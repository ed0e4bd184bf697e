"""The port's BSS event loop around its step: the horizon sweep
(``sim_end_us=[...]``) against the JAX sweep, chunked runs, the kernel's
per-replica stops joined on the CPU, and the replica counts that are
not a power of two.

The reference vmaps its ``while_loop`` over the horizons: each point is
its own loop, stopping when its own replicas are done, with the key
shared, so point ``c`` equals the single run at horizon ``c`` in every
output, ``steps`` included.  The port runs the points as one ``(C, R)``
grid (one launch on the card; on the CPU the plain loop steps the points
still running together).  Tolerance: none, per replica and per point.

ROADMAP C1: the reference pads R to a power of two when its bucketing is
on, and its ``steps`` then counts the padded replicas' steps; the port
does not pad, so at an odd R it is held against the reference with
``TPUDES_BUCKETING=0``.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from tpudes.core.world import reset_world
from tpudes.parallel.replicated import lower_bss
from tpudes.parallel.replicated import run_replicated_bss as jax_run_bss
from tpudes.scenarios import build_bss
from tpudes_torch.convert import BSS_FIELDS, bss_from_numpy
from tpudes_torch.parallel import replicated as bss
from tpudes_torch.parallel.bss_cuda import join_stops
from tpudes_torch.random import PRNGKey, bss_draws, mpdu_coins

OUT_KEYS = ("srv_rx", "cli_rx", "tx_data", "drops", "steps", "all_done")
HT = dict(interval_s=0.01, data_mode="HtMcs7", standard="80211n")
#: the horizons of the sweep checks, out of order on purpose
ENDS = [1_050_000, 1_200_000, 1_120_000]


def _lower(n_stas, sim_s, **kwargs):
    reset_world()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the short-horizon advisory
        sta, ap, clients, _ = build_bss(n_stas, sim_s, **kwargs)
        prog = lower_bss([sta.Get(i) for i in range(sta.GetN())], ap,
                         clients, sim_s)
    reset_world()
    return prog


def _port(prog):
    return bss_from_numpy({k: getattr(prog, k) for k in BSS_FIELDS})


@pytest.fixture(scope="module")
def sixteen():
    """16 STAs to 1.2 s: legacy and 802.11n (A-MPDUs under load)."""
    return {"legacy": _lower(16, 1.2), "ht": _lower(16, 1.2, **HT)}


@pytest.mark.parametrize("which", ["legacy", "ht"])
def test_sweep_equals_jax_sweep_point_for_point(sixteen, which):
    """Three horizons, 8 replicas, key 3: each point equals the JAX
    sweep's point and the port's own single run at that horizon (the
    same step budget), every output; the points' step counts differ."""
    prog = sixteen[which]
    want = jax_run_bss(prog, 8, jax.random.PRNGKey(3), sim_end_us=ENDS)
    port = _port(prog)
    got = bss.run_replicated_bss(port, 8, PRNGKey(3), device="cpu",
                                 sim_end_us=ENDS)
    assert isinstance(got, list) and len(got) == len(ENDS)
    budget = max(bss._estimate_max_steps(dataclasses.replace(
        port, sim_end_us=v)) for v in ENDS)
    for c, end in enumerate(ENDS):
        one = bss.run_replicated_bss(
            dataclasses.replace(port, sim_end_us=end), 8, PRNGKey(3),
            device="cpu", max_steps=budget)
        for k in OUT_KEYS:
            assert np.array_equal(got[c][k], np.asarray(want[c][k])), (c, k)
            assert np.array_equal(got[c][k], one[k]), (c, k)
        assert got[c]["all_done"]
    assert len({p["steps"] for p in got}) == len(ENDS)


def test_sweep_chunked_equals_one_launch(sixteen):
    """A chunked sweep (points finish in different chunks, and a finished
    point keeps its count) equals the unchunked one."""
    port = _port(sixteen["ht"])
    one = bss.run_replicated_bss(port, 4, PRNGKey(8), device="cpu",
                                 sim_end_us=ENDS)
    chunked = bss.run_replicated_bss(port, 4, PRNGKey(8), device="cpu",
                                     sim_end_us=ENDS, chunk_steps=150)
    for c in range(len(ENDS)):
        for k in OUT_KEYS:
            assert np.array_equal(chunked[c][k], one[c][k]), (c, k)
    assert len({p["steps"] for p in one}) == len(ENDS)
    with pytest.raises(ValueError, match="at least one"):
        bss.run_replicated_bss(port, 4, PRNGKey(8), device="cpu",
                               sim_end_us=[])


def test_grid_stops_join_per_point(sixteen):
    """The kernel's grid on the CPU: each (point, replica) steps alone on
    replica r's draws under point c's horizon until its own stop;
    ``join_stops`` on the ``(C, R)`` stops joins each point on its own
    and equals the plain grid loop's state and step counts."""
    port = _port(sixteen["legacy"])
    R, C = 4, len(ENDS)
    consts, init, _ = bss.build_bss_advance(port, R, "cpu")
    bound = bss._estimate_max_steps(port)
    want, w_steps, w_pend = bss.bss_advance_math(consts, init(C),
                                                 PRNGKey(2), [0] * C, bound,
                                                 ENDS)
    assert not bool(w_pend.any()) and len(set(w_steps)) == C
    u_back, u_coin = bss_draws(PRNGKey(2), 0, max(w_steps), R, port.n)
    got, done, t_next = {k: [] for k in want}, [], []
    for c, end in enumerate(ENDS):
        for r in range(R):
            one = {k: v[0, r:r + 1] for k, v in init().items()}
            n = 0
            while bool(bss.pending(consts, one, end)[0]):
                one = bss.step_fn(consts, one, u_back[n, r:r + 1],
                                  u_coin[n, r:r + 1], end)
                n += 1
            nxt = torch.minimum(bss.tx_times(consts, one).amin(1),
                                one["next_arr"].amin(1))
            t_next.append(torch.where(one["t"] < end,
                                      torch.maximum(one["t"], nxt),
                                      one["t"]))
            done.append(n)
            for k in got:
                got[k].append(one[k])
    got = {k: torch.cat(v).unflatten(0, (C, R)) for k, v in got.items()}
    done = torch.tensor(done, dtype=torch.int32).view(C, R)
    joined, steps = join_stops(got, done, torch.cat(t_next).view(C, R))
    assert steps == w_steps
    assert int((done < done.amax(1, keepdim=True)).sum()) > 0
    for k in want:
        assert torch.equal(joined[k], want[k]), k


@pytest.mark.parametrize("ht", [False, True])
@pytest.mark.parametrize("replicas", [3, 5])
def test_odd_replica_counts_equal_unbucketed_reference(monkeypatch, ht,
                                                       replicas):
    """ROADMAP C1: at R = 3 and 5 the port (which does not pad R) equals
    the reference with its bucketing off (``TPUDES_BUCKETING=0``) on
    every output, ``steps`` included."""
    monkeypatch.setenv("TPUDES_BUCKETING", "0")
    kwargs = dict(radii=(12.0, 20.0, 28.0), **(HT if ht else {}))
    prog = _lower(8, 1.2, **kwargs)
    want = jax_run_bss(prog, replicas, jax.random.PRNGKey(2))
    got = bss.run_replicated_bss(_port(prog), replicas, PRNGKey(2),
                                 device="cpu")
    for k in OUT_KEYS:
        assert np.array_equal(got[k], np.asarray(want[k])), (k, ht, replicas)


@pytest.fixture(scope="module")
def rings_ht():
    """8 STAs on 12/20/28 m rings under 802.11n, to 1.5 s."""
    return _lower(8, 1.5, radii=(12.0, 20.0, 28.0), **HT)


def test_ht_chunked_run_equals_one_launch(rings_ht):
    port = dataclasses.replace(_port(rings_ht), sim_end_us=1_200_000)
    one = bss.run_replicated_bss(port, 4, PRNGKey(9), device="cpu")
    chunked = bss.run_replicated_bss(port, 4, PRNGKey(9), device="cpu",
                                     chunk_steps=137)
    for k in OUT_KEYS:
        assert np.array_equal(chunked[k], one[k]), k
    short = bss.run_replicated_bss(port, 4, PRNGKey(9), device="cpu",
                                   max_steps=50)
    assert short["steps"] == 50 and not short["all_done"]


def test_ht_per_replica_stops_join_to_the_shared_loop(rings_ht):
    """The ``AGG`` kernel's design on the CPU: each replica steps alone
    on its own draws (its MPDU coins hashed row by row) until its own
    stop; ``join_stops`` then equals the shared loop's state."""
    port = dataclasses.replace(_port(rings_ht), sim_end_us=1_100_000)
    R, K = 4, port.max_mpdus
    consts, init, _, _, _, _ = bss.build_bss_step(port, R, "cpu")
    bound = bss._estimate_max_steps(port)
    want, w_steps, w_pend = bss.bss_advance_math(
        consts, {k: v[None] for k, v in init().items()}, PRNGKey(2), [0],
        bound)
    u_back, keys = bss_draws(PRNGKey(2), 0, w_steps[0], R, port.n,
                             coin_keys=True)
    end = consts["sim_end"]
    rows = []
    for r in range(R):
        one = {k: v[r:r + 1] for k, v in init().items()}
        n = 0
        while n < bound and bool(bss.pending(consts, one, end)[0]):
            coins = (lambda g, i, kc=keys[n, r:r + 1]:
                     mpdu_coins(kc[g], i, K))
            one = bss.step_fn(consts, one, u_back[n, r:r + 1], coins, end)
            n += 1
        nxt = torch.minimum(bss.tx_times(consts, one).amin(1),
                            one["next_arr"].amin(1))
        rows.append((one, n, torch.where(one["t"] < end,
                                         torch.maximum(one["t"], nxt),
                                         one["t"])))
    got = {k: torch.cat([row[0][k] for row in rows])[None] for k in want}
    done = torch.tensor([[row[1] for row in rows]], dtype=torch.int32)
    joined, steps = join_stops(got, done,
                               torch.cat([row[2] for row in rows])[None])
    assert steps == w_steps and not bool(w_pend.any())
    assert int((done < steps[0]).sum()) > 0    # the join had work to do
    for k in want:
        assert torch.equal(joined[k], want[k]), k
