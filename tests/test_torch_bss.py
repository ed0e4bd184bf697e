"""The port's WiFi BSS replica engine against the JAX engine.

Programs are lowered by the reference (``tpudes.scenarios.build_bss`` +
``lower_bss``) and carried across with ``convert.bss_from_numpy``; the
port's own lowering, ``scenarios.bss_program``, must give the same
fields.  The JAX ``run_replicated_bss`` and the port's run on the CPU
with the same key.

Tolerances: none.  Per replica ``srv_rx``, ``cli_rx``, ``tx_data``,
``drops`` and ``all_done`` are equal, and ``steps`` too (R a power of
two: the reference pads R to one and counts its padded replicas'
steps).  The step's whole state equals the reference's, field by field
and ``t`` included, after every one of the first 200 steps.  Two tie
classes could separate the engines without a fault, and each is
counted: a decode coin within 4 ulp of its PSR (the PSR is bit-equal to
the reference's, ``tests/test_torch_wifi_error.py``, so none should
decide an outcome), and a step with three or more winners on one µs,
whose interference sum the port adds as a pairwise tree and the
reference's dot in its own order (with one or two winners every order
agrees).  Neither has moved an outcome on these programs.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu

from tpudes.core.world import reset_world
from tpudes.parallel.replicated import build_bss_step as jax_build_bss_step
from tpudes.parallel.replicated import lower_bss
from tpudes.parallel.replicated import run_replicated_bss as jax_run_bss
from tpudes.scenarios import build_bss
from tpudes_torch.convert import (
    BSS_FIELDS,
    bss_from_numpy,
    bss_state_from_numpy,
)
from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel import replicated as bss
from tpudes_torch.parallel.bss_cuda import (
    BSS_STATE,
    bss_advance_cuda,
    join_stops,
)
from tpudes_torch.random import PRNGKey, bss_draws
from tpudes_torch.scenarios import bss_program

_torch_cpu.one_thread()

OUT_KEYS = ("srv_rx", "cli_rx", "tx_data", "drops", "steps", "all_done")

#: (n_stas, sim_s, build_bss keywords): the bench's program, a small one,
#: and one whose 12/20/28 m rings put mid-range PSRs on collisions
PROGRAMS = {
    "bench": (64, 2.0, {}),
    "small": (4, 2.0, {}),
    "rings": (8, 1.5, dict(radii=(12.0, 20.0, 28.0))),
    "two_rings": (4, 1.5, dict(radii=(10.0, 22.0))),
}


def _lower(n_stas, sim_s, kwargs):
    reset_world()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the short-horizon advisory
        sta, ap, clients, _ = build_bss(n_stas, sim_s, **kwargs)
        prog = lower_bss([sta.Get(i) for i in range(sta.GetN())], ap,
                         clients, sim_s)
    reset_world()
    return prog


@pytest.fixture(scope="module")
def lowered():
    return {name: _lower(*spec) for name, spec in PROGRAMS.items()}


def _port(prog):
    return bss_from_numpy({k: getattr(prog, k) for k in BSS_FIELDS})


@pytest.mark.parametrize("name", ["bench", "two_rings", "rings"])
def test_bss_program_equals_reference_lowering(lowered, name):
    """``bss_program`` gives ``lower_bss(build_bss(...))``'s fields,
    dtypes included, and ``bss_from_numpy`` carries them unchanged."""
    n_stas, sim_s, kwargs = PROGRAMS[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = bss_program(n_stas, sim_s, **kwargs)
    want = lowered[name]
    for prog in (got, _port(want)):
        for f in dataclasses.fields(want):
            a, b = getattr(prog, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name


def test_bss_program_refuses_hidden_nodes_and_ht_modes():
    """Hidden nodes and modes outside the OFDM/HT registry (the DSSS
    rates) are refused; HT modes lower (``tests/test_torch_bss_ht.py``)."""
    with pytest.raises(ValueError, match="hidden-node"):
        bss_program(4, 2.0, radii=(300.0,))
    with pytest.raises(ValueError, match="OFDM and HT"):
        bss_program(4, 2.0, data_mode="DsssRate1Mbps")
    with pytest.raises(ValueError, match="standards"):
        bss_program(4, 2.0, standard="80211b")
    with pytest.warns(UserWarning, match="warm-up"):
        bss_program(2, 1.0)


@pytest.mark.parametrize("name, replicas", [("bench", 4), ("rings", 8)])
def test_step_state_equals_reference_for_200_steps(lowered, name, replicas):
    """The plain ``step_fn`` and the JAX ``step_fn`` from the same state
    on the same draws: every field after each of the first 200 steps
    (checked at 1, 10 and 200 and every step between)."""
    prog = lowered[name]
    init, _, step = jax_build_bss_step(prog, replicas)
    jstep = jax.jit(lambda s, k: step(s, k, jnp.int32(prog.sim_end_us)))
    js = init()
    _, port_init, _, _, port_step, _ = bss.build_bss_step(
        _port(prog), replicas, "cpu")
    ps = port_init()
    assert all(torch.equal(ps[k], v) for k, v in
               bss_state_from_numpy(js, "cpu").items())
    key = jax.random.PRNGKey(3)
    u_back, u_coin = bss_draws(PRNGKey(3), 0, 200, replicas, prog.n)
    for s in range(200):
        js = jstep(js, key)
        ps = port_step(ps, u_back[s], u_coin[s])
        want = bss_state_from_numpy(js, "cpu")
        for k, _, _ in BSS_STATE:
            assert torch.equal(ps[k], want[k]), (name, s + 1, k)
    assert int(js["step"]) == 200
    assert int(ps["tx_data"].sum()) > 0 and int(ps["srv_rx"].sum()) > 0


def _count_ties(prog, replicas, seed):
    """Run the port's plain loop with its census and count the two tie
    classes: gated coins within 4 ulp of their PSR, and replica-steps
    with three or more winners (data frames and the beacon); with the
    number of gated decodes and the final state."""
    consts, init, _ = bss.build_bss_advance(prog, replicas, "cpu")
    census = {}
    s, _, _ = bss.bss_advance_math(consts, init(), PRNGKey(seed), [0],
                                   bss._estimate_max_steps(prog),
                                   census=census)
    return (int(census["coin_ties"]), int(census["three_winners"]),
            int(census["gated"]), {k: v[0] for k, v in s.items()})


@pytest.mark.parametrize("name, replicas", [("small", 16), ("rings", 8),
                                            ("bench", 4)])
def test_run_equals_jax_engine_per_replica(lowered, name, replicas):
    prog = lowered[name]
    want = jax_run_bss(prog, replicas, jax.random.PRNGKey(5))
    got = bss.run_replicated_bss(_port(prog), replicas, PRNGKey(5),
                                 device="cpu")
    for k in OUT_KEYS:
        assert np.array_equal(got[k], np.asarray(want[k])), (name, k)
    assert got["all_done"] and got["srv_rx"].shape == (replicas,)
    assert got["cli_rx"].shape == (replicas, prog.n)
    assert got["srv_rx"].sum() > 0 and got["cli_rx"].sum() > 0
    if name == "bench":
        # the 34 m ring always fails at 54 Mbit/s: its frames drop
        assert (got["drops"] > 0).all()


@pytest.mark.parametrize("name, replicas", [("rings", 8), ("small", 16)])
def test_tie_classes_are_counted(lowered, name, replicas):
    """The tie classes of the programs the per-replica test runs,
    counted; the run they come from equals the JAX engine's."""
    prog = lowered[name]
    coin_ties, three, decodes, s = _count_ties(_port(prog), replicas, 5)
    want = jax_run_bss(prog, replicas, jax.random.PRNGKey(5))
    for k in ("srv_rx", "cli_rx", "tx_data", "drops"):
        assert np.array_equal(s[k].numpy(), np.asarray(want[k])), k
    print(f"{name}: {decodes} gated decodes, {coin_ties} coins within 4 ulp "
          f"of their PSR, {three} replica-steps with >= 3 winners")
    assert decodes > 0


def test_chunked_run_equals_one_launch(lowered):
    port = _port(lowered["small"])
    one = bss.run_replicated_bss(port, 16, PRNGKey(9), device="cpu")
    chunked = bss.run_replicated_bss(port, 16, PRNGKey(9), device="cpu",
                                     chunk_steps=37)
    for k in OUT_KEYS:
        assert np.array_equal(chunked[k], one[k]), k
    short = bss.run_replicated_bss(port, 16, PRNGKey(9), device="cpu",
                                   max_steps=50)
    assert short["steps"] == 50 and not short["all_done"]


def test_jax_key_words_are_accepted(lowered):
    port = _port(lowered["two_rings"])
    a = bss.run_replicated_bss(port, 2, np.asarray(jax.random.PRNGKey(1)),
                               device="cpu")
    b = bss.run_replicated_bss(port, 2, PRNGKey(1), device="cpu")
    for k in OUT_KEYS:
        assert np.array_equal(a[k], b[k]), k


def test_per_replica_stops_join_to_the_shared_loop(lowered):
    """The kernel's design on the CPU: each replica runs alone until its
    own stop (its own draws), recording the stop and the ``t`` one more
    step would give it; ``join_stops`` then equals the shared loop's
    state, which moved the early finishers' ``t`` once more."""
    port = _port(lowered["rings"])   # its replicas stop at 150 or 151
    R = 8
    consts, init, _, _, step, pending = bss.build_bss_step(port, R, "cpu")
    bound = bss._estimate_max_steps(port)
    want, w_steps, w_pend = bss.bss_advance_math(
        consts, {k: v[None] for k, v in init().items()}, PRNGKey(2), [0],
        bound)
    u_back, u_coin = bss_draws(PRNGKey(2), 0, w_steps[0], R, port.n)
    s = init()
    rows = []
    for r in range(R):
        one = {k: v[r:r + 1] for k, v in s.items()}
        n = 0
        while n < bound and bool(bss.pending(consts, one,
                                             consts["sim_end"])[0]):
            one = bss.step_fn(consts, one, u_back[n, r:r + 1],
                              u_coin[n, r:r + 1], consts["sim_end"])
            n += 1
        nxt = torch.minimum(bss.tx_times(consts, one).amin(1),
                            one["next_arr"].amin(1))
        t_next = torch.where(one["t"] < consts["sim_end"],
                             torch.maximum(one["t"], nxt), one["t"])
        rows.append((one, n, t_next))
    got = {k: torch.cat([row[0][k] for row in rows])[None] for k in want}
    done = torch.tensor([[row[1] for row in rows]], dtype=torch.int32)
    t_next = torch.cat([row[2] for row in rows])[None]
    joined, steps = join_stops(got, done, t_next)
    assert steps == w_steps and not bool(w_pend.any())
    assert int((done < steps[0]).sum()) > 0    # the join had work to do
    assert int((joined["t"] != got["t"]).sum()) > 0
    for k in want:
        assert torch.equal(joined[k], want[k]), k


def test_tree_sum_order():
    """One or two nonzero terms: the tree sum is the plain sum; three
    and more add as pairs of neighbours, then pairs of pairs."""
    x = torch.zeros((3, 7))
    x[0, 4] = 0.3
    x[1, 1], x[1, 6] = 0.1, 0.7
    x[2, :4] = torch.tensor([1.0, 1e-8, 1e-8, 1e-8])
    got = bss.tree_sum(x)
    assert got[0] == x[0, 4] and got[1] == x[1, 1] + x[1, 6]
    assert got[2] == (x[2, 0] + x[2, 1]) + (x[2, 2] + x[2, 3])


def test_wrapper_takes_the_plain_loop_on_the_cpu(lowered):
    port = _port(lowered["two_rings"])
    consts, init, _ = bss.build_bss_advance(port, 2, "cpu")
    kc.reset_launches()
    state, steps, still = bss.bss_advance(consts, init(), PRNGKey(0), [0],
                                          30)
    assert kc.launches["bss_advance"] == 0 and steps == [30]
    with pytest.raises(ValueError, match="step0"):
        bss_advance_cuda(consts, init(), PRNGKey(0), [5], 4)


@pytest.mark.parametrize("kwargs", [
    dict(mesh=object()), dict(mesh=object(), checkpoint="x"),
])
def test_unported_run_options_raise(lowered, kwargs):
    """``mesh=`` (A12) raises, also beside the runtime's ``checkpoint=``,
    which runs (tests/test_torch_checkpoint.py, test_torch_runtime.py)."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bss.run_replicated_bss(_port(lowered["two_rings"]), 2, PRNGKey(0),
                               device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [dict(obs=True),
                                    dict(obs=True, block=False)])
def test_obs_runs_beside_the_runtime_options(lowered, kwargs):
    """``obs=True`` (once refused, ROADMAP A10) runs, also beside
    ``block=False``: the outputs are the obs=False run's, plus ``retx``
    and the FlowMonitor columns (tests/test_torch_obs_bss.py holds them
    against the reference)."""
    prog = _port(lowered["two_rings"])
    got = bss.run_replicated_bss(prog, 2, PRNGKey(0), device="cpu",
                                 **kwargs)
    if not isinstance(got, dict):
        got = got.result()
    plain = bss.run_replicated_bss(prog, 2, PRNGKey(0), device="cpu")
    for k in OUT_KEYS:
        assert np.array_equal(np.asarray(got[k]), np.asarray(plain[k])), k
    assert got["retx"].shape == (2,)
    assert got["flow"]["fm_tx"].shape == (2, prog.n)
    assert got["flow"]["fm_ring"].shape == (2, 512, 5)


def test_obs_columns_count_the_exchanges(lowered):
    """Each node's sent MPDUs are its data exchanges (one MPDU each in the
    legacy arm), the STAs' deliveries the AP's decoded requests, and the
    delay histogram holds every delivery."""
    prog = _port(lowered["two_rings"])
    got = bss.run_replicated_bss(prog, 2, PRNGKey(0), device="cpu",
                                 obs=True)
    flow = got["flow"]
    assert np.array_equal(flow["fm_tx"].sum(1), got["tx_data"])
    assert np.array_equal(flow["fm_rx"][:, 1:].sum(1), got["srv_rx"])
    assert np.array_equal(flow["fm_hist"].sum(-1), flow["fm_rx"])


@pytest.mark.parametrize("fields", ["mobility", "traffic", "geom_stride"])
def test_unported_program_arms_raise(lowered, fields):
    """The program arms once refused here (ROADMAP A3c) now run
    (``tests/test_torch_bss_mobile.py`` and ``test_torch_bss_traffic.py``
    hold them against the JAX engine): a motion program of the static
    model reports its geometry refreshes, the cbr workload of the
    program's own intervals and a stride without motion give the static
    run's outputs."""
    from tpudes_torch.ops.mobility import MobilityProgram
    from tpudes_torch.traffic.program import TrafficProgram

    port = _port(lowered["two_rings"])
    arm = dict(
        mobility=dict(mobility=MobilityProgram.static(port.positions)),
        traffic=dict(traffic=TrafficProgram.cbr(port.start_us,
                                                port.interval_us)),
        geom_stride=dict(geom_stride=8),
    )[fields]
    prog = dataclasses.replace(port, **arm)
    got = bss.run_replicated_bss(prog, 2, PRNGKey(0), device="cpu")
    assert got["all_done"]
    if fields == "mobility":
        assert got["geom_refreshes"] == got["steps"]
    else:
        want = bss.run_replicated_bss(port, 2, PRNGKey(0), device="cpu")
        for k in OUT_KEYS:
            assert np.array_equal(got[k], want[k]), k
