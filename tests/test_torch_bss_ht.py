"""The port's 802.11n A-MPDU arm of the BSS engine against the JAX engine.

Programs are lowered by the reference (``tpudes.scenarios.build_bss`` with
``standard="80211n"`` + ``lower_bss``: QoS AIFS, A-MPDUs of up to
``max_mpdus = 64`` subframes answered by a BlockAck) and carried across
with ``convert.bss_from_numpy``; the port's own lowering,
``scenarios.bss_program(..., standard="80211n")``, must give the same
fields.  The JAX ``run_replicated_bss`` and the port's run on the CPU
with the same key.

Tolerances: none.  Per replica ``srv_rx``, ``cli_rx``, ``tx_data``,
``drops``, ``steps`` and ``all_done`` are equal (``steps`` at a power of
two, or with the reference's bucketing off: ``tests/test_torch_bss_sweep.
py::test_odd_replica_counts_equal_unbucketed_reference`` pins the port's
unpadded count).  The step's whole state equals the
reference's after every one of 200 steps taken from a warm state.  A
subframe decodes at ``psr ** (1 / k)``, which the reference's executable
computes as ``exp((nbits * log1p(-pe)) * (1 / k))`` (XLA rewrites the
power of an ``exp``); the port's :func:`mpdu_success_rate` is bit-equal
to the jitted expression over a grid of SINRs and every k.  Two tie
classes could still part the engines without a fault, and each is
counted: a coin within 4 ulp of its subframe rate, and a step with three
or more winners on one µs (the interference sum's order).
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
from tpudes.ops.wifi_error import mode_chunk_success_rate as jax_psr
from tpudes.parallel.replicated import build_bss_advance as jax_build_advance
from tpudes.parallel.replicated import build_bss_step as jax_build_bss_step
from tpudes.parallel.replicated import lower_bss
from tpudes.parallel.replicated import run_replicated_bss as jax_run_bss
from tpudes.scenarios import build_bss
from tpudes_torch.convert import (
    BSS_FIELDS,
    bss_from_numpy,
    bss_state_from_numpy,
)
from tpudes_torch.ops.wifi_error import (
    HT_MODES,
    ampdu_airtime,
    mode_chunk_success_rate,
    mpdu_success_rate,
)
from tpudes_torch.parallel import replicated as bss
from tpudes_torch.parallel.bss_cuda import BSS_STATE
from tpudes_torch.random import PRNGKey, bss_draws, mpdu_coins
from tpudes_torch.scenarios import bss_program

_torch_cpu.one_thread()

OUT_KEYS = ("srv_rx", "cli_rx", "tx_data", "drops", "steps", "all_done")
HT = dict(data_mode="HtMcs7", standard="80211n")

#: (n_stas, sim_s, build_bss keywords): bench.py::bench_wifi_ht (512 B
#: every 10 ms per STA, aggregation under load), the same BSS at the
#: legacy bench's 100 ms (single-MPDU A-MPDUs), and 8 STAs on 12/20/28 m
#: rings, whose 28 m ring decodes a subframe about half the time, so
#: A-MPDUs succeed in part
PROGRAMS = {
    "bench_ht": (64, 2.0, dict(interval_s=0.01, **HT)),
    "ht_100ms": (64, 2.0, dict(**HT)),
    "rings_ht": (8, 1.5, dict(radii=(12.0, 20.0, 28.0), interval_s=0.01,
                              **HT)),
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


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_ht_bss_program_equals_reference_lowering(lowered, name):
    """``bss_program(..., standard="80211n")`` gives ``lower_bss``'s
    fields, dtypes included (AIFS 43 µs, K = 64, 580 B subframes at the
    bench), and ``bss_from_numpy`` carries them unchanged."""
    n_stas, sim_s, kwargs = PROGRAMS[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = bss_program(n_stas, sim_s, **kwargs)
    want = lowered[name]
    assert want.max_mpdus == 64 and want.aifs_us == 43
    for prog in (got, _port(want)):
        for f in dataclasses.fields(want):
            a, b = getattr(prog, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name


@pytest.mark.parametrize("mode", [m.index for m in HT_MODES])
def test_mpdu_rate_bit_equal_to_jitted_reference(mode):
    """An A-MPDU's airtime, nbits and subframe rate for every k in 1..64
    and 1,001 SINRs from -5 to 45 dB, against the reference's expressions
    (``replicated.py:935-944``) jitted: bit-equal; k = 1 is the PPDU's
    own success rate."""
    sinr = (10.0 ** (np.linspace(-5.0, 45.0, 1001) / 10.0)).astype(np.float32)
    s, k = (a.ravel() for a in np.meshgrid(sinr, np.arange(1, 65,
                                                          dtype=np.int32),
                                           indexing="ij"))
    rate = HT_MODES[mode - HT_MODES[0].index].data_rate_bps

    def ref(s, k):
        nsym = jnp.ceil((22.0 + 8.0 * 580 * k) / (rate * 4e-6))
        dur = 36 + (nsym * 4).astype(jnp.int32)
        nbits = jnp.float32(rate * 1e-6) * dur.astype(jnp.float32)
        p = jax_psr(s, nbits, jnp.asarray(mode))
        return dur, nbits, p ** (1.0 / k.astype(jnp.float32))

    want = [np.asarray(a) for a in jax.jit(ref)(s, k)]
    kt = torch.from_numpy(k)
    dur, nbits = ampdu_airtime(kt, 580, mode)
    got = mpdu_success_rate(torch.from_numpy(s), nbits, kt, mode)
    assert np.array_equal(dur.numpy(), want[0])
    assert np.array_equal(nbits.numpy().view(np.int32),
                          want[1].view(np.int32))
    assert np.array_equal(got.numpy().view(np.int32), want[2].view(np.int32))
    one = k == 1
    lone = mode_chunk_success_rate(torch.from_numpy(s[one]), nbits[one],
                                   mode)
    assert torch.equal(lone, got[one])
    mid = (want[2] > 1e-6) & (want[2] < 1 - 1e-6)
    assert mid.sum() > 1000          # mid-range rates are in the grid


def test_mpdu_coins_equal_jax_uniform():
    """``uniform(k_coin, (N, K))`` of the step's second split key, drawn
    row by row (``mpdu_coins`` on the keys of ``bss_draws``), equals
    ``jax.random.uniform`` bit for bit."""
    n, K, R = 9, 64, 3
    u_back, keys = bss_draws(PRNGKey(5), 3, 5, R, n, coin_keys=True)
    key = jax.random.PRNGKey(5)
    for s in (3, 4):
        for r in range(R):
            kb, km = jax.random.split(
                jax.random.fold_in(jax.random.fold_in(key, s), r))
            want = np.asarray(jax.random.uniform(km, (n, K), jnp.float32))
            assert np.array_equal(
                u_back[s - 3, r].numpy(),
                np.asarray(jax.random.uniform(kb, (n,), jnp.float32)))
            rows = mpdu_coins(keys[s - 3, r].expand(n, 2), torch.arange(n),
                              K)
            assert np.array_equal(rows.numpy(), want)


@pytest.mark.parametrize("name, replicas, warm", [("bench_ht", 4, 1500),
                                                  ("rings_ht", 8, 400)])
def test_ht_step_state_equals_reference_for_200_steps(lowered, name,
                                                      replicas, warm):
    """From the reference's state after ``warm`` steps (backlogs built
    up), the plain ``step_fn`` and the JAX ``step_fn`` on the same draws:
    every field after each of the next 200 steps; A-MPDUs of several
    subframes are sent."""
    prog = lowered[name]
    init, _, advance = jax_build_advance(prog, replicas)
    end = jnp.int32(prog.sim_end_us)
    js, _, _ = jax.jit(advance)(init(), jax.random.PRNGKey(3),
                                jnp.int32(warm), end)
    assert int(js["step"]) == warm
    step = jax_build_bss_step(prog, replicas)[2]
    jstep = jax.jit(lambda s, k: step(s, k, end))
    consts = bss.build_bss_consts(_port(prog), "cpu")
    ps = bss_state_from_numpy(js, "cpu")
    u_back, keys = bss_draws(PRNGKey(3), warm, warm + 200, replicas, prog.n,
                             coin_keys=True)
    K = prog.max_mpdus
    census = {}
    for s in range(200):
        js = jstep(js, jax.random.PRNGKey(3))
        coins = (lambda r, i, kc=keys[s]: mpdu_coins(kc[r], i, K))
        ps = bss.step_fn(consts, ps, u_back[s], coins, prog.sim_end_us,
                         census)
        want = bss_state_from_numpy(js, "cpu")
        for k, _, _ in BSS_STATE:
            assert torch.equal(ps[k], want[k]), (name, s + 1, k)
    assert int(census["mpdus"]) > int(census["gated"]) > 0


def _census_run(prog, replicas, seed):
    """The plain loop over the whole horizon with its census: the
    result dict ``run_replicated_bss`` gives, and the counts."""
    consts, init, _ = bss.build_bss_advance(prog, replicas, "cpu")
    census = {}
    state, steps, still = bss.bss_advance_math(
        consts, init(), PRNGKey(seed), [0], bss._estimate_max_steps(prog),
        census=census)
    return bss._bss_unpack(state, steps, still)[0], {
        k: int(v) for k, v in census.items()}


@pytest.mark.parametrize("name, replicas", [("bench_ht", 8),
                                            ("rings_ht", 16),
                                            ("ht_100ms", 8)])
def test_ht_run_equals_jax_engine_per_replica(lowered, name, replicas):
    """Every integer output per replica; on the two loaded programs the
    census shows A-MPDUs of several subframes, BlockAck'd exchanges and
    retry-limit drops, on the rings partial successes, and counts both
    tie classes."""
    prog = lowered[name]
    want = jax_run_bss(prog, replicas, jax.random.PRNGKey(5))
    if name == "ht_100ms":
        got = bss.run_replicated_bss(_port(prog), replicas, PRNGKey(5),
                                     device="cpu")
    else:
        got, census = _census_run(_port(prog), replicas, 5)
        print(f"{name}: {census}")
        assert census["mpdus"] > census["gated"] > 0   # A-MPDUs of k > 1
        assert census["coin_ties"] == 0
        if name == "rings_ht":
            assert census["partial"] > 0
    for k in OUT_KEYS:
        assert np.array_equal(got[k], np.asarray(want[k])), (name, k)
    assert got["all_done"] and got["srv_rx"].sum() > 0
    assert got["cli_rx"].sum() > 0 and got["drops"].sum() > 0
