"""The port's finite-backlog LTE path against the JAX engine.

The reference lowers the lena drop (``build_lena(2, 4)`` +
``lower_lte_sm(..., 0.25)``, 250 TTIs) and a workload of one entity per
UE is built by the reference's ``TrafficProgram`` factories; both cross
over with ``program_from_numpy(..., traffic=traffic_from_numpy(...))``
and run through ``tpudes.parallel.lte_sm.run_lte_sm`` and the port's
``run_lte_sm`` on the CPU with key ``PRNGKey(3)``, 4 replicas.

Tolerances: per replica and UE ``rx_bits``, ``new_tbs``, ``retx``,
``drops``, ``ok`` and ``goodput_bits`` are equal, ``backlog_bits`` is
bit-equal and ``offered_bits`` equal.  An integer mismatch would have to
be a decode coin within an ulp of a BLER computed by the two ``erfc``
implementations; none occurs on these programs.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest

import _torch_cpu

from tpudes.core.world import reset_world
from tpudes.parallel.lte_sm import lower_lte_sm
from tpudes.parallel.lte_sm import run_lte_sm as jax_run_lte_sm
from tpudes.scenarios import build_lena
from tpudes.traffic.program import TrafficProgram as JaxTraffic
from tpudes_torch.convert import (
    PROGRAM_FIELDS,
    TRAFFIC_FIELDS,
    program_from_numpy,
    traffic_from_numpy,
)
from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel.lte_sm import build_sm_traffic_advance, run_lte_sm
from tpudes_torch.random import PRNGKey, replica_keys

_torch_cpu.one_thread()

LTE_KEYS = ("rx_bits", "new_tbs", "retx", "drops", "ok")
TRAFFIC_KEYS = LTE_KEYS + ("goodput_bits",)
KEY_SEED = 3
REPLICAS = 4
SIZES = np.asarray([1.4, 800.0, 12000.0], np.float32)


@pytest.fixture(scope="module")
def lena():
    reset_world()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the short-horizon advisory
        lte, _ = build_lena(2, 4)
        prog = lower_lte_sm(lte, 0.25)
    reset_world()
    return prog


def _workload(model: str, n: int, horizon_us: int):
    """A load near what the 2-cell drop delivers (about 0.5 Mbit per UE
    in 250 TTIs under full buffers), so backlogs empty and fill: the
    reference's own LTE traffic test's ON-OFF shape at a higher peak,
    and the other models at a similar mean."""
    if model == "onoff":
        tp = JaxTraffic.onoff(n, 200.0, horizon_us=horizon_us,
                              on=(1.5, 0.01, 0.05), off_mean_s=0.02,
                              tr_seed=2)
    elif model == "mmpp":
        tp = JaxTraffic.mmpp(n, 100.0, horizon_us=horizon_us, epoch_s=0.02,
                             tr_seed=4)
    elif model == "cbr":
        tp = JaxTraffic.cbr(np.arange(n) * 300, np.arange(n) * 500 + 7000)
    else:
        rng = np.random.default_rng(1)
        t = np.sort(rng.integers(0, horizon_us, (n, 40)), axis=1)
        tp = JaxTraffic.trace_replay(t, rng.integers(200, 3000, (n, 40)))
    return dataclasses.replace(tp, size_pareto=SIZES)


def _port(prog):
    tr = prog.traffic
    return program_from_numpy(
        {k: getattr(prog, k) for k in PROGRAM_FIELDS},
        traffic=None if tr is None else traffic_from_numpy(
            {k: getattr(tr, k) for k in TRAFFIC_FIELDS}
        ),
    )


def _assert_same(got, want, msg, keys=TRAFFIC_KEYS):
    for k in keys:
        assert got[k].shape == np.asarray(want[k]).shape, (msg, k)
        assert np.array_equal(got[k], np.asarray(want[k])), (msg, k)
    if "backlog_bits" in want:
        w = np.asarray(want["backlog_bits"])
        assert got["backlog_bits"].dtype == w.dtype == np.float32
        assert np.array_equal(got["backlog_bits"].view(np.int32),
                              w.view(np.int32)), msg
        assert np.array_equal(got["offered_bits"],
                              np.asarray(want["offered_bits"])), msg


@pytest.mark.parametrize("sched", ["pf", "rr", "tdbet"])
@pytest.mark.parametrize("model", ["onoff", "mmpp", "trace", "cbr"])
def test_traffic_matches_jax_engine_per_replica(lena, model, sched):
    prog = dataclasses.replace(
        lena, scheduler=sched,
        traffic=_workload(model, lena.n_ue, lena.n_ttis * 1000),
    )
    want = jax_run_lte_sm(prog, jax.random.PRNGKey(KEY_SEED),
                          replicas=REPLICAS)
    got = run_lte_sm(_port(prog), PRNGKey(KEY_SEED), replicas=REPLICAS,
                     device="cpu")
    assert got["rx_bits"].shape == (REPLICAS, prog.n_ue)
    _assert_same(got, want, (model, sched))
    assert got["goodput_bits"].sum() > 0
    # padding: a TB larger than the backlog delivers more than drains
    assert (got["goodput_bits"] <= got["rx_bits"]).all()


def test_gate_fires_and_backlogs_carry(lena):
    """On the near-capacity ON-OFF load the backlog gate bites: UEs sit
    out TTIs with an empty backlog (fewer new TBs than full buffers
    give), some backlog is left at the end, and retx occur."""
    tp = _workload("onoff", lena.n_ue, lena.n_ttis * 1000)
    port = _port(dataclasses.replace(lena, traffic=tp))
    out = run_lte_sm(port, PRNGKey(KEY_SEED), replicas=REPLICAS, device="cpu")
    full = run_lte_sm(dataclasses.replace(port, traffic=None),
                      PRNGKey(KEY_SEED), replicas=REPLICAS, device="cpu")
    assert out["new_tbs"].sum() < full["new_tbs"].sum()
    assert (out["backlog_bits"] > 0).any() and out["retx"].sum() > 0
    # the state the launches carry between chunks: the gate ran in the
    # plain loop with the backlog state beside the 14 arrays
    consts, init_state, advance = build_sm_traffic_advance(port, "cpu")
    s = advance(init_state(2), replica_keys(PRNGKey(KEY_SEED), 2),
                PRNGKey(11), 0, 40)
    assert set(s) == {k for k, _, _ in kc.SM_STATE + kc.TR_STATE}


def test_unbatched_and_chunked_runs(lena):
    """No replica axis runs on the key itself, like the reference; any
    chunking of the horizon gives the same run (the offered table is
    built per launch)."""
    prog = dataclasses.replace(
        lena, traffic=_workload("onoff", lena.n_ue, lena.n_ttis * 1000)
    )
    want = jax_run_lte_sm(prog, jax.random.PRNGKey(KEY_SEED))
    port = _port(prog)
    one = run_lte_sm(port, PRNGKey(KEY_SEED), device="cpu")
    assert one["rx_bits"].shape == (prog.n_ue,)
    _assert_same(one, want, "unbatched")
    chunked = run_lte_sm(port, PRNGKey(KEY_SEED), device="cpu",
                         chunk_ttis=37)
    for k in TRAFFIC_KEYS + ("backlog_bits",):
        assert np.array_equal(chunked[k], one[k]), k


def test_scheduler_sweep_matches_jax_sweep(lena):
    names = ["pf", "rr"]
    prog = dataclasses.replace(
        lena, traffic=_workload("mmpp", lena.n_ue, lena.n_ttis * 1000)
    )
    want = jax_run_lte_sm(prog, jax.random.PRNGKey(KEY_SEED),
                          replicas=REPLICAS, schedulers=names)
    port = _port(prog)
    got = run_lte_sm(port, PRNGKey(KEY_SEED), replicas=REPLICAS,
                     device="cpu", schedulers=names)
    assert isinstance(got, list) and len(got) == len(names)
    for name, g, w in zip(names, got, want):
        _assert_same(g, w, name)
        one = run_lte_sm(dataclasses.replace(port, scheduler=name),
                         PRNGKey(KEY_SEED), replicas=REPLICAS, device="cpu")
        for k in TRAFFIC_KEYS + ("backlog_bits",):
            assert np.array_equal(g[k], one[k]), (name, k)


def test_saturating_fill_bit_equal_to_full_buffer(lena):
    """A cbr fill far above the cell's rate never empties a backlog: the
    run is the full-buffer run (``test_traffic_engines.py:159-173``)."""
    prog = dataclasses.replace(lena, n_ttis=100)
    sat = dataclasses.replace(
        JaxTraffic.cbr(np.zeros(prog.n_ue, np.int32),
                       np.full(prog.n_ue, 1, np.int64)),
        size_pareto=np.asarray([0.0, 20000.0, 20000.0], np.float32),
    )
    port = _port(prog)
    full = run_lte_sm(port, PRNGKey(KEY_SEED), replicas=2, device="cpu")
    out = run_lte_sm(_port(dataclasses.replace(prog, traffic=sat)),
                     PRNGKey(KEY_SEED), replicas=2, device="cpu")
    for k in LTE_KEYS + ("cqi", "mcs"):
        assert np.array_equal(out[k], full[k]), k
    assert np.array_equal(out["goodput_bits"], out["rx_bits"])
