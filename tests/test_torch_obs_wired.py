"""``obs=True`` through the port's wired engine against the JAX engine
under ``TpudesObs=1``.

The reference steps every replica's row on one clock, the union of all
rows' next events; the port steps each row on its own (ROADMAP Queue C,
C5).  So at one replica everything is equal: every FlowMonitor column,
the raw ring (the reference's -1 rows included) and each window's
ChunkStream entry (``next_event``, ``n_steps`` and the ring).  With more
than one replica the reference counts a birth whose first link is busy at
the first union step at or after it, and stamps -1 rows into a row's ring
at union steps where the row was idle: ``fm_t0`` and the raw ring may
differ there (C6, counted below), while ``fm_tx``, ``fm_txb``, ``fm_rx``,
``fm_rxb``, ``fm_lost``, ``fm_dsum``, ``fm_jsum``, ``fm_dlast``,
``fm_t1`` and ``fm_hist`` are equal at every window edge.  Deliveries
inside a visit are grouped by slot: one delay observation per (slot,
flow).  Tolerance: none (the f32 delay sums are integer-valued and below
2^24 slots, exact in any order).
"""

import contextlib

import jax
import numpy as np
import pytest

from tpudes.core.global_value import GlobalValue
from tpudes.obs.device import ChunkStream as RefChunkStream
from tpudes.parallel import wired as ref
from tpudes_torch.convert import WIRED_FIELDS, wired_from_numpy
from tpudes_torch.obs.device import ChunkStream
from tpudes_torch.obs.flowmon import FM_KEYS
from tpudes_torch.parallel import wired as W

KEY = 11
EDGE_EQUAL = ("fm_tx", "fm_txb", "fm_rx", "fm_rxb", "fm_lost", "fm_dsum",
              "fm_jsum", "fm_dlast", "fm_t1", "fm_hist")


@contextlib.contextmanager
def ref_obs():
    GlobalValue.Bind("TpudesObs", 1)
    try:
        yield
    finally:
        GlobalValue.Bind("TpudesObs", 0)


def _bits(a):
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a.view(np.int64) if a.dtype == np.float64 else a


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        _bits(a), _bits(b))


def _port(prog):
    return wired_from_numpy({k: getattr(prog, k) for k in WIRED_FIELDS})


def _full_columns():
    """Three flows over all three columns of ``paths``, one backwards."""
    return ref.WiredProgram(
        n_links=3, service_slots=np.array([1, 2, 1], np.int32),
        delay_slots=np.array([2, 3, 2], np.int32),
        paths=np.array([[0, 1, 2], [2, 1, 0], [1, 2, -1]], np.int32),
        start_slot=np.array([1, 2, 3], np.int32),
        period_slots=np.array([3, 4, 5], np.int32),
        n_pkts=np.array([40, 30, 20], np.int32), n_slots=200,
        jitter_slots=2)


PROGRAMS = {
    "chain_defaults": lambda: ref.wired_chain(),
    "chain_12x8_jitter5": lambda: ref.wired_chain(12, 8, jitter_slots=5,
                                                  n_slots=600),
    "full_columns": _full_columns,
}


def _both(prog, replicas, window):
    RefChunkStream.reset()
    ChunkStream.reset()
    with ref_obs():
        want = ref.run_wired(prog, jax.random.key(KEY), replicas=replicas,
                             window_slots=window)
    got = W.run_wired(_port(prog), np.array([0, KEY]), replicas,
                      device="cpu", obs=True, window_slots=window)
    return want, got


@pytest.mark.parametrize("window", [None, 53])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_one_replica_equals_reference_ring_and_stream_included(name, window):
    want, got = _both(PROGRAMS[name](), 1, window)
    for k in FM_KEYS:
        assert _same(got["flow"][k], want["flow"][k]), k
    assert int(got["flow"]["fm_rx"].sum()) > 0
    entries = RefChunkStream.entries("wired")
    assert len(ChunkStream.entries("wired")) == len(entries)
    assert (len(entries) > 1) == (window is not None)
    for a, b in zip(entries, ChunkStream.entries("wired")):
        assert a["t_end"] == b["t_end"] and set(a["metrics"]) == set(
            b["metrics"])
        for k in a["metrics"]:
            assert _same(b["metrics"][k], a["metrics"][k]), k
    plain = W.run_wired(_port(PROGRAMS[name]()), np.array([0, KEY]), 1,
                        device="cpu", window_slots=window)
    for k in ("deliver_slot", "delivered", "served"):
        assert np.array_equal(got[k], plain[k]), k


@pytest.mark.parametrize("window", [None, 53])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_replicas_equal_reference_at_the_window_edge(name, window):
    """Four replicas: every column but ``fm_t0`` equal (C6), and each
    row's ring rows of its own visits are the reference's rows of those
    steps."""
    want, got = _both(PROGRAMS[name](), 4, window)
    for k in EDGE_EQUAL:
        assert _same(got["flow"][k], want["flow"][k]), k
    ring_g, ring_w = got["flow"]["fm_ring"], np.asarray(
        want["flow"]["fm_ring"])
    for r in range(4):
        own = ring_g[r][ring_g[r][:, 0] >= 0]
        theirs = {tuple(row) for row in ring_w[r]}
        # a row the port stamps at its own event is the reference's row of
        # that step unless a later union step took the slot
        later = {int(row[0]) % 512 for row in ring_w[r] if row[0] > 0}
        for row in own:
            assert tuple(row) in theirs or int(row[0]) % 512 in later


def _c6_census(prog, replicas):
    """The C6 class on ``prog``: flows whose ``fm_t0`` differs from the
    reference's, and rows whose raw ring differs."""
    want, got = _both(prog, replicas, None)
    t0_g, t0_w = got["flow"]["fm_t0"], np.asarray(want["flow"]["fm_t0"])
    ring_g = got["flow"]["fm_ring"]
    ring_w = np.asarray(want["flow"]["fm_ring"])
    return dict(
        t0_flows=int((_bits(t0_g) != _bits(t0_w)).sum()),
        ring_rows=int((ring_g != ring_w).any(axis=(1, 2)).sum()),
        flows=int(t0_g.size), rows=int(replicas))


def test_union_clock_class_is_counted():
    """ROADMAP Queue C, C6, counted at eight replicas: the flows whose
    first counted send (``fm_t0``) and the rows whose raw ring differ from
    the reference's, on each program; one replica never differs."""
    census = {name: _c6_census(make(), 8) for name, make in PROGRAMS.items()}
    assert census == {
        "chain_defaults": dict(t0_flows=0, ring_rows=0, flows=24, rows=8),
        "chain_12x8_jitter5": dict(t0_flows=1, ring_rows=0, flows=64,
                                   rows=8),
        "full_columns": dict(t0_flows=2, ring_rows=8, flows=24, rows=8),
    }
    for make in PROGRAMS.values():
        one = _c6_census(make(), 1)
        assert one["t0_flows"] == 0 and one["ring_rows"] == 0


def test_obs_beside_block_false_and_a_bad_grant():
    """``obs=True`` beside ``block=False``: the future's result is the
    blocking run's; a ring counter past the horizon wraps as the
    reference's (slot % 512)."""
    prog = _port(ref.wired_chain(n_slots=700))
    one = W.run_wired(prog, np.array([0, KEY]), 2, device="cpu", obs=True)
    fut = W.run_wired(prog, np.array([0, KEY]), 2, device="cpu", obs=True,
                      block=False)
    res = fut.result()
    for k in FM_KEYS:
        assert _same(res["flow"][k], one["flow"][k]), k
    steps = one["flow"]["fm_ring"][..., 0]
    assert (steps >= 512).any()
    live = steps >= 0
    assert np.array_equal((steps % 512)[live],
                          np.nonzero(live)[1].astype(steps.dtype))
