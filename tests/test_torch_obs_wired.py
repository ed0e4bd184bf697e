"""``obs=True`` through the port's wired engine against the JAX engine
under ``TpudesObs=1``.

The reference steps every replica's row on one clock, the union of all
rows' next events, from the window's first slot; so does the port's plain
version with the columns (ROADMAP Queue C, C6, closed).  So at any replica
count every FlowMonitor column (``fm_t0`` included), the raw ring (the
reference's -1 rows at union steps where a row was idle included) and
each window's ChunkStream entry (``next_event``, ``n_steps``, the ring)
are equal: one replica, three (padded to their bucket of four, whose
padded row joins the union), four and eight, one window and windows of
53 slots.  Deliveries inside a step are grouped by slot: one delay
observation per (slot, flow).  Tolerance: none (the f32 delay sums are
integer-valued and below 2^24 slots, exact in any order).  The reference
runs are shared by the tests of the module.
"""

import contextlib
import functools

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
from tpudes_torch.parallel.runtime import bucket_replicas

KEY = 11


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


@functools.lru_cache(maxsize=None)
def _both(name, replicas, window):
    """The reference's and the port's ``obs=True`` runs of program
    ``name`` and their ChunkStream entries, once a module."""
    RefChunkStream.reset()
    ChunkStream.reset()
    prog = PROGRAMS[name]()
    with ref_obs():
        want = ref.run_wired(prog, jax.random.key(KEY), replicas=replicas,
                             window_slots=window)
    got = W.run_wired(_port(prog), np.array([0, KEY]), replicas,
                      device="cpu", obs=True, window_slots=window)
    return dict(want=want, got=got,
                want_entries=RefChunkStream.entries("wired"),
                got_entries=ChunkStream.entries("wired"))


def _assert_equal(name, replicas, window):
    """Every column, the raw ring and every ChunkStream entry equal."""
    run = _both(name, replicas, window)
    want, got = run["want"], run["got"]
    for k in FM_KEYS:
        assert _same(got["flow"][k], want["flow"][k]), k
    assert int(got["flow"]["fm_rx"].sum()) > 0
    entries = run["want_entries"]
    assert len(run["got_entries"]) == len(entries)
    assert (len(entries) > 1) == (window is not None)
    for a, b in zip(entries, run["got_entries"]):
        assert a["t_end"] == b["t_end"] and set(a["metrics"]) == set(
            b["metrics"])
        for k in a["metrics"]:
            assert _same(b["metrics"][k], a["metrics"][k]), k
    return run


@pytest.mark.parametrize("window", [None, 53])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_one_replica_equals_reference_ring_and_stream_included(name, window):
    got = _assert_equal(name, 1, window)["got"]
    plain = W.run_wired(_port(PROGRAMS[name]()), np.array([0, KEY]), 1,
                        device="cpu", window_slots=window)
    for k in ("deliver_slot", "delivered", "served"):
        assert np.array_equal(got[k], plain[k]), k


@pytest.mark.parametrize("window", [None, 53])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_replicas_equal_reference_at_the_window_edge(name, window):
    """Four replicas on the union clock: every column, ``fm_t0``
    included, the raw ring and each window's entry equal."""
    run = _assert_equal(name, 4, window)
    ring = run["got"]["flow"]["fm_ring"]
    # the union clock stamps -1 rows where a row was idle
    assert (ring[..., 0] == -1).any() and (ring[..., 0] >= 0).any()


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_three_replicas_bucketed_equal_reference(name):
    """Three replicas over windows of 53 slots, padded to their bucket of
    four: the padded row joins the union clock, as the reference's does."""
    assert bucket_replicas(3) == 4
    got = _assert_equal(name, 3, 53)["got"]
    assert got["flow"]["fm_t0"].shape[0] == 3


def _c6_census(name, replicas):
    """The C6 class on program ``name``: flows whose ``fm_t0`` differs
    from the reference's, and rows whose raw ring differs."""
    run = _both(name, replicas, None)
    t0_g = run["got"]["flow"]["fm_t0"]
    t0_w = np.asarray(run["want"]["flow"]["fm_t0"])
    ring_g = run["got"]["flow"]["fm_ring"]
    ring_w = np.asarray(run["want"]["flow"]["fm_ring"])
    return dict(
        t0_flows=int((_bits(t0_g) != _bits(t0_w)).sum()),
        ring_rows=int((ring_g != ring_w).any(axis=(1, 2)).sum()),
        flows=int(t0_g.size), rows=int(replicas))


def test_union_clock_class_is_counted():
    """ROADMAP Queue C, C6, closed: at eight replicas no flow's first
    counted send (``fm_t0``) and no row's raw ring differs from the
    reference's on any program (a per-row clock differs for 1 of 64 and
    2 of 24 flows and 8 of 8 rows), and every column and entry is equal;
    one replica never differs."""
    census = {name: _c6_census(name, 8) for name in PROGRAMS}
    assert census == {
        "chain_defaults": dict(t0_flows=0, ring_rows=0, flows=24, rows=8),
        "chain_12x8_jitter5": dict(t0_flows=0, ring_rows=0, flows=64,
                                   rows=8),
        "full_columns": dict(t0_flows=0, ring_rows=0, flows=24, rows=8),
    }
    for name in PROGRAMS:
        _assert_equal(name, 8, None)
        one = _c6_census(name, 1)
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
