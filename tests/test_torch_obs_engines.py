"""``obs=True`` through the port's engines against the JAX engines under
``TpudesObs=1``: the LTE SM engine (every arm, the scheduler grid), the
TCP dumbbell (bulk, RED/ECN, app-limited, both grids), the AS flow
engine's chunk stream and the hybrid's distributed record.

One program and key through both packages on the CPU.  Per replica the
FlowMonitor columns are equal (integers) and bit-equal (floats), the rings
equal, the engines' own obs counters equal; the core outputs equal the
``obs=False`` run's; a chunked run's ChunkStream entries equal the
reference's (engine, bound, every metric's shape, dtype and bits).  The
reference's knob is bound for the reference's calls only and cleared
after (the world reset after each test clears it too).  Tolerance: none.
"""

import contextlib
import dataclasses
import warnings

import jax
import numpy as np
import pytest

from tpudes.core.global_value import GlobalValue
from tpudes.core.world import reset_world
from tpudes.obs.device import ChunkStream as RefChunkStream
from tpudes.obs.distributed import DistributedTelemetry as RefDist
from tpudes.parallel import as_flows as ref_as
from tpudes.parallel import hybrid as ref_hybrid
from tpudes.parallel import tcp_dumbbell as ref_tcp
from tpudes.parallel import wired as ref_wired
from tpudes.parallel.lte_sm import lower_lte_sm
from tpudes.parallel.lte_sm import run_lte_sm as ref_run_lte
from tpudes.parallel.programs import toy_as_program as jax_toy_as
from tpudes.parallel.programs import toy_traffic_points as jax_toy_points
from tpudes.scenarios import build_dumbbell, build_lena
from tpudes_torch.convert import (
    AS_FIELDS,
    DUMBBELL_FIELDS,
    PROGRAM_FIELDS,
    TRAFFIC_FIELDS,
    WIRED_FIELDS,
    as_from_numpy,
    dumbbell_from_numpy,
    program_from_numpy,
    traffic_from_numpy,
    wired_from_numpy,
)
from tpudes_torch.obs.device import ChunkStream, CompileTelemetry
from tpudes_torch.obs.distributed import DistributedTelemetry
from tpudes_torch.obs.flowmon import FM_KEYS
from tpudes_torch.obs.geometry import GeomTelemetry
from tpudes_torch.obs.traffic import TrafficTelemetry
from tpudes_torch.parallel import as_flows as port_as
from tpudes_torch.parallel import hybrid as port_hybrid
from tpudes_torch.parallel import tcp_dumbbell as port_tcp
from tpudes_torch.parallel.lte_sm import run_lte_sm
from tpudes_torch.parallel.runtime import RUNTIME
from tpudes_torch.random import PRNGKey

KEY = 3


@contextlib.contextmanager
def ref_obs():
    """The reference's ``TpudesObs`` knob up for the block, then down."""
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


def _same_flow(got: dict, want: dict, skip=()) -> None:
    for k in FM_KEYS:
        if k not in skip:
            assert _same(got[k], want[k]), k


def _same_stream(engine: str) -> int:
    """The port's ChunkStream entries of ``engine`` equal the
    reference's; returns their count."""
    want, got = RefChunkStream.entries(engine), ChunkStream.entries(engine)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a["t_end"] == b["t_end"]
        assert set(a["metrics"]) == set(b["metrics"])
        for k in a["metrics"]:
            assert _same(b["metrics"][k], a["metrics"][k]), (engine, k)
    return len(got)


@pytest.fixture(autouse=True)
def _fresh_streams():
    RefChunkStream.reset()
    ChunkStream.reset()
    yield
    RefChunkStream.reset()
    ChunkStream.reset()


# --------------------------------------------------------------------------
# LTE


@pytest.fixture(scope="module")
def lena():
    reset_world()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the short-horizon advisory
        lte, _ = build_lena(2, 4)
        prog = lower_lte_sm(lte, 0.1)
    reset_world()
    return prog


def _lte_port(prog):
    return program_from_numpy({k: getattr(prog, k) for k in PROGRAM_FIELDS})


LTE_INT = ("rx_bits", "new_tbs", "retx", "drops", "ok", "cqi", "mcs")


@pytest.mark.parametrize("kw", [
    dict(replicas=3), dict(), dict(replicas=3, schedulers=["pf", "rr"]),
], ids=["replicas", "single", "scheduler_grid"])
def test_lte_static_flow_columns_and_stream_equal_reference(lena, kw):
    """The static arm's FlowMonitor columns (one flow a UE, bytes from
    the split rx counter, a one-TTI delay, the ring's argmax by UE index)
    and its chunk stream (ok, drops, retx and the reversed ring per
    lane) equal the reference's; the outputs equal the obs=False run's."""
    with ref_obs():
        want = ref_run_lte(lena, jax.random.PRNGKey(KEY), chunk_ttis=40,
                           **kw)
    got = run_lte_sm(_lte_port(lena), PRNGKey(KEY), device="cpu", obs=True,
                     chunk_ttis=40, **kw)
    plain = run_lte_sm(_lte_port(lena), PRNGKey(KEY), device="cpu", **kw)
    wants = want if isinstance(want, list) else [want]
    gots = got if isinstance(got, list) else [got]
    plains = plain if isinstance(plain, list) else [plain]
    for w, g, p in zip(wants, gots, plains):
        _same_flow(g["flow"], w["flow"])
        assert int(g["flow"]["fm_rx"].sum()) > 0
        for k in LTE_INT:
            assert np.array_equal(g[k], p[k]), k
        assert "flow" not in p
    assert _same_stream("lte_sm") == 3


def _lte_arm(arm: str):
    """The reference's moving lena drop (const velocity, stride 8) or the
    static drop with an ON-OFF workload (one entity a UE), and its port."""
    from tpudes.traffic import TrafficProgram as JaxTraffic
    from tpudes_torch.convert import MOBILITY_FIELDS, mobility_from_numpy

    reset_world()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if arm == "mobile":
            lte, _ = build_lena(2, 4, mobility="const_velocity", speed=10.0)
            prog = lower_lte_sm(lte, 0.06, geom_stride=8)
        else:
            lte, _ = build_lena(2, 4)
            prog = lower_lte_sm(lte, 0.06)
            prog = dataclasses.replace(prog, traffic=JaxTraffic.onoff(
                prog.n_ue, 200.0, horizon_us=prog.n_ttis * 1000,
                on=(1.5, 0.01, 0.05), off_mean_s=0.02, tr_seed=2))
    reset_world()
    port = program_from_numpy(
        {k: getattr(prog, k) for k in PROGRAM_FIELDS},
        None if prog.mobility is None else mobility_from_numpy(
            {k: getattr(prog.mobility, k) for k in MOBILITY_FIELDS}),
        traffic=None if prog.traffic is None else traffic_from_numpy(
            {k: getattr(prog.traffic, k) for k in TRAFFIC_FIELDS}))
    return prog, port


@pytest.mark.parametrize("arm", ["mobile", "traffic"])
def test_lte_mobile_and_traffic_arms_stream_as_reference(arm):
    """The mobile and traffic arms have no columns in the reference; their
    chunk streams (the counters summed over every lane), the geometry
    refreshes and the workload they record equal the reference's."""
    from tpudes.obs.geometry import GeomTelemetry as RefGeom
    from tpudes.obs.traffic import TrafficTelemetry as RefTraffic

    jprog, port = _lte_arm(arm)
    for reg in (RefGeom, RefTraffic, GeomTelemetry, TrafficTelemetry):
        reg.reset()
    with ref_obs():
        want = ref_run_lte(jprog, jax.random.PRNGKey(KEY), replicas=2,
                           chunk_ttis=25, schedulers=["pf", "fdmt"])
    got = run_lte_sm(port, PRNGKey(KEY), replicas=2, device="cpu",
                     obs=True, chunk_ttis=25, schedulers=["pf", "fdmt"])
    for w, g in zip(want, got):
        assert "flow" not in w and "flow" not in g
        for k in LTE_INT:
            assert np.array_equal(g[k], np.asarray(w[k])), k
    assert _same_stream("lte_sm") == 3
    if arm == "mobile":
        assert GeomTelemetry.snapshot() == RefGeom.snapshot()
        assert GeomTelemetry.engine("lte_sm")["device_refreshes"] > 0
    else:
        assert TrafficTelemetry.snapshot() == RefTraffic.snapshot()
        assert TrafficTelemetry.engine("lte_sm")["runs"] == 1


def test_nine_scheduler_sweep_compiles_once(lena):
    """Nine scheduler runs share one runner (the scheduler is a launch's
    operand): CompileTelemetry counts one ``lte_sm`` entry, as the
    reference pins ``compiles == 1``."""
    from tpudes.parallel.lte_sm import SM_SCHED_IDS

    RUNTIME.clear("lte_sm")
    CompileTelemetry.reset()
    prog = dataclasses.replace(_lte_port(lena), n_ttis=5)
    for sched in SM_SCHED_IDS:
        run_lte_sm(dataclasses.replace(prog, scheduler=sched), PRNGKey(KEY),
                   replicas=2, device="cpu", obs=True)
    assert CompileTelemetry.compiles("lte_sm") == 1
    snap = CompileTelemetry.snapshot()["lte_sm"]
    assert snap["compiles"] == 1 and snap["wall_s"] >= 0.0


# --------------------------------------------------------------------------
# TCP dumbbell


def _dumbbell(spec: dict, sim_s: float):
    spec = dict(spec)
    red = spec.pop("red", None)
    reset_world()
    try:
        db, _ = build_dumbbell(**spec)
        if red is not None:
            from tpudes.models.traffic_control import TrafficControlHelper

            tch = TrafficControlHelper()
            tch.SetRootQueueDisc("tpudes::RedQueueDisc", **red)
            tch.Install(db.GetBottleneckDevices().Get(0))
        prog = ref_tcp.lower_dumbbell(spec["sim_time"])
    finally:
        reset_world()
    n = int(np.ceil(sim_s / prog.slot_s))
    return dataclasses.replace(
        prog, n_slots=n,
        stop_slot=np.minimum(prog.stop_slot, int(sim_s / prog.slot_s)))


TCP_SPECS = {
    "red_ecn": (dict(n_flows=4, sim_time=2.0,
                     variants=["TcpDctcp", "TcpNewReno"] * 2,
                     bottleneck_rate="5Mbps",
                     red=dict(MinTh=5.0, MaxTh=15.0, MaxSize=60,
                              UseEcn=True, UseHardDrop=False)), 0.5, {}),
    "variant_grid": (dict(n_flows=3, sim_time=1.7,
                          variants=["TcpLp", "TcpBbr", "TcpDctcp"],
                          bottleneck_rate="10Mbps", bottleneck_delay="10ms",
                          queue="100p", seg_bytes=500), 0.25,
                     dict(variants=[["TcpLp", "TcpBbr", "TcpDctcp"],
                                    ["TcpCubic"] * 3])),
    "bulk_chunked": (dict(n_flows=2, sim_time=0.9,
                          variants=["TcpVeno", "TcpBic"],
                          bottleneck_rate="3Mbps", bottleneck_delay="20ms",
                          queue="25p", seg_bytes=500), 0.5,
                     dict(chunk_slots=200)),
}


def _tcp_port(prog):
    return dumbbell_from_numpy({k: getattr(prog, k)
                                for k in DUMBBELL_FIELDS})


def _tcp_equal(want, got, plain):
    wants = want if isinstance(want, list) else [want]
    gots = got if isinstance(got, list) else [got]
    plains = plain if isinstance(plain, list) else [plain]
    for w, g, p in zip(wants, gots, plains):
        for k in ("cwnd_cuts", "retx", "queue_hist"):
            assert _same(g[k], w[k]), k
        _same_flow(g["flow"], w["flow"])
        for k in ("delivered", "drops", "goodput_mbps", "cwnd_final"):
            assert _same(g[k], p[k]), k
        assert int(g["flow"]["fm_rx"].sum()) > 0


@pytest.mark.parametrize("name", sorted(TCP_SPECS))
def test_tcp_obs_equal_reference(name):
    """cwnd cuts, consumed losses, the occupancy histogram, the
    FlowMonitor columns (the delay one multiply-add, as the reference's
    compiled step fuses it) and the ring equal the reference's; so does a
    chunked run's stream."""
    spec, sim_s, kw = TCP_SPECS[name]
    prog = _dumbbell(spec, sim_s)
    jkw = dict(kw)
    if "variants" in jkw:
        jkw["variants"] = [[ref_tcp.VARIANTS.index(v) for v in p]
                           for p in jkw["variants"]]
    with ref_obs():
        want = ref_tcp.run_tcp_dumbbell(prog, jax.random.PRNGKey(5), 3,
                                        **jkw)
    got = port_tcp.run_tcp_dumbbell(_tcp_port(prog), PRNGKey(5), 3,
                                    device="cpu", obs=True, **kw)
    plain = port_tcp.run_tcp_dumbbell(_tcp_port(prog), PRNGKey(5), 3,
                                      device="cpu", **kw)
    _tcp_equal(want, got, plain)
    assert (_same_stream("dumbbell") > 1) == ("chunk_slots" in kw)


def test_tcp_app_limited_workload_grid_obs_equal_reference():
    """The app-limited arm over a three-point workload grid."""
    from tpudes.parallel.programs import toy_dumbbell_program as jax_toy_db

    jp = jax_toy_db(2, 300)
    pts = jax_toy_points(2, int(jp.n_slots * jp.slot_s * 1e6))[:3]
    jp = dataclasses.replace(jp, traffic=pts[0])
    port = dataclasses.replace(_tcp_port(jp), traffic=traffic_from_numpy(
        {k: getattr(pts[0], k) for k in TRAFFIC_FIELDS}))
    sweep = [traffic_from_numpy({k: getattr(p, k) for k in TRAFFIC_FIELDS})
             for p in pts]
    with ref_obs():
        want = ref_tcp.run_tcp_dumbbell(jp, jax.random.PRNGKey(2), 2,
                                        traffic_sweep=pts, chunk_slots=128)
    got = port_tcp.run_tcp_dumbbell(port, PRNGKey(2), 2, device="cpu",
                                    obs=True, traffic_sweep=sweep,
                                    chunk_slots=128)
    plain = port_tcp.run_tcp_dumbbell(port, PRNGKey(2), 2, device="cpu",
                                      traffic_sweep=sweep)
    _tcp_equal(want, got, plain)
    assert _same_stream("dumbbell") >= 2


# --------------------------------------------------------------------------
# AS flows and the hybrid


@pytest.mark.parametrize("kw", [dict(chunk_rounds=3),
                                dict(chunk_rounds=2, rate_scale=[0.5, 2.0])],
                         ids=["chunked", "rate_grid"])
def test_as_flows_stream_max_util_as_reference(kw):
    """The fixed point's chunk summary ``max_util`` (the largest link
    utilisation over the replicas, a point's) streams as the reference's;
    the outputs equal the obs=False run's."""
    jp = jax_toy_as(n_nodes=40, n_flows=6, spf_rounds=12)
    port = as_from_numpy({k: getattr(jp, k) for k in AS_FIELDS})
    with ref_obs():
        ref_as.run_as_flows(jp, jax.random.PRNGKey(0), 3, **kw)
    got = port_as.run_as_flows(port, np.array([0, 0]), 3, device="cpu",
                               obs=True, **kw)
    plain = port_as.run_as_flows(port, np.array([0, 0]), 3, device="cpu",
                                 **kw)
    for g, p in zip(got if isinstance(got, list) else [got],
                    plain if isinstance(plain, list) else [plain]):
        for k in ("goodput_bps", "delay_s", "max_util"):
            assert _same(g[k], p[k]), k
    assert _same_stream("as_flows") >= 1


@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("transport", ["local", "batched"])
def test_hybrid_distributed_record_counts_equal_reference(ranks, transport):
    """``run_hybrid(telemetry=True)``: per rank the windows, the grants'
    sum and most, and the boundary packets out and in equal what the
    reference's drivers record (the walls are the hosts')."""
    prog = (ref_wired.wired_weak_chain(ranks, n_slots=600) if ranks > 1
            else ref_wired.wired_chain(n_slots=300))
    port = wired_from_numpy({k: getattr(prog, k) for k in WIRED_FIELDS})
    RefDist.reset()
    DistributedTelemetry.reset()
    ref_hybrid.run_hybrid(prog, jax.random.key(7), 2, transport=transport,
                          window_slots=40)
    got = port_hybrid.run_hybrid(port, np.array([0, 7]), 2,
                                 transport=transport, window_slots=40,
                                 telemetry=True, device="cpu")
    want, snap = RefDist.snapshot(), DistributedTelemetry.snapshot()
    keys = ("windows", "grant_slots_sum", "grant_slots_max", "tx_pkts",
            "rx_pkts", "transport_tx", "transport_rx")
    assert snap["counters"] == want["counters"]
    assert snap["counters"]["windows"] == got["windows"] * ranks
    assert set(snap["ranks"]) == set(want["ranks"])
    for r, entry in want["ranks"].items():
        assert {k: snap["ranks"][r][k] for k in keys} == \
            {k: entry[k] for k in keys}, r
    if ranks > 1:
        assert snap["counters"]["boundary_tx"] > 0
    RefDist.reset()
    DistributedTelemetry.reset()
