"""``obs=True`` through the port's WiFi BSS engine against the JAX
engine under ``TpudesObs=1``: the legacy, A-MPDU (``AGG``), mobile
(``MOB``) and workload (``TRF``) arms, the horizon grid and the workload
grid, chunked.

Per replica the failed exchanges (``retx``) and the FlowMonitor columns
(one flow a node, the delay the exchange's airtime, its histogram bin as
the reference's compiled step computes it) are equal, floats bit-equal,
and the ring equal, its idle rows too (the reference's shared step counter
keeps stamping a finished replica's ring until its point's last replica
finishes); the core outputs equal the ``obs=False`` run's; a chunked run's
ChunkStream entries equal the reference's.  Tolerance: none.
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
from tpudes.parallel.programs import toy_bss_program as jax_toy_bss
from tpudes.parallel.programs import toy_traffic_points as jax_toy_points
from tpudes.parallel.replicated import lower_bss
from tpudes.parallel.replicated import run_replicated_bss as ref_run
from tpudes.scenarios import build_bss
from tpudes_torch.convert import (
    BSS_FIELDS,
    MOBILITY_FIELDS,
    TRAFFIC_FIELDS,
    bss_from_numpy,
    mobility_from_numpy,
    traffic_from_numpy,
)
from tpudes_torch.obs.device import ChunkStream
from tpudes_torch.obs.flowmon import FM_KEYS
from tpudes_torch.obs.geometry import GeomTelemetry
from tpudes_torch.parallel import replicated as bss
from tpudes_torch.random import PRNGKey

OUT = ("srv_rx", "cli_rx", "tx_data", "drops", "steps", "all_done")


@contextlib.contextmanager
def ref_obs():
    GlobalValue.Bind("TpudesObs", 1)
    try:
        yield
    finally:
        GlobalValue.Bind("TpudesObs", 0)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        _bits(a), _bits(b))


def _tr(tp):
    return traffic_from_numpy({k: getattr(tp, k) for k in TRAFFIC_FIELDS})


def _port(prog):
    mob = None if prog.mobility is None else mobility_from_numpy(
        {k: getattr(prog.mobility, k) for k in MOBILITY_FIELDS})
    return bss_from_numpy({k: getattr(prog, k) for k in BSS_FIELDS}, mob,
                          None if prog.traffic is None else _tr(prog.traffic))


def _ht_rings():
    """8 STAs on 12/20/28 m rings under 802.11n aggregation (the outer
    ring's A-MPDUs succeed in part), to 1.2 s (the clients start at 1 s)."""
    reset_world()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sta, ap, clients, _ = build_bss(
            8, 1.2, radii=(12.0, 20.0, 28.0), interval_s=0.01,
            data_mode="HtMcs7", standard="80211n")
        prog = lower_bss([sta.Get(i) for i in range(sta.GetN())], ap,
                         clients, 1.2)
    reset_world()
    return prog


def _moving(prog):
    """The toy BSS with its STAs moving at constant velocity."""
    from tpudes.ops.mobility import MobilityProgram

    n = prog.n
    rng = np.random.default_rng(1)
    base = np.asarray(prog.positions, np.float32)
    vel = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    vel[0] = 0.0
    vel[:, 2] = 0.0
    return dataclasses.replace(
        prog, mobility=MobilityProgram.constant_velocity(base, vel),
        geom_stride=4)


def _case(name):
    jp = jax_toy_bss(8, 150_000 if name == "trf_workload_grid" else 300_000)
    pts = jax_toy_points(jp.n, jp.sim_end_us, start_us=jp.start_us,
                         beacon=(int(jp.interval_us[0]),
                                 int(jp.start_us[0])))
    if name == "legacy_horizon_grid_chunked":
        return jp, dict(sim_end_us=[200_000, 300_000], chunk_steps=150)
    if name == "agg":
        return _ht_rings(), {}
    if name == "mob":
        return _moving(jp), dict(chunk_steps=100)
    if name == "trf":
        return dataclasses.replace(jp, traffic=pts[2]), {}
    return dataclasses.replace(jp, traffic=pts[2]), dict(
        traffic_sweep=pts[2:4])


@pytest.mark.parametrize("name", ["legacy_horizon_grid_chunked", "agg", "mob",
                                  "trf", "trf_workload_grid"])
def test_bss_obs_equal_reference(name):
    jp, kw = _case(name)
    RefChunkStream.reset()
    ChunkStream.reset()
    GeomTelemetry.reset()
    with ref_obs():
        want = ref_run(jp, 3, jax.random.PRNGKey(4), **kw)
    pkw = dict(kw)
    if "traffic_sweep" in pkw:
        pkw["traffic_sweep"] = [_tr(tp) for tp in pkw["traffic_sweep"]]
    got = bss.run_replicated_bss(_port(jp), 3, PRNGKey(4), device="cpu",
                                 obs=True, **pkw)
    plain = bss.run_replicated_bss(_port(jp), 3, PRNGKey(4), device="cpu",
                                   **pkw)
    wants = want if isinstance(want, list) else [want]
    gots = got if isinstance(got, list) else [got]
    plains = plain if isinstance(plain, list) else [plain]
    for w, g, p in zip(wants, gots, plains):
        assert _same(g["retx"], w["retx"])
        for k in FM_KEYS:
            assert _same(g["flow"][k], w["flow"][k]), k
        for k in OUT:
            assert np.array_equal(np.asarray(g[k]), np.asarray(p[k])), k
        assert int(g["flow"]["fm_rx"].sum()) > 0
    entries = RefChunkStream.entries("bss")
    assert len(ChunkStream.entries("bss")) == len(entries)
    assert (len(entries) > 1) == ("chunk_steps" in kw)
    for a, b in zip(entries, ChunkStream.entries("bss")):
        assert a["t_end"] == b["t_end"]
        for k in a["metrics"]:
            assert _same(b["metrics"][k], a["metrics"][k]), k
    if name == "mob":
        assert GeomTelemetry.engine("bss")["device_refreshes"] > 0
    RefChunkStream.reset()
    ChunkStream.reset()


def test_idle_ring_rows_of_a_finished_replica_equal_reference():
    """A replica that finishes before the last of its point keeps stamping
    idle rows (step -1, the next event then the horizon) into its ring
    while the shared counter runs: ``bss_cuda.idle_ring_rows`` writes the
    same rows the plain loop does, from the replicas' own stops."""
    import torch

    from tpudes_torch.parallel.bss_cuda import idle_ring_rows

    prog = bss.build_bss_consts(_port(jax_toy_bss(4, 120_000)), "cpu")
    ring = torch.full((2, 3, 512, 5), -1, dtype=torch.int32)
    ring[..., 0] = torch.arange(512, dtype=torch.int32)
    done = torch.tensor([[5, 700, 701], [3, 3, 3]], dtype=torch.int32)
    last = done.amax(1)
    first = torch.tensor([[111, 222, 0], [0, 0, 0]], dtype=torch.int32)
    end = torch.tensor([[120_000], [90_000]], dtype=torch.int32)
    out = idle_ring_rows(ring, done, last, first, end, prog["pkt_bytes"])
    # row (0, 0) idled over steps 5..700: every slot, the last 512 steps
    s = torch.arange(512)
    step = 700 - ((700 - s) % 512)
    assert torch.equal(out[0, 0, :, 0], torch.full((512,), -1,
                                                   dtype=torch.int32))
    want_t = torch.where(step == 5, 111, 120_000).to(torch.int32)
    assert torch.equal(out[0, 0, :, 1], want_t)
    assert (out[0, 0, :, 3] == prog["pkt_bytes"]).all()
    # row (0, 1) idled over step 700 only; row (0, 2) and point 1 not at all
    assert torch.equal(out[0, 1, 700 % 512], torch.tensor(
        [-1, 222, 0, prog["pkt_bytes"], 0], dtype=torch.int32))
    keep = torch.ones(512, dtype=torch.bool)
    keep[700 % 512] = False
    assert torch.equal(out[0, 1, keep], ring[0, 1, keep])
    assert torch.equal(out[0, 2], ring[0, 2])
    assert torch.equal(out[1], ring[1])


def test_bss_obs_block_false_and_checkpoint_resume(tmp_path):
    """``obs=True`` beside ``block=False`` returns a future whose result
    is the blocking run's, its last chunk's metrics flushed at the result
    (not at the launch); a checkpointed run resumed from its last chunk
    gives the same columns."""
    prog = _port(jax_toy_bss(4, 120_000))
    ChunkStream.reset()
    fut = bss.run_replicated_bss(prog, 2, PRNGKey(1), device="cpu",
                                 obs=True, block=False, chunk_steps=40)
    n = len(ChunkStream.entries("bss"))
    res = fut.result()
    assert len(ChunkStream.entries("bss")) == n + 1
    one = bss.run_replicated_bss(prog, 2, PRNGKey(1), device="cpu",
                                 obs=True)
    ck = tmp_path / "bss.ckpt"
    bss.run_replicated_bss(prog, 2, PRNGKey(1), device="cpu", obs=True,
                           chunk_steps=40, checkpoint=str(ck))
    again = bss.run_replicated_bss(prog, 2, PRNGKey(1), device="cpu",
                                   obs=True, chunk_steps=40,
                                   checkpoint=str(ck))
    for out in (res, again):
        assert _same(out["retx"], one["retx"])
        for k in FM_KEYS:
            assert _same(out["flow"][k], one["flow"][k]), k
    ChunkStream.reset()
