"""The AS flow engine in the port against the JAX engine, on the CPU.

Programs come from the reference's numpy fields through
``convert.as_from_numpy`` and both engines run with the same key:
``tpudes.parallel.as_flows.run_as_flows`` and
``tpudes_torch.parallel.as_flows.run_as_flows(..., device="cpu")`` (the
plain versions ``spf_math`` and ``fluid_math``, which the kernels of
``csrc/as_flows.cu`` equal bit for bit: ``tests/test_torch_as_mock.py``).

The routing stage's tables (``dist``, ``nh_edge``, ``nh_node``), each
flow's ``path``, ``hops`` and ``unreachable`` are equal; the float outputs
(``goodput_bps``, ``delay_s``, ``delivered_frac``, ``max_util``) are
bit-equal.  Programs: the toy BA programs under both metrics, the
reference tests' overloaded line and exact-``max_hops`` line, truncated
Bellman-Ford rounds that leave flows unreachable, an ON-OFF and an MMPP
workload, a four-point ``rate_scale`` grid whose upper points overload
links, ``chunk_rounds=1``, R = 3 and 5, and the bench's own graph
(``as_program(10_000, 128, 10.0, seed=3)``) at R = 8.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpudes.parallel import as_flows as ref
from tpudes.parallel.programs import toy_as_program as jax_toy
from tpudes.traffic import TrafficProgram as JaxTraffic
from tpudes_torch.convert import AS_FIELDS, as_from_numpy
from tpudes_torch.parallel import as_flows as port
from tpudes_torch.scenarios import as_program

FLOATS = ("goodput_bps", "delay_s", "delivered_frac", "max_util")
INTS = ("hops", "unreachable")


def _port(prog):
    return as_from_numpy({k: getattr(prog, k) for k in AS_FIELDS})


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _same(want: dict, got: dict) -> None:
    assert set(got) == set(FLOATS + INTS)
    for k in FLOATS:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.dtype == np.float32 and g.shape == w.shape, k
        assert np.array_equal(_bits(w), _bits(g)), (
            k, np.flatnonzero(_bits(w) != _bits(g))[:5])
    for k in INTS:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.dtype == w.dtype and np.array_equal(w, g), k


def _routing_equal(jprog) -> dict:
    """The routing tables and paths of both engines equal; returns the
    port's reached flags, paths and hops."""
    ddst, dist, nh_edge, nh_node = ref.device_spf(jprog)
    path, hops, arrived = ref._walk_paths(jprog, ddst, nh_edge, nh_node)
    p = _port(jprog)
    pd, pdist, pe, pn = port.device_spf(p, "cpu")
    assert np.array_equal(np.asarray(ddst), pd.numpy())
    assert np.array_equal(_bits(dist), _bits(pdist.numpy()))
    assert np.array_equal(np.asarray(nh_edge), pe.numpy())
    assert np.array_equal(np.asarray(nh_node), pn.numpy())
    ppath, phops, parr = port.walk_paths(p, pd, pe, pn)
    assert np.array_equal(np.asarray(path), ppath.numpy())
    assert np.array_equal(np.asarray(hops), phops.numpy())
    assert np.array_equal(np.asarray(arrived), parr.numpy())
    return dict(path=ppath, hops=phops)


def _run_both(jprog, replicas, seed=0, **kw):
    want = ref.run_as_flows(jprog, jax.random.PRNGKey(seed), replicas, **kw)
    got = port.run_as_flows(_port(jprog), np.array([0, seed]), replicas,
                            device="cpu", **kw)
    return want, got


def _line(n, caps, delays, src, dst, fbps, **kw):
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], 1).astype(np.int32)
    return ref.AsFlowsProgram(
        n=n, edges=edges, delay_s=np.asarray(delays, float),
        rate_bps=np.asarray(caps, float), src=np.asarray(src, np.int32),
        dst=np.asarray(dst, np.int32), flow_bps=np.asarray(fbps, float),
        pkt_bytes=512, sim_s=1.0, **kw)


@pytest.mark.parametrize("metric", ["hops", "delay"])
@pytest.mark.parametrize("n, flows, rounds, seed", [
    (24, 3, 8, 1), (64, 6, 16, 2), (48, 5, 10, 7)])
def test_toy_programs_equal_reference(metric, n, flows, rounds, seed):
    jprog = dataclasses.replace(jax_toy(n, flows, rounds, seed=seed),
                                spf_metric=metric)
    _routing_equal(jprog)
    _same(*_run_both(jprog, 4, seed=seed))


def test_overloaded_line_equals_reference():
    """tests/test_as_flows.py:172-187: two flows through a line of two
    equal links at twice their capacity (the links' constants fold)."""
    jprog = _line(3, [10e6, 10e6], [1e-3, 1e-3], [0, 0], [2, 2],
                  [10e6, 10e6], rate_jitter=0.0)
    assert port.link_constants(_port(jprog))[3]
    want, got = _run_both(jprog, 4)
    _same(want, got)
    assert (got["delivered_frac"] < 0.51).all()
    assert got["max_util"].max() == pytest.approx(2.0)


def test_overloaded_unequal_line_equals_reference():
    jprog = _line(4, [10e6, 7e6, 30e6], [1e-3, 4e-3, 2e-3], [0, 1, 0],
                  [3, 3, 2], [8e6, 5e6, 9e6], rate_jitter=0.2)
    assert not port.link_constants(_port(jprog))[3]
    want, got = _run_both(jprog, 5, seed=4)
    _same(want, got)
    assert (got["delivered_frac"] < 1.0).any()


def test_exact_max_hops_line_equals_reference():
    """tests/test_as_flows.py:190-209: a path of exactly max_hops hops."""
    jprog = _line(6, [10e6] * 5, [1e-3] * 5, [0], [5], [1e5], max_hops=5,
                  spf_rounds=8, rate_jitter=0.0)
    want, got = _run_both(jprog, 2)
    _same(want, got)
    assert int(got["hops"][0]) == 5 and not got["unreachable"].any()


def test_truncated_rounds_leave_flows_unreachable():
    """Two Bellman-Ford rounds on a long line and a BA graph: the far
    flows stay unreachable (delay inf, delivery 0) in both engines, which
    only Jacobi rounds reproduce."""
    jprog = _line(9, [10e6] * 8, np.linspace(1e-3, 8e-3, 8), [0, 6, 2],
                  [8, 8, 3], [1e6, 2e6, 3e6], spf_rounds=2, max_hops=8)
    r = _routing_equal(jprog)
    want, got = _run_both(jprog, 3)
    _same(want, got)
    assert got["unreachable"].tolist() == [True, False, False]
    assert np.isinf(got["delay_s"][:, 0]).all()
    assert (got["delivered_frac"][:, 0] == 0).all()
    assert int(r["hops"][0]) == 8
    for metric in ("hops", "delay"):
        ba = dataclasses.replace(jax_toy(72, 6, 2, seed=4),
                                 spf_metric=metric)
        _routing_equal(ba)
        want, got = _run_both(ba, 3, seed=2)
        _same(want, got)
        assert got["unreachable"].any()


@pytest.mark.parametrize("model", ["onoff", "mmpp"])
def test_workloads_equal_reference(model):
    jprog = jax_toy(40, 5, 10, seed=6)
    h = int(jprog.sim_s * 1e6)
    if model == "onoff":
        tp = JaxTraffic.onoff(5, 60.0, horizon_us=h, on=(1.5, 0.05, 0.5),
                              off_mean_s=0.2, tr_seed=3)
    else:
        tp = JaxTraffic.mmpp(5, 25.0, horizon_us=h, epoch_s=0.05,
                             mult=(0.5, 2.0), tr_seed=3)
    jprog = dataclasses.replace(jprog, traffic=tp,
                                flow_bps=np.linspace(1e5, 9e6, 5))
    want, got = _run_both(jprog, 3, seed=9)
    _same(want, got)
    base = port.run_as_flows(_port(dataclasses.replace(jprog, traffic=None)),
                             np.array([0, 9]), 3, device="cpu")
    assert not np.array_equal(base["goodput_bps"], got["goodput_bps"])


def test_cbr_workload_is_the_constant_rate_run():
    jprog = jax_toy(32, 4, 8, seed=2)
    tp = JaxTraffic.cbr(np.zeros(4, np.int32), 10_000)
    want, got = _run_both(dataclasses.replace(jprog, traffic=tp), 3)
    _same(want, got)
    plain = port.run_as_flows(_port(jprog), np.array([0, 0]), 3,
                              device="cpu")
    _same(plain, got)


def test_rate_scale_grid_overloads_and_equals_reference():
    jprog = dataclasses.replace(jax_toy(40, 5, 10, seed=3),
                                flow_bps=np.full(5, 2e7))
    scales = [0.25, 1.0, 3.0, 8.0]
    want, got = _run_both(jprog, 3, seed=5, rate_scale=scales)
    assert len(got) == 4
    for w, g in zip(want, got):
        _same(w, g)
    assert (got[0]["delivered_frac"] == 1.0).all()
    assert (got[3]["delivered_frac"] < 1.0).any()
    assert got[3]["max_util"].min() > 1.0
    single = port.run_as_flows(_port(jprog), np.array([0, 5]), 3,
                               device="cpu")
    _same(single, got[1])


@pytest.mark.parametrize("chunk", [1, 3])
def test_chunk_rounds_equal_single_shot(chunk):
    jprog = dataclasses.replace(jax_toy(40, 5, 10, seed=3),
                                flow_bps=np.full(5, 5e7))
    want, got = _run_both(jprog, 4, seed=1, chunk_rounds=chunk)
    _same(want, got)
    single = port.run_as_flows(_port(jprog), np.array([0, 1]), 4,
                               device="cpu")
    _same(single, got)


@pytest.mark.parametrize("replicas", [3, 5])
def test_replica_counts_that_are_not_powers_of_two(replicas):
    jprog = jax_toy(48, 4, 12, seed=5)
    _same(*_run_both(jprog, replicas, seed=replicas))


def test_bench_graph_equals_reference():
    """BASELINE config #5's program (bench.py::bench_as's graph: 10,000
    nodes, 128 flows) at R = 8."""
    p = as_program(10_000, 128, 10.0, seed=3)
    jprog = ref.AsFlowsProgram(**{k: getattr(p, k) for k in AS_FIELDS})
    r = _routing_equal(jprog)
    want, got = _run_both(jprog, 8, seed=3)
    _same(want, got)
    assert not got["unreachable"].any()
    assert int(r["hops"].max()) >= 4


def test_refusals_name_their_roadmap_items():
    p = _port(jax_toy(24, 2, 6))
    key = np.array([0, 0])
    for kw, item in ((dict(mesh=object()), "A12"),
                     (dict(checkpoint="x", mesh=object()), "A12"),
                     (dict(block=False, mesh=object()), "A12")):
        with pytest.raises(NotImplementedError, match=item):
            port.run_as_flows(p, key, 2, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="A14"):
        port.run_as_flows(dataclasses.replace(p, surrogate=object()), key, 2,
                          device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port.run_as_flows(p, key, 2)


def test_obs_runs_and_leaves_the_outputs():
    """``obs=True`` (once refused, ROADMAP A10) runs: the outputs are the
    obs=False run's, and a chunked run streams one ``max_util`` a chunk
    (tests/test_torch_obs_engines.py holds them against the reference)."""
    from tpudes_torch.obs.device import ChunkStream

    p = _port(jax_toy(24, 2, 6))
    key = np.array([0, 0])
    ChunkStream.reset()
    got = port.run_as_flows(p, key, 2, device="cpu", obs=True,
                            chunk_rounds=2)
    plain = port.run_as_flows(p, key, 2, device="cpu", chunk_rounds=2)
    for k in ("goodput_bps", "delay_s", "max_util"):
        assert np.array_equal(got[k], plain[k]), k
    entries = ChunkStream.entries("as_flows")
    assert len(entries) >= 2 and all(
        set(e["metrics"]) == {"max_util"} for e in entries)
    ChunkStream.reset()


def test_obs_beside_block_false_flushes_at_the_result():
    """``obs=True, block=False``: the last chunk's metrics are recorded
    when the future's result is taken, not at the launch."""
    from tpudes_torch.obs.device import ChunkStream

    p = _port(jax_toy(24, 2, 6))
    ChunkStream.reset()
    fut = port.run_as_flows(p, np.array([0, 0]), 2, device="cpu", obs=True,
                            chunk_rounds=2, block=False)
    before = len(ChunkStream.entries("as_flows"))
    fut.result()
    assert len(ChunkStream.entries("as_flows")) == before + 1
    ChunkStream.reset()
