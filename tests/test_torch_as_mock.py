"""``csrc/as_flows.cu`` on the CPU, through the CUDA mock.

The kernels' source is built by ``g++`` against
``tpudes_torch/csrc/mock/cuda_runtime.h`` (a fiber per CUDA thread) and
called through ``as_cuda.spf_cuda``, ``as_cuda.fluid_cuda`` and
``as_cuda.erf_inv_check`` on CPU tensors:

- ``as_spf`` (the frontier rounds, the next hops and the walk) bit-equal
  to ``spf_math`` + ``walk_math`` (``dist``, ``nh_edge``, ``nh_node``,
  ``path``, ``hops``, ``reached``; the walk equal to ``walk_paths``) on
  toy BA programs under both metrics, at truncated rounds 1-3, its rows in
  shared memory and in device memory (``GLOBAL``), and on a star whose
  hub has 70 neighbours (a warp strides its list three times) with a path
  beyond it;
- ``as_fluid`` (the draws and the fixed point) bit-equal to
  ``as_replica_draws`` + ``fluid_math`` on a toy program, a rate-scale
  grid that overloads links, a line of equal links (the folded delay), a
  run split into launches that carry the links' log deliveries, and the
  draws ``z`` over a range of keys; its ``SOFT`` instantiation (the
  softplus delivery gate) bit-equal to ``fluid_math``'s soft arm at two
  temperatures, on one point and a grid, from zeros and from a carried
  ``lfrac``;
- the draw's ``erf_inv`` bit-equal to ``ops.fused.erf_inv`` on f32 inputs
  across both of its branches, at the edges and at +-1;
- ``run_as_flows`` through both kernels equal to the plain run, one
  ``as_spf`` and one ``as_fluid`` launch a chunk, and no call of the
  plain walk or draws;
- the runner cache: through both kernels, a miss and two hits of
  ``run_as_flows`` are equal (the fluid tables the cache holds are read,
  never written);
- mutant builds that must fail: Gauss-Seidel rounds (one distance buffer
  updated in place), a frontier node's distance read from the round's new
  buffer, a link's load summed out of (hop, flow) order, the soft gate
  without its ``* t``, the ``erf_inv`` polynomial's multiply-adds rounded
  twice, and the last
  replica's CTA doubling the cached link capacities in the tables' blob
  after its run (a hit then differs from its miss).

Tolerance: none (bits).  Skips where ``g++`` is missing.  The kernel's
build and the mutants' are made together, all ``g++`` processes started at
once (the module's ``builds`` fixture).  The same source
runs on the card in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes
import dataclasses
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_cpu

from tpudes_torch import _build
from tpudes_torch.ops.fused import erf_inv
from tpudes_torch.parallel import as_cuda
from tpudes_torch.parallel import as_flows as P
from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel.programs import toy_as_program
from tpudes_torch.random import as_replica_draws

_torch_cpu.one_thread()

CSRC = Path(_build.CSRC)
GXX_FLAGS = ("-x", "c++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
             "-shared", "-pthread")
SPF_OUTPUTS = ("dist", "nh_edge", "nh_node", "path", "hops", "reached")
#: the mutants: (name, file in csrc/ (the kernel or a header it includes),
#: its text, the replacement)
MUTANTS = {
    "gauss_seidel": ("as_flows.cu", "  int* W = base + N;",
                     "  int* W = base;"),
    "frontier_new_buffer": (
        "as_flows.cu",
        "        const int k = fkey(__fadd_rn(fval(R[xo]), w));",
        "        const int k = fkey(__fadd_rn(fval(W[xo]), w));"),
    "link_order": (
        "as_flows.cu",
        "      for (int j = lptr[l]; j < lptr[l + 1]; ++j)",
        "      for (int j = lptr[l + 1] - 1; j >= lptr[l]; --j)"),
    "cached_table_write": (
        "as_flows.cu",
        "    stage(FLUID_PROF_WORDS - 1);\n  }\n}\n",
        "    stage(FLUID_PROF_WORDS - 1);\n  }\n"
        "  if (tid == 0 && blockIdx.x == gridDim.x - 1)\n"
        "    for (int l = 0; l < L; ++l)\n"
        "      reinterpret_cast<float*>(const_cast<int*>(a.blob) + "
        "b.off[5])[l] *= 2.0f;\n}\n"),
    "soft_gate_without_t": (
        "as_flows.cu", "          lf = __fmul_rn(-sp, a.gate_t);",
        "          lf = -sp;"),
    "erf_inv_double_rounding": (
        "xla_math.cuh",
        "    acc = fma32(acc, t, static_cast<float>(near ? kNear[k] : "
        "kFar[k]));",
        "    acc = __fadd_rn(__fmul_rn(acc, t), static_cast<float>(near ? "
        "kNear[k] : kFar[k]));"),
}


def _start_build(source: Path, out: Path) -> subprocess.Popen:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/as_flows.cu against the CUDA "
                    "mock")
    return subprocess.Popen([gxx, *GXX_FLAGS, "-I", str(CSRC / "mock"), "-I",
                             str(CSRC), "-o", str(out), str(source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _mutant_source(mutant: str, where: Path) -> Path:
    """``as_flows.cu`` with :data:`MUTANTS`' edit ``mutant`` in ``where``
    (a mutant header beside a copy of the kernel, which includes it)."""
    name, old, new = MUTANTS[mutant]
    text = (CSRC / name).read_text()
    assert text.count(old) == 1
    where.mkdir()
    (where / name).write_text(text.replace(old, new))
    src = where / "as_flows.cu"
    if name != src.name:
        src.write_text((CSRC / src.name).read_text())
    return src


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """The kernel's mock build and every mutant's, all ``g++`` processes
    started together; their paths by name (``"main"`` and each of
    :data:`MUTANTS`)."""
    root = tmp_path_factory.mktemp("as_mock")
    sources = {"main": CSRC / "as_flows.cu"}
    for mutant in MUTANTS:
        sources[mutant] = _mutant_source(mutant, root / mutant)
    procs = {name: (_start_build(src, root / f"lib{name}.so"),
                    root / f"lib{name}.so") for name, src in sources.items()}
    for name, (proc, _) in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, f"{name}: {out}"
    return {name: path for name, (_, path) in procs.items()}


@pytest.fixture(scope="module")
def mock_lib(builds):
    return ctypes.CDLL(str(builds["main"]))


def _use(lib, monkeypatch):
    monkeypatch.setitem(_build._LOADED, "as_flows", lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    kc.reset_launches()


@pytest.fixture
def kernel(mock_lib, monkeypatch):
    _use(mock_lib, monkeypatch)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _line(n, caps, delays, src, dst, fbps, **kw):
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], 1).astype(np.int32)
    return P.AsFlowsProgram(
        n=n, edges=edges, delay_s=np.asarray(delays, float),
        rate_bps=np.asarray(caps, float), src=np.asarray(src, np.int32),
        dst=np.asarray(dst, np.int32), flow_bps=np.asarray(fbps, float),
        pkt_bytes=512, sim_s=1.0, **kw)


def _split_rounds_program(rounds=1):
    """2,048 nodes: the destination 5, its neighbour 7, and 7's neighbour
    7 + 1,024; one round reaches 7 only, but a buffer updated in place
    reaches 7 + 1,024 too."""
    n = 2048
    edges = np.array([[5, 7], [7, 7 + 1024], [7 + 1024, 300]], np.int32)
    return P.AsFlowsProgram(
        n=n, edges=edges, delay_s=np.full(3, 1e-3), rate_bps=np.full(3, 1e7),
        src=np.array([300], np.int32), dst=np.array([5], np.int32),
        flow_bps=np.array([1e5]), pkt_bytes=512, sim_s=1.0,
        spf_rounds=rounds)


def _star_path_program(leaves=70, path=12, metric="delay", rounds=48):
    """A hub (node 0) with ``leaves`` neighbours, a path of ``path`` nodes
    from leaf 1 on, and flows from leaves to the path's end, from the
    path's end to a leaf and from a leaf to another: the hub's 70 edges
    take a warp three strides, and under the delay metric the hub's row
    improves over several rounds."""
    rng = np.random.default_rng(11)
    star = np.stack([np.zeros(leaves), np.arange(1, leaves + 1)], 1)
    chain = np.arange(leaves, leaves + path + 1)
    line = np.stack([np.r_[1, chain[1:-1]], chain[1:]], 1)
    edges = np.concatenate([star, line]).astype(np.int32)
    n = leaves + path + 1
    far = int(chain[-1])
    return P.AsFlowsProgram(
        n=n, edges=edges, delay_s=rng.uniform(1e-3, 9e-3, edges.shape[0]),
        rate_bps=rng.uniform(1e7, 1e8, edges.shape[0]),
        src=np.array([5, 40, far, 69, 3], np.int32),
        dst=np.array([far, far, 17, 0, 66], np.int32),
        flow_bps=np.full(5, 4e6), pkt_bytes=512, sim_s=1.0,
        spf_metric=metric, spf_rounds=rounds, max_hops=20)


def _frontier_program():
    """Sixteen copies of: the destination 0, a node y at 1 and a node x
    at 10 from it, y - x at 1, and 40 leaves on x.  Round 1's frontier
    holds every x and y (32 nodes, one warp's, appended in the order the
    lanes reach them); where y comes before x, y lowers x to 2 in the
    warp's first lane-step, before it pushes along most of x's 42 edges,
    so a round that read x's distance from its new buffer would give
    those leaves 3, not 11, at two rounds."""
    edges, delay = [], []
    for i in range(16):
        y, x = 1 + 42 * i, 2 + 42 * i
        edges += [(0, y), (0, x), (y, x)]
        delay += [1e-3, 1e-2, 1e-3]
        edges += [(x, x + 1 + m) for m in range(40)]
        delay += [1e-3] * 40
    edges = np.asarray(edges, np.int32)
    return P.AsFlowsProgram(
        n=1 + 42 * 16, edges=edges, delay_s=np.asarray(delay),
        rate_bps=np.full(edges.shape[0], 1e7),
        src=np.array([40], np.int32), dst=np.array([0], np.int32),
        flow_bps=np.array([1e5]), pkt_bytes=512, sim_s=1.0,
        spf_metric="delay", spf_rounds=2)


def _spf_equal(prog, shared=None) -> None:
    g = P.spf_graph(prog, "cpu")
    dist, nh_edge, nh_node = P.spf_math(g, prog.n, prog.spf_rounds)
    want = (dist, nh_edge, nh_node, *P.walk_math(g, dist, nh_edge, nh_node))
    got = as_cuda.spf_cuda(g, prog.n, prog.spf_rounds, shared)
    for name, a, b in zip(SPF_OUTPUTS, want, got):
        assert _same(a, b), name
    path, hops, _ = P.walk_paths(prog, g["ddst"], nh_edge, nh_node)
    assert _same(path, got[3]) and _same(hops, got[4])


@pytest.mark.parametrize("metric", ["hops", "delay"])
@pytest.mark.parametrize("n, rounds, shared", [
    (40, 10, None), (72, 2, None), (40, 10, False), (64, 3, False)])
def test_spf_kernel_equals_plain(kernel, metric, n, rounds, shared):
    prog = dataclasses.replace(toy_as_program(n, 4, rounds, seed=5),
                               spf_metric=metric)
    _spf_equal(prog, shared)
    assert kc.launches["as_spf"] == 1


@pytest.mark.parametrize("metric", ["hops", "delay"])
@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_spf_kernel_truncated_rounds(kernel, metric, rounds):
    """Rounds 1-3 on a 48-node graph leave nodes and flows unreached; the
    rows in shared memory at odd rounds, in device memory at even."""
    prog = dataclasses.replace(toy_as_program(48, 6, rounds, seed=8),
                               spf_metric=metric)
    _spf_equal(prog, None if rounds % 2 else False)
    g = P.spf_graph(prog, "cpu")
    dist = P.spf_math(g, prog.n, rounds)[0]
    assert (dist == P.INF).any()


@pytest.mark.parametrize("shared", [None, False])
@pytest.mark.parametrize("metric", ["hops", "delay"])
def test_spf_kernel_star_hub(kernel, shared, metric):
    prog = _star_path_program(metric=metric)
    g = P.spf_graph(prog, "cpu")
    assert int((g["row_ptr"][1:] - g["row_ptr"][:-1]).max()) > 64
    _spf_equal(prog, shared)
    _spf_equal(dataclasses.replace(prog, spf_rounds=4), shared)


def test_spf_kernel_split_rounds(kernel):
    prog = _split_rounds_program()
    _spf_equal(prog)
    dist = as_cuda.spf_cuda(P.spf_graph(prog, "cpu"), prog.n, 1)[0]
    assert dist[0, 7] == 1.0 and dist[0, 7 + 1024] == P.INF


def _fluid_inputs(prog, replicas, scales, key=3):
    return P.fluid_inputs(prog, np.array([0, key]), replicas, scales,
                          "cpu")[0]


def _fluid_equal(args, rounds=P.FP_ROUNDS, lfrac=None,
                 gate_temp=None) -> torch.Tensor:
    want, wl, z = P.fluid_draws_math(*args, rounds, lfrac, gate_temp)
    got, gl = as_cuda.fluid_cuda(*args, rounds, lfrac, carry=True,
                                 z_out=True, gate_temp=gate_temp)
    for k in want:
        assert _same(want[k], got[k]), k
    assert _same(wl, gl)
    assert _same(z, got["z"])
    return gl


@pytest.mark.parametrize("scales", [[1.0], [0.5, 1.0, 3.0, 8.0]])
def test_fluid_kernel_equals_plain(kernel, scales):
    prog = dataclasses.replace(toy_as_program(40, 5, 10, seed=3),
                               flow_bps=np.linspace(2e6, 4e7, 5))
    args = _fluid_inputs(prog, 3, scales)
    _fluid_equal(args)
    assert kc.launches["as_fluid"] == 1
    assert kc.launches["as_fluid:sweep"] == int(len(scales) > 1)
    if len(scales) > 1:
        frac = as_cuda.fluid_cuda(*args, P.FP_ROUNDS)[0]["delivered_frac"]
        assert (frac[-1] < 1.0).any() and frac[-1].sum() < frac[0].sum()


@pytest.mark.parametrize("scales, gate_temp", [([1.0], 0.25),
                                               ([0.5, 1.0, 3.0, 8.0], 0.6)])
def test_fluid_soft_kernel_equals_plain(kernel, scales, gate_temp):
    """The ``SOFT`` instantiation (the softplus delivery gate) equals
    ``fluid_math``'s soft arm bit for bit, from zeros and from a carried
    ``lfrac``, and counts ``as_fluid:soft``; the hard gate differs on the
    overloaded links."""
    prog = dataclasses.replace(toy_as_program(40, 5, 10, seed=3),
                               flow_bps=np.linspace(2e6, 4e7, 5))
    args = _fluid_inputs(prog, 3, scales)
    lf = _fluid_equal(args, 2, gate_temp=gate_temp)
    _fluid_equal(args, 2, lf, gate_temp=gate_temp)
    assert kc.launches["as_fluid:soft"] == 2
    hard = as_cuda.fluid_cuda(*args, P.FP_ROUNDS)[0]["delivered_frac"]
    soft = as_cuda.fluid_cuda(*args, P.FP_ROUNDS,
                              gate_temp=gate_temp)[0]["delivered_frac"]
    assert not _same(hard, soft)
    with pytest.raises(ValueError, match="gate_temp"):
        as_cuda.fluid_cuda(*args, P.FP_ROUNDS, gate_temp=0.0)


@pytest.mark.parametrize("key", [(0, 0), (0, 2**32 - 1), (123456789,
                                                          987654321),
                                 (2**31, 7)])
def test_fluid_kernel_draws_equal_reference(kernel, key):
    """The draws the kernel writes out are ``as_replica_draws`` of the
    run's key for every replica, whatever the key's two words."""
    prog = dataclasses.replace(toy_as_program(32, 6, 10, seed=1),
                               flow_bps=np.full(6, 3e7))
    args = P.fluid_inputs(prog, np.array(key), 5, [1.0, 2.0], "cpu")[0]
    got, _ = as_cuda.fluid_cuda(*args, P.FP_ROUNDS, z_out=True)
    assert _same(got["z"], as_replica_draws(args[3], 5, 6))
    _fluid_equal(args)


def test_erf_inv_check_equals_plain(kernel):
    """The draw's erf_inv on f32 inputs across the near (w < 5) and far
    branches, the edges of f32 and +-1: bit-equal to ``fused.erf_inv``."""
    rng = np.random.default_rng(4)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    x = np.concatenate([
        rng.uniform(-1, 1, 1536), 1 - rng.uniform(0, 1e-3, 256),
        -1 + rng.uniform(0, 1e-5, 128),
        [0.0, -0.0, 1.0, -1.0, lo, -lo, 1e-30, -3e-20, 0.5, 0.9966,
         0.99662, 0.9967]]).astype(np.float32)
    x = torch.from_numpy(x)
    want = erf_inv(x)
    assert (torch.abs(x) < 0.99).any() and (torch.abs(x) > 0.997).any()
    assert _same(as_cuda.erf_inv_check(x), want)


def _converging_program():
    """Eight flows of unequal rates into one node: links near it carry
    three or more contributions, whose sum depends on its order."""
    return dataclasses.replace(toy_as_program(64, 8, 16, seed=2),
                               src=np.arange(10, 18, dtype=np.int32),
                               dst=np.full(8, 63, np.int32),
                               flow_bps=np.linspace(3e6, 9e7, 8))


def test_fluid_kernel_converging_flows(kernel):
    args = _fluid_inputs(_converging_program(), 4, [1.0, 2.0])
    counts = args[0]["ptr"][1:] - args[0]["ptr"][:-1]
    assert int(counts.max()) >= 3
    _fluid_equal(args)


def test_fluid_kernel_folded_line(kernel):
    prog = _line(3, [10e6, 10e6], [1e-3, 1e-3], [0, 0], [2, 2],
                 [10e6, 10e6], rate_jitter=0.0)
    args = _fluid_inputs(prog, 2, [1.0, 1.5])
    assert args[0]["fold"]
    _fluid_equal(args)


@pytest.mark.parametrize("split", [(1, 3), (2, 2), (1, 1, 1, 1)])
def test_fluid_kernel_carries_rounds(kernel, split):
    prog = dataclasses.replace(toy_as_program(48, 6, 12, seed=4),
                               flow_bps=np.full(6, 3e7))
    args = _fluid_inputs(prog, 2, [1.0, 2.0])
    lf = None
    for rounds in split:
        lf = _fluid_equal(args, rounds, lf)
    want, _, _ = P.fluid_draws_math(*args, P.FP_ROUNDS)
    got, _ = as_cuda.fluid_cuda(*args, split[-1], _carried(args, split))
    for k in want:
        assert _same(want[k], got[k]), k


def _carried(args, split):
    lf = None
    for rounds in split[:-1]:
        lf = P.fluid_draws_math(*args, rounds, lf)[1]
    return lf


@pytest.mark.parametrize("chunk", [None, 1])
def test_run_through_both_kernels_equals_plain(kernel, monkeypatch, chunk):
    prog = dataclasses.replace(toy_as_program(40, 5, 10, seed=3),
                               flow_bps=np.full(5, 2e7))
    key = np.array([0, 7])
    want = P.run_as_flows(prog, key, 3, device="cpu", rate_scale=[1.0, 4.0])
    monkeypatch.setattr(as_cuda, "spf_launch", as_cuda.spf_cuda)
    monkeypatch.setattr(as_cuda, "fluid_launch", as_cuda.fluid_cuda)

    def plain(*a, **k):
        raise AssertionError("the kernels' run called a plain stage")

    for name in ("walk_paths", "_walk", "as_replica_draws",
                 "fluid_draws_math", "spf_math"):
        monkeypatch.setattr(P, name, plain)
    got = P.run_as_flows(prog, key, 3, device="cpu", chunk_rounds=chunk,
                         rate_scale=[1.0, 4.0])
    assert kc.launches["as_spf"] == 1
    assert kc.launches["as_fluid"] == (4 if chunk else 1)
    for w, g in zip(want, got):
        for k in w:
            assert np.array_equal(w[k].view(np.uint32) if w[k].dtype ==
                                  np.float32 else w[k],
                                  g[k].view(np.uint32) if g[k].dtype ==
                                  np.float32 else g[k]), k


def _miss_hit_hit(monkeypatch) -> list:
    """``run_as_flows`` through both kernels from a cleared runner cache,
    three times."""
    from tpudes_torch.parallel.runtime import RUNTIME

    monkeypatch.setattr(as_cuda, "spf_launch", as_cuda.spf_cuda)
    monkeypatch.setattr(as_cuda, "fluid_launch", as_cuda.fluid_cuda)
    prog = dataclasses.replace(toy_as_program(40, 5, 10, seed=3),
                               flow_bps=np.full(5, 2e7))
    RUNTIME.clear()
    return [P.run_as_flows(prog, np.array([0, 7]), 3, device="cpu",
                           rate_scale=[1.0, 4.0]) for _ in range(3)]


def _runs_equal(a, b) -> bool:
    return all(np.array_equal(x[k], y[k], equal_nan=True)
               for x, y in zip(a, b) for k in x)


def test_runner_cache_hits_through_both_kernels_equal_the_miss(kernel,
                                                               monkeypatch):
    miss, hit1, hit2 = _miss_hit_hit(monkeypatch)
    assert _runs_equal(miss, hit1) and _runs_equal(miss, hit2)
    assert kc.launches["as_spf"] == kc.launches["as_fluid"] == 3


def test_bad_operands_raise(kernel):
    prog = toy_as_program(24, 3, 6)
    g = P.spf_graph(prog, "cpu")
    with pytest.raises(ValueError):
        as_cuda.spf_cuda(dict(g, col_w=g["col_w"].double()), prog.n, 6)
    with pytest.raises(ValueError):
        as_cuda.spf_cuda(g, prog.n + 1, 6)
    with pytest.raises(ValueError):
        as_cuda.spf_cuda(dict(g, src=g["src"].long()), prog.n, 6)
    args = _fluid_inputs(prog, 2, [1.0])
    with pytest.raises(ValueError):
        as_cuda.fluid_cuda(*args, 0)
    bad = (args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError):
        as_cuda.fluid_cuda(*bad, 4)
    with pytest.raises(ValueError):
        as_cuda.fluid_cuda(args[0], args[1], args[2], args[3].int(),
                           *args[4:], 4)
    assert kc.launches["as_spf"] == kc.launches["as_fluid"] == 0


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_mock_kernel_mutant_fails(mutant, builds, monkeypatch):
    _use(ctypes.CDLL(str(builds[mutant])), monkeypatch)
    if mutant == "gauss_seidel":
        with pytest.raises(AssertionError):
            _spf_equal(toy_as_program(40, 4, 10, seed=5))
    elif mutant == "frontier_new_buffer":
        with pytest.raises(AssertionError):
            _spf_equal(_frontier_program())
    elif mutant == "cached_table_write":
        miss, hit, _ = _miss_hit_hit(monkeypatch)
        with pytest.raises(AssertionError):
            assert _runs_equal(miss, hit)
    elif mutant == "link_order":
        args = _fluid_inputs(_converging_program(), 4, [1.0, 2.0])
        with pytest.raises(AssertionError):
            _fluid_equal(args)
    elif mutant == "soft_gate_without_t":
        args = _fluid_inputs(_converging_program(), 4, [1.0, 2.0])
        _fluid_equal(args)  # the hard gate is untouched
        with pytest.raises(AssertionError):
            _fluid_equal(args, gate_temp=0.25)
    else:
        x = torch.from_numpy(np.random.default_rng(5).uniform(
            -1, 1, 4096).astype(np.float32))
        assert not _same(as_cuda.erf_inv_check(x), erf_inv(x))
