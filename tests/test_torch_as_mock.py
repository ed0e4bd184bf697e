"""``csrc/as_flows.cu`` on the CPU, through the CUDA mock.

The kernels' source is built by ``g++`` against
``tpudes_torch/csrc/mock/cuda_runtime.h`` (a thread per CUDA thread) and
called through ``as_cuda.spf_cuda`` and ``as_cuda.fluid_cuda`` on CPU
tensors:

- ``as_spf`` bit-equal to ``spf_math`` (``dist``, ``nh_edge``,
  ``nh_node``) on toy BA programs under both metrics, with truncated
  rounds, its rows in shared memory and in device memory (``GLOBAL``);
- ``as_fluid`` bit-equal to ``fluid_math`` on a toy program, a rate-scale
  grid that overloads links, a line of equal links (the folded delay),
  and a run split into launches that carry the links' log deliveries;
- ``run_as_flows`` through both kernels equal to the plain run, one
  ``as_spf`` and one ``as_fluid`` launch a chunk;
- mutant builds that must fail: Gauss-Seidel rounds (one distance buffer
  updated in place) and a link's load summed out of (hop, flow) order.

Tolerance: none (bits).  Skips where ``g++`` is missing.  The same source
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

from tpudes_torch import _build
from tpudes_torch.parallel import as_cuda
from tpudes_torch.parallel import as_flows as P
from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel.programs import toy_as_program

CSRC = Path(_build.CSRC)
GXX_FLAGS = ("-x", "c++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
             "-shared", "-pthread")
#: the mutants: (name, text in csrc/as_flows.cu, its replacement)
MUTANTS = {
    "gauss_seidel": ("  float* nxt = buf0 + N;", "  float* nxt = buf0;"),
    "link_order": (
        "      for (int j = a.ptr[l]; j < a.ptr[l + 1]; ++j)",
        "      for (int j = a.ptr[l + 1] - 1; j >= a.ptr[l]; --j)"),
}


def _build_mock(source: Path, out: Path) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/as_flows.cu against the CUDA "
                    "mock")
    subprocess.run([gxx, *GXX_FLAGS, "-I", str(CSRC / "mock"), "-I",
                    str(CSRC), "-o", str(out), str(source)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def mock_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("as_mock") / "libas_flows_mock.so"
    return _build_mock(CSRC / "as_flows.cu", out)


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
    return torch.equal(_bits(a), _bits(b))


def _line(n, caps, delays, src, dst, fbps, **kw):
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], 1).astype(np.int32)
    return P.AsFlowsProgram(
        n=n, edges=edges, delay_s=np.asarray(delays, float),
        rate_bps=np.asarray(caps, float), src=np.asarray(src, np.int32),
        dst=np.asarray(dst, np.int32), flow_bps=np.asarray(fbps, float),
        pkt_bytes=512, sim_s=1.0, **kw)


def _split_rounds_program():
    """2,048 nodes (two nodes a thread of a 1,024-thread CTA): the
    destination 5, its neighbour 7, and 7's neighbour 7 + 1,024, which the
    same thread relaxes after 7; one round reaches 7 only, but a buffer
    updated in place reaches 7 + 1,024 too."""
    n = 2048
    edges = np.array([[5, 7], [7, 7 + 1024], [7 + 1024, 300]], np.int32)
    return P.AsFlowsProgram(
        n=n, edges=edges, delay_s=np.full(3, 1e-3), rate_bps=np.full(3, 1e7),
        src=np.array([300], np.int32), dst=np.array([5], np.int32),
        flow_bps=np.array([1e5]), pkt_bytes=512, sim_s=1.0, spf_rounds=1)


def _spf_equal(prog, shared=None) -> None:
    g = P.spf_graph(prog, "cpu")
    want = P.spf_math(g, prog.n, prog.spf_rounds)
    got = as_cuda.spf_cuda(g, prog.n, prog.spf_rounds, shared)
    for name, a, b in zip(("dist", "nh_edge", "nh_node"), want, got):
        assert _same(a, b), name


@pytest.mark.parametrize("metric", ["hops", "delay"])
@pytest.mark.parametrize("n, rounds, shared", [
    (40, 10, None), (72, 2, None), (40, 10, False), (64, 3, False)])
def test_spf_kernel_equals_plain(kernel, metric, n, rounds, shared):
    prog = dataclasses.replace(toy_as_program(n, 4, rounds, seed=5),
                               spf_metric=metric)
    _spf_equal(prog, shared)
    assert kc.launches["as_spf"] == 1


def test_spf_kernel_split_rounds(kernel):
    prog = _split_rounds_program()
    _spf_equal(prog)
    dist = as_cuda.spf_cuda(P.spf_graph(prog, "cpu"), prog.n, 1)[0]
    assert dist[0, 7] == 1.0 and dist[0, 7 + 1024] == P.INF


def _fluid_inputs(prog, replicas, scales, key=3):
    return P.fluid_inputs(prog, np.array([0, key]), replicas, scales,
                          "cpu")[0]


def _fluid_equal(args, rounds=P.FP_ROUNDS, lfrac=None) -> torch.Tensor:
    want, wl = P.fluid_math(*args, rounds, lfrac)
    got, gl = as_cuda.fluid_cuda(*args, rounds, lfrac, carry=True)
    for k in want:
        assert _same(want[k], got[k]), k
    assert _same(wl, gl)
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
    want, _ = P.fluid_math(*args, P.FP_ROUNDS)
    got, _ = as_cuda.fluid_cuda(*args, split[-1], _carried(args, split))
    for k in want:
        assert _same(want[k], got[k]), k


def _carried(args, split):
    lf = None
    for rounds in split[:-1]:
        lf = P.fluid_math(*args, rounds, lf)[1]
    return lf


@pytest.mark.parametrize("chunk", [None, 1])
def test_run_through_both_kernels_equals_plain(kernel, monkeypatch, chunk):
    monkeypatch.setattr(as_cuda, "spf_launch", as_cuda.spf_cuda)
    monkeypatch.setattr(as_cuda, "fluid_launch", as_cuda.fluid_cuda)
    prog = dataclasses.replace(toy_as_program(40, 5, 10, seed=3),
                               flow_bps=np.full(5, 2e7))
    key = np.array([0, 7])
    got = P.run_as_flows(prog, key, 3, device="cpu", chunk_rounds=chunk,
                         rate_scale=[1.0, 4.0])
    assert kc.launches["as_spf"] == 1
    assert kc.launches["as_fluid"] == (4 if chunk else 1)
    monkeypatch.undo()
    want = P.run_as_flows(prog, key, 3, device="cpu", rate_scale=[1.0, 4.0])
    for w, g in zip(want, got):
        for k in w:
            assert np.array_equal(w[k].view(np.uint32) if w[k].dtype ==
                                  np.float32 else w[k],
                                  g[k].view(np.uint32) if g[k].dtype ==
                                  np.float32 else g[k]), k


def test_bad_operands_raise(kernel):
    prog = toy_as_program(24, 3, 6)
    g = P.spf_graph(prog, "cpu")
    with pytest.raises(ValueError):
        as_cuda.spf_cuda(dict(g, col_w=g["col_w"].double()), prog.n, 6)
    with pytest.raises(ValueError):
        as_cuda.spf_cuda(g, prog.n + 1, 6)
    args = _fluid_inputs(prog, 2, [1.0])
    with pytest.raises(ValueError):
        as_cuda.fluid_cuda(*args, 0)
    bad = (args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError):
        as_cuda.fluid_cuda(*bad, 4)
    assert kc.launches["as_spf"] == kc.launches["as_fluid"] == 0


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_mock_kernel_mutant_fails(mutant, tmp_path, monkeypatch):
    old, new = MUTANTS[mutant]
    text = (CSRC / "as_flows.cu").read_text()
    assert text.count(old) == 1
    src = tmp_path / "as_flows.cu"
    src.write_text(text.replace(old, new))
    _use(_build_mock(src, tmp_path / "libmutant.so"), monkeypatch)
    if mutant == "gauss_seidel":
        prog = _split_rounds_program()
        with pytest.raises(AssertionError):
            _spf_equal(prog)
        return
    args = _fluid_inputs(_converging_program(), 4, [1.0, 2.0])
    with pytest.raises(AssertionError):
        _fluid_equal(args)
