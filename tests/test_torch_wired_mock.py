"""``csrc/wired_advance.cu`` on the CPU, through the CUDA mock.

The kernel's source is built by ``g++`` against
``tpudes_torch/csrc/mock/cuda_runtime.h`` (a thread per CUDA thread) and
called through ``wired_cuda.wired_cuda`` on CPU tensors, each launch held
against the plain ``wired.advance_math`` on a copy of the same carry:
every state array, ``t``, ``next_event`` and ``n_steps`` bit-equal.

- the whole engine over windows of a jittered chain, a flow that uses
  every column of ``paths``, and refresh spans of 1, 5 and 256 slots (the
  span must not change the result);
- a zero-step window (``t_grant`` at or below the carry's ``t``);
- one rank's subset (its owned links and resident flows) and the four
  space lanes, through the port's own ``run_hybrid`` (local and batched
  transports: priming advances, ingress from peers, egress every window);
- mutant builds that must fail: FIFO ties at one arrival slot going to
  the largest packet id, and the egress buffers not cleared at a launch.

Tolerance: none (integers).  Skips where ``g++`` is missing.  The same
source runs on the card in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import ctypes
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tpudes_torch import _build
from tpudes_torch.parallel import hybrid
from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel import wired as W
from tpudes_torch.parallel import wired_cuda

CSRC = Path(_build.CSRC)
GXX_FLAGS = ("-x", "c++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
             "-shared", "-pthread")
KEY = np.array([0, 7])
#: the mutants: name -> [(text, replacement), ...] in wired_advance.cu
MUTANTS = {
    "ties_to_largest_id": [
        ("         static_cast<unsigned>(i);\n}",
         "         static_cast<unsigned>(0x7FFFFFFF - i);\n}"),
        ("  return static_cast<int>(key & 0xFFFFFFFFull);",
         "  return 0x7FFFFFFF - static_cast<int>(key & 0xFFFFFFFFull);"),
    ],
    "egress_not_cleared": [
        ("    eg_hop[p] = -1;\n    eg_ready[p] = -1;\n", ""),
    ],
}


def _build_mock(source: Path, out: Path) -> ctypes.CDLL:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/wired_advance.cu against the "
                    "CUDA mock")
    subprocess.run([gxx, *GXX_FLAGS, "-I", str(CSRC / "mock"), "-I",
                    str(CSRC), "-o", str(out), str(source)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def mock_lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("wired_mock") / "libwired_advance_mock.so"
    return _build_mock(CSRC / "wired_advance.cu", out)


def _use(lib, monkeypatch):
    monkeypatch.setitem(_build._LOADED, "wired_advance", lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    kc.reset_launches()


@pytest.fixture
def kernel(mock_lib, monkeypatch):
    _use(mock_lib, monkeypatch)


def _clone(carry):
    return {k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in carry.items()}


def _both(tab, carry, t_grant, span=wired_cuda.SPAN_SLOTS):
    """The kernel and the plain version on copies of ``carry``; asserts
    them equal and returns the plain result."""
    want, wm = W.advance_math(tab, _clone(carry), t_grant)
    got, gm = wired_cuda.wired_cuda(tab, _clone(carry), t_grant, span)
    for k, _ in W.WIRED_STATE:
        assert torch.equal(want[k], got[k]), k
    assert want["t"] == got["t"]
    assert torch.equal(wm["next_event"], gm["next_event"])
    assert int(wm["n_steps"]) == int(gm["n_steps"])
    return want, wm


def _full_column_program():
    """Two flows of three links each over a 3-link graph (``H = 3``), so
    a packet's last hop is the last column of ``paths``."""
    return W.WiredProgram(
        n_links=3, service_slots=np.array([1, 2, 1], np.int32),
        delay_slots=np.array([2, 3, 2], np.int32),
        paths=np.array([[0, 1, 2], [2, 1, 0]], np.int32),
        start_slot=np.array([1, 2], np.int32),
        period_slots=np.array([3, 4], np.int32),
        n_pkts=np.array([40, 30], np.int32), n_slots=180, jitter_slots=3)


@pytest.mark.parametrize("prog, windows, span", [
    (W.wired_chain(12, 8, jitter_slots=5, n_slots=500), (500,), 256),
    (W.wired_chain(12, 8, jitter_slots=5, n_slots=500), (37, 200, 500), 5),
    (W.wired_chain(6, 3, n_slots=300, period=2), (120, 300), 1),
    (_full_column_program(), (60, 180), 7),
])
def test_kernel_equals_plain_whole_engine(kernel, prog, windows, span):
    init, _ = W.build_wired_advance(prog, 3, device="cpu")
    carry, tab = init(KEY), _tab(prog)
    for g in windows:
        carry, _ = _both(tab, carry, g, span)
    assert kc.launches["wired_advance"] == len(windows)
    assert kc.launches["wired_advance:owned"] == 0
    assert (carry["deliver"] >= 0).any()


def _tab(prog, owned=None, flow_ids=None):
    return W.wired_tables(prog, [(prog, owned, flow_ids)], "cpu")


def test_zero_step_window(kernel):
    prog = W.wired_chain(6, 3, n_slots=200, jitter_slots=2)
    tab = _tab(prog)
    init, _ = W.build_wired_advance(prog, 2, device="cpu")
    carry, _ = _both(tab, init(KEY), 0)
    assert carry["t"] == 0
    carry, _ = _both(tab, carry, 90)
    carry, metrics = _both(tab, carry, 60)
    assert carry["t"] == 90 and int(metrics["n_steps"]) == 0


@pytest.mark.parametrize("transport, prog", [
    ("local", W.wired_chain(8, 5, ranks=2, n_slots=400, jitter_slots=4)),
    ("local", W.wired_chain(12, 6, ranks=4, n_slots=300, boundary_delay=5)),
    ("batched", W.wired_weak_chain(4, links_per_rank=2, n_slots=600,
                                   boundary_delay=16, cross_period=23)),
])
def test_kernel_equals_plain_in_hybrid_windows(kernel, monkeypatch,
                                               transport, prog):
    """Every window of a hybrid run (owned subsets or lanes, ingress,
    egress, the priming advance) through both versions."""
    seen = []

    def launch(tab, carry, t_grant):
        seen.append(tab["paths"].shape[0])
        return _both(tab, carry, t_grant)

    monkeypatch.setattr(wired_cuda, "advance_launch", launch)
    out = hybrid.run_hybrid(prog, KEY, 2, transport=transport, device="cpu")
    if transport == "batched":
        assert set(seen) == {prog.n_ranks}
        assert kc.launches["wired_advance:lanes"] == len(seen)
    else:
        assert kc.launches["wired_advance:owned"] == len(seen)
    assert kc.launches["wired_advance"] == len(seen)
    want = W.run_wired(prog, KEY, 2, device="cpu")
    for k in ("deliver_slot", "delivered", "served"):
        assert np.array_equal(out[k], want[k]), k
    assert out["windows"] > 2


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_mock_kernel_mutant_fails(name, tmp_path, monkeypatch):
    """A build with the FIFO tie order or the egress clearing broken must
    disagree with the plain version on a two-rank run."""
    text = (CSRC / "wired_advance.cu").read_text()
    for old, new in MUTANTS[name]:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    src = tmp_path / "wired_advance.cu"
    src.write_text(text)
    _use(_build_mock(src, tmp_path / "libmutant.so"), monkeypatch)
    monkeypatch.setattr(wired_cuda, "advance_launch", _both)
    prog = W.wired_chain(8, 5, ranks=2, n_slots=300, period=3)
    with pytest.raises(AssertionError):
        hybrid.run_hybrid(prog, KEY, 2, transport="local", device="cpu")
