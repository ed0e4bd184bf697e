"""``csrc/wired_advance.cu`` on the CPU, through the CUDA mock.

The kernel's source is built by ``g++`` against
``tpudes_torch/csrc/mock/cuda_runtime.h`` (a thread per CUDA thread) and
called through ``wired_cuda.wired_cuda`` on CPU tensors, each launch held
against the plain ``wired.advance_math`` on a copy of the same carry:
every state array, ``t``, ``next_event`` and ``n_steps`` bit-equal.

- the whole engine over windows of a jittered chain, a flow that uses
  every column of ``paths``, and refresh spans of 1, 5 and 256 slots (the
  span must not change the result);
- list capacities of 4 and 8 entries, which force the refresh to retry
  with half its span, and the default, on a chain whose list holds more
  than 8 (the default's probe shows it); links of service + delay 2 and,
  through the tables, 1 (lookahead windows of 2 and 1 slots);
- a zero-step window (``t_grant`` at or below the carry's ``t``);
- more live packets at one slot than the list holds: the wrapper raises,
  naming the capacity and the row;
- the link table ``lo_at`` read from device memory where it does not fit
  in a CTA's shared memory beside its rows;
- one rank's subset (its owned links and resident flows) and the four
  space lanes, through the port's own ``run_hybrid`` (local and batched
  transports: priming advances, ingress from peers, egress every window);
- mutant builds that must fail: FIFO ties at one arrival slot going to
  the largest packet id, the egress buffers not cleared at a launch, the
  lookahead window one slot too long, and a queue insertion that puts a
  packet behind later arrivals.

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
        ("return ra < rb || (ra == rb && ia < ib);",
         "return ra < rb || (ra == rb && ia > ib);"),
    ],
    "egress_not_cleared": [
        ("          eg_hop[p] = -1;\n          eg_ready[p] = -1;\n", ""),
        ("      *reinterpret_cast<int4*>(eg_hop + p) = none;\n"
         "      *reinterpret_cast<int4*>(eg_ready + p) = none;\n", ""),
    ],
    "window_one_slot_too_long": [
        ("min(min(max(reach, s + win), s + MAX_WINDOW),",
         "min(min(max(reach, s + win) + 1, s + MAX_WINDOW),"),
    ],
    "insert_behind_later_arrival": [
        ("while (cur >= 0 && before(w.ent[cur].ready, cur, r, e)) {",
         "while (cur >= 0) {"),
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


def _both(tab, carry, t_grant, span=wired_cuda.SPAN_SLOTS,
          cap=wired_cuda.LIST_CAP):
    """The kernel and the plain version on copies of ``carry``; asserts
    them equal and returns the plain result."""
    want, wm = W.advance_math(tab, _clone(carry), t_grant)
    got, gm = wired_cuda.wired_cuda(tab, _clone(carry), t_grant, span, cap)
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


#: a chain whose list holds more than 8 live packets at a span of 64
#: slots, while no more than 4 arrive by any one slot
BUSY = W.wired_chain(12, 2, service=[1] * 12, period=10, n_slots=400,
                     jitter_slots=3)


@pytest.mark.parametrize("cap", [4, 8, wired_cuda.LIST_CAP])
def test_list_capacities_equal_plain(kernel, cap):
    """Capacities that force the refresh's span to halve, and the
    default, each bit-equal over three windows; the default's probe shows
    a list longer than 8, so the small capacities had to retry."""
    tab = _tab(BUSY)
    init, _ = W.build_wired_advance(BUSY, 3, device="cpu")
    carry = init(KEY)
    prof = torch.zeros((3, wired_cuda.PROF_WORDS), dtype=torch.int64)
    wired_cuda.wired_profile(tab, _clone(carry), 400, prof, 64)
    assert wired_cuda.wired_stages(prof)["list_max"] > 8
    for g in (70, 250, 400):
        carry, _ = _both(tab, carry, g, 64, cap)
    assert (carry["deliver"] >= 0).sum() > 100


@pytest.mark.parametrize("window", [1, 2])
def test_lookahead_windows_of_one_and_two(kernel, window):
    """Links of service 1 and delay 1 (service + delay 2, W = 2), and the
    same tables with the delay taken out (service + delay 1, W = 1: the
    program class refuses a zero delay, the kernel and the plain version
    are held on the tables)."""
    prog = W.wired_chain(8, 6, service=[1] * 8, delay=[1] * 8, period=2,
                         n_slots=200, jitter_slots=3)
    tab = _tab(prog)
    if window == 1:
        tab = dict(tab, svcdly=tab["svc"].clone())
    assert int(tab["svcdly"].min()) == window
    init, _ = W.build_wired_advance(prog, 2, device="cpu")
    carry = init(KEY)
    for g in (33, 120, 200):
        carry, _ = _both(tab, carry, g, 16)
    assert (carry["deliver"] >= 0).sum() > 50


def test_overflow_at_one_slot_raises(kernel):
    """Six packets that reach one link at one slot, a list of four: the
    launch raises, naming the capacity and the row."""
    prog = W.WiredProgram(
        n_links=2, service_slots=np.array([1, 1], np.int32),
        delay_slots=np.array([2, 2], np.int32),
        paths=np.array([[0, 1]] * 6, np.int32),
        start_slot=np.full(6, 3, np.int32),
        period_slots=np.full(6, 50, np.int32),
        n_pkts=np.full(6, 2, np.int32), n_slots=120)
    init, _ = W.build_wired_advance(prog, 2, device="cpu")
    carry = init(KEY)
    with pytest.raises(wired_cuda.ListOverflowError, match=r"cap=4 .* row 0"):
        wired_cuda.wired_cuda(_tab(prog), _clone(carry), 120, 8, 4)
    _both(_tab(prog), carry, 120, 8, 6)


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
    """A build with the FIFO tie order, the egress clearing, the
    lookahead window or the queue order broken must disagree with the
    plain version on a two-rank run."""
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


def test_link_table_in_device_memory(kernel, monkeypatch):
    """Where ``lo_at`` does not fit in a CTA's shared memory beside its
    rows the kernel reads it from device memory: the same launches,
    bit-equal (the limit lowered so that this chain's table is left out)."""
    prog = W.wired_chain(12, 8, jitter_slots=5, n_slots=300)
    tab = _tab(prog)
    K, F, H = tab["paths"].shape
    Lo = tab["svc"].shape[1]
    rows = wired_cuda.ROWS_PER_CTA
    monkeypatch.setattr(wired_cuda, "SMEM_LIMIT", wired_cuda.smem_bytes(
        F, H, Lo, wired_cuda.LIST_CAP, rows, False))
    assert wired_cuda.launch_geometry(F, H, Lo, wired_cuda.LIST_CAP,
                                      rows) == (
        rows, False, wired_cuda.SMEM_LIMIT)
    init, _ = W.build_wired_advance(prog, rows, device="cpu")
    carry = init(KEY)
    for g in (90, 300):
        carry, _ = _both(tab, carry, g)
    assert (carry["deliver"] >= 0).sum() > 50
