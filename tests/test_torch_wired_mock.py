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
  packet behind later arrivals;
- the ``OBS`` arm and the union pass (``csrc/wired_advance_obs.cu``)
  against the plain version's union steps, every column and ring row
  included: 1 and 3 replicas, lookahead windows of 1 and 2 slots, list
  capacities that halve the span, the link table in device memory, a
  zero-step window, a grant below ``t`` and ring counters past 512, and
  ``run_wired(obs=True)``; its mutants: the jitter taken out of slot
  order, and the ring or ``fm_t0`` on a row's own clock.

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


#: g++ builds of the module at once (each a few hundred MB)
PARALLEL_BUILDS = 5


def _start_build(source: Path, out: Path) -> subprocess.Popen:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/wired_advance.cu against the "
                    "CUDA mock")
    return subprocess.Popen([gxx, *GXX_FLAGS, "-I", str(CSRC / "mock"), "-I",
                             str(CSRC), "-o", str(out), str(source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    assert proc.returncode == 0, log


def _mutant_sources(where: Path, unit: str, edits: list) -> None:
    """Both units in ``where``, ``unit`` with each ``(text, replacement)``
    of ``edits`` made (each text found once); the OBS unit includes the
    other from its own directory first."""
    for name in ("wired_advance.cu", "wired_advance_obs.cu"):
        text = (CSRC / name).read_text()
        if name == unit:
            for old, new in edits:
                assert text.count(old) == 1, old
                text = text.replace(old, new)
        (where / name).write_text(text)


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """Every mock library of the module, built by :data:`PARALLEL_BUILDS`
    g++ processes at a time: ``kernel`` (``wired_advance.cu``), ``obs``
    (``wired_advance_obs.cu``) and each mutant of :data:`MUTANTS` and
    :data:`OBS_MUTANTS`; returns their paths by name."""
    root = tmp_path_factory.mktemp("wired_mock")
    sources = {"kernel": CSRC / "wired_advance.cu",
               "obs": CSRC / "wired_advance_obs.cu"}
    for name, edits in MUTANTS.items():
        (root / name).mkdir()
        _mutant_sources(root / name, "wired_advance.cu", edits)
        sources[name] = root / name / "wired_advance.cu"
    for name, (unit, old, new) in OBS_MUTANTS.items():
        (root / name).mkdir()
        _mutant_sources(root / name, unit, [(old, new)])
        sources[name] = root / name / "wired_advance_obs.cu"
    out, running = {}, []
    for name, src in sources.items():
        out[name] = root / f"lib{name}.so"
        running.append(_start_build(src, out[name]))
        if len(running) == PARALLEL_BUILDS:
            _finish(running.pop(0))
    for proc in running:
        _finish(proc)
    return out


@pytest.fixture(scope="module")
def mock_lib(builds):
    return ctypes.CDLL(str(builds["kernel"]))


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
def test_mock_kernel_mutant_fails(name, builds, monkeypatch):
    """A build with the FIFO tie order, the egress clearing, the
    lookahead window or the queue order broken must disagree with the
    plain version on a two-rank run."""
    _use(ctypes.CDLL(str(builds[name])), monkeypatch)
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


# --------------------------------------------------------------------------
# the OBS arm and the union pass (csrc/wired_advance_obs.cu)

#: the OBS arm's mutants, in (file, text, replacement): each delay's
#: jitter taken against the flow's first delay, not against the one before
#: it in slot order; the ring's rows stamped on the row's own visits in
#: place of the union clock; and ``fm_t0`` taken from the row's own visits
OBS_MUTANTS = {
    "jitter_out_of_slot_order": (
        "wired_advance.cu", "  o.dlast[q] = d;\n",
        "  o.dlast[q] = dlast >= 0.0f ? dlast : d;\n"),
    "ring_on_the_row_clock": (
        "wired_advance_obs.cu",
        "const unsigned* ring_clock = a.u;",
        "const unsigned* ring_clock = a.visits + row * a.n_words;"),
    "t0_on_the_row_clock": (
        "wired_advance_obs.cu",
        "const unsigned* send_clock = a.u;",
        "const unsigned* send_clock = a.visits + row * a.n_words;"),
}


@pytest.fixture(scope="module")
def obs_lib(builds):
    return ctypes.CDLL(str(builds["obs"]))


def _obs_windows(prog, replicas, bounds, span=wired_cuda.SPAN_SLOTS,
                 cap=wired_cuda.LIST_CAP, tab=None):
    """The OBS arm and the union pass over windows ending at ``bounds``
    against the plain version's union steps: every state array, column,
    ring row, ``t``, ``fm_mark`` and metric bit-equal."""
    if tab is None:
        tab = W.wired_tables(prog, [(prog, None, None)], "cpu")
    init, _ = W.build_wired_advance(prog, replicas, device="cpu", obs=True,
                                    tab=tab)
    want = init(KEY)
    got = _clone(want)
    for b in bounds:
        want, wm = W.advance_math(tab, want, b)
        got, gm = wired_cuda.wired_obs_cuda(tab, got, b, span, cap)
        for k, v in want.items():
            if torch.is_tensor(v):
                a, g = (v, got[k]) if v.dtype != torch.float32 else (
                    v.view(torch.int32), got[k].view(torch.int32))
                assert torch.equal(a, g), (b, k)
            else:
                assert v == got[k], (b, k)
        for k in ("next_event", "n_steps", "fm_ring"):
            assert torch.equal(wm[k], gm[k]), (b, k)
    assert int(want["fm_rx"].sum()) > 0
    return want


@pytest.mark.parametrize("replicas", [1, 3])
def test_obs_arm_bit_equal_to_plain_version(obs_lib, monkeypatch, replicas):
    """A jittered chain and the every-column program, over windows of 37
    slots, one slot (37 to 38), 112 and the rest; one replica and three
    (all on the union clock); each launch one of the arm and one union
    pass."""
    _use(obs_lib, monkeypatch)
    prog = W.wired_chain(12, 8, jitter_slots=5, n_slots=300)
    _obs_windows(prog, replicas, (37, 38, 150, 300))
    full = _port_full()
    got = _obs_windows(full, replicas, (50, full.n_slots))
    assert kc.launches["wired_advance:obs"] == 6
    assert kc.launches["wired_advance:obs_union"] == 6
    assert int(got["fm_ring"][..., 0].max()) >= 0


@pytest.mark.parametrize("window", [1, 2])
def test_obs_arm_lookahead_windows_of_one_and_two(obs_lib, monkeypatch,
                                                  window):
    """Lookahead windows of 2 slots (service 1, delay 1) and of 1 (the
    same tables with the delay taken out), three replicas."""
    _use(obs_lib, monkeypatch)
    prog = W.wired_chain(8, 6, service=[1] * 8, delay=[1] * 8, period=2,
                         n_slots=200, jitter_slots=3)
    tab = W.wired_tables(prog, [(prog, None, None)], "cpu")
    if window == 1:
        tab = dict(tab, svcdly=tab["svc"].clone())
    assert int(tab["svcdly"].min()) == window
    _obs_windows(prog, 3, (33, 120), span=16, tab=tab)


@pytest.mark.parametrize("cap", [4, 8])
def test_obs_arm_list_capacities_halve_the_span(obs_lib, monkeypatch, cap):
    """List capacities that force the refresh's span to halve, three
    replicas over two windows: the default capacity's probe shows a list
    of more than 8 at a span of 64 in the first window already."""
    _use(obs_lib, monkeypatch)
    init, _ = W.build_wired_advance(BUSY, 3, device="cpu", obs=True)
    prof = torch.zeros((3, wired_cuda.PROF_WORDS), dtype=torch.int64)
    wired_cuda.wired_profile(_tab(BUSY), init(KEY), 70, prof, 64)
    assert wired_cuda.wired_stages(prof)["list_max"] > 8
    _obs_windows(BUSY, 3, (70, 150), span=64, cap=cap)


def test_obs_arm_zero_step_and_a_bad_grant(obs_lib, monkeypatch):
    """A zero-step window (``t_grant`` 0), a grant below the carry's
    ``t``, and windows past the horizon, whose ring counters wrap past
    512."""
    _use(obs_lib, monkeypatch)
    got = _obs_windows(W.wired_chain(n_slots=700), 2,
                       (0, 90, 60, 700, 1300, 650))
    assert int(got["fm_ring"][..., 1].max()) >= 512


def test_obs_arm_link_table_in_device_memory(obs_lib, monkeypatch):
    """Where ``lo_at`` does not fit in a CTA's shared memory beside its
    rows the arm reads it from device memory: bit-equal (the limit
    lowered so that this chain's table is left out)."""
    _use(obs_lib, monkeypatch)
    prog = W.wired_chain(12, 8, jitter_slots=5, n_slots=300)
    tab = _tab(prog)
    K, F, H = tab["paths"].shape
    Lo = tab["svc"].shape[1]
    rows = wired_cuda.ROWS_PER_CTA
    monkeypatch.setattr(wired_cuda, "SMEM_LIMIT", wired_cuda.smem_bytes(
        F, H, Lo, wired_cuda.LIST_CAP, rows, False, obs=True))
    wired_cuda.launch_geometry.cache_clear()
    try:
        assert wired_cuda.launch_geometry(F, H, Lo, wired_cuda.LIST_CAP,
                                          rows, True) == (
            rows, False, wired_cuda.SMEM_LIMIT)
        _obs_windows(prog, rows, (90, 300), tab=tab)
    finally:
        wired_cuda.launch_geometry.cache_clear()


def _port_full():
    """Three flows over all three columns of ``paths``, one backwards."""
    return W.WiredProgram(
        n_links=3, service_slots=np.array([1, 2, 1], np.int32),
        delay_slots=np.array([2, 3, 2], np.int32),
        paths=np.array([[0, 1, 2], [2, 1, 0], [1, 2, -1]], np.int32),
        start_slot=np.array([1, 2, 3], np.int32),
        period_slots=np.array([3, 4, 5], np.int32),
        n_pkts=np.array([40, 30, 20], np.int32), n_slots=200,
        jitter_slots=2)


def test_obs_arm_runs_through_run_wired(obs_lib, monkeypatch):
    """``run_wired(obs=True)`` on the card's path (CPU tensors through the
    mock): the windows launch the OBS arm and the union pass and give the
    plain run's columns, in seconds and µs."""
    _use(obs_lib, monkeypatch)
    prog = W.wired_chain(6, 3, n_slots=200, jitter_slots=3)
    plain = W.run_wired(prog, KEY, 2, device="cpu", obs=True,
                        window_slots=70)
    monkeypatch.setattr(W, "advance_math", lambda *a: pytest.fail(
        "the OBS arm must not take the plain version"))
    monkeypatch.setattr(wired_cuda, "advance_math", lambda tab, carry, t:
                        wired_cuda.wired_obs_cuda(tab, carry, t))
    got = W.run_wired(prog, KEY, 2, device="cpu", obs=True,
                      window_slots=70)
    assert kc.launches["wired_advance:obs"] == 3
    assert kc.launches["wired_advance:obs_union"] == 3
    for k, v in plain["flow"].items():
        assert np.array_equal(np.asarray(v).view(np.uint8),
                              np.asarray(got["flow"][k]).view(np.uint8)), k


@pytest.mark.parametrize("name", sorted(OBS_MUTANTS))
def test_obs_arm_mutant_fails(builds, monkeypatch, name):
    """A build with the jitter out of slot order, or the ring or ``fm_t0``
    on the row's own clock, must disagree with the plain version on eight
    replicas of the every-column program over its first 60 slots (where
    the union clock and a row's own differ in both)."""
    _use(ctypes.CDLL(str(builds[name])), monkeypatch)
    with pytest.raises(AssertionError) as differs:
        _obs_windows(_port_full(), 8, (60,))
    first = str(differs.value).split("\n")[0]
    want = {"jitter_out_of_slot_order": "'fm_jsum'",
            "ring_on_the_row_clock": "'fm_ring'",
            "t0_on_the_row_clock": "'fm_t0'"}[name]
    assert want in first, first
