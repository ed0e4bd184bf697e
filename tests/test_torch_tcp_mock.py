"""``csrc/tcp_advance.cu`` run on the CPU, against the plain loop.

The kernel's own source is compiled by ``g++`` against the mock of the
CUDA runtime and intrinsics in ``tpudes_torch/csrc/mock/`` (a block's
threads as fibers run in turn, 32 a warp, the warp collectives through a
barrier; ``-ffp-contract=off``, so no product fuses into a sum that the
source does not fuse), loaded by ctypes in place of the nvcc build, and
called through the wrapper (``tcp_cuda.tcp_launch`` / ``tcp_profile``)
on CPU tensors.  Its whole state must equal ``tcp_advance_math``'s bit
for bit: F = 1, 8, 17 and 32 flows over every variant, RED/ECN, a
three-point variant grid, app-limited flows (the TRF arm) alone and as
an eight-point workload grid, a ragged last block, rings in global memory,
ack lags of one and three slots (the warps in turn), and launches cut
at slots that are not multiples of 32 (the edges of the kernel's batch
of draws) or odd.  Tolerance: none.  A copy of the source with one
constant or the admission's tie order changed fails the comparison.

The card runs the same source through nvcc (``tests/test_torch_cuda.py``,
``chip_smoke.py``); this test shows the logic, not the card's arithmetic.
Skips where ``g++`` is missing.  The kernel's build and the mutants' are
made together, all ``g++`` processes started at once (the module's
``builds`` fixture).
"""

import ctypes
import dataclasses
import shutil
import subprocess
import types
from pathlib import Path

import pytest
import torch

import _torch_cpu

from tpudes_torch import _build
from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel import tcp_cuda
from tpudes_torch.parallel import tcp_dumbbell as tcp
from tpudes_torch.parallel.programs import toy_traffic_points
from tpudes_torch.random import PRNGKey
from tpudes_torch.scenarios import dumbbell_program
from tpudes_torch.traffic.device import app_cum_table

_torch_cpu.one_thread()

CSRC = Path(_build.CSRC)
GXX_FLAGS = ("-x", "c++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
             "-shared", "-pthread")


#: the mutants of the plain arms: (the source's text, its replacement)
MUTANTS = [
    ("if (var == CUBIC) g = 0.7f;", "if (var == CUBIC) g = 0.71f;"),
    ("(rg == rem && g < lane)", "(rg == rem && g > lane)"),
]
#: the OBS arm's mutants, by name
OBS_MUTANTS = {
    "jitter_without_seen_guard": ("rx > 0 && o.dlast >= 0.0f",
                                  "rx > 0"),
    "ring_slot_off_by_one": ("t % RING_CAP) * RING_COLS",
                             "(t + 1) % RING_CAP) * RING_COLS"),
}


def _start_build(source: Path, out_dir: Path) -> tuple:
    """Start ``g++`` on ``source`` (csrc/tcp_advance.cu or an edited copy;
    its headers from csrc/) and on its OBS arm's unit (csrc/
    tcp_advance_obs.cu, copied beside the source, so that it includes the
    source it sits beside) against the CUDA mock, an object each; returns
    ``(procs, objects, library path)`` for :func:`_finish_build`."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/tcp_advance.cu against the "
                    "CUDA mock")
    part = out_dir / "tcp_advance_obs.cu"
    shutil.copy(CSRC / "tcp_advance_obs.cu", part)
    flags = [f for f in GXX_FLAGS if f != "-shared"]
    objs, procs = [], []
    for src in (source, part):
        obj = out_dir / f"{src.stem}.o"
        objs.append(str(obj))
        procs.append(subprocess.Popen(
            [gxx, *flags, "-c", "-I", str(CSRC / "mock"), "-I", str(CSRC),
             "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs, objs, out_dir / "libtcp_advance_mock.so"


def _finish_build(build: tuple) -> Path:
    """Wait for :func:`_start_build`'s objects and link them."""
    procs, objs, lib = build
    for proc in procs:
        out, _ = proc.communicate()
        assert proc.returncode == 0, out
    subprocess.run([shutil.which("g++"), "-shared", "-pthread", "-o",
                    str(lib), *objs], check=True, capture_output=True,
                   text=True)
    return lib


def _mutant_dir(root: Path, name: str, was: str, now: str) -> Path:
    source = (CSRC / "tcp_advance.cu").read_text()
    assert source.count(was) == 1
    where = root / name
    where.mkdir()
    (where / "tcp_advance.cu").write_text(source.replace(was, now))
    return where


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """The kernel's mock build and every mutant's (:data:`MUTANTS` as
    ``"mutant<i>"``, :data:`OBS_MUTANTS` by name), all ``g++`` processes
    started together; the libraries' paths by name."""
    root = tmp_path_factory.mktemp("tcp_mock")
    (root / "main").mkdir()
    started = {"main": _start_build(CSRC / "tcp_advance.cu", root / "main")}
    for name, (was, now) in [*((f"mutant{i}", m)
                               for i, m in enumerate(MUTANTS)),
                             *OBS_MUTANTS.items()]:
        where = _mutant_dir(root, name, was, now)
        started[name] = _start_build(where / "tcp_advance.cu", where)
    return {name: _finish_build(b) for name, b in started.items()}


@pytest.fixture(scope="module")
def mock_lib(builds):
    return ctypes.CDLL(str(builds["main"]))


@pytest.fixture
def kernel(mock_lib, monkeypatch):
    """The mock build as the loaded ``tcp_advance`` library, and a null
    stream."""
    monkeypatch.setitem(_build._LOADED, "tcp_advance", mock_lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))


def _dumbbell(n_flows, sim_s=0.25, red=None, queue="30p", **kw):
    """``n_flows`` flows over all 17 variants in turn (DCTCP's flows
    ECN-capable), droptail or RED."""
    return dumbbell_program(
        n_flows, sim_s, variants=[tcp.VARIANTS[i % 17]
                                  for i in range(n_flows)],
        queue=queue, red=red, **kw)


def _operands(prog, replicas, variants=None, seed=6):
    consts = tcp.build_tcp_consts(prog, "cpu")
    var, ecn = tcp.sweep_operands(prog, variants)
    var, ecn = torch.as_tensor(var), torch.as_tensor(ecn)
    s0 = tcp.init_state(consts, replicas, var.shape[0])
    return consts, s0, PRNGKey(seed), var, ecn


def _kernel_vs_plain(prog, replicas, cuts=(), variants=None, workloads=None):
    """The kernel over launches cut at ``cuts`` against the plain loop:
    every state array bit-equal.  ``workloads`` (an app-limited program's
    traffic_sweep, or ``[prog.traffic]``) runs the TRF arm over a grid of
    its points.  Returns ``(state, census)``."""
    consts, s0, key, var, ecn = _operands(prog, replicas, variants)
    app = None
    if workloads is not None:
        ops = tcp.workload_operands(
            prog, workloads if len(workloads) > 1 else None, "cpu")
        points = ops["tr_id"].shape[0]
        var, ecn = var.repeat(points, 1), ecn.repeat(points, 1)
        s0 = tcp.init_state(consts, replicas, points)

        def app(t0, t1):
            return app_cum_table(ops, prog.traffic.epoch_us,
                                 consts["slot_us"], t0, t1)
    census = {}
    want = tcp.tcp_advance_math(consts, s0, key, 0, prog.n_slots, var, ecn,
                                census, None if app is None
                                else app(0, prog.n_slots))
    got, t = s0, 0
    for bound in (*cuts, prog.n_slots):
        got = tcp_cuda.tcp_launch(consts, got, key, t, bound, var, ecn,
                                  None if app is None else app(t, bound))
        t = bound
    for k, _, _ in tcp.TCP_STATE:
        assert torch.equal(got[k].view(torch.int32),
                           want[k].view(torch.int32)), k
    assert int(got["delivered"].sum()) > 0
    return got, census


@pytest.mark.parametrize("n_flows", [1, 8, 17, 32])
def test_mock_kernel_bit_equal_to_plain_loop(kernel, n_flows):
    """Launches cut at slots 45 and 77 (t0 % 32 = 13, then 13 again after
    an odd length) and 150."""
    _, census = _kernel_vs_plain(_dumbbell(n_flows), 2, cuts=(45, 77, 150))
    assert census["tail_drops"] > 0
    assert census["reductions"] > 0


@pytest.mark.parametrize("hard_drop", [False, True])
def test_mock_kernel_red_bit_equal_to_plain_loop(kernel, hard_drop):
    """RED with ECN over DCTCP, NewReno and Cubic flows: CE marks and early
    drops, a launch cut at slot 97."""
    prog = dumbbell_program(
        6, 0.3, variants=["TcpDctcp", "TcpNewReno", "TcpCubic"] * 2,
        bottleneck_rate="5Mbps",
        red=dict(MinTh=3, MaxTh=8, MaxSize=60, UseEcn=True,
                 UseHardDrop=hard_drop))
    _, census = _kernel_vs_plain(prog, 3, cuts=(97,))
    assert census["ce_marks"] > 0 and census["early_drops"] > 0


def test_mock_kernel_variant_grid(kernel):
    """Three variant points x 3 replicas, cut at slots 33 and 190."""
    points = [["TcpNewReno"] * 5, list(tcp.VARIANTS[4:9]),
              ["TcpBbr", "TcpLp", "TcpHtcp", "TcpYeah", "TcpLedbat"]]
    _kernel_vs_plain(_dumbbell(5), 3, cuts=(33, 190), variants=points)


@pytest.mark.parametrize("point", [2, 5, 7])
def test_mock_kernel_app_limited(kernel, point):
    """The TRF arm: an app-limited program (an mmpp, onoff or trace
    workload of the toy points), cut at slots 45 and 77: the clip binds
    (the flows deliver other counts than the bulk run's)."""
    prog = _dumbbell(5)
    tp = toy_traffic_points(5, 250_000)[point]
    got, _ = _kernel_vs_plain(dataclasses.replace(prog, traffic=tp), 2,
                              cuts=(45, 77), workloads=[tp])
    bulk, _ = _kernel_vs_plain(prog, 2, cuts=(45, 77))
    assert not torch.equal(got["delivered"], bulk["delivered"])


def test_mock_kernel_workload_grid(kernel):
    """The TRF arm over the eight toy workload points as one grid (8 x 2
    rows, each point its own table row), cut at slot 33."""
    pts = toy_traffic_points(5, 250_000)
    prog = dataclasses.replace(_dumbbell(5), traffic=pts[0])
    kc.reset_launches()
    got, _ = _kernel_vs_plain(prog, 2, cuts=(33,), workloads=pts)
    assert kc.launches["tcp_advance:trf_sweep"] == 2
    assert kc.launches["tcp_advance:sweep"] == 0
    per_point = got["delivered"].sum((1, 2))
    assert len(set(per_point.tolist())) > 1


def test_mock_kernel_ragged_last_block(kernel):
    """5 rows: the last block holds one row, its other warps idle."""
    assert tcp_cuda.launch_geometry(4, 10, 1, 5)["blocks"] == 3
    _kernel_vs_plain(_dumbbell(4, sim_s=0.15), 5, cuts=(70,))


def test_mock_kernel_global_rings(kernel):
    """32 flows behind a 150 ms bottleneck: an ack lag of 365 slots, so
    a block's rings pass what it may hold and stay in global memory."""
    prog = _dumbbell(32, sim_s=0.6, bottleneck_delay="150ms")
    geo = tcp_cuda.launch_geometry(32, prog.buf_len, 1, 2)
    assert geo["rings"] == "global"
    _kernel_vs_plain(prog, 2, cuts=(161, 400))


@pytest.mark.parametrize("red", [False, True])
def test_mock_probe_equals_main_launch(kernel, red):
    """The probe's state equals the main launch's, and it counts cycles in
    every stage (RED's only under RED)."""
    prog = _dumbbell(6, sim_s=0.1, red=dict(MinTh=3, MaxTh=8, MaxSize=60,
                                            UseEcn=True) if red else None)
    consts, s0, key, var, ecn = _operands(prog, 3)
    want = tcp_cuda.tcp_launch(consts, s0, key, 5, prog.n_slots, var, ecn)
    got, cyc = tcp_cuda.tcp_profile(consts, s0, key, 5, prog.n_slots, var,
                                    ecn)
    for k, _, _ in tcp.TCP_STATE:
        assert torch.equal(got[k], want[k]), k
    assert cyc.shape == (3, len(tcp_cuda.TCP_PROF_STAGES))
    total = cyc.sum(0)
    for k, name in enumerate(tcp_cuda.TCP_PROF_STAGES):
        assert (int(total[k]) > 0) == (name != "red" or red), name


def test_mock_division_fast_path(kernel):
    """The kernel's branch-free division against the CPU's own on 20,000
    pairs (the CPU build seeds it with an exact reciprocal; the card's
    seed is held in tests/test_torch_cuda.py)."""
    bad, done = tcp_cuda.division_check(20_000, seed=3, device="cpu")
    assert (bad, done) == (0, 20_000)


@pytest.mark.parametrize("lag, delay, access", [(1, "0.1ms", "0.1ms"),
                                                (3, "0.25ms", "0.5ms")])
def test_mock_kernel_short_ack_lag(kernel, lag, delay, access):
    """An ack lag of one slot (a slot's ring entry is written the slot
    before: the warps take one slot a step, in turn) and of three (two
    slots a step, in turn)."""
    prog = _dumbbell(5, sim_s=0.2, bottleneck_delay=delay,
                     access_delay=access)
    assert prog.ack_lag == lag
    _kernel_vs_plain(prog, 2, cuts=(37,))


@pytest.mark.parametrize("was, now", MUTANTS)
def test_mock_kernel_mutant_fails(builds, monkeypatch, was, now):
    """A copy of the source with Cubic's loss factor or the admission's
    tie order (equal remainders ranked by lane) changed: the comparison
    that the tests above make fails, so it can see such a change."""
    name = f"mutant{MUTANTS.index((was, now))}"
    monkeypatch.setitem(_build._LOADED, "tcp_advance",
                        ctypes.CDLL(str(builds[name])))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    with pytest.raises(AssertionError) as differs:
        _kernel_vs_plain(_dumbbell(17), 2, cuts=(45,))
    # the first state array that differs
    assert str(differs.value).split("\n")[0] in {k for k, _, _ in
                                                  tcp.TCP_STATE}


# --------------------------------------------------------------------------
# the OBS arm (csrc/tcp_advance_obs.cu)

#: the OBS arm's mutants (in tcp_advance.cu's obs_slot, which the OBS unit
#: instantiates): the jitter taken without its first-delivery guard, and
#: the ring row written one slot late
def _obs_kernel_vs_plain(prog, replicas, cuts=(), variants=None,
                         workloads=None):
    """:func:`_kernel_vs_plain` with the obs state: the OBS arm's launches
    against the plain loop's obs_slot, every state array, obs counter,
    FlowMonitor column and ring bit-equal."""
    consts, _, key, var, ecn = _operands(prog, replicas, variants)
    points, app = var.shape[0], None
    if workloads is not None:
        ops = tcp.workload_operands(prog, workloads, "cpu")
        points = ops["tr_id"].shape[0]
        var, ecn = var.repeat(points, 1), ecn.repeat(points, 1)

        def app(t0, t1):
            return app_cum_table(ops, prog.traffic.epoch_us,
                                 consts["slot_us"], t0, t1)
    s0 = tcp.init_state(consts, replicas, points, obs=True)
    kc.reset_launches()
    want = tcp.tcp_advance_math(consts, s0, key, 0, prog.n_slots, var, ecn,
                                None, None if app is None
                                else app(0, prog.n_slots))
    got, t = s0, 0
    for bound in (*cuts, prog.n_slots):
        got = tcp_cuda.tcp_launch(consts, got, key, t, bound, var, ecn,
                                  None if app is None else app(t, bound))
        t = bound
    assert kc.launches["tcp_advance:obs"] == len(cuts) + 1
    for k in want:
        a, b = want[k], got[k]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k
    assert int(got["fm_rx"].sum()) > 0
    return got


def test_mock_obs_arm_bit_equal_to_plain_loop(kernel):
    """Bulk flows over every variant, launches cut at slots 37 (a batch
    edge) and 100: the cuts, consumed losses, occupancy histogram,
    FlowMonitor columns and ring."""
    got = _obs_kernel_vs_plain(_dumbbell(17), 2, cuts=(37, 100))
    assert int(got["cwnd_cuts"].sum()) > 0 and int(got["retx_cnt"].sum()) > 0


def test_mock_obs_arm_red_and_grids(kernel):
    """The OBS arm under RED/ECN over a two-point variant grid, and the
    app-limited arm over a three-point workload grid."""
    prog = dumbbell_program(
        6, 0.3, variants=["TcpDctcp", "TcpNewReno", "TcpCubic"] * 2,
        bottleneck_rate="5Mbps",
        red=dict(MinTh=3, MaxTh=8, MaxSize=60, UseEcn=True))
    got = _obs_kernel_vs_plain(prog, 2, cuts=(97,), variants=[
        ["TcpDctcp", "TcpNewReno", "TcpCubic"] * 2, ["TcpDctcp"] * 6])
    assert int(got["fm_lost"].sum()) > 0
    pts = toy_traffic_points(5, 250_000)[1:4]
    _obs_kernel_vs_plain(dataclasses.replace(_dumbbell(5), traffic=pts[0]),
                         2, cuts=(45,), workloads=pts)


@pytest.mark.parametrize("name", sorted(OBS_MUTANTS))
def test_mock_obs_arm_mutant_fails(builds, monkeypatch, name):
    monkeypatch.setitem(_build._LOADED, "tcp_advance",
                        ctypes.CDLL(str(builds[name])))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    with pytest.raises(AssertionError) as differs:
        _obs_kernel_vs_plain(_dumbbell(8), 2, cuts=(45,))
    assert str(differs.value).split("\n")[0] in {"fm_jsum", "fm_ring"}
