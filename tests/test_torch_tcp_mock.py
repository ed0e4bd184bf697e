"""``csrc/tcp_advance.cu`` run on the CPU, against the plain loop.

The kernel's own source is compiled by ``g++`` against the mock of the
CUDA runtime and intrinsics in ``tpudes_torch/csrc/mock/`` (a block's
threads as ``std::thread``s, 32 a warp, the warp collectives through a
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
Skips where ``g++`` is missing.
"""

import ctypes
import dataclasses
import shutil
import subprocess
import types
from pathlib import Path

import pytest
import torch

from tpudes_torch import _build
from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel import tcp_cuda
from tpudes_torch.parallel import tcp_dumbbell as tcp
from tpudes_torch.parallel.programs import toy_traffic_points
from tpudes_torch.random import PRNGKey
from tpudes_torch.scenarios import dumbbell_program
from tpudes_torch.traffic.device import app_cum_table

CSRC = Path(_build.CSRC)
GXX_FLAGS = ("-x", "c++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
             "-shared", "-pthread")


def _build_mock(source: Path, out_dir: Path):
    """``source`` (csrc/tcp_advance.cu or an edited copy; its headers from
    csrc/) built by g++ against the CUDA mock, loaded."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/tcp_advance.cu against the "
                    "CUDA mock")
    lib = out_dir / "libtcp_advance_mock.so"
    subprocess.run(
        [gxx, *GXX_FLAGS, "-I", str(CSRC / "mock"), "-I", str(CSRC), "-o",
         str(lib), str(source)],
        check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def mock_lib(tmp_path_factory):
    return _build_mock(CSRC / "tcp_advance.cu",
                       tmp_path_factory.mktemp("tcp_mock"))


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


@pytest.mark.parametrize("was, now", [
    ("if (var == CUBIC) g = 0.7f;", "if (var == CUBIC) g = 0.71f;"),
    ("(rg == rem && g < lane)", "(rg == rem && g > lane)"),
])
def test_mock_kernel_mutant_fails(tmp_path, monkeypatch, was, now):
    """A copy of the source with Cubic's loss factor or the admission's
    tie order (equal remainders ranked by lane) changed: the comparison
    that the tests above make fails, so it can see such a change."""
    source = (CSRC / "tcp_advance.cu").read_text()
    assert source.count(was) == 1
    mutant = tmp_path / "tcp_advance.cu"
    mutant.write_text(source.replace(was, now))
    monkeypatch.setitem(_build._LOADED, "tcp_advance",
                        _build_mock(mutant, tmp_path))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    with pytest.raises(AssertionError) as differs:
        _kernel_vs_plain(_dumbbell(17), 2, cuts=(45,))
    # the first state array that differs
    assert str(differs.value).split("\n")[0] in {k for k, _, _ in
                                                  tcp.TCP_STATE}
