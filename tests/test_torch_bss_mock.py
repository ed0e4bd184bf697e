"""``csrc/bss_advance.cuh`` on the CPU, through the CUDA mock: the BSS
event loop's kernel with and without its ``OBS`` arm.

The one-slot units (``bss_advance.cu``, ``bss_advance_s1.cu`` and
``bss_advance_obs_s1.cu``: N <= 32 nodes) are built by ``g++`` against
``tpudes_torch/csrc/mock/cuda_runtime.h`` (a fiber per CUDA thread; the
kernel's dynamic shared memory is the mock's buffer), the other slot
counts stubbed out, and called through ``bss_cuda.bss_advance_cuda`` on
CPU tensors against the plain ``replicated.bss_advance_math``: every state
array, step count and pending flag, and with ``obs`` the failed exchanges,
every FlowMonitor column and the ring (the idle rows ``join_stops`` writes
for replicas that stopped before their point's last one included),
bit-equal, over launches cut mid-run.  The legacy, A-MPDU, mobile and
workload arms, a horizon grid and a workload grid.  Mutant builds of the
``OBS`` arm must fail: the jitter taken without its first-delivery guard,
and the ring row written one step late.  Tolerance: none.  Skips where
``g++`` is missing; the card runs the same source in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes
import dataclasses
import shutil
import subprocess
import types
import warnings
from pathlib import Path

import pytest
import torch

import _torch_cpu

from tpudes.core.world import reset_world
from tpudes.parallel.programs import toy_bss_program as jax_toy_bss
from tpudes.parallel.programs import toy_traffic_points as jax_toy_points
from tpudes.parallel.replicated import lower_bss
from tpudes.scenarios import build_bss
from tpudes_torch import _build
from tpudes_torch.convert import (
    BSS_FIELDS,
    MOBILITY_FIELDS,
    TRAFFIC_FIELDS,
    bss_from_numpy,
    mobility_from_numpy,
    traffic_from_numpy,
)
from tpudes_torch.parallel import bss_cuda
from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel import replicated as bss
from tpudes_torch.random import PRNGKey

_torch_cpu.one_thread()

CSRC = Path(_build.CSRC)
FLAGS = ("-x", "c++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
         "-pthread", "-Ds_dyn=tcp_smem")
UNITS = ("bss_advance.cu", "bss_advance_s1.cu", "bss_advance_obs_s1.cu")
#: the slot counts and the probe this build leaves out, and the mock's
#: dynamic shared memory under the kernel's name for it
STUBS = """#include "bss_advance.cuh"
namespace bss_kernel {
alignas(16) unsigned char tcp_smem[232448];
#define STUB(f) \\
  cudaError_t f(bool, bool, bool, const Launch&) { \\
    return cudaErrorInvalidValue; \\
  }
STUB(launch_slots0) STUB(launch_slots2) STUB(launch_slots3)
STUB(launch_slots4) STUB(launch_probe) STUB(launch_obs0)
STUB(launch_obs2) STUB(launch_obs3) STUB(launch_obs4)
}  // namespace bss_kernel
"""
OBS_MUTANTS = {
    "jitter_without_seen_guard": ("rx > 0 && f_dlast[s] >= 0.0f",
                                  "rx > 0"),
    "ring_slot_off_by_one": ("step % kRingCap) *",
                             "(step + 1) % kRingCap) *"),
}


def _start_build(out_dir: Path, header: str | None = None) -> tuple:
    """Start the one-slot units and the stubs in ``out_dir`` (``header``
    an edited bss_advance.cuh beside them), one g++ a unit; returns
    ``(procs, objects, library path)`` for :func:`_finish_build`."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/bss_advance.cuh against the "
                    "CUDA mock")
    srcs = []
    for name in UNITS:
        shutil.copy(CSRC / name, out_dir / name)
        srcs.append(out_dir / name)
    (out_dir / "stubs.cc").write_text(STUBS)
    srcs.append(out_dir / "stubs.cc")
    if header is not None:
        (out_dir / "bss_advance.cuh").write_text(header)
    procs, objs = [], []
    for src in srcs:
        obj = out_dir / f"{src.name}.o"
        objs.append(str(obj))
        procs.append(subprocess.Popen(
            [gxx, *FLAGS, "-c", "-I", str(CSRC / "mock"), "-I", str(CSRC),
             "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs, objs, out_dir / "libbss_advance_mock.so"


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


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """The kernel's mock build and each of :data:`OBS_MUTANTS`', all
    ``g++`` processes started together; the libraries' paths by name."""
    root = tmp_path_factory.mktemp("bss_mock")
    header = (CSRC / "bss_advance.cuh").read_text()
    started = {}
    for name in ("main", *OBS_MUTANTS):
        (root / name).mkdir()
        edited = None
        if name != "main":
            was, now = OBS_MUTANTS[name]
            assert header.count(was) == 1
            edited = header.replace(was, now)
        started[name] = _start_build(root / name, edited)
    return {name: _finish_build(b) for name, b in started.items()}


@pytest.fixture(scope="module")
def mock_lib(builds):
    return ctypes.CDLL(str(builds["main"]))


def _use(lib, monkeypatch):
    monkeypatch.setitem(_build._LOADED, "bss_advance", lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    kc.reset_launches()


@pytest.fixture
def kernel(mock_lib, monkeypatch):
    _use(mock_lib, monkeypatch)


def _tr(tp):
    return traffic_from_numpy({k: getattr(tp, k) for k in TRAFFIC_FIELDS})


def _port(prog):
    mob = None if prog.mobility is None else mobility_from_numpy(
        {k: getattr(prog.mobility, k) for k in MOBILITY_FIELDS})
    return bss_from_numpy({k: getattr(prog, k) for k in BSS_FIELDS}, mob,
                          None if prog.traffic is None else _tr(prog.traffic))


def _program(arm: str):
    """``(program, horizons, workload grid)`` of each arm: the 8-STA toy
    BSS (9 nodes, one slot a lane)."""
    jp = jax_toy_bss(8, 200_000)
    pts = jax_toy_points(jp.n, jp.sim_end_us, start_us=jp.start_us,
                         beacon=(int(jp.interval_us[0]),
                                 int(jp.start_us[0])))
    if arm == "agg":
        reset_world()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sta, ap, clients, _ = build_bss(
                8, 1.1, radii=(12.0, 20.0, 28.0), interval_s=0.01,
                data_mode="HtMcs7", standard="80211n")
            jp = lower_bss([sta.Get(i) for i in range(sta.GetN())], ap,
                           clients, 1.1)
        reset_world()
    elif arm == "mob":
        from tpudes.ops.mobility import MobilityProgram

        base = jp.positions.astype("float32")
        vel = (base * 0.05).astype("float32")
        vel[:, 2] = 0.0
        jp = dataclasses.replace(
            jp, mobility=MobilityProgram.constant_velocity(base, vel),
            geom_stride=3)
    elif arm in ("trf", "trf_grid"):
        jp = dataclasses.replace(jp, traffic=pts[2])
    prog = _port(jp)
    ends = [100_000, 200_000] if arm == "horizon_grid" else None
    sweep = [_tr(tp) for tp in pts[2:5]] if arm == "trf_grid" else None
    return prog, ends, sweep


def _kernel_vs_plain(prog, ends, sweep, obs, replicas=3,
                     cuts=(61, 97)):
    consts, init, _ = bss.build_bss_advance(prog, replicas, "cpu", sweep)
    C = len(ends) if ends is not None else (len(sweep) if sweep else 1)
    if sweep is not None:
        ends = [int(prog.sim_end_us)] * C
    s0 = init(C, obs)
    key = PRNGKey(4)
    want, w_steps, w_pend = bss.bss_advance_math(consts, s0, key, [0] * C,
                                                 100_000, ends)
    got, steps = s0, [0] * C
    for bound in (*cuts, 100_000):
        got, steps, pend = bss_cuda.bss_advance_cuda(consts, got, key,
                                                     steps, bound, ends)
    assert steps == w_steps
    assert torch.equal(pend, w_pend)
    for k in want:
        a, b = want[k], got[k]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k
    assert kc.launches["bss_advance:obs"] == (len(cuts) + 1) * obs
    return want


@pytest.mark.parametrize("arm", ["legacy", "horizon_grid", "agg", "mob",
                                 "trf", "trf_grid"])
def test_obs_arm_bit_equal_to_plain_loop(kernel, arm):
    prog, ends, sweep = _program(arm)
    got = _kernel_vs_plain(prog, ends, sweep, obs=True)
    assert int(got["fm_rx"].sum()) > 0 and int(got["fm_tx"].sum()) > 0
    assert (got["fm_ring"][..., 0] == -1).any()


def test_kernel_without_obs_bit_equal_to_plain_loop(kernel):
    """The arm without the columns through the same build."""
    prog, ends, sweep = _program("legacy")
    got = _kernel_vs_plain(prog, ends, sweep, obs=False)
    assert "fm_tx" not in got and int(got["srv_rx"].sum()) > 0


@pytest.mark.parametrize("name", sorted(OBS_MUTANTS))
def test_obs_arm_mutant_fails(builds, monkeypatch, name):
    _use(ctypes.CDLL(str(builds[name])), monkeypatch)
    prog, ends, sweep = _program("legacy")
    with pytest.raises(AssertionError) as differs:
        _kernel_vs_plain(prog, ends, sweep, obs=True)
    first = str(differs.value).split("\n")[0]
    assert first.endswith(("fm_jsum", "fm_ring")), first
