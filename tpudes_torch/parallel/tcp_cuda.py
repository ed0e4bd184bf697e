"""The TCP dumbbell's slot loop as one persistent CUDA kernel: the wrapper.

``csrc/tcp_advance.cu`` replaces the reference's device loop
(``tpudes/parallel/tcp_dumbbell.py:1199``, a ``lax.while_loop`` over
``build_dumbbell_step.step_fn``; XLA code, no ``pallas_call``): one
launch runs every slot of a chunk for every (point, replica) row, two
warps per row (one runs the window's rules, two slots a step, the other
the queue a step behind, with the cwnds handed over in shared memory) and
:data:`TCP_ROWS_PER_BLOCK` rows a block, flow ``f`` on lane ``f`` (up to
:data:`TCP_MAX_FLOWS` flows), the rings in the row's slice of shared
memory (or, past :data:`SHARED_OPTIN_MAX` a block, in the output
tensors), the draws hashed inside.  Its state equals the plain loop's
(:func:`tpudes_torch.parallel.tcp_dumbbell.tcp_advance_math`) bit for
bit.  :func:`tcp_profile` runs the stage probe; :func:`division_check`
holds the kernel's branch-free division against the card's IEEE one.

An app-limited program's launch runs the ``TRF`` instantiation, which
reads the offered segments of its slots from an ``(C, T, F)`` int32 table
(:func:`tpudes_torch.traffic.device.app_cum_table`; one workload shared by
every point is the same row at a point stride of 0).

Launches are counted in :data:`tpudes_torch.parallel.kernels_cuda.
launches` under ``tcp_advance``, those of a RED program also under
``tcp_advance:red``, those of more than one variant point under
``tcp_advance:sweep``, those of an app-limited program under
``tcp_advance:trf`` and those of more than one workload under
``tcp_advance:trf_sweep``.
"""

from __future__ import annotations

import ctypes

import torch

from tpudes_torch.parallel.bss_cuda import SHARED_OPTIN_MAX
from tpudes_torch.parallel.kernels_cuda import _check, _launch
from tpudes_torch.parallel.tcp_dumbbell import (
    _CUBIC_INV_C,
    _CUBIC_WEST,
    _DTYPES,
    _HS_K,
    _HS_LOG_LOW,
    _HYBLA_INV,
    _LEDBAT_INV,
    TCP_STATE,
    state_shape,
)

#: flows a row holds: one a lane of its warp (TCP_MAX_FLOWS)
TCP_MAX_FLOWS = 32
#: rows (two warps each, one per (point, replica)) a block
#: (TCP_ROWS_PER_BLOCK)
TCP_ROWS_PER_BLOCK = 2
#: a row's cwnd handoff, its rules warp to its queue warp: shared memory
#: ahead of the block's rings (TCP_HANDOFF_WORDS)
TCP_HANDOFF_BYTES = 128 * 4
#: the stage probe's stages, in a slot's order (tcp_advance.cu's Stage),
#: and the warp that runs each: the rules warp's, then the queue warp's
TCP_PROF_STAGES = ("draws", "arrivals", "rules", "departure", "red",
                   "admission")
TCP_PROF_WARPS = {"rules": ("arrivals", "rules"),
                  "queue": ("draws", "departure", "red", "admission")}
#: the last slot a launch may reach (TCP_MAX_SLOT): t + ack_lag < 2^31
TCP_MAX_SLOT = 2147000000


def launch_geometry(n_flows: int, buf_len: int, points: int,
                    replicas: int) -> dict:
    """The launch's shape, as ``tcp_advance_launch`` checks it: ``rows``
    (point-major, row ``p R + r``), ``blocks`` of ``threads``
    (:data:`TCP_ROWS_PER_BLOCK` rows of two warps, the last block ragged),
    a row's ring words ``L (3 F + 1)`` and the block's ``shared`` bytes,
    0 when the rings stay in global memory (``rings``: "shared" or
    "global")."""
    rows = points * replicas
    words = buf_len * (3 * n_flows + 1)
    smem = TCP_ROWS_PER_BLOCK * words * 4
    in_smem = (smem + TCP_ROWS_PER_BLOCK * TCP_HANDOFF_BYTES
               <= SHARED_OPTIN_MAX)
    return dict(rows=rows, blocks=-(-rows // TCP_ROWS_PER_BLOCK),
                threads=64 * TCP_ROWS_PER_BLOCK, ring_words=words,
                shared=smem if in_smem else 0,
                rings="shared" if in_smem else "global")


def _app_args(app_cum, C: int, T: int, F: int, dev) -> tuple:
    """``(pointer, point stride, slot stride)`` of the app limit's table:
    ``(C, T, F)`` int32 on the launch's device, its flows contiguous, its
    slots ``F`` apart, its points ``T F`` apart or 0 (one workload shared
    by every point, an ``expand``); ``(None, 0, 0)`` for a bulk run."""
    if app_cum is None:
        return None, 0, 0
    if (app_cum.device != dev or app_cum.dtype != torch.int32
            or tuple(app_cum.shape) != (C, T, F)
            or app_cum.stride()[1:] != (F, 1)
            or app_cum.stride(0) not in (0, T * F)):
        raise ValueError(
            f"app_cum: want int32 (C, T, F) = {(C, T, F)} on {dev} with "
            f"strides (T F or 0, F, 1); got {app_cum.dtype} "
            f"{tuple(app_cum.shape)} strides {app_cum.stride()} on "
            f"{app_cum.device}")
    if C * T * F >= 2**31:
        raise ValueError(f"tcp_advance indexes app_cum in int32; C*T*F="
                         f"{C * T * F}")
    return app_cum.data_ptr(), app_cum.stride(0), app_cum.stride(1)


def _launch_args(consts: dict, state: dict, key: torch.Tensor, t0: int,
                 t1: int, var: torch.Tensor, ecn: torch.Tensor,
                 app_cum: torch.Tensor | None = None) -> tuple:
    """Check a launch's operands and allocate its outputs: ``(args,
    out)``, ``args`` the C launcher's arguments up to ``shared`` (the
    probe's output and the stream follow)."""
    F, L = consts["F"], consts["L"]
    C, R = state["cwnd"].shape[:2]
    dev = key.device
    if not 1 <= F <= TCP_MAX_FLOWS:
        raise ValueError(
            f"tcp_advance holds 1..{TCP_MAX_FLOWS} flows a row (one a "
            f"lane); got {F}")
    if not 0 <= t0 <= t1 <= TCP_MAX_SLOT - consts["ack_lag"]:
        raise ValueError(
            f"tcp_advance runs 0 <= t0 <= t1 with t1 + ack_lag <= "
            f"{TCP_MAX_SLOT}; got t0={t0}, t1={t1}")
    if C * R * L * F >= 2**31:
        raise ValueError(f"tcp_advance indexes state in int32; C*R*L*F="
                         f"{C * R * L * F}")
    _check("key", key, (2,), torch.int64, dev)
    _check("var", var, (C, F), torch.int32, dev)
    _check("ecn", ecn, (C, F), torch.bool, dev)
    for k in ("start", "stop", "max_pkts"):
        _check(k, consts[k], (F,), torch.int32, dev)
    out = {}
    for k, ax, dt in TCP_STATE:
        shape = state_shape(ax, C, R, L, F)
        _check(k, state[k], shape, _DTYPES[dt], dev)
        out[k] = torch.empty(shape, dtype=_DTYPES[dt], device=dev)
    geo = launch_geometry(F, L, C, R)
    app, app_sc, app_st = _app_args(app_cum, C, t1 - t0, F, dev)
    n = len(TCP_STATE)
    f = ctypes.c_float
    args = (
        (ctypes.c_void_p * n)(*[state[k].data_ptr() for k, _, _ in TCP_STATE]),
        (ctypes.c_void_p * n)(*[out[k].data_ptr() for k, _, _ in TCP_STATE]),
        var.data_ptr(), ecn.data_ptr(), consts["start"].data_ptr(),
        consts["stop"].data_ptr(), consts["max_pkts"].data_ptr(),
        key.data_ptr(), app, C, R, F, L, consts["ack_lag"],
        consts["queue_cap"], consts["burst"], consts["rtt_slots"],
        int(consts["red"]), int(consts["red_gentle"]), int(consts["red_ecn"]),
        int(consts["red_hard_drop"]), int(t0), int(t1), app_sc, app_st,
        f(consts["slot_s"]), f(consts["base_rtt_s"]),
        f(consts["red_min_th"]), f(consts["red_max_th"]),
        f(consts["red_max_p"]), f(consts["red_forced_th"]),
        f(consts["red_lin"]), f(consts["red_gentle_k"]),
        f(consts["red_keep"]), f(_HS_LOG_LOW), f(_HS_K), f(_CUBIC_INV_C),
        f(_CUBIC_WEST), f(_HYBLA_INV), f(_LEDBAT_INV),
        geo["blocks"], geo["shared"],
    )
    return args, out


def tcp_launch(consts: dict, state: dict, key: torch.Tensor, t0: int,
               t1: int, var: torch.Tensor, ecn: torch.Tensor,
               app_cum: torch.Tensor | None = None) -> dict:
    """Launch ``tcp_advance`` once for slots ``[t0, t1)`` of a grid of C
    points: ``state`` is ``(C, R, ...)`` (:data:`TCP_STATE`), ``var``
    ``(C, F)`` int32 variant ids, ``ecn`` ``(C, F)`` bool, ``app_cum``
    (an app-limited program) the ``(C, t1 - t0, F)`` int32 offered
    segments (:func:`_app_args`).  Returns the new state in fresh
    tensors, on the card, nothing copied back: the arguments and result
    of the plain loop (:func:`tpudes_torch.parallel.tcp_dumbbell.
    tcp_advance_math`).  Raises on a bad argument or a launch error;
    never takes the plain loop."""
    args, out = _launch_args(consts, state, key, t0, t1, var, ecn, app_cum)
    C = state["cwnd"].shape[0]
    trf = app_cum is not None
    workloads = trf and C > 1 and app_cum.stride(0) != 0
    _launch("tcp_advance", *args,
            torch.cuda.current_stream(key.device).cuda_stream,
            argtypes=LAUNCH_ARGTYPES,
            arms=("red",) * bool(consts["red"])
            + ("sweep",) * (C > 1 and not workloads) + ("trf",) * trf
            + ("trf_sweep",) * workloads)
    return out


def tcp_profile(consts: dict, state: dict, key: torch.Tensor, t0: int,
                t1: int, var: torch.Tensor, ecn: torch.Tensor):
    """The probe: the launch :func:`tcp_launch` makes for bulk flows, run
    by the kernel's profiling instantiation (``tcp_advance_profile``: each
    warp reads ``clock64()`` at its stage edges, its wait at the warps'
    barrier in no stage).  Returns ``(out, cycles)``: :func:`tcp_launch`'s
    state and the ``(C R, len(TCP_PROF_STAGES))`` int64 cycles each row's
    warps spent in each stage, summed over its slots (:data:`TCP_PROF_WARPS`
    says which warp runs which).  Not the main path: not counted in
    ``kernels_cuda.launches``."""
    from tpudes_torch._build import load_library

    C, R = state["cwnd"].shape[:2]
    args, out = _launch_args(consts, state, key, t0, t1, var, ecn)
    prof = torch.zeros((C * R, len(TCP_PROF_STAGES)), dtype=torch.int64,
                       device=key.device)
    fn = load_library("tcp_advance").tcp_advance_profile
    if fn.argtypes is None:
        fn.argtypes = PROFILE_ARGTYPES
        fn.restype = ctypes.c_int
    err = fn(*args, prof.data_ptr(),
             torch.cuda.current_stream(key.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tcp_advance probe failed: CUDA error {err}")
    return out, prof


def division_check(n: int, seed: int = 0, device=None) -> tuple:
    """The kernel's branch-free division (``dvd_fast`` in
    csrc/tcp_advance.cu) against the card's IEEE division (``__fdiv_rn``)
    on ``n`` operand pairs hashed from ``seed``, each operand normal with
    an exponent in -60..59 (the range where the kernel takes the fast path;
    a quarter of the pairs with all-ones or all-zeros mantissas).  Returns
    ``(differing, checked)``: the pairs whose quotients differ in any bit,
    and the pairs checked.  Runs where ``device`` is (the card by
    default); not counted in ``kernels_cuda.launches``."""
    from tpudes_torch._build import load_library
    from tpudes_torch.device import resolve_device

    dev = resolve_device(device)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    fn = load_library("tcp_advance").tcp_div_check
    fn.argtypes = [ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = max(1, min(264, -(-n // 256)))
    err = fn(seed & 0xFFFFFFFF, n, counts.data_ptr(), blocks, 256,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tcp_div_check failed: CUDA error {err}")
    bad, done = counts.tolist()
    return bad, done


#: ctypes signature of ``tcp_advance_launch`` (csrc/tcp_advance.cu): the
#: host arrays of the state's input and output pointers, var, ecn, start,
#: stop, max_pkts, key, the app limit's table (null: bulk), sixteen ints
#: (C, R, F, L, ack_lag, queue_cap, burst, rtt_slots, red, gentle, red_ecn,
#: hard_drop, t0, t1, the table's point and slot strides), fifteen floats
#: (slot_s, base_rtt, the seven RED constants, the six folded rule
#: constants), blocks, shared, stream; ``tcp_advance_profile`` takes the
#: probe's output before the stream
LAUNCH_ARGTYPES = (
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 16 + [ctypes.c_float] * 15
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]
)
PROFILE_ARGTYPES = LAUNCH_ARGTYPES[:-1] + [ctypes.c_void_p] * 2
