"""The BSS event loop as one persistent CUDA kernel: the wrapper.

``csrc/bss_advance.cu`` replaces the reference's device event loop
(``tpudes/parallel/replicated.py:1155``, a ``lax.while_loop`` over
``build_bss_step.step_fn``; XLA code, no ``pallas_call``): one launch
runs every step of a chunk for every replica, one CTA per replica and
one thread per node, the draws made inside; an A-MPDU program runs its
``AGG`` arm, and a horizon sweep is a ``(R, C)`` grid, ``blockIdx.y``
the point with its own horizon.  Each CTA stops when its own replica
has no event left before its horizon (or at the step bound);
:func:`join_stops` then gives the replicas that stopped before the last
one of their point the one move of ``t`` the reference's loop makes in
their place, so the state equals the plain loop's
(:func:`tpudes_torch.parallel.replicated.bss_advance_math`) bit for bit.

State layout (:data:`BSS_STATE`): a grid of C horizons, per node
``(C, R, N)``, per replica ``(C, R)``; a single run is C = 1.
``immediate`` is bool, the rest int32.
"""

from __future__ import annotations

import ctypes

import torch

from tpudes_torch.ops.wifi_error import (
    ALL_MODES,
    ampdu_params,
    ber_constants,
    pe_constants,
)
from tpudes_torch.parallel.kernels_cuda import _check, _launch

#: state layout: (key, axis, dtype) with axis "n" = (C, R, N), "r" =
#: (C, R),
#: in the reference's init_state order (``replicated.py:689-707``)
BSS_STATE = (
    ("t", "r", "i32"), ("next_arr", "n", "i32"), ("queue", "n", "i32"),
    ("ap_pend", "n", "i32"), ("bcn_pend", "r", "i32"),
    ("backoff", "n", "i32"), ("hold", "n", "i32"),
    ("immediate", "n", "bool"), ("cw", "n", "i32"),
    ("retries", "n", "i32"), ("busy_until", "r", "i32"),
    ("srv_rx", "r", "i32"), ("cli_rx", "n", "i32"),
    ("tx_data", "r", "i32"), ("drops", "r", "i32"),
)
_DTYPES = {"i32": torch.int32, "bool": torch.bool}

#: nodes one CTA holds, one thread each (BSS_MAX_N in csrc/bss_advance.cu)
BSS_MAX_N = 1024
#: the last step a launch may reach (BSS_MAX_STEP): step + 31, a warp's
#: key lookahead, stays below 2^31
BSS_MAX_STEP = 2147483000
#: horizons one launch holds (BSS_MAX_POINTS: the grid's y extent, passed
#: by value in the kernel's parameters)
BSS_MAX_POINTS = 64
#: an A-MPDU's subframe cap the kernel holds: two coins per lane of a warp
BSS_MAX_MPDUS = 64


def psr_params(mode_index: int) -> list:
    """The error model's per-mode constants as the kernel takes them:
    the BER's scale and factor, the union bound's ten weights' logs and
    distances (a zero weight's term skipped: its distance passed as 0
    and its mask bit clear), the rate's factor and the term mask."""
    mode = ALL_MODES[int(mode_index)]
    scale, factor = ber_constants(mode.constellation)
    coeffs, log_c, exps, b = pe_constants(mode.rate_class)
    mask = sum(1 << k for k, a in enumerate(coeffs) if a > 0.0)
    return [scale, factor, *log_c, *exps, b, mask]


def bss_launch(consts: dict, state: dict, key: torch.Tensor, step0,
               step1: int, sim_end=None):
    """Launch ``bss_advance`` once for steps ``[step0, step1)`` of a grid
    of C horizons: a CTA per replica and point runs its steps until its
    replica is no longer pending or the bound.  ``state`` is ``(C, R,
    ...)``, ``step0`` a list of C counters, ``sim_end`` a list of C
    horizons (None: the program's, C = 1).  Returns ``(state, done,
    t_next, pending)``, all on the card and nothing copied back: each
    replica's state where its CTA stopped, the ``(C, R)`` step it
    stopped at, the ``t`` one more step would give it, and whether it is
    still pending.  Raises on a bad argument or a launch error."""
    ends = [int(v) for v in (sim_end if sim_end is not None
                             else [consts["sim_end"]])]
    starts = [int(v) for v in step0]
    C = len(ends)
    if not 1 <= C <= BSS_MAX_POINTS or len(starts) != C:
        raise ValueError(
            f"bss_advance runs 1..{BSS_MAX_POINTS} points, a horizon and a "
            f"counter each; got {len(ends)} horizons, {len(starts)} counters"
        )
    if not all(0 <= v <= step1 <= BSS_MAX_STEP for v in starts):
        raise ValueError(
            f"bss_advance runs 0 <= step0 <= step1 <= {BSS_MAX_STEP}; got "
            f"step0={step0}, step1={step1}"
        )
    dev = key.device
    n, K = consts["N"], consts["K"]
    R = state["queue"].shape[1]
    if not 1 <= n <= BSS_MAX_N:
        raise ValueError(f"bss_advance holds 1..{BSS_MAX_N} nodes; got {n}")
    if not 1 <= K <= BSS_MAX_MPDUS:
        raise ValueError(
            f"bss_advance holds A-MPDUs of 1..{BSS_MAX_MPDUS}; got {K}")
    if C * R * n >= 2**31:
        raise ValueError(
            f"bss_advance indexes state in int32; C*R*N={C * R * n}")
    _check("key", key, (2,), torch.int64, dev)
    _check("rx_w", consts["rx_w"], (n, n), torch.float32, dev)
    _check("det", consts["det"], (n, n), torch.bool, dev)
    for k in ("interval", "stop"):
        _check(k, consts[k], (n,), torch.int32, dev)
    out = {}
    for k, ax, dt in BSS_STATE:
        shape = (C, R, n) if ax == "n" else (C, R)
        _check(k, state[k], shape, _DTYPES[dt], dev)
        out[k] = torch.empty(shape, dtype=_DTYPES[dt], device=dev)
    done = torch.empty((C, R), dtype=torch.int32, device=dev)
    t_next = torch.empty((C, R), dtype=torch.int32, device=dev)
    still = torch.empty((C, R), dtype=torch.bool, device=dev)
    psr = psr_params(consts["mode"])
    sub8, inv_ndbps, rate, preamble = ampdu_params(consts["subframe_bytes"],
                                                   consts["mode"])
    _launch(
        "bss_advance",
        consts["rx_w"].data_ptr(), consts["det"].data_ptr(),
        consts["interval"].data_ptr(), consts["stop"].data_ptr(),
        key.data_ptr(),
        *[state[k].data_ptr() for k, _, _ in BSS_STATE],
        *[out[k].data_ptr() for k, _, _ in BSS_STATE],
        done.data_ptr(), t_next.data_ptr(), still.data_ptr(),
        R, n, consts["aifs"], consts["data_dur"], consts["resp_dur"],
        consts["exch_beacon"], (ctypes.c_int * C)(*ends),
        (ctypes.c_int * C)(*starts), C, int(step1),
        ctypes.c_float(consts["nbits"]), ctypes.c_float(consts["noise_w"]),
        *[ctypes.c_float(v) for v in psr[:-1]], psr[-1],
        K, preamble, ctypes.c_float(sub8), ctypes.c_float(inv_ndbps),
        ctypes.c_float(rate),
        torch.cuda.current_stream(dev).cuda_stream,
        argtypes=LAUNCH_ARGTYPES,
        arms=("agg",) * (K > 1) + ("sweep",) * (C > 1),
    )
    return out, done, t_next, still


def join_stops(state: dict, done: torch.Tensor, t_next: torch.Tensor):
    """``(state, steps)`` of the loop from the replicas' own ``(C, R)``
    stops, each point joined on its own (its own loop): the loop ran to
    the point's last stop, and a replica that stopped before it took one
    more step there, in which ``t`` moves to its next event (at or past
    the horizon) and nothing else changes (``replicated.py:776-777``).
    ``steps``, a list of C counts, is copied to the host."""
    last = done.amax(1)
    return (dict(state, t=torch.where(done < last[:, None], t_next,
                                      state["t"])), last.tolist())


def bss_advance_cuda(consts: dict, state: dict, key: torch.Tensor,
                     step0, step1: int, sim_end=None):
    """Steps ``[step0, step1)`` in one launch (:func:`bss_launch`), joined
    into the loop's state (:func:`join_stops`).  Returns ``(state, steps,
    pending)`` as the plain loop does.  Never takes the plain loop."""
    out, done, t_next, still = bss_launch(consts, state, key, step0, step1,
                                          sim_end)
    out, steps = join_stops(out, done, t_next)
    return out, steps, still


#: ctypes signature of ``bss_advance_launch`` (csrc/bss_advance.cu):
#: rx_w, det, interval, stop, key, state in, state out, done, t_next,
#: pending, six ints (R, N, aifs, data_dur, resp_dur, exch_beacon), the
#: C horizons and C first steps (host arrays), C, step1, nbits, noise_w,
#: the 23 floats of psr_params and its int term mask, the A-MPDU cap K
#: and the data preamble, the three floats of ampdu_params, stream
LAUNCH_ARGTYPES = (
    [ctypes.c_void_p] * (5 + 2 * len(BSS_STATE) + 3)
    + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 2
    + [ctypes.c_int] * 2 + [ctypes.c_float] * (2 + 23) + [ctypes.c_int]
    + [ctypes.c_int] * 2 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
)
