"""The BSS event loop as one persistent CUDA kernel: the wrapper.

``csrc/bss_advance.cu`` replaces the reference's device event loop
(``tpudes/parallel/replicated.py:1155``, a ``lax.while_loop`` over
``build_bss_step.step_fn``; XLA code, no ``pallas_call``): one launch
runs every step of a chunk for every replica, one CTA per replica and
one thread per node, the draws made inside.  Each CTA stops when its own
replica has no event left before the horizon (or at the step bound);
:func:`join_stops` then gives the replicas that stopped before the last
one the one move of ``t`` the reference's shared loop makes in their
place, so the state equals the plain loop's
(:func:`tpudes_torch.parallel.replicated.bss_advance_math`) bit for bit.

State layout (:data:`BSS_STATE`): per node ``(R, N)``, per replica
``(R,)``; ``immediate`` is bool, the rest int32.
"""

from __future__ import annotations

import ctypes

import torch

from tpudes_torch.ops.wifi_error import (
    ALL_MODES,
    ber_constants,
    pe_constants,
)
from tpudes_torch.parallel.kernels_cuda import _check, _launch

#: state layout: (key, axis, dtype) with axis "n" = (R, N), "r" = (R,),
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


def bss_launch(consts: dict, state: dict, key: torch.Tensor, step0: int,
               step1: int):
    """Launch ``bss_advance`` once for steps ``[step0, step1)``: a CTA per
    replica runs its steps until its replica is no longer pending or the
    bound.  Returns ``(state, done, t_next, pending)``, all on the card
    and nothing copied back: each replica's state where its CTA stopped,
    the step it stopped at, the ``t`` one more step would give it, and
    whether it is still pending.  Raises on a bad argument or a launch
    error."""
    if not 0 <= step0 <= step1 <= BSS_MAX_STEP:
        raise ValueError(
            f"bss_advance runs 0 <= step0 <= step1 <= {BSS_MAX_STEP}; got "
            f"step0={step0}, step1={step1}"
        )
    dev = key.device
    n = consts["N"]
    R = state["queue"].shape[0]
    if not 1 <= n <= BSS_MAX_N:
        raise ValueError(f"bss_advance holds 1..{BSS_MAX_N} nodes; got {n}")
    if R * n >= 2**31:
        raise ValueError(f"bss_advance indexes state in int32; R*N={R * n}")
    _check("key", key, (2,), torch.int64, dev)
    _check("rx_w", consts["rx_w"], (n, n), torch.float32, dev)
    _check("det", consts["det"], (n, n), torch.bool, dev)
    for k in ("interval", "stop"):
        _check(k, consts[k], (n,), torch.int32, dev)
    out = {}
    for k, ax, dt in BSS_STATE:
        shape = (R, n) if ax == "n" else (R,)
        _check(k, state[k], shape, _DTYPES[dt], dev)
        out[k] = torch.empty(shape, dtype=_DTYPES[dt], device=dev)
    done = torch.empty((R,), dtype=torch.int32, device=dev)
    t_next = torch.empty((R,), dtype=torch.int32, device=dev)
    still = torch.empty((R,), dtype=torch.bool, device=dev)
    psr = psr_params(consts["mode"])
    _launch(
        "bss_advance",
        consts["rx_w"].data_ptr(), consts["det"].data_ptr(),
        consts["interval"].data_ptr(), consts["stop"].data_ptr(),
        key.data_ptr(),
        *[state[k].data_ptr() for k, _, _ in BSS_STATE],
        *[out[k].data_ptr() for k, _, _ in BSS_STATE],
        done.data_ptr(), t_next.data_ptr(), still.data_ptr(),
        R, n, consts["aifs"], consts["data_dur"], consts["resp_dur"],
        consts["exch_beacon"], consts["sim_end"], int(step0), int(step1),
        ctypes.c_float(consts["nbits"]), ctypes.c_float(consts["noise_w"]),
        *[ctypes.c_float(v) for v in psr[:-1]], psr[-1],
        torch.cuda.current_stream(dev).cuda_stream,
        argtypes=LAUNCH_ARGTYPES,
    )
    return out, done, t_next, still


def join_stops(state: dict, done: torch.Tensor, t_next: torch.Tensor):
    """``(state, steps)`` of the shared loop from the replicas' own stops:
    the loop ran to the last stop, and a replica that stopped before it
    took one more step there, in which ``t`` moves to its next event (at
    or past the horizon) and nothing else changes
    (``replicated.py:776-777``).  ``steps`` is copied to the host."""
    steps = int(done.max())
    return dict(state, t=torch.where(done < steps, t_next, state["t"])), steps


def bss_advance_cuda(consts: dict, state: dict, key: torch.Tensor,
                     step0: int, step1: int):
    """Steps ``[step0, step1)`` in one launch (:func:`bss_launch`), joined
    into the shared loop's state (:func:`join_stops`).  Returns
    ``(state, steps, pending)`` as the plain loop does.  Never takes the
    plain loop."""
    out, done, t_next, still = bss_launch(consts, state, key, step0, step1)
    out, steps = join_stops(out, done, t_next)
    return out, steps, still


#: ctypes signature of ``bss_advance_launch`` (csrc/bss_advance.cu):
#: rx_w, det, interval, stop, key, state in, state out, done, t_next,
#: pending, nine ints (R, N, aifs, data_dur, resp_dur, exch_beacon,
#: sim_end, step0, step1), nbits, noise_w, the 23 floats of psr_params
#: and its int term mask, stream
LAUNCH_ARGTYPES = (
    [ctypes.c_void_p] * (5 + 2 * len(BSS_STATE) + 3)
    + [ctypes.c_int] * 9 + [ctypes.c_float] * (2 + 23) + [ctypes.c_int]
    + [ctypes.c_void_p]
)
