"""The wired engine's CUDA kernel: the wrapper.

``csrc/wired_advance.cu`` replaces the reference's windowed slot loop,
``tpudes/parallel/wired.py:578`` ``build_wired_advance`` (the
``lax.while_loop`` at ``:700-836`` over ``_make_lane_step.step`` ``:529``)
and ``:841`` ``build_wired_space_advance`` (the same step vmapped over
rank lanes); XLA code, no ``pallas_call``.  One launch advances every
(lane, replica) row of a carry to the grant, a warp a row on its own
clock; the carry's tensors are updated in place.

:func:`advance_launch` takes the plain :func:`tpudes_torch.parallel.
wired.advance_math` for CPU tensors and launches the kernel for CUDA
ones (:func:`wired_cuda`), or raises; it never falls back.  Every launch
is counted in :data:`tpudes_torch.parallel.kernels_cuda.launches` under
``wired_advance``, and also under ``wired_advance:owned`` where its one
lane serves a subset of the links (a hybrid rank) or
``wired_advance:lanes`` where it runs K > 1 lanes (the space kernel).
"""

from __future__ import annotations

import ctypes

import torch

from tpudes_torch.parallel.kernels_cuda import _check
from tpudes_torch.parallel.wired import (
    INF_SLOT,
    WIRED_STATE,
    _rows,
    advance_math,
)

#: slots past a refresh within which a row's live packets join its
#: active list (the kernel rescans all its packets when its clock passes
#: them); any value gives the same result, it trades the list's length
#: against the rescans
SPAN_SLOTS = 128
#: the shared memory a CTA may take (the card's opt-in limit)
SMEM_LIMIT = 227 * 1024


def smem_bytes(L: int, Lo: int) -> int:
    """Shared memory of a ``wired_advance`` CTA: a head key, free,
    served, service and service + delay a local link, and ``g2l`` over
    the L links."""
    return 24 * Lo + 4 * L


def advance_launch(tab: dict, carry: dict, t_grant: int) -> tuple:
    """One ``advance`` of the carry's rows (:func:`~tpudes_torch.
    parallel.wired.advance_math`'s arguments and result): the plain
    version for CPU tensors, one ``wired_advance`` launch for CUDA ones,
    which updates the carry's tensors in place and returns them."""
    dev = carry["hop"].device
    if dev.type == "cpu":
        return advance_math(tab, carry, t_grant)
    if dev.type != "cuda":
        raise ValueError(f"no wired_advance for device {dev}")
    return wired_cuda(tab, carry, t_grant)


def wired_cuda(tab: dict, carry: dict, t_grant: int,
               span: int = SPAN_SLOTS) -> tuple:
    """Launch ``wired_advance`` once on the carry's device
    (:func:`advance_launch`'s arguments and result); raises on a bad
    argument or a launch error and never takes the plain version.
    ``span`` is the kernel's refresh span (:data:`SPAN_SLOTS`; the result
    does not depend on it)."""
    dev = carry["hop"].device
    K, F, H = tab["paths"].shape
    P = tab["pkt_flow"].shape[1]
    Lo = tab["svc"].shape[1]
    L = tab["L"]
    shape = carry["hop"].shape
    N = _rows(carry["hop"]).shape[0]
    t0, t_grant = int(carry["t"]), int(t_grant)
    smem = smem_bytes(L, Lo)
    if (N % K or N < 1 or N * P >= 2**31 or smem > SMEM_LIMIT
            or not 0 <= t0 <= INF_SLOT or not 0 <= t_grant <= INF_SLOT
            or not 1 <= span <= 2**20):
        raise ValueError(f"wired_advance takes K R rows, N P < 2^31, "
                         f"{SMEM_LIMIT} B of link tables a CTA, 0 <= t, "
                         f"t_grant <= 2^30 and 1 <= span <= 2^20; got "
                         f"K={K}, N={N}, P={P}, L={L}, Lo={Lo} ({smem} B), "
                         f"t={t0}, t_grant={t_grant}, span={span}")
    for name, want in (("paths", (K, F, H)), ("nhops", (K, F)),
                       ("pkt_flow", (K, P)), ("g2l", (K, L)),
                       ("svc", (K, Lo)), ("svcdly", (K, Lo))):
        _check(name, tab[name], want, torch.int32, dev)
    for name, ax in WIRED_STATE:
        _check(name, carry[name], (*shape[:-1], P if ax == "p" else Lo),
               torch.int32, dev)
    scratch = torch.empty((N, P, 4), dtype=torch.int32, device=dev)
    nxt = torch.empty((N,), dtype=torch.int32, device=dev)
    steps = torch.empty((N,), dtype=torch.int32, device=dev)
    _call("wired_advance_launch", ADVANCE_ARGTYPES,
          *(tab[k].data_ptr() for k in ("paths", "nhops", "pkt_flow", "g2l",
                                        "svc", "svcdly")),
          *(carry[k].data_ptr() for k, _ in WIRED_STATE),
          scratch.data_ptr(), nxt.data_ptr(), steps.data_ptr(),
          K, N // K, P, F, H, L, Lo, t0, t_grant, int(span), smem,
          torch.cuda.current_stream(dev).cuda_stream)
    _count("wired_advance")
    if K > 1:
        _count("wired_advance:lanes")
    elif Lo < L:
        _count("wired_advance:owned")
    carry["t"] = max(t0, t_grant)
    next_event = nxt.view(K, -1).amin(1)
    return carry, dict(next_event=next_event if len(shape) == 3
                       else next_event[0], n_steps=steps.max())


def _call(symbol: str, argtypes: list, *args) -> None:
    """Call the library's entry ``symbol``; raise on an error."""
    from tpudes_torch._build import load_library

    fn = getattr(load_library("wired_advance"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")


def _count(name: str) -> None:
    from tpudes_torch.parallel.kernels_cuda import launches

    launches[name] += 1


#: ctypes signature of ``wired_advance_launch`` (csrc/wired_advance.cu):
#: paths, nhops, pkt_flow, g2l, svc, svcdly, the state's hop, ready,
#: free, deliver, eg_hop, eg_ready and served (in place), the list
#: scratch, next and steps out; eleven ints (K, R, P, F, H, L, Lo, t,
#: t_grant, span, shared bytes), stream
ADVANCE_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 11 + [
    ctypes.c_void_p]
