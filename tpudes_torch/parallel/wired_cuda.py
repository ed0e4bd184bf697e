"""The wired engine's CUDA kernel: the wrapper.

``csrc/wired_advance.cu`` replaces the reference's windowed slot loop,
``tpudes/parallel/wired.py:578`` ``build_wired_advance`` (the
``lax.while_loop`` at ``:700-836`` over ``_make_lane_step.step`` ``:529``)
and ``:841`` ``build_wired_space_advance`` (the same step vmapped over
rank lanes); XLA code, no ``pallas_call``.  One launch advances every
(lane, replica) row of a carry to the grant, a warp a row on its own
clock, several rows of one lane a CTA, each row's active list and its
links' FIFO queues in shared memory, serving a lookahead window of slots
a round; the carry's tensors are updated in place.

:func:`advance_launch` takes the plain :func:`tpudes_torch.parallel.
wired.advance_math` for CPU tensors and launches the kernel for CUDA
ones (:func:`wired_cuda`), or raises; it never falls back, also not where
a row's list overflows (:class:`ListOverflowError`).  Every launch is
counted in :data:`tpudes_torch.parallel.kernels_cuda.launches` under
``wired_advance``, and also under ``wired_advance:owned`` where its one
lane serves a subset of the links (a hybrid rank) or
``wired_advance:lanes`` where it runs K > 1 lanes (the space kernel).
:func:`wired_profile` runs the stage probe.
"""

from __future__ import annotations

import ctypes
import functools

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
#: them, and halves the span where the list would overflow); any value
#: gives the same result, it trades the list's length against the rescans
SPAN_SLOTS = 512
#: the entries of a row's list in shared memory (:class:`ListOverflowError`
#: where more live packets of a row arrive by one slot): 12 KB a row, so
#: that two CTAs of ROWS_PER_CTA rows share an SM with room to spare
LIST_CAP = 512
#: rows a CTA, a warp each (the kernel takes at most 4)
ROWS_PER_CTA = 4
#: the shared memory a CTA may take (the card's opt-in limit)
SMEM_LIMIT = 227 * 1024
#: the error word's value where no row overflowed (the kernel's launch
#: sets its four bytes to 0x7F)
NO_ERROR = 0x7F7F7F7F
#: the stage probe's words a row (csrc/wired_advance.cu's PROF
#: instantiation): the cycles in each of :data:`PROF_STAGES`, the row's
#: total cycles, its refreshes, its windows (service rounds), and the
#: sum and the most of its list lengths over its refreshes
PROF_STAGES = ("clear", "scan", "build", "serve", "insert", "reduce",
               "final")
PROF_WORDS = len(PROF_STAGES) + 5


class ListOverflowError(RuntimeError):
    """More live packets of a row arrive by one slot than its list in
    shared memory holds (the launch's ``cap``)."""


def wired_stages(prof: torch.Tensor) -> dict:
    """The probe's ``(N, PROF_WORDS)`` words as means a row: the cycles
    in each stage and its share of the row's total, the refreshes, the
    windows, and the list's mean and most length over all refreshes."""
    p = prof.double()
    n = len(PROF_STAGES)
    total = p[:, n].mean().item()
    out = {"cycles_" + k: p[:, i].mean().item()
           for i, k in enumerate(PROF_STAGES)}
    out.update({"share_" + k: (p[:, i].mean().item() / total if total
                               else 0.0) for i, k in enumerate(PROF_STAGES)})
    refreshes = p[:, n + 1].sum().item()
    out.update(rows=int(p.shape[0]), cycles_total=total,
               refreshes=p[:, n + 1].mean().item(),
               windows=p[:, n + 2].mean().item(),
               list_mean=(p[:, n + 3].sum().item() / refreshes
                          if refreshes else 0.0),
               list_max=int(p[:, n + 4].max().item()))
    return out


def _round16(b: int) -> int:
    return (b + 15) & ~15


def smem_bytes(F: int, H: int, Lo: int, cap: int, rows: int,
               table_smem: bool) -> int:
    """Shared memory of a ``wired_advance`` CTA: the lane's service and
    service + delay a local link, ``lo_at`` where it is held there, and
    each of its ``rows`` warps' row: 30 bytes a link (free, served, the
    left-off least arrival, two lists of incoming packets, the build's two
    run bounds, the queue head) and 24 bytes a list entry."""
    table = _round16(8 * Lo) + (_round16(2 * F * (H + 1)) if table_smem
                                else 0)
    return table + rows * _round16(30 * Lo + 24 * cap)


@functools.lru_cache(maxsize=64)
def launch_geometry(F: int, H: int, Lo: int, cap: int, R: int) -> tuple:
    """``(rows, table_smem, smem)`` of a launch: :data:`ROWS_PER_CTA` rows
    a CTA (fewer where R is smaller), ``lo_at`` in shared memory where it
    fits beside them, else read from device memory, and fewer rows where
    even that does not fit; raises where one row does not fit."""
    for n in range(min(ROWS_PER_CTA, R), 0, -1):
        for table_smem in (True, False):
            smem = smem_bytes(F, H, Lo, cap, n, table_smem)
            if smem <= SMEM_LIMIT:
                return n, table_smem, smem
    raise ValueError(f"wired_advance: a row of {Lo} local links and a "
                     f"list of cap={cap} entries takes "
                     f"{smem_bytes(F, H, Lo, cap, 1, False)} B of shared "
                     f"memory, over the {SMEM_LIMIT} B a CTA may take")


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
               span: int = SPAN_SLOTS, cap: int = LIST_CAP) -> tuple:
    """Launch ``wired_advance`` once on the carry's device
    (:func:`advance_launch`'s arguments and result); raises on a bad
    argument, a launch error or a list overflow
    (:class:`ListOverflowError`) and never takes the plain version.
    ``span`` is the kernel's refresh span (:data:`SPAN_SLOTS`) and ``cap``
    its list's entries a row (:data:`LIST_CAP`); the result depends on
    neither."""
    return _launch(tab, carry, t_grant, span, cap, None)


def wired_profile(tab: dict, carry: dict, t_grant: int, prof: torch.Tensor,
                  span: int = SPAN_SLOTS, cap: int = LIST_CAP) -> tuple:
    """The stage probe: :func:`wired_cuda`'s launch by the kernel's
    profiling instantiation (``wired_advance_profile``: each warp reads
    ``clock64()`` at its stage edges), which also writes each row's
    :data:`PROF_WORDS` words to ``prof`` (``(N, PROF_WORDS)`` int64 on the
    carry's device; :func:`wired_stages` reads them).  Not the main path:
    not counted in ``kernels_cuda.launches``."""
    return _launch(tab, carry, t_grant, span, cap, prof)


def _launch(tab: dict, carry: dict, t_grant: int, span: int, cap: int,
            prof) -> tuple:
    carry, metrics, err = enqueue(tab, carry, t_grant, span, cap, prof)
    # a row of no more than cap packets cannot overflow: the error word is
    # read back (a synchronise, the wrapper's last step) only where one can
    if err is not None and int(err.item()) != NO_ERROR:
        raise ListOverflowError(
            f"wired_advance: more than cap={cap} live packets of row "
            f"{int(err.item())} arrive by one slot, more than its list "
            f"holds; launch with a larger cap")
    return carry, metrics


def enqueue(tab: dict, carry: dict, t_grant: int, span: int = SPAN_SLOTS,
            cap: int = LIST_CAP, prof=None) -> tuple:
    """The launch of :func:`wired_cuda` (or :func:`wired_profile`) without
    the error word's read-back: ``(carry, metrics, err)``, ``err`` the
    one-word int32 device tensor where the kernel writes the least row
    whose list overflowed (:data:`NO_ERROR` where none did).  The caller
    must read it before trusting the carry; it is here for timing the
    kernel alone.  ``err`` is None where the rows hold no more than
    ``cap`` packets: no list can then overflow."""
    dev = carry["hop"].device
    K, F, H = tab["paths"].shape
    P = tab["pkt_flow"].shape[1]
    Lo = tab["svc"].shape[1]
    shape = carry["hop"].shape
    N = _rows(carry["hop"]).shape[0]
    t0, t_grant = int(carry["t"]), int(t_grant)
    if (N % K or N < 1 or N * P >= 2**31 or Lo > 32767
            or not 0 <= t0 <= INF_SLOT or not 0 <= t_grant <= INF_SLOT
            or not 0 <= span <= 2**20 or not 1 <= cap <= 32767):
        raise ValueError(f"wired_advance takes K R rows, N P < 2^31, Lo and "
                         f"cap <= 32767, 0 <= t, t_grant <= 2^30 and 0 <= "
                         f"span <= 2^20; got K={K}, N={N}, P={P}, Lo={Lo}, "
                         f"cap={cap}, t={t0}, t_grant={t_grant}, "
                         f"span={span}")
    rows, table_smem, smem = launch_geometry(F, H, Lo, cap, N // K)
    for name, want, dtype in (
            ("lo_at", (K, F, H + 1), torch.int16),
            ("pkt_flow", (K, P), torch.int32), ("svc", (K, Lo), torch.int32),
            ("svcdly", (K, Lo), torch.int32)):
        _check(name, tab[name], want, dtype, dev)
    for name, ax in WIRED_STATE:
        _check(name, carry[name], (*shape[:-1], P if ax == "p" else Lo),
               torch.int32, dev)
    if prof is not None:
        _check("prof", prof, (N, PROF_WORDS), torch.int64, dev)
    out = torch.empty((2 * N + 1,), dtype=torch.int32, device=dev)
    nxt, steps = out[:N], out[N:2 * N]
    err = out[2 * N:] if P > cap else None
    args = [*(tab[k].data_ptr() for k in ("lo_at", "pkt_flow", "svc",
                                          "svcdly")),
            *(carry[k].data_ptr() for k, _ in WIRED_STATE),
            nxt.data_ptr(), steps.data_ptr(),
            None if err is None else err.data_ptr(),
            K, N // K, P, F, H, Lo, t0, t_grant, int(span), int(cap), rows,
            int(table_smem), smem]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if prof is None:
        _call("wired_advance_launch", ADVANCE_ARGTYPES, *args, stream)
        _count("wired_advance")
        if K > 1:
            _count("wired_advance:lanes")
        elif Lo < tab["L"]:
            _count("wired_advance:owned")
    else:
        _call("wired_advance_profile", PROFILE_ARGTYPES, *args,
              prof.data_ptr(), stream)
    carry["t"] = max(t0, t_grant)
    next_event = nxt.view(K, -1).amin(1)
    metrics = dict(next_event=next_event if len(shape) == 3
                   else next_event[0], n_steps=steps.max())
    return carry, metrics, err


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
#: lo_at, pkt_flow, svc, svcdly, the state's hop, ready, free, deliver,
#: eg_hop, eg_ready and served (in place), next, steps and the error word
#: out; thirteen ints (K, R, P, F, H, Lo, t, t_grant, span, cap, rows a
#: CTA, lo_at in shared memory, shared bytes), stream;
#: ``wired_advance_profile`` takes the probe's words before the stream
ADVANCE_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 13 + [
    ctypes.c_void_p]
PROFILE_ARGTYPES = ADVANCE_ARGTYPES[:-1] + [ctypes.c_void_p] * 2
