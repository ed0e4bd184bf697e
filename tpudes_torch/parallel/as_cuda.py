"""The AS flow engine's two CUDA kernels: the wrappers.

``csrc/as_flows.cu`` replaces the reference's routing stage and its fluid
fixed point (``tpudes/parallel/as_flows.py:227-267``, the ``lax.scan`` of
Bellman-Ford rounds and the next-hop scatter; ``:309-377`` and the
``while_loop`` at ``:485-518``; XLA code, no ``pallas_call``):

- :func:`spf_launch` (:func:`spf_cuda` on the card): ``as_spf``, one CTA
  a destination row, the row's two distance buffers in shared memory
  while ``2 N`` floats fit (the ``GLOBAL`` instantiation keeps them in
  device memory past that), Jacobi rounds with an early exit after a
  round that changed nothing, then each node's next hop;
- :func:`fluid_launch` (:func:`fluid_cuda` on the card): ``as_fluid``, one
  CTA a ``(point, replica)``, the links' log deliveries and utilisations,
  the flows' log survivals and every flow-hop's contribution in shared
  memory; each link sums its contributions in its list's (hop, flow)
  order.

Each equals its plain version (:func:`tpudes_torch.parallel.as_flows.
spf_math`, :func:`~tpudes_torch.parallel.as_flows.fluid_math`) bit for
bit.  On CPU tensors a wrapper takes the plain version; on CUDA tensors it
launches its kernel or raises.  Every launch is counted in
:data:`tpudes_torch.parallel.kernels_cuda.launches` under ``as_spf`` or
``as_fluid``, a grid of more than one rate scale also under
``as_fluid:sweep``.
"""

from __future__ import annotations

import ctypes

import torch

from tpudes_torch.parallel.as_flows import (
    INF,
    NEXT_HOP_SLACK,
    RHO_MAX,
    UTIL_MIN,
    fluid_math,
    spf_math,
)
from tpudes_torch.parallel.kernels_cuda import _check

#: threads of an ``as_fluid`` CTA (FLUID_THREADS in the .cu)
FLUID_THREADS = 128
#: the shared memory a CTA may take (the card's opt-in limit)
SMEM_LIMIT = 227 * 1024


def spf_smem_bytes(n: int) -> int:
    """Shared memory of an ``as_spf`` CTA that keeps its row's two distance
    buffers there (0: they do not fit, the ``GLOBAL`` instantiation)."""
    need = 2 * n * 4 + 16
    return need if need <= SMEM_LIMIT else 0


def fluid_smem_bytes(L: int, F: int, H: int) -> int:
    """Shared memory of an ``as_fluid`` CTA: ``lfrac`` and ``util`` of the
    L links, ``lg`` and the rate of the F flows, the ``H F``
    contributions and a word per warp for the maximum."""
    return 4 * (2 * L + 2 * F + H * F + FLUID_THREADS // 32)


def spf_launch(g: dict, n: int, rounds: int) -> tuple:
    """The routing stage for the graph ``g``
    (:func:`~tpudes_torch.parallel.as_flows.spf_graph`) of ``n`` nodes:
    ``(dist, nh_edge, nh_node)``, ``(D, N)`` f32, int32, int32.  One
    ``as_spf`` launch for CUDA tensors; :func:`spf_math` for CPU ones."""
    dev = g["w"].device
    if dev.type == "cpu":
        return spf_math(g, n, rounds)
    if dev.type != "cuda":
        raise ValueError(f"no as_spf for device {dev}")
    return spf_cuda(g, n, rounds)


def spf_cuda(g: dict, n: int, rounds: int, shared: bool | None = None
             ) -> tuple:
    """Launch ``as_spf`` once on ``g``'s tensors (:func:`spf_launch`'s
    arguments and result); raises on a bad argument or a launch error and
    never takes the plain version.  ``shared=False`` runs the ``GLOBAL``
    instantiation where the rows would fit in shared memory (the checks
    of that arm; None: shared memory where the rows fit)."""
    dev = g["w"].device
    D, E2 = g["dsts"].shape[0], g["col_v"].shape[0]
    if n < 1 or D < 1 or E2 >= 2**30 or D * n >= 2**31 or rounds < 0:
        raise ValueError(f"as_spf takes 1 <= N, 1 <= D, 2E < 2^30, D N < "
                         f"2^31, rounds >= 0; got N={n}, D={D}, 2E={E2}, "
                         f"rounds={rounds}")
    _check("row_ptr", g["row_ptr"], (n + 1,), torch.int32, dev)
    _check("col_v", g["col_v"], (E2,), torch.int32, dev)
    _check("col_w", g["col_w"], (E2,), torch.float32, dev)
    _check("col_e", g["col_e"], (E2,), torch.int32, dev)
    _check("dsts", g["dsts"], (D,), torch.int32, dev)
    dist = torch.empty((D, n), dtype=torch.float32, device=dev)
    nh_edge = torch.empty((D, n), dtype=torch.int32, device=dev)
    nh_node = torch.empty((D, n), dtype=torch.int32, device=dev)
    smem = spf_smem_bytes(n) if shared is not False else 0
    if shared and not smem:
        raise ValueError(f"as_spf's rows of {n} nodes do not fit in "
                         f"{SMEM_LIMIT} B of shared memory")
    scratch = None if smem else torch.empty((D, 2, n), dtype=torch.float32,
                                            device=dev)
    _call("as_spf_launch", SPF_ARGTYPES, g["row_ptr"].data_ptr(),
          g["col_v"].data_ptr(), g["col_w"].data_ptr(),
          g["col_e"].data_ptr(), g["dsts"].data_ptr(),
          None if scratch is None else scratch.data_ptr(), dist.data_ptr(),
          nh_edge.data_ptr(), nh_node.data_ptr(),
          n, D, int(rounds), smem, ctypes.c_float(INF),
          ctypes.c_float(NEXT_HOP_SLACK),
          torch.cuda.current_stream(dev).cuda_stream)
    _count("as_spf")
    return dist, nh_edge, nh_node


def fluid_launch(t: dict, fm, scale, z, reached, jitter: float, hj2: float,
                 rounds: int, lfrac=None, carry: bool = False) -> tuple:
    """The fluid stage over the ``(C, R)`` grid (:func:`fluid_math`'s
    arguments): ``(out, lfrac)``, the outputs and, with ``carry``, the
    ``(C, R, L)`` log deliveries after the last round (else None).  One
    ``as_fluid`` launch for CUDA tensors; :func:`fluid_math` for CPU
    ones."""
    dev = z.device
    if dev.type == "cpu":
        out, lf = fluid_math(t, fm, scale, z, reached, jitter, hj2, rounds,
                             lfrac)
        return out, (lf if carry else None)
    if dev.type != "cuda":
        raise ValueError(f"no as_fluid for device {dev}")
    return fluid_cuda(t, fm, scale, z, reached, jitter, hj2, rounds, lfrac,
                      carry)


def fluid_cuda(t: dict, fm, scale, z, reached, jitter: float, hj2: float,
               rounds: int, lfrac=None, carry: bool = False) -> tuple:
    """Launch ``as_fluid`` once on the tensors' device
    (:func:`fluid_launch`'s arguments and result); raises on a bad argument
    or a launch error and never takes the plain version."""
    dev = z.device
    F, H = t["hop_link"].shape
    L = t["c"].shape[0]
    C, R = scale.shape[0], z.shape[0]
    smem = fluid_smem_bytes(L, F, H)
    if smem > SMEM_LIMIT or C * R >= 2**31 or rounds < 1 or F < 1:
        raise ValueError(f"as_fluid keeps a CTA's links and flow-hops in "
                         f"{SMEM_LIMIT} B of shared memory and runs >= 1 "
                         f"round; got L={L}, F={F}, H={H} ({smem} B), "
                         f"C={C}, R={R}, rounds={rounds}")
    _check("hop_link", t["hop_link"], (F, H), torch.int32, dev)
    _check("ptr", t["ptr"], (L + 1,), torch.int32, dev)
    n_slot = t["slot"].shape[0]
    _check("slot", t["slot"], (n_slot,), torch.int32, dev)
    for name in ("c", "k", "dly"):
        _check(name, t[name], (L,), torch.float32, dev)
    _check("fm", fm, (F,), torch.float32, dev)
    _check("scale", scale, (C,), torch.float32, dev)
    _check("z", z, (R, F), torch.float32, dev)
    _check("reached", reached, (F,), torch.bool, dev)
    if lfrac is not None:
        _check("lfrac", lfrac, (C, R, L), torch.float32, dev)
    out = {k: torch.empty((C, R, F), dtype=torch.float32, device=dev)
           for k in ("goodput_bps", "delay_s", "delivered_frac")}
    out["max_util"] = torch.empty((C, R), dtype=torch.float32, device=dev)
    lf_out = (torch.empty((C, R, L), dtype=torch.float32, device=dev)
              if carry else None)
    f = ctypes.c_float
    _call("as_fluid_launch", FLUID_ARGTYPES, t["hop_link"].data_ptr(),
          t["ptr"].data_ptr(), t["slot"].data_ptr(), t["c"].data_ptr(),
          t["k"].data_ptr(), t["dly"].data_ptr(), fm.data_ptr(),
          scale.data_ptr(), z.data_ptr(), reached.data_ptr(),
          None if lfrac is None else lfrac.data_ptr(),
          None if lf_out is None else lf_out.data_ptr(),
          out["goodput_bps"].data_ptr(), out["delay_s"].data_ptr(),
          out["delivered_frac"].data_ptr(), out["max_util"].data_ptr(),
          F, H, L, C, R, int(rounds), smem, int(t["fold"]), f(jitter),
          f(-hj2),
          f(UTIL_MIN), f(RHO_MAX),
          torch.cuda.current_stream(dev).cuda_stream)
    _count("as_fluid")
    if C > 1:
        _count("as_fluid:sweep")
    return out, lf_out


def _call(symbol: str, argtypes: list, *args) -> None:
    """Call the library's entry ``symbol``; raise on an error."""
    from tpudes_torch._build import load_library

    fn = getattr(load_library("as_flows"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")


def _count(name: str) -> None:
    from tpudes_torch.parallel.kernels_cuda import launches

    launches[name] += 1


#: ctypes signature of ``as_spf_launch`` (csrc/as_flows.cu): row_ptr,
#: col_v, col_w, col_e, dsts, scratch (null: shared memory), dist, nh_edge,
#: nh_node, four ints (N, D, rounds, shared bytes), INF, the slack, stream
SPF_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])
#: ``as_fluid_launch``: hop_link, ptr, slot, c, k, dly, fm, scale, z,
#: reached, lfrac in and out (null: zeros, none), goodput, delay, frac,
#: max_util, eight ints (F, H, L, C, R, rounds, shared bytes, fold), four
#: floats (jitter, -jitter^2 / 2, UTIL_MIN, RHO_MAX), stream
FLUID_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 8
                  + [ctypes.c_float] * 4 + [ctypes.c_void_p])
