"""The AS flow engine's two CUDA kernels: the wrappers.

``csrc/as_flows.cu`` replaces the reference's routing stage, its path
walk, its draws and its fluid fixed point (``tpudes/parallel/
as_flows.py:227-293``, the ``lax.scan`` of Bellman-Ford rounds, the
next-hop scatter and the walk; ``:633-644``, the replicas' normal draws;
``:309-377`` and the ``while_loop`` at ``:485-518``; XLA code, no
``pallas_call``):

- :func:`spf_launch` (:func:`spf_cuda` on the card): ``as_spf``, one CTA
  of 32 warps a destination row, Jacobi rounds over a frontier (the nodes
  the last round changed), a warp spreading 32 frontier nodes' edges over
  its lanes, then each node's next hop, the row's tables and the walk of
  the row's flows; its two distance buffers and two frontier lists in
  shared memory while ``16 N`` bytes fit (the ``GLOBAL`` instantiation
  keeps them in device memory past that);
- :func:`fluid_launch` (:func:`fluid_cuda` on the card): ``as_fluid``, one
  CTA a replica, the run's tables copied into shared memory
  (``cp.async``) while the CTA draws its replica's rates from the run's
  key, then each of the C points in turn: the rounds a flow-hop and a
  link a lane, stopped at the fixed point (a round that moves no link's
  log delivery); each link sums its contributions in its list's (hop,
  flow) order.

Each equals its plain version (:func:`tpudes_torch.parallel.as_flows.
spf_math` with :func:`~tpudes_torch.parallel.as_flows.walk_math`,
:func:`~tpudes_torch.parallel.as_flows.fluid_draws_math`) bit for bit.
On CPU tensors a wrapper takes the plain version; on CUDA tensors it
launches its kernel or raises.  Every launch is counted in
:data:`tpudes_torch.parallel.kernels_cuda.launches` under ``as_spf`` or
``as_fluid``, a grid of more than one rate scale also under
``as_fluid:sweep``.  :func:`spf_profile` and :func:`fluid_profile` run
the kernels' stage probes (not counted); :func:`erf_inv_check` the
draw's ``erf_inv`` alone.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpudes_torch.parallel.as_flows import (
    INF,
    NEXT_HOP_SLACK,
    RHO_MAX,
    UTIL_MIN,
    fluid_draws_math,
    spf_math,
    walk_math,
)
from tpudes_torch.parallel.kernels_cuda import _check

#: threads of an ``as_fluid`` CTA (FLUID_THREADS in the .cu)
FLUID_THREADS = 128
#: the shared memory a CTA may take (the card's opt-in limit), less room
#: for ``as_spf``'s static words
SMEM_LIMIT = 227 * 1024
SPF_STATIC_SMEM = 1024

#: the stage probe's words (``SPF_PROF_*`` and ``FLUID_PROF_*`` in the
#: .cu): ``as_spf``'s set-up, then for each of :data:`SPF_PROF_ROUNDS`
#: rounds (later rounds add to the last) the slowest warp's relaxation and
#: the least and the most wait over warps at the round's barrier, then the
#: next-hop pass, the row writes, the walk and the rounds run; ``as_fluid``'s
#: set-up, each of :data:`FLUID_PROF_ROUNDS` rounds' flow step and link
#: step, and the delays with the outputs
SPF_PROF_ROUNDS = 16
SPF_PROF_WORDS = 5 + 3 * SPF_PROF_ROUNDS
FLUID_PROF_ROUNDS = 8
FLUID_PROF_WORDS = 2 + 2 * FLUID_PROF_ROUNDS


def spf_stages(words, ctas: int) -> dict:
    """The ``as_spf`` probe's ``(SPF_PROF_WORDS,)`` sums over CTAs as
    cycles a CTA (a destination row): ``setup``, ``round_<r>`` (each with
    ``relax``, ``wait_min``, ``wait_max``) for the rounds run, ``next_hop``,
    ``rows``, ``walk`` and ``rounds`` (the mean rounds run)."""
    w = [float(v) / ctas for v in words]
    rounds = w[4 + 3 * SPF_PROF_ROUNDS]
    out = {"setup": w[0]}
    for r in range(min(SPF_PROF_ROUNDS, int(np.ceil(rounds)))):
        out[f"round_{r}"] = dict(zip(("relax", "wait_min", "wait_max"),
                                     w[1 + 3 * r:4 + 3 * r]))
    out.update(next_hop=w[1 + 3 * SPF_PROF_ROUNDS],
               rows=w[2 + 3 * SPF_PROF_ROUNDS],
               walk=w[3 + 3 * SPF_PROF_ROUNDS], rounds=rounds)
    return out


def fluid_stages(words, rows: int, rounds: int) -> dict:
    """The ``as_fluid`` probe's ``(FLUID_PROF_WORDS,)`` sums over CTAs as
    cycles a grid row (``rows``: points x replicas): ``setup``,
    ``flow_<r>`` and ``link_<r>`` for the first ``rounds`` rounds (0 for a
    round a row did not run), ``delay``."""
    w = [float(v) / rows for v in words]
    out = {"setup": w[0]}
    for r in range(min(rounds, FLUID_PROF_ROUNDS)):
        out[f"flow_{r}"] = w[1 + 2 * r]
        out[f"link_{r}"] = w[2 + 2 * r]
    out["delay"] = w[FLUID_PROF_WORDS - 1]
    return out


def spf_smem_bytes(n: int) -> int:
    """Shared memory of an ``as_spf`` CTA that keeps its row's two distance
    buffers and two frontier lists there (0: they do not fit, the
    ``GLOBAL`` instantiation)."""
    need = 16 * n
    return need if need + SPF_STATIC_SMEM <= SMEM_LIMIT else 0


def fluid_smem_bytes(t: dict, F: int) -> int:
    """Shared memory of an ``as_fluid`` CTA: the tables' blob, ``lfrac``
    and ``util`` of the L links, the jitter factor, rate and ``lg`` of the
    F flows, the FH contributions and a word per warp for the maximum."""
    L = t["c"].shape[0]
    return 4 * (t["blob"].shape[0] + 2 * L + 3 * F + t["fh"]
                + FLUID_THREADS // 32)


def spf_launch(g: dict, n: int, rounds: int) -> tuple:
    """The routing stage and the walk for the graph ``g``
    (:func:`~tpudes_torch.parallel.as_flows.spf_graph`) of ``n`` nodes:
    ``(dist, nh_edge, nh_node, path, hops, reached)``, ``(D, N)`` f32,
    int32, int32, ``(F, H)`` int32, ``(F,)`` int32 and bool.  One
    ``as_spf`` launch for CUDA tensors; :func:`spf_math` and
    :func:`walk_math` for CPU ones."""
    dev = g["w"].device
    if dev.type == "cpu":
        dist, nh_edge, nh_node = spf_math(g, n, rounds)
        return (dist, nh_edge, nh_node,
                *walk_math(g, dist, nh_edge, nh_node))
    if dev.type != "cuda":
        raise ValueError(f"no as_spf for device {dev}")
    return spf_cuda(g, n, rounds)


def spf_cuda(g: dict, n: int, rounds: int, shared: bool | None = None,
             prof=None) -> tuple:
    """Launch ``as_spf`` once on ``g``'s tensors (:func:`spf_launch`'s
    arguments and result); raises on a bad argument or a launch error and
    never takes the plain version.  ``shared=False`` runs the ``GLOBAL``
    instantiation where the rows would fit in shared memory (the checks
    of that arm; None: shared memory where the rows fit).  ``prof`` (int64
    words) runs the stage probe instead, uncounted."""
    dev = g["w"].device
    D, E2 = g["dsts"].shape[0], g["col_v"].shape[0]
    F, H = g["src"].shape[0], g["max_hops"]
    if (n < 1 or D < 1 or E2 >= 2**30 or D * n * 4 >= 2**31 or rounds < 0
            or H < 0 or E2 != g["e2"]):
        raise ValueError(f"as_spf takes 1 <= N, 1 <= D, 2E < 2^30, 4 D N < "
                         f"2^31, rounds >= 0, max_hops >= 0; got N={n}, "
                         f"D={D}, 2E={E2}, rounds={rounds}, max_hops={H}")
    _check("row_ptr", g["row_ptr"], (n + 1,), torch.int32, dev)
    for name, dtype in (("col_v", torch.int32), ("col_w", torch.float32),
                        ("col_e", torch.int32)):
        _check(name, g[name], (E2,), dtype, dev)
    _check("dsts", g["dsts"], (D,), torch.int32, dev)
    _check("flow_ptr", g["flow_ptr"], (D + 1,), torch.int32, dev)
    for name in ("flow_ids", "src"):
        _check(name, g[name], (F,), torch.int32, dev)
    dist = torch.empty((D, n), dtype=torch.float32, device=dev)
    nh_edge = torch.empty((D, n), dtype=torch.int32, device=dev)
    nh_node = torch.empty((D, n), dtype=torch.int32, device=dev)
    path = torch.empty((F, H), dtype=torch.int32, device=dev)
    hops = torch.empty((F,), dtype=torch.int32, device=dev)
    reached = torch.empty((F,), dtype=torch.bool, device=dev)
    smem = spf_smem_bytes(n) if shared is not False else 0
    if shared and not smem:
        raise ValueError(f"as_spf's rows of {n} nodes do not fit in "
                         f"{SMEM_LIMIT} B of shared memory")
    scratch = None if smem else torch.empty((D, 4, n), dtype=torch.int32,
                                            device=dev)
    _call("as_spf_launch", SPF_ARGTYPES, g["row_ptr"].data_ptr(),
          g["col_v"].data_ptr(), g["col_w"].data_ptr(),
          g["col_e"].data_ptr(), g["dsts"].data_ptr(),
          g["flow_ptr"].data_ptr(), g["flow_ids"].data_ptr(),
          g["src"].data_ptr(),
          None if scratch is None else scratch.data_ptr(), dist.data_ptr(),
          nh_edge.data_ptr(), nh_node.data_ptr(), path.data_ptr(),
          hops.data_ptr(), reached.data_ptr(),
          None if prof is None else prof.data_ptr(),
          n, D, F, H, E2, int(rounds), smem, ctypes.c_float(INF),
          ctypes.c_float(NEXT_HOP_SLACK),
          torch.cuda.current_stream(dev).cuda_stream)
    if prof is None:
        _count("as_spf")
    return dist, nh_edge, nh_node, path, hops, reached


def spf_profile(g: dict, n: int, rounds: int, prof,
                shared: bool | None = None) -> tuple:
    """The stage probe of ``as_spf``: :func:`spf_cuda`'s launch by the
    kernel's ``PROF`` instantiation, which adds its
    :data:`SPF_PROF_WORDS` cycles (sums over CTAs, :func:`spf_stages`) to
    the int64 ``prof``.  Returns the outputs.  Not counted in
    ``kernels_cuda.launches``."""
    _check("prof", prof, (SPF_PROF_WORDS,), torch.int64, g["w"].device)
    return spf_cuda(g, n, rounds, shared, prof)


def fluid_launch(t: dict, fm, scale, key, replicas: int, reached,
                 jitter: float, hj2: float, rounds: int, lfrac=None,
                 carry: bool = False, z_out: bool = False) -> tuple:
    """The draws and the fluid stage over the ``(C, R)`` grid
    (:func:`~tpudes_torch.parallel.as_flows.fluid_inputs`' arguments):
    ``(out, lfrac)``, the outputs and, with ``carry``, the ``(C, R, L)``
    log deliveries after the last round (else None); with ``z_out``
    ``out["z"]`` is the ``(R, F)`` draws.  One ``as_fluid`` launch for
    CUDA tensors; :func:`~tpudes_torch.parallel.as_flows.
    fluid_draws_math` for CPU ones."""
    dev = fm.device
    if dev.type == "cpu":
        out, lf, z = fluid_draws_math(t, fm, scale, key, replicas, reached,
                                      jitter, hj2, rounds, lfrac)
        if z_out:
            out["z"] = z
        return out, (lf if carry else None)
    if dev.type != "cuda":
        raise ValueError(f"no as_fluid for device {dev}")
    return fluid_cuda(t, fm, scale, key, replicas, reached, jitter, hj2,
                      rounds, lfrac, carry, z_out)


def fluid_cuda(t: dict, fm, scale, key, replicas: int, reached,
               jitter: float, hj2: float, rounds: int, lfrac=None,
               carry: bool = False, z_out: bool = False,
               prof=None) -> tuple:
    """Launch ``as_fluid`` once on the tensors' device
    (:func:`fluid_launch`'s arguments and result); raises on a bad argument
    or a launch error and never takes the plain version.  ``prof`` (int64
    words) runs the stage probe instead, uncounted."""
    dev = fm.device
    F = fm.shape[0]
    L = t["c"].shape[0]
    C, R = scale.shape[0], int(replicas)
    FH, words = t["fh"], t["blob"].shape[0]
    smem = fluid_smem_bytes(t, F)
    if (smem > SMEM_LIMIT or C * R >= 2**31 or rounds < 1 or F < 1
            or R < 1):
        raise ValueError(f"as_fluid keeps a CTA's tables, links and "
                         f"flow-hops in {SMEM_LIMIT} B of shared memory and "
                         f"runs >= 1 round; got L={L}, F={F}, FH={FH} "
                         f"({smem} B), C={C}, R={R}, rounds={rounds}")
    _check("blob", t["blob"], (words,), torch.int32, dev)
    if t["blob"].data_ptr() % 16:
        raise ValueError("as_fluid's tables must start on 16 bytes")
    _check("fm", fm, (F,), torch.float32, dev)
    _check("scale", scale, (C,), torch.float32, dev)
    _check("key", key, (2,), torch.int64, dev)
    _check("reached", reached, (F,), torch.bool, dev)
    if lfrac is not None:
        _check("lfrac", lfrac, (C, R, L), torch.float32, dev)
    out = {k: torch.empty((C, R, F), dtype=torch.float32, device=dev)
           for k in ("goodput_bps", "delay_s", "delivered_frac")}
    out["max_util"] = torch.empty((C, R), dtype=torch.float32, device=dev)
    if z_out:
        out["z"] = torch.empty((R, F), dtype=torch.float32, device=dev)
    lf_out = (torch.empty((C, R, L), dtype=torch.float32, device=dev)
              if carry else None)
    f = ctypes.c_float
    _call("as_fluid_launch", FLUID_ARGTYPES, t["blob"].data_ptr(),
          fm.data_ptr(), scale.data_ptr(), key.data_ptr(),
          reached.data_ptr(), None if lfrac is None else lfrac.data_ptr(),
          None if lf_out is None else lf_out.data_ptr(),
          out["goodput_bps"].data_ptr(), out["delay_s"].data_ptr(),
          out["delivered_frac"].data_ptr(), out["max_util"].data_ptr(),
          out["z"].data_ptr() if z_out else None,
          None if prof is None else prof.data_ptr(),
          F, L, FH, words, C, R, int(rounds), smem, int(t["fold"]),
          f(jitter), f(-hj2), f(UTIL_MIN), f(RHO_MAX),
          torch.cuda.current_stream(dev).cuda_stream)
    if prof is None:
        _count("as_fluid")
        if C > 1:
            _count("as_fluid:sweep")
    return out, lf_out


def fluid_profile(t: dict, fm, scale, key, replicas: int, reached,
                  jitter: float, hj2: float, rounds: int, prof) -> dict:
    """The stage probe of ``as_fluid``: :func:`fluid_cuda`'s launch by the
    kernel's ``PROF`` instantiation, which adds its
    :data:`FLUID_PROF_WORDS` cycles (sums over CTAs,
    :func:`fluid_stages`) to the int64 ``prof``.  Returns the outputs.
    Not counted in ``kernels_cuda.launches``."""
    _check("prof", prof, (FLUID_PROF_WORDS,), torch.int64, fm.device)
    return fluid_cuda(t, fm, scale, key, replicas, reached, jitter, hj2,
                      rounds, prof=prof)[0]


def erf_inv_check(x: torch.Tensor) -> torch.Tensor:
    """The draw's ``erf_inv`` in ``as_fluid`` (``xla_math::xla_erf_inv``)
    on the ``(n,)`` f32 ``x`` on its device (``as_erf_inv_check``): equal
    to ``ops.fused.erf_inv`` bit for bit.  Not counted in
    ``kernels_cuda.launches``."""
    n = x.shape[0]
    _check("x", x, (n,), torch.float32, x.device)
    out = torch.empty_like(x)
    _call("as_erf_inv_check", ERF_INV_ARGTYPES, x.data_ptr(),
          out.data_ptr(), n, torch.cuda.current_stream(x.device).cuda_stream)
    return out


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
#: col_v, col_w, col_e, dsts, flow_ptr, flow_ids, src, scratch (null:
#: shared memory), dist, nh_edge, nh_node, path, hops, reached, prof (null:
#: the main instantiation), seven ints (N, D, F, H, 2E, rounds, shared
#: bytes), INF, the slack, stream
SPF_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])
#: ``as_fluid_launch``: blob, fm, scale, key, reached, lfrac in and out
#: (null: zeros, none), goodput, delay, frac, max_util, z_out and prof
#: (null: none), nine ints (F, L, FH, blob words, C, R, rounds, shared
#: bytes, fold), four floats (jitter, -jitter^2 / 2, UTIL_MIN, RHO_MAX),
#: stream
FLUID_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                  + [ctypes.c_float] * 4 + [ctypes.c_void_p])
#: ``as_erf_inv_check``: x, out, n (int64), stream
ERF_INV_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_void_p]
