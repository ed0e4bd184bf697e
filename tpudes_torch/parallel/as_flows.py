"""The AS flow engine on the card (BASELINE config #5).

Counterpart of ``tpudes/parallel/as_flows.py``: a BRITE AS graph of N
nodes and E undirected links carries F sparse CBR flows, and R
Monte-Carlo replicas draw each flow's offered rate around its nominal.
One run is two stages:

- **routing** (:func:`device_spf`, ``as_flows.py:213-267``): Bellman-Ford
  over the ``2E`` directed edges (edges first as given, then reversed) for
  the D distinct destinations, ``spf_rounds`` Jacobi rounds ``new[u] =
  min(old[u], min over u->v of old[v] + w)``, then each node's next hop
  toward each destination, the smallest directed index among the edges
  whose ``w + dist[v]`` is within ``1 + 1e-6`` of the best; then each
  flow's path, a walk of at most ``max_hops`` hops (:func:`walk_math`,
  ``:270-293``), shared by every replica;
- **the fluid fixed point** (:func:`fluid_math`, ``:309-377`` and the
  ``while_loop`` at ``:485-518``): :data:`FP_ROUNDS` rounds in which each
  flow walks its path, adding its surviving rate ``rate * exp(lg)`` to
  each link's load and the link's log delivery to ``lg``; a link's
  delivery is ``min(1, capacity / load)``; then the M/M/1 queueing,
  serialisation and propagation delay summed along each path.

On the card each stage is one launch of a hand-written kernel in
``csrc/as_flows.cu`` (:mod:`tpudes_torch.parallel.as_cuda`): ``as_spf``, a
CTA a destination row, which also walks the row's flows, and ``as_fluid``,
a CTA a replica, which also draws the replica's rates.  On
the CPU the wrappers take the plain versions, :func:`spf_math` with
:func:`walk_math`, and ``random.as_replica_draws`` with
:func:`fluid_math`.

The arithmetic is the reference's as its CPU backend compiles it (the
optimised HLO of the jitted runner): ``load / cap`` is a product with the
folded f32 reciprocal ``1 / cap``; ``8 pkt / cap`` is a folded f32
constant ``k``; a link's delay ``rho / (1 - rho) * k + k + dly`` fuses its
product into one multiply-add, as does the rate's exponent ``z * jitter -
jitter^2 / 2``, and where ``k`` and ``dly`` are each one value on every
link (a line of equal links) the compiler adds ``k + dly`` first
(:func:`link_constants`); ``exp`` and ``log`` are the compiled ones
(:mod:`tpudes_torch.ops.fused`).  A link's load is the sum of its
contributions in (hop, flow) order, from 0: the CPU applies a scatter's
duplicate updates in update order, hop after hop.  Neither version sums
with ``atomicAdd`` or ``index_add_``, whose order is not fixed.

The engine runs on :mod:`tpudes_torch.parallel.runtime`: the graph's
tables and the fluid stage's tables (built from the first run's paths,
which are a pure function of the program) sit in the runner cache, keyed
by value as the reference's ``as_prog_key``; the routing stage and the
walk still run every call, as the reference's executable runs them.  The
replica axis is padded to its power-of-two bucket (replica ``r``'s draws
are ``normal(fold_in(key, r), (F,))`` and every output row depends on its
own draws only, so the real replicas cannot move), the fixed point's
chunks go through ``drive_chunks`` (``checkpoint=`` saves the carry
after each), and ``block=False`` returns an :class:`~tpudes_torch.
parallel.runtime.EngineFuture`.  :func:`as_study` is the serving layer's
descriptor.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``mesh`` (A12), the ``TpudesObs`` columns (A10) and the smooth
surrogate (``prog.surrogate``, ``build_as_diff``: A14);
``lower_as_flows`` from a host object graph (A16) is not here either.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpudes_torch.device import resolve_device, to_device
from tpudes_torch.ops.fused import exp, f32, fma, log
from tpudes_torch.parallel.runtime import (
    RUNTIME,
    EngineFuture,
    _not_ported,
    bucket_replicas,
    chunk_bounds,
    drive_chunks,
    finalize_with_flush,
)
from tpudes_torch.random import as_replica_draws
from tpudes_torch.traffic.device import avg_mult

__all__ = ["AsFlowsProgram", "FP_ROUNDS", "INF", "as_prog_key", "as_study",
           "device_spf",
           "fluid_draws_math", "fluid_inputs", "fluid_math", "fluid_tables",
           "run_as_flows", "spf_graph", "spf_math", "walk_math",
           "walk_paths"]

#: the distance of an unreachable node (``as_flows.py:37``)
INF = 1e30
#: "no edge": the next-hop tables' fill (``as_flows.py:263``)
BIG = 2**30
#: fluid fixed-point rounds (``as_flows.py:298``)
FP_ROUNDS = 4
#: ``1 + 1e-6`` in f32: the next hop's tie slack (``as_flows.py:264``)
NEXT_HOP_SLACK = float(np.float32(1 + 1e-6))
#: a link's utilisation never enters the delay above this
#: (``as_flows.py:364``)
RHO_MAX = 0.99
#: the utilisation below which a link delivers all (``as_flows.py:338``)
UTIL_MIN = 1e-9

#: the reference fuzzer's axes (``as_flows.py:43-68``): the documented
#: region of BA graphs and sparse CBR loads the port is held to
FUZZ_AXES = {
    "n_nodes": ("int", 24, 72),
    "n_flows": ("int", 2, 6),
    "flow_kbps": ("choice", (200.0, 400.0, 800.0)),
    "pkt_bytes": ("choice", (256, 512)),
    "topo_seed": ("int", 1, 999),
    "sim_ms": ("int", 1000, 2500),
    "replicas": ("int", 2, 9),
    "chunk_divisor": ("choice", (2,)),
    "key_seed": ("int", 0, 2**16),
    "traffic": ("choice", ("off", "cbr", "mmpp", "onoff", "trace")),
    "tr_burst": ("float", 0.1, 0.6),
    "tr_phase": ("float", 0.0, 1.0),
    "surrogate": ("choice", ("off", "ste")),
}


@dataclass(frozen=True)
class AsFlowsProgram:
    """Static program of one AS-topology traffic study
    (``as_flows.py:71-108``), the same fields."""

    n: int                      # nodes
    edges: np.ndarray           # (E, 2) undirected
    delay_s: np.ndarray         # (E,)
    rate_bps: np.ndarray        # (E,)
    src: np.ndarray             # (F,) flow source node
    dst: np.ndarray             # (F,) flow destination node
    flow_bps: np.ndarray        # (F,) nominal offered rate
    pkt_bytes: int
    sim_s: float
    max_hops: int = 32          # path-walk bound
    spf_rounds: int = 48        # Bellman-Ford rounds
    rate_jitter: float = 0.3    # per-replica lognormal rate spread
    #: "hops" (every link weighs 1) or "delay" (propagation delay)
    spf_metric: str = "hops"
    #: a :class:`~tpudes_torch.traffic.program.TrafficProgram` over the F
    #: flows (None: constant nominal rates): each flow's rate scales by
    #: :func:`~tpudes_torch.traffic.device.avg_mult` over ``sim_s``
    traffic: object = None
    #: the reference's smooth-surrogate config; not ported (A14): a
    #: program that sets it is refused
    surrogate: object = None


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float64).astype(np.float32)


def spf_graph(prog: AsFlowsProgram, device) -> dict:
    """The routing stage's graph on ``device``: the ``2E`` directed edges
    ``u``, ``v`` (int64) and weights ``w`` (f32: 1, or the link's delay in
    f32), the same edges as a CSR grouped by source node (``row_ptr``
    ``(N + 1,)``, ``col_v``, ``col_w``, ``col_e`` int32 / f32 in directed
    index order within a node), the ``(D,)`` distinct destinations
    ``dsts`` and each flow's row ``ddst`` (``as_flows.py:227-235``); for
    the walk, the flows' sources ``src`` and destinations ``fdst``
    (int32), each row's flows as a CSR (``flow_ptr`` ``(D + 1,)``,
    ``flow_ids`` ``(F,)``, ascending within a row), and the ints
    ``max_hops`` and ``e2`` (2E)."""
    e = np.concatenate([prog.edges, prog.edges[:, ::-1]]).astype(np.int64)
    if prog.spf_metric == "hops":
        w = np.ones(e.shape[0], np.float32)
    elif prog.spf_metric == "delay":
        w = _f32(np.concatenate([prog.delay_s, prog.delay_s]))
    else:
        raise ValueError(f"unknown spf_metric {prog.spf_metric!r}")
    order = np.argsort(e[:, 0], kind="stable")
    counts = np.bincount(e[:, 0], minlength=prog.n)
    row_ptr = np.zeros(prog.n + 1, np.int32)
    row_ptr[1:] = np.cumsum(counts)
    dsts, inv = np.unique(np.asarray(prog.dst), return_inverse=True)
    flow_ptr = np.zeros(dsts.size + 1, np.int32)
    flow_ptr[1:] = np.cumsum(np.bincount(inv, minlength=dsts.size))

    def on(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return dict(
        u=on(e[:, 0], torch.int64), v=on(e[:, 1], torch.int64),
        w=on(w, torch.float32),
        row_ptr=on(row_ptr, torch.int32), col_v=on(e[order, 1], torch.int32),
        col_w=on(w[order], torch.float32), col_e=on(order, torch.int32),
        dsts=on(dsts, torch.int32), ddst=on(inv, torch.int64),
        src=on(prog.src, torch.int32), fdst=on(prog.dst, torch.int32),
        flow_ptr=on(flow_ptr, torch.int32),
        flow_ids=on(np.argsort(inv, kind="stable"), torch.int32),
        max_hops=int(prog.max_hops), e2=int(e.shape[0]),
    )


def spf_math(g: dict, n: int, rounds: int) -> tuple:
    """The plain routing stage (``as_flows.py:243-266``) on ``g``'s device:
    ``(dist, nh_edge, nh_node)``, ``(D, N)`` f32, int32, int32.  Each round
    relaxes every directed edge from the round's old table (a scatter-min,
    which is exact in any order)."""
    dsts = g["dsts"].long()
    D = dsts.shape[0]
    u, v, w = g["u"], g["v"], g["w"]
    dev = w.device
    dist = torch.full((D, n), INF, dtype=torch.float32, device=dev)
    dist[torch.arange(D, device=dev), dsts] = 0.0
    idx = u[None, :].expand(D, -1)
    for _ in range(int(rounds)):
        dist = dist.scatter_reduce(1, idx, dist[:, v] + w[None, :], "amin",
                                   include_self=True)
    score = w[None, :] + dist[:, v]
    best = torch.full((D, n), INF, dtype=torch.float32, device=dev)
    best = best.scatter_reduce(1, idx, score, "amin", include_self=True)
    eidx = torch.arange(u.shape[0], dtype=torch.int32, device=dev)
    cand = torch.where(score <= best[:, u] * f32(score, NEXT_HOP_SLACK),
                       eidx[None, :], BIG)
    nh_edge = torch.full((D, n), BIG, dtype=torch.int32, device=dev)
    nh_edge = nh_edge.scatter_reduce(1, idx, cand, "amin", include_self=True)
    nh_node = torch.where(
        nh_edge < BIG, v[torch.clamp_max(nh_edge, u.shape[0] - 1).long()]
        .to(torch.int32), -1)
    return dist, nh_edge, nh_node


def device_spf(prog: AsFlowsProgram, device=None) -> tuple:
    """``(ddst, dist, nh_edge, nh_node)`` for the program's distinct
    destinations (``as_flows.py:213-267``): ``ddst`` maps a flow to its
    row of the ``(D, N)`` tables.  One ``as_spf`` launch on the card
    (:func:`tpudes_torch.parallel.as_cuda.spf_launch`, which also walks
    the paths), :func:`spf_math` on the CPU."""
    from tpudes_torch.parallel.as_cuda import spf_launch

    g = spf_graph(prog, resolve_device(device))
    return (g["ddst"], *spf_launch(g, prog.n, prog.spf_rounds)[:3])


def _walk(src, dst, ddst, hops_max: int, e2: int, nh_edge, nh_node):
    """The walk of :func:`walk_paths` over int64 ``src``, ``dst``,
    ``ddst``."""
    dev = nh_edge.device
    cur = src
    cols = []
    for _ in range(hops_max):
        done = (cur == dst) | (cur < 0)
        at = torch.clamp_min(cur, 0)
        edge = torch.where(done, BIG, nh_edge[ddst, at])
        cur = torch.where(done, -1, nh_node[ddst, at].long())
        cols.append(torch.where(edge < BIG, edge, e2))
    path = torch.stack(cols, 1).to(torch.int32) if cols else torch.zeros(
        (src.shape[0], 0), dtype=torch.int32, device=dev)
    hops = (path < e2).sum(1, dtype=torch.int32)
    arrived = (cur == -1) | (cur == dst)
    return path, hops, arrived


def walk_paths(prog: AsFlowsProgram, ddst, nh_edge, nh_node) -> tuple:
    """``(path, hops, arrived)``: each flow's ``(F, H)`` directed-edge
    index per hop (``2E`` past its end), its hop count and whether the walk
    ended at its destination (``as_flows.py:270-293``); shared by every
    replica."""
    dev = nh_edge.device
    return _walk(torch.as_tensor(np.asarray(prog.src), dtype=torch.int64,
                                 device=dev),
                 torch.as_tensor(np.asarray(prog.dst), dtype=torch.int64,
                                 device=dev),
                 ddst, int(prog.max_hops), 2 * prog.edges.shape[0], nh_edge,
                 nh_node)


def walk_math(g: dict, dist, nh_edge, nh_node) -> tuple:
    """The plain walk on the graph ``g`` (:func:`spf_graph`) and its
    routing tables: ``(path, hops, reached)``, :func:`walk_paths`' paths
    and hop counts, and whether each flow is reached (its source at a
    finite distance and its walk arrived; ``as_flows.py:493``)."""
    src = g["src"].long()
    path, hops, arrived = _walk(src, g["fdst"].long(), g["ddst"],
                                g["max_hops"], g["e2"], nh_edge, nh_node)
    return path, hops, (dist[g["ddst"], src] < INF) & arrived


def link_constants(prog: AsFlowsProgram) -> tuple:
    """``(c, k, dly, fold)``: each undirected link's ``(E,)`` f32 constants
    as the compiled runner folds them, ``1 / cap`` and ``8 pkt / cap``
    divided in f32 and the delay in f32 (``as_flows.py:336``,
    ``:366-369``), and whether ``k`` and ``dly`` are each one value on
    every link.  Then the compiler holds them as two scalar constants and
    adds them first: a link's delay is ``fma(q, k, k + dly)``, not
    ``fma(q, k, k) + dly``."""
    cap = _f32(prog.rate_bps)
    with np.errstate(divide="ignore"):
        c = np.float32(1.0) / cap
        k = np.float32(8.0 * prog.pkt_bytes) / cap
    dly = _f32(prog.delay_s)
    fold = bool((k == k[0]).all() and (dly == dly[0]).all())
    return c, k, dly, fold


def fluid_tables(prog: AsFlowsProgram, path: torch.Tensor) -> dict:
    """The fluid stage's tables, built once per run on ``path``'s device
    from the ``(F, H)`` paths: the ``L`` touched directed links ``links``
    (ascending), each flow-hop's compact link ``hop_link`` ``(F, H)``
    int32 (-1 past the path's end), each link's contributions as a CSR
    ``ptr`` ``(L + 1,)`` / ``slot`` int32 in (hop, flow) order, a slot
    being ``h F + f``, and the links' f32 constants ``c``, ``k`` and
    ``dly`` and the flag ``fold`` (:func:`link_constants`); and for
    ``as_fluid`` the same compacted to the ``FH`` flow-hops in one int32
    ``blob`` (each part padded to 4 words: each flow's flow-hops ``fh_ptr``
    ``(F + 1,)``, their compact links and flows, ``(FH,)`` each, flow
    after flow in hop order; each link's contributions ``lptr`` ``(L +
    1,)`` and ``lslot`` ``(FH,)``, flow-hop positions in (hop, flow)
    order; ``c``, ``k``, ``dly`` as f32 bits) and the count ``fh``."""
    dev = path.device
    F, H = path.shape
    E = prog.edges.shape[0]
    valid = path < 2 * E
    links = torch.unique(path[valid].long())
    hop_link = torch.where(valid, torch.searchsorted(links, path.long()),
                           -1).to(torch.int32)
    slot = (torch.arange(H, device=dev)[None, :] * F
            + torch.arange(F, device=dev)[:, None])
    key = (hop_link.long() * (H * F) + slot)[valid]
    ordered = torch.sort(key).values
    counts = torch.bincount(hop_link[valid].long(), minlength=links.numel())
    ptr = torch.zeros(links.numel() + 1, dtype=torch.int32, device=dev)
    ptr[1:] = torch.cumsum(counts, 0)
    *consts, fold = link_constants(prog)
    c, k, dly = (torch.as_tensor(a, device=dev)[links % E] for a in consts)
    slot = ordered % (H * F)
    fh_ptr = torch.zeros(F + 1, dtype=torch.int64, device=dev)
    fh_ptr[1:] = torch.cumsum(valid.sum(1), 0)
    flow = torch.arange(F, device=dev)[:, None].expand(F, H)
    parts = (fh_ptr, hop_link[valid], flow[valid], ptr,
             fh_ptr[slot % F] + slot // F,
             *(x.view(torch.int32) for x in (c, k, dly)))
    blob = torch.cat([torch.nn.functional.pad(x.to(torch.int32),
                                              (0, -x.numel() % 4))
                      for x in parts])
    return dict(links=links, hop_link=hop_link.contiguous(), ptr=ptr,
                slot=slot.to(torch.int32), c=c.contiguous(),
                k=k.contiguous(), dly=dly.contiguous(), fold=fold,
                blob=blob, fh=int(slot.numel()))


def rate_constants(prog: AsFlowsProgram) -> tuple:
    """``(jitter, half_jitter_sq)`` in f32, the rate exponent's two
    constants ``z * jitter - jitter^2 / 2`` (``as_flows.py:491-493``)."""
    j = float(prog.rate_jitter)
    return float(np.float32(j)), float(np.float32(0.5 * j ** 2))


def flow_rates(fm, scale, z, reached, jitter: float, hj2: float):
    """``(C, R, F)`` offered rates: ``(fbps mult) * scale * exp(z jitter -
    jitter^2 / 2)``, that association, the exponent one multiply-add, 0
    where the flow is not reached (``as_flows.py:491-494``)."""
    e = exp(fma(z, f32(z, jitter), f32(z, -hj2)))               # (R, F)
    rate = (fm[None, :] * scale[:, None])[:, None, :] * e[None]
    return torch.where(reached, rate, f32(rate, 0.0))


def _gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` with index ``-1`` reading 0 (a pad column)."""
    pad = torch.zeros((*x.shape[:-1], 1), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], -1)[..., idx.long() % (x.shape[-1] + 1)]


def fluid_math(t: dict, fm, scale, z, reached, jitter: float, hj2: float,
               rounds: int, lfrac=None) -> tuple:
    """The plain fluid stage over the ``(C, R)`` grid of C rate scales and
    R replicas: ``rounds`` rounds from the carried log deliveries
    ``lfrac`` ``(C, R, L)`` (None: zeros), then the outputs.  ``fm`` is
    ``(F,)`` f32 nominal rate times the workload's multiplier, ``scale``
    ``(C,)``, ``z`` ``(R, F)``, ``reached`` ``(F,)`` bool.  Returns
    ``(out, lfrac)``, ``out`` with ``goodput_bps``, ``delay_s``,
    ``delivered_frac`` ``(C, R, F)`` and ``max_util`` ``(C, R)``.

    A link's load sums its padded contribution list one list position at
    a time, from 0 (:func:`fluid_tables`' (hop, flow) order)."""
    hop_link, c, k, dly = t["hop_link"], t["c"], t["k"], t["dly"]
    F, H = hop_link.shape
    L = c.shape[0]
    C, R = scale.shape[0], z.shape[0]
    dev = z.device
    rate = flow_rates(fm, scale, z, reached, jitter, hj2)
    if lfrac is None:
        lfrac = torch.zeros((C, R, L), dtype=torch.float32, device=dev)
    counts = (t["ptr"][1:] - t["ptr"][:-1]).long()
    width = int(counts.max()) if L else 0
    pos = torch.arange(width, device=dev)
    # (L, width) slots of each link's list; H F (a zero column) past its end
    at = t["ptr"][:-1, None].long() + pos[None, :]
    lists = torch.where(pos[None, :] < counts[:, None],
                        t["slot"][torch.clamp_max(at, max(
                            t["slot"].numel() - 1, 0))].long(), H * F)
    lg = torch.zeros((C, R, F), dtype=torch.float32, device=dev)
    util = torch.zeros((C, R, L), dtype=torch.float32, device=dev)
    for _ in range(int(rounds)):
        lg = torch.zeros((C, R, F), dtype=torch.float32, device=dev)
        contrib = torch.zeros((C, R, H * F + 1), dtype=torch.float32,
                              device=dev)
        for h in range(H):
            contrib[..., h * F:(h + 1) * F] = rate * exp(lg)
            lg = lg + _gather_last(lfrac, hop_link[:, h])
        load = torch.zeros((C, R, L), dtype=torch.float32, device=dev)
        for j in range(width):
            load = load + contrib[..., lists[:, j]]
        util = load * c
        one = torch.ones_like(util)
        lfrac = log(torch.minimum(
            one / torch.clamp_min(util, f32(util, UTIL_MIN)), one))
    rho = torch.clamp_max(util, f32(util, RHO_MAX))
    q = rho / (1.0 - rho)
    ldel = fma(q, k, k + dly) if t["fold"] else fma(q, k, k) + dly
    dl = torch.zeros((C, R, F), dtype=torch.float32, device=dev)
    for h in range(H):
        dl = dl + _gather_last(ldel, hop_link[:, h])
    frac = torch.where(reached, exp(lg), f32(lg, 0.0))
    max_util = (torch.clamp_min(util.amax(-1), 0.0) if L else
                torch.zeros((C, R), dtype=torch.float32, device=dev))
    return dict(goodput_bps=rate * frac,
                delay_s=torch.where(reached, dl, f32(dl, float("inf"))),
                delivered_frac=frac, max_util=max_util), lfrac


def fluid_draws_math(t: dict, fm, scale, key, replicas: int, reached,
                     jitter: float, hj2: float, rounds: int,
                     lfrac=None) -> tuple:
    """The plain draws and fluid stage (:func:`fluid_inputs`' arguments):
    ``z = as_replica_draws(key, replicas, F)``, then :func:`fluid_math`.
    Returns ``(out, lfrac, z)``."""
    z = as_replica_draws(key, int(replicas), fm.shape[0])
    out, lf = fluid_math(t, fm, scale, z, reached, jitter, hj2, rounds,
                         lfrac)
    return out, lf, z


def fluid_inputs(prog: AsFlowsProgram, key, replicas: int, scales,
                 device=None) -> tuple:
    """``(args, hops)``: the routing stage and the path walk of one run
    (:func:`~tpudes_torch.parallel.as_cuda.spf_launch`, one ``as_spf``
    launch on the card), then the fluid stage's leading arguments
    ``(tables, fm, scale, key, replicas, reached, jitter,
    half_jitter_sq)`` for :func:`~tpudes_torch.parallel.as_cuda.
    fluid_launch`: ``key`` the run's ``(2,)`` key, whose replica ``r``
    draws ``normal(fold_in(key, r), (F,))``, ``scales`` the C rate
    scales; and each flow's hop count."""
    from tpudes_torch.parallel.as_cuda import spf_launch

    dev = resolve_device(device)
    key = torch.as_tensor(key, dtype=torch.int64).to(dev)
    g = spf_graph(prog, dev)
    _, _, _, path, hops, reached = spf_launch(g, prog.n, prog.spf_rounds)
    fm = torch.as_tensor(_f32(prog.flow_bps), device=dev)
    if prog.traffic is not None:
        horizon = min(int(prog.sim_s * 1e6), 2**30 - 1)
        fm = fm * avg_mult(prog.traffic.operands(dev),
                           prog.traffic.epoch_us, horizon)
    scale = torch.tensor([float(s) for s in scales], dtype=torch.float32,
                         device=dev)
    return (fluid_tables(prog, path), fm, scale, key, int(replicas), reached,
            *rate_constants(prog)), hops


def as_prog_key(prog: AsFlowsProgram) -> tuple:
    """Hashable identity of the fields that shape a run's tables
    (``as_flows.py:391``, with the node count added): ``sim_s`` is absent
    (the fixed point has no horizon) and the workload adds only its shape
    key."""
    return (
        int(prog.n), prog.edges.tobytes(), prog.delay_s.tobytes(),
        prog.rate_bps.tobytes(), prog.src.tobytes(), prog.dst.tobytes(),
        prog.flow_bps.tobytes(), prog.pkt_bytes, prog.max_hops,
        prog.spf_rounds, prog.rate_jitter, prog.spf_metric,
        None if prog.traffic is None else prog.traffic.shape_key(),
        None if prog.surrogate is None else prog.surrogate,
    )


def as_study(prog: AsFlowsProgram, key, replicas, mesh=None,
             rate_scale: float = 1.0, device=None):
    """Serving-layer study descriptor (``as_flows.py:411``): the offered
    load multiplier is the sweep operand, so two load studies coalesce
    onto one launch whenever their topology, flows, key, replica count,
    mesh and device match.  A lone study still launches through
    ``rate_scale=[x]``."""
    from tpudes_torch.serving.descriptor import (
        StudyDescriptor,
        mesh_fingerprint,
    )

    dev = resolve_device(device)
    ck = as_prog_key(prog) + (
        np.asarray(key, np.int64).tobytes(), int(replicas),
        mesh_fingerprint(mesh),
        # the workload by value, and the horizon it averages over
        None if prog.traffic is None
        else prog.traffic.param_key() + (float(prog.sim_s),),
        str(dev),
    )

    def launch(points, block=False):
        return run_as_flows(prog, key, replicas, mesh=mesh, device=dev,
                            rate_scale=[float(v) for v in points],
                            block=block)

    def warm(n_points):
        # no horizon to shrink: the fixed point runs once a bucket
        run_as_flows(prog, key, replicas, mesh=mesh, device=dev,
                     rate_scale=[1.0] * n_points)

    return StudyDescriptor("as_flows", ck, float(rate_scale), launch, warm)


def _as_runner(prog: AsFlowsProgram, dev) -> dict:
    """A run's cached tables: the graph (:func:`spf_graph`), the nominal
    rates and the rate constants; :func:`run_as_flows` adds the fluid
    stage's tables (:func:`fluid_tables`) from the first run's paths."""
    return dict(g=spf_graph(prog, dev),
                fm=torch.as_tensor(_f32(prog.flow_bps), device=dev),
                rates=rate_constants(prog))


def run_as_flows(prog: AsFlowsProgram, key, replicas: int, *,
                 rate_scale=None, chunk_rounds: int | None = None,
                 device=None, mesh=None, checkpoint=None, block: bool = True,
                 obs: bool = False):
    """Run ``replicas`` replicas of ``prog`` (``as_flows.py:647-783``):
    a dict of numpy arrays, ``goodput_bps``, ``delay_s`` (inf where the
    flow is not reached) and ``delivered_frac`` ``(R, F)`` f32,
    ``max_util`` ``(R,)`` f32, ``hops`` ``(F,)`` int32 and
    ``unreachable`` ``(F,)`` bool.

    ``rate_scale=[...]`` runs C offered-load scales as one ``(C, R)`` grid
    (the routing stage once) and returns one dict a point.
    ``chunk_rounds=N`` runs the fixed point N rounds a launch, carrying the
    links' log deliveries: the same result bit for bit; ``checkpoint=`` (a
    path or a :class:`~tpudes_torch.parallel.checkpoint.CarryCheckpoint`)
    saves the carry after each chunk and resumes a matching run from its
    last completed chunk, bit-equal.  The replica axis is padded to its
    power-of-two bucket and the results sliced back.  ``block=False``
    returns an :class:`~tpudes_torch.parallel.runtime.EngineFuture`.
    ``device`` defaults to the card, where a run is one ``as_spf`` launch
    (the routing and the walk) and one ``as_fluid`` launch a chunk (the
    draws and the fixed point)."""
    if mesh is not None:
        raise _not_ported("mesh", "A12")
    if obs:
        raise _not_ported("TpudesObs", "A10")
    if prog.surrogate is not None:
        raise _not_ported("the smooth surrogate (prog.surrogate, "
                          "build_as_diff)", "A14")
    from tpudes_torch.parallel.as_cuda import fluid_launch, spf_launch
    from tpudes_torch.parallel.checkpoint import checkpoint_ctx

    dev = resolve_device(device)
    r_pad = bucket_replicas(replicas)
    n_cfg = None if rate_scale is None else len(rate_scale)
    scales = [1.0] if rate_scale is None else [float(s) for s in rate_scale]
    runner, _ = RUNTIME.runner(
        "as_flows", as_prog_key(prog) + (r_pad, None, n_cfg, False, str(dev)),
        lambda: _as_runner(prog, dev))
    # the routing stage and the walk run every call, as the reference's
    # executable runs them; their paths are a pure function of the key
    _, _, _, path, hops, reached = spf_launch(runner["g"], prog.n,
                                              prog.spf_rounds)
    if "tables" not in runner:
        runner["tables"] = fluid_tables(prog, path)
    fm = runner["fm"]
    if prog.traffic is not None:
        horizon = min(int(prog.sim_s * 1e6), 2**30 - 1)
        fm = fm * avg_mult(prog.traffic.operands(dev),
                           prog.traffic.epoch_us, horizon)
    key = to_device(key if isinstance(key, torch.Tensor)
                    else np.asarray(key, np.int64), dev, torch.int64)
    args = (runner["tables"], fm, to_device(np.asarray(scales, np.float32),
                                            dev),
            key, int(r_pad), reached, *runner["rates"])

    def launch(c, bound):
        out, lfrac = fluid_launch(*args, bound - c["done"], c["lfrac"],
                                  carry=bound < FP_ROUNDS)
        return dict(done=bound, lfrac=lfrac, out=out)

    ckpt = checkpoint_ctx(
        checkpoint, engine="as_flows", key=key, replicas=replicas,
        r_pad=r_pad, n_cfg=n_cfg, obs=False, axis=1, device=dev,
        extra=as_prog_key(prog) + (
            None if rate_scale is None else tuple(scales),
            None if prog.traffic is None
            else prog.traffic.param_key() + (float(prog.sim_s),)),
    )
    carry, flush = drive_chunks(
        "as_flows", chunk_bounds(FP_ROUNDS, chunk_rounds or FP_ROUNDS),
        dict(done=0, lfrac=None, out=None), launch, checkpoint=ckpt)
    fetch = dict(out=carry["out"], hops=hops, reached=reached)
    R = int(replicas)

    def finalize(host):
        shared = dict(hops=host["hops"], unreachable=~host["reached"])
        points = [dict({k: v[c, :R] for k, v in host["out"].items()},
                       **shared) for c in range(len(scales))]
        return points[0] if rate_scale is None else points

    fut = EngineFuture("as_flows", fetch,
                       finalize_with_flush(flush, finalize))
    return fut.result() if block else fut
