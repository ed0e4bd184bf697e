"""The wired-graph per-link-queue engine on the card.

Counterpart of ``tpudes/parallel/wired.py``: links in a graph, each with
its own FIFO queue, service time and propagation delay, carry
deterministic CBR flows along explicit multi-hop paths on an integer slot
clock.  Link ``l`` serves one packet per ``service[l]`` slots, the packet
that has waited longest by ``(arrival slot, packet id)``; a packet served
at ``t`` reaches its next hop (or its destination) at ``t + service[l] +
delay[l]``.  Queues are unbounded and nothing is random in service, so
every timestamp is exact: a replica equals the reference's host DES
(``run_wired_host``) with the same phase jitter.  A service starts only
strictly below the horizon ``n_slots``; a delivery may land past it.

The engine advances in the reference's ``advance(carry, ing_hop,
ing_ready, t_grant) -> (carry, metrics)`` form (``wired.py:578``): the
ingress operands overwrite packets a peer partition handed over, the
egress buffers are cleared, then every owned link serves below the
grant.  The ingress is written into the carry before the launch (the
kernel and :func:`advance_math` take no ingress);
:mod:`tpudes_torch.parallel.hybrid` scatters its few received entries
straight into the carry and drives the launches by granted windows.
:func:`build_wired_space_advance` runs all partitions as lanes of one
launch (``wired.py:841``).

Each (lane, replica) row steps its own clock from event to event: the
next slot where some packet on an owned link is waiting and its link is
free, ``min max(ready, free[link])``.  A row stepped at a slot before its
own next event serves nothing, so this gives the reference's state, its
``next_event`` (the min over rows of the final state's next event) and
its final ``t``, which all rows share (``t_grant`` where ``t <
t_grant``).  Only the reference's ``n_steps`` metric, the steps of the
union clock of all rows, differs: the port's ``n_steps`` is the most
steps any one row took (ROADMAP Queue C).

On the card a launch is one ``wired_advance`` kernel
(``csrc/wired_advance.cu``, :mod:`tpudes_torch.parallel.wired_cuda`),
which updates the carry's tensors in place (the reference donates its
carry).  On the CPU it is the plain :func:`advance_math`, a sparse form:
each packet's current local link, a packed ``(ready << 32) | pid`` key,
and ``scatter_reduce(..., "amin")`` over the links for the FIFO heads (not
the reference's dense ``(Lo, P)`` one-hot).

The replica axis is not padded to a power of two (the reference's
bucket): replica ``r``'s phases are ``randint(fold_in(fold_in(key, r),
f), 0, jitter + 1)`` and rows never interact, so the real rows equal the
reference's.

:func:`run_wired` runs on :mod:`tpudes_torch.parallel.runtime`: its
tables sit in the runner cache (keyed by value, as the reference's
:func:`wired_cache_key`), the replica axis is padded to its power-of-two
bucket (rows never interact, so the real rows cannot move), its windows
go through ``drive_chunks``, and ``block=False`` returns an
:class:`~tpudes_torch.parallel.runtime.EngineFuture`; like the
reference's, it takes no ``checkpoint=``.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``mesh=`` (A12), ``TpudesObs`` / ``obs=True`` (A10).  The host DES
oracle ``run_wired_host`` runs on the JAX package's simulator core and is
not ported (A16); the tests call the reference's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tpudes_torch.device import resolve_device, to_device
from tpudes_torch.parallel.runtime import (
    RUNTIME,
    EngineFuture,
    _not_ported,
    bucket_replicas,
    chunk_bounds,
    drive_chunks,
)
from tpudes_torch.random import wired_jitter

__all__ = [
    "INF_SLOT",
    "WIRED_PKT_BYTES",
    "UnliftableWiredError",
    "WiredProgram",
    "advance_math",
    "build_wired_advance",
    "build_wired_space_advance",
    "next_of_math",
    "packet_table",
    "partition_flows",
    "partition_lookahead",
    "run_wired",
    "wired_cache_key",
    "wired_chain",
    "wired_step_math",
    "wired_tables",
    "wired_weak_chain",
]

#: "no event" (``wired.py:73``): far beyond any horizon, small enough
#: that ``INF_SLOT + service + delay`` never overflows int32
INF_SLOT = 1 << 30
#: nominal wire bytes a packet (``wired.py:79``)
WIRED_PKT_BYTES = 1000
#: ``lo_at``'s codes (:func:`wired_tables`): a packet past its flow's
#: last hop; a packet at a link its lane does not serve
LO_DELIVERED, LO_PEER = -1, -2
#: the order key of a packet that waits nowhere
_INF_KEY = torch.iinfo(torch.int64).max
#: the state's arrays: (name, axis after the rows: "p" packets, "l" local
#: links)
WIRED_STATE = (("hop", "p"), ("ready", "p"), ("free", "l"),
               ("deliver", "p"), ("eg_hop", "p"), ("eg_ready", "p"),
               ("served", "l"))


class UnliftableWiredError(ValueError):
    """The wired program is malformed for the slot model (bad path,
    non-positive service period, negative delay)."""


@dataclass(frozen=True)
class WiredProgram:
    """Static description of one wired-graph scenario
    (``wired.py:88-141``), the same fields and checks.  ``link_owner``
    maps each link to the PDES rank that serves it (all zeros: one
    partition); plain :func:`run_wired` serves every link."""

    n_links: int
    service_slots: np.ndarray     # (L,) int32, >= 1
    delay_slots: np.ndarray       # (L,) int32, >= 1
    paths: np.ndarray             # (F, H) int32 link ids, -1 padded
    start_slot: np.ndarray        # (F,) int32 first packet's arrival
    period_slots: np.ndarray      # (F,) int32 CBR period, >= 1
    n_pkts: np.ndarray            # (F,) int32 per-flow packet budget
    n_slots: int                  # simulation horizon in slots
    slot_s: float = 1e-3          # one slot in seconds (reporting only)
    jitter_slots: int = 0         # per-replica CBR phase jitter amplitude
    link_owner: np.ndarray = None  # (L,) int32 rank per link

    def __post_init__(self):
        owner = self.link_owner
        if owner is None:
            owner = np.zeros(self.n_links, np.int32)
            object.__setattr__(self, "link_owner", owner)
        svc = np.asarray(self.service_slots)
        if svc.shape != (self.n_links,) or (svc < 1).any():
            raise UnliftableWiredError(
                "service_slots must be (L,) with every period >= 1 "
                f"(got {svc!r}) — a zero-service link has no slot-model "
                "serialization time"
            )
        if (np.asarray(self.delay_slots) < 1).any():
            raise UnliftableWiredError(
                "delay_slots must be >= 1: a zero-delay hop would make "
                "same-slot arrival order depend on event insertion order "
                "(the device kernel's FIFO is the global (arrival, id) "
                "order over the whole slot)"
            )
        paths = np.asarray(self.paths)
        if ((paths >= self.n_links)).any():
            raise UnliftableWiredError("path names a link id >= n_links")
        if (np.asarray(self.period_slots) < 1).any():
            raise UnliftableWiredError("period_slots must be >= 1")

    @property
    def n_flows(self) -> int:
        return int(np.asarray(self.paths).shape[0])

    @property
    def n_ranks(self) -> int:
        return int(np.asarray(self.link_owner).max()) + 1


def wired_chain(n_links: int = 6, n_flows: int = 3, *, service=None,
                delay=None, period: int = 5, n_pkts: int = 0,
                n_slots: int = 600, ranks: int = 1, boundary_delay: int = 8,
                jitter_slots: int = 0) -> WiredProgram:
    """The reference's chain (``wired.py:167``): ``n_links`` in
    series, flow ``f`` entering at link ``f % (n_links - 1)`` and running
    to the end of the chain; ``ranks`` equal contiguous partitions, each
    boundary link's delay raised to ``boundary_delay``; ``n_pkts=0`` fills
    the horizon."""
    L = int(n_links)
    svc = np.array(
        service if service is not None else [1 + (i % 2) for i in range(L)],
        np.int32,
    )
    dly = np.array(
        delay if delay is not None else [2 + (i % 3) for i in range(L)],
        np.int32,
    )
    owner = np.minimum(np.arange(L) * ranks // L, ranks - 1).astype(np.int32)
    for i in range(L - 1):
        if owner[i] != owner[i + 1]:
            dly[i] = max(dly[i], boundary_delay)
    F = int(n_flows)
    paths = np.full((F, L), -1, np.int32)
    starts, periods, budgets = [], [], []
    for f in range(F):
        first = f % max(L - 1, 1)
        hops = list(range(first, L))
        paths[f, : len(hops)] = hops
        starts.append(1 + 3 * f)
        periods.append(int(period) + f)
        budgets.append(
            int(n_pkts) if n_pkts else max(1, int(n_slots) // (period + f))
        )
    return WiredProgram(
        n_links=L, service_slots=svc, delay_slots=dly, paths=paths,
        start_slot=np.asarray(starts, np.int32),
        period_slots=np.asarray(periods, np.int32),
        n_pkts=np.asarray(budgets, np.int32), n_slots=int(n_slots),
        jitter_slots=int(jitter_slots), link_owner=owner,
    )


def wired_weak_chain(ranks: int, links_per_rank: int = 4,
                     flows_per_rank: int = 3, *, period: int = 41,
                     cross_period: int = 257, n_slots: int = 3000,
                     boundary_delay: int = 240,
                     jitter_slots: int = 0) -> WiredProgram:
    """The reference's weak-scaling chain (``wired.py:230``): each rank
    owns ``links_per_rank`` links carrying ``flows_per_rank`` rank-local
    flows, every block alike, plus one thin cross flow over the whole
    chain; uniform partitions by construction."""
    K, lpr, fpr = int(ranks), int(links_per_rank), int(flows_per_rank)
    L = K * lpr
    svc = np.asarray([1 + ((i % lpr) % 2) for i in range(L)], np.int32)
    dly = np.asarray([2 + ((i % lpr) % 3) for i in range(L)], np.int32)
    owner = (np.arange(L) // lpr).astype(np.int32)
    for i in range(L - 1):
        if owner[i] != owner[i + 1]:
            dly[i] = max(dly[i], int(boundary_delay))
    F = K * fpr + 1
    paths = np.full((F, L), -1, np.int32)
    starts, periods, budgets = [], [], []
    f = 0
    for r in range(K):
        for i in range(fpr):
            first = r * lpr + (i % max(lpr - 1, 1))
            hops = list(range(first, (r + 1) * lpr))
            paths[f, : len(hops)] = hops
            starts.append(1 + 3 * i)
            periods.append(int(period) + 4 * i)
            budgets.append(max(1, int(n_slots) // (int(period) + 4 * i)))
            f += 1
    paths[f, :L] = np.arange(L)
    starts.append(2)
    periods.append(int(cross_period))
    budgets.append(max(1, int(n_slots) // int(cross_period)))
    return WiredProgram(
        n_links=L, service_slots=svc, delay_slots=dly, paths=paths,
        start_slot=np.asarray(starts, np.int32),
        period_slots=np.asarray(periods, np.int32),
        n_pkts=np.asarray(budgets, np.int32), n_slots=int(n_slots),
        jitter_slots=int(jitter_slots), link_owner=owner,
    )


def partition_flows(prog: WiredProgram, rank: int):
    """``rank``'s flow-granular resident set (``wired.py:305``): ``(sub,
    flow_ids, pkt_ids)``, the sub-program of the flows whose path touches
    a link the rank owns, their global flow ids and the global ids of
    their packets (both strictly increasing, since packet ids are
    flow-major)."""
    owner = np.asarray(prog.link_owner)
    paths = np.asarray(prog.paths)
    keep = [
        f for f in range(prog.n_flows)
        if (owner[paths[f][paths[f] >= 0]] == rank).any()
    ]
    if not keep:
        raise UnliftableWiredError(
            f"rank {rank} owns links touched by no flow — an idle "
            "partition has no resident traffic to simulate"
        )
    keep_np = np.asarray(keep, np.int32)
    offs = np.concatenate(([0], np.cumsum(np.asarray(prog.n_pkts,
                                                     np.int64))))
    pkt_ids = np.concatenate(
        [np.arange(offs[f], offs[f + 1]) for f in keep]
    ).astype(np.int32)
    sub = dataclasses.replace(
        prog,
        paths=paths[keep_np],
        start_slot=np.asarray(prog.start_slot)[keep_np],
        period_slots=np.asarray(prog.period_slots)[keep_np],
        n_pkts=np.asarray(prog.n_pkts)[keep_np],
    )
    return sub, keep_np, pkt_ids


def packet_table(prog: WiredProgram):
    """``(pkt_flow, pkt_birth, pkt_nhops)``, each ``(P,)`` int32
    (``wired.py:343``); packet ids are flow-major."""
    paths = np.asarray(prog.paths)
    counts = np.asarray(prog.n_pkts, np.int64)
    flows = np.repeat(np.arange(prog.n_flows, dtype=np.int32), counts)
    k = np.arange(flows.size) - np.repeat(
        np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
    births = (np.asarray(prog.start_slot, np.int64)[flows]
              + k * np.asarray(prog.period_slots, np.int64)[flows])
    nhops = (paths >= 0).sum(axis=1).astype(np.int32)[flows]
    return flows, births.astype(np.int32), nhops


def partition_lookahead(prog: WiredProgram, rank: int) -> int:
    """``rank``'s conservative lookahead (``wired.py:363``): the least
    ``service + delay`` over its boundary links (owned links whose
    successor on some path is owned elsewhere); ``INF_SLOT`` when it never
    sends.  Raises on a boundary link whose lookahead is not positive."""
    owner = np.asarray(prog.link_owner)
    svc = np.asarray(prog.service_slots)
    dly = np.asarray(prog.delay_slots)
    paths = np.asarray(prog.paths)
    look = INF_SLOT
    for f in range(prog.n_flows):
        hops = paths[f][paths[f] >= 0]
        for a, b in zip(hops[:-1], hops[1:]):
            if owner[a] == rank and owner[b] != rank:
                la = int(svc[a]) + int(dly[a])
                if la < 1:
                    raise UnliftableWiredError(
                        f"boundary link {int(a)} (flow {f}, toward rank "
                        f"{int(owner[b])}) has service+delay={la} <= 0: "
                        "zero lookahead degenerates the granted-time "
                        "window to no progress"
                    )
                look = min(look, la)
    return look


def _wired_unpack(host: dict, prog: WiredProgram, replicas: int) -> dict:
    """The result dict from the numpy ``deliver`` ``(R, P)`` and ``served``
    ``(R, L)`` (``wired.py:1026``): ``deliver_slot``, ``delivered`` (R, F;
    ``host["delivered"]`` where the caller counted them) and
    ``served``."""
    R = int(replicas)
    deliver = np.asarray(host["deliver"])[:R]
    delivered = host.get("delivered")
    if delivered is None:
        delivered = _delivered(torch.from_numpy(deliver), prog).numpy()
    return dict(deliver_slot=deliver, delivered=np.asarray(delivered)[:R],
                served=np.asarray(host["served"])[:R])


def _pkt_offsets(prog: WiredProgram, device) -> torch.Tensor:
    """``(F + 1,)`` int64 first packet id of each flow, then P."""
    return torch.as_tensor(np.concatenate(([0], np.cumsum(np.asarray(
        prog.n_pkts, np.int64)))), device=device)


def _delivered(deliver: torch.Tensor, prog: WiredProgram,
               offs: torch.Tensor | None = None) -> torch.Tensor:
    """``(R, F)`` int32 deliveries a flow from ``(R, P)`` deliver slots, on
    their device: packet ids are flow-major, so a flow's count is the
    difference of the running count at its first packet and past its
    last (``offs``, :func:`_pkt_offsets`, where the caller has them)."""
    if offs is None:
        offs = _pkt_offsets(prog, deliver.device)
    run = torch.cumsum((deliver >= 0).to(torch.int32), 1, dtype=torch.int32)
    run = torch.cat([torch.zeros_like(run[:, :1]), run], 1)
    return run[:, offs[1:]] - run[:, offs[:-1]]


# --------------------------------------------------------------------------
# tables and the plain version


def wired_tables(prog: WiredProgram, lanes, device=None) -> dict:
    """The constant tables of ``K = len(lanes)`` lanes, each ``(sub,
    owned, flow_ids)``: a (sub-)program of ``prog``'s flows, the ``(L,)``
    mask of the links the lane serves and the global ids of its flows.
    Every lane has the same P, F and owned-link count Lo (one lane always
    does).  Returns int32 tensors on ``device``: ``paths`` (K, F, H)
    global link ids, ``nhops`` (K, F), ``pkt_flow`` and ``pkt_birth`` (K,
    P), ``g2l`` (K, L) (a link's local row, -1 where the lane does not
    serve it), ``svc`` and ``svcdly`` (K, Lo) (each local link's service
    and service + delay), and ``lo_at`` (K, F, H + 1), derived from
    ``paths``, ``nhops`` and ``g2l``: the local link of flow f's hop h,
    :data:`LO_DELIVERED` at and past its hop count, :data:`LO_PEER` where
    the lane does not serve that link (int16 where Lo < 2^15, as the
    kernel reads it); and ``flow_ids`` (K, F) numpy, ``L``, ``H``."""
    dev = resolve_device(device)
    svc = np.asarray(prog.service_slots, np.int64)
    sd = svc + np.asarray(prog.delay_slots, np.int64)
    L = int(prog.n_links)
    cols = {k: [] for k in ("paths", "nhops", "pkt_flow", "pkt_birth",
                            "g2l", "svc", "svcdly", "lo_at")}
    fids = []
    for sub, owned, flow_ids in lanes:
        paths = np.asarray(sub.paths, np.int32)
        flow, birth, _ = packet_table(sub)
        own = (np.ones(L, bool) if owned is None
               else np.asarray(owned, bool))
        idx = np.nonzero(own)[0]
        g2l = np.full(L, -1, np.int32)
        g2l[idx] = np.arange(idx.size, dtype=np.int32)
        cols["paths"].append(paths)
        cols["nhops"].append((paths >= 0).sum(axis=1).astype(np.int32))
        cols["pkt_flow"].append(flow)
        cols["pkt_birth"].append(birth)
        cols["g2l"].append(g2l)
        cols["svc"].append(svc[idx].astype(np.int32))
        cols["svcdly"].append(sd[idx].astype(np.int32))
        cols["lo_at"].append(_lo_at(paths, g2l))
        fids.append(np.arange(sub.n_flows, dtype=np.int32)
                    if flow_ids is None else np.asarray(flow_ids, np.int32))
    for name, parts in cols.items():
        if len({p.shape for p in parts}) != 1:
            raise UnliftableWiredError(
                f"lanes of one launch need equal shapes; {name} has "
                f"{[p.shape for p in parts]}")
    tab = {k: torch.as_tensor(np.stack(v), device=dev).contiguous()
           for k, v in cols.items()}
    tab.update(flow_ids=np.stack(fids), L=L,
               H=int(np.asarray(prog.paths).shape[1]),
               flow_ids_t=torch.as_tensor(np.stack(fids).astype(np.int64),
                                          device=dev))
    return tab


def _lo_at(paths: np.ndarray, g2l: np.ndarray) -> np.ndarray:
    """``(F, H + 1)`` local link of each flow's hop, as :func:`_locate`
    and :func:`wired_step_math` find it: ``g2l[paths[f, h]]`` (a padded
    link read as link 0), :data:`LO_PEER` where that is -1, and
    :data:`LO_DELIVERED` from the flow's hop count on."""
    F, H = paths.shape
    nh = (paths >= 0).sum(axis=1)
    lo = g2l[np.maximum(paths, 0)]
    lo = np.where(lo >= 0, lo, LO_PEER)
    lo = np.where(np.arange(H)[None, :] < nh[:, None], lo, LO_DELIVERED)
    lo = np.concatenate([lo, np.full((F, 1), LO_DELIVERED)], axis=1)
    return lo.astype(np.int16 if g2l.max(initial=-1) < 2**15 - 1
                     else np.int32)


def _lane_rows(tab: dict, rows: int) -> torch.Tensor:
    """``(N,)`` lane of each of the ``N = K R`` state rows (lane-major)."""
    K = tab["paths"].shape[0]
    return torch.arange(K, device=tab["paths"].device).repeat_interleave(
        rows // K)


def _locate(tab: dict, lane: torch.Tensor, hop: torch.Tensor):
    """``(lo, flow, nh)`` of each packet of the ``(N, P)`` rows: its
    current local link (-1 where it is delivered or sits at a link the
    lane does not serve), its flow and its flow's hop count."""
    K, F, H = tab["paths"].shape
    ln = lane[:, None]
    flow = tab["pkt_flow"][lane].long()                      # (N, P)
    nh = tab["nhops"][ln, flow]
    on = (hop >= 0) & (hop < nh)
    link = tab["paths"][ln, flow, hop.clamp(0, H - 1).long()]
    lo = tab["g2l"][ln, link.clamp(min=0).long()]
    return torch.where(on, lo, -1), flow, nh


def next_of_math(tab: dict, lane, hop, ready, free) -> torch.Tensor:
    """``(N,)`` next interesting slot of each row (``wired.py:525``
    ``next_of``): the least ``max(ready, free[link])`` over its packets on
    owned links, ``INF_SLOT`` where there is none."""
    lo, _, _ = _locate(tab, lane, hop)
    f = free.gather(1, lo.clamp(min=0).long())
    m = torch.where(lo >= 0, torch.maximum(ready, f), INF_SLOT)
    return torch.cat([m, torch.full_like(m[:, :1], INF_SLOT)], 1).amin(1)


def wired_step_math(tab: dict, lane, s, active, st: dict) -> dict:
    """One step of every active row at its own slot ``s`` (``(N,)``
    int32), the reference's ``_make_lane_step.step`` (``wired.py:529``):
    each owned link that is free at ``s`` serves its FIFO head, the least
    ``(ready, pid)`` among its packets with ``ready <= s``; the packet is
    delivered, moves to its next owned link, or lands in the egress
    buffers.  ``st`` holds the ``(N, P)`` and ``(N, Lo)`` arrays of
    :data:`WIRED_STATE`; returns the new ones."""
    hop, ready, free = st["hop"], st["ready"], st["free"]
    N, P = hop.shape
    Lo = free.shape[1]
    H = tab["paths"].shape[2]
    ln = lane[:, None]
    lo, flow, nh = _locate(tab, lane, hop)
    wait = (lo >= 0) & (ready <= s[:, None]) & active[:, None]
    col = torch.where(wait, lo, Lo).long()
    pid = torch.arange(P, device=hop.device, dtype=torch.int64)
    key = torch.where(wait, (ready.long() << 32) | pid, _INF_KEY)
    head = torch.full((N, Lo + 1), _INF_KEY, dtype=torch.int64,
                      device=hop.device).scatter_reduce(1, col, key, "amin")
    lo0 = lo.clamp(min=0).long()
    serve = (wait & (key == head.gather(1, col))
             & (free.gather(1, lo0) <= s[:, None]))
    arr = s[:, None] + tab["svcdly"][ln, lo0]
    new_hop = hop + 1
    has_next = new_hop < nh
    nxt = tab["paths"][ln, flow, new_hop.clamp(max=H - 1).long()]
    next_owned = has_next & (tab["g2l"][ln, nxt.clamp(min=0).long()] >= 0)
    cross = serve & has_next & ~next_owned
    link_served = torch.zeros((N, Lo + 1), dtype=torch.bool,
                              device=hop.device).scatter_(
        1, torch.where(serve, lo, Lo).long(),
        torch.ones_like(serve))[:, :Lo]
    return dict(
        hop=torch.where(serve, new_hop, hop),
        ready=torch.where(serve, arr, ready),
        free=torch.where(link_served, s[:, None] + tab["svc"][lane], free),
        deliver=torch.where(serve & ~has_next, arr, st["deliver"]),
        eg_hop=torch.where(cross, new_hop, st["eg_hop"]),
        eg_ready=torch.where(cross, arr, st["eg_ready"]),
        served=st["served"] + link_served.to(torch.int32),
    )


def _rows(x: torch.Tensor) -> torch.Tensor:
    """A state array as ``(N, ...)`` rows (a lane axis, if any, folded
    into the replicas)."""
    return x.reshape(-1, x.shape[-1])


def advance_math(tab: dict, carry: dict, t_grant: int) -> tuple:
    """The plain ``advance`` (``wired.py:700-836``) over the carry's rows
    (``(R, P)`` arrays, or ``(K, R, P)`` for K lanes), its ingress already
    written into ``hop`` and ``ready`` (:func:`build_wired_advance`'s
    ``advance`` does that): the egress buffers are cleared, then each row
    steps its own clock through its events below ``t_grant``.  Returns
    ``(carry, metrics)``: a new carry, ``metrics["next_event"]`` the least next
    event over each lane's rows (``(K,)`` int32; a scalar tensor for a
    carry without a lane axis) and ``metrics["n_steps"]`` the most steps
    a row took."""
    shape = carry["hop"].shape
    st = {k: _rows(carry[k]) for k, _ in WIRED_STATE}
    N = st["hop"].shape[0]
    lane = _lane_rows(tab, N)
    st["eg_hop"] = torch.full_like(st["hop"], -1)
    st["eg_ready"] = torch.full_like(st["hop"], -1)
    t0, t_grant = int(carry["t"]), int(t_grant)
    steps = torch.zeros(N, dtype=torch.int32, device=st["hop"].device)
    if t0 < t_grant:
        s = torch.clamp_min(next_of_math(tab, lane, st["hop"], st["ready"],
                                         st["free"]), t0)
        active = s < t_grant
        while bool(active.any()):
            st = wired_step_math(tab, lane, s, active, st)
            steps += active.to(torch.int32)
            nxt = next_of_math(tab, lane, st["hop"], st["ready"], st["free"])
            s = torch.where(active, torch.maximum(s + 1, nxt), s)
            active = s < t_grant
    nxt = next_of_math(tab, lane, st["hop"], st["ready"], st["free"])
    K = tab["paths"].shape[0]
    next_event = nxt.view(K, -1).amin(1)
    out = {k: st[k].reshape(*shape[:-1], st[k].shape[-1])
           for k, _ in WIRED_STATE}
    out["t"] = max(t0, t_grant)
    return out, dict(next_event=next_event if len(shape) == 3
                     else next_event[0],
                     n_steps=steps.max() if N else torch.zeros((), dtype=
                                                              torch.int32))


# --------------------------------------------------------------------------
# the entries


def _init_rows(tab: dict, key, replicas: int, jitter: int,
               replica_offset: int = 0) -> dict:
    """The first carry of the tables' K lanes: ``(K, R, P)`` and ``(K, R,
    Lo)``; each lane's packets born at their CBR slot plus their flow's
    phase for each replica (:func:`tpudes_torch.random.wired_jitter`, by
    global replica index and global flow id)."""
    dev = tab["paths"].device
    K, P = tab["pkt_flow"].shape
    Lo = tab["svc"].shape[1]
    R = int(replicas)
    key = to_device(key if isinstance(key, torch.Tensor)
                    else np.asarray(key, np.int64), dev, torch.int64)
    ready = []
    for k in range(K):
        jit = wired_jitter(key, R, tab["flow_ids_t"][k], jitter,
                           replica_offset)
        ready.append(tab["pkt_birth"][k][None, :]
                     + jit[:, tab["pkt_flow"][k].long()])
    z = dict(dtype=torch.int32, device=dev)
    return dict(
        t=0,
        hop=torch.zeros((K, R, P), **z),
        ready=torch.stack(ready).to(torch.int32).contiguous(),
        free=torch.zeros((K, R, Lo), **z),
        deliver=torch.full((K, R, P), -1, **z),
        eg_hop=torch.full((K, R, P), -1, **z),
        eg_ready=torch.full((K, R, P), -1, **z),
        served=torch.zeros((K, R, Lo), **z),
    )


def _advance(tab: dict):
    """The reference's ``advance(carry, ing_hop, ing_ready, t_grant)``
    over ``tab``: the ingress entries ``>= 0`` overwrite their packets' hop
    and ready, then one ``advance_launch``."""
    def advance(carry, ing_hop, ing_ready, t_grant):
        from tpudes_torch.parallel.wired_cuda import advance_launch

        if ing_hop is not None:
            take = ing_hop >= 0
            carry = dict(carry, hop=torch.where(take, ing_hop, carry["hop"]),
                         ready=torch.where(take, ing_ready, carry["ready"]))
        return advance_launch(tab, carry, t_grant)

    return advance


def build_wired_advance(prog: WiredProgram, replicas: int, owned=None,
                        flow_ids=None, obs: bool = False, device=None,
                        tab: dict | None = None):
    """``(init_state, advance)`` of the windowed engine
    (``wired.py:578``).  ``owned`` is the ``(L,)`` mask of the links this
    engine serves (None: all); a packet at another link is a peer's.
    ``flow_ids`` are the global ids of ``prog``'s flows where ``prog`` is
    a resident subset (:func:`partition_flows`), so the phases match the
    whole program's.

    ``init_state(key, replica_offset=0)`` is the first carry, ``(R, P)``
    and ``(R, Lo)`` int32 tensors and ``t = 0`` (``key`` the run's ``(2,)``
    key words).  ``advance(carry, ing_hop, ing_ready, t_grant)`` applies
    the ingress (``(R, P)``, entries ``>= 0`` overwrite; None: none),
    clears the egress and serves below ``t_grant`` (:func:`advance_math`;
    on the card one ``wired_advance`` launch that updates the carry's
    tensors in place); returns ``(carry, metrics)`` with the scalar
    ``next_event`` and ``n_steps``.  ``obs=True`` (the ``TpudesObs``
    FlowMonitor columns) is not ported (A10).  ``tab`` is the lane's
    :func:`wired_tables` where the caller has them (the runner cache),
    else built here."""
    if obs:
        raise _not_ported("TpudesObs", "A10")
    if tab is None:
        tab = wired_tables(prog, [(prog, owned, flow_ids)], device)
    jitter = int(prog.jitter_slots)

    def init_state(key, replica_offset: int = 0):
        c = _init_rows(tab, key, replicas, jitter, replica_offset)
        return {k: (v[0] if k != "t" else v) for k, v in c.items()}

    return init_state, _advance(tab)


def uniform_partitions(prog: WiredProgram) -> list:
    """Every rank's ``(sub, flow_ids, pkt_ids)`` (:func:`partition_flows`)
    where all ranks have equal flow, packet and owned-link counts, as the
    lanes of one launch need; raises :class:`UnliftableWiredError` with
    the reference's text (``wired.py:841``) otherwise."""
    parts = [partition_flows(prog, r) for r in range(prog.n_ranks)]
    pkts = [int(ids.size) for _, _, ids in parts]
    owner = np.asarray(prog.link_owner)
    links = [int((owner == r).sum()) for r in range(prog.n_ranks)]
    flows = [p[0].n_flows for p in parts]
    if len(set(pkts)) != 1 or len(set(links)) != 1 or len(set(flows)) != 1:
        raise UnliftableWiredError(
            "space-batched lanes need uniform partitions (equal per-rank"
            " flow/packet/owned-link counts); partitions here are "
            f"flows={flows} pkts={pkts} links={links} — use "
            "transport='local'/'mpi', which allow ragged partitions"
        )
    return parts


def build_wired_space_advance(prog: WiredProgram, replicas: int,
                              device=None):
    """All K partitions of ``prog`` as lanes of one launch
    (``wired.py:841``): ``(init_state, advance, parts)`` with a leading
    rank axis on every array — ``(K, R, P)`` and ``(K, R, Lo)`` — and
    ``next_event`` per lane ``(K,)``.  Needs uniform partitions (equal
    per-rank flow, packet and owned-link counts) and raises
    :class:`UnliftableWiredError` otherwise.  ``parts`` is the per-rank
    ``(sub, flow_ids, pkt_ids)`` list (:func:`partition_flows`)."""
    parts = uniform_partitions(prog)
    owner = np.asarray(prog.link_owner)
    tab = wired_tables(prog, [(sub, owner == k, fids)
                              for k, (sub, fids, _) in enumerate(parts)],
                       device)
    jitter = int(prog.jitter_slots)

    def init_state(key):
        return _init_rows(tab, key, replicas, jitter)

    return init_state, _advance(tab), parts


def wired_cache_key(prog: WiredProgram, keep_owner: bool = False) -> tuple:
    """Hashable identity of the fields that shape a run's tables
    (``wired.py:1001``): ``n_slots`` (the grant is a launch's operand)
    and ``slot_s`` (reporting only) are absent, and so is ``link_owner``
    unless ``keep_owner`` (only the space-lanes engine derives its lanes
    from it; the others get their served links as an explicit mask)."""
    skip = {"n_slots", "slot_s"}
    if not keep_owner:
        skip.add("link_owner")
    return tuple(
        v.tobytes() if isinstance(v, np.ndarray) else v
        for k, v in prog.__dict__.items()
        if k not in skip
    )


def run_wired(prog: WiredProgram, key, replicas: int = 1, mesh=None, *,
              window_slots: int | None = None, replica_offset: int = 0,
              block: bool = True, obs: bool = False, device=None):
    """Run ``replicas`` replicas of ``prog`` (``wired.py:1045``): a dict
    of numpy arrays, ``deliver_slot`` ``(R, P)`` (-1: not delivered),
    ``delivered`` ``(R, F)`` and ``served`` ``(R, L)``.

    ``window_slots=N`` runs the horizon as N-slot advances, carrying the
    state: the same result bit for bit.  ``replica_offset`` shifts the
    replicas' phase indices, so ``replicas=k, replica_offset=p k`` gives
    rows ``[p k, (p + 1) k)`` of one large run.  ``key`` is the run's
    ``(2,)`` key words.  The replica axis is padded to its power-of-two
    bucket and the results sliced back; ``block=False`` returns an
    :class:`~tpudes_torch.parallel.runtime.EngineFuture`.  ``device``
    defaults to the card, where a window is one ``wired_advance``
    launch."""
    if mesh is not None:
        raise _not_ported("mesh", "A12")
    if obs:
        raise _not_ported("TpudesObs", "A10")
    dev = resolve_device(device)
    r_pad = bucket_replicas(replicas)
    cached, _ = RUNTIME.runner(
        "wired", wired_cache_key(prog) + (r_pad, False, str(dev)),
        lambda: dict(tab=wired_tables(prog, [(prog, None, None)], dev),
                     offs=_pkt_offsets(prog, dev)))
    init_state, advance = build_wired_advance(prog, r_pad, device=dev,
                                              tab=cached["tab"])
    carry, _ = drive_chunks(
        "wired", chunk_bounds(prog.n_slots, window_slots or prog.n_slots),
        init_state(key, replica_offset),
        lambda c, bound: advance(c, None, None, bound)[0])
    fut = EngineFuture(
        "wired", dict(deliver=carry["deliver"], served=carry["served"],
                      delivered=_delivered(carry["deliver"], prog,
                                           cached["offs"])),
        lambda host: _wired_unpack(host, prog, replicas))
    return fut.result() if block else fut
