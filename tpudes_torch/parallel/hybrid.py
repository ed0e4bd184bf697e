"""The hybrid space x replica PDES on the card: device-engine ranks.

Counterpart of ``tpudes/parallel/hybrid.py``: the conservative
granted-time-window protocol, each rank a device engine over its
partition of a :class:`~tpudes_torch.parallel.wired.WiredProgram` (a set
of links) that advances all R replicas up to each grant.  At a window's
edge a rank reads its boundary traffic out of the egress buffers, the
traffic goes to the ranks that own its next links, and it enters their
next window as ingress, scattered straight into their carry.  A round,
as in the reference:

1. every rank's egress and next event are read (one copy a rank: the
   egress entries are gathered on the card first, ``torch.nonzero`` and
   one small copy, not the whole ``(R, P)`` buffers);
2. each rank's candidate is its next event (or an earlier just-received
   arrival) plus its lookahead, the least ``service + delay`` over its
   boundary links; the grant is the least candidate;
3. every rank advances strictly below the grant (all of them to the
   horizon once the grant is infinite).

One engine, :class:`HybridLanes`, holds ranks as the lanes of one
``wired_advance`` launch, and one loop runs the rounds over engines.
Transports: ``"local"``, every rank an engine of one lane
(:class:`HybridRank`), a launch a rank each window, and ``"batched"``,
one engine of all ranks (:class:`SpaceLanesHybrid`, uniform partitions
only), a launch a window.  The results are merged as the reference merges
them (``np.maximum`` of ``deliver``, the sum of ``served``) and equal
``run_wired``'s bit for bit.

An engine's tables sit in the runner cache of :mod:`tpudes_torch.
parallel.runtime` (a rank's keyed as the reference's ``HybridRank``,
``hybrid.py:161``: its sub-program, replica bucket, owned links and flow
ids; the space lanes' by the whole program with its ownership map), its
replica axis is padded to its power-of-two bucket (the padded rows join
the grant, as the reference's do, so ``windows`` counts as the
reference's), and each window's launch is counted under
``wired_hybrid`` or ``wired_space``.  ``telemetry=True`` records every
rank's window in :class:`~tpudes_torch.obs.distributed.
DistributedTelemetry` (``hybrid.py:556-759``).

Not ported yet (raises ``NotImplementedError`` naming its ROADMAP item):
``transport="mpi"``, one process a rank over ``LaunchDistributed`` and
``MpiInterface`` (A12, on ``torch.distributed``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpudes_torch.device import resolve_device
from tpudes_torch.parallel import wired_cuda
from tpudes_torch.obs.device import CompileTelemetry
from tpudes_torch.obs.distributed import wall_now
from tpudes_torch.parallel.runtime import RUNTIME, _not_ported, bucket_replicas
from tpudes_torch.parallel.wired import (
    INF_SLOT,
    WiredProgram,
    _init_rows,
    _wired_unpack,
    packet_table,
    partition_flows,
    partition_lookahead,
    uniform_partitions,
    wired_cache_key,
    wired_tables,
)

__all__ = ["HybridLanes", "HybridRank", "SpaceLanesHybrid", "run_hybrid"]


def _demux_egress(rs, ps, hops, readys, paths, pkt_flow, pkt_ids,
                  link_owner) -> dict:
    """One lane's egress entries (replica ``rs``, local packet ``ps``, its
    next ``hops`` and arrival ``readys``, as :func:`_egress_entries`
    gathers them) → ``outbox[dst_rank] = dict(r, p, hop, ready)``, ``p``
    the global packet id (``pkt_ids`` maps local rows out; None:
    identity); ``hybrid.py:94`` on the entries rather than the dense
    buffers."""
    outbox: dict[int, dict] = {}
    if rs.size:
        links = paths[pkt_flow[ps], hops]
        dsts = link_owner[links]
        gp = ps if pkt_ids is None else pkt_ids[ps]
        for dst in np.unique(dsts):
            m = dsts == dst
            outbox[int(dst)] = dict(
                r=rs[m].astype(np.int32),
                p=gp[m].astype(np.int32),
                hop=hops[m].astype(np.int32),
                ready=readys[m].astype(np.int32),
            )
    return outbox


def _egress_entries(eg_hop, eg_ready, next_event) -> tuple:
    """The egress entries of ``(..., R, P)`` buffers on the card, gathered
    there and copied back once with the next events: ``(idx, hops,
    readys, next_events)``, ``idx`` the ``(n, ndim)`` indices."""
    idx = torch.nonzero(eg_hop >= 0)
    flat = idx.t().unbind()
    packed = torch.cat([
        idx.to(torch.int64).reshape(-1), eg_hop[flat].to(torch.int64),
        eg_ready[flat].to(torch.int64),
        next_event.reshape(-1).to(torch.int64)]).cpu().numpy()
    n, d = idx.shape
    return (packed[:n * d].reshape(n, d), packed[n * d:n * d + n],
            packed[n * d + n:n * d + 2 * n], packed[n * d + 2 * n:])


def _inject_inbox(carry: dict, k: int, inbox: list, g2l, who: str) -> None:
    """Write the received payloads straight into lane ``k`` of the carry's
    ``(K, R, P)`` ``hop`` and ``ready`` (``hybrid.py:119``, without the
    reference's dense ingress tensors: each payload's few entries are
    copied to the carry's device and scattered there); ``g2l`` maps a
    global packet id to its resident row (None: identity).  A packet
    outside the resident set raises."""
    for payload in inbox:
        if not payload["p"].size:
            continue
        lp = payload["p"] if g2l is None else g2l[payload["p"]]
        if (lp < 0).any():
            raise RuntimeError(
                f"peer injected a packet outside {who}'s resident "
                "flow set — partition maps disagree"
            )
        e = torch.as_tensor(np.stack([payload["r"], lp, payload["hop"],
                                      payload["ready"]]).astype(np.int64),
                            device=carry["hop"].device)
        carry["hop"][k, e[0], e[1]] = e[2].to(torch.int32)
        carry["ready"][k, e[0], e[1]] = e[3].to(torch.int32)


def _scatter_results(deliver, served, pkt_ids, owned_mask, n_total_pkts,
                     n_links):
    """One lane's ``(R, P_loc)`` deliver and ``(R, Lo)`` served scattered
    back to global packet and link ids (``hybrid.py:135``)."""
    if pkt_ids is not None:
        full = np.full((deliver.shape[0], n_total_pkts), -1, np.int32)
        full[:, pkt_ids] = deliver
        deliver = full
    g_served = np.zeros((served.shape[0], n_links), np.int32)
    g_served[:, np.nonzero(owned_mask)[0]] = served
    return deliver, g_served


def _g2l(pkt_ids, n_total: int):
    m = np.full(n_total, -1, np.int32)
    m[pkt_ids] = np.arange(pkt_ids.size, dtype=np.int32)
    return m


def _candidate(next_event: int, inbox: list, lookahead: int) -> int:
    """A rank's grant candidate after the flush (``hybrid.py:260``)."""
    c = next_event
    for payload in inbox:
        if payload["ready"].size:
            c = min(c, int(payload["ready"].min()))
    if c >= INF_SLOT or lookahead >= INF_SLOT:
        return INF_SLOT
    return min(c + lookahead, INF_SLOT)


class HybridLanes:
    """PDES ranks as the lanes of one engine: lane ``k`` is rank
    ``ranks[k]``'s owned links and resident flows
    (:func:`~tpudes_torch.parallel.wired.partition_flows`; all links and
    flows where ``size`` is 1), and every window advances all lanes by
    one ``wired_advance`` launch.  One lane is the reference's
    ``HybridRank`` (``hybrid.py:149``), all K lanes its
    ``SpaceLanesHybrid`` (``:312``).  Per round: ``poll()`` → exchange →
    :func:`_candidate` per lane → grant → ``window()``.  The carry is
    ``(K, R, P)`` and ``(K, R, Lo)``; the constructor runs the priming
    advance to ``t = 0`` (the first next events, nothing served)."""

    def __init__(self, prog: WiredProgram, key, replicas: int, ranks,
                 size: int, device=None):
        owner = np.asarray(prog.link_owner)
        self.prog, self.size = prog, int(size)
        self.ranks = [int(r) for r in ranks]
        if self.size > 1 and owner.max() >= self.size:
            raise ValueError(
                f"link_owner names rank {int(owner.max())} but only "
                f"{self.size} ranks are launched"
            )
        if self.size > 1:
            parts = [partition_flows(prog, r) for r in self.ranks]
            self.owned = [owner == r for r in self.ranks]
            self.lookaheads = [partition_lookahead(prog, r)
                               for r in self.ranks]
        else:
            parts = [(prog, None, None)]
            self.owned = [owner >= 0]
            self.lookaheads = [INF_SLOT]
        self.link_owner = owner
        self.n_total_pkts = int(np.asarray(prog.n_pkts).sum())
        self.pkt_ids = [ids for _, _, ids in parts]
        self._g2l = [None if ids is None else _g2l(ids, self.n_total_pkts)
                     for ids in self.pkt_ids]
        self._pkt_flow = [packet_table(sub)[0] for sub, _, _ in parts]
        self._paths = [np.asarray(sub.paths) for sub, _, _ in parts]
        dev = resolve_device(device)
        r_pad = bucket_replicas(replicas)
        lanes = [(sub, own, fids)
                 for (sub, fids, _), own in zip(parts, self.owned)]
        if len(lanes) == 1:
            sub, own, fids = lanes[0]
            fids = (np.arange(sub.n_flows, dtype=np.int32) if fids is None
                    else np.asarray(fids, np.int32))
            self.engine = "wired_hybrid"
            key_ = wired_cache_key(sub) + (r_pad, np.asarray(own).tobytes(),
                                           fids.tobytes(), str(dev))
        else:
            self.engine = "wired_space"
            key_ = wired_cache_key(prog, keep_owner=True) + (
                r_pad, "space", tuple(self.ranks), self.size, str(dev))
        t_miss = wall_now()
        self.tab, compiling = RUNTIME.runner(
            self.engine, key_, lambda: wired_tables(prog, lanes, dev))
        self.t_now = self.windows = 0
        self.carry = _init_rows(self.tab, key, r_pad,
                                int(prog.jitter_slots))
        # the priming advance to t = 0 (its miss timed as the reference's,
        # ``hybrid.py:233``, ``:448``)
        with CompileTelemetry.timed(self.engine, compiling, t_miss):
            self._launch(0)

    def _launch(self, t_grant: int) -> None:
        self.carry, self._metrics = wired_cuda.advance_launch(
            self.tab, self.carry, t_grant)
        RUNTIME.record_launch(self.engine)

    def poll(self) -> list:
        """Every lane's ``(outbox, next_event)`` after the last window,
        one copy back for all lanes; ``outbox[dst_rank] = dict(r, p, hop,
        ready)``."""
        idx, hops, readys, nxt = _egress_entries(
            self.carry["eg_hop"], self.carry["eg_ready"],
            self._metrics["next_event"])
        polled = []
        for k in range(len(self.ranks)):
            m = idx[:, 0] == k
            polled.append((_demux_egress(
                idx[m, 1], idx[m, 2], hops[m], readys[m], self._paths[k],
                self._pkt_flow[k], self.pkt_ids[k], self.link_owner),
                int(nxt[k])))
        return polled

    def window(self, inboxes: list, t_grant: int) -> None:
        """Write each lane's received traffic into the carry and advance
        all lanes to ``t_grant`` (clipped to the horizon)."""
        for k, inbox in enumerate(inboxes):
            _inject_inbox(self.carry, k, inbox, self._g2l[k],
                          f"rank {self.ranks[k]}")
        g = min(int(t_grant), self.prog.n_slots)
        self._launch(g)
        self.t_now = g
        self.windows += 1

    def results(self) -> list:
        """Each lane's outcome scattered back to global packet and link
        ids (the padded replicas' rows too), with the windows run."""
        deliver = self.carry["deliver"].cpu().numpy()
        served = self.carry["served"].cpu().numpy()
        outs = []
        for k in range(len(self.ranks)):
            d, s = _scatter_results(deliver[k], served[k], self.pkt_ids[k],
                                    self.owned[k], self.n_total_pkts,
                                    self.prog.n_links)
            outs.append(dict(deliver=d, served=s, windows=self.windows))
        return outs


class HybridRank(HybridLanes):
    """One PDES rank (``hybrid.py:149``): an engine of one lane."""

    def __init__(self, prog: WiredProgram, key, replicas: int, rank: int,
                 size: int, device=None):
        super().__init__(prog, key, replicas, [rank], size, device)


class SpaceLanesHybrid(HybridLanes):
    """All ranks as the lanes of one launch (``hybrid.py:312``); needs
    uniform partitions (:func:`~tpudes_torch.parallel.wired.
    uniform_partitions` raises otherwise)."""

    def __init__(self, prog: WiredProgram, key, replicas: int, device=None):
        uniform_partitions(prog)
        super().__init__(prog, key, replicas, range(prog.n_ranks),
                         prog.n_ranks, device)


def _bound_grant(g: int, t_now: int, window_slots: int | None) -> int:
    """Clamp a grant to ``window_slots`` past the clock
    (``hybrid.py:596``): the window schedule changes, never the
    results."""
    if window_slots:
        return min(g, t_now + int(window_slots))
    return g


def _pkts(payloads) -> int:
    """Boundary packets in a list of payloads (each ``dict(r, p, hop,
    ready)``)."""
    return sum(int(np.asarray(p["p"]).size) for p in payloads)


def _run_windows(engines: list, prog: WiredProgram,
                 window_slots: int | None, telemetry: bool = False) -> list:
    """The granted-window rounds over ``engines`` (their lanes the ranks
    in order) until the horizon (``hybrid.py:551``, ``:653``); each
    rank's results.  ``telemetry`` records each rank's window in
    :class:`~tpudes_torch.obs.distributed.DistributedTelemetry` as the
    reference's drivers do (``hybrid.py:556-601``, ``:653-690``): one
    engine a rank (``"local"``) times each rank's advance; the lanes of
    one engine (``"batched"``) give rank 0 the round's poll, grant and
    advance walls."""
    from tpudes_torch.obs.distributed import DistributedTelemetry

    while True:
        t0 = wall_now()
        polled = [lane for e in engines for lane in e.poll()]
        inboxes: list[list] = [[] for _ in polled]
        for outbox, _ in polled:
            for dst, payload in outbox.items():
                inboxes[dst].append(payload)
        t1 = wall_now()
        lookaheads = [la for e in engines for la in e.lookaheads]
        grant = min(_candidate(nx, inbox, la) for (_, nx), inbox, la
                    in zip(polled, inboxes, lookaheads))
        g = prog.n_slots if grant >= INF_SLOT else min(grant, prog.n_slots)
        t2 = wall_now()
        for e in engines:
            t_prev, ta = e.t_now, wall_now()
            e.window([inboxes[r] for r in e.ranks],
                     _bound_grant(g, e.t_now, window_slots))
            if not telemetry:
                continue
            tb = wall_now()
            lanes = len(e.ranks) > 1
            for i, r in enumerate(e.ranks):
                first = lanes and i == 0
                DistributedTelemetry.record_window(
                    r, grant_slots=max(0, e.t_now - t_prev),
                    tx_pkts=_pkts(polled[r][0].values()),
                    rx_pkts=_pkts(inboxes[r]),
                    poll_wall_s=t1 - t0 if first else 0.0,
                    flush_wall_s=0.0,
                    grant_wall_s=t2 - t1 if first else 0.0,
                    advance_wall_s=(tb - ta if first or not lanes
                                    else 0.0))
        if engines[0].t_now >= prog.n_slots:
            return [out for e in engines for out in e.results()]


def run_hybrid(prog: WiredProgram, key, replicas: int = 1, *,
               ranks: int | None = None, transport: str = "local",
               window_slots: int | None = None, telemetry: bool = False,
               device=None) -> dict:
    """Run ``prog`` space-partitioned over ``ranks`` PDES ranks (default:
    the partitions ``prog.link_owner`` declares), each advancing R
    replicas of its links (padded to the power-of-two bucket) by granted
    windows (``hybrid.py:763``); the merged result is ``run_wired``'s,
    with ``windows`` (the rounds run) and ``ranks``.  ``transport`` is
    ``"local"`` or ``"batched"``;
    ``window_slots`` bounds every grant (the schedule changes, the
    results do not).  ``key`` is the run's ``(2,)`` key words; ``device``
    defaults to the card.  ``telemetry=True`` records every rank's window
    (grant, boundary packets out and in, the phases' walls) in
    :class:`~tpudes_torch.obs.distributed.DistributedTelemetry`, as the
    reference's drivers always do.  Not ported: the ``"mpi"`` transport
    (A12)."""
    size = int(ranks) if ranks is not None else prog.n_ranks
    if transport == "local":
        engines = [HybridRank(prog, key, replicas, r, size, device)
                   for r in range(size)]
    elif transport == "batched":
        if size != prog.n_ranks:
            raise ValueError(
                f"transport='batched' runs the program's own partitioning "
                f"({prog.n_ranks} ranks); got ranks={size}"
            )
        engines = [SpaceLanesHybrid(prog, key, replicas, device)]
    elif transport == "mpi":
        raise _not_ported("transport='mpi' (LaunchDistributed and "
                          "MpiInterface on torch.distributed)", "A12")
    else:
        raise ValueError(f"unknown transport {transport!r}")
    rank_outs = _run_windows(engines, prog, window_slots, telemetry)
    deliver = rank_outs[0]["deliver"]
    served = rank_outs[0]["served"]
    for out in rank_outs[1:]:
        deliver = np.maximum(deliver, out["deliver"])
        served = served + out["served"]
    result = _wired_unpack(dict(deliver=deliver, served=served), prog,
                           replicas)
    result["windows"] = int(rank_outs[0]["windows"])
    result["ranks"] = size
    return result
