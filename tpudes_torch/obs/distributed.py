"""Distributed/hybrid PDES observability: the window protocol's metrics.

A copy of ``tpudes/obs/distributed.py`` (:class:`DistributedTelemetry`
``:43``, :func:`validate_distributed_metrics` ``:152``, :func:`wall_now`
``:31``).  ``tpudes_torch.parallel.hybrid.run_hybrid(telemetry=True)``
records one entry a granted window a rank: the grant in slots, the
boundary packets demuxed out of and injected into the device buffers,
and the wall time of each protocol phase (device poll, flush exchange,
grant reduction, window advance).  :meth:`DistributedTelemetry.absorb`
merges per-rank snapshots; :func:`validate_distributed_metrics` is the
schema gate (``python -m tpudes_torch.obs --distributed metrics.json``).
"""

from __future__ import annotations

import time

__all__ = [
    "DistributedTelemetry",
    "validate_distributed_metrics",
    "wall_now",
]


def wall_now() -> float:
    """Monotonic wall clock for the window drivers' phase telemetry: a
    wall-clock read is an observability concern, so the drivers take it
    from here, not from ``time`` (``distributed.py:31``)."""
    return time.monotonic()

_PHASES = ("poll", "flush", "grant", "advance")


class DistributedTelemetry:
    """Process-wide hybrid-PDES metrics registry (cumulative since
    reset)."""

    _ranks: dict[int, dict] = {}

    @classmethod
    def _rank(cls, rank: int) -> dict:
        return cls._ranks.setdefault(
            int(rank),
            {
                "windows": 0,
                "grant_slots_sum": 0,
                "grant_slots_max": 0,
                "tx_pkts": 0,
                "rx_pkts": 0,
                "transport_tx": 0,
                "transport_rx": 0,
                **{f"{p}_wall_s": 0.0 for p in _PHASES},
            },
        )

    @classmethod
    def record_window(
        cls,
        rank: int,
        *,
        grant_slots: int,
        tx_pkts: int,
        rx_pkts: int,
        poll_wall_s: float,
        flush_wall_s: float,
        grant_wall_s: float,
        advance_wall_s: float,
    ) -> None:
        r = cls._rank(rank)
        r["windows"] += 1
        r["grant_slots_sum"] += int(grant_slots)
        r["grant_slots_max"] = max(r["grant_slots_max"], int(grant_slots))
        r["tx_pkts"] += int(tx_pkts)
        r["rx_pkts"] += int(rx_pkts)
        r["poll_wall_s"] += float(poll_wall_s)
        r["flush_wall_s"] += float(flush_wall_s)
        r["grant_wall_s"] += float(grant_wall_s)
        r["advance_wall_s"] += float(advance_wall_s)

    @classmethod
    def record_transport(cls, rank: int, tx: int, rx: int) -> None:
        """Fold in ``MpiInterface``'s per-rank rx/tx frame counters."""
        r = cls._rank(rank)
        r["transport_tx"] += int(tx)
        r["transport_rx"] += int(rx)

    @classmethod
    def absorb(cls, snapshot: dict) -> None:
        """Merge a rank process's snapshot into this registry (the
        parent-side gather after a ``transport="mpi"`` launch)."""
        for rank, r in snapshot.get("ranks", {}).items():
            mine = cls._rank(int(rank))
            mine["windows"] += r["windows"]
            # the raw sum rides the snapshot so the merge is exact;
            # reconstructing from the 3-decimal rounded mean would
            # drift on long runs
            mine["grant_slots_sum"] += r["grant_slots_sum"]
            mine["grant_slots_max"] = max(
                mine["grant_slots_max"], r["grant_slots_max"]
            )
            for k in ("tx_pkts", "rx_pkts", "transport_tx", "transport_rx"):
                mine[k] += r[k]
            for p in _PHASES:
                mine[f"{p}_wall_s"] += r[f"{p}_wall_s"]

    # --- reading ----------------------------------------------------------

    @classmethod
    def snapshot(cls) -> dict:
        ranks = {}
        counters = {"windows": 0, "boundary_tx": 0, "boundary_rx": 0}
        for rank, r in sorted(cls._ranks.items()):
            wall = sum(r[f"{p}_wall_s"] for p in _PHASES)
            n = r["windows"]
            ranks[str(rank)] = {
                "windows": n,
                "wall_s": round(wall, 6),
                "windows_per_s": round(n / wall, 3) if wall > 0 else 0.0,
                "grant_slots_sum": r["grant_slots_sum"],
                "grant_slots_mean": (
                    round(r["grant_slots_sum"] / n, 3) if n else 0.0
                ),
                "grant_slots_max": r["grant_slots_max"],
                "tx_pkts": r["tx_pkts"],
                "rx_pkts": r["rx_pkts"],
                "transport_tx": r["transport_tx"],
                "transport_rx": r["transport_rx"],
                **{
                    f"{p}_wall_s": round(r[f"{p}_wall_s"], 6)
                    for p in _PHASES
                },
            }
            counters["windows"] += n
            counters["boundary_tx"] += r["tx_pkts"]
            counters["boundary_rx"] += r["rx_pkts"]
        return {"version": 1, "counters": counters, "ranks": ranks}

    @classmethod
    def reset(cls) -> None:
        cls._ranks = {}


def validate_distributed_metrics(doc) -> list[str]:
    """Schema check for a :meth:`DistributedTelemetry.snapshot`
    document (dependency-free, mirroring ``validate_serving_metrics``).
    Returns human-readable problems; empty means valid."""
    from tpudes_torch.obs.schema import make_need

    problems: list[str] = []
    need = make_need(problems)

    if not isinstance(doc, dict):
        return ["top level: not a JSON object"]
    if doc.get("version") != 1:
        problems.append("version: expected 1")
    counters = need(doc, "counters", dict, "top level")
    if counters is not None:
        for k in ("windows", "boundary_tx", "boundary_rx"):
            v = need(counters, k, int, "counters")
            if isinstance(v, int) and v < 0:
                problems.append(f"counters.{k}: negative")
    ranks = need(doc, "ranks", dict, "top level")
    if ranks is not None:
        for name, r in ranks.items():
            where = f"ranks.{name}"
            if not name.isdigit():
                problems.append(f"{where}: rank key is not an integer")
            windows = need(r, "windows", int, where)
            need(r, "wall_s", (int, float), where)
            need(r, "windows_per_s", (int, float), where)
            need(r, "grant_slots_sum", int, where)
            need(r, "grant_slots_mean", (int, float), where)
            need(r, "grant_slots_max", int, where)
            for k in ("tx_pkts", "rx_pkts", "transport_tx", "transport_rx"):
                need(r, k, int, where)
            for p in _PHASES:
                need(r, f"{p}_wall_s", (int, float), where)
            if isinstance(windows, int) and windows < 0:
                problems.append(f"{where}.windows: negative")
    return problems
