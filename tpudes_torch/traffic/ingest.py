"""Trace ingestion: measured traces to trace-replay operand tables.

A copy of ``tpudes/traffic/ingest.py`` (numpy and stdlib only):
:func:`read_pcap` (``:48``), :func:`read_csv_trace` (``:99``) and
:func:`ingest_traces` (``:160``), which compress per-entity ``(time,
bytes)`` captures into an exact trace-replay
:class:`~tpudes_torch.traffic.program.TrafficProgram`.  Arrivals are
truncated to whole microseconds and same-µs arrivals coalesce by summing
bytes, lossless on the engines' µs window queries; a trace that still
exceeds ``max_rows`` after coalescing raises rather than dropping
arrivals.  :meth:`tpudes_torch.obs.flowmon.DeviceFlowMonitor.
ToTrafficProgram` replays a device run's delivered ring events through
it.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = [
    "TraceIngestError",
    "ingest_traces",
    "read_csv_trace",
    "read_pcap",
]

#: classic libpcap magics: µs timestamps (the trace_helper writer),
#: byte-swapped, and the nanosecond-resolution variant
_MAGIC_US_LE = 0xA1B2C3D4
_MAGIC_NS_LE = 0xA1B23C4D


class TraceIngestError(ValueError):
    """Unreadable or unrepresentable trace input."""


def read_pcap(path: str):
    """Parse one libpcap file → ``(times_us, bytes_)`` int64 arrays
    (arrival time in µs since capture epoch, ORIGINAL packet length —
    what the wire carried, not the snap-truncated capture).  Handles
    both endiannesses and the nanosecond magic; pcapng is rejected
    loudly (convert with ``tcpdump -r in.pcapng -w out.pcap``)."""
    with open(path, "rb") as f:
        head = f.read(24)
        if len(head) < 24:
            raise TraceIngestError(f"{path}: truncated pcap header")
        magic_le = struct.unpack("<I", head[:4])[0]
        magic_be = struct.unpack(">I", head[:4])[0]
        if magic_le == 0x0A0D0D0A or magic_be == 0x0A0D0D0A:
            raise TraceIngestError(
                f"{path}: pcapng is not supported — convert to classic "
                "pcap (tcpdump -r in.pcapng -w out.pcap)"
            )
        if magic_le in (_MAGIC_US_LE, _MAGIC_NS_LE):
            endian, magic = "<", magic_le
        elif magic_be in (_MAGIC_US_LE, _MAGIC_NS_LE):
            endian, magic = ">", magic_be
        else:
            raise TraceIngestError(
                f"{path}: not a libpcap file (magic {head[:4]!r})"
            )
        ns = magic == _MAGIC_NS_LE
        times, sizes = [], []
        while True:
            rec = f.read(16)
            if not rec:
                break
            if len(rec) < 16:
                raise TraceIngestError(
                    f"{path}: truncated record header at packet "
                    f"{len(times)}"
                )
            sec, sub, cap, orig = struct.unpack(endian + "IIII", rec)
            data = f.read(cap)
            if len(data) < cap:
                raise TraceIngestError(
                    f"{path}: truncated payload at packet {len(times)}"
                )
            us = sec * 1_000_000 + (sub // 1000 if ns else sub)
            times.append(us)
            sizes.append(orig)
    return (
        np.asarray(times, np.int64),
        np.asarray(sizes, np.int64),
    )


def read_csv_trace(
    path: str,
    *,
    time_col: int = 0,
    bytes_col: int = 1,
    time_unit: str = "s",
    delimiter: str = ",",
):
    """Parse a CSV packet log → ``(times_us, bytes_)`` int64 arrays.
    ``time_unit`` is one of s/ms/us/ns; a non-numeric first row is
    treated as a header and skipped (exporters disagree about
    headers, so sniff instead of flag)."""
    scale = {"s": 1e6, "ms": 1e3, "us": 1.0, "ns": 1e-3}.get(time_unit)
    if scale is None:
        raise TraceIngestError(
            f"time_unit must be s/ms/us/ns, not {time_unit!r}"
        )
    times, sizes = [], []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            cells = line.split(delimiter)
            try:
                t = float(cells[time_col])
                b = float(cells[bytes_col])
            except (ValueError, IndexError):
                if lineno == 1:
                    continue  # header row
                raise TraceIngestError(
                    f"{path}:{lineno}: unparseable row {line!r}"
                ) from None
            times.append(int(round(t * scale)))
            sizes.append(int(round(b)))
    if not times:
        raise TraceIngestError(f"{path}: no packet rows")
    return (
        np.asarray(times, np.int64),
        np.asarray(sizes, np.int64),
    )


def _compress(times_us, bytes_, t0_us):
    """Sort, rebase to ``t0_us``, and coalesce same-µs arrivals (sum
    bytes) — lossless on the device tables' µs window queries."""
    order = np.argsort(times_us, kind="stable")
    t = times_us[order] - int(t0_us)
    b = bytes_[order]
    if (t < 0).any():
        raise TraceIngestError("arrival before the trace epoch t0")
    # coalesce runs of equal timestamps
    keep = np.ones(len(t), bool)
    keep[1:] = t[1:] != t[:-1]
    idx = np.cumsum(keep) - 1
    out_t = t[keep]
    out_b = np.zeros(len(out_t), np.int64)
    np.add.at(out_b, idx, b)
    return out_t, out_b


def ingest_traces(
    sources,
    *,
    t0_us: int | None = None,
    max_rows: int = 4096,
    pad_to: int | None = None,
):
    """Build an exact trace-replay :class:`TrafficProgram` from one
    measured source per entity.

    ``sources`` is a list with one entry per entity, each either a
    path (``.pcap``/``.csv`` by extension), a ``(times_us, bytes_)``
    array pair, or a callable returning one.  ``t0_us`` rebases all
    entities to a common epoch (default: the earliest arrival across
    the batch, so relative timing between entities is preserved —
    capture timestamps are wall-clock, simulation starts at 0).
    ``max_rows`` bounds the per-entity table after same-µs coalescing
    (a longer trace refuses loudly — truncation would silently change
    the workload); ``pad_to`` forces the table capacity (the
    ``shape_key`` knob, so ingested workloads can join an existing
    sweep's executable)."""
    from tpudes_torch.traffic.program import GAP_INF, TrafficProgram

    rows = []
    for i, src in enumerate(sources):
        if callable(src):
            pair = src()
        elif isinstance(src, str):
            if src.endswith(".csv"):
                pair = read_csv_trace(src)
            else:
                pair = read_pcap(src)
        else:
            pair = src
        t, b = (np.asarray(pair[0], np.int64),
                np.asarray(pair[1], np.int64))
        if t.shape != b.shape or t.ndim != 1:
            raise TraceIngestError(
                f"entity {i}: times/bytes must be matching 1-D arrays"
            )
        rows.append((t, b))
    if all(len(t) == 0 for t, _ in rows):
        raise TraceIngestError("every source is empty")
    if t0_us is None:
        t0_us = min(int(t.min()) for t, _ in rows if len(t))
    comp = [
        _compress(t, b, t0_us) if len(t) else
        (np.zeros(0, np.int64), np.zeros(0, np.int64))
        for t, b in rows
    ]
    k = max(max((len(t) for t, _ in comp), default=1), 2)
    if k > max_rows:
        raise TraceIngestError(
            f"{k} arrivals/entity after coalescing exceeds "
            f"max_rows={max_rows} — raise the cap or split the capture"
        )
    if pad_to is not None:
        if pad_to < k:
            raise TraceIngestError(
                f"pad_to={pad_to} below the {k} rows the traces need"
            )
        k = int(pad_to)
    n = len(comp)
    arr_t = np.full((n, k), int(GAP_INF), np.int64)
    arr_b = np.zeros((n, k), np.int64)
    for i, (t, b) in enumerate(comp):
        if len(t) and int(t.max()) >= int(GAP_INF):
            raise TraceIngestError(
                f"entity {i}: arrival at {int(t.max())} µs past the "
                f"representable horizon ({int(GAP_INF)} µs ≈ 17.9 min) "
                "— rebase with t0_us or split the capture"
            )
        arr_t[i, : len(t)] = t
        arr_b[i, : len(b)] = np.minimum(b, 2**30)
    return TrafficProgram.trace_replay(arr_t, arr_b)
