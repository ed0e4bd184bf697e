"""Device-resident FlowMonitor: per-flow KPI columns and packet rings.

A copy of ``tpudes/obs/flowmon.py`` for the port.  The device engines
cannot fire per-packet callbacks, so each keeps ns-3's FlowMonitor
columns beside its state when run with ``obs=True``:

- **Accumulators** (:func:`flow_carry` ``:114``, :func:`flow_accumulate`
  ``:146``, :func:`flow_ring_write` ``:203``), here as plain torch
  functions: per-flow tx/rx packets and bytes, the RFC-3550 delay and
  jitter sums, loss, a 16-bin delay histogram, and a 512-row packet-event
  ring ``(step, t_us, flow, size, verdict)`` written at ``step % 512``.
  They are the plain versions every engine's plain loop calls; on the
  card the engines' kernels (``csrc/*``, their ``OBS`` arms) compute the
  same columns bit for bit.
- **Host reduction and export** (:func:`decode_packet_rings` ``:233``,
  :func:`reduce_flow_stats` ``:256``, :func:`host_reference_stats`
  ``:293``, :func:`serialize_flow_stats_xml` ``:337``,
  :func:`write_events_pcap` ``:368``, the validators ``:417`` and
  ``:486``, :class:`DeviceFlowMonitor` ``:556``), numpy and stdlib only.

The engines are step-synchronous: a flow that delivers several packets in
one step contributes ONE delay observation (the step's mean) to the
jitter chain, as in the reference.  Counters are int32; the reducer
raises where ``fm_tx`` saturated.

:class:`FiveTuple` and :class:`FlowStats` are copies of
``tpudes/models/flow_monitor.py:27`` and ``:38``; the pcap constants are
``tpudes/network/trace_helper.py``'s.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

__all__ = [
    "FLOW_DELAY_BINS",
    "FLOW_RING_CAP",
    "FM_KEYS",
    "RING_COLS",
    "VERDICT_TX",
    "VERDICT_RX",
    "VERDICT_DROP",
    "DeviceFlowMonitor",
    "FiveTuple",
    "FlowStats",
    "PacketEvent",
    "decode_packet_rings",
    "flow_accumulate",
    "flow_carry",
    "flow_ring_write",
    "host_reference_stats",
    "reduce_flow_stats",
    "serialize_flow_stats_xml",
    "validate_flowmon_xml",
    "validate_pcap",
    "write_events_pcap",
]

#: fixed-bin delay histogram width (per-flow column ``fm_hist``)
FLOW_DELAY_BINS = 16
#: packet-event ring capacity: one slot per engine step, recycled
#: modularly; a chunk no longer than this fetches a complete event log
FLOW_RING_CAP = 512
#: ring row layout: (step, t_us, flow, size, verdict)
RING_COLS = 5

VERDICT_TX = 0
VERDICT_RX = 1
VERDICT_DROP = 2

#: the column keys :func:`flow_carry` creates, in the engines' fetch order
FM_KEYS = (
    "fm_tx", "fm_txb", "fm_rx", "fm_rxb", "fm_lost",
    "fm_dsum", "fm_jsum", "fm_dlast", "fm_t0", "fm_t1",
    "fm_hist", "fm_ring",
)

#: ``tpudes/network/trace_helper.py``'s classic pcap header fields
DLT_RAW = 101
PCAP_MAGIC = 0xA1B2C3D4
PCAP_VERSION = (2, 4)


@dataclass(frozen=True)
class FiveTuple:
    """ipv4-flow-classifier.h FiveTuple (``flow_monitor.py:27``)."""

    source: str
    destination: str
    protocol: int
    source_port: int
    destination_port: int


@dataclass
class FlowStats:
    """flow-monitor.h FlowStats, the fields the examples report
    (``flow_monitor.py:38``)."""

    tx_packets: int = 0
    tx_bytes: int = 0
    rx_packets: int = 0
    rx_bytes: int = 0
    lost_packets: int = 0
    delay_sum_s: float = 0.0
    jitter_sum_s: float = 0.0
    last_delay_s: float | None = None
    time_first_tx_s: float | None = None
    time_last_rx_s: float | None = None

    @property
    def mean_delay_s(self) -> float:
        return self.delay_sum_s / self.rx_packets if self.rx_packets else 0.0

    @property
    def mean_jitter_s(self) -> float:
        return (
            self.jitter_sum_s / (self.rx_packets - 1)
            if self.rx_packets > 1
            else 0.0
        )

    def throughput_bps(self) -> float:
        if (
            self.time_first_tx_s is None
            or self.time_last_rx_s is None
            or self.time_last_rx_s <= self.time_first_tx_s
        ):
            return 0.0
        return 8.0 * self.rx_bytes / (self.time_last_rx_s - self.time_first_tx_s)


class PacketEvent(NamedTuple):
    """One decoded ring row (µs timestamp, ns-3 trace verdict)."""

    step: int
    t_us: int
    flow: int
    size: int
    verdict: int


# --- the accumulators (torch; the plain versions of the kernels' OBS arms)


def flow_carry(n_flows: int, lead: tuple = (), device=None) -> dict:
    """The obs columns, zero or sentinel initialised (``flowmon.py:114``):
    ``lead`` prefixes every column with the engine's batch axes.
    ``fm_dlast``, ``fm_t0`` and ``fm_t1`` start at -1.0 (no observation
    yet), ring rows at step -1 (never written)."""
    import torch

    F = int(n_flows)
    lead = tuple(int(n) for n in lead)
    z = dict(dtype=torch.int32, device=device)
    zf = dict(dtype=torch.float32, device=device)
    return dict(
        fm_tx=torch.zeros(lead + (F,), **z),
        fm_txb=torch.zeros(lead + (F,), **z),
        fm_rx=torch.zeros(lead + (F,), **z),
        fm_rxb=torch.zeros(lead + (F,), **z),
        fm_lost=torch.zeros(lead + (F,), **z),
        fm_dsum=torch.zeros(lead + (F,), **zf),
        fm_jsum=torch.zeros(lead + (F,), **zf),
        fm_dlast=torch.full(lead + (F,), -1.0, **zf),
        fm_t0=torch.full(lead + (F,), -1.0, **zf),
        fm_t1=torch.full(lead + (F,), -1.0, **zf),
        fm_hist=torch.zeros(lead + (F, FLOW_DELAY_BINS), **z),
        fm_ring=torch.full(lead + (FLOW_RING_CAP, RING_COLS), -1, **z),
    )


def bin_scale(bin_width_s: float) -> float:
    """The f32 factor :func:`delay_bin` multiplies a delay by: the
    reference's ``delay / f32(width)`` (``flowmon.py:175``) is compiled by
    XLA as ``delay * f32(1 / f32(width))`` (its algebraic simplifier
    inverts a constant divisor; the engines' optimised HLO shows the
    multiply), which lands in another bin than the divide for some
    delays."""
    one = np.float32(1.0)
    return float(one / np.float32(bin_width_s))


def delay_bin(delay_s, bin_width_s: float):
    """The histogram bin of each delay: ``clip(int(delay * scale), 0,
    BINS - 1)``, :func:`bin_scale`'s product and the truncation toward
    zero of the reference's compiled step."""
    import torch

    q = delay_s * torch.tensor(bin_scale(bin_width_s), dtype=torch.float32)
    return q.to(torch.int32).clamp(0, FLOW_DELAY_BINS - 1)


def flow_accumulate(fm: dict, *, t_s, tx, tx_bytes, rx, rx_bytes, delay_s,
                    lost, bin_width_s: float) -> dict:
    """One step of FlowStats accumulation over the ``fm_*`` columns
    (``flowmon.py:146``).  Operands broadcast against the ``(..., F)``
    columns: ``tx``, ``rx`` and ``lost`` are this step's per-flow packet
    counts, ``*_bytes`` their bytes, ``delay_s`` the per-flow delay of
    this step's deliveries (ignored where ``rx == 0``), ``t_s`` the step's
    time.  Jitter is ``|delay - last delay|``, one observation a (step,
    flow).  Returns new columns (the ring is :func:`flow_ring_write`'s)."""
    import torch

    f32, i32 = torch.float32, torch.int32
    rx = torch.as_tensor(rx)
    tx = torch.as_tensor(tx)
    got = rx > 0
    seen = fm["fm_dlast"] >= 0.0
    delay_s = torch.as_tensor(delay_s, dtype=f32, device=rx.device)
    t_s = torch.as_tensor(t_s, dtype=f32, device=rx.device)
    bins = delay_bin(delay_s, bin_width_s)
    one_hot = (bins[..., None] == torch.arange(
        FLOW_DELAY_BINS, dtype=i32, device=rx.device)).to(i32)
    out = dict(fm)
    out["fm_tx"] = fm["fm_tx"] + tx.to(i32)
    out["fm_txb"] = fm["fm_txb"] + torch.as_tensor(tx_bytes).to(i32)
    out["fm_rx"] = fm["fm_rx"] + rx.to(i32)
    out["fm_rxb"] = fm["fm_rxb"] + torch.as_tensor(rx_bytes).to(i32)
    out["fm_lost"] = fm["fm_lost"] + torch.as_tensor(lost).to(i32)
    out["fm_dsum"] = fm["fm_dsum"] + delay_s * rx.to(f32)
    out["fm_jsum"] = fm["fm_jsum"] + torch.where(
        got & seen, (delay_s - fm["fm_dlast"]).abs(),
        torch.zeros((), dtype=f32, device=rx.device))
    out["fm_dlast"] = torch.where(got, delay_s, fm["fm_dlast"])
    out["fm_t0"] = torch.where((tx > 0) & (fm["fm_t0"] < 0.0), t_s,
                               fm["fm_t0"])
    out["fm_t1"] = torch.where(got, t_s, fm["fm_t1"])
    out["fm_hist"] = fm["fm_hist"] + one_hot * rx.to(i32)[..., None]
    return out


def flow_ring_write(ring, counter: int, row):
    """``ring`` with this step's event ``row`` written at slot ``counter
    % CAP`` (``flowmon.py:203``): ``ring`` is ``(..., CAP, COLS)``, ``row``
    ``(..., COLS)``; a row of step -1 (no event) still overwrites, so a
    slot always holds the last step that owned it.  ``counter`` is an int
    or a ``(...)`` tensor of per-row counters."""
    import torch

    ring = ring.clone()
    cap = ring.shape[-2]
    row = torch.as_tensor(row).to(torch.int32)
    if isinstance(counter, torch.Tensor) and counter.dim() > 0:
        idx = (counter.long() % cap)[..., None, None].expand(
            *counter.shape, 1, ring.shape[-1])
        return ring.scatter_(-2, idx, row[..., None, :])
    ring[..., int(counter) % cap, :] = row
    return ring


def flip_ring(ring):
    """The ring in reverse slot order: the chunk metrics' fresh copy of
    it (the reference's ``jnp.flip(..., axis=-2)``; the decoder orders
    rows by their step, so the flip needs no undo)."""
    import torch

    return torch.flip(ring, dims=(-2,))


# --- host-side reduction ---------------------------------------------


def decode_packet_rings(rings) -> list[PacketEvent]:
    """Merge ring snapshots (one per chunk boundary) into one event
    list, sorted by step and deduped on the step column (unique per
    event — every engine stamps rows with its monotonic step counter,
    so the same event fetched at two chunk boundaries collapses).

    Each snapshot is a ``(CAP, COLS)`` array slice (pick the replica /
    config lane before calling); rows with step ``< 0`` are empty
    slots.  Snapshots may arrive flipped or rotated — order inside a
    ring is irrelevant, the step column is the total order."""
    by_step: dict[int, PacketEvent] = {}
    for ring in rings:
        arr = np.asarray(ring)
        if arr.ndim != 2 or arr.shape[-1] != RING_COLS:
            raise ValueError(
                f"ring snapshot must be (cap, {RING_COLS}), got "
                f"{arr.shape} — slice the replica lane first"
            )
        for r in arr[arr[:, 0] >= 0]:
            by_step[int(r[0])] = PacketEvent(*(int(v) for v in r))
    return [by_step[s] for s in sorted(by_step)]


def reduce_flow_stats(fm: dict) -> dict[int, FlowStats]:
    """Fetched ``fm_*`` columns (leaves sliced to ``(F,)`` /
    ``(F, BINS)``) → host :class:`FlowStats`, flow ids 1-based as
    upstream's classifier assigns them.  Flows with no activity are
    omitted (the host monitor only materialises a flow on its first
    packet)."""
    tx = np.asarray(fm["fm_tx"]).reshape(-1)
    if (tx == np.iinfo(np.int32).max).any():
        raise ValueError(
            "fm_tx saturated int32 — shorten the horizon or shard flows"
        )
    F = tx.shape[0]
    get = lambda k: np.asarray(fm[k]).reshape(F, -1).squeeze(-1)  # noqa: E731
    rx = get("fm_rx")
    lost = get("fm_lost")
    dlast = np.asarray(fm["fm_dlast"], np.float64).reshape(-1)
    t0 = np.asarray(fm["fm_t0"], np.float64).reshape(-1)
    t1 = np.asarray(fm["fm_t1"], np.float64).reshape(-1)
    out: dict[int, FlowStats] = {}
    for i in range(F):
        if tx[i] == 0 and rx[i] == 0 and lost[i] == 0:
            continue
        out[i + 1] = FlowStats(
            tx_packets=int(tx[i]),
            tx_bytes=int(get("fm_txb")[i]),
            rx_packets=int(rx[i]),
            rx_bytes=int(get("fm_rxb")[i]),
            lost_packets=int(lost[i]),
            delay_sum_s=float(np.asarray(fm["fm_dsum"])[i]),
            jitter_sum_s=float(np.asarray(fm["fm_jsum"])[i]),
            last_delay_s=float(dlast[i]) if dlast[i] >= 0 else None,
            time_first_tx_s=float(t0[i]) if t0[i] >= 0 else None,
            time_last_rx_s=float(t1[i]) if t1[i] >= 0 else None,
        )
    return out


def host_reference_stats(
    steps, n_flows: int | None = None
) -> dict[int, FlowStats]:
    """Pure-NumPy reference accumulator: the host monitor's
    ``_on_send`` / ``_on_deliver`` / ``_on_drop`` arithmetic applied to
    a per-step event stream, under the same one-observation-per-
    (step, flow) jitter rule the device columns use.  ``steps`` is an
    iterable of dicts with keys ``t_s`` and per-flow arrays ``tx``,
    ``tx_bytes``, ``rx``, ``rx_bytes``, ``delay_s``, ``lost`` (exactly
    :func:`flow_accumulate`'s operands) — the oracle the device columns
    are validated against per engine."""
    stats: dict[int, FlowStats] = {}
    last: dict[int, float] = {}
    for ev in steps:
        t_s = float(ev["t_s"])
        F = len(np.atleast_1d(ev["tx"])) if n_flows is None else n_flows
        for i in range(F):
            tx = int(np.atleast_1d(ev["tx"])[i])
            rx = int(np.atleast_1d(ev["rx"])[i])
            lost = int(np.atleast_1d(ev.get("lost", np.zeros(F)))[i])
            if tx == 0 and rx == 0 and lost == 0:
                continue
            st = stats.setdefault(i + 1, FlowStats())
            st.tx_packets += tx
            st.tx_bytes += int(np.atleast_1d(ev["tx_bytes"])[i])
            st.lost_packets += lost
            if tx and st.time_first_tx_s is None:
                st.time_first_tx_s = t_s
            if rx:
                delay = float(np.atleast_1d(ev["delay_s"])[i])
                st.rx_packets += rx
                st.rx_bytes += int(np.atleast_1d(ev["rx_bytes"])[i])
                st.delay_sum_s += delay * rx
                if i + 1 in last:
                    st.jitter_sum_s += abs(delay - last[i + 1])
                last[i + 1] = delay
                st.last_delay_s = delay
                st.time_last_rx_s = t_s
    return stats


# --- export: the ONE XML serializer + pcap emission ------------------


def serialize_flow_stats_xml(
    stats: dict[int, FlowStats],
    flows: dict[FiveTuple, int],
    filename: str,
) -> None:
    """flow-monitor.cc ``SerializeToXmlFile``: the standard FlowMonitor
    XML shape (attribute names match upstream's parser ecosystem).
    Shared by the host monitor and :class:`DeviceFlowMonitor` — one
    serializer, two producers (REG001 trace-name parity)."""
    with open(filename, "w") as f:
        f.write("<?xml version=\"1.0\" ?>\n<FlowMonitor>\n  <FlowStats>\n")
        for fid, st in sorted(stats.items()):
            f.write(
                f'    <Flow flowId="{fid}" '
                f'txPackets="{st.tx_packets}" txBytes="{st.tx_bytes}" '
                f'rxPackets="{st.rx_packets}" rxBytes="{st.rx_bytes}" '
                f'lostPackets="{st.lost_packets}" '
                f'delaySum="+{st.delay_sum_s * 1e9:.0f}ns" '
                f'jitterSum="+{st.jitter_sum_s * 1e9:.0f}ns" />\n'
            )
        f.write("  </FlowStats>\n  <Ipv4FlowClassifier>\n")
        for t, fid in (flows or {}).items():
            f.write(
                f'    <Flow flowId="{fid}" sourceAddress="{t.source}" '
                f'destinationAddress="{t.destination}" '
                f'protocol="{t.protocol}" sourcePort="{t.source_port}" '
                f'destinationPort="{t.destination_port}" />\n'
            )
        f.write("  </Ipv4FlowClassifier>\n</FlowMonitor>\n")


def write_events_pcap(
    events,
    filename: str,
    *,
    verdicts=(VERDICT_RX,),
    data_link_type: int | None = None,
    snap_len: int = 65535,
) -> int:
    """Emit decoded ring events as a classic libpcap file in the
    ``network/trace_helper`` frame format (same magic/version/record
    layout as ``tpudes/network/trace_helper.py``'s ``PcapFileWrapper``),
    so the device run opens in tcpdump/wireshark and — the round trip
    this repo cares about — ``tpudes_torch.traffic.ingest.read_pcap`` reads it back
    into a trace-replay table.

    The device rings carry sizes, not payload bytes, so frames are
    zero-filled and capped at ``snap_len`` while the record header
    keeps the ORIGINAL length — exactly what ``read_pcap`` returns, so
    the round trip is lossless on (µs time, wire bytes).  Returns the
    record count."""
    dlt = DLT_RAW if data_link_type is None else int(data_link_type)
    n = 0
    with open(filename, "wb") as f:
        f.write(
            struct.pack(
                "<IHHiIII",
                PCAP_MAGIC, PCAP_VERSION[0], PCAP_VERSION[1],
                0, 0, snap_len, dlt,
            )
        )
        for ev in events:
            if ev.verdict not in verdicts:
                continue
            sec, usec = divmod(int(ev.t_us), 1_000_000)
            cap = min(int(ev.size), snap_len)
            f.write(
                struct.pack("<IIII", sec, usec, cap, int(ev.size))
                + b"\x00" * cap
            )
            n += 1
    return n


def validate_flowmon_xml(text: str) -> tuple[list, int]:
    """Schema-check a FlowMonitor XML document (the shared serializer's
    output, or upstream ns-3's — same attribute ecosystem).  Returns
    ``(problems, n_flows)``; empty problems = valid.  Messages are
    actionable: they name the element, the attribute and what to fix."""
    import xml.etree.ElementTree as ET

    problems: list[str] = []
    try:
        root = ET.fromstring(text)
    except ET.ParseError as e:
        return [f"not well-formed XML ({e}) — is this a FlowMonitor "
                "SerializeToXmlFile output?"], 0
    if root.tag != "FlowMonitor":
        return [f"root element is <{root.tag}>, expected <FlowMonitor> "
                "(SerializeToXmlFile writes <FlowMonitor> at top level)"], 0
    stats = root.find("FlowStats")
    if stats is None:
        return ["missing <FlowStats> section under <FlowMonitor>"], 0
    int_attrs = ("txPackets", "txBytes", "rxPackets", "rxBytes",
                 "lostPackets")
    ns_attrs = ("delaySum", "jitterSum")
    seen_ids: set = set()
    n = 0
    for i, flow in enumerate(stats.findall("Flow")):
        n += 1
        where = f"FlowStats/Flow[{i}]"
        fid = flow.get("flowId")
        if fid is None:
            problems.append(f"{where}: missing flowId attribute")
        elif fid in seen_ids:
            problems.append(f"{where}: duplicate flowId {fid}")
        else:
            seen_ids.add(fid)
        for a in int_attrs:
            v = flow.get(a)
            if v is None:
                problems.append(f"{where}: missing {a} attribute")
            elif not v.lstrip("-").isdigit():
                problems.append(
                    f"{where}: {a}={v!r} is not an integer"
                )
            elif int(v) < 0:
                problems.append(f"{where}: {a}={v} is negative")
        for a in ns_attrs:
            v = flow.get(a)
            if v is None:
                problems.append(f"{where}: missing {a} attribute")
            elif not (v.startswith("+") and v.endswith("ns")):
                problems.append(
                    f"{where}: {a}={v!r} must be '+<nanoseconds>ns' "
                    "(upstream ns-3 Time serialization)"
                )
    for i, flow in enumerate(
        root.findall("Ipv4FlowClassifier/Flow")
    ):
        where = f"Ipv4FlowClassifier/Flow[{i}]"
        for a in ("flowId", "sourceAddress", "destinationAddress"):
            if flow.get(a) is None:
                problems.append(f"{where}: missing {a} attribute")
    return problems, n


#: pcapng section-header magic — a different container format
_PCAPNG_MAGIC = 0x0A0D0D0A
#: classic-pcap magic accepted in either byte order, µs or ns ticks
_PCAP_MAGICS = (0xA1B2C3D4, 0xA1B23C4D)


def validate_pcap(data: bytes) -> tuple[list, int]:
    """Structurally validate a classic libpcap capture: both byte
    orders, both the microsecond and nanosecond magic.  Returns
    ``(problems, n_records)``.  Walks every record header and checks it
    against the remaining bytes, so a truncated or corrupt file names
    the exact offset."""
    if len(data) < 24:
        return [f"file is {len(data)} bytes — a pcap global header is "
                "24 bytes; not a capture file"], 0
    (magic,) = struct.unpack("<I", data[:4])
    if magic == _PCAPNG_MAGIC or struct.unpack(">I", data[:4])[0] == _PCAPNG_MAGIC:
        return ["pcapng container, not classic pcap — convert with "
                "`tcpdump -r in.pcapng -w out.pcap` or read with a "
                "pcapng-aware tool"], 0
    endian = None
    for e in ("<", ">"):
        (m,) = struct.unpack(e + "I", data[:4])
        if m in _PCAP_MAGICS:
            endian = e
            magic = m
            break
    if endian is None:
        return [f"unknown magic 0x{magic:08X} — expected classic pcap "
                "0xA1B2C3D4 (µs) or 0xA1B23C4D (ns) in either byte "
                "order"], 0
    ver_major, ver_minor, _tz, _sig, snap_len, _dlt = struct.unpack(
        endian + "HHiIII", data[4:24]
    )
    problems: list[str] = []
    if ver_major != 2:
        problems.append(
            f"version {ver_major}.{ver_minor} — classic pcap is 2.x"
        )
    if snap_len == 0:
        problems.append("snap_len is 0 — every record would be empty")
    off = 24
    n = 0
    while off < len(data):
        if off + 16 > len(data):
            problems.append(
                f"truncated record header at byte {off} "
                f"({len(data) - off} bytes left, need 16)"
            )
            break
        _sec, _sub, cap, orig = struct.unpack(
            endian + "IIII", data[off:off + 16]
        )
        if cap > snap_len:
            problems.append(
                f"record {n} at byte {off}: incl_len {cap} exceeds "
                f"snap_len {snap_len}"
            )
            break
        if cap > orig:
            problems.append(
                f"record {n} at byte {off}: incl_len {cap} exceeds "
                f"orig_len {orig}"
            )
        if off + 16 + cap > len(data):
            problems.append(
                f"record {n} at byte {off}: declares {cap} payload "
                f"bytes but only {len(data) - off - 16} remain "
                "(truncated capture)"
            )
            break
        off += 16 + cap
        n += 1
    return problems, n


class DeviceFlowMonitor:
    """Host wrapper over one lane's reduced device telemetry: the same
    reporting surface the host ``FlowMonitor`` exposes
    (``GetFlowStats`` / ``SerializeToXmlFile``) plus the device-only
    exports (pcap, trace-replay round trip).

    ``five_tuples`` optionally names each flow id's classifier tuple
    for the XML's Ipv4FlowClassifier section; device engines have no
    IP layer, so it defaults to empty (the section is emitted empty —
    parsers that only read FlowStats are unaffected)."""

    def __init__(
        self,
        fm: dict,
        rings=(),
        five_tuples: dict[int, FiveTuple] | None = None,
    ):
        self.stats = reduce_flow_stats(fm)
        self.events = decode_packet_rings(rings) if len(rings) else []
        self._flows = {
            t: fid for fid, t in (five_tuples or {}).items()
        }

    def GetFlowStats(self) -> dict[int, FlowStats]:
        return self.stats

    def SerializeToXmlFile(self, filename: str, *_args) -> None:
        serialize_flow_stats_xml(self.stats, self._flows, filename)

    def WritePcap(self, filename: str, **kw) -> int:
        return write_events_pcap(self.events, filename, **kw)

    def ToTrafficProgram(self, n_entities: int | None = None, **kw):
        """Delivered ring events → exact trace-replay
        :class:`~tpudes_torch.traffic.program.TrafficProgram` (one entity per flow id
        seen, or ``n_entities`` fixed lanes), closing the ingest loop
        against our own output without touching the filesystem."""
        from tpudes_torch.traffic.ingest import ingest_traces

        rx = [e for e in self.events if e.verdict == VERDICT_RX]
        flows = sorted({e.flow for e in rx})
        if n_entities is not None:
            flows = list(range(n_entities))
        sources = []
        for fl in flows:
            mine = [e for e in rx if e.flow == fl]
            sources.append(
                (
                    np.asarray([e.t_us for e in mine], np.int64),
                    np.asarray([e.size for e in mine], np.int64),
                )
            )
        return ingest_traces(sources, t0_us=0, **kw)
