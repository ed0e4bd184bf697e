"""The port's device FlowMonitor (``tpudes_torch.obs``) against the JAX
package's ``tpudes.obs``.

The accumulators take the same seeded numpy inputs as the reference's
jitted ones (the arithmetic the reference's engines compile): every
column and ring bit-equal.  The host side (reducer, decoder, the numpy
oracle) gives equal ``FlowStats`` and events; the XML and pcap writers
give the reference's files byte for byte; the validators give the
reference's problem lists on the reference tests' bad documents.  The
telemetry registries (compile, stage, chunk, geometry, traffic and the
hybrid's distributed record) give the reference's snapshots for the same
records.  Tolerance: none.
"""

import dataclasses
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudes.obs import distributed as ref_dist
from tpudes.obs import flowmon as ref_fm
from tpudes.obs import geometry as ref_geom
from tpudes.obs import traffic as ref_traffic
from tpudes.obs.device import ChunkStream as RefChunkStream
from tpudes.obs.device import CompileTelemetry as RefCompile
from tpudes.obs.device import KernelProfile as RefProfile
from tpudes_torch.obs import __main__ as cli
from tpudes_torch.obs import device as dev_obs
from tpudes_torch.obs import distributed as port_dist
from tpudes_torch.obs import flowmon as fm
from tpudes_torch.obs import geometry as port_geom
from tpudes_torch.obs import traffic as port_traffic

F, R, STEPS = 5, 3, 40


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        _bits(a), _bits(b))


def _steps(seed, n=STEPS):
    """Seeded per-step operands of flow_accumulate, ``(R, F)`` each: few
    events a step, delays over several bins, some exactly on a bin edge."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tx = rng.integers(0, 3, (R, F)).astype(np.int32)
        rx = (rng.random((R, F)) < 0.4).astype(np.int32) * rng.integers(
            1, 3, (R, F)).astype(np.int32)
        delay = rng.uniform(0.0, 0.02, (R, F)).astype(np.float32)
        delay[0, 0] = np.float32(0.001 * (i % 17))     # on the bin edges
        out.append(dict(
            t_s=np.float32(i * 0.0137), tx=tx, tx_bytes=tx * 1040,
            rx=rx, rx_bytes=rx * 1040, delay_s=delay,
            lost=(rng.random((R, F)) < 0.1).astype(np.int32)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accumulators_bit_equal_to_jitted_reference(seed):
    """flow_carry, then STEPS of flow_accumulate and flow_ring_write: the
    port's columns and ring equal the jitted reference's bit for bit."""
    bw = 0.02 / fm.FLOW_DELAY_BINS

    @jax.jit
    def ref_step(cols, ops, t):
        out = ref_fm.flow_accumulate(cols, bin_width_s=bw, **ops)
        row = jnp.stack([jnp.full((R,), t), ops["tx"].sum(1),
                         jnp.argmax(ops["rx"], 1).astype(jnp.int32),
                         ops["rx_bytes"].sum(1),
                         jnp.full((R,), fm.VERDICT_RX)], -1)
        out["fm_ring"] = ref_fm.flow_ring_write(cols["fm_ring"], t, row)
        return out

    want = {k: v for k, v in ref_fm.flow_carry(F, lead=(R,)).items()}
    got = fm.flow_carry(F, (R,), "cpu")
    for k in fm.FM_KEYS:
        assert _same(got[k].numpy(), want[k]), k
    for t, ops in enumerate(_steps(seed)):
        want = ref_step(want, {k: jnp.asarray(v) for k, v in ops.items()},
                        jnp.int32(t))
        tops = {k: torch.as_tensor(np.asarray(v)) for k, v in ops.items()}
        ring = got["fm_ring"]
        got = fm.flow_accumulate(got, bin_width_s=bw, **tops)
        row = torch.stack([torch.full((R,), t), tops["tx"].sum(1),
                           tops["rx"].argmax(1),
                           tops["rx_bytes"].sum(1),
                           torch.full((R,), fm.VERDICT_RX)], -1)
        got["fm_ring"] = fm.flow_ring_write(ring, t, row.to(torch.int32))
    for k in fm.FM_KEYS:
        assert _same(got[k].numpy(), want[k]), k
    assert int(got["fm_hist"].sum()) == int(got["fm_rx"].sum()) > 0


def test_per_row_ring_counters_equal_the_reference_per_row():
    """The port's ring write with one counter a row (the engines whose
    rows keep their own clocks) equals the reference's write row by
    row."""
    rng = np.random.default_rng(4)
    ring = ref_fm.flow_carry(2, lead=(R,))["fm_ring"]
    got = torch.as_tensor(np.array(ring))
    for _ in range(30):
        counter = rng.integers(0, 2000, R).astype(np.int32)
        row = rng.integers(-1, 99, (R, fm.RING_COLS)).astype(np.int32)
        ring = jnp.stack([
            ref_fm.flow_ring_write(ring[r][None], int(counter[r]),
                                   row[r][None])[0]
            for r in range(R)])
        got = fm.flow_ring_write(got, torch.as_tensor(counter),
                                 torch.as_tensor(row))
    assert _same(got.numpy(), ring)


def _stats_pair(seed=3):
    steps = _steps(seed, 25)
    cols = fm.flow_carry(F, (R,), "cpu")
    bw = 0.02 / fm.FLOW_DELAY_BINS
    for ops in steps:
        cols = fm.flow_accumulate(
            cols, bin_width_s=bw,
            **{k: torch.as_tensor(np.asarray(v)) for k, v in ops.items()})
    return steps, {k: v.numpy() for k, v in cols.items()}


def test_reduce_decode_and_oracle_equal_reference():
    """reduce_flow_stats, decode_packet_rings and host_reference_stats on
    the same columns, rings and event stream give the reference's."""
    steps, cols = _stats_pair()
    lane = {k: v[1] for k, v in cols.items()}
    got, want = fm.reduce_flow_stats(lane), ref_fm.reduce_flow_stats(lane)
    assert set(got) == set(want) and len(got) > 0
    for fid in want:
        assert dataclasses.asdict(got[fid]) == dataclasses.asdict(want[fid])
    one = [{k: (v[1] if np.ndim(v) else v) for k, v in s.items()}
           for s in steps]
    got_o = fm.host_reference_stats(one)
    want_o = ref_fm.host_reference_stats(one)
    assert {k: dataclasses.asdict(v) for k, v in got_o.items()} == {
        k: dataclasses.asdict(v) for k, v in want_o.items()}
    rng = np.random.default_rng(9)
    rings = []
    for _ in range(3):
        r = np.full((fm.FLOW_RING_CAP, fm.RING_COLS), -1, np.int32)
        idx = rng.choice(fm.FLOW_RING_CAP, 40, replace=False)
        r[idx] = rng.integers(0, 1000, (40, fm.RING_COLS))
        r[idx, 0] = rng.integers(0, 60, 40)    # repeated steps dedup
        rings.append(r)
    assert [tuple(e) for e in fm.decode_packet_rings(rings)] == [
        tuple(e) for e in ref_fm.decode_packet_rings(rings)]
    with pytest.raises(ValueError, match="slice the replica lane"):
        fm.decode_packet_rings([np.zeros((2, 4, 5), np.int32)])
    with pytest.raises(ValueError, match="saturated"):
        fm.reduce_flow_stats(dict(lane, fm_tx=np.full(F, 2**31 - 1)))


def _toy_events(n=8):
    return [fm.PacketEvent(step=i, t_us=i * 100, flow=1 + i % 2, size=1000,
                           verdict=fm.VERDICT_RX if i % 2 else fm.VERDICT_TX)
            for i in range(n)]


def test_xml_and_pcap_byte_equal_to_reference_writers(tmp_path):
    """The same stats through serialize_flow_stats_xml, and the same
    events through write_events_pcap (every verdict filter and a short
    snap length), give the reference's files byte for byte."""
    _, cols = _stats_pair()
    stats = fm.reduce_flow_stats({k: v[0] for k, v in cols.items()})
    ref_stats = {k: ref_fm.FlowStats(**dataclasses.asdict(v))
                 for k, v in stats.items()}
    flows = {fm.FiveTuple("10.0.0.1", "10.0.1.1", 17, 49152, 9): 1}
    ref_flows = {ref_fm.FiveTuple("10.0.0.1", "10.0.1.1", 17, 49152, 9): 1}
    a, b = tmp_path / "port.xml", tmp_path / "ref.xml"
    fm.serialize_flow_stats_xml(stats, flows, str(a))
    ref_fm.serialize_flow_stats_xml(ref_stats, ref_flows, str(b))
    assert a.read_bytes() == b.read_bytes()
    events = _toy_events()
    ref_events = [ref_fm.PacketEvent(*e) for e in events]
    for kw in (dict(), dict(verdicts=(fm.VERDICT_TX, fm.VERDICT_RX)),
               dict(snap_len=64, data_link_type=1)):
        a, b = tmp_path / "port.pcap", tmp_path / "ref.pcap"
        n = fm.write_events_pcap(events, str(a), **kw)
        assert n == ref_fm.write_events_pcap(ref_events, str(b), **kw)
        assert a.read_bytes() == b.read_bytes()


def _bad_documents():
    """The reference tests' bad FlowMonitor documents and captures
    (tests/test_flowmon.py), with a few more defects."""
    xml_bad = (
        '<?xml version="1.0" ?>\n<FlowMonitor>\n  <FlowStats>\n'
        '    <Flow flowId="1" txPackets="x" txBytes="10" rxPackets="9"'
        ' rxBytes="9" lostPackets="0" delaySum="0.05s"'
        ' jitterSum="+2000ns" />\n'
        '    <Flow flowId="1" txPackets="1" txBytes="1" rxPackets="1"'
        ' rxBytes="1" lostPackets="0" delaySum="+1ns"'
        ' jitterSum="+0ns" />\n'
        '    <Flow txPackets="-3" rxBytes="1" />\n'
        "  </FlowStats>\n  <Ipv4FlowClassifier>\n    <Flow flowId=\"2\" />\n"
        "  </Ipv4FlowClassifier>\n</FlowMonitor>\n")
    hdr = struct.pack(">IHHiIII", 0xA1B23C4D, 2, 4, 0, 0, 65535, 101)
    recs = b"".join(struct.pack(">IIII", 0, t * 1000, 16, 16) + bytes(16)
                    for t in range(5))
    good = struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 101) + \
        b"".join(struct.pack("<IIII", 0, 7, 8, 8) + bytes(8)
                 for _ in range(4))
    return dict(
        xml=[xml_bad, "<wrong/>", "{json?}", "<FlowMonitor/>"],
        pcap=[hdr + recs, struct.pack("<I", 0x0A0D0D0A) + good[4:],
              good[:-3], good[:10], b"\x00" * 24,
              struct.pack("<IHHiIII", 0xA1B2C3D4, 3, 0, 0, 0, 0, 101),
              struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 4, 101)
              + struct.pack("<IIII", 0, 0, 8, 8) + bytes(8)])


@pytest.mark.parametrize("kind", ["xml", "pcap"])
def test_validators_report_the_reference_problems(kind):
    for doc in _bad_documents()[kind]:
        if kind == "xml":
            assert fm.validate_flowmon_xml(doc) == \
                ref_fm.validate_flowmon_xml(doc)
        else:
            assert fm.validate_pcap(doc) == ref_fm.validate_pcap(doc)


def test_cli_flowmon_pcap_and_telemetry_modes(tmp_path, capsys):
    """``python -m tpudes_torch.obs``: --flowmon and --pcap over files the
    port writes (exit 0), a truncated capture (1), a missing file and two
    modes at once (2), and the JSON modes over the registries'
    snapshots."""
    import json

    _, cols = _stats_pair()
    xml = tmp_path / "flowmon.xml"
    fm.serialize_flow_stats_xml(
        fm.reduce_flow_stats({k: v[0] for k, v in cols.items()}), {},
        str(xml))
    cap = tmp_path / "run.pcap"
    fm.write_events_pcap(_toy_events(), str(cap))
    bad = tmp_path / "bad.pcap"
    bad.write_bytes(cap.read_bytes()[:-2])
    assert cli.main(["--flowmon", str(xml)]) == 0
    assert cli.main(["--pcap", str(cap)]) == 0
    assert "valid pcap capture (4 records)" in capsys.readouterr().out
    assert cli.main(["--pcap", str(bad)]) == 1
    assert "truncated" in capsys.readouterr().out
    assert cli.main(["--flowmon", str(tmp_path / "nope.xml")]) == 2
    assert cli.main(["--flowmon", "--pcap", str(xml)]) == 2
    port_dist.DistributedTelemetry.reset()
    port_dist.DistributedTelemetry.record_window(
        0, grant_slots=4, tx_pkts=1, rx_pkts=2, poll_wall_s=0.1,
        flush_wall_s=0.0, grant_wall_s=0.0, advance_wall_s=0.2)
    for flag, doc in (
            ("--distributed", port_dist.DistributedTelemetry.snapshot()),
            ("--geometry", port_geom.GeomTelemetry.snapshot()),
            ("--traffic", port_traffic.TrafficTelemetry.snapshot())):
        path = tmp_path / f"{flag[2:]}.json"
        path.write_text(json.dumps(doc))
        assert cli.main([flag, str(path)]) == 0, flag
        path.write_text(json.dumps({"version": 2}))
        assert cli.main([flag, str(path)]) == 1, flag
    port_dist.DistributedTelemetry.reset()


def test_device_flow_monitor_round_trips_as_the_reference(tmp_path):
    """DeviceFlowMonitor over the same columns and rings: the same stats,
    events, XML, pcap and trace-replay program as the reference's."""
    _, cols = _stats_pair()
    lane = {k: v[2] for k, v in cols.items()}
    rings = [np.array([[3, 300, 1, 1000, 1], [1, 100, 0, 1000, 1],
                       [2, 150, 1, 1000, 0], [-1, 0, 0, 0, 0]], np.int32)]
    got = fm.DeviceFlowMonitor(lane, rings)
    want = ref_fm.DeviceFlowMonitor(lane, rings)
    assert [tuple(e) for e in got.events] == [tuple(e) for e in want.events]
    for name in ("a", "b"):
        mon = got if name == "a" else want
        mon.SerializeToXmlFile(str(tmp_path / f"{name}.xml"))
        mon.WritePcap(str(tmp_path / f"{name}.pcap"))
    for ext in ("xml", "pcap"):
        assert (tmp_path / f"a.{ext}").read_bytes() == \
            (tmp_path / f"b.{ext}").read_bytes(), ext
    tp, tp_ref = got.ToTrafficProgram(), want.ToTrafficProgram()
    assert tp.model == tp_ref.model == "trace"
    for f in ("arr_t", "arr_b", "start_us", "rate_pps"):
        a, b = np.asarray(getattr(tp, f)), np.asarray(getattr(tp_ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_registries_snapshot_as_the_reference():
    """The same records into the port's and the reference's compile, stage
    and chunk registries, and into the geometry, traffic and distributed
    ones, give equal snapshots (the walls as recorded)."""
    regs = [(dev_obs.CompileTelemetry, RefCompile),
            (dev_obs.KernelProfile, RefProfile),
            (dev_obs.ChunkStream, RefChunkStream),
            (port_geom.GeomTelemetry, ref_geom.GeomTelemetry),
            (port_traffic.TrafficTelemetry, ref_traffic.TrafficTelemetry),
            (port_dist.DistributedTelemetry, ref_dist.DistributedTelemetry)]
    for ours, theirs in regs:
        ours.reset()
        theirs.reset()
    for cls in (dev_obs.CompileTelemetry, RefCompile):
        cls.record("lte_sm", 0.25)
        cls.record("lte_sm", 0.5)
        cls.record("bss", 1.0)
    for cls in (dev_obs.KernelProfile, RefProfile):
        cls.record("bss_advance", "phy", 3e-6, 512)
    for cls in (dev_obs.ChunkStream, RefChunkStream):
        cls.record("wired", 40, {"n": 1})
    for cls in (port_geom.GeomTelemetry, ref_geom.GeomTelemetry):
        cls.record_device("lte_sm", 3, 40)
        cls.record_host("lte_sm")
    for cls in (port_traffic.TrafficTelemetry, ref_traffic.TrafficTelemetry):
        cls.record("lte_sm", "onoff", offered=100.0, delivered=40.0,
                   duty=0.5)
    for cls in (port_dist.DistributedTelemetry,
                ref_dist.DistributedTelemetry):
        for rank in (0, 1):
            cls.record_window(rank, grant_slots=5 + rank, tx_pkts=2,
                              rx_pkts=rank, poll_wall_s=0.25,
                              flush_wall_s=0.0, grant_wall_s=0.125,
                              advance_wall_s=0.5)
        cls.record_transport(1, 3, 4)
    assert dev_obs.CompileTelemetry.compiles("lte_sm") == 2
    assert dev_obs.ChunkStream.entries("wired") == \
        RefChunkStream.entries("wired")
    for ours, theirs in regs:
        if hasattr(theirs, "snapshot"):
            assert ours.snapshot() == theirs.snapshot(), ours.__name__
        ours.reset()
        theirs.reset()
    assert port_geom.validate_geometry_metrics({"version": 1}) == \
        ref_geom.validate_geometry_metrics({"version": 1})
    assert port_traffic.validate_traffic_metrics({"engines": {"x": {}}}) \
        == ref_traffic.validate_traffic_metrics({"engines": {"x": {}}})
    bad = {"version": 1, "counters": {"windows": -1},
           "ranks": {"a": {"windows": 1}}}
    assert port_dist.validate_distributed_metrics(bad) == \
        ref_dist.validate_distributed_metrics(bad)
