"""tpudes_torch.obs — the port's observability, from ``tpudes/obs``.

- the device FlowMonitor (:mod:`tpudes_torch.obs.flowmon`): with
  ``obs=True`` every engine keeps per-flow FlowStats columns and a
  packet-event ring beside its state (on the card in its kernel's
  ``OBS`` arm), reduced on the host into :class:`FlowStats`, exported
  through the ns-3 XML serializer and as pcap, or replayed as a
  trace-replay traffic program;
- compile, stage and chunk telemetry (:mod:`tpudes_torch.obs.device`);
- geometry-refresh and workload telemetry
  (:mod:`tpudes_torch.obs.geometry`, :mod:`tpudes_torch.obs.traffic`);
- the hybrid PDES window record (:mod:`tpudes_torch.obs.distributed`);
- the serving layer's metrics (:mod:`tpudes_torch.obs.serving`).

``python -m tpudes_torch.obs --flowmon flowmon.xml`` / ``--pcap out.pcap``
/ ``--distributed``, ``--geometry``, ``--traffic`` or ``--serving
metrics.json`` validate the artifacts.  Not ported: the reference's
Chrome-trace export (``tpudes/obs/export.py``) and host profiler, which
wait for a host layer of the port's own (ROADMAP A16).
"""

from tpudes_torch.obs.device import ChunkStream, CompileTelemetry, KernelProfile
from tpudes_torch.obs.distributed import (
    DistributedTelemetry,
    validate_distributed_metrics,
    wall_now,
)
from tpudes_torch.obs.flowmon import (
    DeviceFlowMonitor,
    FiveTuple,
    FlowStats,
    decode_packet_rings,
    flow_accumulate,
    flow_carry,
    flow_ring_write,
    host_reference_stats,
    reduce_flow_stats,
    serialize_flow_stats_xml,
    validate_flowmon_xml,
    validate_pcap,
    write_events_pcap,
)
from tpudes_torch.obs.geometry import GeomTelemetry, validate_geometry_metrics
from tpudes_torch.obs.schema import make_need
from tpudes_torch.obs.serving import ServingTelemetry, validate_serving_metrics
from tpudes_torch.obs.traffic import TrafficTelemetry, validate_traffic_metrics

__all__ = [
    "ChunkStream",
    "CompileTelemetry",
    "DeviceFlowMonitor",
    "DistributedTelemetry",
    "FiveTuple",
    "FlowStats",
    "GeomTelemetry",
    "KernelProfile",
    "ServingTelemetry",
    "TrafficTelemetry",
    "decode_packet_rings",
    "flow_accumulate",
    "flow_carry",
    "flow_ring_write",
    "host_reference_stats",
    "make_need",
    "reduce_flow_stats",
    "serialize_flow_stats_xml",
    "validate_distributed_metrics",
    "validate_flowmon_xml",
    "validate_geometry_metrics",
    "validate_pcap",
    "validate_serving_metrics",
    "validate_traffic_metrics",
    "wall_now",
    "write_events_pcap",
]
