"""tpudes_torch.obs — the port's observability: for now the serving
layer's metrics (:mod:`tpudes_torch.obs.serving`, from
``tpudes/obs/serving.py``).  The device side of ``tpudes/obs`` (the
FlowMonitor columns, compile and chunk telemetry, the distributed
record) is ROADMAP A10.
"""

from tpudes_torch.obs.schema import make_need
from tpudes_torch.obs.serving import ServingTelemetry, validate_serving_metrics

__all__ = ["ServingTelemetry", "make_need", "validate_serving_metrics"]
