"""tpudes_torch.serving — studies served on the engine runtime.

Counterpart of ``tpudes/serving/__init__.py``: a long-lived
:class:`StudyServer` accepts independently arriving studies (a program,
a key, a replica count and a device each) and coalesces compatible ones
onto shared config-axis launches; see :mod:`tpudes_torch.serving.server`
for the scheduling and :mod:`tpudes_torch.obs.serving` for the metrics.
The reference's member processes (``serving/distributed.py``:
``ProcessRouter``, ``serve_studies``) wait for A12.

    from tpudes_torch.serving import StudyServer

    server = StudyServer(max_wait_s=0.005, max_batch=8)
    handles = [
        server.submit_study("lte_sm", prog, key, replicas=64,
                            tenant=f"user{i}", device="cuda")
        for i, prog in enumerate(programs)      # e.g. four schedulers
    ]
    results = [h.result() for h in handles]     # one per study
    server.close()
"""

from tpudes_torch.parallel.checkpoint import CarryCheckpoint, CheckpointError
from tpudes_torch.serving.descriptor import StudyDescriptor, mesh_fingerprint
from tpudes_torch.serving.errors import MemberLostError, RetryBudgetError
from tpudes_torch.serving.server import (
    SLO_CLASSES,
    AdmissionError,
    StudyHandle,
    StudyServer,
)

__all__ = [
    "SLO_CLASSES",
    "AdmissionError",
    "CarryCheckpoint",
    "CheckpointError",
    "MemberLostError",
    "RetryBudgetError",
    "StudyDescriptor",
    "StudyHandle",
    "StudyServer",
    "mesh_fingerprint",
]
