"""tpudes_torch — the PyTorch/CUDA port of tpudes' device engines.

The JAX package ``tpudes`` is the reference; this package sits beside it
and imports nothing from it (nor JAX).  Constants and tables it needs
from the reference are copied, each copy naming its source.

The engines: the LTE SM engine
(:func:`tpudes_torch.parallel.lte_sm.run_lte_sm`, kernels
``csrc/lte_sm_advance.cu`` and ``csrc/lte_sm_step.cu``), the WiFi BSS
replica engine (:func:`tpudes_torch.parallel.replicated.
run_replicated_bss`, ``csrc/bss_advance.cu``), the TCP dumbbell
(:func:`tpudes_torch.parallel.tcp_dumbbell.run_tcp_dumbbell`,
``csrc/tcp_advance.cu``), the fused WiFi PHY window
(:mod:`tpudes_torch.parallel.kernels`, ``csrc/wifi_window.cu``), the AS
flow engine (:func:`run_as_flows`, ``csrc/as_flows.cu``) and the wired
engine with the hybrid PDES over it (``csrc/wired_advance.cu``).  They
run on the engine runtime (:mod:`tpudes_torch.parallel.runtime`: runner
cache, replica buckets, submitted runs, the chunk drive and
:mod:`~tpudes_torch.parallel.checkpoint`), and
:class:`tpudes_torch.serving.StudyServer` serves studies over them.

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``; without CUDA they raise rather than fall back.
"""

from tpudes_torch.device import resolve_device

__all__ = ["resolve_device", "run_as_flows"]


def __getattr__(name: str):
    # the engine is imported when first asked for, not with the package
    if name == "run_as_flows":
        from tpudes_torch.parallel.as_flows import run_as_flows

        return run_as_flows
    raise AttributeError(f"module 'tpudes_torch' has no attribute {name!r}")
