"""tpudes_torch — the PyTorch/CUDA port of tpudes' device engines.

The JAX package ``tpudes`` is the reference; this package sits beside it
and imports nothing from it (nor JAX).  Constants and tables it needs
from the reference are copied, each copy naming its source.

Slice 1 covers the static full-buffer LTE SM engine
(:func:`tpudes_torch.parallel.lte_sm.run_lte_sm`) with its fused per-TTI
step as a hand-written CUDA kernel (``csrc/lte_sm_step.cu``).

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``; without CUDA they raise rather than fall back.
"""

from tpudes_torch.device import resolve_device

__all__ = ["resolve_device"]
