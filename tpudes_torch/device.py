"""Device selection for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA request without CUDA raises:
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(array, device, dtype=None) -> torch.Tensor:
    """``array`` (numpy, a sequence or a tensor) as a tensor on
    ``device``.  A copy from host memory is issued non-blocking: a
    pageable buffer is staged at once and the call does not wait for the
    work queued on the card's stream, so a run submitted behind queued
    work does not block on it (a blocking copy synchronises the stream)."""
    if not isinstance(array, torch.Tensor):
        array = torch.as_tensor(np.asarray(array))
    if dtype is not None:
        array = array.to(dtype)
    return array.to(device, non_blocking=True)
