"""Deterministic propagation loss (counterpart of ``tpudes/ops/propagation.py``).

Friis is the loss the lena default uses (Friis at 2.12 GHz,
``tpudes/models/lte/helper.py:36``); log-distance is the other loss the
device geometry stage takes.  Two arithmetics, as the reference has
them:

- eager (``friis``): the static lowering evaluates the loss op by op.
  ``jnp.log10`` is ``log(x) * (1 / ln 10)`` with ``fused._INV_LN10``,
  and the quotient is a true division;
- compiled (``friis(..., fused=True)``, :func:`log_distance`,
  :func:`db_to_ratio`, :func:`pairwise_distance`, :func:`dbm_to_w`): the
  geometry stage runs under ``jit``, whose compiler folds ``-10 * (1 /
  ln 10)`` into one f32 constant, divides by a constant as a
  multiplication by its f32 reciprocal, fuses a product into the sum
  that follows it, and takes its own ``log``
  (:mod:`tpudes_torch.ops.fused`); its ``pow`` is the C library's
  ``powf``, which :func:`db_to_ratio` reproduces.

The mobile BSS step (``tpudes/parallel/replicated.py:654-672``) was read
from its optimised HLO on the CPU: the squared distance is a reduction
whose terms fuse into its sum, ``d0 d0`` then ``fma(d1, d1, .)`` then
``fma(d2, d2, .)``; the loss is ``fma(log(max(d, 1)), 10 n / ln 10,
L0)``; and ``10 ** ((tx - loss - 30) / 10)`` becomes ``powf(10, ((tx -
30) - loss) * 0.1)``, the compiler folding the two constants ``tx`` and
``30`` into one and dividing by 10 as a product with ``0.1``; the HLO
keeps ``power`` (glibc's ``powf``, :func:`~tpudes_torch.ops.fused.exp10`),
not ``exp(x ln 10)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpudes_torch.ops import fused as compiled

SPEED_OF_LIGHT = 299792458.0


def _folded(k: float) -> float:
    """``k * log10(x)`` compiled: ``log(x)`` times this f32 constant."""
    return float(np.float32(k) * np.float32(compiled._INV_LN10))


def friis(
    tx_power_dbm,
    d: torch.Tensor,
    frequency_hz: float = 5.15e9,
    system_loss: float = 1.0,
    min_loss_db: float = 0.0,
    *,
    fused: bool = False,
) -> torch.Tensor:
    """Friis free-space rx power (FriisPropagationLossModel::DoCalcRxPower):
    ``rx = tx - max(minLoss, -10 log10(lambda^2 / (16 pi^2 d^2 L)))``;
    ``d <= 0`` gives ``tx - minLoss``.  ``fused`` takes the compiled
    arithmetic (f32 ``d`` only)."""
    lam = SPEED_OF_LIGHT / frequency_hz
    numerator = torch.full((), lam * lam, dtype=d.dtype, device=d.device)
    if fused:
        den = (compiled.f32(d, 16.0 * math.pi * math.pi) * d) * d
        den = den * compiled.f32(d, system_loss)
        loss_db = compiled.log(numerator / den) * compiled.f32(d, _folded(-10.0))
    else:
        denominator = 16.0 * math.pi * math.pi * d * d * system_loss
        loss_db = -10.0 * (torch.log(numerator / denominator) * compiled._INV_LN10)
    loss_db = torch.clamp_min(loss_db, min_loss_db)
    return torch.where(
        d <= 0.0, tx_power_dbm - min_loss_db, tx_power_dbm - loss_db
    )


def log_distance_loss(
    d: torch.Tensor,
    exponent: float = 3.0,
    reference_distance: float = 1.0,
    reference_loss_db: float = 46.6777,
) -> torch.Tensor:
    """The log-distance path loss in dB, compiled arithmetic: ``L0 + 10
    n log10(max(d, d0) / d0)``, the product fused into the sum."""
    x = torch.clamp_min(d, reference_distance)
    if reference_distance != 1.0:
        x = x * compiled.f32(d, 1.0 / reference_distance)
    return compiled.fma(
        compiled.log(x), compiled.f32(d, _folded(10.0 * exponent)),
        compiled.f32(d, reference_loss_db),
    )


def log_distance(
    tx_power_dbm,
    d: torch.Tensor,
    exponent: float = 3.0,
    reference_distance: float = 1.0,
    reference_loss_db: float = 46.6777,
) -> torch.Tensor:
    """Log-distance loss (LogDistancePropagationLossModel), compiled
    arithmetic: ``rx = tx - (L0 + 10 n log10(max(d, d0) / d0))``."""
    return tx_power_dbm - log_distance_loss(d, exponent, reference_distance,
                                            reference_loss_db)


def pairwise_distance(pos: torch.Tensor) -> torch.Tensor:
    """``(..., N, 3)`` f32 positions to the ``(..., N, N)`` distances,
    compiled arithmetic: ``sqrt(fma(dz, dz, fma(dy, dy, dx dx)))``, the
    root correctly rounded (the matrix is symmetric bit for bit)."""
    diff = pos[..., :, None, :] - pos[..., None, :, :]
    dx, dy, dz = diff.unbind(-1)
    ss = compiled.fma(dz, dz, compiled.fma(dy, dy, dx * dx))
    return compiled.sqrt(ss)


def dbm_to_w(tx_power_dbm: float, loss_db: torch.Tensor) -> torch.Tensor:
    """The rx power in W of a ``tx_power_dbm`` transmitter behind
    ``loss_db``, ``10 ** ((tx - loss - 30) / 10)`` as the compiled step
    computes it: ``powf(10, ((tx - 30) - loss) * 0.1)``, ``tx - 30`` one
    f32 constant."""
    tx30 = float(np.float32(tx_power_dbm) - np.float32(30.0))
    return compiled.exp10((compiled.f32(loss_db, tx30) - loss_db)
                          * compiled.f32(loss_db, 0.1))


def db_to_ratio(db: torch.Tensor) -> torch.Tensor:
    """``10 ** (db / 10)`` compiled: ``db * 0.1`` in f32, then
    ``powf(10, .)`` (:func:`~tpudes_torch.ops.fused.exp10`)."""
    return compiled.exp10(db * compiled.f32(db, 0.1))

