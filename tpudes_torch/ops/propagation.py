"""Deterministic propagation loss (counterpart of ``tpudes/ops/propagation.py``).

Friis is the loss the lena default uses (Friis at 2.12 GHz,
``tpudes/models/lte/helper.py:36``); log-distance is the other loss the
device geometry stage takes.  Two arithmetics, as the reference has
them:

- eager (``friis``): the static lowering evaluates the loss op by op.
  ``jnp.log10`` is ``log(x) * (1 / ln 10)`` with the f32 constant below,
  and the quotient is a true division;
- compiled (``friis(..., fused=True)``, :func:`log_distance`,
  :func:`db_to_ratio`): the geometry stage runs under ``jit``, whose
  compiler folds ``-10 * (1 / ln 10)`` into one f32 constant, divides
  by a constant as a multiplication by its f32 reciprocal, fuses a
  product into the sum that follows it, and takes its own ``log``
  (:mod:`tpudes_torch.ops.fused`); its ``pow`` is the C library's
  ``powf``, which :func:`db_to_ratio` reproduces.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpudes_torch.ops import fused as compiled

SPEED_OF_LIGHT = 299792458.0

#: the f32 constant ``jnp.log10`` multiplies ``log(x)`` by
_INV_LN10_F32 = float(np.float32(0.4342944819032518))


def _folded(k: float) -> float:
    """``k * log10(x)`` compiled: ``log(x)`` times this f32 constant."""
    return float(np.float32(k) * np.float32(_INV_LN10_F32))


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
        loss_db = -10.0 * (torch.log(numerator / denominator) * _INV_LN10_F32)
    loss_db = torch.clamp_min(loss_db, min_loss_db)
    return torch.where(
        d <= 0.0, tx_power_dbm - min_loss_db, tx_power_dbm - loss_db
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
    x = torch.clamp_min(d, reference_distance)
    if reference_distance != 1.0:
        x = x * compiled.f32(d, 1.0 / reference_distance)
    path_loss = compiled.fma(
        compiled.log(x), compiled.f32(d, _folded(10.0 * exponent)),
        compiled.f32(d, reference_loss_db),
    )
    return tx_power_dbm - path_loss


def db_to_ratio(db: torch.Tensor) -> torch.Tensor:
    """``10 ** (db / 10)`` compiled: ``db * 0.1`` in f32, then
    ``powf(10, .)`` (:func:`~tpudes_torch.ops.fused.exp10`)."""
    return compiled.exp10(db * compiled.f32(db, 0.1))

