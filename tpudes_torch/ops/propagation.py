"""Deterministic propagation loss (counterpart of ``tpudes/ops/propagation.py``).

Only Friis is ported: it is the one loss the lena default uses (Friis at
2.12 GHz, ``tpudes/models/lte/helper.py:36``).  ``jnp.log10`` is
``log(x) * (1 / ln 10)`` with the f32 constant below, and the quotient
is a true division (the reference's ``numerator / denominator``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPEED_OF_LIGHT = 299792458.0

#: the f32 constant ``jnp.log10`` multiplies ``log(x)`` by
_INV_LN10_F32 = float(np.float32(0.4342944819032518))


def friis(
    tx_power_dbm,
    d: torch.Tensor,
    frequency_hz: float = 5.15e9,
    system_loss: float = 1.0,
    min_loss_db: float = 0.0,
) -> torch.Tensor:
    """Friis free-space rx power (FriisPropagationLossModel::DoCalcRxPower):
    ``rx = tx - max(minLoss, -10 log10(lambda^2 / (16 pi^2 d^2 L)))``;
    ``d <= 0`` gives ``tx - minLoss``."""
    lam = SPEED_OF_LIGHT / frequency_hz
    numerator = torch.tensor(lam * lam, dtype=d.dtype, device=d.device)
    denominator = 16.0 * math.pi * math.pi * d * d * system_loss
    loss_db = -10.0 * (torch.log(numerator / denominator) * _INV_LN10_F32)
    loss_db = torch.clamp_min(loss_db, min_loss_db)
    return torch.where(
        d <= 0.0, tx_power_dbm - min_loss_db, tx_power_dbm - loss_db
    )
