"""Smooth surrogates for the engines' hard decision points.

Counterpart of ``tpudes/diff/surrogate.py``.  The engines are full of
quantizers (the CQI ladder, the modulation-order ladder, the eligibility
threshold, the AS delivery min-gate): exact for simulation, with a zero or
undefined derivative almost everywhere.  :class:`Surrogacy` swaps them
for temperature-controlled soft versions.  It is a runner-cache key
component, never an operand: a temperature or ``ste`` flip selects other
arithmetic.

Two blends:

- ``ste=False``: the forward value is the soft version;
- ``ste=True``: straight-through, ``hard + (soft - soft.detach())``: the
  forward is the hard expression bit for bit (the correction is an exact
  float zero where ``soft`` is finite), and the backward differentiates
  ``soft``.

``ops/`` and ``parallel/`` take the surrogate duck-typed (any object with
``temp``, ``gate_temp``, ``ste`` and ``blend``).  The soft step is
``sigmoid(x / temp)``, which the reference compiler computes as ``1 /
(exp(-(x * (1 / temp))) + 1)``: the division by the constant temperature
becomes a product with its f32 reciprocal
(:func:`~tpudes_torch.ops.fused_grad.logistic`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpudes_torch.ops import fused as compiled
from tpudes_torch.ops import fused_grad as dmath

__all__ = ["Surrogacy", "soft_sigmoid", "soft_staircase", "soft_steps",
           "staircase_sum", "ste"]


def ste(hard: torch.Tensor, soft: torch.Tensor) -> torch.Tensor:
    """Straight-through blend: forward ``hard`` (``soft - soft.detach()``
    adds an exact zero), backward ``d(soft)`` plus the hard path's own
    (zero almost everywhere) cotangent."""
    return hard + (soft - soft.detach())


def _inv(temp: float) -> float:
    """The f32 reciprocal of the f32 temperature (the compiled divide)."""
    return float(np.float32(1.0) / np.float32(temp))


def soft_sigmoid(x: torch.Tensor, temp: float) -> torch.Tensor:
    """``sigmoid(x / temp)`` in f32, compiled: ``x`` times the f32
    ``1 / temp``, then the logistic."""
    return dmath.logistic(x * compiled.f32(x, _inv(temp)))


def soft_steps(x: torch.Tensor, edges, temp: float) -> torch.Tensor:
    """``sigmoid((x[..., None] - edges) / temp)``, ``(..., K)``: the soft
    steps of a staircase (the compiler adds the negated edge); ``x``'s
    cotangent summed over the K steps in a fixed order."""
    from tpudes_torch.diff.graphs import broadcast

    neg = compiled.const_table(-np.asarray(edges, np.float32), x)
    wide = broadcast(x[..., None], (*x.shape, neg.shape[0]))
    return soft_sigmoid(wide + neg, temp)


def staircase_sum(steps: torch.Tensor, heights) -> torch.Tensor:
    """``sum_k heights[k] steps[..., k]`` in ``k`` order from 0, each
    height's product fused into the sum (``fma(h, s, acc)``) as the
    compiler reduces it; a height of 1 is dropped."""
    h = np.asarray(heights, np.float32)
    if (h == 1.0).all():
        out = steps[..., 0]
        for k in range(1, h.size):
            out = out + steps[..., k]
        return out
    hk = compiled.const_table(h, steps)
    out = hk[0] * steps[..., 0]
    for k in range(1, h.size):
        out = compiled.fma(hk[k], steps[..., k], out)
    return out


def soft_staircase(x: torch.Tensor, edges, heights,
                   temp: float) -> torch.Tensor:
    """``sum_k heights[k] sigmoid((x - edges[k]) / temp)``, the smooth
    ``sum_k heights[k] 1[x >= edges[k]]`` (:func:`soft_steps`,
    :func:`staircase_sum`)."""
    return staircase_sum(soft_steps(x, edges, temp), heights)


@dataclass(frozen=True)
class Surrogacy:
    """Temperature config of the soft surrogates (``surrogate.py:86``):
    ``temp`` the staircases' (spectral-efficiency / CQI units),
    ``gate_temp`` the gates' (log-utilisation units), ``ste``
    straight-through."""

    temp: float = 0.08
    gate_temp: float = 0.25
    ste: bool = False

    def key(self) -> tuple:
        """The runner-cache key component."""
        return ("surrogacy", float(self.temp), float(self.gate_temp),
                bool(self.ste))

    def blend(self, hard: torch.Tensor, soft: torch.Tensor) -> torch.Tensor:
        """The hard expression and its soft twin, per ``ste``."""
        return ste(hard, soft) if self.ste else soft

    def step(self, x: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
        """Soft ``1[x >= threshold]`` at ``gate_temp``, blended with the
        hard comparison."""
        hard = (x >= compiled.f32(x, threshold)).to(torch.float32)
        soft = soft_sigmoid(x + compiled.f32(x, -float(np.float32(threshold))),
                            self.gate_temp)
        return self.blend(hard, soft)
