"""Autograd rules for the compiled f32 functions of :mod:`~tpudes_torch.ops.fused`.

The compiled functions read a float's bits (``log``), build ``2**n`` from
bits (``exp``) or evaluate the reference compiler's polynomials
(``log1p``, ``erfc``, glibc's ``powf`` for ``10 ** x``).  Autograd cannot
pass through the bit reads, and through the polynomials it would
differentiate the polynomial, not the function.  Each function the
differentiable engines reach is wrapped here in a
:class:`torch.autograd.Function`: the forward is the compiled one,
unchanged (so the forwards stay bit-equal to the engines'), and the
backward is the reference's rule as ``jax.value_and_grad`` states it:

- ``exp``: ``g y``; ``log``: ``g / x``; ``log1p``: ``g / (x + 1)``;
- ``erfc``: ``-2 / sqrt(pi) g exp(-x^2)``;
- ``10 ** x`` (``power``): ``g (ln 10 y)``, ``ln 10`` the f32 ``log(10)``;
- ``sqrt``: ``g (0.5 / y)``; ``rsqrt``: ``g (-0.5 (y / x))``;
- ``logistic`` (``jax.nn.sigmoid``, which the compiler expands to ``1 /
  (exp(-x) + 1)``): ``g (y (1 - y))``;
- ``softplus`` (``jnp.logaddexp(x, 0)``: ``max(x, 0) + log1p(exp(-|x|))``
  in the forward): the custom rule ``g exp(x - y)``.

``maximum`` / ``minimum`` / ``clip`` take :func:`torch.maximum` and
:func:`torch.minimum` against a constant tensor, whose backward splits the
gradient half and half at a tie, as ``jnp.maximum`` / ``jnp.minimum`` do
(``jnp.clip`` is ``min(max(x, lo), hi)``); ``torch.clamp`` would pass all
of it at the bound.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpudes_torch.ops import fused as compiled

__all__ = ["clip", "erfc", "exp", "exp10", "log", "log1p", "logistic",
           "maximum", "minimum", "rsqrt", "softplus", "sqrt"]

#: ``log(10)`` and ``-2 / sqrt(pi)`` in f32, the rules' constants
_LN10 = float(np.float32(math.log(10.0)))
_ERFC_K = float(np.float32(-2.0 / math.sqrt(math.pi)))


class _Exp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = compiled.exp(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


class _Log(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return compiled.log(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / x


class _Log1p(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return compiled.log1p(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / (x + 1.0)


class _Erfc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return compiled.erfc(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return compiled.f32(x, _ERFC_K) * (g * compiled.exp(-(x * x)))


class _Exp10(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = compiled.exp10(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (compiled.f32(y, _LN10) * y)


class _Sqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = compiled.sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (0.5 / y)


class _Rsqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = (1.0 / torch.sqrt(x.double())).float()
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * (-0.5 * (y / x))


class _Logistic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (compiled.exp(-x) + 1.0)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1.0 - y))


class _Softplus(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        zero = compiled.f32(x, 0.0)
        y = torch.maximum(x, zero) + compiled.log1p(
            compiled.exp(-torch.abs(x)))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * compiled.exp(x - y)


def exp(x: torch.Tensor) -> torch.Tensor:
    """:func:`~tpudes_torch.ops.fused.exp` with the rule ``g y``."""
    return _Exp.apply(x)


def log(x: torch.Tensor) -> torch.Tensor:
    """:func:`~tpudes_torch.ops.fused.log` with the rule ``g / x``."""
    return _Log.apply(x)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """:func:`~tpudes_torch.ops.fused.log1p` with the rule ``g / (x + 1)``."""
    return _Log1p.apply(x)


def erfc(x: torch.Tensor) -> torch.Tensor:
    """:func:`~tpudes_torch.ops.fused.erfc` with the rule ``-2 / sqrt(pi)
    g exp(-x^2)``."""
    return _Erfc.apply(x)


def exp10(x: torch.Tensor) -> torch.Tensor:
    """``10 ** x`` (:func:`~tpudes_torch.ops.fused.exp10`) with the rule
    ``g (ln 10 y)``."""
    return _Exp10.apply(x)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded root with the rule ``g (0.5 / y)``."""
    return _Sqrt.apply(x)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(x)`` rounded once to f32 (in f64, then rounded), with the
    rule ``g (-0.5 (y / x))``.  The reference's CPU backend takes the
    processor's reciprocal-root estimate and a Newton step, which lands
    on this value on every operand the tests reach, and on two roundings
    (``1 / sqrtf(x)``) on about two thirds of them."""
    return _Rsqrt.apply(x)


def logistic(x: torch.Tensor) -> torch.Tensor:
    """``1 / (exp(-x) + 1)`` with the compiled ``exp`` and the rule
    ``g (y (1 - y))``."""
    return _Logistic.apply(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0) + log1p(exp(-|x|))`` compiled, with the rule ``g exp(x
    - y)``."""
    return _Softplus.apply(x)


def maximum(x: torch.Tensor, value) -> torch.Tensor:
    """``max(x, value)``, the gradient split at a tie."""
    return torch.maximum(x, compiled.f32(x, value))


def minimum(x: torch.Tensor, value) -> torch.Tensor:
    """``min(x, value)``, the gradient split at a tie."""
    return torch.minimum(x, compiled.f32(x, value))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``min(max(x, lo), hi)``."""
    return minimum(maximum(x, lo), hi)
