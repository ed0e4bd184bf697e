"""LTE link tables and the f32 SINR -> CQI -> MCS -> MI -> BLER chain.

Counterpart of ``tpudes/ops/lte.py``; the tables and constants are
copies of its lines 39-92 (3GPP TS 36.211/36.213 public values, the
LENA PiroEW2010 SNR gap, the Gaussian-waterfall error model).  The f32
path and the bf16 one (``dtype=jnp.bfloat16``) are ported, and the
surrogate seams of the differentiable chain (``surrogate=`` of
:func:`cqi_from_sinr`, :func:`eff_from_sinr`, :func:`qm_from_eff`,
:func:`decode_ok`; ``:148-248``), whose arithmetic is the jitted chain's
(:func:`se_compiled`) and differentiable
(:mod:`tpudes_torch.ops.fused_grad`).

The arithmetic follows what the reference computes, which is not always
its source text: ``jnp.log2`` is ``log(x) / log(2)`` compiled, and XLA
turns a division by a constant inside a compiled function into a
multiplication by the f32 reciprocal.  So the CQI chain (run op by op
in ``build_sm_consts``) divides by ``SNR_GAP`` but multiplies by
``1/ln 2``, and the BLER argument (inside the compiled step) multiplies
by ``1/sqrt 2``.  A divisor is always a tensor on the operand's device:
PyTorch's CUDA division by a host scalar is a reciprocal multiply.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpudes_torch.ops import fused as compiled
from tpudes_torch.ops import fused_grad as dmath

RB_BANDWIDTH_HZ = 180e3          # 12 subcarriers x 15 kHz
RE_PER_RB_DATA = 120.0           # ~168 REs/RB/TTI minus PDCCH + RS overhead
BOLTZMANN_T = 1.380649e-23 * 290.0

#: TS 36.213 Table 7.2.3-1: CQI index -> spectral efficiency (bits/RE)
CQI_EFFICIENCY = [
    0.0, 0.1523, 0.2344, 0.3770, 0.6016, 0.8770, 1.1758, 1.4766,
    1.9141, 2.4063, 2.7305, 3.3223, 3.9023, 4.5234, 5.1152, 5.5547,
]

#: per-MCS spectral efficiency (bits/RE), MCS 0-28; Qm 2/4/6
MCS_EFFICIENCY = [
    0.1523, 0.1943, 0.2344, 0.3008, 0.3770, 0.4385, 0.5879, 0.7402,
    0.9023, 1.0273,
    1.1758, 1.3262, 1.4766, 1.6953, 1.9141, 2.1602, 2.4063,
    2.5703, 2.7305, 3.0293, 3.3223, 3.6094, 3.9023, 4.2129, 4.5234,
    4.8193, 5.1152, 5.3320, 5.5547,
]
MCS_QM = [2.0] * 10 + [4.0] * 7 + [6.0] * 12
MCS_ECR = [e / q for e, q in zip(MCS_EFFICIENCY, MCS_QM)]

#: LENA CQI mapping SNR gap -ln(5 BER)/1.5 at target BER 5e-5
SNR_GAP = -math.log(5.0 * 5e-5) / 1.5

#: Gaussian-waterfall dispersion and the 10 % first-tx BLER quantile
BLER_DISPERSION = 1.4
BLER_TARGET_Q = 1.281551

_CQI_EFF = np.array(CQI_EFFICIENCY, dtype=np.float32)
_MCS_EFF = np.array(MCS_EFFICIENCY, dtype=np.float32)
_MCS_QM = np.array(MCS_QM, dtype=np.float32)
_MCS_ECR = np.array(MCS_ECR, dtype=np.float32)
#: CQI -> highest MCS whose efficiency does not exceed the CQI's
_CQI_TO_MCS = np.array(
    [
        max([m for m in range(29) if MCS_EFFICIENCY[m] <= CQI_EFFICIENCY[c]] or [0])
        for c in range(16)
    ],
    dtype=np.int32,
)

#: f32 reciprocals of the constant divisors XLA rewrites (see docstring)
INV_LN2_F32 = float(np.float32(1.0) / np.log(np.float32(2.0)))
INV_SQRT2_F32 = float(np.float32(1.0) / np.float32(math.sqrt(2.0)))
INV_SNR_GAP_F32 = float(np.float32(1.0) / np.float32(SNR_GAP))


#: the SNR gap as a bf16 divisor, and the f32 reciprocal of that which
#: the jitted geometry stage multiplies by
SNR_GAP_BF16 = float(torch.tensor(SNR_GAP).to(torch.bfloat16).float())
INV_SNR_GAP_BF16_F32 = float(np.float32(1.0) / np.float32(SNR_GAP_BF16))


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to the nearest bf16 (ties to even) and widened back."""
    return x.to(torch.bfloat16).float()


def noise_psd_w(noise_figure_db: float) -> float:
    """Thermal noise PSD (W/Hz) at the given receiver noise figure."""
    return float(10.0 ** (noise_figure_db / 10.0) * BOLTZMANN_T)


def f32_const(like: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-dim f32 tensor on ``like``'s device (a true divisor on CUDA)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def gapped_log2(sinr: torch.Tensor, fused: bool = False,
                bf16: bool = False) -> torch.Tensor:
    """log2(1 + sinr / SNR_GAP) in f32, the gapped Shannon efficiency,
    in the reference's arithmetic: op by op (``build_sm_consts``), or
    compiled (``fused``, the geometry stage); ``bf16`` for
    ``precision="bf16"``:

    - op by op, every operation rounded (``b`` is :func:`round_bf16`):
      ``y = b(1 + b(b(sinr) / b(SNR_GAP)))``;
    - compiled (its optimised HLO: the division is a multiplication by
      the f32 reciprocal of ``b(SNR_GAP)``, rounded, and the ``+ 1`` is
      not rounded): ``y = b(b(sinr) * (1 / b(SNR_GAP))) + 1``.
    """
    if bf16:
        x = round_bf16(sinr)
        if fused:
            y = round_bf16(x * compiled.f32(x, INV_SNR_GAP_BF16_F32)) + 1.0
        else:
            y = round_bf16(1.0 + round_bf16(x / f32_const(x,
                                                          SNR_GAP_BF16)))
    elif fused:
        one = compiled.f32(sinr, 1.0)
        y = compiled.fma(sinr, compiled.f32(sinr, INV_SNR_GAP_F32), one)
    else:
        y = 1.0 + sinr / f32_const(sinr, SNR_GAP)
    return compiled.log(y) * INV_LN2_F32


def cqi_from_efficiency(se: torch.Tensor) -> torch.Tensor:
    """Wideband CQI (int32): the highest CQI whose efficiency the gapped
    Shannon efficiency ``se`` supports (lte-amc PiroEW2010 mapping)."""
    eff = compiled.device_table(_CQI_EFF, se.device)
    hit = (eff <= se[..., None]) & (eff > 0.0)
    return hit.sum(dim=-1, dtype=torch.int32)


def se_compiled(sinr: torch.Tensor) -> torch.Tensor:
    """``log2(1 + sinr / SNR_GAP)`` as a jitted chain computes it (the
    differentiable chain's optimised HLO): ``log(fma(sinr, 1 / SNR_GAP,
    1))`` times the f32 ``1 / ln 2``, differentiable."""
    y = compiled.fma(sinr, compiled.f32(sinr, INV_SNR_GAP_F32),
                     compiled.f32(sinr, 1.0))
    return dmath.log(y) * compiled.f32(sinr, INV_LN2_F32)


def cqi_from_sinr(sinr: torch.Tensor, bf16: bool = False,
                  surrogate=None) -> torch.Tensor:
    """Wideband CQI (``lte.py:148``): op by op (``build_sm_consts``), f32
    or bf16.  With a ``surrogate`` (duck-typed :class:`~tpudes_torch.diff.
    Surrogacy`; the compiled arithmetic, :func:`se_compiled`) the 15-step
    comparison staircase becomes its sigmoid sum at ``surrogate.temp`` and
    the result is f32 (the soft index, or the hard one
    straight-through)."""
    if surrogate is None:
        return cqi_from_efficiency(gapped_log2(sinr, bf16=bf16))
    return cqi_and_eff(se_compiled(sinr), surrogate)[0]


def cqi_and_eff(se: torch.Tensor, surrogate) -> tuple:
    """``(cqi, eff)`` from the compiled efficiency ``se``: the wideband
    CQI (f32; int32 without a surrogate) and the granted quantised
    efficiency of :func:`eff_from_sinr`.  Under a surrogate both sum the
    same 15 soft steps (the compiler computes them once)."""
    hard_eff = _hard_staircase(se, _CQI_EFF[1:], _CQI_STEPS)
    cqi = cqi_from_efficiency(se)
    if surrogate is None:
        return cqi, hard_eff
    from tpudes_torch.diff.surrogate import soft_steps, staircase_sum

    steps = soft_steps(se, _CQI_EFF[1:], surrogate.temp)
    return (surrogate.blend(cqi.to(torch.float32),
                            staircase_sum(steps, np.ones(15, np.float32))),
            surrogate.blend(hard_eff, staircase_sum(steps, _CQI_STEPS)))


def _hard_staircase(x: torch.Tensor, edges: np.ndarray,
                    steps: np.ndarray) -> torch.Tensor:
    """``sum_k steps[k] 1[x >= edges[k]]`` in f32, in ``k`` order from 0."""
    e = compiled.const_table(edges, x)
    terms = compiled.const_table(steps, x) * (
        x[..., None] >= e).to(torch.float32)
    out = terms[..., 0]
    for k in range(1, edges.size):
        out = out + terms[..., k]
    return out


#: the CQI ladder's steps, ``CQI_EFFICIENCY[k + 1] - CQI_EFFICIENCY[k]``
_CQI_STEPS = _CQI_EFF[1:] - _CQI_EFF[:-1]
#: the modulation-order ladder's anchors (``lte.py:210``): the granted
#: efficiency at which Qm steps 2 -> 4 and 4 -> 6
_QM_EDGES = np.array([MCS_EFFICIENCY[10], MCS_EFFICIENCY[17]],
                     dtype=np.float32)
_QM_STEPS = np.array([2.0, 2.0], np.float32)


def eff_from_sinr(sinr: torch.Tensor, surrogate=None) -> torch.Tensor:
    """Quantised spectral efficiency the CQI ladder grants
    (``lte.py:188``): ``sum_k step_k 1[se >= CQI_EFFICIENCY[k + 1]]``, or
    its soft staircase under ``surrogate``; compiled arithmetic."""
    return cqi_and_eff(se_compiled(sinr), surrogate)[1]


def qm_from_eff(eff: torch.Tensor, surrogate=None) -> torch.Tensor:
    """Modulation order from the granted efficiency (``lte.py:213``): the
    2 / 4 / 6 staircase at :data:`_QM_EDGES`, or its soft staircase."""
    two = compiled.f32(eff, 2.0)
    hard = _hard_staircase(eff, _QM_EDGES, _QM_STEPS) + two
    if surrogate is None:
        return hard
    from tpudes_torch.diff.surrogate import soft_staircase

    soft = soft_staircase(eff, _QM_EDGES, _QM_STEPS, surrogate.temp) + two
    return surrogate.blend(hard, soft)


def decode_ok(coin: torch.Tensor, bler: torch.Tensor,
              surrogate=None) -> torch.Tensor:
    """TB decode indicator (``lte.py:232``): ``coin >= bler`` (bool), or
    its sigmoid at ``surrogate.gate_temp`` blended with it (f32)."""
    if surrogate is None:
        return coin >= bler
    from tpudes_torch.diff.surrogate import soft_sigmoid

    hard = (coin >= bler).to(torch.float32)
    return surrogate.blend(hard, soft_sigmoid(coin - bler,
                                              surrogate.gate_temp))


def mcs_from_cqi(cqi: torch.Tensor) -> torch.Tensor:
    return compiled.device_table(_CQI_TO_MCS, cqi.device)[cqi.long()]


def mi_from_efficiency(se: torch.Tensor, qm: torch.Tensor) -> torch.Tensor:
    """Normalised per-RB mutual information in [0, 1]: the gapped Shannon
    capacity ``se`` capped at the modulation order."""
    return torch.minimum(se, qm) / qm


def mi_per_rb(sinr: torch.Tensor, qm: torch.Tensor,
              bf16: bool = False) -> torch.Tensor:
    """Op-by-op per-RB MI (``build_sm_consts``), f32 or bf16."""
    return mi_from_efficiency(gapped_log2(sinr, bf16=bf16), qm)


def tb_bler_ecr(
    mi_eff: torch.Tensor, ecr: torch.Tensor, tb_bits: torch.Tensor,
    bf16: bool = False, fused: bool = False,
) -> torch.Tensor:
    """TB block-error rate from effective MI on a pre-gathered code
    rate: Gaussian waterfall with finite-blocklength dispersion and the
    margin that gives 10 % BLER at MI = code rate.  ``bf16``: the
    waterfall argument as the jitted step's optimised HLO computes it,
    ``z = b(b(mi) - b(ecr - margin)) / b(sigma)`` (``b`` is
    :func:`round_bf16`) with the quotient in f32 and not rounded.
    ``fused``: as the jitted differentiable chain computes it (its
    optimised HLO), differentiable: ``sigma = 1.4 rsqrt(max(tb, 24))``,
    ``z`` over ``sigma``, the compiled ``erfc`` of ``z`` times the f32
    ``1 / sqrt 2``, clipped to ``[0, 1]`` (the clamps split the gradient
    at a tie, as ``jnp.maximum`` and ``jnp.clip`` do)."""
    if fused:
        sigma = compiled.f32(tb_bits, BLER_DISPERSION) * dmath.rsqrt(
            dmath.maximum(tb_bits, 24.0))
        margin = sigma * compiled.f32(sigma, BLER_TARGET_Q)
        z = (mi_eff - (ecr - margin)) / sigma
        return dmath.clip(
            dmath.erfc(z * compiled.f32(z, INV_SQRT2_F32))
            * compiled.f32(z, 0.5), 0.0, 1.0)
    sigma = f32_const(tb_bits, BLER_DISPERSION) / compiled.sqrt(
        torch.clamp_min(tb_bits, 24.0)
    )
    margin = BLER_TARGET_Q * sigma
    if bf16:
        b = round_bf16
        z = b(b(mi_eff) - b(ecr - margin)) / b(sigma)
    else:
        z = (mi_eff - (ecr - margin)) / sigma
    return torch.clamp(0.5 * torch.special.erfc(z * INV_SQRT2_F32), 0.0, 1.0)
