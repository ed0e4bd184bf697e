"""``grad_lte_sm``: KPI gradients through the LTE SINR -> CQI -> MI -> BLER chain.

Counterpart of ``tpudes/diff/lte_grad.py``.  The full-buffer SM engine's
TTI is an integer machine (CQI gathers, decode coins, HARQ), and under
RLC saturation its per-TTI expectation is closed form: static (or
operand) interference geometry, schedulers that degenerate to weighted
fair shares, and a decode coin whose expectation is ``1 - BLER``.  This
module builds that expectation from the port's LTE ops
(:func:`~tpudes_torch.ops.lte.cqi_and_eff`, ``qm_from_eff``,
``tb_bler_ecr``), a :class:`~tpudes_torch.diff.
Surrogacy` smoothing the CQI / efficiency staircase, the modulation-order
ladder and the eligibility threshold, and takes its gradient with
``torch.autograd`` w.r.t. propagation parameters, tx powers, eNB and UE
positions and per-UE scheduler weights.

The arithmetic is the reference's jitted chain as its CPU backend
compiles it (the optimised HLO): the squared distance ``fma(dz, dz,
fma(dy, dy, dx dx))`` and its correctly rounded root; log-distance
``fma(log(max(d, d0) / d0), n (10 / ln 10), L0)`` with ``d0 = max(d0,
1e-3)``; Friis ``log(lambda^2 / (((16 pi^2 d) d) L)) (-10 / ln 10)``,
``lambda = c / max(f, 1)``, ``L = max(L, 1e-6)``; the power ``10 ** ((p -
30) 0.1)`` and ``10 ** (clip(rx, -250, 50) 0.1)`` by glibc's ``powf``;
the noise-normalised power a product with the one folded f32 constant
``(1 / (n_rb 180 kHz)) (1 / N0)``; the cell sums in cell order; ``se =
log(fma(sinr, 1 / gap, 1)) (1 / ln 2)``; the sigmoids ``1 / (exp(-(x (1
/ t))) + 1)``; ``w = fma(sched_w, elig, 1e-6)``; the BLER of
:func:`~tpudes_torch.ops.lte.tb_bler_ecr` (``fused``).  Every clamp
splits its gradient at a tie, as ``jnp.maximum`` does; each broadcast
operand sums its cotangent in a fixed order
(:func:`~tpudes_torch.diff.graphs.broadcast`), so the card's gradients
equal the CPU's.

Differentiable operands (``params``): ``tx_power_dbm`` (E,), ``ue_pos``
(U, 3) and ``enb_pos`` (E, 3) and ``ploss`` (3,) on a positional program
(``prog.pathloss``), ``sched_w`` (U,).  On the card a call is one
CUDA-graph replay (:class:`~tpudes_torch.diff.graphs.GraphCall`); a batch
runs its points one after another inside it, so each equals a solo call
bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["LTE_LOSSES", "build_lte_diff", "build_lte_loss_fn",
           "grad_lte_sm", "lte_default_params"]

LTE_LOSSES = ("kpi_mse", "neg_goodput", "cqi_mse")
#: operands that exist only on positional (pathloss-bearing) programs
_POSITIONAL = ("ue_pos", "enb_pos", "ploss")
#: "no surrogate passed": distinct from an explicit None (the exact
#: staircase program)
_DEFAULT_SURROGATE = object()

#: the speed of light in f32, ``16 pi^2`` in f32, and the compiled
#: ``-10 log10`` / ``10 log10`` factors
_C_F32 = float(np.float32(299792458.0))
_SIXTEEN_PI2 = float(np.float32(16.0 * math.pi * math.pi))


def _folded(k: float) -> float:
    from tpudes_torch.ops.fused import _INV_LN10

    return float(np.float32(k) * np.float32(_INV_LN10))


def build_lte_diff(prog, surrogate, device=None):
    """``kpi_fn(ops) -> dict`` (``lte_grad.py:54``): per-UE expected KPIs
    of the full-buffer downlink, differentiable in every ``ops`` entry:
    ``sinr``, ``se``, ``eff`` (the granted quantised efficiency),
    ``share`` (the cell RB share), ``bler``, ``tput_bps`` and ``cqi`` (the
    soft wideband CQI), each ``(U,)``.  A program without positions closes
    over its gain matrix.  ``cqi_only=True`` stops after the CQI (``sinr``,
    ``se``, ``eff``, ``cqi``): what a CQI loss reads, as the reference
    compiler drops the rest of the chain from such a loss."""
    from tpudes_torch.device import resolve_device
    from tpudes_torch.diff.graphs import broadcast, fma_sum, seq_sum
    from tpudes_torch.ops import fused_grad as dmath
    from tpudes_torch.ops.fused import f32, fma
    from tpudes_torch.ops.lte import (
        CQI_EFFICIENCY,
        RB_BANDWIDTH_HZ,
        RE_PER_RB_DATA,
        cqi_and_eff,
        qm_from_eff,
        se_compiled,
        tb_bler_ecr,
    )

    dev = resolve_device(device)
    E, U = prog.n_enb, prog.n_ue
    serving = torch.as_tensor(np.asarray(prog.serving, np.int64), device=dev)
    cells = [(serving == e).to(torch.float32) for e in range(E)]
    members = [np.nonzero(np.asarray(prog.serving) == e)[0].tolist()
               for e in range(E)]
    static_gain = (None if prog.pathloss is not None else torch.as_tensor(
        np.asarray(prog.gain, np.float64).astype(np.float32), device=dev))
    kind = None if prog.pathloss is None else prog.pathloss[0]
    noise = np.float32(prog.noise_psd)
    k_psd = float(np.float32(np.float32(1.0)
                             / np.float32(prog.n_rb * RB_BANDWIDTH_HZ))
                  * np.float32(np.float32(1.0) / noise))
    eff1 = float(np.float32(CQI_EFFICIENCY[1]))
    k_tb = float(np.float32(RE_PER_RB_DATA * prog.n_rb))

    def gain_of(ops):
        enb = broadcast(ops["enb_pos"][:, None, :], (E, U, 3))
        ue = broadcast(ops["ue_pos"][None, :, :], (E, U, 3))
        dx, dy, dz = (enb - ue).unbind(-1)
        d = dmath.sqrt(fma(dz, dz, fma(dy, dy, dx * dx)))         # (E, U)
        pl = [broadcast(v, (E, U)) for v in ops["ploss"].unbind(0)]
        if kind == "friis":
            lam = f32(d, _C_F32) / dmath.maximum(pl[0], 1.0)
            den = ((d * f32(d, _SIXTEEN_PI2)) * d) * dmath.maximum(
                pl[1], 1e-6)
            loss = dmath.log((lam * lam) / den) * f32(d, _folded(-10.0))
            loss = torch.maximum(loss, pl[2])
            rx = torch.where(d <= 0.0, 0.0 - pl[2], 0.0 - loss)
        else:
            d0 = dmath.maximum(pl[1], 1e-3)
            x = torch.maximum(d, d0) / d0
            rx = 0.0 - fma(dmath.log(x), pl[0] * f32(d, _folded(10.0)),
                           pl[2])
        rx = dmath.clip(rx, -250.0, 50.0)
        return dmath.exp10(rx * f32(rx, 0.1))

    def kpi_fn(ops, cqi_only: bool = False):
        gain = static_gain if static_gain is not None else gain_of(ops)
        tx = ops["tx_power_dbm"]
        psd = dmath.exp10((tx + f32(tx, -30.0)) * f32(tx, 0.1))
        a = broadcast((psd * f32(psd, k_psd))[:, None], (E, U))
        seen = a * gain                                            # (E, U)
        total = fma_sum((a[e], gain[e]) for e in range(E))
        sig = seq_sum(seen[e] * cells[e] for e in range(E))
        sinr = sig / ((total - sig) + 1.0)
        se = se_compiled(sinr)
        cqi, effq = cqi_and_eff(se, surrogate)
        if cqi_only:
            return dict(sinr=sinr, se=se, eff=effq,
                        cqi=cqi.to(torch.float32))
        qm = qm_from_eff(effq, surrogate)
        if surrogate is None:
            elig = (se >= f32(se, eff1)).to(torch.float32)
        else:
            elig = surrogate.step(se, eff1)
        w = fma(ops["sched_w"], elig, f32(se, 1e-6))
        # each UE's cell total, its cell's row picked by a one-hot sum
        # (exact: one term, the rest 0)
        cell_tot = [broadcast(seq_sum(w[u] for u in m), (U,)) if m
                    else torch.zeros((U,), device=w.device)
                    for m in members]
        share = w / seq_sum(cells[e] * cell_tot[e] for e in range(E))
        mi = torch.minimum(se, qm) / qm
        tb_bits = (effq * f32(effq, k_tb)) * share
        ecr = effq / qm
        bler = tb_bler_ecr(mi, ecr, tb_bits, fused=True)
        tput = (tb_bits * (1.0 - bler)) * f32(tb_bits, 1000.0)
        return dict(sinr=sinr, se=se, eff=effq, share=share, bler=bler,
                    tput_bps=tput, cqi=cqi.to(torch.float32))

    return kpi_fn


def _lte_scalar_loss(loss: str, out: dict, target) -> torch.Tensor:
    """The scalar KPI loss (``lte_grad.py:171``)."""
    from tpudes_torch.diff.graphs import fixed_sum, mean_sq
    from tpudes_torch.ops import fused_grad as dmath
    from tpudes_torch.ops.fused import f32

    if loss == "kpi_mse":
        d = (out["tput_bps"] - target) / dmath.maximum(torch.abs(target),
                                                        1.0)
        return mean_sq(d)
    if loss == "neg_goodput":
        return -fixed_sum(out["tput_bps"], 0) * f32(target, 1e-6)
    if loss == "cqi_mse":
        return mean_sq(out["cqi"] - target)
    raise ValueError(f"unknown LTE loss {loss!r}; one of {LTE_LOSSES}")


def build_lte_loss_fn(prog, surrogate, loss: str, device=None):
    """``loss_fn(params, target) -> scalar`` (``lte_grad.py:189``)."""
    kpi_fn = build_lte_diff(prog, surrogate, device)

    def loss_fn(params, target):
        return _lte_scalar_loss(loss, kpi_fn(params, loss == "cqi_mse"),
                                target)

    return loss_fn


def lte_default_params(prog, at: dict | None = None, device=None) -> dict:
    """The linearisation point (``lte_grad.py:209``): the program's tx
    powers, uniform scheduler weights and, on a positional program, its
    pathloss parameters, eNB sites and the UEs' positions at t = 0
    (:func:`~tpudes_torch.ops.mobility.trajectory_positions`); ``at``
    overrides any entry.  f32 tensors on ``device``."""
    from tpudes_torch.device import resolve_device

    dev = resolve_device(device)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64).astype(np.float32),
                               device=dev)

    params = {"tx_power_dbm": f(prog.tx_power_dbm),
              "sched_w": f(np.ones(prog.n_ue))}
    if prog.pathloss is not None:
        params["ploss"] = f(prog.pathloss[1:4])
        params["enb_pos"] = f(prog.enb_pos)
        if prog.mobility is not None:
            from tpudes_torch.ops.mobility import trajectory_positions

            params["ue_pos"] = f(trajectory_positions(prog.mobility, [0])[0])
    for k, v in (at or {}).items():
        params[k] = f(v)
    missing = [k for k in (_POSITIONAL if prog.pathloss is not None else ())
               if k not in params]
    if missing:
        raise ValueError(
            f"positional LTE program needs {missing} (pass via at=)")
    return params


def _lte_diff_key(prog, surrogate) -> tuple:
    """Runner-cache identity of the chain (``lte_grad.py:242``), with the
    tx-power and position shapes the operands take."""
    return (np.asarray(prog.gain).tobytes(),
            np.asarray(prog.serving).tobytes(), float(prog.noise_psd),
            int(prog.n_rb), prog.pathloss is None,
            None if prog.pathloss is None else prog.pathloss[0],
            None if surrogate is None else surrogate.key())


def lte_grad_step(prog, surrogate, loss: str, device):
    """``step(params, target) -> (losses, grads)``: the grad of
    :func:`build_lte_loss_fn`'s objective at each of the C points of
    ``params`` (``(C, ...)`` tensors)."""
    from tpudes_torch.diff.calibrate import value_and_grad
    from tpudes_torch.diff.graphs import point_grads

    vg = value_and_grad(build_lte_loss_fn(prog, surrogate, loss, device))

    def step(params, target):
        return point_grads(vg, params, target)

    return step


def grad_lte_sm(prog, *, loss: str = "neg_goodput", target=None,
                at: dict | None = None, batch: dict | None = None,
                surrogate=_DEFAULT_SURROGATE, wrt=None, device=None):
    """The loss and its gradients of the LTE expected-KPI chain w.r.t. its
    operands (``lte_grad.py:251``): :func:`~tpudes_torch.diff.as_grad.
    grad_as_flows`' contract on the LTE engine (``{"loss", "grads"}``;
    ``batch={name: (C, ...)}`` evaluates C designs in one launch).
    ``surrogate`` defaults to a fresh :class:`~tpudes_torch.diff.
    Surrogacy`; ``Surrogacy(ste=True)`` is hard forward, soft backward;
    None differentiates the exact staircase program.  ``device`` defaults
    to the card, where the call is one CUDA-graph replay."""
    from tpudes_torch.device import resolve_device
    from tpudes_torch.diff.graphs import GraphCall, batch_axes, grad_call
    from tpudes_torch.diff.surrogate import Surrogacy
    from tpudes_torch.obs.distributed import wall_now
    from tpudes_torch.parallel.runtime import RUNTIME

    if surrogate is _DEFAULT_SURROGATE:
        surrogate = Surrogacy()
    if loss not in LTE_LOSSES:
        raise ValueError(f"unknown LTE loss {loss!r}; one of {LTE_LOSSES}")
    dev = resolve_device(device)
    if prog.pathloss is None:
        bad = [k for k in (batch or {}) if k in _POSITIONAL] + [
            k for k in (wrt or ()) if k in _POSITIONAL]
        if bad:
            raise ValueError(
                f"{sorted(set(bad))} need a positional program "
                "(prog.pathloss/enb_pos, the mobility lowering); this "
                "program bakes a gain matrix")
    params = lte_default_params(prog, at, dev)
    n_cfg, axes = batch_axes(batch, params)
    for k, v in (batch or {}).items():
        params[k] = torch.as_tensor(
            np.asarray(v, np.float64).astype(np.float32), device=dev)
    names = tuple(sorted(params))
    ck = ("diff", "lte_grad", _lte_diff_key(prog, surrogate), loss, n_cfg,
          None if axes is None else tuple(sorted(axes.items())), names,
          str(dev))
    t_miss = wall_now()
    runner, compiling = RUNTIME.runner(
        "diff_lte", ck,
        lambda: GraphCall(lte_grad_step(prog, surrogate, loss, dev), dev))
    tgt = (torch.zeros((prog.n_ue,), dtype=torch.float32, device=dev)
           if target is None else torch.as_tensor(
               np.asarray(target, np.float64).astype(np.float32),
               device=dev))
    return grad_call(runner, "diff_lte", "lte_sm", compiling, t_miss,
                     params, names, n_cfg, axes, wrt, target=tgt)
