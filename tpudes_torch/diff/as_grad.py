"""``grad_as_flows``: KPI gradients through the fluid AS engine.

Counterpart of ``tpudes/diff/as_grad.py``.  The differentiable runner
(:func:`tpudes_torch.parallel.as_flows.build_as_diff`) shares the fluid
rounds' arithmetic with the engine and takes the per-flow nominal rates
and per-edge capacities as operands; this module takes the gradient of a
scalar KPI loss with ``torch.autograd``, caches one runner per (program,
loss, batching) in :data:`~tpudes_torch.parallel.runtime.RUNTIME` (value
flips never rebuild it: every operand is an input) and evaluates a batch
of C candidate designs in one launch.

Differentiable operands (the members of ``params``):

- ``flow_bps``   (F,) the per-flow nominal offered rates (with
  ``prog.traffic`` the workload's multiplier rides on top);
- ``cap_bps``    (E,) the per-edge link capacities;
- ``rate_scale`` ()   the global offered-load multiplier (a (C,) array
  under ``rate_scale=[...]``).

On the card a call is one CUDA-graph replay (:class:`~tpudes_torch.diff.
graphs.GraphCall`, captured at the runner cache's miss): the replica
draws ``normal(fold_in(key, r), (F,))``, every point's forward and
backward.  A batch runs its C points one after another inside that one
launch, each on its own copies of the operands, so a point's loss and
grads are its own and equal a solo call's bit for bit.

Not ported: the reference's trace manifest (``as_grad.py:240-408``, the
JXL lint surface), which has no torch counterpart (ROADMAP A17).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["AS_LOSSES", "as_default_params", "build_as_loss_fn",
           "grad_as_flows"]

#: loss registry (``as_grad.py:31``)
AS_LOSSES = ("kpi_mse", "neg_goodput", "delay")
#: the operands of a grad, in the order the runner differentiates them
AS_OPERANDS = ("cap_bps", "flow_bps", "rate_scale")


def _as_scalar_loss(loss: str, out: dict, target) -> torch.Tensor:
    """The scalar KPI loss (``as_grad.py:34``)."""
    from tpudes_torch.diff.graphs import fixed_sum, fma_sum, mean_rows, mean_sq
    from tpudes_torch.ops import fused_grad as dmath
    from tpudes_torch.ops.fused import f32

    gp = mean_rows(out["goodput_bps"])                 # (F,)
    if loss == "kpi_mse":
        d = (gp - target) / dmath.maximum(torch.abs(target), 1.0)
        return mean_sq(d)
    if loss == "neg_goodput":
        return -fixed_sum(gp, 0) * f32(gp, 1e-6)
    if loss == "delay":
        r = out["reached"]
        dl = mean_rows(out["delay_s"])
        return fma_sum((dl[i], r[i]) for i in range(dl.shape[0])) / \
            dmath.maximum(fixed_sum(r, 0), 1.0)
    raise ValueError(f"unknown AS loss {loss!r}; one of {AS_LOSSES}")


def build_as_loss_fn(prog, r_pad: int, loss: str, n_real: int | None = None,
                     device=None):
    """``loss_fn(params, z, mult, target) -> scalar`` (``as_grad.py:57``):
    the scalar KPI objective of one point, ``params`` holding
    ``flow_bps`` / ``cap_bps`` / ``rate_scale`` tensors, ``z`` the
    ``(r_pad, F)`` replica draws, ``mult`` the workload multiplier (None:
    1).  ``n_real`` keeps the first ``n_real`` replicas before the loss
    reduces, so the objective averages exactly the requested replicas."""
    from tpudes_torch.parallel.as_flows import build_as_diff

    diff_run = build_as_diff(prog, r_pad, device)

    def loss_fn(params, z, mult, target):
        out = diff_run(z, params["rate_scale"], params["flow_bps"],
                       params["cap_bps"], mult)
        if n_real is not None and n_real != r_pad:
            out = {k: (v if k == "reached" else v[:n_real])
                   for k, v in out.items()}
        return _as_scalar_loss(loss, out, target)

    return loss_fn


def as_default_params(prog, device=None) -> dict:
    """The linearisation point: the program's own nominal operands
    (``as_grad.py:88``), f32 on ``device``."""
    from tpudes_torch.device import resolve_device

    dev = resolve_device(device)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64).astype(np.float32),
                               device=dev)

    return {"flow_bps": f(prog.flow_bps), "cap_bps": f(prog.rate_bps),
            "rate_scale": f(1.0)}


def _as_grad_key(prog_key, r_shape, loss, n_cfg, axes) -> tuple:
    """Runner-cache identity of one grad program (``as_grad.py:109``)."""
    return ("diff", "as_grad", prog_key, r_shape, loss, n_cfg,
            None if axes is None else tuple(sorted(axes.items())))


def as_grad_step(prog, r_pad: int, replicas: int, loss: str, device):
    """``step(params, key, target, mult=None) -> (losses, grads)``: the
    grad of :func:`build_as_loss_fn`'s objective at each of the C points
    of ``params`` (:data:`AS_OPERANDS`, each ``(C, ...)``), the ``(r_pad,
    F)`` draws made from ``key`` inside the step."""
    from tpudes_torch.diff.calibrate import value_and_grad
    from tpudes_torch.diff.graphs import point_grads
    from tpudes_torch.random import as_replica_draws

    vg = value_and_grad(build_as_loss_fn(prog, r_pad, loss, n_real=replicas,
                                         device=device))
    F = len(prog.src)

    def step(params, key, target, mult=None):
        z = as_replica_draws(key, r_pad, F)
        return point_grads(vg, params, z, mult, target)

    return step


def grad_as_flows(prog, key, replicas: int, *, loss: str = "neg_goodput",
                  target=None, at: dict | None = None,
                  batch: dict | None = None, rate_scale=None, wrt=None,
                  device=None):
    """The loss and its gradients of the fluid AS engine w.r.t. its
    operands (``as_grad.py:120``): ``{"loss": float, "grads": {name:
    np.ndarray}}``.  ``at`` moves the linearisation point (no rebuild),
    ``batch={name: (C, ...)}`` evaluates C candidate designs in one
    launch (losses and grads gain a leading C axis), ``rate_scale=[...]``
    batches the offered-load scale; one batch axis a call.  ``wrt``
    restricts the returned grads (all are computed).  ``prog.surrogate``
    smooths the delivery gate.  ``device`` defaults to the card, where the
    call is one CUDA-graph replay."""
    from tpudes_torch.device import resolve_device
    from tpudes_torch.diff.graphs import GraphCall, batch_axes, grad_call
    from tpudes_torch.obs.distributed import wall_now
    from tpudes_torch.parallel.as_flows import as_prog_key, workload_mult
    from tpudes_torch.parallel.runtime import RUNTIME, bucket_replicas

    if batch is not None and rate_scale is not None:
        raise ValueError(
            "one batch axis per launch: candidate designs (batch=) or "
            "the offered-load sweep (rate_scale=[...])")
    if loss not in AS_LOSSES:
        raise ValueError(f"unknown AS loss {loss!r}; one of {AS_LOSSES}")
    dev = resolve_device(device)
    r_pad = bucket_replicas(replicas)
    if rate_scale is not None:
        n_cfg = len(rate_scale)
        axes = {"flow_bps": None, "cap_bps": None, "rate_scale": 0}
    else:
        n_cfg, axes = batch_axes(batch, AS_OPERANDS)
    ck = _as_grad_key(as_prog_key(prog), (r_pad, int(replicas)), loss,
                      n_cfg, axes) + (str(dev),)
    t_miss = wall_now()
    runner, compiling = RUNTIME.runner(
        "diff_as", ck,
        lambda: GraphCall(as_grad_step(prog, r_pad, int(replicas), loss,
                                       dev), dev))

    params = as_default_params(prog, dev)
    for k, v in (at or {}).items():
        params[k] = _f32(v, dev)
    if rate_scale is not None:
        params["rate_scale"] = _f32([float(v) for v in rate_scale], dev)
    for k, v in (batch or {}).items():
        params[k] = _f32(v, dev)
    tgt = (torch.zeros((len(prog.src),), dtype=torch.float32, device=dev)
           if target is None else _f32(target, dev))
    key_t = torch.as_tensor(np.asarray(key, np.int64)).to(dev)
    return grad_call(runner, "diff_as", "as_flows", compiling, t_miss,
                     params, AS_OPERANDS, n_cfg, axes, wrt, key=key_t,
                     target=tgt, mult=workload_mult(prog, dev))


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float64).astype(np.float32),
                           device=device)
