"""Gradient-based calibration: fit runtime operands to observed KPIs.

Counterpart of ``tpudes/diff/calibrate.py``.  A whole descent is one
launch: the steps' forward, backward and optimizer update in order,
captured on the card as one CUDA graph at the runner cache's miss
(:class:`~tpudes_torch.diff.graphs.GraphCall`) and replayed on a hit, as
the reference runs one compiled ``lax.scan``.  Step ``t`` draws its
replica minibatch from ``fold_in(key, t)`` inside the launch.  The loss
and gradient-norm histories come back as ``(steps,)`` arrays.

Optimizers (tensor arithmetic, no branch on a value):

- ``adam``: the bias-corrected Adam update;
- ``lbfgs``: L-BFGS-lite, the two-loop recursion over an M = 5 ring of
  ``(s, y)`` pairs with a fixed step capped at a fraction of the
  iterate's scale, on the parameters raveled in sorted-name order (the
  reference's ``ravel_pytree``).

Everything value-like the objective reads rides in ``operands`` (observed
KPIs, the operands not optimised, the workload): a cached descent must
refit new observations, never bake the first call's.

:func:`calibrate_as_flows` and :func:`calibrate_lte` wrap the two
engines: plant, observe, descend, recover.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["CalibResult", "calibrate_as_flows", "calibrate_lte", "descend",
           "value_and_grad"]

#: L-BFGS-lite history depth (``calibrate.py:52``)
_LBFGS_M = 5


@dataclass
class CalibResult:
    """One calibration run (``calibrate.py:54``): the fitted operands and
    the per-step loss and gradient-norm histories."""

    params: dict
    loss: np.ndarray        # (steps,)
    grad_norm: np.ndarray   # (steps,)
    steps: int
    opt: str

    @property
    def final_loss(self) -> float:
        return float(self.loss[-1])


def value_and_grad(fn):
    """``jax.value_and_grad`` of ``fn(params, *args) -> scalar`` over the
    dict ``params``: ``(loss, grads)``, the grads a dict of the same
    names, made with ``torch.autograd`` on fresh leaves."""

    def vg(params, *args):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            loss = fn(leaves, *args)
            gs = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
        return loss.detach(), {
            k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), gs)}

    return vg


def _grad_norm(grads: dict) -> torch.Tensor:
    from tpudes_torch.diff.graphs import fixed_sum

    return torch.sqrt(fixed_sum(torch.stack(
        [(g.to(torch.float32) ** 2).sum() for _, g in sorted(grads.items())]),
        0))


def _adam_run(vg, steps: int, lr: float):
    """The Adam descent (``calibrate.py:69``):
    ``run(params0, key, operands) -> (params, losses, grad_norms)``."""
    from tpudes_torch.ops.fused import powf

    b1, b2, eps = 0.9, 0.999, 1e-8

    def run(params0, key, operands=None):
        operands = operands or {}
        p = dict(params0)
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v = {k: torch.zeros_like(x) for k, x in p.items()}
        # the bias corrections 1 - b^(t + 1) of every step at once (a
        # vector: a 0-dim operand would index powf's tables by a host int)
        tf = torch.arange(1, int(steps) + 1, dtype=torch.float32,
                          device=key.device)
        c1s = 1.0 - powf(torch.full_like(tf, b1), tf)
        c2s = 1.0 - powf(torch.full_like(tf, b2), tf)
        losses, gnorms = [], []
        keys = _step_keys(key, steps)
        for t in range(int(steps)):
            loss, g = vg(p, keys[t], operands)
            m = {k: b1 * m[k] + (1 - b1) * g[k] for k in p}
            v = {k: b2 * v[k] + (1 - b2) * g[k] * g[k] for k in p}
            c1, c2 = c1s[t], c2s[t]
            p = {k: p[k] - lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
                 for k in p}
            losses.append(loss)
            gnorms.append(_grad_norm(g))
        return p, torch.stack(losses), torch.stack(gnorms)

    return run


def _step_keys(key: torch.Tensor, steps: int) -> torch.Tensor:
    """``(steps, 2)``: step ``t``'s key ``fold_in(key, t)``, all at once."""
    from tpudes_torch.random import fold_in

    return fold_in(key[None, :], torch.arange(int(steps), device=key.device))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum()


def _lbfgs_run(vg, names, shapes, steps: int, lr: float):
    """L-BFGS-lite (``calibrate.py:112``) on the parameters raveled in
    ``names`` order: ``run(params0, key, operands) -> (params, losses,
    grad_norms)``.  The ring's slots start masked (``rho = 0``)."""
    M = _LBFGS_M
    sizes = [int(np.prod(s)) for s in shapes]

    def ravel(d):
        return torch.cat([d[k].reshape(-1) for k in names])

    def unravel(x):
        out, at = {}, 0
        for k, s, n in zip(names, shapes, sizes):
            out[k] = x[at:at + n].reshape(s)
            at += n
        return out

    def direction(g, S, Y, rho):
        q = g
        alphas = [None] * M
        for i in range(M):
            j = M - 1 - i                                  # newest first
            a = rho[j] * _dot(S[j], q)
            q = q - a * Y[j]
            alphas[j] = a
        sy = _dot(S[M - 1], Y[M - 1])
        yy = _dot(Y[M - 1], Y[M - 1])
        gamma = torch.where(yy > 1e-12, sy / torch.clamp_min(yy, 1e-12),
                            torch.ones_like(yy))
        r = gamma * q
        for j in range(M):
            b = rho[j] * _dot(Y[j], r)
            r = r + (alphas[j] - b) * S[j]
        return r

    def run(params0, key, operands=None):
        operands = operands or {}
        x = ravel(params0)
        P = x.numel()
        g_prev = torch.zeros_like(x)
        x_prev = x
        S = torch.zeros((M, P), dtype=torch.float32, device=x.device)
        Y = torch.zeros_like(S)
        rho = torch.zeros((M,), dtype=torch.float32, device=x.device)
        losses, gnorms = [], []
        keys = _step_keys(key, steps)
        for t in range(int(steps)):
            loss, g = vg(unravel(x), keys[t], operands)
            gf = ravel(g)
            if t > 0:
                s = x - x_prev
                y = gf - g_prev
                sy = _dot(s, y)
                ok = sy > 1e-12
                S = torch.where(ok, torch.cat([S[1:], s[None]]), S)
                Y = torch.where(ok, torch.cat([Y[1:], y[None]]), Y)
                rho = torch.where(ok, torch.cat(
                    [rho[1:], (1.0 / torch.clamp_min(sy, 1e-12))[None]]), rho)
            step = lr * direction(gf, S, Y, rho)
            cap = 0.25 * (1.0 + torch.sqrt(_dot(x, x)))
            snorm = torch.sqrt(_dot(step, step))
            step = step * torch.clamp_max(cap / torch.clamp_min(snorm, 1e-12),
                                          1.0)
            losses.append(loss)
            gnorms.append(torch.sqrt(_dot(gf, gf)))
            g_prev, x_prev, x = gf, x, x - step
        return unravel(x), torch.stack(losses), torch.stack(gnorms)

    return run


def descend(loss_and_grad, params0: dict, *, steps: int, lr: float, key,
            opt: str = "adam", operands=None, runtime_key: tuple | None = None,
            engine: str = "diff", device=None) -> CalibResult:
    """``steps`` optimizer iterations of ``loss_and_grad(params, key_t,
    operands) -> (loss, grads)`` as one launch (``calibrate.py:203``).
    ``operands`` (a nested dict of tensors) carries everything value-like
    the objective reads; ``runtime_key`` (the program's identity, never
    operand values) caches the descent in
    :data:`~tpudes_torch.parallel.runtime.RUNTIME` under ``engine``, and
    on the card the cached descent is one CUDA graph, replayed.
    ``device`` defaults to the card."""
    from tpudes_torch.device import resolve_device
    from tpudes_torch.diff.graphs import GraphCall
    from tpudes_torch.obs.device import CompileTelemetry
    from tpudes_torch.obs.distributed import wall_now
    from tpudes_torch.obs.grad import GradTelemetry
    from tpudes_torch.parallel.runtime import RUNTIME

    if opt not in ("adam", "lbfgs"):
        raise ValueError(f"opt must be 'adam' or 'lbfgs', not {opt!r}")
    dev = resolve_device(device)
    params0 = {k: _f32(v, dev) for k, v in params0.items()}
    key_t = torch.as_tensor(np.asarray(key, np.int64)).to(dev)
    names = tuple(sorted(params0))
    shapes = tuple(tuple(params0[k].shape) for k in names)

    def build():
        run = (_adam_run(loss_and_grad, steps, lr) if opt == "adam" else
               _lbfgs_run(loss_and_grad, names, shapes, steps, lr))
        return GraphCall(run, dev)

    t_miss = wall_now()
    if runtime_key is not None:
        runner, compiling = RUNTIME.runner(
            engine, ("descent", opt, int(steps), float(lr),
                     np.asarray(key, np.int64).tobytes(), names, shapes)
            + tuple(runtime_key) + (str(dev),), build)
    else:
        runner, compiling = build(), True
    with CompileTelemetry.timed(engine, compiling, t_miss):
        params, losses, gnorms = runner(params0=params0,
                                        operands=operands or {}, key=key_t)
        RUNTIME.record_launch(engine)
        params = {k: v.detach().cpu().numpy() for k, v in params.items()}
        losses = losses.cpu().numpy()
        gnorms = gnorms.cpu().numpy()
    GradTelemetry.record_descent(engine, losses, gnorms)
    return CalibResult(params=params, loss=losses, grad_norm=gnorms,
                       steps=int(steps), opt=opt)


def _f32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(v, np.float64).astype(np.float32),
                           device=device)


def calibrate_as_flows(prog, key, observed, *, wrt=("flow_bps",),
                       init: dict | None = None, steps: int = 80,
                       lr: float = 0.08, replicas: int = 8,
                       loss: str = "kpi_mse", opt: str = "adam",
                       device=None) -> CalibResult:
    """Recover AS operands (flow rates / link capacities) from observed
    per-flow goodput by descent (``calibrate.py:280``): the parameters in
    log space, step ``t``'s replicas ``normal(fold_in(fold_in(key, t),
    r), (F,))``."""
    from tpudes_torch.device import resolve_device
    from tpudes_torch.diff.as_grad import as_default_params, build_as_loss_fn
    from tpudes_torch.ops import fused
    from tpudes_torch.ops import fused_grad as dmath
    from tpudes_torch.parallel.as_flows import as_prog_key, workload_mult
    from tpudes_torch.parallel.runtime import bucket_replicas
    from tpudes_torch.random import as_replica_draws

    dev = resolve_device(device)
    r_pad = bucket_replicas(replicas)
    F = len(prog.src)
    defaults = as_default_params(prog, dev)
    start = dict(defaults)
    for k, v in (init or {}).items():
        start[k] = _f32(v, dev)
    params0 = {k: fused.log(torch.clamp_min(start[k], 1e-6)) for k in wrt}
    operands = {"target": _f32(observed, dev),
                "rest": {k: v for k, v in defaults.items() if k not in wrt},
                "mult": workload_mult(prog, dev)}
    holder = {}

    def scalar(log_params, kt, ops):
        if "loss_fn" not in holder:
            holder["loss_fn"] = build_as_loss_fn(prog, r_pad, loss,
                                                 n_real=replicas, device=dev)
        p = dict(ops["rest"])
        for k in wrt:
            p[k] = dmath.exp(log_params[k])
        z = as_replica_draws(kt, r_pad, F)
        return holder["loss_fn"](p, z, ops.get("mult"), ops["target"])

    res = descend(value_and_grad(scalar), params0, steps=steps, lr=lr,
                  key=key, opt=opt, operands=operands,
                  runtime_key=(as_prog_key(prog), r_pad, int(replicas), loss,
                               tuple(wrt)),
                  engine="diff_as", device=dev)
    res.params = {k: np.exp(v) for k, v in res.params.items()}
    return res


def calibrate_lte(prog, key, observed, *, wrt=("ploss",),
                  init: dict | None = None, at: dict | None = None,
                  steps: int = 120, lr: float = 0.05, loss: str = "cqi_mse",
                  opt: str = "adam", surrogate=None,
                  device=None) -> CalibResult:
    """Recover LTE propagation / power operands from observed KPIs (per-UE
    CQI or throughput) by descent over the expected-KPI chain
    (``calibrate.py:350``)."""
    from tpudes_torch.device import resolve_device
    from tpudes_torch.diff.lte_grad import (
        _lte_diff_key,
        build_lte_loss_fn,
        lte_default_params,
    )
    from tpudes_torch.diff.surrogate import Surrogacy

    dev = resolve_device(device)
    if surrogate is None:
        surrogate = Surrogacy()
    defaults = lte_default_params(prog, at, dev)
    start = dict(defaults)
    for k, v in (init or {}).items():
        start[k] = _f32(v, dev)
    params0 = {k: start[k] for k in wrt}
    operands = {"target": _f32(observed, dev),
                "rest": {k: v for k, v in defaults.items() if k not in wrt}}
    holder = {}

    def scalar(params, kt, ops):
        if "loss_fn" not in holder:
            holder["loss_fn"] = build_lte_loss_fn(prog, surrogate, loss, dev)
        return holder["loss_fn"]({**ops["rest"], **params}, ops["target"])

    return descend(value_and_grad(scalar), params0, steps=steps, lr=lr,
                   key=key, opt=opt, operands=operands,
                   runtime_key=(_lte_diff_key(prog, surrogate), loss,
                                tuple(wrt)),
                   engine="diff_lte", device=dev)
