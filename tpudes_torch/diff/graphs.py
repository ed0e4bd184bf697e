"""One launch a grad call or a descent: CUDA graphs, and fixed-order sums.

The reference runs a grad call as one compiled executable and a whole
descent as one ``lax.scan`` (one launch, one compile).  On the card
:class:`GraphCall` captures the call's work (the forward, the backward
and, for a descent, every step with its optimizer) as one CUDA graph at
the runner cache's miss, and replays it on a hit: the operands are copied
into the graph's static inputs first.  It warms the function up on a
side stream before the capture (PyTorch's whole-network capture asks for
that; it also makes the constant tensors the compiled functions keep,
before the capture), and a failed capture raises: nothing runs eagerly in
its place.  On the CPU a call runs the function once.

:func:`fixed_sum` sums an axis in a fixed order of elementwise adds, the
same on every device and for every batch size: in index order from 0
(the reference compiler's order for a reduction) for short axes, as a
pairwise tree past :data:`SEQ_MAX` (:func:`seq_sum`, :func:`fma_sum`,
:func:`mean_rows` and :func:`mean_sq` are the reductions the reference
compiler makes of the losses and cell sums).  :func:`broadcast` broadcasts an
operand so that its cotangent is summed that way: a gradient on the card
equals the CPU's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["GraphCall", "batch_axes", "broadcast", "fixed_sum", "flatten",
           "fma_sum", "grad_call", "mean_rows", "mean_sq", "point_grads",
           "seq_sum", "unflatten"]

#: the longest axis :func:`fixed_sum` adds in index order
SEQ_MAX = 64


def fixed_sum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``x`` summed over ``dim`` by elementwise adds in a fixed order:
    ``((x0 + x1) + x2) + ...`` for at most :data:`SEQ_MAX` entries, else
    a pairwise tree over the entries padded with zeros to a power of
    two."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n == 0:
        return torch.zeros_like(x[0:1]).sum(0)
    if n <= SEQ_MAX:
        out = x[0]
        for i in range(1, n):
            out = out + x[i]
        return out
    m = 1 << (n - 1).bit_length()
    if m != n:
        x = torch.cat([x, torch.zeros((m - n, *x.shape[1:]), dtype=x.dtype,
                                      device=x.device)])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


def seq_sum(terms) -> torch.Tensor:
    """The terms added in order from the first (a reduction's order)."""
    out = None
    for t in terms:
        out = t if out is None else out + t
    return out


def fma_sum(pairs) -> torch.Tensor:
    """``sum_i a_i b_i`` as the compiler reduces a product it fused into
    the reduction: ``a_0 b_0``, then ``fma(a_i, b_i, acc)`` in order."""
    from tpudes_torch.ops.fused import fma

    out = None
    for a, b in pairs:
        out = a * b if out is None else fma(a, b, out)
    return out


def mean_rows(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=0)``: :func:`fixed_sum` of the rows times the f32
    ``1 / n`` (the compiled divide)."""
    from tpudes_torch.ops.fused import f32

    return fixed_sum(x, 0) * f32(x, np.float32(1.0) / np.float32(x.shape[0]))


def mean_sq(d: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(d ** 2)`` of a 1-D ``d``: the squares fused into the
    reduction (:func:`fma_sum`), times the f32 ``1 / n``."""
    from tpudes_torch.ops.fused import f32

    return fma_sum((d[i], d[i]) for i in range(d.shape[0])) * f32(
        d, np.float32(1.0) / np.float32(d.shape[0]))


class _Broadcast(torch.autograd.Function):
    """``x.expand(shape)`` whose backward sums the broadcast axes with
    :func:`fixed_sum`: the same order on every device (autograd's own
    reduction of a broadcast's cotangent takes the device's reduction
    order, which differs between the CPU and the card)."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = x.shape
        return x.expand(shape)

    @staticmethod
    def backward(ctx, g):
        lead = g.dim() - len(ctx.in_shape)
        for _ in range(lead):
            g = fixed_sum(g, 0)
        for i, n in enumerate(ctx.in_shape):
            if n == 1 and g.shape[i] != 1:
                g = fixed_sum(g, i).unsqueeze(i)
        return g, None


def broadcast(x: torch.Tensor, shape) -> torch.Tensor:
    """``x`` broadcast to ``shape``, its cotangent summed in a fixed order
    (:class:`_Broadcast`)."""
    shape = torch.Size(shape)
    return x if x.shape == shape else _Broadcast.apply(x, shape)


def point_grads(vg, params: dict, *args) -> tuple:
    """``vg(point_params, *args) -> (loss, grads)`` (a
    :func:`~tpudes_torch.diff.calibrate.value_and_grad`) at each of the C
    points of ``params`` (``(C, ...)`` tensors), one after another:
    ``(losses (C,), {name: (C, ...)})``.  A point's ops see only its own
    row, so it equals a solo call bit for bit."""
    n = next(iter(params.values())).shape[0]
    losses, grads = [], {k: [] for k in params}
    for c in range(n):
        val, g = vg({k: v[c] for k, v in params.items()}, *args)
        losses.append(val)
        for k in params:
            grads[k].append(g[k])
    return torch.stack(losses), {k: torch.stack(v) for k, v in grads.items()}


def batch_axes(batch: dict | None, names) -> tuple:
    """``(n_cfg, axes)`` of a ``batch={name: (C, ...)}`` over the operands
    ``names``: C and ``{name: 0 (batched) or None}``; ``(None, None)``
    without a batch."""
    if batch is None:
        return None, None
    sizes = {int(np.shape(v)[0]) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError("batch= arrays need one shared leading axis")
    return sizes.pop(), {k: (0 if k in batch else None) for k in names}


def grad_call(runner, engine: str, telemetry: str, compiling: bool, t_miss,
              params: dict, names, n_cfg, axes, wrt, **inputs) -> dict:
    """One grad launch of a cached ``runner`` (a :class:`GraphCall` of a
    ``step(params, **inputs) -> (losses, grads)`` over C points), timed
    and counted under ``engine``: the operands ``names`` of ``params``
    stacked to the C points (a batched one as given, the rest repeated),
    the results brought to the host, an unbatched call's point axis
    dropped, the grads kept to ``wrt`` (None: all), and the call recorded
    in :class:`~tpudes_torch.obs.grad.GradTelemetry` under ``telemetry``:
    ``{"loss": float or (C,), "grads": {name: np.ndarray}}``."""
    from tpudes_torch.obs.device import CompileTelemetry
    from tpudes_torch.obs.grad import GradTelemetry
    from tpudes_torch.parallel.runtime import RUNTIME

    C = n_cfg or 1
    stacked = {k: (params[k] if axes is not None and axes[k] == 0
                   else params[k][None].expand(C, *params[k].shape))
               .contiguous() for k in names}
    with CompileTelemetry.timed(engine, compiling, t_miss):
        losses, grads = runner(params=stacked, **inputs)
        RUNTIME.record_launch(engine)
        val = losses.cpu().numpy()
        grads = {k: v.cpu().numpy() for k, v in grads.items()}
    if axes is None:
        val = val[0]
        grads = {k: v[0] for k, v in grads.items()}
    if wrt is not None:
        grads = {k: grads[k] for k in wrt}
    norm = float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in grads.values())))
    GradTelemetry.record(telemetry, loss=float(np.mean(val)),
                         grad_norm=norm, batched=n_cfg)
    return {"loss": float(val) if np.ndim(val) == 0 else val,
            "grads": grads}


def flatten(tree, prefix: str = "") -> dict:
    """A nested dict of tensors (None leaves dropped) as one flat dict
    keyed by path (``"rest/ploss"``)."""
    out = {}
    for k, v in (tree or {}).items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "/"))
        elif v is not None:
            out[name] = v
    return out


def unflatten(flat: dict) -> dict:
    """:func:`flatten`'s inverse."""
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


class GraphCall:
    """``fn(**inputs) -> outputs`` (the inputs tensors, nested dicts of
    them or None, which ``fn`` then does not receive; the outputs
    tensors, or dicts / tuples of them), one launch a call: on the card a
    CUDA graph captured at the first call (after ``warmup`` runs on a
    side stream) and replayed after it, its outputs the graph's static
    tensors (read them before the next call); on the CPU ``fn`` itself.
    ``captures`` and ``replays`` count."""

    def __init__(self, fn, device, warmup: int = 1):
        self.fn = fn
        self.device = torch.device(device)
        self.warmup = int(warmup)
        self.graph = None
        self.static_in: dict = {}
        self.static_out = None
        self.captures = 0
        self.replays = 0

    def __call__(self, **inputs):
        flat = flatten(inputs)
        if self.device.type != "cuda":
            return self.fn(**unflatten(flat))
        if self.graph is None:
            self._capture(flat)
        else:
            if flat.keys() != self.static_in.keys():
                raise ValueError("a replay takes the captured call's inputs")
            for k, v in flat.items():
                self.static_in[k].copy_(v, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        return self.static_out

    def _capture(self, inputs: dict) -> None:
        self.static_in = {k: v.detach().clone() for k, v in inputs.items()}
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(self.warmup):
                self.fn(**unflatten(self.static_in))
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.static_out = self.fn(**unflatten(self.static_in))
        self.graph = graph
        self.captures += 1
