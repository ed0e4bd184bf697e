"""UE motion as closed-form positions of simulation time.

Counterpart of ``tpudes/ops/mobility.py``: every model is a pure
function ``positions_at(ops, t_us (T,)) -> (T, N, 3)``, so the geometry
stage evaluates the positions of a whole chunk of refresh times in one
pass of tensor operations, and a ``geom_stride = K`` run samples the
same trajectory a stride-1 run samples, only less often.

- ``static`` / ``const_velocity``: ``p(t) = p0 + v t``;
- ``random_walk``: per-(segment, node) velocities drawn from a
  ``fold_in``-keyed stream (pure in ``(mob_seed, segment, node)``),
  displacement summed over the segment grid and folded into the bounds
  rectangle by the triangle-wave reflection;
- ``waypoint``: per-node ``(time, position)`` tables, linear
  interpolation clamped at both ends.

The arithmetic is the reference's compiled arithmetic (a product
feeding a sum is one fused multiply-add, :mod:`tpudes_torch.ops.fused`),
so the positions equal the reference's bit for bit, on the CPU and on
the card alike, apart from the walk: its velocities take ``sin``/``cos``,
which the reference and the port round differently by an ulp now and
then (:func:`walk_segment_velocities`).
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from tpudes_torch.device import resolve_device
from tpudes_torch.ops.fused import f32, fma
from tpudes_torch.random import PRNGKey, fold_in, uniform

#: model short name -> id (``tpudes/ops/mobility.py:74``)
MOB_MODEL_IDS = {
    "static": 0,
    "const_velocity": 1,
    "random_walk": 2,
    "waypoint": 3,
}

#: the coherence length (m) behind the geom_stride advisory
GEOM_COHERENCE_M = 2.0

#: root key of every walk stream: segment draws are
#: ``fold_in(fold_in(PRNGKey(root), mob_seed), segment)``
_MOB_ROOT_SEED = 0x6E0B17


@dataclass(frozen=True)
class MobilityProgram:
    """One node batch's motion (``tpudes/ops/mobility.py:106``).  Build
    it with the factories, or carry the reference's over with
    :func:`tpudes_torch.convert.mobility_from_numpy`."""

    model: str                    # key of MOB_MODEL_IDS
    base_pos: np.ndarray          # (N, 3) f32 position at t = 0
    velocity: np.ndarray          # (N, 3) f32 (const_velocity)
    speed: np.ndarray             # (N, 2) f32 per-node [min, max] m/s (walk)
    bounds: np.ndarray            # (4,) f32 (xmin, xmax, ymin, ymax) (walk)
    wp_t: np.ndarray              # (N, W) i32 waypoint times (us), sorted
    wp_p: np.ndarray              # (N, W, 3) f32 waypoint positions
    seg_us: int = 1_000_000       # walk segment length
    n_seg: int = 1                # walk segment-grid length
    mob_seed: int = 0             # walk stream seed

    def __post_init__(self):
        if self.model not in MOB_MODEL_IDS:
            raise ValueError(f"unknown mobility model {self.model!r}")

    @property
    def n(self) -> int:
        return int(self.base_pos.shape[0])

    def shape_key(self) -> tuple:
        """Everything that sets the shapes of the position math."""
        return (
            self.n, int(self.wp_t.shape[1]), int(self.n_seg),
            int(self.seg_us),
        )

    def param_key(self) -> tuple:
        """Hashable identity of the whole parameter set."""
        return (
            self.model, self.base_pos.tobytes(), self.velocity.tobytes(),
            self.speed.tobytes(), self.bounds.tobytes(),
            self.wp_t.tobytes(), self.wp_p.tobytes(),
            int(self.seg_us), int(self.n_seg), int(self.mob_seed),
        )

    def operands(self, device=None) -> dict:
        """The position math's tensors on ``device`` (the card by
        default), the walk's ``(n_seg, N, 2)`` velocity table drawn
        here once (zeros for the other models, which never read it)."""
        device = resolve_device(device)

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        walk = (
            walk_segment_velocities(self, device)
            if self.model == "random_walk"
            else torch.zeros((int(self.n_seg), self.n, 2), device=device)
        )
        return dict(
            mob_id=MOB_MODEL_IDS[self.model],
            mob_base=t(self.base_pos, torch.float32),
            mob_vel=t(self.velocity, torch.float32),
            mob_speed=t(self.speed, torch.float32),
            mob_bounds=t(self.bounds, torch.float32),
            mob_wp_t=t(self.wp_t, torch.int32),
            mob_wp_p=t(self.wp_p, torch.float32),
            mob_walk_vels=walk,
        )

    # --- factories -------------------------------------------------------

    @classmethod
    def _fill(cls, model: str, base, **kw) -> "MobilityProgram":
        base = np.asarray(base, np.float32)
        n = base.shape[0]
        defaults = dict(
            velocity=np.zeros((n, 3), np.float32),
            speed=np.zeros((n, 2), np.float32),
            bounds=np.zeros((4,), np.float32),
            wp_t=np.zeros((n, 2), np.int32),
            wp_p=np.broadcast_to(base[:, None, :], (n, 2, 3)).copy(),
        )
        defaults.update(kw)
        return cls(model=model, base_pos=base, **defaults)

    @classmethod
    def static(cls, base) -> "MobilityProgram":
        return cls._fill("static", base)

    @classmethod
    def constant_velocity(cls, base, velocity) -> "MobilityProgram":
        return cls._fill(
            "const_velocity", base,
            velocity=np.asarray(velocity, np.float32),
        )

    @classmethod
    def random_walk(cls, base, bounds, speed, *, seg_s: float = 1.0,
                    horizon_us: int, mob_seed: int = 0) -> "MobilityProgram":
        """``speed`` is (N, 2) per-node [min, max] m/s (a [0, 0] row
        pins the node); ``horizon_us`` sizes the segment grid."""
        base = np.asarray(base, np.float32)
        seg_us = max(1, int(round(seg_s * 1e6)))
        return cls._fill(
            "random_walk", base,
            speed=np.asarray(speed, np.float32).reshape(base.shape[0], 2),
            bounds=np.asarray(bounds, np.float32).reshape(4),
            seg_us=seg_us, n_seg=int(horizon_us) // seg_us + 1,
            mob_seed=int(mob_seed),
        )

    @classmethod
    def waypoints(cls, wp_t, wp_p) -> "MobilityProgram":
        """``wp_t`` (N, W) us ascending per row, ``wp_p`` (N, W, 3);
        a node holds its first entry before its time and pauses at its
        last one after."""
        wp_t = np.asarray(wp_t, np.int64)
        wp_p = np.asarray(wp_p, np.float32)
        if wp_t.shape[1] < 2:
            wp_t = np.concatenate([wp_t, wp_t], axis=1)
            wp_p = np.concatenate([wp_p, wp_p], axis=1)
        if (np.diff(wp_t, axis=1) < 0).any():
            raise ValueError("waypoint times must ascend per node")
        # the clock is int32 us: clamp instead of wrapping
        wp_t = np.minimum(wp_t, np.int64(2**31 - 1))
        return cls._fill(
            "waypoint", wp_p[:, 0, :],
            wp_t=wp_t.astype(np.int32), wp_p=wp_p,
        )


def walk_segment_velocities(prog: MobilityProgram, device=None):
    """``(n_seg, N, 2)`` walk velocities: segment ``s`` draws
    ``uniform(fold_in(key, s), (N, 2))`` (the flat ``2N`` draw,
    reshaped) under ``key = fold_in(PRNGKey(root), mob_seed)``; speed
    interpolates the node's band, heading is ``2 pi u``.  Op by op in
    f32, as the reference draws it eagerly, but for ``cos``/``sin``,
    taken in f64 and rounded: that is the card's and the CPU's result
    alike, and the reference's (the C library's ``cosf``/``sinf``) but
    for about one value in 75, an ulp away."""
    device = resolve_device(device)
    n = prog.n
    key = fold_in(PRNGKey(_MOB_ROOT_SEED, device=device), int(prog.mob_seed))
    seg = torch.arange(int(prog.n_seg), device=device)
    u = uniform(fold_in(key[None, :], seg), 2 * n).reshape(-1, n, 2)
    speed = torch.as_tensor(np.asarray(prog.speed, np.float32), device=device)
    spd = speed[:, 0] + u[..., 0] * (speed[:, 1] - speed[:, 0])
    ang = (f32(u, 2.0 * math.pi) * u[..., 1]).double()
    return torch.stack([spd * torch.cos(ang).float(),
                        spd * torch.sin(ang).float()], dim=-1)


def fold_into_bounds(x, lo, hi):
    """Triangle-wave reflection of ``x`` into ``[lo, hi]`` (elastic
    rebound in closed form); ``hi <= lo`` clamps to ``lo``.  ``mod`` is
    the floored one (the result takes the divisor's sign)."""
    span = hi - lo
    period = 2.0 * span
    y = torch.fmod(x - lo, period)
    y = torch.where((y != 0) & ((y < 0) != (period < 0)), y + period, y)
    folded = (lo + span) - torch.abs(span - y)
    return torch.where(span > 0.0, folded, lo.expand_as(x))


def build_position_fn(prog: MobilityProgram):
    """``positions_at(ops, t_us) -> (T, N, 3)`` for ``prog``'s model:
    ``ops`` is :meth:`MobilityProgram.operands`, ``t_us`` a ``(T,)``
    int32 tensor of times in us on the operands' device."""
    model = prog.model
    seg_us = float(prog.seg_us)
    W = int(prog.wp_t.shape[1])

    def positions_at(ops, t_us):
        t_us = t_us.to(torch.int32)
        t_f = t_us.to(torch.float32)
        base = ops["mob_base"][None]                       # (1, N, 3)
        if model in ("static", "const_velocity"):
            t_s = (t_f * f32(t_f, 1e-6))[:, None, None]
            return fma(ops["mob_vel"][None], t_s, base)
        if model == "random_walk":
            return _walk_positions(ops, t_f, seg_us)
        return _waypoint_positions(ops, t_us, W)

    return positions_at


def _walk_positions(ops, t_f, seg_us):
    vels = ops["mob_walk_vels"]                            # (S, N, 2)
    base = ops["mob_base"]
    starts = torch.arange(vels.shape[0], dtype=torch.float32,
                          device=t_f.device) * seg_us
    dt = torch.clamp(t_f[:, None] - starts, 0.0, seg_us) * f32(t_f, 1e-6)
    if vels.shape[0] == 1:
        # one segment: the displacement's product fuses into the sum
        xy = fma(vels[0][None], dt[:, :1, None], base[None, :, :2])
    else:
        disp = vels[0][None] * dt[:, 0, None, None]        # (T, N, 2)
        for s in range(1, vels.shape[0]):
            disp = fma(vels[s][None], dt[:, s, None, None], disp)
        xy = base[None, :, :2] + disp
    b = ops["mob_bounds"]
    bx = fold_into_bounds(xy[..., 0], b[0], b[1])
    by = fold_into_bounds(xy[..., 1], b[2], b[3])
    # a zero-band node is pinned, never folded into the walkers' box
    moving = ops["mob_speed"][:, 1] > 0.0
    return torch.stack([
        torch.where(moving, bx, base[:, 0]),
        torch.where(moving, by, base[:, 1]),
        base[:, 2].expand_as(bx),
    ], dim=-1)


def _waypoint_positions(ops, t_us, W):
    wt = ops["mob_wp_t"]                                   # (N, W)
    wp = ops["mob_wp_p"]                                   # (N, W, 3)
    T, N = t_us.shape[0], wt.shape[0]
    idx = torch.clamp(
        (wt[None] <= t_us[:, None, None]).sum(-1) - 1, 0, W - 2
    )                                                      # (T, N)
    wt_b = wt[None].expand(T, N, W)
    t0 = torch.gather(wt_b, 2, idx[..., None])[..., 0]
    t1 = torch.gather(wt_b, 2, idx[..., None] + 1)[..., 0]
    wp_b = wp[None].expand(T, N, W, 3)
    gidx = idx[..., None, None].expand(T, N, 1, 3)
    p0 = torch.gather(wp_b, 2, gidx)[..., 0, :]
    p1 = torch.gather(wp_b, 2, gidx + 1)[..., 0, :]
    frac = torch.clamp(
        (t_us[:, None] - t0).to(torch.float32)
        / torch.clamp_min((t1 - t0).to(torch.float32), 1.0),
        0.0, 1.0,
    )                                                      # (T, N)
    return fma(p1 - p0, frac[..., None], p0)


def max_speed_mps(prog: MobilityProgram) -> float:
    """Upper bound on any node's speed over the run."""
    if prog.model == "static":
        return 0.0
    if prog.model == "const_velocity":
        return float(
            np.sqrt((prog.velocity.astype(np.float64) ** 2).sum(-1)).max()
        ) if prog.velocity.size else 0.0
    if prog.model == "random_walk":
        return float(prog.speed[:, 1].max()) if prog.speed.size else 0.0
    # waypoint: the fastest leg (zero-duration legs are pauses)
    t = prog.wp_t.astype(np.float64)
    p = prog.wp_p.astype(np.float64)
    dt = np.diff(t, axis=1) * 1e-6
    dp = np.sqrt((np.diff(p, axis=1) ** 2).sum(-1))
    with np.errstate(divide="ignore", invalid="ignore"):
        v = np.where(dt > 0.0, dp / np.maximum(dt, 1e-30), 0.0)
    return float(v.max()) if v.size else 0.0


def warn_geom_stride(who: str, mobility: MobilityProgram, geom_stride: int,
                     step_s: float) -> None:
    """Warn when the fastest node drifts further than
    :data:`GEOM_COHERENCE_M` between two geometry refreshes; the run
    still runs on the stale snapshot."""
    speed = max_speed_mps(mobility)
    drift_m = speed * geom_stride * step_s
    if drift_m > GEOM_COHERENCE_M:
        warnings.warn(
            f"{who}: geom_stride={geom_stride} lets the fastest node "
            f"({speed:.1f} m/s) drift ~{drift_m:.1f} m between geometry "
            f"refreshes (> the ~{GEOM_COHERENCE_M:.0f} m coherence scale "
            "of the loss models); lower the stride or accept the "
            "staleness",
            stacklevel=3,
        )


def trajectory_positions(prog: MobilityProgram, t_grid_us) -> np.ndarray:
    """``(T, N, 3)`` f32 positions at the µs times ``t_grid_us`` on the
    CPU, through the position math the engines run
    (``tpudes/ops/mobility.py:425-449``): what a lowering's guards read
    over a whole trajectory."""
    ops = prog.operands("cpu")
    t = torch.as_tensor(np.asarray([int(v) for v in t_grid_us], np.int32))
    return build_position_fn(prog)(ops, t).numpy()
