"""Traffic programs: one entity batch's arrival workload.

Counterpart of ``tpudes/traffic/program.py``.  A :class:`TrafficProgram`
describes the arrivals of ``N`` entities under one model of the family
(:data:`TRAFFIC_MODEL_IDS`): ``cbr`` (fixed interval), ``mmpp`` (a
2-state Markov-modulated Poisson rate on an epoch grid), ``onoff``
(bounded-Pareto ON bursts at a peak rate, exponential OFF gaps) and
``trace`` (exact ``(time, bytes)`` replay).  Every stochastic choice is
drawn here, once, into tables keyed by ``fold_in`` streams
(:func:`traffic_tables`, with :mod:`tpudes_torch.random`'s threefry, bit
for bit the reference's), so the device side is closed-form arithmetic
over them (:mod:`tpudes_torch.traffic.device`).

The table arithmetic is the reference's numpy, copied; only the draws
come from the port.  :meth:`TrafficProgram.with_cbr_rows` pins some
entities to cbr (the BSS AP's beacons) and :func:`unify_shapes` pads the
points of a workload sweep to one shape (``program.py:178-197``,
``:382-431``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from tpudes_torch.device import resolve_device
from tpudes_torch.random import PRNGKey, fold_in, uniform

__all__ = [
    "GAP_INF", "TRAFFIC_MODEL_IDS", "TrafficProgram", "bounded_pareto_icdf",
    "bounded_pareto_mean", "traffic_tables", "unify_shapes",
]

#: model short name -> dispatch id (``program.py:66``)
TRAFFIC_MODEL_IDS = {"cbr": 0, "mmpp": 1, "onoff": 2, "trace": 3}

#: root key of every table stream: draws are
#: ``fold_in(fold_in(PRNGKey(root), tr_seed), ...)``
_TRAFFIC_ROOT_SEED = 0x7AF1C0

#: "no more arrivals" on the µs clock
GAP_INF = np.int32(2**30)


def bounded_pareto_icdf(u, alpha: float, lo: float, hi: float):
    """Inverse CDF of the bounded Pareto on ``[lo, hi]`` with shape
    ``alpha`` (numpy); ``alpha <= 0`` or ``hi <= lo`` is the constant
    ``lo``."""
    if alpha <= 0.0 or hi <= lo:
        return u * 0.0 + lo
    r = (lo / hi) ** alpha
    return lo / (1.0 - u * (1.0 - r)) ** (1.0 / alpha)


def bounded_pareto_mean(alpha: float, lo: float, hi: float) -> float:
    """Closed-form mean of the bounded Pareto, degenerate cases as in
    :func:`bounded_pareto_icdf`."""
    if alpha <= 0.0 or hi <= lo:
        return float(lo)
    if abs(alpha - 1.0) < 1e-9:
        return float(lo * hi / (hi - lo) * math.log(hi / lo))
    r = (lo / hi) ** alpha
    return float(
        (alpha * lo / (alpha - 1.0))
        * (1.0 - (lo / hi) ** (alpha - 1.0))
        / (1.0 - r)
    )


@dataclass(frozen=True)
class TrafficProgram:
    """One entity batch's arrival workload (``program.py:110``).  Build
    it with the factories, or carry the reference's over with
    :func:`tpudes_torch.convert.traffic_from_numpy`."""

    model: str                    # key of TRAFFIC_MODEL_IDS
    start_us: np.ndarray          # (N,) i32 workload start per entity
    interval_us: np.ndarray       # (N,) i32 cbr inter-arrival
    rate_pps: np.ndarray          # (N,) f32 nominal mean arrival rate
    mmpp_mult: np.ndarray         # (2,) f32 state rate multipliers
    mmpp_p: np.ndarray            # (2,) f32 per-epoch switch probs
    peak_pps: np.ndarray          # (N,) f32 ON-period arrival rate
    on_pareto: np.ndarray         # (3,) f32 (alpha, on_min_s, on_max_s)
    off_mean_s: float = 1.0       # exponential OFF mean (onoff)
    arr_t: np.ndarray = None      # (N, K) i32 µs trace times, ascending
    arr_b: np.ndarray = None      # (N, K) i32 trace bytes per arrival
    size_pareto: np.ndarray = None  # (3,) f32 (alpha, min_B, max_B)
    env: np.ndarray = None        # (3,) f32 (amp, period_s, phase)
    epoch_us: int = 100_000       # mmpp epoch length
    n_epoch: int = 1              # mmpp epoch-grid length
    n_cycle: int = 1              # onoff cycle-table length
    tr_seed: int = 0              # table stream seed
    #: (N,) i32 per-entity model override (None: every entity runs
    #: ``model``)
    model_id: np.ndarray = None

    def __post_init__(self):
        if self.model not in TRAFFIC_MODEL_IDS:
            raise ValueError(f"unknown traffic model {self.model!r}")
        if np.any(np.diff(np.asarray(self.arr_t, np.int64), axis=1) < 0):
            raise ValueError("trace arrival times must ascend per row")

    @property
    def n(self) -> int:
        return int(self.start_us.shape[0])

    def shape_key(self) -> tuple:
        """Everything that sets the shapes of the device math."""
        return (
            self.n, int(self.n_epoch), int(self.n_cycle),
            int(self.arr_t.shape[1]), int(self.epoch_us),
        )

    def param_key(self) -> tuple:
        """Hashable identity of the whole parameter set."""
        return (
            self.model, self.start_us.tobytes(),
            self.interval_us.tobytes(), self.rate_pps.tobytes(),
            self.mmpp_mult.tobytes(), self.mmpp_p.tobytes(),
            self.peak_pps.tobytes(), self.on_pareto.tobytes(),
            float(self.off_mean_s), self.arr_t.tobytes(),
            self.arr_b.tobytes(), self.size_pareto.tobytes(),
            self.env.tobytes(), int(self.epoch_us), int(self.n_epoch),
            int(self.n_cycle), int(self.tr_seed),
            None if self.model_id is None else self.model_id.tobytes(),
        )

    def model_ids(self) -> np.ndarray:
        """(N,) i32 effective per-entity model ids."""
        if self.model_id is not None:
            return np.asarray(self.model_id, np.int32)
        return np.full((self.n,), TRAFFIC_MODEL_IDS[self.model], np.int32)

    def with_cbr_rows(self, mask, interval_us, start_us=None):
        """A copy whose ``mask``-selected entities run cbr at
        ``interval_us`` (from ``start_us`` where given) in place of
        ``model``: how the BSS keeps the AP's beacons exact while the
        STAs burst (``program.py:178-197``)."""
        mask = np.asarray(mask, bool)
        ids = self.model_ids().copy()
        ids[mask] = TRAFFIC_MODEL_IDS["cbr"]
        iv = self.interval_us.copy()
        iv[mask] = np.minimum(
            np.asarray(interval_us, np.int64), GAP_INF
        ).astype(np.int32)
        start = self.start_us.copy()
        if start_us is not None:
            start[mask] = np.asarray(start_us, np.int32)
        return dataclasses.replace(
            self, model_id=ids, interval_us=iv, start_us=start
        )

    def operands(self, device=None) -> dict:
        """The device math's tensors on ``device`` (the card by
        default), the reference's operand dict (``program.py:199``):
        the tables are drawn once per program and the tensors made once
        per device."""
        device = resolve_device(device)
        cache = self.__dict__.setdefault("_operands_cache", {})
        ops = cache.get(str(device))
        if ops is None:
            t = traffic_tables(self)

            def on(a, dtype):
                return torch.as_tensor(np.asarray(a), dtype=dtype,
                                       device=device)

            i32, f32 = torch.int32, torch.float32
            ops = cache[str(device)] = dict(
                tr_id=on(self.model_ids(), i32),
                tr_start=on(self.start_us, i32),
                tr_interval=on(self.interval_us, i32),
                tr_rate=on(self.rate_pps, f32),
                tr_epoch_rate=on(t["epoch_rate"], f32),
                tr_epoch_cum=on(t["epoch_cum"], f32),
                tr_on_start=on(t["on_start"], i32),
                tr_on_len=on(t["on_len"], i32),
                tr_cum_pk=on(t["cum_pk"], f32),
                tr_peak=on(t["peak"], f32),
                tr_arr_t=on(self.arr_t, i32),
                tr_arr_b=on(self.arr_b, i32),
                tr_size=on(self.size_pareto, f32),
            )
        return dict(ops)

    # --- factories --------------------------------------------------------

    @classmethod
    def _fill(cls, model: str, n: int, **kw) -> "TrafficProgram":
        defaults = dict(
            start_us=np.zeros((n,), np.int32),
            interval_us=np.full((n,), GAP_INF, np.int32),
            rate_pps=np.zeros((n,), np.float32),
            mmpp_mult=np.ones((2,), np.float32),
            mmpp_p=np.zeros((2,), np.float32),
            peak_pps=np.zeros((n,), np.float32),
            on_pareto=np.asarray([0.0, 1.0, 1.0], np.float32),
            arr_t=np.full((n, 2), GAP_INF, np.int32),
            arr_b=np.zeros((n, 2), np.int32),
            size_pareto=np.asarray([0.0, 512.0, 512.0], np.float32),
            env=np.zeros((3,), np.float32),
        )
        defaults.update(kw)
        return cls(model=model, **defaults)

    @classmethod
    def cbr(cls, start_us, interval_us) -> "TrafficProgram":
        """Entity e fires at ``start + k * interval`` (``program.py:256``)."""
        start = np.asarray(start_us, np.int32)
        iv = np.asarray(
            np.broadcast_to(np.asarray(interval_us), start.shape), np.int64
        )
        rate = np.where(
            iv >= GAP_INF, 0.0, 1e6 / np.maximum(iv, 1)
        ).astype(np.float32)
        return cls._fill(
            "cbr", start.shape[0], start_us=start,
            interval_us=np.minimum(iv, GAP_INF).astype(np.int32),
            rate_pps=rate,
        )

    @classmethod
    def mmpp(
        cls, n: int, rate_pps, *, horizon_us: int,
        mult=(0.25, 3.0), switch_p=(0.3, 0.3), epoch_s: float = 0.1,
        start_us=0, envelope=None, tr_seed: int = 0,
    ) -> "TrafficProgram":
        """2-state Markov-modulated Poisson arrivals at long-run mean
        ``rate_pps`` (``program.py:274``)."""
        epoch_us = max(1, int(round(epoch_s * 1e6)))
        n_epoch = int(horizon_us) // epoch_us + 1
        mult = np.asarray(mult, np.float64).reshape(2)
        p01, p10 = (float(v) for v in np.reshape(switch_p, 2))
        tot = max(p01 + p10, 1e-9)
        stationary_mean = (p10 * mult[0] + p01 * mult[1]) / tot
        mult = mult / max(stationary_mean, 1e-9)
        return cls._fill(
            "mmpp", n,
            start_us=np.broadcast_to(
                np.asarray(start_us, np.int32), (n,)
            ).copy(),
            rate_pps=np.broadcast_to(
                np.asarray(rate_pps, np.float32), (n,)
            ).copy(),
            mmpp_mult=mult.astype(np.float32),
            mmpp_p=np.asarray(switch_p, np.float32).reshape(2),
            env=_env_params(envelope),
            epoch_us=epoch_us, n_epoch=n_epoch, tr_seed=int(tr_seed),
        )

    @classmethod
    def onoff(
        cls, n: int, peak_pps, *, horizon_us: int,
        on=(1.5, 0.2, 5.0), off_mean_s: float = 0.5,
        start_us=0, envelope=None, tr_seed: int = 0,
    ) -> "TrafficProgram":
        """Poisson-Pareto ON-OFF bursts (``program.py:309``): the cycle
        table holds enough cycles for ``horizon_us`` at the mean cycle
        length, twice over."""
        on = np.asarray(on, np.float32).reshape(3)
        mean_on = bounded_pareto_mean(float(on[0]), float(on[1]),
                                      float(on[2]))
        mean_cycle = mean_on + float(off_mean_s)
        n_cycle = max(2, int(2.0 * horizon_us / 1e6 / max(mean_cycle, 1e-6))
                      + 4)
        peak = np.broadcast_to(np.asarray(peak_pps, np.float32), (n,))
        duty = mean_on / max(mean_cycle, 1e-9)
        return cls._fill(
            "onoff", n,
            start_us=np.broadcast_to(
                np.asarray(start_us, np.int32), (n,)
            ).copy(),
            rate_pps=(peak * np.float32(duty)).copy(),
            peak_pps=peak.copy(),
            on_pareto=on,
            off_mean_s=float(off_mean_s),
            env=_env_params(envelope),
            n_cycle=n_cycle, tr_seed=int(tr_seed),
        )

    @classmethod
    def trace_replay(cls, arr_t, arr_b=None) -> "TrafficProgram":
        """Exact replay of ``(N, K)`` µs arrival times, ascending per row
        (pad with any value >= :data:`GAP_INF`), and their bytes (512 by
        default) (``program.py:343``)."""
        arr_t = np.asarray(arr_t, np.int64)
        if arr_t.ndim != 2:
            raise ValueError("arr_t must be (N, K)")
        if arr_t.shape[1] < 2:
            arr_t = np.concatenate(
                [arr_t, np.full_like(arr_t, GAP_INF)], axis=1
            )
        live = arr_t < GAP_INF
        srt = np.where(live, arr_t, GAP_INF)
        if (np.diff(srt, axis=1) < 0).any():
            raise ValueError("trace arrival times must ascend per row")
        arr_t = np.minimum(arr_t, GAP_INF).astype(np.int32)
        n, k = arr_t.shape
        if arr_b is None:
            arr_b = np.full((n, k), 512, np.int32)
        else:
            arr_b = np.asarray(arr_b, np.int32)
            if arr_b.shape[1] < k:
                arr_b = np.concatenate(
                    [arr_b, np.zeros((n, k - arr_b.shape[1]), np.int32)],
                    axis=1,
                )
        dur_s = max(float(srt[live].max(initial=0)) * 1e-6, 1e-6)
        rate = (live.sum(axis=1) / dur_s).astype(np.float32)
        return cls._fill(
            "trace", n,
            start_us=np.where(
                live.any(axis=1), srt.min(axis=1), GAP_INF
            ).astype(np.int32),
            rate_pps=rate, arr_t=arr_t, arr_b=arr_b,
        )


def unify_shapes(progs) -> list:
    """The points of a workload sweep padded to one
    :meth:`TrafficProgram.shape_key` (``program.py:382-431``): the epoch
    grid, the cycle table and the trace width grow to the largest, the
    trace rows padded with the never-arriving :data:`GAP_INF`.  Padding
    keeps every realisation (the tables are per-index ``fold_in``
    streams).  The entity counts must agree, and so must ``epoch_us``
    among the points whose epoch grid has more than one epoch."""
    progs = list(progs)
    if len({p.n for p in progs}) != 1:
        raise ValueError("workload sweep points must share the entity count")
    used = {int(p.epoch_us) for p in progs if int(p.n_epoch) > 1}
    if len(used) > 1:
        raise ValueError(
            "workload sweep points must share epoch_us; build the mmpp "
            "points with one epoch_s"
        )
    epoch_us = used.pop() if used else int(progs[0].epoch_us)
    progs = [
        p if int(p.epoch_us) == epoch_us
        else dataclasses.replace(p, epoch_us=epoch_us)
        for p in progs
    ]
    S = max(int(p.n_epoch) for p in progs)
    C = max(int(p.n_cycle) for p in progs)
    K = max(int(p.arr_t.shape[1]) for p in progs)
    out = []
    for p in progs:
        arr_t, arr_b = p.arr_t, p.arr_b
        k0 = arr_t.shape[1]
        if k0 < K:
            n = arr_t.shape[0]
            arr_t = np.concatenate(
                [arr_t, np.full((n, K - k0), GAP_INF, np.int32)], axis=1
            )
            arr_b = np.concatenate(
                [arr_b, np.zeros((n, K - k0), np.int32)], axis=1
            )
        out.append(dataclasses.replace(
            p, n_epoch=S, n_cycle=C, arr_t=arr_t, arr_b=arr_b
        ))
    return out


def _env_params(envelope) -> np.ndarray:
    """(amp, period_s, phase); None is flat (amp 0)."""
    if envelope is None:
        return np.zeros((3,), np.float32)
    amp, period_s, phase = envelope
    if not (0.0 <= float(amp) < 1.0):
        raise ValueError("envelope amplitude must be in [0, 1)")
    if float(period_s) <= 0.0:
        raise ValueError("envelope period must be positive")
    return np.asarray([float(amp), float(period_s), float(phase)],
                      np.float32)


def _env_at(env: np.ndarray, t_s: np.ndarray) -> np.ndarray:
    """Diurnal multiplier at time ``t_s``."""
    amp, period, phase = (float(v) for v in env)
    if amp == 0.0:
        return np.ones_like(np.asarray(t_s, np.float64))
    return np.maximum(
        1.0 + amp * np.sin(2.0 * math.pi * (t_s / period - phase)), 0.0
    )


def _draws(key: torch.Tensor, index: np.ndarray, n: int) -> np.ndarray:
    """``uniform(fold_in(key, i), (n,))`` for every ``i`` of ``index``
    (any shape of leading key axes, as the reference's ``vmap`` draws
    them): ``index.shape + (n,)`` f32."""
    k = fold_in(key, torch.as_tensor(index, dtype=torch.int64))
    return uniform(k, n).numpy()


def traffic_tables(prog: TrafficProgram) -> dict:
    """The stochastic tables (numpy), as ``program.py:458`` draws them:

    - ``epoch_rate`` (S,) f32 — mmpp per-epoch rate multiplier;
    - ``epoch_cum`` (S+1,) f32 — its prefix integral (multiplier-s);
    - ``on_start``/``on_len`` (N, C) i32 µs — the ON bursts;
    - ``peak`` (N, C) f32 — per-cycle ON rate;
    - ``cum_pk`` (N, C) f32 — offered packets before cycle c starts.

    Drawn on the CPU once per program and kept."""
    cached = prog.__dict__.get("_tables_cache")
    if cached is not None:
        return cached
    key = fold_in(PRNGKey(_TRAFFIC_ROOT_SEED), int(prog.tr_seed))
    S, C, N = int(prog.n_epoch), int(prog.n_cycle), prog.n
    out: dict = {}

    # mmpp: the modulating chain on the epoch grid, one draw per epoch
    u = _draws(fold_in(key, 0), np.arange(S), 1)[:, 0]
    p01, p10 = float(prog.mmpp_p[0]), float(prog.mmpp_p[1])
    states = np.zeros(S, np.int32)
    s = 0
    for e in range(S):
        states[e] = s
        s = (1 - s) if u[e] < (p01 if s == 0 else p10) else s
    mids = (np.arange(S) + 0.5) * (prog.epoch_us * 1e-6)
    epoch_rate = (
        np.asarray(prog.mmpp_mult, np.float64)[states]
        * _env_at(prog.env, mids)
    ).astype(np.float32)
    epoch_cum = np.zeros(S + 1, np.float32)
    epoch_cum[1:] = np.cumsum(
        epoch_rate.astype(np.float64) * (prog.epoch_us * 1e-6)
    ).astype(np.float32)
    out["epoch_rate"] = epoch_rate
    out["epoch_cum"] = epoch_cum

    # onoff: one (2,) draw per (entity, cycle), keyed
    # fold_in(fold_in(k_cyc, entity), cycle)
    k_ent = fold_in(fold_in(key, 1)[None, :], torch.arange(N))   # (N, 2)
    uc = _draws(k_ent[:, None, :], np.arange(C)[None, :], 2)      # (N, C, 2)
    alpha, on_lo, on_hi = (float(v) for v in prog.on_pareto)
    on_s = bounded_pareto_icdf(uc[..., 0], alpha, on_lo, on_hi)
    off_s = -float(prog.off_mean_s) * np.log1p(
        -np.minimum(uc[..., 1], 1.0 - 1e-7)
    )
    on_us = np.maximum(np.round(on_s * 1e6), 1.0)
    off_us = np.maximum(np.round(off_s * 1e6), 1.0)
    starts = np.zeros((N, C), np.float64)
    starts[:, 1:] = np.cumsum(on_us + off_us, axis=1)[:, :-1]
    on_start = np.minimum(starts, float(GAP_INF)).astype(np.int32)
    on_len = np.minimum(on_us, float(GAP_INF)).astype(np.int32)
    cycle_t = starts * 1e-6
    peak = (
        prog.peak_pps.astype(np.float64)[:, None]
        * _env_at(prog.env, cycle_t)
    ).astype(np.float32)
    cum_pk = np.zeros((N, C), np.float32)
    cum_pk[:, 1:] = np.cumsum(
        peak[:, :-1].astype(np.float64) * on_len[:, :-1] * 1e-6, axis=1
    ).astype(np.float32)
    out["on_start"] = on_start
    out["on_len"] = on_len
    out["peak"] = peak
    out["cum_pk"] = cum_pk

    object.__setattr__(prog, "_tables_cache", out)
    return out
