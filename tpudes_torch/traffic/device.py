"""The offered-bits table: a traffic program's arrivals per TTI window.

Counterpart of ``tpudes/traffic/device.py``'s ``build_cum_fn`` and
``build_bits_fn`` (``device.py:75-182``, ``:278-318``), batched over the
windows of a whole launch: where the reference's LTE loop calls
``bits_fn(ops, tr_key, t * 1000, (t + 1) * 1000)`` once per TTI,
:func:`offered_table` returns every TTI of ``[t0, t1)`` at once, shared
by all replicas and config points.

The arithmetic is the reference's compiled arithmetic (its optimised
HLO on the CPU, :mod:`tpudes_torch.ops.fused`): a product feeding a sum
is one fused multiply-add, ``x ** y`` is glibc's ``powf``, and
``lo / b ** (1 / a)`` is ``lo * b ** -(1 / a)``.  Two counts differ in
form only: the onoff cycle index ``sum(on_start <= tau)`` and the trace
count ``sum(arr_t <= t)`` are ``searchsorted`` over rows that ascend,
the same integers without a ``(T, N, C)`` temporary.

:func:`entry_gaps` is ``build_gap_fn`` (``device.py:185-258``), the
WiFi BSS's next inter-arrival gap, taken only at the entries that
arrive (the reference computes every entity's and keeps the arrivals':
no branch has a side effect).  :func:`avg_mult` is ``avg_mult``
(``device.py:321-340``), the AS flow engine's fluid view of a workload.
"""

from __future__ import annotations

import torch

from tpudes_torch.ops.fused import f32, fma, log1p, powf
from tpudes_torch.random import TRAFFIC_KEY_TAG, fold_in, uniform
from tpudes_torch.traffic.program import GAP_INF, TRAFFIC_MODEL_IDS

__all__ = [
    "TRAFFIC_KEY_TAG", "app_cum_table", "avg_mult", "cum_packets",
    "entry_gaps",
    "offered_table", "pareto_sizes", "stack_traffic_operands",
]

_TRACE = TRAFFIC_MODEL_IDS["trace"]


def _select(tr_id, cbr, mmpp, onoff, trace):
    return torch.where(
        tr_id == _TRACE, trace,
        torch.where(tr_id == TRAFFIC_MODEL_IDS["onoff"], onoff,
                    torch.where(tr_id == TRAFFIC_MODEL_IDS["mmpp"], mmpp,
                                cbr)),
    )


def _ascending_rows(x: torch.Tensor) -> torch.Tensor:
    """``(N, K)`` rows as ``searchsorted`` takes them: contiguous int32."""
    return x.to(torch.int32).contiguous()


def cum_packets(ops: dict, epoch_us: int, t_us: torch.Tensor) -> torch.Tensor:
    """Cumulative offered packets in ``[0, t_us]`` (``build_cum_fn``):
    ``t_us`` is ``(T,)`` int32 times, the result ``(T, N)`` f32."""
    start = ops["tr_start"]
    tv = t_us.to(torch.int32)[:, None]                       # (T, 1)
    tau = torch.clamp_min(tv - start, 0)                     # (T, N)
    tau_f = tau.float()
    started = tv >= start
    z = f32(tau_f, 0.0)

    # cbr: arrivals at start + k interval, k >= 0
    iv = ops["tr_interval"]
    a_cbr = torch.where(started & (iv < GAP_INF),
                        tau // torch.clamp_min(iv, 1) + 1, 0).float()

    # mmpp: rate x the closed-form cumulative intensity of the epochs
    S = ops["tr_epoch_rate"].shape[0]
    e = torch.clamp(tau // int(epoch_us), 0, S - 1).long()
    ep = f32(tau_f, float(epoch_us))
    since = torch.minimum(fma(-e.float(), ep, tau_f), ep)
    lam = fma(ops["tr_epoch_rate"][e] * since, f32(tau_f, 1e-6),
              ops["tr_epoch_cum"][e])
    a_mmpp = ops["tr_rate"] * lam * started.float()

    # onoff: packets before the current cycle + the peak-rate fill of its
    # burst; the cycle is the count of starts at or before tau, minus one
    on_start = ops["tr_on_start"]                            # (N, C)
    C = on_start.shape[1]
    hits = torch.searchsorted(_ascending_rows(on_start),
                              tau.t().contiguous(), right=True)
    c = torch.clamp(hits - 1, 0, C - 1).t()                  # (T, N)

    def pick(name):                                          # cycle c's
        return torch.gather(ops[name].expand(len(tau), -1, -1), 2,
                            c[..., None])[..., 0]

    in_burst = torch.maximum(tau_f - pick("tr_on_start").float(), z)
    fill = torch.minimum(in_burst, pick("tr_on_len").float()) * f32(tau_f,
                                                                     1e-6)
    a_onoff = fma(pick("tr_peak"), fill, pick("tr_cum_pk")) * started.float()

    # trace: the count of live table entries at or before t
    arr_t = ops["tr_arr_t"]
    live_n = (arr_t < GAP_INF).sum(1)
    hit = torch.searchsorted(_ascending_rows(arr_t),
                             tv.expand(-1, arr_t.shape[0]).t().contiguous(),
                             right=True).t()
    a_trace = torch.minimum(hit, live_n).float()

    return _select(ops["tr_id"], a_cbr, a_mmpp, a_onoff, a_trace)


def avg_mult(ops: dict, epoch_us: int, horizon_us: int) -> torch.Tensor:
    """``(N,)`` f32: each entity's realized over nominal offered rate over
    ``[0, horizon_us]`` (``device.py:321-340``): :func:`cum_packets` at
    the horizon over ``max(tr_rate * max(horizon, 1) * 1e-6, 1e-9)``, and
    exactly 1.0 for cbr."""
    t = torch.full((1,), int(horizon_us), dtype=torch.int32,
                   device=ops["tr_rate"].device)
    h_s = torch.clamp_min(t.float(), 1.0) * f32(ops["tr_rate"], 1e-6)
    nominal = torch.clamp_min(ops["tr_rate"] * h_s, f32(h_s, 1e-9))
    m = cum_packets(ops, epoch_us, t)[0] / nominal
    return torch.where(ops["tr_id"] == TRAFFIC_MODEL_IDS["cbr"],
                       f32(m, 1.0), m)


def app_cum_table(ops: dict, epoch_us: int, slot_us: int, t0: int,
                  t1: int) -> torch.Tensor:
    """``(P, t1 - t0, N)`` int32: the whole packets each entity of each
    point of the stacked operands (:func:`stack_traffic_operands`) has
    offered by the end of slots ``[t0, t1)``, ``floor(cum((t + 1)
    slot_us))`` cast to int32, the TCP dumbbell's app limit
    (``tpudes/parallel/tcp_dumbbell.py:955-973``).  The time is the
    reference's int32 product (it wraps as the reference's does), and
    :func:`cum_packets` takes every slot of a point in one call."""
    dev = ops["tr_start"].device
    t_us = torch.arange(t0 + 1, t1 + 1, dtype=torch.int32,
                        device=dev) * int(slot_us)
    points = ops["tr_start"].shape[0]
    return torch.stack([
        torch.floor(cum_packets({k: v[p] for k, v in ops.items()}, epoch_us,
                                t_us)).to(torch.int32)
        for p in range(points)]).contiguous()


def pareto_sizes(u: torch.Tensor, tr_size: torch.Tensor) -> torch.Tensor:
    """Bounded-Pareto packet sizes of the draws ``u``
    (``_traced_pareto_sizes``, ``device.py:261``), as its optimised HLO
    computes them: ``lo * (1 - u (1 - r)) ** -(1/a)`` with ``r = (lo /
    h) ** a``, the base one fused multiply-add."""
    alpha, lo, hi = tr_size[0], tr_size[1], tr_size[2]
    degen = (alpha <= 0.0) | (hi <= lo)
    one = f32(u, 1.0)
    a = torch.where(degen, one, alpha)
    h = torch.maximum(hi, lo * f32(u, 1.0 + 1e-6))
    r = powf(lo / h, a)
    base = fma(-u, one - r, one)
    drawn = lo * powf(base, -(one / a))
    return torch.where(degen, lo, drawn)


def offered_table(ops: dict, epoch_us: int, tr_key: torch.Tensor, t0: int,
                  t1: int) -> torch.Tensor:
    """``(t1 - t0, N)`` f32 offered bits: row ``i`` is the reference's
    ``bits_fn(ops, tr_key, (t0+i) 1000, (t0+i+1) 1000)`` — trace entities
    their exact bytes in the window, the others the packets the window
    adds (``floor`` of the cumulative count at its two edges) times one
    bounded-Pareto size drawn per (entity, window) from
    ``uniform(fold_in(fold_in(tr_key, entity), window start µs), ())``.
    The cumulative count is taken once at the ``T + 1`` window edges and
    differenced.  ``tr_key`` is the run's ``(2,)`` traffic key."""
    dev = ops["tr_start"].device
    n = ops["tr_start"].shape[0]
    edges = torch.arange(t0, t1 + 1, dtype=torch.int64, device=dev) * 1000
    cum = torch.floor(cum_packets(ops, epoch_us, edges - 1))
    d_pkts = torch.clamp_min(cum[1:] - cum[:-1], 0.0)        # (T, N)

    ent_keys = fold_in(tr_key[None, :], torch.arange(n, device=dev))
    keys = fold_in(ent_keys[None, :, :], edges[:-1, None])   # (T, N, 2)
    u = uniform(keys, 1)[..., 0]
    gen_bits = d_pkts * pareto_sizes(u, ops["tr_size"]) * 8.0

    # trace: bytes of the live entries in [start, end) of each window
    arr_t = _ascending_rows(ops["tr_arr_t"])
    live_b = torch.where(arr_t < GAP_INF, ops["tr_arr_b"], 0).long()
    cum_b = torch.nn.functional.pad(torch.cumsum(live_b, 1), (1, 0))
    before = torch.searchsorted(
        arr_t, edges.to(torch.int32)[None, :].expand(n, -1).contiguous()
    )                                                        # (N, T + 1)
    in_win = torch.gather(cum_b, 1, before)
    tr_bits = (in_win[:, 1:] - in_win[:, :-1]).t().to(torch.int32).float()
    return torch.where(ops["tr_id"] == _TRACE, tr_bits * 8.0,
                       gen_bits).contiguous()


def stack_traffic_operands(progs, device=None) -> dict:
    """The operand dicts of same-shape programs stacked on a leading
    point axis, ``(P, N, ...)`` (``device.py:58-72``): a workload sweep's
    operands, or one program's with ``P = 1``."""
    keys = {p.shape_key() for p in progs}
    if len(keys) != 1:
        raise ValueError(
            f"workload sweep points must share one traffic shape key (got "
            f"{sorted(keys)}); pad tables to a common capacity"
        )
    ops = [p.operands(device) for p in progs]
    return {k: torch.stack([o[k] for o in ops]) for k in ops[0]}


def _round_gap(x: torch.Tensor) -> torch.Tensor:
    """``clip(round(x), 1, GAP_INF)`` as int32 (round half to even)."""
    return torch.clamp(torch.round(x), 1.0, float(GAP_INF)).to(torch.int32)


def entry_gaps(ops: dict, epoch_us: int, point: torch.Tensor,
               ent: torch.Tensor, keys: torch.Tensor, t_arr: torch.Tensor,
               models=None) -> torch.Tensor:
    """``(G,)`` int32 µs from an arrival of entity ``ent[g]`` at
    ``t_arr[g]`` to its next one, under point ``point[g]`` of the
    stacked operands (:func:`stack_traffic_operands`) and the replica's
    traffic key ``keys[g]`` (``build_gap_fn``, ``device.py:185-258``):

    - cbr: the interval;
    - mmpp: ``-log1p(-min(u, 1 - 1e-7)) / max(rate, 1e-9)`` s, rounded
      half to even in µs, with ``u = uniform(fold_in(fold_in(key, ent),
      t_arr), ())`` and ``rate`` the entity's times its epoch's;
    - onoff: the peak spacing inside the burst, else a jump to the next
      burst's start (:data:`GAP_INF` past the table);
    - trace: the next live table entry.

    Only the entity's own model's value is kept, as ``_select`` keeps
    it, so a model no entity runs (absent from ``models``, the model
    ids of the operands; None: all four) is not computed.  int32 sums
    wrap as the reference's do."""
    i32 = torch.int32
    p, e = point.long(), ent.long()
    t = t_arr.to(i32)
    inf = torch.tensor(int(GAP_INF), dtype=i32, device=t.device)
    tau = torch.clamp_min(t - ops["tr_start"][p, e], 0)
    models = set(TRAFFIC_MODEL_IDS.values()) if models is None else models
    g_cbr = ops["tr_interval"][p, e]
    g_mmpp = g_onoff = g_trace = g_cbr       # never selected where absent

    if TRAFFIC_MODEL_IDS["mmpp"] in models:
        # the exponential gap at the epoch's rate
        S = ops["tr_epoch_rate"].shape[1]
        ep = torch.clamp(torch.div(tau, int(epoch_us), rounding_mode="floor"),
                         0, S - 1).long()
        rate = ops["tr_rate"][p, e] * ops["tr_epoch_rate"][p, ep]
        u = uniform(fold_in(fold_in(keys, ent.long()), t.long()), 1)[..., 0]
        g_exp = -log1p(-torch.minimum(u, f32(u, 1.0 - 1e-7))) / (
            torch.clamp_min(rate, f32(u, 1e-9)))
        g_mmpp = torch.where(rate > f32(u, 1e-9),
                             _round_gap(g_exp * f32(u, 1e6)), inf)

    if TRAFFIC_MODEL_IDS["onoff"] in models:
        # the peak spacing inside the burst, else the next burst
        on_start = ops["tr_on_start"][p, e]                  # (G, C)
        C = on_start.shape[1]
        c = torch.clamp((on_start <= tau[:, None]).sum(1) - 1, 0, C - 1)
        on_s = on_start.gather(1, c[:, None])[:, 0]
        on_l = ops["tr_on_len"][p, e].gather(1, c[:, None])[:, 0]
        pk = ops["tr_peak"][p, e].gather(1, c[:, None])[:, 0]
        p_us = _round_gap(f32(pk, 1e6) / torch.clamp_min(pk, f32(pk, 1e-9)))
        end = on_s + on_l
        in_on = (tau >= on_s) & (tau < end)
        next_c = torch.clamp(c + 1, 0, C - 1)
        next_on = on_start.gather(1, next_c[:, None])[:, 0]
        jump = torch.where(next_c == c, inf,
                           torch.clamp_min(next_on - tau, 1))
        stays = in_on & (tau + p_us < end) & (pk > f32(pk, 1e-9))
        g_onoff = torch.where(stays, p_us, jump)

    if TRAFFIC_MODEL_IDS["trace"] in models:
        # the next live entry
        arr_t = ops["tr_arr_t"][p, e]                        # (G, K)
        K = arr_t.shape[1]
        idx = ((arr_t < inf) & (arr_t <= t[:, None])).sum(1)
        nxt = arr_t.gather(1, torch.clamp_max(idx, K - 1)[:, None])[:, 0]
        g_trace = torch.where((idx < K) & (nxt < inf),
                              torch.clamp_min(nxt - t, 1), inf)
    return _select(ops["tr_id"][p, e], g_cbr, g_mmpp, g_onoff,
                   g_trace).to(i32)
