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
the same integers without a ``(T, N, C)`` temporary.  ``gap_fn`` and
``avg_mult`` are not ported (the WiFi BSS and AS-flow paths need them).
"""

from __future__ import annotations

import torch

from tpudes_torch.ops.fused import f32, fma, powf
from tpudes_torch.random import fold_in, uniform
from tpudes_torch.traffic.program import GAP_INF, TRAFFIC_MODEL_IDS

__all__ = ["TRAFFIC_KEY_TAG", "cum_packets", "offered_table", "pareto_sizes"]

#: fold tag of the run's traffic key: ``fold_in(key, TRAFFIC_KEY_TAG)``
#: (``device.py:50``, ``lte_sm.py:1016``)
TRAFFIC_KEY_TAG = 0x7A

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
