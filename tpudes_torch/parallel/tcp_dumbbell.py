"""The TCP dumbbell replica engine on the card (BASELINE config #2).

Counterpart of ``tpudes/parallel/tcp_dumbbell.py``: R Monte-Carlo
replicas of one dumbbell (F bulk TCP flows left to right through one
bottleneck, the tcp-variants-comparison shape) advance one **packet
slot** at a time, a slot being the bottleneck's serialization time τ.
Per replica and flow the state is ``(R, F)`` tensors, the ack, loss
and ECN-echo rings ``(R, L, F)`` and the RTT ring ``(R, L)``; all
seventeen TcpCongestionOps variants are evaluated as masked vector rules
in one step (:func:`cwnd_increase`, :func:`loss_response`), and the
bottleneck is a droptail FIFO or RED (gentle, ECN marking, hard drop).

The slot loop is :func:`tcp_advance`: on the card one launch of the
persistent kernel ``csrc/tcp_advance.cu`` (:mod:`tpudes_torch.parallel.
tcp_cuda`) runs every slot of a chunk for every replica, one warp per
replica; on the CPU :func:`tcp_advance_math` runs :func:`step_math` in a
loop.  Replica ``r`` draws slot ``t``'s numbers from ``fold_in(fold_in(
key, t), r)`` (:func:`tpudes_torch.random.tcp_draws`), the reference's
streams bit for bit, so a run is comparable with the JAX engine per
replica.  The ``variants=[...]`` sweep is a ``(C, R)`` grid: C variant
assignments of the same program, each row its point's variant ids and
ECN flags; the ``traffic_sweep=[...]`` sweep is the same grid over C
workloads, the variants and ECN flags shared.

An app-limited program (``prog.traffic``, a
:class:`~tpudes_torch.traffic.program.TrafficProgram` of one entity a
flow) clips each flow's sending to what its application has offered by
the end of the slot: ``want = min(want, max(floor(cum((t + 1) slot_us)) -
delivered - inflight, 0))`` (``tcp_dumbbell.py:955-973``), the cum a
function of ``(point, t, flow)`` shared by the replicas.  A launch reads
it from an ``(C, T, F)`` int32 table of its slots
(:func:`tpudes_torch.traffic.device.app_cum_table`).

The step's arithmetic is the reference's as its CPU backend compiles it
(its optimised HLO of the jitted advance): a product feeding a sum it
alone feeds is one fused multiply-add (:func:`~tpudes_torch.ops.fused.
fma`); a division by a constant is a product with the constant's f32
reciprocal, and a constant factor before it folds into that product
(:func:`folded`); ``log``, ``cbrt`` and ``power`` are the compiled ones
(:mod:`tpudes_torch.ops.fused`).

The engine runs on :mod:`tpudes_torch.parallel.runtime`: the program's
constants sit in the runner cache (keyed by value, as the reference's
``dumbbell_prog_key``), the replica axis is padded to its power-of-two
bucket (a replica's draws are a pure function of ``(key, t, r)``, so the
real replicas cannot move), the chunks go through ``drive_chunks``
(``checkpoint=`` saves the carry after each), and ``block=False``
returns an :class:`~tpudes_torch.parallel.runtime.EngineFuture`.
:func:`tcp_study` is the serving layer's descriptor.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``mesh`` (A12) and the ``TpudesObs`` columns (A10).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from tpudes_torch.device import resolve_device, to_device
from tpudes_torch.ops.fused import cbrt, device_table, f32, fma, log, powf
from tpudes_torch.parallel.runtime import (
    RUNTIME,
    EngineFuture,
    _not_ported,
    bucket_replicas,
    chunk_bounds,
    drive_chunks,
    finalize_with_flush,
)
from tpudes_torch.random import tcp_draws
from tpudes_torch.traffic.device import app_cum_table, stack_traffic_operands

# variant ids: the reference's vector-rule dispatch table
# (``tcp_dumbbell.py:54-60``)
VARIANTS = ("TcpNewReno", "TcpCubic", "TcpScalable", "TcpHighSpeed",
            "TcpVegas", "TcpVeno", "TcpLinuxReno", "TcpBic", "TcpWestwood",
            "TcpIllinois", "TcpHybla", "TcpBbr", "TcpDctcp", "TcpHtcp",
            "TcpYeah", "TcpLedbat", "TcpLp")
(V_NEWRENO, V_CUBIC, V_SCALABLE, V_HIGHSPEED, V_VEGAS, V_VENO,
 V_LINUXRENO, V_BIC, V_WESTWOOD, V_ILLINOIS, V_HYBLA, V_BBR,
 V_DCTCP, V_HTCP, V_YEAH, V_LEDBAT, V_LP) = range(17)
#: the variants whose class sets ``REQUIRES_ECN``
#: (``tpudes/models/internet/tcp_congestion.py:654-662``: DCTCP)
REQUIRES_ECN = frozenset({"TcpDctcp"})

# the rules' constants (``tcp_dumbbell.py:62-84``)
INIT_CWND = 10.0
SSTHRESH0 = 1e9
CUBIC_C = 0.4
CUBIC_BETA = 0.7
SCALABLE_AI = 50.0
SCALABLE_MD = 0.125
HS_LOW_WINDOW = 38.0
VEGAS_ALPHA, VEGAS_BETA, VEGAS_GAMMA = 2.0, 4.0, 1.0
VENO_BETA = 3.0
BIC_BETA, BIC_LOW_WND, BIC_MAX_INCR, BIC_SMIN = 0.8, 14.0, 16.0, 0.01
ILL_ALPHA_MAX, ILL_ALPHA_MIN = 10.0, 0.3
ILL_BETA_MAX, ILL_BETA_MIN = 0.5, 0.125
HYBLA_RRTT = 0.025
BBR_HIGH_GAIN = 2.89
BBR_CYCLE_GAINS = (1.25, 0.75, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0)
BBR_STARTUP, BBR_DRAIN, BBR_PROBE_BW = range(3)
BBR_BW_DECAY = 0.98
DCTCP_G = 0.0625
HTCP_DELTA_B = 1.0
HTCP_DEFAULT_BACKOFF = 0.5
YEAH_ALPHA, YEAH_QMAX, YEAH_RHO = 80.0, 8.0, 0.125
LEDBAT_TARGET_S, LEDBAT_GAIN = 0.1, 1.0
LP_INFERENCE_FRAC = 0.15
INT32_MAX = 2**31 - 1


@dataclass(frozen=True)
class DumbbellProgram:
    """Static description of one dumbbell scenario on the replica axis
    (``tcp_dumbbell.py:119-159``)."""

    n_flows: int
    variant_idx: np.ndarray      # (F,) index into VARIANTS
    start_slot: np.ndarray       # (F,) first slot each flow may send
    stop_slot: np.ndarray        # (F,) no new packets at/after this slot
    max_pkts: np.ndarray         # (F,) segment budget (INT32_MAX = unlimited)
    slot_s: float                # τ: bottleneck serialization time
    n_slots: int                 # simulation horizon in slots
    ack_lag: int                 # slots from departure to ack arrival
    queue_cap: int               # bottleneck queue capacity (packets)
    burst_cap: int               # per-flow packets enqueueable per slot
    base_rtt_s: float            # unloaded RTT (for Vegas/Veno diff)
    seg_bytes: int               # application payload per packet
    #: (F,) ECN-capable flows (a REQUIRES_ECN variant or a UseEcn socket)
    ecn: np.ndarray = None
    #: bottleneck AQM: "fifo" (tail drop) or "red"
    qdisc: str = "fifo"
    red_min_th: float = 5.0
    red_max_th: float = 15.0
    red_max_p: float = 0.02      # 1 / LInterm
    red_qw: float = 0.002
    red_gentle: bool = True
    red_use_ecn: bool = False
    red_use_hard_drop: bool = True
    #: app-limited workload: a TrafficProgram of one entity a flow, its
    #: cumulative offered segments capping each flow's sending (None: bulk)
    traffic: object = None

    @property
    def buf_len(self) -> int:
        return self.ack_lag + 2


def variant_point(entry) -> np.ndarray:
    """One sweep point: ``(F,)`` int32 variant ids from names or ids
    (``tcp_dumbbell.py:1232-1237``)."""
    return np.asarray(
        [VARIANTS.index(v) if isinstance(v, str) else int(v) for v in entry],
        np.int32,
    )


def variant_ecn(variant_idx) -> np.ndarray:
    """``(F,)`` ECN capability the variant alone implies (its
    ``REQUIRES_ECN``), what a sweep point can know
    (``tcp_dumbbell.py:1240-1253``)."""
    return np.asarray([VARIANTS[int(i)] in REQUIRES_ECN
                       for i in variant_idx], bool)


def folded(c1: float, c2: float) -> float:
    """The f32 constant the reference's compiler makes of ``c1 * x /
    c2``: the division becomes a product with ``f32(1 / f32(c2))``, and
    the two constant factors fold into one, ``f32(f32(c1) * that)``."""
    one = np.float32(1.0)
    return float(np.float32(c1) * (one / np.float32(c2)))


# --------------------------------------------------------------------------
# state
# --------------------------------------------------------------------------

#: the state layout: (key, axis, dtype) with axis "f" = (C, R, F), "lf" =
#: (C, R, L, F), "l" = (C, R, L), "r" = (C, R), in the reference's
#: init_state order (``tcp_dumbbell.py:791-833``), its ``side`` dict's
#: fields flattened after the rest
TCP_STATE = (
    ("cwnd", "f", "f32"), ("ssthresh", "f", "f32"),
    ("inflight", "f", "i32"), ("q", "f", "i32"), ("q_marked", "f", "f32"),
    ("delivered", "f", "i32"), ("drops", "f", "i32"),
    ("recover_until", "f", "i32"),
    ("ack_buf", "lf", "i32"), ("loss_buf", "lf", "i32"),
    ("mark_buf", "lf", "f32"), ("rtt_buf", "l", "f32"),
    ("qsum", "r", "f32"), ("red_avg", "r", "f32"),
    ("dctcp_acked", "f", "f32"), ("dctcp_marked", "f", "f32"),
    ("w_max", "f", "f32"), ("epoch_t", "f", "f32"), ("k", "f", "f32"),
    ("origin", "f", "f32"), ("w_est", "f", "f32"), ("base_rtt", "f", "f32"),
    ("last_diff", "f", "f32"), ("min_rtt", "f", "f32"),
    ("ww_acc", "f", "f32"), ("bwe", "f", "f32"),
    ("ill_max_rtt", "f", "f32"), ("ill_alpha", "f", "f32"),
    ("ill_beta", "f", "f32"), ("bbr_acc", "f", "f32"),
    ("bbr_bw", "f", "f32"), ("bbr_full_bw", "f", "f32"),
    ("bbr_full_cnt", "f", "f32"), ("bbr_state", "f", "i32"),
    ("bbr_cycle", "f", "i32"), ("cwnd_cnt", "f", "f32"),
    ("dctcp_alpha", "f", "f32"), ("htcp_beta", "f", "f32"),
    ("htcp_last_cong", "f", "f32"), ("lp_until", "f", "f32"),
)
#: the reference's ``side`` dict: the variant rules' side state
SIDE_KEYS = tuple(k for k, _, _ in TCP_STATE[TCP_STATE.index(
    ("w_max", "f", "f32")):])
_DTYPES = {"f32": torch.float32, "i32": torch.int32}
#: each field's initial value (``tcp_dumbbell.py:791-833``); None: the
#: program's base RTT
_INIT = dict(cwnd=INIT_CWND, ssthresh=SSTHRESH0, epoch_t=-1.0,
             min_rtt=math.inf, ill_alpha=ILL_ALPHA_MAX,
             ill_beta=ILL_BETA_MIN, dctcp_alpha=1.0,
             htcp_beta=HTCP_DEFAULT_BACKOFF, rtt_buf=None, base_rtt=None)


def state_shape(axis: str, points: int, replicas: int, L: int,
                F: int) -> tuple:
    return {"f": (points, replicas, F), "lf": (points, replicas, L, F),
            "l": (points, replicas, L), "r": (points, replicas)}[axis]


def init_state(consts: dict, replicas: int, points: int = 1) -> dict:
    """The ``(C, R, ...)`` initial state of C points (``tcp_dumbbell.py:
    776-833``), on the constants' device."""
    dev = consts["start"].device
    out = {}
    for k, ax, dt in TCP_STATE:
        v = _INIT.get(k, 0.0)
        if v is None:
            v = float(np.float32(consts["base_rtt_s"]))
        shape = state_shape(ax, points, replicas, consts["L"], consts["F"])
        out[k] = torch.full(shape, v, dtype=_DTYPES[dt], device=dev)
    return out


def build_tcp_consts(prog: DumbbellProgram, device=None) -> dict:
    """The program's constants on ``device``: its per-flow tensors and the
    scalars of the step, the RED constants as the compiled step holds
    them (:func:`folded`)."""
    dev = resolve_device(device)
    if prog.qdisc not in ("fifo", "red"):
        raise ValueError(f"qdisc must be 'fifo' or 'red'; got {prog.qdisc!r}")
    F = int(prog.n_flows)
    i32 = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.int32).reshape(F), device=dev)
    red_span = max(prog.red_max_th - prog.red_min_th, 1e-9)
    return dict(
        F=F, L=prog.buf_len, ack_lag=int(prog.ack_lag),
        queue_cap=int(prog.queue_cap), burst=int(prog.burst_cap),
        rtt_slots=max(1, int(round(prog.base_rtt_s / prog.slot_s))),
        # the app-limit's clock: a slot in whole µs (``:774``)
        slot_us=max(1, int(round(prog.slot_s * 1e6))),
        slot_s=float(np.float32(prog.slot_s)),
        base_rtt_s=float(prog.base_rtt_s),
        start=i32(prog.start_slot), stop=i32(prog.stop_slot),
        max_pkts=i32(prog.max_pkts),
        red=prog.qdisc == "red",
        red_min_th=float(np.float32(prog.red_min_th)),
        red_max_th=float(np.float32(prog.red_max_th)),
        red_max_p=float(np.float32(prog.red_max_p)),
        red_forced_th=float(np.float32(
            2.0 * prog.red_max_th if prog.red_gentle else prog.red_max_th)),
        # p below max_th: (avg - min_th) * max_p / (max_th - min_th)
        red_lin=folded(prog.red_max_p, red_span),
        # gentle p past max_th: max_p + (avg - max_th) (1 - max_p) / max_th
        red_gentle_k=folded(1.0 - prog.red_max_p, prog.red_max_th),
        red_keep=float(np.float32(1.0 - prog.red_qw)),
        red_gentle=bool(prog.red_gentle),
        red_ecn=bool(prog.red_use_ecn),
        red_hard_drop=bool(prog.red_use_hard_drop),
    )


# --------------------------------------------------------------------------
# the variant rules
# --------------------------------------------------------------------------

#: log(83000) - log(38), the HighSpeed table's span (``:666``), and the
#: compiled step's fold of ``0.4 * (log w - log 38) / span``
_HS_LOG_LOW = float(np.float32(math.log(HS_LOW_WINDOW)))
_HS_K = folded(0.4, math.log(83000.0) - math.log(HS_LOW_WINDOW))
#: Python folds ``3 (1 - beta) / (1 + beta)`` in double (``:499``)
_CUBIC_WEST = 3.0 * (1 - CUBIC_BETA) / (1 + CUBIC_BETA)
#: divisions by a constant, as the compiled step's products
_CUBIC_INV_C = folded(1.0, CUBIC_C)
_HYBLA_INV = folded(1.0, HYBLA_RRTT)
_LEDBAT_INV = folded(1.0, LEDBAT_TARGET_S)
_BBR_GAINS = np.asarray(BBR_CYCLE_GAINS, np.float32)


def _by_variant(var: torch.Tensor, values: list) -> torch.Tensor:
    """``jnp.select`` over the variant ids (the reference's dispatch,
    ``tcp_dumbbell.py:568-577``, ``:700-710``): ``values[i]`` is variant
    ``i``'s value, and each flow takes its own variant's (one gather of
    the stacked values, the same values the select picks)."""
    table = torch.stack(torch.broadcast_tensors(*values), dim=-1)
    return torch.gather(table, -1, var.long().unsqueeze(-1)).squeeze(-1)


def cwnd_increase(var, cwnd, ssthresh, acked, t_s, rtt_s, st: dict,
                  acked_raw=None):
    """Per-ack cwnd growth of all seventeen variants, masked-dense
    (``tcp_dumbbell.py:390-643``): every rule computes, ``var`` selects.
    ``st`` is the side state; returns ``(cwnd, ssthresh, st)``.
    ``acked_raw`` (default ``acked``) feeds the estimators (min-RTT,
    Westwood, Illinois, BBR), ``acked`` the window's growth.  ``t_s``
    is a 0-dim f32 tensor, ``rtt_s`` broadcasts against ``cwnd``."""
    c = lambda v: f32(cwnd, v)  # noqa: E731
    w = torch.clamp_min(cwnd, 1.0)
    a = acked.float()
    ar = a if acked_raw is None else acked_raw.float()
    in_ss = cwnd < ssthresh

    # the estimators (raw acks)
    sampled = ar > 0
    min_rtt = torch.where(sampled, torch.minimum(st["min_rtt"], rtt_s),
                          st["min_rtt"])
    ww_acc = st["ww_acc"] + ar
    ww_done = sampled & (ww_acc >= w)
    ww_sample = ww_acc / torch.clamp_min(rtt_s, c(1e-6))
    bwe = torch.where(
        ww_done,
        torch.where(st["bwe"] == 0.0, ww_sample,
                    fma(st["bwe"], c(0.9), ww_sample * 0.1)),
        st["bwe"])
    ww_acc = torch.where(ww_done, c(0.0), ww_acc)
    ill_max = torch.where(sampled, torch.maximum(st["ill_max_rtt"], rtt_s),
                          st["ill_max_rtt"])
    dm = ill_max - min_rtt
    da = torch.clamp_min(rtt_s - min_rtt, 0.0)
    d1 = dm * 0.01
    k_ill = c(ILL_ALPHA_MAX - ILL_ALPHA_MIN) / torch.clamp_min(
        dm - d1, c(1e-9))
    alpha_raw = torch.where(
        da <= d1, c(ILL_ALPHA_MAX),
        torch.clamp_min(fma(-k_ill, da - d1, c(ILL_ALPHA_MAX)),
                        ILL_ALPHA_MIN))
    beta_raw = torch.clamp(
        (da * (ILL_BETA_MAX - ILL_BETA_MIN)) / torch.clamp_min(dm, c(1e-9))
        + ILL_BETA_MIN, ILL_BETA_MIN, ILL_BETA_MAX)
    ill_alpha = torch.where(
        sampled, torch.where(dm <= 0.0, c(ILL_ALPHA_MAX), alpha_raw),
        st["ill_alpha"])
    ill_beta = torch.where(
        sampled, torch.where(dm <= 0.0, c(ILL_BETA_MIN), beta_raw),
        st["ill_beta"])
    bbr_acc = st["bbr_acc"] + ar
    round_done = sampled & (bbr_acc >= w)
    bbr_sample = bbr_acc / torch.clamp_min(rtt_s, c(1e-6))
    bbr_bw = torch.where(
        round_done, torch.maximum(st["bbr_bw"] * BBR_BW_DECAY, bbr_sample),
        st["bbr_bw"])
    bbr_acc = torch.where(round_done, c(0.0), bbr_acc)
    grew = bbr_sample > st["bbr_full_bw"] * 1.25
    bbr_full_bw = torch.where(round_done & grew, bbr_sample,
                              st["bbr_full_bw"])
    bbr_full_cnt = torch.where(
        round_done, torch.where(grew, c(0.0), st["bbr_full_cnt"] + 1.0),
        st["bbr_full_cnt"])
    state = st["bbr_state"]
    pipe_full = round_done & (state == BBR_STARTUP) & (bbr_full_cnt >= 3)
    state = torch.where(pipe_full, BBR_DRAIN, state)
    leave_drain = round_done & (st["bbr_state"] == BBR_DRAIN)
    state = torch.where(leave_drain, BBR_PROBE_BW, state)
    bbr_cycle = torch.where(
        round_done & (state == BBR_PROBE_BW),
        torch.remainder(st["bbr_cycle"] + 1, len(BBR_CYCLE_GAINS)),
        st["bbr_cycle"])

    # congestion avoidance (per ack batch)
    inc_reno = a / w
    inc_scal = a / torch.clamp_max(w, SCALABLE_AI)
    a_hs = torch.where(
        w <= HS_LOW_WINDOW, c(1.0),
        torch.clamp_min(powf(w, c(0.8)) * 0.156 * 0.5, 1.0))
    inc_hs = (a_hs * a) / w
    fresh = (st["epoch_t"] < 0.0) & (a > 0) & ~in_ss
    k = torch.where(
        st["w_max"] > w,
        cbrt(torch.clamp_min(st["w_max"] - w, 0.0) * _CUBIC_INV_C), c(0.0))
    origin = torch.maximum(st["w_max"], w)
    epoch_t = torch.where(fresh, t_s, st["epoch_t"])
    k = torch.where(fresh, k, st["k"])
    origin = torch.where(fresh, origin, st["origin"])
    w_est = torch.where(fresh, w, st["w_est"])
    te = (t_s - epoch_t) + rtt_s
    x = te - k
    target = fma((x * x) * x, c(CUBIC_C), origin)
    w_est = w_est + (a * _CUBIC_WEST) / w
    target = torch.maximum(target, w_est)
    inc_cubic = torch.clamp((target - w) / w, 0.0, 0.5) * a
    diff = w * (1.0 - st["base_rtt"] / torch.maximum(rtt_s, st["base_rtt"]))
    inc_vegas = torch.where(
        diff < VEGAS_ALPHA, inc_reno,
        torch.where(diff > VEGAS_BETA, -a / w, c(0.0)))
    inc_veno = torch.where(diff < VENO_BETA, inc_reno, inc_reno * 0.5)
    is_lr = (var == V_LINUXRENO) | (var == V_DCTCP)
    cnt = st["cwnd_cnt"] + a
    whole = torch.floor(cnt / w)
    new_cnt = torch.where(is_lr & ~in_ss & (a > 0), fma(-whole, w, cnt),
                          st["cwnd_cnt"])
    bic_mid = torch.clamp_max((st["w_max"] - w) * 0.5, BIC_MAX_INCR)
    bic_probe = torch.clamp_max((w - st["w_max"]) + 1.0, BIC_MAX_INCR)
    bic_inc = torch.clamp_min(
        torch.where(w < st["w_max"], bic_mid, bic_probe), BIC_SMIN)
    inc_bic = torch.where((w < BIC_LOW_WND) | (st["w_max"] == 0.0),
                          inc_reno, (a * bic_inc) / w)
    inc_ill = (ill_alpha * a) / w
    rho = torch.clamp_min(rtt_s * _HYBLA_INV, 1.0)
    inc_hybla = ((a * rho) * rho) / w
    h_delta = torch.clamp_min((t_s - st["htcp_last_cong"]) - HTCP_DELTA_B,
                              0.0)
    h_poly = fma(h_delta * 0.25, h_delta, fma(h_delta, c(10.0), c(1.0)))
    h_alpha = torch.clamp_min(((1.0 - st["htcp_beta"]) * 2.0) * h_poly, 1.0)
    inc_htcp = (h_alpha * a) / w
    inc_yeah = torch.where(
        diff < YEAH_QMAX, a / torch.clamp_max(w, YEAH_ALPHA),
        (fma(-diff, c(1.0 - YEAH_RHO), c(1.0)) * a) / w)
    qdelay = torch.clamp_min(rtt_s - torch.minimum(st["min_rtt"], rtt_s), 0.0)
    inc_ledbat = (((LEDBAT_TARGET_S - qdelay) * _LEDBAT_INV) * a) / w
    in_infer = t_s < st["lp_until"]
    inc_lp = torch.where(in_infer, c(0.0), inc_reno)
    # in VARIANTS' order; BBR's is the select's default, 0 (its window
    # is set below)
    inc_ca = _by_variant(var, [
        inc_reno, inc_cubic, inc_scal, inc_hs, inc_vegas, inc_veno, whole,
        inc_bic, inc_reno, inc_ill, inc_hybla, c(0.0), whole, inc_htcp,
        inc_yeah, inc_ledbat, inc_lp])
    # slow start (+1 per ack, Hybla 2^rho - 1); Vegas leaves it past gamma
    vegas_exit = (var == V_VEGAS) & in_ss & (diff > VEGAS_GAMMA) & (a > 0)
    ssthresh = torch.where(vegas_exit, torch.clamp_min(w - 1.0, 2.0),
                           ssthresh)
    inc_ss = torch.where(var == V_HYBLA, a * (powf(c(2.0), rho) - 1.0), a)
    inc = torch.where(in_ss & ~vegas_exit, inc_ss, inc_ca)
    lp_hold = (var == V_LP) & in_infer
    inc = torch.where(lp_hold, c(0.0), inc)
    floor = torch.where(lp_hold, c(1.0), c(2.0))
    new_cwnd = torch.maximum(cwnd + torch.where(a > 0, inc, c(0.0)), floor)

    # BBR: cwnd tracks gain x BDP
    gain = torch.where(
        state == BBR_STARTUP, c(BBR_HIGH_GAIN),
        torch.where(state == BBR_DRAIN, c(1.0 / BBR_HIGH_GAIN),
                    device_table(_BBR_GAINS, cwnd.device)[
                        bbr_cycle.long()]))
    target_b = torch.clamp_min(gain * (bbr_bw * min_rtt), 4.0)
    cwnd_bbr = torch.where(
        bbr_bw == 0.0, cwnd + a,
        torch.where(cwnd < target_b,
                    cwnd + torch.minimum(a, (target_b - cwnd) + 1.0),
                    torch.clamp_min(target_b, 4.0)))
    new_cwnd = torch.where(var == V_BBR, torch.where(a > 0, cwnd_bbr, cwnd),
                           new_cwnd)

    # TCP-LP's early-congestion inference
    lp_trigger = (
        (var == V_LP) & sampled & (ill_max > min_rtt)
        & (rtt_s > fma(ill_max - min_rtt, c(LP_INFERENCE_FRAC), min_rtt))
        & ~in_infer)
    new_cwnd = torch.where(lp_trigger, c(1.0), new_cwnd)
    ssthresh = torch.where(lp_trigger, torch.clamp_min(ssthresh * 0.5, 2.0),
                           ssthresh)
    lp_until = torch.where(lp_trigger, t_s + rtt_s, st["lp_until"])

    st = dict(st, epoch_t=epoch_t, k=k, origin=origin, w_est=w_est,
              lp_until=lp_until,
              last_diff=torch.where(a > 0, diff, st["last_diff"]),
              min_rtt=min_rtt, ww_acc=ww_acc, bwe=bwe,
              ill_max_rtt=ill_max, ill_alpha=ill_alpha, ill_beta=ill_beta,
              bbr_acc=bbr_acc, bbr_bw=bbr_bw, bbr_full_bw=bbr_full_bw,
              bbr_full_cnt=bbr_full_cnt, bbr_state=state,
              bbr_cycle=bbr_cycle, cwnd_cnt=new_cnt)
    return new_cwnd, ssthresh, st


def loss_response(var, cwnd, st: dict, t_s):
    """GetSsThresh of every variant on a detected loss, masked-dense
    (``tcp_dumbbell.py:646-725``); ``t_s`` stamps H-TCP's last
    congestion.  Returns ``(ssthresh, st)``."""
    c = lambda v: f32(cwnd, v)  # noqa: E731
    w = torch.clamp_min(cwnd, 1.0)
    ss_reno = w * 0.5
    new_wmax = torch.where(w < st["w_max"], (w * (1.0 + CUBIC_BETA)) * 0.5,
                           w)
    ss_cubic = w * CUBIC_BETA
    ss_scal = w * (1.0 - SCALABLE_MD)
    b_hs = torch.where(
        w <= HS_LOW_WINDOW, c(0.5),
        torch.clamp_min(fma(-(log(w) - _HS_LOG_LOW), c(_HS_K), c(0.5)), 0.1))
    ss_hs = w * (1.0 - b_hs)
    ss_veno = torch.where(st["last_diff"] < VENO_BETA, w * 0.8, w * 0.5)
    bic_wmax = torch.where(w < st["w_max"], (w * (1.0 + BIC_BETA)) * 0.5, w)
    ss_bic = w * BIC_BETA
    finite = torch.isfinite(st["min_rtt"])
    ss_west = torch.where((st["bwe"] > 0.0) & finite,
                          st["bwe"] * st["min_rtt"], w * 0.5)
    ss_ill = w * (1.0 - st["ill_beta"])
    ss_bbr = torch.clamp_min(
        st["bbr_bw"] * torch.where(finite, st["min_rtt"], c(0.0)), 4.0)
    ss_dctcp = w * (1.0 - st["dctcp_alpha"] * 0.5)
    h_valid = (st["ill_max_rtt"] > 0.0) & finite
    h_beta = torch.where(
        h_valid,
        torch.clamp(st["min_rtt"] / torch.clamp_min(st["ill_max_rtt"],
                                                    c(1e-9)), 0.5, 0.8),
        c(HTCP_DEFAULT_BACKOFF))
    ss_htcp = w * h_beta
    ss_yeah = w - torch.maximum(st["last_diff"], w * 0.125)
    ssthresh = _by_variant(var, [
        ss_reno, ss_cubic, ss_scal, ss_hs, ss_reno, ss_veno, ss_reno, ss_bic,
        ss_west, ss_ill, ss_reno, ss_bbr, ss_dctcp, ss_htcp, ss_yeah,
        ss_reno, ss_reno])
    ssthresh = torch.clamp_min(ssthresh, 2.0)
    is_htcp = var == V_HTCP
    st = dict(
        st,
        w_max=torch.where(var == V_CUBIC, new_wmax,
                          torch.where(var == V_BIC, bic_wmax, st["w_max"])),
        epoch_t=torch.full_like(st["epoch_t"], -1.0),
        htcp_beta=torch.where(is_htcp, h_beta, st["htcp_beta"]),
        htcp_last_cong=torch.where(is_htcp, t_s, st["htcp_last_cong"]),
    )
    return ssthresh, st


# --------------------------------------------------------------------------
# one slot
# --------------------------------------------------------------------------


def _row_draw(u: torch.Tensor, points: int) -> torch.Tensor:
    """A replica's draw for every ``(point, replica)`` row: the ``(R,
    ...)`` draws tiled over the C points."""
    return u if points == 1 else u.repeat(points, *([1] * (u.dim() - 1)))


#: what :func:`step_math`'s census counts, summed over rows, flows and
#: slots: packets RED marked CE on arrival, packets it dropped early, tail
#: drops past the queue's capacity, and window reductions
CENSUS_KEYS = ("ce_marks", "early_drops", "tail_drops", "reductions")


def step_math(c: dict, s: dict, t: int, var: torch.Tensor,
              ecn: torch.Tensor, u_dep: torch.Tensor, u_red=None,
              u_mark=None, census: dict | None = None, app=None) -> dict:
    """Slot ``t`` of every row (``tcp_dumbbell.py:835-1137`` without the
    ``obs`` block): ``s`` is the flat state, ``(N, F)`` per flow, ``(N,
    L, F)`` and ``(N, L)`` rings, ``(N,)`` per row; ``var`` and ``ecn``
    ``(N, F)``; ``u_dep`` ``(N,)`` and, under RED, ``u_red`` ``(N, F)``
    and ``u_mark`` ``(N,)``; ``app`` (an app-limited program) the ``(N,
    F)`` int32 segments each row's flows have offered by the end of the
    slot.  Returns the new state; ``census``, if given, gains this slot's
    :data:`CENSUS_KEYS` (as tensors)."""
    L, F = c["L"], c["F"]
    dev = s["cwnd"].device
    idx = t % L
    # the int32 clock times the f32 slot, in f32 (``:761-764``)
    t_s = torch.full((), float(t), dtype=torch.float32, device=dev) \
        * c["slot_s"]
    slot_s = c["slot_s"]

    # 1. this slot's ack / loss / ECN-echo arrivals
    acks = s["ack_buf"][:, idx]
    losses = s["loss_buf"][:, idx]
    marks = s["mark_buf"][:, idx]
    rtt = s["rtt_buf"][:, idx][:, None]
    ack_buf, loss_buf = s["ack_buf"].clone(), s["loss_buf"].clone()
    mark_buf, rtt_buf = s["mark_buf"].clone(), s["rtt_buf"].clone()
    ack_buf[:, idx] = 0
    loss_buf[:, idx] = 0
    mark_buf[:, idx] = 0.0
    inflight = s["inflight"] - acks - losses

    # DCTCP's per-window marked-fraction EWMA
    d_acked = s["dctcp_acked"] + acks.float()
    d_marked = s["dctcp_marked"] + marks
    win_done = d_acked >= s["cwnd"]
    side = {k: s[k] for k in SIDE_KEYS}
    side["dctcp_alpha"] = torch.where(
        win_done,
        fma(s["dctcp_alpha"], f32(d_acked, 1.0 - DCTCP_G),
            (d_marked * DCTCP_G) / torch.clamp_min(d_acked, 1.0)),
        s["dctcp_alpha"])
    d_acked = torch.where(win_done, 0.0, d_acked)
    d_marked = torch.where(win_done, 0.0, d_marked)

    in_recovery = t < s["recover_until"]
    cwnd, ssthresh, side = cwnd_increase(
        var, s["cwnd"], s["ssthresh"],
        torch.where(in_recovery, 0, acks), t_s, rtt, side, acked_raw=acks)
    # 2. one reduction per recovery window on a loss or an ECN echo
    reduce = ((losses > 0) | ((marks > 0) & ecn)) & ~in_recovery
    ss_loss, side_loss = loss_response(var, cwnd, side, t_s)
    ssthresh = torch.where(reduce, ss_loss, ssthresh)
    cwnd = torch.where(reduce, ssthresh, cwnd)
    side = {k: torch.where(reduce, side_loss[k], side[k]) for k in side}
    recover_until = torch.where(reduce, t + c["rtt_slots"],
                                s["recover_until"])

    # 3. departure: one packet, its flow drawn by queue occupancy
    q = s["q"]
    qtot = q.sum(1, dtype=torch.int32)
    backlogged = qtot > 0
    cum = torch.cumsum(q, 1, dtype=torch.int32)
    thresh = (u_dep * qtot.float()).to(torch.int32)
    dep = torch.argmax((cum > thresh[:, None]).to(torch.int8), 1)
    dep_oh = (torch.arange(F, device=dev)[None, :] == dep[:, None]) \
        & backlogged[:, None]
    if c["red"]:
        dep_marked = (dep_oh & (u_mark[:, None] < s["q_marked"]
                                / torch.clamp_min(q, 1).float())).float()
    else:
        dep_marked = torch.zeros_like(s["q_marked"])
    dep_i = dep_oh.to(torch.int32)
    q_marked = torch.clamp_min(s["q_marked"] - dep_marked, 0.0)
    q = q - dep_i
    delivered = s["delivered"] + dep_i
    aidx = (t + c["ack_lag"]) % L
    ack_buf[:, aidx] += dep_i
    mark_buf[:, aidx] += dep_marked
    rtt_buf[:, aidx] = fma(qtot.float(), f32(rtt_buf, slot_s),
                           f32(rtt_buf, c["base_rtt_s"]))

    # 4. window-driven arrivals; RED marks or early drops, then
    #    admission up to the queue's capacity
    want = torch.clamp(cwnd.to(torch.int32) - inflight, 0, c["burst"])
    live = ((t >= c["start"]) & (t < c["stop"])
            & (delivered + inflight < c["max_pkts"]))
    want = torch.where(live, want, 0)
    if app is not None:
        # app-limited: never past what the application has offered
        want = torch.minimum(want, torch.clamp_min(app - delivered - inflight,
                                                   0))
    red_avg = s["red_avg"]
    red_marks = torch.zeros_like(s["q_marked"])
    red_drops = torch.zeros_like(want)
    if c["red"]:
        qnow = q.sum(1, dtype=torch.int32).float()
        n_arr = want.sum(1, dtype=torch.int32)
        keep = powf(f32(red_avg, c["red_keep"]), n_arr.float())
        red_avg = torch.where(n_arr > 0, fma(red_avg - qnow, keep, qnow),
                              red_avg)
        p = torch.where(red_avg < c["red_min_th"], f32(red_avg, 0.0),
                        (red_avg - c["red_min_th"]) * c["red_lin"])
        if c["red_gentle"]:
            p = torch.where(
                red_avg >= c["red_max_th"],
                fma(red_avg - c["red_max_th"], f32(red_avg, c["red_gentle_k"]),
                    f32(red_avg, c["red_max_p"])), p)
        forced = red_avg >= c["red_forced_th"]
        p = torch.clamp(torch.where(forced, f32(red_avg, 1.0), p), 0.0, 1.0)
        n_act = torch.minimum(
            want, torch.floor(fma(want.float(), p[:, None], u_red))
            .to(torch.int32))
        mark_sel = ecn & c["red_ecn"]
        if c["red_hard_drop"]:
            mark_sel = mark_sel & ~forced[:, None]
        red_drops = torch.where(mark_sel, 0, n_act)
        red_marks = torch.where(mark_sel, n_act, 0).float()
        want_q = want - red_drops
    else:
        want_q = want
    wtot = want_q.sum(1, dtype=torch.int32)
    free = torch.clamp_min(c["queue_cap"] - q.sum(1, dtype=torch.int32), 0)
    # proportional admission, largest remainders first
    scale = torch.clamp_max(free.float() / torch.clamp_min(wtot, 1).float(),
                            1.0)
    exact = want_q.float() * scale[:, None]
    acc = torch.floor(exact).to(torch.int32)
    rem = exact - acc.float()
    acc_sum = acc.sum(1, dtype=torch.int32)
    leftover = torch.minimum(free - acc_sum, wtot - acc_sum)
    acc = acc + ((admission_rank(rem) < leftover[:, None])
                 & (acc < want_q)).to(torch.int32)
    acc = torch.minimum(acc, want_q)
    rej = want_q - acc
    q = q + acc
    q_marked = q_marked + torch.minimum(red_marks, acc.float())
    inflight = inflight + want
    drops = s["drops"] + rej + red_drops
    loss_buf[:, aidx] += rej + red_drops
    if census is not None:
        for k, v in zip(CENSUS_KEYS, (red_marks, red_drops, rej, reduce)):
            census[k] = census.get(k, 0) + v.sum(dtype=torch.int64)

    return dict(
        side, cwnd=cwnd, ssthresh=ssthresh, inflight=inflight, q=q,
        q_marked=q_marked, delivered=delivered, drops=drops,
        recover_until=recover_until, ack_buf=ack_buf, loss_buf=loss_buf,
        mark_buf=mark_buf, rtt_buf=rtt_buf,
        qsum=s["qsum"] + qtot.float(), red_avg=red_avg,
        dctcp_acked=d_acked, dctcp_marked=d_marked,
    )


def admission_rank(rem: torch.Tensor) -> torch.Tensor:
    """Each flow's place in ``argsort(-rem)`` (``tcp_dumbbell.py:1040-
    1041``, a stable sort): the flows with a larger remainder, and those
    before it with an equal one."""
    i = torch.arange(rem.shape[1], device=rem.device)
    ahead = (rem[:, None, :] > rem[:, :, None]) | (
        (rem[:, None, :] == rem[:, :, None]) & (i[None, :] < i[:, None]))
    return ahead.sum(2, dtype=torch.int32)


# --------------------------------------------------------------------------
# the slot loop: the kernel's plain version and the wrapper
# --------------------------------------------------------------------------

#: slot draws (T * R * F elements) the plain loop hashes at once
DRAW_CHUNK_ELEMS = 1 << 20


def tcp_advance_math(consts: dict, state: dict, key: torch.Tensor,
                     t0: int, t1: int, var: torch.Tensor,
                     ecn: torch.Tensor, census: dict | None = None,
                     app_cum: torch.Tensor | None = None) -> dict:
    """Slots ``[t0, t1)`` of the loop in plain PyTorch (any device), for
    a grid of C points: ``state`` is ``(C, R, ...)``, ``var`` ``(C, F)``
    int32 variant ids and ``ecn`` ``(C, F)`` bool ECN flags; ``app_cum``
    (an app-limited program) the ``(C, t1 - t0, F)`` int32 offered
    segments of each point's flows by the end of each slot
    (:func:`~tpudes_torch.traffic.device.app_cum_table`).  Every point
    runs every slot (the reference's loop ends at the horizon, not on a
    condition), and replica ``r`` of every point takes the single run's
    draws.  Returns the ``(C, R, ...)`` state; ``census``, if given,
    gains the run's :data:`CENSUS_KEYS` counts (ints)."""
    C, R = state["cwnd"].shape[:2]
    F = consts["F"]
    flat = {k: v.flatten(0, 1) for k, v in state.items()}
    var_rows = var.long().repeat_interleave(R, 0)
    ecn_rows = ecn.repeat_interleave(R, 0)
    block = max(1, DRAW_CHUNK_ELEMS // (R * max(F, 1)))
    for b0 in range(t0, t1, block):
        b1 = min(b0 + block, t1)
        u_dep, u_red, u_mark = tcp_draws(key, b0, b1, R, F, consts["red"])
        for t in range(b0, b1):
            i = t - b0
            app = None if app_cum is None else \
                app_cum[:, t - t0].repeat_interleave(R, 0)
            flat = step_math(
                consts, flat, t, var_rows, ecn_rows, _row_draw(u_dep[i], C),
                None if u_red is None else _row_draw(u_red[i], C),
                None if u_mark is None else _row_draw(u_mark[i], C),
                census, app)
    if census is not None:
        census.update({k: int(v) for k, v in census.items()})
    return {k: flat[k].unflatten(0, (C, R)) for k, _, _ in TCP_STATE}


def tcp_advance(consts: dict, state: dict, key: torch.Tensor, t0: int,
                t1: int, var: torch.Tensor, ecn: torch.Tensor,
                app_cum: torch.Tensor | None = None) -> dict:
    """Slots ``[t0, t1)`` for a grid of C points: the plain loop for CPU
    tensors, one launch of the persistent CUDA kernel for CUDA tensors
    (or an error).  Arguments and result as :func:`tcp_advance_math`
    takes and gives them."""
    if key.device.type == "cpu":
        return tcp_advance_math(consts, state, key, t0, t1, var, ecn,
                                app_cum=app_cum)
    if key.device.type == "cuda":
        from tpudes_torch.parallel.tcp_cuda import tcp_launch

        return tcp_launch(consts, state, key, t0, t1, var, ecn, app_cum)
    raise ValueError(f"no dumbbell advance for device {key.device}")


def _tcp_unpack(host: dict, prog: DumbbellProgram, replicas: int) -> list:
    """The result dicts (``tcp_dumbbell.py:1285-1310``) as numpy, one per
    point of the host ``(C, R_pad, ...)`` state, the padded replicas
    sliced off."""
    R = int(replicas)
    sim_s = prog.n_slots * prog.slot_s
    out = []
    for c in range(host["delivered"].shape[0]):
        delivered = host["delivered"][c, :R]
        out.append(dict(
            goodput_mbps=delivered.astype(np.float32) * prog.seg_bytes * 8.0
            / sim_s / 1e6,
            delivered=delivered,
            drops=host["drops"][c, :R],
            mean_queue=host["qsum"][c, :R] / prog.n_slots,
            cwnd_final=host["cwnd"][c, :R],
        ))
    return out


#: the RED parameters (``tcp_dumbbell.py:1144``): absent from a fifo
#: program's key, as they never reach its step
RED_FIELDS = ("red_min_th", "red_max_th", "red_max_p", "red_qw",
              "red_gentle", "red_use_ecn", "red_use_hard_drop")


def dumbbell_prog_key(prog: DumbbellProgram) -> tuple:
    """Hashable identity of the fields that shape a run's constants
    (``tcp_dumbbell.py:1150``): ``n_slots``, ``variant_idx`` and ``ecn``
    are a launch's operands, a fifo program's RED parameters never reach
    its step, and the workload adds only its shape key."""
    skip = {"n_slots", "variant_idx", "ecn", "traffic"}
    if prog.qdisc != "red":
        skip.update(RED_FIELDS)
    return tuple(
        v.tobytes() if isinstance(v, np.ndarray) else v
        for k, v in prog.__dict__.items()
        if k not in skip
    ) + (None if prog.traffic is None else prog.traffic.shape_key(),)


def _keyed_constants(prog: DumbbellProgram, device) -> dict:
    """:func:`build_tcp_consts` of the program's keyed fields alone (a
    fifo program's RED parameters at their defaults), so the cached
    constants are a pure function of :func:`dumbbell_prog_key`."""
    if prog.qdisc != "red":
        fields = {f.name: f.default for f in dataclasses.fields(prog)
                  if f.name in RED_FIELDS}
        prog = dataclasses.replace(prog, **fields)
    return build_tcp_consts(prog, device)


def tcp_study(prog: DumbbellProgram, key, replicas, mesh=None, device=None):
    """Serving-layer study descriptor (``tcp_dumbbell.py:1313``): the
    per-flow variant and ECN assignment is the sweep operand, so two
    studies coalesce onto one launch whenever their other fields, slot
    horizon, key, replica count, mesh and device match.  A program whose
    declared ``ecn`` disagrees with its variants' ``REQUIRES_ECN`` flags
    is ``solo``: sweep points take ECN from their variants, so only its
    own run serves it."""
    from tpudes_torch.serving.descriptor import (
        StudyDescriptor,
        mesh_fingerprint,
    )

    dev = resolve_device(device)
    ids = np.asarray(prog.variant_idx, np.int32)
    declared = (np.asarray(prog.ecn, bool) if prog.ecn is not None
                else np.zeros(prog.n_flows, bool))
    solo = not np.array_equal(declared, variant_ecn(ids))
    statics = tuple(
        v.tobytes() if isinstance(v, np.ndarray) else v
        for k, v in prog.__dict__.items()
        if k not in ("variant_idx", "ecn", "traffic")
    ) + (None if prog.traffic is None else prog.traffic.param_key(),)
    ck = (statics, np.asarray(key, np.int64).tobytes(), int(replicas),
          mesh_fingerprint(mesh), str(dev))
    point = tuple(int(i) for i in ids)

    def launch(points, block=False):
        if solo or len(points) == 1:
            pt = variant_point(list(points[0]))
            p1 = prog if solo else dataclasses.replace(
                prog, variant_idx=pt, ecn=variant_ecn(pt))
            return run_tcp_dumbbell(p1, key, replicas, mesh=mesh,
                                    block=block, device=dev)
        return run_tcp_dumbbell(prog, key, replicas, mesh=mesh,
                                variants=[list(p) for p in points],
                                block=block, device=dev)

    def warm(n_points):
        # a 1-slot run builds the kernel and fills the runner cache
        tiny = dataclasses.replace(prog, n_slots=1)
        run_tcp_dumbbell(tiny, key, replicas, mesh=mesh, device=dev,
                         variants=None if n_points == 1
                         else [list(point)] * n_points)

    return StudyDescriptor("dumbbell", ck, point, launch, warm, solo=solo)


def sweep_operands(prog: DumbbellProgram, variants=None):
    """``(var, ecn)``, the ``(C, F)`` numpy variant ids and ECN flags of
    a run: the program's own (C = 1; its ``ecn``, or none), or one row a
    sweep point, ECN from the variants (``tcp_dumbbell.py:1468-1491``)."""
    if variants is None:
        points = [np.asarray(prog.variant_idx, np.int32)]
        ecns = [np.asarray(prog.ecn, bool) if prog.ecn is not None
                else np.zeros(prog.n_flows, bool)]
    else:
        points = [variant_point(p) for p in variants]
        if not points:
            raise ValueError("variants=[...] needs at least one point")
        for p in points:
            if p.shape != (prog.n_flows,):
                raise ValueError(
                    f"each sweep point assigns all {prog.n_flows} flows "
                    f"(got shape {p.shape})")
        ecns = [variant_ecn(p) for p in points]
    var = np.stack(points).astype(np.int32)
    if var.min() < 0 or var.max() >= len(VARIANTS):
        raise ValueError(f"variant ids must lie in 0..{len(VARIANTS) - 1}")
    return var, np.stack(ecns)


def workload_operands(prog: DumbbellProgram, traffic_sweep=None,
                      device=None):
    """The stacked operand tables of a run's workloads, ``(P, F, ...)``
    (:func:`~tpudes_torch.traffic.device.stack_traffic_operands`): the
    program's own (P = 1), one a point of ``traffic_sweep``, or None for
    a bulk run.  A sweep needs ``prog.traffic`` set and every point
    sharing its shape key (``tcp_dumbbell.py:1496-1510``); each workload
    has one entity a flow."""
    if traffic_sweep is not None:
        traffic_sweep = list(traffic_sweep)
        if prog.traffic is None or not traffic_sweep or any(
                tp.shape_key() != prog.traffic.shape_key()
                for tp in traffic_sweep):
            raise ValueError(
                "a workload sweep needs prog.traffic set and every point "
                "sharing its traffic shape key (one executable serves the "
                "sweep; pad tables to a common capacity)")
        progs = traffic_sweep
    elif prog.traffic is not None:
        progs = [prog.traffic]
    else:
        return None
    if progs[0].n != prog.n_flows:
        raise ValueError(f"the workload has {progs[0].n} entities; the "
                         f"dumbbell {prog.n_flows} flows (one a flow)")
    return stack_traffic_operands(progs, device)


def run_tcp_dumbbell(
    prog: DumbbellProgram,
    key,
    replicas: int,
    mesh=None,
    *,
    variants=None,
    traffic_sweep=None,
    chunk_slots: int | None = None,
    checkpoint=None,
    block: bool = True,
    obs: bool = False,
    device=None,
) -> dict | list[dict]:
    """Run ``replicas`` Monte-Carlo replicas of the dumbbell
    (``tcp_dumbbell.py:1383-1552``).

    ``key`` is a ``(2,)`` threefry key (:func:`tpudes_torch.random.
    PRNGKey` or a JAX key's words).  Returns per-replica numpy arrays:
    ``goodput_mbps`` (R, F), ``delivered`` (R, F), ``drops`` (R, F),
    ``mean_queue`` (R,) and ``cwnd_final`` (R, F).

    ``variants=[point, ...]`` (each an (F,)-sequence of variant names or
    ids) runs a config sweep: C points as one ``(C, R)`` grid per
    launch, and a list of C such dicts, point ``c`` equal to the run of
    ``dataclasses.replace(prog, variant_idx=point, ecn=REQUIRES_ECN(
    point))`` with the same key.

    ``prog.traffic`` (a TrafficProgram, one entity a flow) makes the
    flows app-limited.  ``traffic_sweep=[workload, ...]`` (same-shape
    TrafficPrograms, ``prog.traffic`` naming the shape) runs a workload
    sweep instead: the variants and ECN flags shared, a list of C dicts,
    point ``c`` equal to the run of ``dataclasses.replace(prog,
    traffic=workload)``.  One config axis a run: ``variants=`` and
    ``traffic_sweep=`` together raise.

    ``chunk_slots=N`` runs the horizon N slots per launch, the same
    result; ``checkpoint=`` (a path or a :class:`~tpudes_torch.parallel.
    checkpoint.CarryCheckpoint`) saves the carry after each chunk and
    resumes a matching run from its last completed chunk, bit-equal.
    The replica axis is padded to its power-of-two bucket and the
    results sliced back.  ``block=False`` returns an
    :class:`~tpudes_torch.parallel.runtime.EngineFuture`.  ``device``
    defaults to the card, where each chunk is one launch of the
    persistent kernel."""
    if variants is not None and traffic_sweep is not None:
        raise ValueError(
            "one config axis per launch: sweep either the variant "
            "assignment (variants=[...]) or the workload "
            "(traffic_sweep=[...])")
    if mesh is not None:
        raise _not_ported("mesh", "A12")
    if obs:
        raise _not_ported("TpudesObs", "A10")
    from tpudes_torch.parallel.checkpoint import checkpoint_ctx

    dev = resolve_device(device)
    r_pad = bucket_replicas(replicas)
    sweep = "traffic" if traffic_sweep is not None else "variant"
    n_cfg = (len(variants) if variants is not None
             else len(traffic_sweep) if traffic_sweep is not None else None)
    consts, _ = RUNTIME.runner(
        "dumbbell",
        dumbbell_prog_key(prog) + (r_pad, False, n_cfg, sweep, str(dev)),
        lambda: _keyed_constants(prog, dev),
    )
    ops = workload_operands(prog, traffic_sweep, dev)
    var, ecn = sweep_operands(prog, variants)
    if traffic_sweep is not None:
        points = ops["tr_id"].shape[0]
        var, ecn = np.repeat(var, points, 0), np.repeat(ecn, points, 0)
    var_t, ecn_t = to_device(var, dev), to_device(ecn, dev)
    key = to_device(key if isinstance(key, torch.Tensor)
                    else np.asarray(key, np.int64), dev, torch.int64)
    C = var.shape[0]

    def launch(c, bound):
        app = None if ops is None else app_cum_table(
            ops, prog.traffic.epoch_us, consts["slot_us"], c["t"], bound)
        if app is not None and app.shape[0] != C:
            app = app.expand(C, -1, -1)
        return dict(t=bound, state=tcp_advance(consts, c["state"], key,
                                               c["t"], bound, var_t, ecn_t,
                                               app))

    ckpt = checkpoint_ctx(
        checkpoint, engine="dumbbell", key=key, replicas=replicas,
        r_pad=r_pad, n_cfg=n_cfg, obs=False, axis=1, device=dev,
        extra=dumbbell_prog_key(prog) + (
            tuple(tuple(int(i) for i in p) for p in var),
            None if prog.traffic is None else prog.traffic.param_key(),
            None if traffic_sweep is None
            else tuple(tp.param_key() for tp in traffic_sweep)),
    )
    carry, flush = drive_chunks(
        "dumbbell", chunk_bounds(prog.n_slots, chunk_slots or prog.n_slots),
        dict(t=0, state=init_state(consts, int(r_pad), C)), launch,
        checkpoint=ckpt)
    fetch = {k: carry["state"][k]
             for k in ("delivered", "drops", "qsum", "cwnd")}
    swept = variants is not None or traffic_sweep is not None

    def finalize(host):
        out = _tcp_unpack(host, prog, replicas)
        return out if swept else out[0]

    fut = EngineFuture("dumbbell", fetch,
                       finalize_with_flush(flush, finalize))
    return fut.result() if block else fut
