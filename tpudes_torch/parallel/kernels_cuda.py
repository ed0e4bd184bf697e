"""The fused LTE TTI: plain PyTorch core + hand-written CUDA kernels.

Counterpart of ``tpudes/parallel/kernels_pallas.py``.  One TTI of the
full-buffer SM engine for every replica at once:

    retx admission -> scheduler metric + per-cell winner -> allocation
    -> MI/BLER decode -> HARQ bookkeeping

:func:`sm_step_math` is the plain PyTorch definition (any device), and
:func:`sm_advance_math` loops it over TTIs ``[t0, t1)`` with the
reference's decode coins.  Two kernels replace the TPU's
``pl.pallas_call`` (``kernels_pallas.py:473``):

- ``csrc/lte_sm_advance.cu`` runs a whole range of TTIs in one launch,
  drawing the coins inside (:func:`sm_advance`; ``run_lte_sm``'s path),
  for C config points (one scheduler id each) at once, with the
  SINR-derived rows either the program's constants (static) or a table
  of geometry refreshes (mobile: :data:`SM_DYNAMIC_ROWS`), or with
  finite backlogs filled from an offered-bits table (traffic:
  :data:`TR_STATE`);
- ``csrc/lte_sm_step.cu`` runs one TTI on coins the caller gives
  (:func:`sm_step`; the single-step route, static rows).

Both take ``precision="bf16"`` (``consts["bf16"]``): the metric and the
BLER argument round to bf16 where the reference's jitted step does
(:mod:`tpudes_torch.ops.lte`), on every arm.

Each wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors; it never falls back from one to the other.
Kernel and plain version give bit-identical state on the card: the
kernels round every product and sum on their own (``__fmul_rn``/
``__fadd_rn``, no contraction), use the same IEEE division, ``sqrtf``
and ``erfcf``, and the same evaluation order as the code below.

Layout: state is a dict of :data:`SM_STATE` tensors with a leading
lane axis, ``(C * R, U)`` per UE and ``(C * R, E)`` per cell, lane
``c * R + r`` holding replica ``r`` of config point ``c`` (the reference
carries ``(1, U)``/``(E, 1)`` per vmapped lane).  Constants are per
program and shared by every lane; so is a geometry table, whose row
``j`` holds the refresh at TTI ``stride * (t0 // stride + j)``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpudes_torch.device import resolve_device
from tpudes_torch.models.lte.scheduler import (
    HARQ_MAX_TX,
    HARQ_RTT_TTIS,
    rbg_size_for,
)
from tpudes_torch.ops.lte import (
    INV_SQRT2_F32,
    RB_BANDWIDTH_HZ,
    RE_PER_RB_DATA,
    _MCS_ECR,
    _MCS_EFF,
    _MCS_QM,
    cqi_from_sinr,
    mcs_from_cqi,
    mi_per_rb,
    round_bf16,
    tb_bler_ecr,
)
from tpudes_torch.random import tti_coins

#: scheduler short name -> dispatch id (``kernels_pallas.py:80-85``)
SM_SCHED_IDS = {
    "pf": 0, "cqa": 1, "pss": 2,
    "rr": 3, "tta": 4,
    "tdmt": 5, "fdmt": 6,
    "tdbet": 7, "fdbet": 8,
}

#: family boundaries: ids <= _PF_MAX take the PF metric, <= _RR_MAX
#: round-robin, <= _MT_MAX max-throughput, else BET
_PF_MAX = SM_SCHED_IDS["pss"]
_RR_MAX = SM_SCHED_IDS["tta"]
_MT_MAX = SM_SCHED_IDS["fdmt"]

NEG = -1e30  # the "no candidate" metric fill

#: the const rows a geometry refresh recomputes (``lte_sm.py:437``)
SM_DYNAMIC_ROWS = ("mi0", "rate0", "eff0", "ecr0", "eligible")

#: state layout: (key, axis, dtype) with axis "u" = (R, U), "e" = (R, E)
SM_STATE = (
    ("avg", "u", "f32"), ("pend", "u", "i32"),
    ("p_mi", "u", "f32"), ("p_tbb", "u", "f32"),
    ("p_nrbg", "u", "i32"), ("p_txc", "u", "i32"), ("p_due", "u", "i32"),
    ("rr_ptr", "e", "i32"),
    ("rx_lo", "u", "i32"), ("rx_hi", "u", "i32"),
    ("new_tbs", "u", "i32"), ("retx", "u", "i32"),
    ("drops", "u", "i32"), ("ok_cnt", "u", "i32"),
)
#: the finite-backlog state a traffic program adds (``lte_sm.py:939-943``):
#: the backlog in bits and the drained bits as a 20-bit split counter
TR_STATE = (
    ("tr_backlog", "u", "f32"),
    ("tr_drained_lo", "u", "i32"), ("tr_drained_hi", "u", "i32"),
)
_DTYPES = {"f32": torch.float32, "i32": torch.int32}

#: a backlog never grows past this many bits (``lte_sm.py:878``)
TR_BACKLOG_CAP = float(2**30)

#: the kernels' shared-memory scratch bounds (SM_MAX_U / SM_MAX_E in
#: csrc/lte_sm_step.cu, ADV_MAX_U / ADV_MAX_E in csrc/lte_sm_advance.cu)
KERNEL_MAX_U = 2048
KERNEL_MAX_E = 256
#: the last TTI an advance launch may reach (ADV_MAX_T)
ADVANCE_MAX_T = 2147483000

#: coin elements (T * R * U) the plain loop draws at once: bounds the
#: threefry temporaries to a few hundred MB
COIN_CHUNK_ELEMS = 1 << 22

#: launches of each of the port's kernels since the last reset — counted
#: where the kernel is launched and nowhere else; ``lte_sm_advance``'s
#: launches with a geometry table, with more than one config point, with
#: an offered-bits table and in bf16 are also counted under its
#: ``:dynamic``, ``:sweep``, ``:traffic`` and ``:bf16`` arms, and
#: ``lte_sm_step``'s in bf16 under ``:bf16``; ``bss_advance`` is the BSS
#: event loop's (:mod:`tpudes_torch.parallel.bss_cuda`), its launches of
#: an A-MPDU program also under ``:agg``, of more than one horizon under
#: ``:sweep``, of a mobile program under ``:mobile``, of a traffic program
#: under ``:traffic`` and of more than one workload under
#: ``:traffic_sweep``; ``tcp_advance`` is the TCP dumbbell's slot loop
#: (:mod:`tpudes_torch.parallel.tcp_cuda`), its launches of a RED program
#: also under ``:red``, of more than one variant point under ``:sweep``, of
#: an app-limited program under ``:trf`` and of more than one workload under
#: ``:trf_sweep``; ``wifi_window`` is the fused PHY window's
#: (:mod:`tpudes_torch.parallel.window_cuda`; a scan is two launches),
#: the scan's geometry kernel also under ``:geometry``, its scan kernel
#: under ``:scan`` and its table-model windows under ``:table``;
#: ``as_spf`` and ``as_fluid`` are the AS flow engine's routing stage and
#: fluid fixed point (:mod:`tpudes_torch.parallel.as_cuda`), the latter's
#: launches over more than one rate scale also under ``:sweep``
launches = {
    "lte_sm_step": 0, "lte_sm_step:bf16": 0, "lte_sm_advance": 0,
    "lte_sm_advance:dynamic": 0, "lte_sm_advance:sweep": 0,
    "lte_sm_advance:traffic": 0, "lte_sm_advance:bf16": 0,
    "bss_advance": 0, "bss_advance:agg": 0, "bss_advance:sweep": 0,
    "bss_advance:mobile": 0, "bss_advance:traffic": 0,
    "bss_advance:traffic_sweep": 0,
    "tcp_advance": 0, "tcp_advance:red": 0, "tcp_advance:sweep": 0,
    "tcp_advance:trf": 0, "tcp_advance:trf_sweep": 0,
    "wifi_window": 0, "wifi_window:geometry": 0, "wifi_window:scan": 0,
    "wifi_window:table": 0,
    "as_spf": 0, "as_fluid": 0, "as_fluid:sweep": 0,
    "wired_advance": 0, "wired_advance:owned": 0, "wired_advance:lanes": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# --------------------------------------------------------------------------
# build-time constants
# --------------------------------------------------------------------------


def build_sm_consts(prog, device=None) -> dict:
    """Per-program constants of the step (``kernels_pallas.py:121``).

    The static full-buffer grid makes SINR -> CQI -> MCS -> MI per-UE
    constants.  They are computed on the CPU (float64 SINR as the
    reference does, then the f32 chain) and moved to ``device`` (the
    card by default), so a run on the card uses the same bits as one on
    the CPU.  ``serving`` replaces the reference's ``(U, U)`` prefix
    operator: the kernels sum same-cell requests in UE order themselves,
    the multi-TTI one over ``cell_order`` (the UEs sorted stably by
    cell, so each cell is a contiguous run in UE order) and
    ``cell_start`` (each cell's first position in it, then ``U``).

    ``precision="bf16"`` rounds the SINR to bf16 storage and runs the
    CQI/MI chain op by op at bf16 (``kernels_pallas.py:147-157``), and
    sets ``bf16``: the step's metric and BLER argument then round as the
    reference's jitted step does."""
    device = resolve_device(device)
    bf16 = prog.precision == "bf16"
    E, U = prog.n_enb, prog.n_ue
    rbg_size = rbg_size_for(prog.n_rb)
    n_rbg = (prog.n_rb + rbg_size - 1) // rbg_size
    serving = np.asarray(prog.serving, dtype=np.int64)

    psd = 10.0 ** ((np.asarray(prog.tx_power_dbm) - 30.0) / 10.0) / (
        prog.n_rb * RB_BANDWIDTH_HZ
    )                                                      # (E,) W/Hz
    seen = psd[:, None] * np.asarray(prog.gain)            # (E, U)
    total = seen.sum(axis=0)
    sig = seen[serving, np.arange(U)]
    sinr = torch.from_numpy(
        np.asarray(sig / (total - sig + prog.noise_psd), np.float32)
    )
    if bf16:
        sinr = round_bf16(sinr)
    cqi = cqi_from_sinr(sinr, bf16)
    mcs0 = mcs_from_cqi(cqi).numpy()
    mi0 = mi_per_rb(sinr, torch.from_numpy(_MCS_QM[mcs0]), bf16)
    eff0 = _MCS_EFF[mcs0]
    rate0 = np.floor(eff0 * rbg_size * RE_PER_RB_DATA) * 1000.0

    pos = np.zeros((U,), dtype=np.int32)
    count_c = np.zeros((E,), dtype=np.int32)
    for u in range(U):
        c = int(serving[u])
        pos[u] = count_c[c]
        count_c[c] += 1
    count_u = np.maximum(count_c, 1)[serving]
    cell_order = np.argsort(serving, kind="stable")
    cell_start = np.concatenate([[0], np.cumsum(count_c)])

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return dict(
        E=E, U=U, n_rbg=n_rbg, rbg_size=rbg_size, n_rb=int(prog.n_rb),
        pf_alpha=float(prog.pf_alpha), bf16=bf16,
        sinr=f32(sinr), cqi=i32(cqi), mcs=i32(mcs0),
        mi0=f32(mi0), rate0=f32(rate0), eff0=f32(eff0),
        ecr0=f32(_MCS_ECR[mcs0]), eligible=i32(cqi.numpy() >= 1),
        serving=i32(serving), pos=i32(pos), count_u=i32(count_u),
        count_c=i32(count_c), cell_order=i32(cell_order),
        cell_start=i32(cell_start),
        cell_onehot=torch.as_tensor(
            serving[None, :] == np.arange(E)[:, None], device=device
        ),                                                 # (E, U) bool
    )


def sm_init_state(E: int, U: int, R: int, device=None,
                  traffic: bool = False) -> dict:
    """Zero state, PF averages at 1 (``kernels_pallas.py:211``), on
    ``device`` (the card by default); with ``traffic`` the
    :data:`TR_STATE` too, empty backlogs."""
    device = resolve_device(device)
    shapes = {"u": (R, U), "e": (R, E)}
    out = {
        k: torch.zeros(shapes[ax], dtype=_DTYPES[dt], device=device)
        for k, ax, dt in SM_STATE + TR_STATE * traffic
    }
    out["avg"].fill_(1.0)
    return out


# --------------------------------------------------------------------------
# the plain PyTorch core (``kernels_pallas.py:226-379``)
# --------------------------------------------------------------------------


def sm_admit_retx(c: dict, s: dict, t: int):
    """HARQ retransmission admission: due TBs fit the per-cell RBG budget
    in UE-index order; returns ``(pend, retx_fit, rem_c)``."""
    onehot = c["cell_onehot"]                              # (E, U)
    pend = s["pend"] != 0
    due = pend & (s["p_due"] <= t) & (c["eligible"] != 0)
    req = torch.where(due, s["p_nrbg"], 0)                 # (R, U)
    # exact integer same-cell prefix sum in UE order (the reference's
    # (U, U) f32 prefix matmul is exact below 2^24)
    cum = torch.cumsum(onehot * req[:, None, :], dim=-1)   # (R, E, U)
    serving = c["serving"].long()[None, None, :].expand(req.shape[0], 1, -1)
    cum_u = torch.gather(cum, 1, serving)[:, 0, :]
    retx_fit = due & (cum_u <= c["n_rbg"])
    used_c = (onehot * torch.where(retx_fit, req, 0)[:, None, :]).sum(-1)
    rem_c = (c["n_rbg"] - used_c).to(torch.int32)          # (R, E)
    return pend, retx_fit, rem_c


def sm_dispatch(c: dict, s: dict, pend, rem_c, sid: int) -> dict:
    """Scheduler dispatch: one metric per FF-MAC family, per-cell winner
    at the lowest UE index among equal maxima, winner takes the rest."""
    U = c["U"]
    onehot = c["cell_onehot"]
    cand = (c["eligible"] != 0) & ~pend                     # (R, U)
    avg = s["avg"]
    # bf16 (``kernels_pallas.py:262-280``): rate and average rounded, the
    # PF quotient in f32 and not rounded, as the jitted step computes it
    rate0 = round_bf16(c["rate0"]) if c["bf16"] else c["rate0"]
    avg_m = round_bf16(avg) if c["bf16"] else avg
    if sid <= _PF_MAX:
        metric = rate0 / torch.clamp_min(avg_m, 1.0)
    elif sid <= _RR_MAX:
        rr_ptr_u = torch.gather(
            s["rr_ptr"], 1, c["serving"].long().expand(avg.shape[0], -1)
        )
        ahead = torch.remainder(c["pos"] - rr_ptr_u, c["count_u"])
        metric = -ahead.to(torch.float32)
    elif sid <= _MT_MAX:
        metric = rate0.expand_as(avg)
    else:
        metric = -avg_m
    neg = torch.tensor(NEG, dtype=torch.float32, device=avg.device)
    m_eu = torch.where(
        onehot & cand[:, None, :], metric[:, None, :], neg
    )                                                      # (R, E, U)
    mx_e = m_eu.amax(dim=-1)                               # (R, E)
    iota_u = torch.arange(U, device=avg.device)
    win_idx = torch.where(m_eu == mx_e[..., None], iota_u, U).amin(dim=-1)
    has_win = (mx_e > neg) & (rem_c > 0)
    winner_oh = (iota_u == win_idx[..., None]) & has_win[..., None]
    is_winner = winner_oh.any(dim=1)                       # (R, U)
    new_nrbg = (winner_oh * rem_c[..., None]).sum(1).to(torch.int32)
    ptr_winner = (winner_oh * c["pos"]).sum(-1)            # (R, E)
    new_ptr = torch.where(
        has_win,
        torch.remainder(ptr_winner + 1, torch.clamp_min(c["count_c"], 1)),
        s["rr_ptr"],
    ).to(torch.int32)
    return dict(is_winner=is_winner, new_nrbg=new_nrbg, new_ptr=new_ptr)


def sm_decode(c: dict, s: dict, retx_fit, new_nrbg, is_winner, coin):
    """Transport blocks + HARQ-IR decode: TB bits from the static MCS,
    accumulated MI capped at 1, BLER, ``coin >= bler``."""
    new_nrb = torch.clamp_max(new_nrbg * c["rbg_size"], c["n_rb"])
    tb_new = torch.floor(
        c["eff0"] * new_nrb.to(torch.float32) * RE_PER_RB_DATA
    )
    tx = retx_fit | is_winner
    tbb_tx = torch.where(retx_fit, s["p_tbb"], tb_new)
    mi_tx = torch.where(
        retx_fit, torch.clamp_max(s["p_mi"] + c["mi0"], 1.0), c["mi0"]
    )
    bler = tb_bler_ecr(mi_tx, c["ecr0"], tbb_tx, c["bf16"])
    ok = tx & (coin >= bler)
    return tx, tbb_tx, mi_tx, ok


def sm_update(c: dict, s: dict, retx_fit, disp, tx, tbb_tx, mi_tx, ok,
              t: int) -> dict:
    """HARQ bookkeeping and accumulators: the pend/retx/drop ladder, the
    PF EMA, the 52-bit split rx counter."""
    fail = tx & ~ok
    txc_after = torch.where(retx_fit, s["p_txc"] + 1, 1)
    dropped = fail & (txc_after >= HARQ_MAX_TX)
    repend = fail & ~dropped
    # a due TB that did not fit the RBG budget stays pending
    keep = (s["pend"] != 0) & ~retx_fit
    served_bits = torch.where(ok, tbb_tx, 0.0)
    lo = s["rx_lo"] + served_bits.to(torch.int32)
    alpha = c["pf_alpha"]
    i32 = torch.int32
    return dict(
        avg=(1.0 - alpha) * s["avg"] + alpha * served_bits * 1000.0,
        pend=(keep | repend).to(i32),
        p_mi=torch.where(repend, mi_tx, s["p_mi"]),
        p_tbb=torch.where(repend, tbb_tx, s["p_tbb"]),
        p_nrbg=torch.where(
            repend,
            torch.where(retx_fit, s["p_nrbg"], disp["new_nrbg"]),
            s["p_nrbg"],
        ),
        p_txc=torch.where(repend, txc_after, s["p_txc"]).to(i32),
        p_due=torch.where(repend, t + HARQ_RTT_TTIS, s["p_due"]).to(i32),
        rr_ptr=disp["new_ptr"],
        # rx_lo rolls into rx_hi at 2^20 (<= 1e5 bits/TTI)
        rx_lo=lo & 0xFFFFF,
        rx_hi=s["rx_hi"] + (lo >> 20),
        new_tbs=s["new_tbs"] + disp["is_winner"].to(i32),
        retx=s["retx"] + retx_fit.to(i32),
        drops=s["drops"] + dropped.to(i32),
        ok_cnt=s["ok_cnt"] + ok.to(i32),
    )


def sm_step_math(c: dict, s: dict, coin, t: int, sid: int) -> dict:
    """One TTI of the whole chain in plain PyTorch (any device)."""
    pend, retx_fit, rem_c = sm_admit_retx(c, s, t)
    disp = sm_dispatch(c, s, pend, rem_c, sid)
    tx, tbb_tx, mi_tx, ok = sm_decode(
        c, s, retx_fit, disp["new_nrbg"], disp["is_winner"], coin
    )
    return sm_update(c, s, retx_fit, disp, tx, tbb_tx, mi_tx, ok, t)


def _sid_list(sids) -> list:
    """Scheduler ids as host ints: one int, or a ``(C,)`` tensor."""
    if isinstance(sids, int):
        return [sids]
    return [int(x) for x in sids.tolist()]


def table_rows(t0: int, t1: int, stride: int) -> int:
    """Rows a geometry table needs for TTIs ``[t0, t1)``: the refreshes
    ``stride * j`` for ``j`` from ``t0 // stride`` to
    ``(t1 - 1) // stride``."""
    return (t1 - 1) // stride - t0 // stride + 1 if t1 > t0 else 0


def sm_traffic_update(s: dict, new: dict, bl, served) -> dict:
    """The finite-backlog bookkeeping after one TTI
    (``lte_sm.py:893-914``): the backlog ``bl`` (offered bits added,
    capped) drains by the bits the TTI delivered, ``min(served, bl)``,
    and the drained bits count into a 20-bit split counter, rounded to
    integers."""
    drain = torch.minimum(served, bl)
    lo = s["tr_drained_lo"] + torch.round(drain).to(torch.int32)
    return dict(new, tr_backlog=bl - drain, tr_drained_lo=lo & 0xFFFFF,
                tr_drained_hi=s["tr_drained_hi"] + (lo >> 20))


def sm_advance_math(c: dict, s: dict, keys: torch.Tensor, t0: int, t1: int,
                    sids, rows: dict | None = None, stride: int = 1,
                    offered: torch.Tensor | None = None) -> dict:
    """TTIs ``[t0, t1)`` in plain PyTorch (any device): the decode coins
    of replica ``r`` at TTI ``t`` are ``uniform(fold_in(keys[r], t),
    (U,))`` (:func:`tpudes_torch.random.tti_coins`), drawn for as many
    TTIs at once as :data:`COIN_CHUNK_ELEMS` allows, then one
    :func:`sm_step_math` per TTI.

    ``sids`` is one scheduler id or a ``(C,)`` tensor of them; each
    point's ``R`` lanes run on the same ``R`` keys.  ``rows`` (the
    :data:`SM_DYNAMIC_ROWS`, each ``(J, U)``, ``J =``
    :func:`table_rows`) replaces the program's rows: TTI ``t`` runs on
    row ``t // stride - t0 // stride``, reloaded at ``t0`` and at every
    multiple of ``stride``.  ``offered`` (``(t1 - t0, U)`` f32 bits)
    fills each lane's backlog (:data:`TR_STATE` in ``s``) before TTI
    ``t`` with row ``t - t0``, gates ``eligible`` by a non-empty backlog
    (``lte_sm.py:876-892``) and drains it after the TTI
    (:func:`sm_traffic_update`); ``rows`` and ``offered`` exclude each
    other."""
    points = _sid_list(sids)
    R = len(keys)
    if len(points) > 1:
        parts = [
            sm_advance_math(
                c, {k: v[i * R:(i + 1) * R] for k, v in s.items()}, keys,
                t0, t1, sid, rows, stride, offered,
            )
            for i, sid in enumerate(points)
        ]
        return {k: torch.cat([p[k] for p in parts]) for k in s}
    sid, U, ct = points[0], c["U"], c
    chunk = max(1, COIN_CHUNK_ELEMS // (R * U))
    for c0 in range(t0, t1, chunk):
        c1 = min(c0 + chunk, t1)
        coins = tti_coins(keys, c0, c1, U)                  # (T, R, U)
        for i in range(c1 - c0):
            t = c0 + i
            if rows is not None and (t == t0 or t % stride == 0):
                j = t // stride - t0 // stride
                ct = {**c, **{k: rows[k][j] for k in SM_DYNAMIC_ROWS}}
            if offered is None:
                s = sm_step_math(ct, s, coins[i], t, sid)
                continue
            bl = torch.clamp_max(s["tr_backlog"] + offered[t - t0],
                                 TR_BACKLOG_CAP)
            ct = dict(c, eligible=c["eligible"] * (bl > 0.0))
            new = sm_step_math(ct, s, coins[i], t, sid)
            served = ((new["rx_hi"] - s["rx_hi"]).float() * float(2**20)
                      + (new["rx_lo"] - s["rx_lo"]).float())
            s = sm_traffic_update(s, new, bl, served)
    return s


def sm_winner_key(metric: np.ndarray, ue: np.ndarray) -> np.ndarray:
    """The key whose per-cell maximum ``csrc/lte_sm_advance.cu`` takes
    as its cell's winner, mirrored in numpy: ``orderable(metric) << 32 |
    (0xFFFFFFFF - ue)`` as uint64, where ``orderable`` maps the f32 bits
    (``-0.0`` first made ``+0.0``) to an order unsigned comparison keeps.
    The largest key holds the highest metric and, among equal metrics,
    the lowest UE index — the winner :func:`sm_dispatch` picks."""
    bits = (np.asarray(metric, np.float32) + np.float32(0.0)).view(np.uint32)
    hi = np.where(bits >> 31 != 0, ~bits, bits | np.uint32(0x80000000))
    lo = np.uint32(0xFFFFFFFF) - np.asarray(ue, np.uint32)
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


# --------------------------------------------------------------------------
# the wrapper and the kernel launch
# --------------------------------------------------------------------------

_CONST_ROWS = (
    ("mi0", torch.float32), ("rate0", torch.float32),
    ("eff0", torch.float32), ("ecr0", torch.float32),
    ("eligible", torch.int32), ("pos", torch.int32),
    ("count_u", torch.int32), ("serving", torch.int32),
)
_ROW_DTYPES = dict(_CONST_ROWS)


def sm_step(c: dict, s: dict, coin: torch.Tensor, t: int, sid: int) -> dict:
    """One TTI: the plain core for CPU tensors, the CUDA kernel for CUDA
    tensors (or an error).  ``coin`` is ``(R, U)`` f32."""
    if coin.device.type == "cpu":
        return sm_step_math(c, s, coin, t, sid)
    if coin.device.type == "cuda":
        return sm_step_cuda(c, s, coin, t, sid)
    raise ValueError(f"no LTE SM step for device {coin.device}")


def sm_advance(c: dict, s: dict, keys: torch.Tensor, t0: int, t1: int,
               sids, rows: dict | None = None, stride: int = 1,
               offered: torch.Tensor | None = None) -> dict:
    """TTIs ``[t0, t1)``: the plain loop for CPU tensors, one launch of
    the multi-TTI CUDA kernel for CUDA tensors (or an error).  ``keys``
    is the ``(R, 2)`` int64 replica keys; ``sids``, ``rows``, ``stride``
    and ``offered`` as in :func:`sm_advance_math`."""
    if keys.device.type == "cpu":
        return sm_advance_math(c, s, keys, t0, t1, sids, rows, stride,
                               offered)
    if keys.device.type == "cuda":
        return sm_advance_cuda(c, s, keys, t0, t1, sids, rows, stride,
                               offered)
    raise ValueError(f"no LTE SM advance for device {keys.device}")


def _check(name, x, shape, dtype, device):
    if (
        x.device != device or x.dtype != dtype
        or tuple(x.shape) != shape or not x.is_contiguous()
    ):
        raise ValueError(
            f"{name}: want contiguous {dtype} {shape} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (non-contiguous)'}"
        )


def _kernel_io(name: str, c: dict, s: dict, R: int, dev,
               layout=SM_STATE) -> dict:
    """Check what every launch reads (the constant rows and the ``R``
    lanes of the ``layout`` state) and allocate the state it writes, in
    fresh tensors (no in-place hazard)."""
    E, U = c["E"], c["U"]
    if U > KERNEL_MAX_U or E > KERNEL_MAX_E:
        raise ValueError(
            f"{name} scratch holds U <= {KERNEL_MAX_U}, "
            f"E <= {KERNEL_MAX_E}; got U={U}, E={E}"
        )
    if R * U >= 2**31:
        raise ValueError(f"{name} indexes state in int32; R*U={R * U}")
    for k, dt in _CONST_ROWS:
        _check(k, c[k], (U,), dt, dev)
    _check("count_c", c["count_c"], (E,), torch.int32, dev)
    shapes = {"u": (R, U), "e": (R, E)}
    out = {}
    for k, ax, dt in layout:
        _check(k, s[k], shapes[ax], _DTYPES[dt], dev)
        out[k] = torch.empty(shapes[ax], dtype=_DTYPES[dt], device=dev)
    return out


def _scalars(c: dict, R: int) -> list:
    """The launchers' shared scalars: R, E, U, n_rbg, rbg_size, n_rb,
    alpha, 1 - alpha, 1/sqrt 2."""
    alpha = c["pf_alpha"]
    return [
        R, c["E"], c["U"], c["n_rbg"], c["rbg_size"], c["n_rb"],
        ctypes.c_float(alpha), ctypes.c_float(1.0 - alpha),
        ctypes.c_float(INV_SQRT2_F32),
    ]


def _launch(name: str, *args, arms: tuple = (), argtypes=None) -> None:
    """Call ``<name>_launch`` (its ctypes signature ``argtypes``, by
    default :data:`LAUNCH_ARGTYPES`'s) and count the launch (and its
    ``arms``); raise on an error."""
    err = _launcher(name, argtypes)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1
    for arm in arms:
        launches[f"{name}:{arm}"] += 1


def sm_step_cuda(c: dict, s: dict, coin: torch.Tensor, t: int,
                 sid: int) -> dict:
    """Launch ``lte_sm_step`` once: one CTA per replica.  Raises on a bad
    argument or a launch error; never takes the plain core."""
    dev = coin.device
    R = coin.shape[0]
    _check("coin", coin, (R, c["U"]), torch.float32, dev)
    out = _kernel_io("lte_sm_step", c, s, R, dev)
    _launch(
        "lte_sm_step",
        *[c[k].data_ptr() for k, _ in _CONST_ROWS],
        c["count_c"].data_ptr(), coin.data_ptr(),
        *[s[k].data_ptr() for k, _, _ in SM_STATE],
        *[out[k].data_ptr() for k, _, _ in SM_STATE],
        *_scalars(c, R), int(t), int(sid), int(c["bf16"]),
        torch.cuda.current_stream(dev).cuda_stream,
        arms=("bf16",) * c["bf16"],
    )
    return out


def sm_advance_cuda(c: dict, s: dict, keys: torch.Tensor, t0: int, t1: int,
                    sids, rows: dict | None = None, stride: int = 1,
                    offered: torch.Tensor | None = None) -> dict:
    """Launch ``lte_sm_advance`` once for TTIs ``[t0, t1)``: a grid of
    ``(R, C)`` CTAs, one per replica and config point, the state in
    registers for the whole range, the coins drawn in the kernel, the
    rows reloaded from ``rows`` at each refresh when it is given, the
    backlogs filled from ``offered`` row by row when it is given.
    Raises on a bad argument or a launch error; never takes the plain
    loop."""
    if not 0 <= t0 <= t1 <= ADVANCE_MAX_T:
        raise ValueError(
            f"lte_sm_advance runs 0 <= t0 <= t1 <= {ADVANCE_MAX_T}; got "
            f"t0={t0}, t1={t1}"
        )
    dev = keys.device
    R, E, U = keys.shape[0], c["E"], c["U"]
    _check("keys", keys, (R, 2), torch.int64, dev)
    _check("cell_order", c["cell_order"], (U,), torch.int32, dev)
    _check("cell_start", c["cell_start"], (E + 1,), torch.int32, dev)
    if isinstance(sids, int):
        C, sid, sids_ptr = 1, sids, None
    else:
        C, sid = sids.shape[0], 0
        if not 1 <= C <= 65535:
            raise ValueError(f"lte_sm_advance runs 1..65535 points; got {C}")
        _check("sids", sids, (C,), torch.int32, dev)
        sids_ptr = sids.data_ptr()
    table = [None] * len(SM_DYNAMIC_ROWS)
    if rows is not None:
        if stride < 1:
            raise ValueError(f"geometry stride must be >= 1; got {stride}")
        J = table_rows(t0, t1, stride)
        for i, k in enumerate(SM_DYNAMIC_ROWS):
            _check(f"rows[{k}]", rows[k], (J, U), _ROW_DTYPES[k], dev)
            table[i] = rows[k].data_ptr()
    traffic = offered is not None
    if traffic:
        if rows is not None:
            raise ValueError("lte_sm_advance takes a geometry table or an "
                             "offered-bits table, not both")
        _check("offered", offered, (t1 - t0, U), torch.float32, dev)
    layout = SM_STATE + TR_STATE * traffic
    out = _kernel_io("lte_sm_advance", c, s, C * R, dev, layout)
    tr_in = [s[k].data_ptr() if traffic else None for k, _, _ in TR_STATE]
    tr_out = [out[k].data_ptr() if traffic else None for k, _, _ in TR_STATE]
    _launch(
        "lte_sm_advance",
        *[c[k].data_ptr() for k, _ in _CONST_ROWS],
        c["count_c"].data_ptr(), c["cell_order"].data_ptr(),
        c["cell_start"].data_ptr(), *table,
        offered.data_ptr() if traffic else None, keys.data_ptr(), sids_ptr,
        *[s[k].data_ptr() for k, _, _ in SM_STATE], *tr_in,
        *[out[k].data_ptr() for k, _, _ in SM_STATE], *tr_out,
        R, C, *_scalars(c, R)[1:], int(t0), int(t1), int(sid),
        int(stride), int(c["bf16"]),
        torch.cuda.current_stream(dev).cuda_stream,
        arms=("dynamic",) * (rows is not None) + ("sweep",) * (C > 1)
        + ("traffic",) * traffic + ("bf16",) * c["bf16"],
    )
    return out


#: ctypes signature of each ``<name>_launch``:
#: ``lte_sm_step`` (csrc/lte_sm_step.cu): const rows, count_c, coin,
#: state in, state out, six ints (R, E, U, n_rbg, rbg_size, n_rb), three
#: floats (alpha, 1 - alpha, 1/sqrt 2), t, sid, bf16, stream;
#: ``lte_sm_advance`` (csrc/lte_sm_advance.cu): const rows, count_c,
#: cell_order, cell_start, the five table rows (null: the static arm),
#: the offered-bits table (null: full buffers), keys, sids (null: one
#: point, ``sid``), state in and the three traffic fields (null without
#: traffic), state out and the three traffic fields, seven ints (R, C,
#: E, U, n_rbg, rbg_size, n_rb), the three floats, t0, t1, sid, stride,
#: bf16, stream
LAUNCH_ARGTYPES = {
    "lte_sm_step": (
        [ctypes.c_void_p] * (len(_CONST_ROWS) + 2 + 2 * len(SM_STATE))
        + [ctypes.c_int] * 6 + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_void_p]
    ),
    "lte_sm_advance": (
        [ctypes.c_void_p] * (
            len(_CONST_ROWS) + 3 + len(SM_DYNAMIC_ROWS) + 3
            + 2 * (len(SM_STATE) + len(TR_STATE))
        )
        + [ctypes.c_int] * 7 + [ctypes.c_float] * 3 + [ctypes.c_int] * 5
        + [ctypes.c_void_p]
    ),
}


def _launcher(name: str, argtypes=None):
    """``<name>_launch`` from the built library (built on first use),
    with its ctypes signature."""
    from tpudes_torch._build import load_library

    fn = getattr(load_library(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes or LAUNCH_ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn
