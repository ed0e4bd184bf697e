"""The WiFi BSS replica engine on the card.

Counterpart of ``tpudes/parallel/replicated.py``: R Monte-Carlo replicas
of one infrastructure BSS (an AP and N - 1 STAs, DCF MAC, log-distance
loss, the NIST error model, UDP echo upstream, beacons) advance together,
each to its own next event — an arrival, or the earliest transmit instant
from backoff, AIFS and the medium's ``busy_until`` — one step at a time,
until no replica has an event before the horizon.  Per-replica state is
``(R, N)`` and ``(R,)`` tensors; time is a per-replica integer µs clock.
The event loop holds a grid of C horizons, ``(C, R, N)`` and ``(C, R)``;
a single run is its C = 1.

The event loop is :func:`bss_advance`: on the card one launch of the
persistent kernel ``csrc/bss_advance.cu`` (:mod:`tpudes_torch.parallel.
bss_cuda`) runs every step of a chunk for every replica, one warp per
replica; on the CPU :func:`bss_advance_math` runs the step below in a
loop under the reference's loop condition.  Replica ``r`` draws its
step-``s`` backoffs and decode coins from ``split(fold_in(fold_in(key,
s), r))`` (:func:`tpudes_torch.random.bss_draws`), the reference's
streams bit for bit, so a run is comparable with the JAX engine per
replica.

Ported: the static program, legacy (one MPDU per exchange, an ack) and
802.11n (``max_mpdus = K > 1``: a winner sends its backlog, up to K
MPDUs, as one A-MPDU answered by a BlockAck; each subframe decodes on
its own coin at ``psr ** (1 / k)``); a mobile program (``mobility``:
every ``geom_stride`` steps each replica rebuilds its ``(N, N)`` rx power
and detectability tables at its own next event time, f32 device
geometry, :func:`geom_tables`; the state carries that time, ``geom_t``);
a traffic program (``traffic``: each arrival's next gap from the
workload model, :func:`tpudes_torch.traffic.device.entry_gaps`, keyed by
``fold_in(fold_in(key, 0x7A), r)``); and the two config axes, the
``sim_end_us=[...]`` horizon sweep and the ``traffic_sweep=[...]``
workload sweep: C points as a ``(C, R)`` grid of one launch, each point
its own loop (the reference vmaps its ``while_loop``, so a point stops
when its own replicas are done, on its own step count).  The
reference's timing model and its documented deviations
(``replicated.py:38-60``, ``:962-967``) are reproduced, not corrected:
the 1 µs clock with the propagation delay folded into the exchange,
acks assumed decodable, one ``busy_until`` per replica, the same-µs
double decode (two senders tying on one µs are each decoded at their
own destination), and the whole A-MPDU dropped at the node's retry
limit.

The engine runs on :mod:`tpudes_torch.parallel.runtime`: the program's
constants sit in the runner cache (keyed by value, as the reference's
``_prog_cache_key``), the replica axis is padded to its power-of-two
bucket (so ``steps`` counts the padded replicas' steps, as the
reference's does), the chunks go through ``drive_chunks``
(``checkpoint=`` saves the carry after each), and ``block=False``
returns an :class:`~tpudes_torch.parallel.runtime.EngineFuture`.
:func:`bss_study` is the serving layer's descriptor.

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
from tpudes_torch.ops.fused import f32
from tpudes_torch.ops.interference import thermal_noise_w
from tpudes_torch.ops.mobility import build_position_fn
from tpudes_torch.ops.propagation import (
    dbm_to_w,
    log_distance_loss,
    pairwise_distance,
)
from tpudes_torch.ops.wifi_error import (
    ALL_MODES,
    MODES_BY_NAME,
    ampdu_airtime,
    mode_chunk_success_rate,
    mpdu_success_rate,
)
from tpudes_torch.parallel.bss_cuda import BSS_STATE, bss_advance_cuda
from tpudes_torch.parallel.runtime import (
    RUNTIME,
    EngineFuture,
    _not_ported,
    bucket_replicas,
    chunk_bounds,
    drive_chunks,
    finalize_with_flush,
)
from tpudes_torch.random import bss_draws, mpdu_coins, traffic_keys
from tpudes_torch.traffic.device import entry_gaps, stack_traffic_operands
from tpudes_torch.traffic.host import offered_packets
from tpudes_torch.traffic.program import TRAFFIC_MODEL_IDS

__all__ = [
    "BssProgram", "bss_advance", "bss_advance_math", "build_bss_advance",
    "build_bss_consts", "build_bss_step", "bss_study", "geom_tables",
    "run_replicated_bss",
]

# µs timing constants, 802.11a OFDM 20 MHz (``replicated.py:87-93``)
SLOT = 9
SIFS = 16
DIFS = 34
CW_MIN = 15
CW_MAX = 1023
RETRY_LIMIT = 7
INF = 2**30

#: the association + ARP warm-up the lowering skips (``replicated.py:100``)
MODELED_WARMUP_S = 0.25

#: draws (steps x R x N, each of u_back and u_coin) the plain loop makes
#: at once: bounds the threefry temporaries to a few hundred MB.  An
#: A-MPDU program's (N, K) coins are hashed only for the gated frames of
#: a step (:func:`tpudes_torch.random.mpdu_coins`)
DRAW_CHUNK_ELEMS = 1 << 21

#: the response under a BlockAck session: a compressed BlockAck's on-air
#: bytes (``models/wifi/mac.py:76-78``), else a normal ack's
BLOCK_ACK_BYTES, ACK_BYTES = 32, 14


@dataclass(frozen=True)
class BssProgram:
    """Static description of one BSS scenario (``replicated.py:140-199``),
    the same fields.  Node 0 is the AP.  ``mobility`` (a
    :class:`tpudes_torch.ops.mobility.MobilityProgram`, None: static)
    moves the nodes, the geometry rebuilt every ``geom_stride`` steps;
    ``traffic`` (a :class:`tpudes_torch.traffic.program.TrafficProgram`
    over the N nodes, entity 0 the AP's beacons; None: the CBR advance)
    gives every gap after the first arrival, which ``start_us`` sets."""

    positions: np.ndarray        # (N, 3) f32
    data_mode_idx: int           # WifiMode index for data frames
    ack_mode_idx: int            # WifiMode index for the ack
    data_bytes: int              # on-air PSDU bytes of a data frame
    beacon_bytes: int            # on-air PSDU bytes of a beacon
    start_us: np.ndarray         # (N,) first app event (AP: beacon)
    interval_us: np.ndarray      # (N,) app period
    stop_us: np.ndarray          # (N,) no arrivals at/after this time
    sim_end_us: int
    tx_power_dbm: float = 16.0206
    path_loss_exponent: float = 3.0
    reference_loss_db: float = 46.6777
    noise_figure_db: float = 7.0
    bandwidth_hz: float = 20e6
    rx_sensitivity_dbm: float = -101.0
    #: contention AIFS for data (DIFS legacy; SIFS + 3 SLOT for QoS AC_BE)
    aifs_us: int = DIFS
    #: A-MPDU cap (1 = legacy single-MPDU DATA/ACK)
    max_mpdus: int = 1
    #: on-air bytes of one A-MPDU subframe (used when max_mpdus > 1)
    subframe_bytes: int = 0
    mobility: object = None
    geom_stride: int = 1
    traffic: object = None

    @property
    def n(self) -> int:
        return int(self.positions.shape[0])


def _preamble_us(mode) -> int:
    """20 µs legacy preamble + L-SIG; the HT family adds the 16 µs
    HT-mixed fields (``replicated.py:202-205``)."""
    return 36 if mode.standard == "ht" else 20


def _ppdu_us(size_bytes: int, mode) -> int:
    """PPDU airtime in whole µs, ceil'd (``replicated.py:208-212``)."""
    ndbps = mode.data_rate_bps * 4e-6
    nsym = math.ceil((16 + 8 * size_bytes + 6) / ndbps)
    return _preamble_us(mode) + nsym * 4


def _pairwise_rx_dbm(prog: BssProgram) -> np.ndarray:
    """(N, N) tx -> rx power in dBm under the program's log-distance
    physics, f64; the diagonal is the unused self-pair at 1 m
    (``replicated.py:508-519``)."""
    pos = prog.positions.astype(np.float64)
    d = np.sqrt(((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(d, 1.0)
    loss = prog.reference_loss_db + 10.0 * prog.path_loss_exponent * np.log10(
        np.maximum(d, 1.0)
    )
    return prog.tx_power_dbm - loss


def _total_offered_arrivals(prog: BssProgram) -> int:
    """App arrivals offered over the horizon (``replicated.py:522-533``)."""
    total = 0
    for s1, iv, s2 in zip(prog.start_us, prog.interval_us, prog.stop_us):
        if s1 >= INF or iv >= INF:
            continue
        horizon = min(int(s2), prog.sim_end_us)
        if horizon > int(s1):
            total += (horizon - int(s1) + int(iv) - 1) // int(iv)
    return total


def _estimate_max_steps(prog: BssProgram) -> int:
    """One arrival and up to 1 + RETRY_LIMIT transmissions per frame,
    plus slack (``replicated.py:536-553``): the CBR count, or a traffic
    program's own offered total where that is larger."""
    total = _total_offered_arrivals(prog)
    if prog.traffic is not None:
        horizon = np.minimum(prog.stop_us.astype(np.int64), prog.sim_end_us)
        total = max(total, int(np.ceil(
            offered_packets(prog.traffic, horizon).sum())))
    return int(total * (3 + RETRY_LIMIT) * 1.5) + 64


def _bss_nominal_step_s(prog: BssProgram) -> float:
    """The nominal spacing of event steps, the horizon over three events
    per offered arrival: ``geom_stride`` in seconds for the coherence
    advisory (``replicated.py:497-505``)."""
    return prog.sim_end_us * 1e-6 / max(3 * _total_offered_arrivals(prog), 1)


def _walk_worst_case_ok(prog: BssProgram, mobility) -> bool:
    """The exact mutual-sensing bound of a random walk
    (``replicated.py:467-494``): a walker may reach any point of its
    bounds rectangle, so the worst separation is the diagonal (two
    walkers) or the farthest corner from a pinned node."""
    xmin, xmax, ymin, ymax = (float(v) for v in mobility.bounds)
    corners = np.array([(xmin, ymin), (xmin, ymax), (xmax, ymin),
                        (xmax, ymax)])
    moving = mobility.speed[:, 1] > 0.0
    zs = mobility.base_pos[:, 2].astype(np.float64)
    dz_mm = (float(np.abs(zs[moving][:, None] - zs[moving][None, :]).max())
             if moving.sum() >= 2 else 0.0)
    worst = 0.0
    if moving.sum() >= 2:
        worst = math.hypot(math.hypot(xmax - xmin, ymax - ymin), dz_mm)
    for pos in mobility.base_pos[~moving].astype(np.float64):
        for z_m in zs[moving]:
            d_xy = np.sqrt(((corners - pos[None, :2]) ** 2).sum(-1)).max()
            worst = max(worst, math.hypot(float(d_xy), float(pos[2] - z_m)))
    loss = prog.reference_loss_db + 10.0 * prog.path_loss_exponent * (
        math.log10(max(worst, 1.0)))
    return prog.tx_power_dbm - loss >= prog.rx_sensitivity_dbm


def _prog_cache_key(prog: BssProgram) -> tuple:
    """Hashable identity of a program by value (``replicated.py:1106``):
    every field, arrays as bytes, but ``sim_end_us`` and ``geom_stride``
    (a launch's operands) and the mobility and workload parameters (only
    their shape keys are in)."""
    out = []
    for k, v in prog.__dict__.items():
        if k in ("sim_end_us", "geom_stride"):
            continue
        if k in ("mobility", "traffic"):
            out.append(None if v is None else v.shape_key())
        elif isinstance(v, np.ndarray):
            out.append(v.tobytes())
        else:
            out.append(v)
    return tuple(out)


def build_bss_consts(prog: BssProgram, device=None,
                     traffic_sweep=None, static: dict | None = None) -> dict:
    """The step's per-program constants (``replicated.py:603-637``), on
    ``device`` (the card by default): the f32 rx power table (N, N)
    from the f64 host table (diagonal 0), the detectability table, the
    arrival timing rows, the exchange durations in µs (the response a
    BlockAck under aggregation, else an ack), ``nbits`` of a legacy data
    frame (the PPDU airtime at the payload rate), the noise floor, the
    data mode, and the A-MPDU cap ``K`` (1: legacy) with the subframe
    bytes.

    A mobile program adds ``mob``: the position math's operands, the
    refresh stride and the physics the tables take (:func:`geom_tables`);
    a traffic program adds ``tr``, its operands stacked on a leading
    point axis (the ``traffic_sweep`` programs', one point each, else
    the program's own) with its ``epoch_us`` and the model ids they
    run.  ``static`` is :func:`bss_static_consts` where the caller has
    it (the runner cache), else built here."""
    device = resolve_device(device)
    mob = None
    if prog.mobility is not None:
        mob = dict(
            ops=prog.mobility.operands(device),
            model=prog.mobility.model,
            positions_at=build_position_fn(prog.mobility),
            stride=max(1, int(prog.geom_stride)),
            seg_us=float(prog.mobility.seg_us),
            tx_dbm=float(np.float32(prog.tx_power_dbm)),
            exponent=float(prog.path_loss_exponent),
            ref_loss=float(prog.reference_loss_db),
            sens=float(prog.rx_sensitivity_dbm),
        )
    tr = None
    if traffic_sweep is not None or prog.traffic is not None:
        progs = (list(traffic_sweep) if traffic_sweep is not None
                 else [prog.traffic])
        tr = dict(ops=stack_traffic_operands(progs, device),
                  epoch_us=int(progs[0].epoch_us),
                  models={int(m) for tp in progs for m in tp.model_ids()})
    if static is None:
        static = bss_static_consts(prog, device)
    return dict(static, sim_end=int(prog.sim_end_us), mob=mob, tr=tr)


def bss_static_consts(prog: BssProgram, device=None) -> dict:
    """The part of :func:`build_bss_consts` that is a pure function of
    :func:`_prog_cache_key` (what the runner cache holds): the tables,
    the timing rows and the exchange constants."""
    device = resolve_device(device)
    data_mode = ALL_MODES[prog.data_mode_idx]
    ack_mode = ALL_MODES[prog.ack_mode_idx]
    ndbps = data_mode.data_rate_bps * 4e-6
    data_airtime_s = (
        _preamble_us(data_mode) * 1e-6
        + math.ceil((16 + 8 * prog.data_bytes + 6) / ndbps) * 4e-6
    )
    rx_dbm = _pairwise_rx_dbm(prog)
    rx_w = 10.0 ** ((rx_dbm - 30.0) / 10.0)
    np.fill_diagonal(rx_w, 0.0)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return dict(
        N=prog.n,
        rx_w=torch.as_tensor(rx_w.astype(np.float32), device=device),
        det=torch.as_tensor(rx_dbm >= prog.rx_sensitivity_dbm,
                            device=device),
        start=i32(prog.start_us), interval=i32(prog.interval_us),
        stop=i32(prog.stop_us),
        aifs=int(prog.aifs_us),
        data_dur=_ppdu_us(prog.data_bytes, data_mode),
        resp_dur=_ppdu_us(BLOCK_ACK_BYTES if prog.max_mpdus > 1
                          else ACK_BYTES, ack_mode),
        exch_beacon=_ppdu_us(prog.beacon_bytes,
                             MODES_BY_NAME["OfdmRate6Mbps"]),
        nbits=float(np.float32(data_mode.data_rate_bps * data_airtime_s)),
        noise_w=float(np.float32(
            thermal_noise_w(prog.bandwidth_hz, prog.noise_figure_db)
        )),
        mode=int(prog.data_mode_idx),
        K=max(1, int(prog.max_mpdus)),
        subframe_bytes=int(prog.subframe_bytes),
    )


def geom_tables(c: dict, t: torch.Tensor):
    """The mobile step's geometry stage at the ``(T,)`` int32 event times
    ``t`` (``replicated.py:654-672``): positions, then ``((T, N, N) rx
    power in W, diagonal 0; (T, N, N) detectability)`` under the
    log-distance physics, in the compiled f32 arithmetic of the
    reference's step (:mod:`tpudes_torch.ops.propagation`)."""
    m = c["mob"]
    pos = m["positions_at"](m["ops"], t)
    loss = log_distance_loss(pairwise_distance(pos), m["exponent"], 1.0,
                             m["ref_loss"])
    det = (f32(loss, m["tx_dbm"]) - loss) >= f32(loss, m["sens"])
    rx_w = dbm_to_w(m["tx_dbm"], loss)
    eye = torch.eye(pos.shape[1], dtype=torch.bool, device=pos.device)
    return torch.where(eye, 0.0, rx_w), det


# --------------------------------------------------------------------------
# the plain PyTorch step (``replicated.py:674-1103``)
# --------------------------------------------------------------------------


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a pairwise tree: zero-padded to a power
    of two, then adjacent pairs added level by level.  The kernel's
    block reduction adds in the same order (warp shuffles, then the warp
    totals), so the two agree bit for bit.  With one or two non-zero
    terms every order gives the same sum; with three or more the
    reference's dot may round differently (a counted tie class)."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width > n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def init_state(consts: dict, replicas: int) -> dict:
    """The zero state (``replicated.py:674-707``): arrivals at their
    start times, CW at its minimum, ``geom_t`` 0; laid out as
    :data:`BSS_STATE`."""
    R, n = replicas, consts["N"]
    dev = consts["rx_w"].device
    out = {}
    for k, ax, dt in BSS_STATE:
        shape = (R, n) if ax == "n" else (R,)
        out[k] = torch.zeros(shape, dtype=torch.bool if dt == "bool"
                             else torch.int32, device=dev)
    out["next_arr"] = consts["start"].expand(R, n).clone()
    out["cw"].fill_(CW_MIN)
    return out


def with_tables(consts: dict, state: dict) -> dict:
    """``state`` (rows first) with a mobile program's tables rebuilt at
    its ``geom_t`` (:func:`geom_tables`), as the step carries them; the
    state itself for a static program."""
    if consts["mob"] is None:
        return state
    shape = state["geom_t"].shape
    rx_w, det = geom_tables(consts, state["geom_t"].reshape(-1))
    n = consts["N"]
    return dict(state, geom_rx_w=rx_w.reshape(*shape, n, n),
                geom_det=det.reshape(*shape, n, n))


def has_frame(s: dict) -> torch.Tensor:
    """(R, N): a STA with a queued request, the AP with a beacon or an
    echo pending (``replicated.py:709-715``)."""
    frame = s["queue"] > 0
    ap = (s["bcn_pend"] > 0) | (s["ap_pend"] > 0).any(1)
    frame[:, 0] = ap
    return frame


def tx_times(c: dict, s: dict) -> torch.Tensor:
    """(R, N) earliest allowed tx instant per contender, INF else
    (``replicated.py:717-725``)."""
    t = s["t"][:, None]
    base = torch.maximum(s["busy_until"][:, None], s["hold"])
    countdown = base + c["aifs"] + s["backoff"] * SLOT
    tx = torch.where(s["immediate"], torch.maximum(t, base), countdown)
    return torch.where(has_frame(s), torch.maximum(tx, t), INF)


def pending(c: dict, s: dict, sim_end) -> torch.Tensor:
    """(R,): the replica has an event before the horizon
    (``replicated.py:1095-1098``)."""
    nxt = torch.minimum(tx_times(c, s).amin(1), s["next_arr"].amin(1))
    return (s["t"] < sim_end) & (nxt < sim_end)


def decode_mpdus(c: dict, sinr: torch.Tensor, k: torch.Tensor,
                 nbits: torch.Tensor, coins: torch.Tensor):
    """``(n_ok, p_mpdu)`` of gated A-MPDUs of ``k`` subframes
    (``replicated.py:919-951``): subframe ``j < k`` decodes when its coin
    ``coins[:, j]`` falls below ``psr ** (1 / k)`` at the PPDU's SINR and
    ``nbits``."""
    p = mpdu_success_rate(sinr, nbits, k, c["mode"])
    j = torch.arange(coins.shape[-1], device=coins.device)
    ok = (coins < p[:, None]) & (j[None, :] < k[:, None])
    return ok.sum(1, dtype=torch.int32), p


def _tally(census: dict, name: str, value: torch.Tensor) -> None:
    census[name] = census.get(name, 0) + value.to(torch.int64).sum()


def _ulp_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ulps between non-negative f32 values (their bit patterns' gap)."""
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def step_fn(c: dict, s: dict, u_back: torch.Tensor, u_coin,
            sim_end, census: dict | None = None, refresh: bool = False,
            tr: dict | None = None) -> dict:
    """One event step of every replica (``replicated.py:738-1093``) on
    its ``(R, N)`` backoff draws and its coins: ``(R, N)`` for a legacy
    program, for an A-MPDU one a function ``(rows, nodes) -> (G, K)``
    that draws the rows of the ``(N, K)`` coins the gated frames need
    (:func:`tpudes_torch.random.mpdu_coins`).  ``sim_end`` is the
    horizon, an int or an ``(R,)`` tensor (a horizon per row: the
    event loop's grid of horizons, flattened).

    A mobile program's state carries its tables, ``geom_rx_w`` and
    ``geom_det`` (``(R, N, N)``, :func:`geom_tables` at ``geom_t``);
    with ``refresh`` the step rebuilds them at each replica's ``next_t``
    first and sets ``geom_t`` to it (``replicated.py:864-891``).  A
    traffic program takes ``tr``: ``point`` (``(R,)``, each row's point
    of ``c["tr"]``) and ``keys`` (``(R, 2)``,
    :func:`tpudes_torch.random.traffic_keys`).

    ``census``, a dict, gathers counts of what the step did, as 0-dim
    tensors added to in place (no host sync): ``gated`` data frames
    (decoded at their destination), their ``mpdus``, ``partial``
    A-MPDUs (some but not all subframes decoded), ``overlap`` (gated
    frames with another frame on the air), ``three_winners``
    (replica-steps with three or more same-µs winners, whose
    interference sum the reference's dot may round in its own order),
    ``coin_ties`` (coins within 4 ulp of their success rate),
    ``winners`` (transmissions), ``ed_links`` (the winners of steps
    where the AP sends data, whose power at its destination is summed)
    and, under a traffic program, the gaps drawn per model
    (``gaps_cbr``, ``gaps_mmpp``, ...)."""
    R, n = u_back.shape
    dev = u_back.device
    i32 = torch.int32
    node = torch.arange(n, device=dev)
    is_ap = node == 0
    aifs = c["aifs"]
    agg = c["K"] > 1

    frame = has_frame(s)
    tx_t = tx_times(c, s)
    tc = tx_t.amin(1)
    ta = s["next_arr"].amin(1)
    live = s["t"] < sim_end
    next_t = torch.where(live, torch.minimum(ta, tc), sim_end)
    past_end = next_t >= sim_end
    arrived = live & (ta <= tc) & (ta < INF) & ~past_end
    transmit = live & (tc < ta) & (tc < INF) & ~past_end

    # ---------- arrival processing
    is_arr = arrived[:, None] & (s["next_arr"] == next_t[:, None])
    new_queue = s["queue"] + (is_arr & ~is_ap).to(i32)
    new_bcn = s["bcn_pend"] + is_arr[:, 0].to(i32)
    gap_ids = None
    if c["tr"] is None:
        adv = torch.where(s["next_arr"] >= INF, INF,
                          s["next_arr"] + c["interval"])
    else:
        # the next gap from the workload model, taken at the arrivals
        # only (their next_arr is next_t < INF)
        rows, nodes = is_arr.nonzero(as_tuple=True)
        t_a = s["next_arr"][rows, nodes]
        adv = s["next_arr"].clone()
        point = tr["point"][rows]
        adv[rows, nodes] = t_a + entry_gaps(
            c["tr"]["ops"], c["tr"]["epoch_us"], point, nodes,
            tr["keys"][rows], t_a, c["tr"]["models"])
        gap_ids = c["tr"]["ops"]["tr_id"][point, nodes]
    adv = torch.where(adv >= c["stop"], INF, adv)
    new_next_arr = torch.where(is_arr, adv, s["next_arr"])
    any_ap = (s["ap_pend"] > 0).any(1)
    frame_after = torch.where(is_arr, new_queue > 0, frame)
    frame_after[:, 0] = torch.where(is_arr[:, 0], (new_bcn > 0) | any_ap,
                                    frame[:, 0])
    became_hol = is_arr & ~frame & frame_after
    medium_idle = next_t >= s["busy_until"] + aifs
    imm_grant = became_hol & medium_idle[:, None]
    drawn = (u_back * (s["cw"] + 1).to(torch.float32)).to(i32)
    new_backoff = torch.where(became_hol & ~imm_grant, drawn, s["backoff"])
    new_immediate = torch.where(became_hol, imm_grant, s["immediate"])

    # ---------- transmission processing
    winners = transmit[:, None] & (tx_t == next_t[:, None]) & frame
    any_win = winners.any(1)
    elapsed = torch.clamp_min(
        torch.div(next_t - s["busy_until"] - aifs, SLOT,
                  rounding_mode="floor"), 0)
    contending = frame & ~winners & transmit[:, None]
    counting = contending & ~s["immediate"]
    new_backoff = torch.where(
        counting, torch.clamp_min(new_backoff - elapsed[:, None], 0),
        new_backoff)
    interrupted = contending & s["immediate"]
    new_backoff = torch.where(interrupted, drawn, new_backoff)
    new_immediate = new_immediate & ~interrupted

    # the AP's frame: a beacon outranks an echo; the echo goes to the
    # lowest STA with one pending (argmax of ap_pend > 0, 0 if none)
    ap_sends_beacon = winners[:, 0] & (s["bcn_pend"] > 0)
    echo_dst = torch.where(s["ap_pend"] > 0, node, n).amin(1)
    echo_dst = torch.where(echo_dst == n, 0, echo_dst)
    ed_1h = node[None, :] == echo_dst[:, None]

    # PHY at each transmitter's destination: STAs send to the AP, the
    # AP to echo_dst; the power there from every winner, a tree sum
    w = winners.to(torch.float32)
    geom = {}
    if c["mob"] is None:
        rx_w, det_t = c["rx_w"], c["det"]
        at_ap = tree_sum(w * rx_w[:, 0])                      # (R,)
        at_ed = tree_sum(w * rx_w[:, echo_dst].T)             # (R,)
        sig = torch.where(is_ap, rx_w[0, echo_dst][:, None], rx_w[:, 0])
        det = torch.where(is_ap, det_t[0, echo_dst][:, None], det_t[:, 0])
    else:
        # the replica's own (N, N) tables, rebuilt at its next_t on a
        # refresh step
        if refresh:
            rx_w, det_t = geom_tables(c, next_t)
            geom = dict(geom_rx_w=rx_w, geom_det=det_t, geom_t=next_t)
        else:
            rx_w, det_t = s["geom_rx_w"], s["geom_det"]
        rr = torch.arange(R, device=dev)
        at_ap = tree_sum(w * rx_w[:, :, 0])
        at_ed = tree_sum(w * rx_w[rr, :, echo_dst])
        sig = torch.where(is_ap, rx_w[rr, 0, echo_dst][:, None],
                          rx_w[:, :, 0])
        det = torch.where(is_ap, det_t[rr, 0, echo_dst][:, None],
                          det_t[:, :, 0])
    interf = torch.where(is_ap, at_ed[:, None], at_ap[:, None]) - sig
    sinr = sig / (interf + c["noise_w"])
    dst_idle = ~torch.where(
        is_ap, winners.gather(1, echo_dst[:, None]), winners[:, :1])
    beacon_tx = winners & is_ap & ap_sends_beacon[:, None]
    data_tx = winners & ~beacon_tx
    gate = data_tx & det & dst_idle
    # the coins against the success rate, taken only where a frame is
    # gated (the reference computes the rate everywhere and masks it)
    where = gate.nonzero(as_tuple=True)
    n_ok = torch.zeros(gate.shape, dtype=i32, device=dev)
    if not agg:
        # one MPDU: its coin against the NIST success rate at its SINR
        # (``replicated.py:954-958``)
        k_agg = 1
        dur_k = torch.full_like(s["hold"], c["data_dur"])
        coins = u_coin[where]
        p = mode_chunk_success_rate(sinr[where], c["nbits"], c["mode"])
        n_ok[where] = (coins < p).to(i32)
    else:
        # an A-MPDU of the winner's backlog, up to K: a STA's queue, the
        # AP's echoes pending for its destination (``replicated.py:
        # 919-951``); its airtime and nbits grow with k
        k_ap = s["ap_pend"].gather(1, echo_dst[:, None]).clamp_max(c["K"])
        k_agg = torch.clamp_min(torch.where(
            is_ap, k_ap, s["queue"].clamp_max(c["K"])), 1)
        dur_k, nbits_k = ampdu_airtime(k_agg, c["subframe_bytes"],
                                       c["mode"])
        coins = u_coin(*where)
        n_ok[where], p = decode_mpdus(c, sinr[where], k_agg[where],
                                      nbits_k[where], coins)
    if census is not None:
        _tally(census, "gated", gate)
        _tally(census, "overlap", gate & (interf != 0.0))
        _tally(census, "three_winners", winners.sum(1) >= 3)
        _tally(census, "winners", winners)
        _tally(census, "ed_links", winners.sum(1) * data_tx[:, 0])
        if gap_ids is not None:
            for name, mid in TRAFFIC_MODEL_IDS.items():
                _tally(census, f"gaps_{name}", gap_ids == mid)
        if agg:
            k_g = k_agg[where]
            _tally(census, "mpdus", k_g)
            _tally(census, "partial", (n_ok[where] > 0) & (n_ok[where] < k_g))
            used = (torch.arange(c["K"], device=dev)[None, :]
                    < k_g[:, None])
            _tally(census, "coin_ties", (_ulp_gap(coins, p[:, None]) <= 4)
                   & used)
        else:
            _tally(census, "mpdus", gate)
            _tally(census, "coin_ties", _ulp_gap(coins, p) <= 4)
    success = data_tx & (n_ok > 0)
    fail = data_tx & (n_ok == 0)

    # ---------- outcome updates (counts: an A-MPDU delivers n_ok MPDUs)
    sta_ok = torch.where(is_ap, 0, n_ok)
    got_echo = n_ok[:, 0]
    ed_i = ed_1h.to(i32)
    new_srv = s["srv_rx"] + sta_ok.sum(1, dtype=i32)
    new_cli = s["cli_rx"] + ed_i * got_echo[:, None]
    new_queue = new_queue - sta_ok
    new_ap_pend = s["ap_pend"] + sta_ok - ed_i * got_echo[:, None]
    new_bcn = new_bcn - ap_sends_beacon.to(i32)

    # the node's retry counter: at the limit the whole head A-MPDU drops
    retry_exceeded = fail & (s["retries"] + 1 > RETRY_LIMIT)
    drop_n = retry_exceeded.to(i32) * k_agg
    new_drops = s["drops"] + drop_n.sum(1, dtype=i32)
    new_queue = new_queue - drop_n * (~is_ap).to(i32)
    new_ap_pend = new_ap_pend - ed_i * drop_n[:, :1]
    reset = success | retry_exceeded | beacon_tx
    new_retries = torch.where(reset, 0, s["retries"] + fail.to(i32))
    new_cw = torch.where(
        reset, CW_MIN,
        torch.where(fail, torch.clamp_max(2 * (s["cw"] + 1) - 1, CW_MAX),
                    s["cw"]))
    drawn_post = (u_back * (new_cw + 1).to(torch.float32)).to(i32)
    new_backoff = torch.where(winners, drawn_post, new_backoff)
    new_immediate = new_immediate & ~winners

    # medium occupancy: the acked (BlockAck'd) exchange, the bare data
    # airtime on a failure, the beacon's airtime; a failed sender waits
    # its response timeout
    exch = dur_k + SIFS + c["resp_dur"]
    occ = torch.where(success, exch,
                      torch.where(beacon_tx, c["exch_beacon"], dur_k))
    new_busy = torch.where(
        any_win, next_t + torch.where(winners, occ, 0).amax(1),
        s["busy_until"])
    new_hold = torch.where(
        fail, next_t[:, None] + (exch + SLOT + 4),
        torch.where(winners, next_t[:, None] + occ, s["hold"]))
    out = {k: s[k] for k in ("geom_rx_w", "geom_det", "geom_t") if k in s}
    out.update(geom)
    return dict(
        out,
        t=torch.maximum(next_t, s["t"]),
        next_arr=new_next_arr,
        queue=torch.clamp_min(new_queue, 0),
        ap_pend=torch.clamp_min(new_ap_pend, 0),
        bcn_pend=torch.clamp_min(new_bcn, 0),
        backoff=new_backoff,
        hold=new_hold,
        immediate=new_immediate,
        cw=new_cw.to(i32),
        retries=new_retries.to(i32),
        busy_until=new_busy,
        srv_rx=new_srv,
        cli_rx=new_cli,
        tx_data=s["tx_data"] + data_tx.sum(1, dtype=i32),
        drops=new_drops,
    )


def build_bss_step(prog: BssProgram, replicas: int, device=None):
    """``(consts, init_state, has_frame, tx_times, step_fn, pending)``
    (``replicated.py:556-1103``), bound to the program: ``init_state()``,
    ``has_frame(s)``, ``tx_times(s)``, ``step_fn(s, u_back, u_coin,
    step=0, key=None)`` on one step's ``(R, N)`` draws (a mobile program
    refreshes its geometry when ``step`` is a multiple of its stride; a
    traffic program draws its gaps under the run's ``key``), and
    ``pending(s)``, on ``device`` (the card by default)."""
    consts = build_bss_consts(prog, device)
    end = consts["sim_end"]

    def one_step(s, u_back, u_coin, step=0, key=None):
        mob, tr = consts["mob"], None
        if consts["tr"] is not None:
            tr = dict(point=torch.zeros(replicas, dtype=torch.long,
                                        device=u_back.device),
                      keys=traffic_keys(key, replicas))
        return step_fn(consts, s, u_back, u_coin, end,
                       refresh=mob is not None and step % mob["stride"] == 0,
                       tr=tr)

    return (
        consts,
        lambda: with_tables(consts, init_state(consts, replicas)),
        has_frame,
        lambda s: tx_times(consts, s),
        one_step,
        lambda s: pending(consts, s, end),
    )


# --------------------------------------------------------------------------
# the event loop: the kernel's plain version and the wrapper
# --------------------------------------------------------------------------


def _rows(state: dict, idx) -> dict:
    return state if idx is None else {k: v[idx] for k, v in state.items()}


def bss_advance_math(consts: dict, state: dict, key: torch.Tensor,
                     step0, step1: int, sim_end=None,
                     census: dict | None = None):
    """The event loop in plain PyTorch (any device) over a grid of C
    horizons: ``state`` is ``(C, R, ...)``, ``step0`` a list of C step
    counters and ``sim_end`` a list of C horizons (None: the program's
    own, C = 1; a single run is the grid's C = 1).  Each point is its
    own loop, as the reference runs one and vmaps it over a sweep
    (``replicated.py:1150-1159``, ``:1403-1422``): it steps while its
    counter is below ``step1`` and any of its replicas is pending, so a
    point stops on its own condition and its state stays as it stopped;
    the points still running at a step run it together, and replica
    ``r`` of every point draws the single run's streams (backoff draws
    made for a block of steps at a time).  Returns ``(state, steps,
    pending)``: the ``(C, R, ...)`` state, the list of C counters after
    the loop and the ``(C, R)`` pending flags of the last state.
    ``census`` is :func:`step_fn`'s.

    A mobile program's tables are rebuilt from ``geom_t`` at the start
    and carried through the loop (not returned); a traffic program's
    replica keys are :func:`traffic_keys`, and under a workload sweep
    (``c["tr"]`` of C points) point ``c`` takes its own operands."""
    ends = [int(v) for v in (sim_end if sim_end is not None
                             else [consts["sim_end"]])]
    C = len(ends)
    flat = {k: v.flatten(0, 1) for k, v in state.items()}
    rows, n = flat["queue"].shape
    R = rows // C
    dev = flat["queue"].device
    steps = [int(v) for v in step0]
    end = torch.tensor(ends, dtype=torch.int32,
                       device=dev).repeat_interleave(R)
    K = consts["K"]
    mob, tr = consts["mob"], consts["tr"]
    flat = with_tables(consts, flat)
    if tr is not None:
        keys = traffic_keys(key, R)
        multi = tr["ops"]["tr_id"].shape[0] > 1      # a workload sweep
        point = (torch.arange(C, device=dev).repeat_interleave(R) if multi
                 else torch.zeros(rows, dtype=torch.long, device=dev))
    block = max(1, DRAW_CHUNK_ELEMS // (R * n))
    draws, b0 = None, 0
    still = pending(consts, flat, end).view(C, R)
    while True:
        live = still.any(1).tolist()
        act = [c for c in range(C) if live[c] and steps[c] < step1]
        if not act:
            break
        step = min(steps[c] for c in act)
        group = [c for c in act if steps[c] == step]
        if draws is None or step >= b0 + len(draws[0]):
            b0 = step
            draws = bss_draws(key, step, min(step + block, step1), R, n,
                              coin_keys=K > 1)
        idx = None if len(group) == C else torch.cat([
            torch.arange(c * R, (c + 1) * R, device=dev) for c in group])
        reps = len(group)
        u_back = draws[0][step - b0].repeat(reps, 1)
        coin = draws[1][step - b0].repeat(reps, 1)   # A-MPDU: coin keys
        u_coin = coin if K == 1 else (
            lambda r, i, k=coin: mpdu_coins(k[r], i, K))
        tr_rows = None
        if tr is not None:
            tr_rows = dict(point=point if idx is None else point[idx],
                           keys=keys.repeat(reps, 1))
        new = step_fn(consts, _rows(flat, idx), u_back, u_coin,
                      end if idx is None else end[idx], census,
                      refresh=mob is not None and step % mob["stride"] == 0,
                      tr=tr_rows)
        if idx is None:
            flat = new
        else:
            flat = {k: v.index_copy(0, idx, new[k]) for k, v in flat.items()}
        for c in group:
            steps[c] += 1
        still = pending(consts, flat, end).view(C, R)
    return ({k: flat[k].unflatten(0, (C, R)) for k, _, _ in BSS_STATE},
            steps, still)


def bss_advance(consts: dict, state: dict, key: torch.Tensor, step0,
                step1: int, sim_end=None):
    """Steps ``[step0, step1)`` of the event loop over a grid of
    horizons, each point ending early when none of its replicas is
    pending: the plain loop for CPU tensors, one launch of the
    persistent CUDA kernel for CUDA tensors (or an error).  ``key`` is
    the run's ``(2,)`` int64 key; the state, ``step0``, ``sim_end`` and
    the result as :func:`bss_advance_math` takes and gives them
    (``(C, R, ...)`` state, a counter and a horizon per point)."""
    if key.device.type == "cpu":
        return bss_advance_math(consts, state, key, step0, step1, sim_end)
    if key.device.type == "cuda":
        return bss_advance_cuda(consts, state, key, step0, step1, sim_end)
    raise ValueError(f"no BSS advance for device {key.device}")


def build_bss_advance(prog: BssProgram, replicas: int, device=None,
                      traffic_sweep=None, static: dict | None = None):
    """``(consts, init_state, advance)`` with ``init_state(points=1)``
    the ``(C, R, ...)`` initial state of C points and ``advance(state,
    key, step0, step1, sim_end=None) -> (state, steps, pending)``
    (``replicated.py:1127-1191``, :func:`bss_advance`), on ``device``
    (the card by default).  With ``traffic_sweep`` (C programs of one
    shape key) point ``c`` runs the ``c``-th workload; ``static`` as
    :func:`build_bss_consts` takes it."""
    consts = build_bss_consts(prog, device, traffic_sweep, static)

    def init(points: int = 1):
        return {k: v.expand(points, *v.shape).clone()
                for k, v in init_state(consts, replicas).items()}

    def advance(state, key, step0, step1, sim_end=None):
        return bss_advance(consts, state, key, step0, step1, sim_end)

    return consts, init, advance




def _bss_unpack(state: dict, steps: list, still, stride: int | None = None,
                replicas: int | None = None) -> list:
    """The result dicts (``replicated.py:1237-1267``), as numpy, one per
    point of the ``(C, R, ...)`` state (tensors or host arrays), its C
    step counts and its ``(C, R)`` pending flags; with ``replicas`` the
    padded replicas sliced off (``steps`` counts theirs too, as the
    reference's does).  A mobile program's (``stride`` given) add
    ``geom_refreshes``, ``ceil(steps / stride)``, and ``geom_stride``."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    R = slice(None) if replicas is None else slice(0, int(replicas))
    done = ~host(still)[:, R].any(-1)
    out = []
    for c in range(len(steps)):
        res = dict({k: host(state[k])[c, R]
                    for k in ("srv_rx", "cli_rx", "tx_data", "drops")},
                   steps=int(steps[c]), all_done=bool(done[c]))
        if stride is not None:
            res.update(geom_refreshes=-(-int(steps[c]) // stride),
                       geom_stride=stride)
        out.append(res)
    return out


def bss_study(prog: BssProgram, key, replicas, mesh=None, device=None):
    """Serving-layer study descriptor (``replicated.py:1270``): the
    horizon is the sweep operand, so two BSS studies coalesce onto one
    ``(C, R)`` grid whenever their static fields, key, replica count,
    mesh and device match (the mobility and workload parameters and the
    stride too: only ``sim_end_us`` may differ)."""
    from tpudes_torch.serving.descriptor import (
        StudyDescriptor,
        mesh_fingerprint,
    )

    dev = resolve_device(device)
    ck = (
        _prog_cache_key(prog), np.asarray(key, np.int64).tobytes(),
        int(replicas), mesh_fingerprint(mesh),
        None if prog.mobility is None else prog.mobility.param_key(),
        int(prog.geom_stride),
        None if prog.traffic is None else prog.traffic.param_key(),
        str(dev),
    )

    def launch(points, block=False):
        if len(points) == 1:
            return run_replicated_bss(
                dataclasses.replace(prog, sim_end_us=int(points[0])),
                replicas, key, mesh=mesh, block=block, device=dev)
        return run_replicated_bss(prog, replicas, key, mesh=mesh,
                                  sim_end_us=[int(v) for v in points],
                                  block=block, device=dev)

    def warm(n_points):
        # a 1 ms horizon builds the kernel and fills the runner cache
        tiny = dataclasses.replace(prog, sim_end_us=1000)
        run_replicated_bss(tiny, replicas, key, mesh=mesh, device=dev,
                           sim_end_us=None if n_points == 1
                           else [tiny.sim_end_us] * n_points)

    return StudyDescriptor("bss", ck, int(prog.sim_end_us), launch, warm)


def run_replicated_bss(
    prog: BssProgram,
    replicas: int,
    key,
    max_steps: int | None = None,
    mesh=None,
    *,
    sim_end_us=None,
    traffic_sweep=None,
    chunk_steps: int | None = None,
    checkpoint=None,
    block: bool = True,
    geom_per_step: bool = False,
    obs: bool = False,
    device=None,
):
    """Run ``replicas`` Monte-Carlo replicas of the scenario
    (``replicated.py:1326-1535``).

    ``key`` is a ``(2,)`` threefry key (:func:`tpudes_torch.random.
    PRNGKey` or a JAX key's words).  Returns per-replica numpy arrays:
    ``srv_rx`` (R,) echo requests decoded at the AP, ``cli_rx`` (R, N)
    echo replies decoded per STA, ``tx_data`` (R,) data-frame
    attempts (exchanges, an A-MPDU counting once), ``drops`` (R,) frames
    dropped at the retry limit (MPDUs); and ``steps`` (event-loop
    iterations, over the replica axis padded to its power-of-two bucket
    as the reference's) and ``all_done`` (no replica has an event left
    before the horizon).

    ``sim_end_us=[...]`` runs a horizon sweep: C horizons as one
    ``(C, R)`` grid per launch, and a list of C such dicts, point ``c``
    equal to the run of ``dataclasses.replace(prog, sim_end_us=v)``
    with the same key and ``max_steps`` (each point its own loop, its
    own ``steps``; the reference's vmapped ``while_loop``).  The step
    budget is shared: the largest of the points' estimates.  On the card
    one launch holds up to 64 horizons (``bss_cuda.BSS_MAX_POINTS``).

    ``traffic_sweep=[...]`` (traffic programs of one shape key, with
    ``prog.traffic`` naming the shape) runs a workload sweep instead: C
    workloads as one ``(C, R)`` grid per launch, point ``c`` equal to
    the run of ``dataclasses.replace(prog, traffic=tp)``, the budget the
    largest of the points' estimates.  One config axis per run: both
    at once raise ``ValueError``.

    A mobile program's results add ``geom_refreshes`` and
    ``geom_stride``; ``geom_per_step=True`` rebuilds its geometry every
    step (the reference's unconditional recompute; ``geom_refreshes``
    still counts by ``geom_stride``, as the reference reports it).

    ``max_steps`` defaults to the reference's estimate;
    ``chunk_steps=K`` runs the loop K steps per launch, the same result;
    ``checkpoint=`` (a path or a :class:`~tpudes_torch.parallel.
    checkpoint.CarryCheckpoint`) saves the carry after each chunk and
    resumes a matching run from its last completed chunk, bit-equal.
    ``block=False`` returns an :class:`~tpudes_torch.parallel.runtime.
    EngineFuture`.  ``device`` defaults to the card, where each chunk is
    one launch of the persistent kernel."""
    if mesh is not None:
        raise _not_ported("mesh", "A12")
    if obs:
        raise _not_ported("TpudesObs", "A10")
    if sim_end_us is not None and traffic_sweep is not None:
        raise ValueError(
            "one config axis per launch: sweep either the horizon "
            "(sim_end_us=[...]) or the workload (traffic_sweep=[...])")
    ends = ([int(prog.sim_end_us)] if sim_end_us is None
            else [int(v) for v in sim_end_us])
    if not ends:
        raise ValueError("sim_end_us=[...] needs at least one horizon")
    sweep_progs = [prog]
    if traffic_sweep is not None:
        traffic_sweep = list(traffic_sweep)
        if not traffic_sweep or prog.traffic is None or any(
                tp.shape_key() != prog.traffic.shape_key()
                for tp in traffic_sweep):
            raise ValueError(
                "a workload sweep needs prog.traffic set and every point "
                "sharing its traffic shape key (pad tables to a common "
                "capacity)")
        sweep_progs = [dataclasses.replace(prog, traffic=tp)
                       for tp in traffic_sweep]
        ends = ends * len(traffic_sweep)
    from tpudes_torch.parallel.checkpoint import checkpoint_ctx

    dev = resolve_device(device)
    r_pad = bucket_replicas(replicas)
    n_cfg = len(ends) if sim_end_us is not None or traffic_sweep else None
    sweep = "traffic" if traffic_sweep is not None else "horizon"
    run_prog = (dataclasses.replace(prog, geom_stride=1) if geom_per_step
                else prog)
    static, _ = RUNTIME.runner(
        "bss",
        (_prog_cache_key(prog), r_pad, False, n_cfg,
         prog.mobility is not None, geom_per_step,
         sweep if n_cfg is not None else None, str(dev)),
        lambda: bss_static_consts(prog, dev),
    )
    _, init, advance = build_bss_advance(run_prog, r_pad, dev,
                                         traffic_sweep, static)
    key = to_device(key if isinstance(key, torch.Tensor)
                    else np.asarray(key, np.int64), dev, torch.int64)
    if max_steps is None:
        max_steps = max(
            _estimate_max_steps(dataclasses.replace(p, sim_end_us=v))
            for v in set(ends) for p in sweep_progs)

    def launch(c, bound):
        state, steps, still = advance(c["state"], key, c["steps"], bound,
                                      ends)
        return dict(state=state, steps=steps, pending=still)

    ckpt = checkpoint_ctx(
        checkpoint, engine="bss", key=key, replicas=replicas, r_pad=r_pad,
        n_cfg=n_cfg, obs=False, axis=1, device=dev,
        extra=_prog_cache_key(prog) + (
            tuple(ends), geom_per_step, int(prog.geom_stride),
            None if prog.mobility is None else prog.mobility.param_key(),
            None if prog.traffic is None else prog.traffic.param_key(),
            None if traffic_sweep is None
            else tuple(tp.param_key() for tp in traffic_sweep)),
    )
    carry, flush = drive_chunks(
        "bss", chunk_bounds(max_steps, chunk_steps or max_steps),
        dict(state=init(len(ends)), steps=[0] * len(ends), pending=None),
        launch, checkpoint=ckpt)
    fetch = dict(state={k: carry["state"][k]
                        for k in ("srv_rx", "cli_rx", "tx_data", "drops")},
                 steps=list(carry["steps"]), pending=carry["pending"])
    stride = None if prog.mobility is None else max(1, int(prog.geom_stride))

    def finalize(host):
        out = _bss_unpack(host["state"], host["steps"], host["pending"],
                          stride, replicas)
        return out if n_cfg is not None else out[0]

    fut = EngineFuture("bss", fetch, finalize_with_flush(flush, finalize))
    return fut.result() if block else fut
