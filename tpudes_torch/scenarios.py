"""The lena macro-cell grid (BASELINE config #4) and the WiFi BSS
(BASELINE config #3) as port programs.

Counterpart of ``tpudes/scenarios.py``'s ``hex_grid`` and ``build_lena``
followed by ``lower_lte_sm``, for a static or a mobile full-buffer drop,
without the host simulator: sites and UEs are plain arrays and the
lowering is the array math the reference controller runs
(``tpudes/models/lte/controller.py:266-287``).

Defaults are copies of the reference's: eNB TxPower 30 dBm
(``models/lte/phy.py:75``), UE NoiseFigure 9 dB (``phy.py:101``), 25 RBs
and Friis at 2.12 GHz (``models/lte/helper.py:33-36``), PF alpha 0.05.
The upstream drop draws from MRG32k3a; this one draws from a seeded
``torch.Generator``, so the two drops differ (the tests feed the
reference's own positions to :func:`lena_grid_program`).
:func:`lena_traffic_program` gives the static drop finite backlogs under
the ON-OFF workload of the reference's LTE traffic test.

:func:`bss_program` lowers the static BSS of ``tpudes/scenarios.py::
build_bss``, 802.11a or 802.11n, as ``replicated.py::lower_bss`` does,
from the reference's own arguments and defaults, without building the
object graph.

:func:`dumbbell_program` lowers the TCP dumbbell of ``tpudes/
scenarios.py::build_dumbbell`` (BASELINE config #2) as ``tcp_dumbbell.py
::lower_dumbbell`` does, a RED root qdisc on the bottleneck included.

:func:`as_program` lowers the BRITE AS network of ``tpudes/scenarios.py::
build_as_network`` (BASELINE config #5) as ``as_flows.py::lower_as_flows``
does, from arrays.
"""

from __future__ import annotations

import dataclasses
import math
import re
import warnings

import numpy as np
import torch

from tpudes_torch.core.rng import RngStream
from tpudes_torch.helper.topology import BriteTopologyHelper
from tpudes_torch.ops.lte import noise_psd_w
from tpudes_torch.ops.mobility import (
    MobilityProgram,
    max_speed_mps,
    trajectory_positions,
    warn_geom_stride,
)
from tpudes_torch.ops.propagation import friis
from tpudes_torch.ops.wifi_error import MODES_BY_NAME
from tpudes_torch.parallel.as_flows import AsFlowsProgram
from tpudes_torch.parallel.lte_sm import LteSmProgram
from tpudes_torch.parallel.tcp_dumbbell import (
    INT32_MAX,
    REQUIRES_ECN,
    VARIANTS,
    DumbbellProgram,
)
from tpudes_torch.parallel.replicated import (
    DIFS,
    INF,
    MODELED_WARMUP_S,
    SIFS,
    SLOT,
    BssProgram,
    _bss_nominal_step_s,
    _pairwise_rx_dbm,
    _walk_worst_case_ok,
)
from tpudes_torch.traffic.program import TrafficProgram

ENB_HEIGHT_M = 30.0
UE_HEIGHT_M = 1.5

#: the ON-OFF workload of the reference's LTE traffic test
#: (``tests/test_traffic_engines.py:148-155``): arrivals per second while
#: ON, bounded-Pareto ON periods (shape, shortest s, longest s), the mean
#: of the exponential OFF periods, bounded-Pareto packet sizes (shape,
#: smallest B, largest B) and the seed of the cycle tables
ONOFF_PEAK_PPS = 50.0
ONOFF_ON = (1.5, 0.01, 0.05)
ONOFF_OFF_MEAN_S = 0.02
ONOFF_SIZE_PARETO = (1.4, 800.0, 12000.0)
ONOFF_TR_SEED = 2

#: on-air bytes the BSS data frame adds to the UDP payload: UDP 8, IPv4
#: 20, LLC/SNAP 8, the MAC header 24 and the FCS 4
#: (``tpudes/parallel/replicated.py:357-358``, ``models/wifi/mac.py:46-47``)
BSS_FRAME_OVERHEAD = 8 + 20 + 8 + 24 + 4
#: a beacon's on-air bytes, 50 + header + FCS (``replicated.py:378``)
BSS_BEACON_BYTES = 50 + 24 + 4
#: the AP's beacon period (``models/wifi/mac.py:48``)
BSS_BEACON_INTERVAL_US = 102400
#: the control answer rates, ascending (``models/wifi/mac.py:51-60``)
BSS_MANDATORY_RATES = ("OfdmRate6Mbps", "OfdmRate12Mbps", "OfdmRate24Mbps")
#: an A-MPDU's subframe cap, the BlockAck window (``models/wifi/mac.py:80``)
MAX_AMPDU_FRAMES = 64
#: the A-MPDU size an HT MAC defaults to (``models/wifi/helper.py:178``)
HT_MAX_AMPDU_SIZE = 65535
#: the MPDU delimiter and FCS bytes of a subframe (``models/wifi/mac.py:79``,
#: ``:46``)
MPDU_DELIMITER_SIZE, FCS_SIZE = 4, 4
#: the STA motions ``bss_program`` lowers (``tpudes/scenarios.py:44-47``)
BSS_MOBILITY = ("static", "const_velocity", "random_walk")
#: the standards ``bss_program`` lowers: 802.11a (DCF, single MPDUs) and
#: 802.11n, whose MACs default to QoS and A-MPDUs under a BlockAck
#: session (``models/wifi/helper.py:129``, ``:171-178``)
BSS_STANDARDS = ("80211a", "80211n")


def ampdu_subframe_bytes(mpdu_size: int) -> int:
    """On-air bytes of one A-MPDU subframe: the delimiter, the MPDU and
    its FCS, padded to 4 bytes (``models/wifi/mac.py:83-87``)."""
    return (MPDU_DELIMITER_SIZE + mpdu_size + FCS_SIZE + 3) & ~3


def hex_grid(n: int, spacing: float) -> list[tuple[float, float]]:
    """First n positions of a hexagonal ring layout (cell 0 centred)."""
    pos = [(0.0, 0.0)]
    ring = 1
    while len(pos) < n:
        for k in range(6 * ring):
            a = 2 * math.pi * k / (6 * ring)
            pos.append(
                (ring * spacing * math.cos(a), ring * spacing * math.sin(a))
            )
            if len(pos) >= n:
                break
        ring += 1
    return pos[:n]


def lena_ue_drop(
    n_enbs: int,
    ues_per_cell: int,
    inter_site: float = 500.0,
    radius_factor: float = 0.45,
    generator: torch.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """``(enb_pos (E, 3), ue_pos (E * ues_per_cell, 3))`` float64: hex
    sites at 30 m, UEs uniform in a disc of ``inter_site *
    radius_factor`` around their site at 1.5 m, cell by cell."""
    sites = np.asarray(hex_grid(n_enbs, inter_site), dtype=np.float64)
    enb_pos = np.column_stack([sites, np.full(n_enbs, ENB_HEIGHT_M)])
    u = torch.rand(
        (n_enbs, ues_per_cell, 2), generator=generator, dtype=torch.float64
    ).numpy()
    r = inter_site * radius_factor * np.sqrt(u[..., 0])
    a = 2 * math.pi * u[..., 1]
    ue_xy = sites[:, None, :] + np.stack(
        [r * np.cos(a), r * np.sin(a)], axis=-1
    )
    ue_pos = np.column_stack(
        [ue_xy.reshape(-1, 2), np.full(n_enbs * ues_per_cell, UE_HEIGHT_M)]
    )
    return enb_pos, ue_pos


def lena_grid_program(
    enb_pos,
    ue_pos,
    n_ttis: int,
    scheduler: str = "pf",
    *,
    n_rb: int = 25,
    tx_power_dbm: float = 30.0,
    noise_figure_db: float = 9.0,
    frequency_hz: float = 2.12e9,
    pf_alpha: float = 0.05,
) -> LteSmProgram:
    """Lower a static full-buffer drop to an :class:`LteSmProgram`.

    Attach is to the closest eNB, lowest index on ties
    (``helper.py:124-135``).  The gain follows the controller: float64
    distances, the Friis loss in f32, then ``10 ** (-loss / 10)`` in
    float64."""
    enb_pos = np.asarray(enb_pos, dtype=np.float64)
    ue_pos = np.asarray(ue_pos, dtype=np.float64)
    d2 = ((ue_pos[:, None, :] - enb_pos[None, :, :]) ** 2).sum(-1)  # (U, E)
    serving = np.argmin(d2, axis=1).astype(np.int32)
    d = np.sqrt(((enb_pos[:, None, :] - ue_pos[None, :, :]) ** 2).sum(-1))
    rx_dbm = friis(
        torch.zeros((), dtype=torch.float32),
        torch.from_numpy(d).to(torch.float32),
        frequency_hz,
    )
    loss_db = -rx_dbm.numpy().astype(np.float64)
    return LteSmProgram(
        gain=10.0 ** (-loss_db / 10.0),
        serving=serving,
        tx_power_dbm=np.full(len(enb_pos), float(tx_power_dbm)),
        noise_psd=noise_psd_w(noise_figure_db),
        n_rb=int(n_rb),
        n_ttis=int(n_ttis),
        scheduler=scheduler,
        pf_alpha=float(pf_alpha),
    )


def lena_mobile_program(
    n_enbs: int,
    ues_per_cell: int,
    n_ttis: int,
    mobility: str = "const_velocity",
    speed: float = 10.0,
    geom_stride: int = 8,
    scheduler: str = "pf",
    *,
    inter_site: float = 500.0,
    radius_factor: float = 0.45,
    frequency_hz: float = 2.12e9,
    generator: torch.Generator | None = None,
) -> LteSmProgram:
    """A moving lena drop (``build_lena(..., mobility=, speed=)`` +
    ``lower_lte_sm(..., geom_stride=)``): :func:`lena_ue_drop`, the t = 0
    lowering of :func:`lena_grid_program` (attach and cell structure),
    Friis at ``frequency_hz`` for the geometry stage, and the UEs moving
    as ``mobility`` says:

    - ``"const_velocity"``: ``speed`` m/s along a heading ``h`` drawn
      per UE from the same generator after the drop,
      ``v = speed (cos h, sin h, 0)``;
    - ``"random_walk"``: speed band ``[speed / 2, speed]``, 1 s segments,
      inside the sites' bounding box padded by the drop radius + 50 m
      (``tpudes/scenarios.py:390-402``)."""
    enb_pos, ue_pos = lena_ue_drop(
        n_enbs, ues_per_cell, inter_site, radius_factor, generator
    )
    prog = lena_grid_program(enb_pos, ue_pos, n_ttis, scheduler,
                             frequency_hz=frequency_hz)
    base = ue_pos.astype(np.float32)
    if mobility == "const_velocity":
        h = 2.0 * math.pi * torch.rand(
            len(ue_pos), generator=generator, dtype=torch.float64
        ).numpy()
        vel = np.stack([speed * np.cos(h), speed * np.sin(h),
                        np.zeros_like(h)], axis=-1)
        mob = MobilityProgram.constant_velocity(base, vel)
    elif mobility == "random_walk":
        pad = inter_site * radius_factor + 50.0
        xs, ys = enb_pos[:, 0], enb_pos[:, 1]
        mob = MobilityProgram.random_walk(
            base, (xs.min() - pad, xs.max() + pad, ys.min() - pad,
                   ys.max() + pad),
            np.tile([speed / 2.0, speed], (len(base), 1)),
            horizon_us=n_ttis * 1000,
        )
    else:
        raise ValueError(f"unknown mobility {mobility!r}")
    warn_geom_stride("lena_mobile_program", mob, geom_stride, 1e-3)
    return dataclasses.replace(
        prog, mobility=mob, geom_stride=int(geom_stride),
        enb_pos=enb_pos.astype(np.float32),
        pathloss=("friis", float(frequency_hz), 1.0, 0.0),
    )


def lena_traffic_program(
    n_enbs: int,
    ues_per_cell: int,
    n_ttis: int,
    scheduler: str = "pf",
    *,
    precision: str = "f32",
    generator: torch.Generator | None = None,
) -> LteSmProgram:
    """The static drop of :func:`lena_ue_drop` + :func:`lena_grid_program`
    with one ON-OFF source per UE, the workload of the reference's LTE
    traffic test over the whole horizon: :data:`ONOFF_PEAK_PPS` arrivals
    per second while ON, bounded-Pareto ON periods ``(1.5, 10 ms, 50
    ms)``, exponential OFF periods of mean 20 ms, packet sizes
    bounded-Pareto ``(1.4, 800 B, 12000 B)``.  A UE offers about 24
    packets of about 1.9 kB a second, 10.8 Mbit/s per cell of 30 UEs: on
    the seven-cell reuse-1 drop several times what the cells deliver, so
    the eligibility gate bites while backlogs are young and most hold
    bits by the end of a 10-second run."""
    prog = lena_grid_program(
        *lena_ue_drop(n_enbs, ues_per_cell, generator=generator), n_ttis,
        scheduler,
    )
    tp = TrafficProgram.onoff(
        prog.n_ue, ONOFF_PEAK_PPS, horizon_us=n_ttis * 1000, on=ONOFF_ON,
        off_mean_s=ONOFF_OFF_MEAN_S, tr_seed=ONOFF_TR_SEED,
    )
    tp = dataclasses.replace(
        tp, size_pareto=np.asarray(ONOFF_SIZE_PARETO, np.float32)
    )
    return dataclasses.replace(prog, traffic=tp, precision=precision)


def _us(seconds: float) -> int:
    """A time the reference's scenario sets in seconds, in whole µs as
    its lowering reads it: ns ticks ``round(s * 1e9)``
    (``core/nstime.py:94-95``), then ``// 1000``."""
    return int(round(seconds * 1e9)) // 1000


def bss_program(
    n_stas: int,
    sim_s: float,
    radii: tuple = (10.0, 22.0, 34.0),
    interval_s: float = 0.1,
    packet_bytes: int = 512,
    data_mode: str = "OfdmRate54Mbps",
    standard: str = "80211a",
    mobility: str = "static",
    speed: float = 1.0,
    geom_stride: int = 1,
) -> BssProgram:
    """The BSS of ``build_bss(n_stas, sim_s, radii, interval_s,
    packet_bytes, data_mode, standard, mobility, speed)``
    (``tpudes/scenarios.py:35-174``) lowered as ``lower_bss(...,
    geom_stride)`` lowers it (``replicated.py:222-464``):

    - the AP at the origin, STA ``i`` on the circle ``radii[i % len]``
      at angle ``2 pi i / n_stas``, positions in f32 of the f64 formula;
    - data at ``data_mode`` (an OFDM or HT mode), the ack at the control
      answer rate (the fastest mandatory rate not above it), beacons at
      6 Mbit/s; under 802.11a DIFS contention and one MPDU per exchange,
      under 802.11n QoS AC_BE contention (AIFS = SIFS + 3 slots) and
      A-MPDUs of up to ``min(64, 65535 // subframe)`` subframes answered
      by a BlockAck (``replicated.py:359-369``, ``:402-404``);
    - UDP echo of ``packet_bytes`` from each STA every ``interval_s``,
      starting at ``1 s + 1 ms * i`` and stopping at ``sim_s``; AP
      beacons every 102,400 µs from 0, never stopping;
    - the PHY defaults (16.0206 dBm, log-distance exponent 3 from 46.6777
      dB at 1 m, 7 dB noise figure, 20 MHz, -101 dBm sensitivity);
    - ``mobility`` moves the STAs, the AP staying at the origin:
      ``"static"`` (no motion program), ``"const_velocity"`` (tangential
      drift at ``speed`` m/s) or ``"random_walk"`` (1 s segments at
      ``[speed / 2, speed]`` m/s in the box ``+-(max(radii) + 5)`` m, walk
      seed 0), its geometry rebuilt every ``geom_stride`` steps.

    Raises ``ValueError`` for a mode outside the OFDM and HT registry
    (the DSSS rates), a standard other than :data:`BSS_STANDARDS`, an
    unknown ``mobility``, and where a pair of nodes cannot hear each
    other, for a mobile program anywhere on its trajectory
    (:func:`check_mutual_sensing`: the engine's one ``busy_until`` per
    replica cannot represent hidden nodes); warns, as the reference
    does, on a horizon within 5x of the skipped warm-up and on a stride
    that lets a node drift past the coherence length."""
    mode = MODES_BY_NAME.get(data_mode)
    if mode is None:
        raise ValueError(
            f"bss_program lowers OFDM and HT modes; {data_mode!r} is neither"
        )
    if standard not in BSS_STANDARDS:
        raise ValueError(
            f"bss_program lowers the standards {BSS_STANDARDS}; got "
            f"{standard!r}"
        )
    if mobility not in BSS_MOBILITY:
        raise ValueError(f"unknown mobility {mobility!r}")
    if sim_s < 5.0 * MODELED_WARMUP_S:        # ``replicated.py:251-261``
        warnings.warn(
            f"sim_end_s={sim_s} s is within ~5x of the association/ARP "
            f"warm-up (~{MODELED_WARMUP_S} s) this lowering skips; "
            "replica-axis outcomes over so short a horizon are dominated "
            "by the unmodeled transient", stacklevel=2)
    pos = [(0.0, 0.0, 0.0)]
    vel = [(0.0, 0.0, 0.0)]
    for i in range(n_stas):
        a = 2 * math.pi * i / n_stas
        r = radii[i % len(radii)]
        pos.append((r * math.cos(a), r * math.sin(a), 0.0))
        vel.append((-speed * math.sin(a), speed * math.cos(a), 0.0))
    sim_end_us = int(sim_s * 1e6)
    motion = None
    if mobility == "const_velocity":
        # device_mobility_program's const-velocity family, its walk
        # segment grid sized to the horizon (``models/mobility.py:819-839``)
        motion = dataclasses.replace(
            MobilityProgram.constant_velocity(pos, vel),
            n_seg=sim_end_us // 1_000_000 + 1)
    elif mobility == "random_walk":
        r_max = max(radii[i % len(radii)] for i in range(max(n_stas, 1)))
        bound = r_max + 5.0
        band = [(0.0, 0.0)] + [(speed / 2.0, speed)] * n_stas
        motion = MobilityProgram.random_walk(
            pos, (-bound, bound, -bound, bound), band, seg_s=1.0,
            horizon_us=sim_end_us, mob_seed=0)
    ack = MODES_BY_NAME["OfdmRate6Mbps"]
    for name in BSS_MANDATORY_RATES:
        if MODES_BY_NAME[name].data_rate_bps <= mode.data_rate_bps:
            ack = MODES_BY_NAME[name]
    max_mpdus, subframe_bytes, aifs = 1, 0, DIFS
    if standard == "80211n":
        subframe_bytes = ampdu_subframe_bytes(
            int(packet_bytes) + BSS_FRAME_OVERHEAD - FCS_SIZE)
        max_mpdus = max(1, min(MAX_AMPDU_FRAMES,
                               HT_MAX_AMPDU_SIZE // subframe_bytes))
        aifs = SIFS + 3 * SLOT
    n = n_stas + 1
    start = np.full((n,), INF, np.int64)
    interval = np.full((n,), INF, np.int64)
    stop = np.full((n,), INF, np.int64)
    start[0], interval[0] = 0, BSS_BEACON_INTERVAL_US
    for i in range(n_stas):
        start[1 + i] = _us(1.0 + 0.001 * i)
        interval[1 + i] = max(1, _us(interval_s))
        stop[1 + i] = _us(sim_s) if _us(sim_s) > 0 else INF
    prog = BssProgram(
        positions=np.asarray(pos, dtype=np.float32),
        data_mode_idx=mode.index,
        ack_mode_idx=ack.index,
        data_bytes=int(packet_bytes) + BSS_FRAME_OVERHEAD,
        beacon_bytes=BSS_BEACON_BYTES,
        start_us=np.minimum(start, INF).astype(np.int32),
        interval_us=np.minimum(interval, INF).astype(np.int32),
        stop_us=np.minimum(stop, INF).astype(np.int32),
        sim_end_us=sim_end_us,
        aifs_us=aifs,
        max_mpdus=max_mpdus,
        subframe_bytes=subframe_bytes,
        mobility=motion,
        geom_stride=int(geom_stride),
    )
    check_mutual_sensing(prog, sim_s)
    return prog


def check_mutual_sensing(prog: BssProgram, sim_s: float) -> None:
    """``lower_bss``'s guard (``replicated.py:406-464``): every pair of
    nodes must hear each other, for a mobile program at every one of
    ``clip(ceil(2 vmax sim_s), 65, 1025)`` times spread over the run
    (and, for a walk, at the worst corner of its box); raises
    ``ValueError`` where not.  A mobile program then gets the stride's
    coherence advisory (``warn_geom_stride``)."""
    hidden = ValueError(
        "topology has node pairs below rx sensitivity (hidden-node "
        "regime) at some point of the run; the single-medium "
        "carrier-sense model cannot represent it"
    )
    mob = prog.mobility
    if mob is None:
        if not bool((_pairwise_rx_dbm(prog) >= prog.rx_sensitivity_dbm
                     ).all()):
            raise hidden
        return
    n_samp = int(np.clip(math.ceil(2.0 * max_speed_mps(mob) * sim_s),
                         65, 1025))
    grid = np.linspace(0, prog.sim_end_us, n_samp).astype(np.int64)
    for pos_t in trajectory_positions(mob, grid):
        moved = dataclasses.replace(prog, positions=pos_t.astype(np.float32))
        if not bool((_pairwise_rx_dbm(moved) >= prog.rx_sensitivity_dbm
                     ).all()):
            raise hidden
    if mob.model == "random_walk" and not _walk_worst_case_ok(prog, mob):
        raise hidden
    warn_geom_stride("bss_program", mob, int(prog.geom_stride),
                     _bss_nominal_step_s(prog))


#: data-rate suffixes, in bit/s (``tpudes/network/data_rate.py:12-25``)
_RATE_SUFFIXES = {
    "bps": 1, "b/s": 1, "kbps": 10**3, "kb/s": 10**3, "kibps": 2**10,
    "mbps": 10**6, "mb/s": 10**6, "mibps": 2**20, "gbps": 10**9,
    "gb/s": 10**9, "gibps": 2**30, "bs": 1,
}
#: time units as powers of ten of a second (``core/nstime.py:19-30``)
_TIME_EXPONENTS = {"s": 0, "ms": -3, "us": -6, "ns": -9}
#: RedQueueDisc's attributes and defaults
#: (``tpudes/models/traffic_control.py:51``, ``:136-164``)
RED_DEFAULTS = dict(MinTh=5.0, MaxTh=15.0, QW=0.002, LInterm=50.0,
                    Gentle=True, UseEcn=False, UseHardDrop=True,
                    MaxSize=1000)
#: the bulk senders' start: ``Seconds(0.1 + 0.01 i)`` for flow ``i``
#: (``tpudes/scenarios.py:238``)
DUMBBELL_START_S, DUMBBELL_START_STEP_S = 0.1, 0.01
#: bytes the IPv4 and TCP headers add to a segment on the wire
TCP_IP_HEADER_BYTES = 40


def _rate_bps(spec) -> int:
    """A data rate (``"10Mbps"`` or a number) in bit/s, as the
    reference's ``DataRate`` parses it."""
    if isinstance(spec, (int, float)):
        return int(spec)
    m = re.match(r"^\s*([0-9.eE+-]+)\s*([a-zA-Z/]*)\s*$", spec)
    if not m or (m.group(2).lower() or "bps") not in _RATE_SUFFIXES:
        raise ValueError(f"cannot parse data rate {spec!r}")
    return int(float(m.group(1)) * _RATE_SUFFIXES[m.group(2).lower() or
                                                  "bps"])


def _time_s(spec) -> float:
    """A time (``"10ms"``, or seconds as a number) in seconds, as the
    reference's ``Time`` holds it: whole ns ticks, read back as
    ``ticks / 1e9`` (``core/nstime.py:94-113``)."""
    if isinstance(spec, (int, float)):
        return int(round(spec * 10**9)) / 10**9
    m = re.match(r"^\s*([+-]?[0-9.eE+-]+?)\s*(s|ms|us|ns)?\s*$", spec)
    if not m:
        raise ValueError(f"cannot parse time {spec!r}")
    shift = _TIME_EXPONENTS[m.group(2) or "s"] + 9
    return int(round(float(m.group(1)) * 10**shift)) / 10**9


def _queue_packets(spec) -> int:
    """A queue size in packets (``"100p"``); byte-mode sizes raise, as
    the slot model counts packets."""
    m = re.match(r"^\s*([0-9]+)\s*(p)?\s*$", str(spec))
    if not m:
        raise ValueError(
            f"the slot model counts queue capacity in packets; got {spec!r}")
    return int(m.group(1))


def dumbbell_program(
    n_flows: int,
    sim_time: float,
    variant: str = "TcpNewReno",
    bottleneck_rate="10Mbps",
    bottleneck_delay="10ms",
    access_rate="100Mbps",
    access_delay="1ms",
    queue="100p",
    seg_bytes: int = 1000,
    variants=None,
    red: dict | None = None,
    use_ecn: bool = False,
    traffic=None,
) -> DumbbellProgram:
    """The dumbbell of ``build_dumbbell(n_flows, sim_time, variant,
    bottleneck_rate, bottleneck_delay, access_rate, access_delay, queue,
    seg_bytes, variants)`` (``tpudes/scenarios.py:177-242``) lowered as
    ``lower_dumbbell(sim_time)`` lowers it (``tcp_dumbbell.py:167-387``):

    - flow ``i`` runs ``variants[i]`` (else ``variant``), starts at
      ``Seconds(0.1 + 0.01 i)`` and stops at the horizon, with no byte
      budget;
    - the slot is one packet's serialization on the bottleneck, ``(seg
      + 40) 8 / rate``; the ack lag is the bottleneck's delay twice and
      the mean access delay four times, in whole slots (``round``); the
      send burst is the access rate over the bottleneck's;
    - ``red`` (RedQueueDisc attributes, :data:`RED_DEFAULTS` for the
      missing ones) puts a RED root qdisc on the bottleneck: its
      ``MaxSize`` is the queue's capacity and ``1 / LInterm`` its
      ``max_p``;
    - a flow is ECN-capable under ``use_ecn`` (the senders' ``UseEcn``)
      or when its variant requires ECN (DCTCP);
    - ``traffic`` (a TrafficProgram of one entity a flow) makes the flows
      app-limited (``DumbbellProgram.traffic``).
    """
    n_flows = int(n_flows)
    names = list(variants) if variants is not None else [variant] * n_flows
    if len(names) != n_flows or any(v not in VARIANTS for v in names):
        raise ValueError(f"want {n_flows} variants of {VARIANTS}; got {names}")
    bn_rate = float(_rate_bps(bottleneck_rate))
    acc_rate = float(_rate_bps(access_rate))
    if acc_rate <= bn_rate:
        raise ValueError(
            "access links must be faster than the bottleneck for the slot "
            "model (queueing would form at the leaves)")
    bn_delay_s = _time_s(bottleneck_delay)
    seg = int(seg_bytes)
    slot_s = (seg + TCP_IP_HEADER_BYTES) * 8 / bn_rate
    # the sender's and the sink's access delay, once per flow each
    acc_d = float(np.mean(np.full(2 * n_flows, _time_s(access_delay))))
    ack_lag_s = 2.0 * bn_delay_s + 4.0 * acc_d
    sim_end_s = float(sim_time)
    stop_s = _time_s(sim_end_s)
    starts = [_time_s(DUMBBELL_START_S + DUMBBELL_START_STEP_S * i)
              for i in range(n_flows)]
    red_kw, qdisc, queue_cap = {}, "fifo", _queue_packets(queue)
    if red is not None:
        unknown = set(red) - set(RED_DEFAULTS)
        if unknown:
            raise ValueError(f"unknown RED attributes {sorted(unknown)}")
        r = dict(RED_DEFAULTS, **red)
        qdisc, queue_cap = "red", int(r["MaxSize"])
        red_kw = dict(
            red_min_th=float(r["MinTh"]), red_max_th=float(r["MaxTh"]),
            red_max_p=1.0 / float(r["LInterm"]), red_qw=float(r["QW"]),
            red_gentle=bool(r["Gentle"]), red_use_ecn=bool(r["UseEcn"]),
            red_use_hard_drop=bool(r["UseHardDrop"]))
    return DumbbellProgram(
        n_flows=n_flows,
        variant_idx=np.asarray([VARIANTS.index(v) for v in names], np.int32),
        start_slot=np.asarray([int(s / slot_s) for s in starts], np.int32),
        stop_slot=np.full(n_flows, int(min(stop_s, sim_end_s) / slot_s),
                          np.int32),
        max_pkts=np.full(n_flows, INT32_MAX, np.int32),
        slot_s=slot_s,
        n_slots=int(math.ceil(sim_end_s / slot_s)),
        ack_lag=max(1, int(round(ack_lag_s / slot_s))),
        queue_cap=queue_cap,
        burst_cap=max(1, int(acc_rate / bn_rate)),
        base_rtt_s=ack_lag_s + slot_s,
        seg_bytes=seg,
        ecn=np.asarray([bool(use_ecn) or v in REQUIRES_ECN for v in names],
                       bool),
        qdisc=qdisc,
        traffic=traffic,
        **red_kw,
    )


def as_program(n_nodes: int, n_flows: int, sim_s: float, model: str = "BA",
               m: int = 2, flow_kbps: float = 400.0, pkt_bytes: int = 512,
               seed: int = 1) -> AsFlowsProgram:
    """BASELINE config #5's program: ``build_as_network(n_nodes, n_flows,
    sim_s, model, m, flow_kbps, pkt_bytes, seed)`` then
    ``lower_as_flows(sim_s)`` (``tpudes/scenarios.py:245-303``,
    ``as_flows.py:115-210``) at the reference's default ``RngSeed`` and
    ``RngRun``, field by field, without the object graph:

    - the BA graph of ``BriteTopologyHelper(model, n_nodes, m,
      seed=seed).Generate()``;
    - each flow's endpoints ``RandInt(0, n - 1)`` on MRG32k3a ``(seed, 0,
      0)``, the destination redrawn while it equals the source; the
      lowering lists the flows by source node, each node's in install
      order;
    - the lowering's edges: nodes ascending, each node's links in install
      order, each link once, so an edge is ``(min, max)`` of its endpoints
      in order of ``(min endpoint, link index)``;
    - each delay the ns-rounded ``int(d 1e9) / 1e9``, each rate
      ``floor(rate)`` (its ``"<int>bps"`` attribute);
    - each flow's rate ``8 pkt / interval``, the interval ``pkt 8 /
      (kbps 1e3)`` rounded to whole ns."""
    g = BriteTopologyHelper(model=model, n=n_nodes, m=m, seed=seed).Generate()
    rng = RngStream(seed, 0, 0)
    src, dst = [], []
    for _ in range(n_flows):
        a = rng.RandInt(0, n_nodes - 1)
        b = rng.RandInt(0, n_nodes - 1)
        while b == a:
            b = rng.RandInt(0, n_nodes - 1)
        src.append(a)
        dst.append(b)
    by_src = np.argsort(np.asarray(src), kind="stable")
    lo = g.edges.min(1)
    order = np.lexsort((np.arange(g.m), lo))
    edges = np.stack([lo, g.edges.max(1)], 1)[order].astype(np.int32)
    delay = np.asarray([int(d * 1e9) / 1e9 for d in g.delay_s[order]])
    rate = np.asarray([float(int(r)) for r in g.rate_bps[order]])
    interval = round(pkt_bytes * 8.0 / (flow_kbps * 1e3) * 1e9) / 1e9
    return AsFlowsProgram(
        n=g.n, edges=edges, delay_s=delay, rate_bps=rate,
        src=np.asarray(src, np.int32)[by_src],
        dst=np.asarray(dst, np.int32)[by_src],
        flow_bps=np.full(n_flows, 8.0 * int(pkt_bytes) / interval),
        pkt_bytes=int(pkt_bytes), sim_s=sim_s)
