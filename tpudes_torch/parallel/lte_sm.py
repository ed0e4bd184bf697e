"""The RLC-SM LTE downlink engine on the card.

Counterpart of ``tpudes/parallel/lte_sm.py``: under RLC saturation
every buffer is always full, so the only evolving state is
scheduler/HARQ bookkeeping (and, for a traffic program, each UE's
finite backlog).  The TTI math is
:mod:`tpudes_torch.parallel.kernels_cuda`: on the card one launch of the
multi-TTI kernel runs a whole range of TTIs, on the CPU the plain loop
runs them; this module owns the program, the replica keys, the geometry
stage and the result assembly.

- Static programs: a static grid makes SINR, CQI, MCS and MI per-UE
  constants (``build_sm_consts``).
- Mobile programs (``prog.mobility``): the UEs move, so the SINR-derived
  rows (:data:`SM_DYNAMIC_ROWS`) are recomputed from the positions every
  ``geom_stride`` TTIs by :func:`geom_rows` — a few tensor operations
  over every refresh time of a launch at once, in the reference's
  compiled f32 arithmetic — and the kernel reads them from that table.
  The serving map stays the t = 0 attach, as in the reference.
- Traffic programs (``prog.traffic``, a
  :class:`~tpudes_torch.traffic.program.TrafficProgram` of ``n_ue``
  entities): each lane's UEs hold finite backlogs, filled every TTI from
  an offered-bits table (:func:`~tpudes_torch.traffic.device.
  offered_table`, built once per launch and shared by every lane),
  drained by the bits each TTI delivers, and a UE with an empty backlog
  is not eligible (``lte_sm.py:839-946``).
- ``precision="bf16"``: the constants, the geometry rows and the step's
  metric and BLER round to bf16 where the reference's executables do
  (:mod:`tpudes_torch.ops.lte`); counters and accumulators stay f32 and
  int32.
- ``schedulers=[...]``: one launch runs C config points, one scheduler
  id each, on shared replica keys; the result is one dict per point.

Each replica ``r`` draws its TTI-``t`` coins as
``uniform(fold_in(fold_in(key, r), t), (U,))`` — the reference's
streams bit for bit (:mod:`tpudes_torch.random`) — so a run is
comparable with the JAX engine per replica, on integers.  The horizon
is a fixed count, so a host loop over chunks of TTIs is exact.

The engine runs on :mod:`tpudes_torch.parallel.runtime`: the program's
constants sit in the runner cache (keyed by value, as the reference's
``_sm_cache_key``), the replica axis is padded to its power-of-two
bucket, the chunks go through ``drive_chunks`` (``checkpoint=`` saves
the carry after each), and ``block=False`` returns an
:class:`~tpudes_torch.parallel.runtime.EngineFuture`.  :func:`lte_sm_study`
is the serving layer's descriptor.

``obs=True`` (the reference's ``TpudesObs``, ``lte_sm.py:650-757``)
keeps ns-3's FlowMonitor columns beside a static program's state, one
flow a UE (:mod:`tpudes_torch.obs.flowmon`; on the card the kernel's
``OBS`` arm), returned under ``flow``; every arm streams each chunk's
``ok``/``drops``/``retx`` (and the static arm its ring) to
:class:`~tpudes_torch.obs.device.ChunkStream`.  A runner-cache miss is
a :class:`~tpudes_torch.obs.device.CompileTelemetry` entry, a mobile
run's refreshes a :class:`~tpudes_torch.obs.geometry.GeomTelemetry` one
and a traffic run's load a :class:`~tpudes_torch.obs.traffic.
TrafficTelemetry` one.

Not ported yet (raises ``NotImplementedError`` naming its ROADMAP item):
``mesh``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tpudes_torch.device import resolve_device, to_device
from tpudes_torch.obs.distributed import wall_now
from tpudes_torch.ops.fused import device_table, f32, fma, sqrt
from tpudes_torch.ops.lte import (
    RB_BANDWIDTH_HZ,
    RE_PER_RB_DATA,
    _MCS_ECR,
    _MCS_EFF,
    _MCS_QM,
    cqi_from_efficiency,
    gapped_log2,
    mcs_from_cqi,
    mi_from_efficiency,
    round_bf16,
)
from tpudes_torch.ops.mobility import build_position_fn
from tpudes_torch.ops.propagation import db_to_ratio, friis, log_distance
from tpudes_torch.parallel.kernels_cuda import (
    SM_DYNAMIC_ROWS,
    SM_SCHED_IDS,
    build_sm_consts,
    sm_advance,
    sm_advance_math,
    sm_init_state,
    sm_step,
    sm_step_math,
    table_rows,
)
from tpudes_torch.parallel.runtime import (
    RUNTIME,
    EngineFuture,
    _not_ported,
    bucket_replicas,
    chunk_bounds,
    drive_chunks,
    finalize_with_flush,
)
from tpudes_torch.random import fold_in, replica_keys
from tpudes_torch.traffic.device import TRAFFIC_KEY_TAG, offered_table
from tpudes_torch.traffic.host import offered_bits_mean

__all__ = [
    "SM_DYNAMIC_ROWS", "LteSmProgram", "build_geom_fn", "build_sm_advance",
    "build_sm_mobile_advance", "build_sm_step", "build_sm_traffic_advance",
    "geom_rows", "lte_sm_study", "run_lte_sm",
]

#: refresh rows one mobile launch's table holds at most (a longer
#: launch is split): 4096 rows x 210 UEs x 5 rows x 4 B is 17 MB
GEOM_MAX_ROWS = 4096

#: TTIs one traffic launch's offered-bits table holds at most (a longer
#: launch is split): 16384 x 210 UEs x 4 B is 14 MB, and its build's
#: temporaries about ten times that
TRAFFIC_MAX_ROWS = 16384

#: the precisions the step runs at (``kernels_pallas.py`` SM_PRECISIONS)
PRECISIONS = ("f32", "bf16")

#: the pathloss descriptors the geometry stage takes
PATHLOSS_KINDS = ("friis", "log_distance")


@dataclass(frozen=True)
class LteSmProgram:
    """Static description of a full-buffer LTE downlink scenario
    (``tpudes/parallel/lte_sm.py:131``)."""

    gain: np.ndarray          # (E, U) linear DL path gain
    serving: np.ndarray       # (U,) int32
    tx_power_dbm: np.ndarray  # (E,)
    noise_psd: float
    n_rb: int
    n_ttis: int
    scheduler: str            # any key of SM_SCHED_IDS
    pf_alpha: float = 0.05
    precision: str = "f32"
    #: UE motion (tpudes_torch.ops.mobility.MobilityProgram); None is
    #: the static grid
    mobility: object = None
    #: TTIs between geometry refreshes (mobile programs)
    geom_stride: int = 1
    #: (E, 3) eNB sites (mobile programs)
    enb_pos: np.ndarray = None
    #: ("friis", frequency_hz, system_loss, min_loss_db) or
    #: ("log_distance", exponent, reference_distance, reference_loss_db)
    pathloss: tuple = None
    #: the UEs' workload (tpudes_torch.traffic.program.TrafficProgram,
    #: one entity per UE); None is full buffers
    traffic: object = None

    def __post_init__(self):
        if self.scheduler not in SM_SCHED_IDS:
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"precision {self.precision!r} not in {PRECISIONS}"
            )
        if self.traffic is not None and self.mobility is not None:
            raise ValueError(
                "traffic + mobility cannot ride one LTE program; run one "
                "axis on the device and the other on the host controller"
            )
        if self.traffic is not None and self.traffic.n != self.n_ue:
            raise ValueError(
                f"traffic drives {self.traffic.n} entities, the program "
                f"has {self.n_ue} UEs"
            )
        if self.mobility is not None:
            self._check_mobile()

    def _check_mobile(self):
        if self.mobility.n != self.n_ue:
            raise ValueError(
                f"mobility moves {self.mobility.n} nodes, the program has "
                f"{self.n_ue} UEs"
            )
        if self.enb_pos is None or np.shape(self.enb_pos) != (self.n_enb, 3):
            raise ValueError("a mobile program needs enb_pos of shape (E, 3)")
        if self.pathloss is None or self.pathloss[0] not in PATHLOSS_KINDS:
            raise ValueError(
                f"a mobile program needs a pathloss descriptor of "
                f"{PATHLOSS_KINDS}; got {self.pathloss!r}"
            )
        if int(self.geom_stride) < 1:
            raise ValueError(f"geom_stride must be >= 1: {self.geom_stride}")

    @property
    def n_enb(self) -> int:
        return int(self.gain.shape[0])

    @property
    def n_ue(self) -> int:
        return int(self.gain.shape[1])


def build_sm_step(prog: LteSmProgram, device=None, use_kernel: bool = True,
                  consts: dict | None = None):
    """``(consts, init_state, step_fn)`` with
    ``step_fn(state, coin (R, U), t) -> state`` (``lte_sm.py:397``), on
    ``device`` (the card by default); static programs only.  ``consts``
    are the program's :func:`build_sm_consts` where the caller has them
    (the runner cache), else built here.

    ``use_kernel=False`` runs the plain core on any device (the card's
    comparison path); otherwise the step is :func:`sm_step`, which
    launches the single-TTI kernel for CUDA tensors."""
    if prog.mobility is not None:
        raise ValueError("build_sm_step runs static programs; a mobile "
                         "program runs through build_sm_mobile_advance")
    device = resolve_device(device)
    if consts is None:
        consts = build_sm_consts(prog, device=device)
    sid = SM_SCHED_IDS[prog.scheduler]
    step = sm_step if use_kernel else sm_step_math

    def init_state(replicas: int) -> dict:
        return sm_init_state(prog.n_enb, prog.n_ue, replicas, device)

    def step_fn(state: dict, coin: torch.Tensor, t: int) -> dict:
        return step(consts, state, coin, t, sid)

    return consts, init_state, step_fn


def build_sm_advance(prog: LteSmProgram, device=None,
                     use_kernel: bool = True, chunk_ttis: int | None = None,
                     consts: dict | None = None):
    """``(consts, init_state, advance)`` with
    ``advance(state, keys (R, 2), t0, t_end, sids=None) -> state``
    running TTIs ``[t0, t_end)`` (``lte_sm.py:646``), ``chunk_ttis`` at a
    time (the whole range by default), on ``device`` (the card by
    default).  ``sids`` (a ``(C,)`` int32 tensor) sweeps C scheduler ids
    over ``(C * R, ...)`` state; by default the program's scheduler.

    Each chunk is :func:`sm_advance`: one launch of the multi-TTI kernel
    for CUDA tensors, the plain loop (coins drawn in memory-bounded
    chunks) for CPU tensors.  ``use_kernel=False`` runs the plain loop
    on any device.  ``advance(..., fm=...)`` also carries the FlowMonitor
    columns (:func:`~tpudes_torch.obs.flowmon.flow_carry` of ``U`` flows,
    ``(C * R, ...)`` lanes; the kernel's ``OBS`` arm) and returns
    ``(state, fm)``."""
    consts, init_state, _ = build_sm_step(prog, device, use_kernel, consts)
    run = sm_advance if use_kernel else sm_advance_math

    def advance(state: dict, keys: torch.Tensor, t0: int, t_end: int,
                sids=None, fm: dict | None = None):
        sids = SM_SCHED_IDS[prog.scheduler] if sids is None else sids
        chunk = chunk_ttis or max(1, t_end - t0)
        for c0 in range(t0, t_end, chunk):
            out = run(consts, state, keys, c0, min(c0 + chunk, t_end),
                      sids, fm=fm)
            state, fm = out if fm is not None else (out, None)
        return state if fm is None else (state, fm)

    return consts, init_state, advance


# --------------------------------------------------------------------------
# the mobile path: the device geometry stage and its advance
# --------------------------------------------------------------------------


def geom_rows(prog: LteSmProgram, consts: dict, t_ttis) -> dict:
    """The SINR-derived rows at refresh TTIs ``t_ttis`` (K of them), all
    at once: ``{mi0, rate0, eff0, ecr0, eligible, sinr, cqi, mcs}``, each
    ``(K, U)`` on ``consts``' device (:func:`build_geom_fn` once)."""
    return build_geom_fn(prog, consts)(t_ttis)


def build_geom_fn(prog: LteSmProgram, consts: dict):
    """``rows_at(t_ttis) -> dict`` of :func:`geom_rows`, with the motion's
    operands and the program's constants put on ``consts``' device once.

    ``rows_at`` is the reference's ``rows_from_pos(pos_at(mob_ops, t))``
    (``lte_sm.py:440-529``) batched over the K times, in the arithmetic
    its compiled stage runs: positions from :mod:`~tpudes_torch.ops.
    mobility`, distances with the squares summed as fused multiply-adds
    and a correctly rounded root, the loss and ``10 ** (dB / 10)`` of
    :mod:`~tpudes_torch.ops.propagation`, the total received power as a
    chain of multiply-adds over the eNBs in order, the serving cell's
    power, SINR, and the CQI/MCS/MI chain with its compiled log2.  In
    bf16 the SINR is rounded to bf16 and the gapped log2 is the stage's
    bf16 HLO (:func:`~tpudes_torch.ops.lte.gapped_log2`)."""
    dev = consts["mi0"].device
    bf16 = prog.precision == "bf16"
    ops = prog.mobility.operands(dev)
    pos_at = build_position_fn(prog.mobility)
    enb = torch.as_tensor(np.asarray(prog.enb_pos, np.float32), device=dev)
    psd = torch.as_tensor(np.asarray(
        10.0 ** ((np.asarray(prog.tx_power_dbm) - 30.0) / 10.0)
        / (prog.n_rb * RB_BANDWIDTH_HZ), np.float32,
    ), device=dev)                                          # (E,)
    serving = consts["serving"].long()
    psd_serving = psd[serving]
    kind, *params = prog.pathloss
    eff_tab, qm_tab, ecr_tab = (device_table(a, dev)
                                for a in (_MCS_EFF, _MCS_QM, _MCS_ECR))
    tb_re = f32(psd, consts["rbg_size"] * RE_PER_RB_DATA)

    def rows_at(t_ttis) -> dict:
        t = torch.as_tensor(t_ttis, dtype=torch.int32, device=dev).reshape(-1)
        pos = pos_at(ops, t * 1000)                         # (K, U, 3)
        diff = enb[None, :, None, :] - pos[:, None, :, :]   # (K, E, U, 3)
        d2 = diff[..., 0] * diff[..., 0]
        d2 = fma(diff[..., 1], diff[..., 1], d2)
        d = sqrt(fma(diff[..., 2], diff[..., 2], d2))       # (K, E, U)
        zero = f32(d, 0.0)
        rx_dbm = (friis(zero, d, *params, fused=True) if kind == "friis"
                  else log_distance(zero, d, *params))
        gain = db_to_ratio(rx_dbm)                          # (K, E, U)
        total = gain[:, 0] * psd[0]
        for e in range(1, gain.shape[1]):
            total = fma(gain[:, e], psd[e], total)          # (K, U)
        sig = torch.gather(
            gain, 1, serving[None, None, :].expand(len(t), 1, -1)
        )[:, 0] * psd_serving
        sinr = sig / ((total - sig) + f32(sig, prog.noise_psd))
        if bf16:
            sinr = round_bf16(sinr)
        se = gapped_log2(sinr, fused=True, bf16=bf16)
        cqi = cqi_from_efficiency(se)
        mcs = mcs_from_cqi(cqi).long()
        eff0 = eff_tab[mcs]
        return dict(
            mi0=mi_from_efficiency(se, qm_tab[mcs]),
            rate0=torch.floor(eff0 * tb_re) * 1000.0,
            eff0=eff0, ecr0=ecr_tab[mcs],
            eligible=(cqi >= 1).to(torch.int32),
            sinr=sinr, cqi=cqi.to(torch.int32), mcs=mcs.to(torch.int32),
        )

    return rows_at


def build_sm_mobile_advance(prog: LteSmProgram, device=None,
                            use_kernel: bool = True,
                            chunk_ttis: int | None = None,
                            consts: dict | None = None):
    """``(consts, init_state, advance)`` for a mobile program, with
    ``advance(state, keys (R, 2), t0, t_end, sids=None) -> (state, last,
    refreshes)``: TTIs ``[t0, t_end)`` with the rows refreshed at every
    multiple of ``geom_stride`` (``lte_sm.py:770-836``); ``last`` is the
    newest refresh's rows (``(U,)`` each), ``refreshes`` the count of
    refresh TTIs in the range.

    Each launch covers ``chunk_ttis`` TTIs (the whole range by default),
    cut further so that its table holds at most :data:`GEOM_MAX_ROWS`
    rows.  A launch's table is :func:`geom_rows` at the refreshes from
    the one it starts inside (a launch that starts mid-stride runs on
    the refresh before it, as the reference's carried rows do) to the
    one its last TTI runs on."""
    consts, init_state, _ = build_sm_step(
        _static_twin(prog), device, use_kernel, consts
    )
    stride = int(prog.geom_stride)
    run = sm_advance if use_kernel else sm_advance_math
    rows_at = build_geom_fn(prog, consts)
    dev = consts["mi0"].device

    def advance(state: dict, keys: torch.Tensor, t0: int, t_end: int,
                sids=None):
        sids = SM_SCHED_IDS[prog.scheduler] if sids is None else sids
        span = min(chunk_ttis or max(1, t_end - t0), stride * GEOM_MAX_ROWS)
        last, refreshes = None, 0
        for c0 in range(t0, t_end, span):
            c1 = min(c0 + span, t_end)
            j0 = c0 // stride
            rows = rows_at(stride * torch.arange(
                j0, j0 + table_rows(c0, c1, stride), device=dev,
            ))
            state = run(consts, state, keys, c0, c1, sids,
                        {k: rows[k] for k in SM_DYNAMIC_ROWS}, stride)
            last = {k: v[-1] for k, v in rows.items()}
            refreshes += (c1 - 1) // stride - (c0 - 1) // stride
        return state, last, refreshes

    return consts, init_state, advance


def build_sm_traffic_advance(prog: LteSmProgram, device=None,
                             use_kernel: bool = True,
                             chunk_ttis: int | None = None,
                             consts: dict | None = None):
    """``(consts, init_state, advance)`` for a traffic program, with
    ``advance(state, keys (R, 2), tr_key (2,), t0, t_end, sids=None) ->
    state`` running TTIs ``[t0, t_end)`` on finite backlogs
    (``lte_sm.py:839-946``); ``init_state(lanes)`` holds the
    :data:`~tpudes_torch.parallel.kernels_cuda.TR_STATE` besides.

    Each launch covers ``chunk_ttis`` TTIs (the whole range by default),
    cut further to :data:`TRAFFIC_MAX_ROWS`; its offered-bits table is
    :func:`~tpudes_torch.traffic.device.offered_table` of its TTIs under
    the run's traffic key ``tr_key`` (``fold_in(key,
    TRAFFIC_KEY_TAG)``), built once and read by every lane."""
    consts, _, _ = build_sm_step(prog, device, use_kernel, consts)
    run = sm_advance if use_kernel else sm_advance_math
    dev = consts["mi0"].device
    ops = prog.traffic.operands(dev)

    def init_state(lanes: int) -> dict:
        return sm_init_state(prog.n_enb, prog.n_ue, lanes, dev, traffic=True)

    def advance(state: dict, keys: torch.Tensor, tr_key: torch.Tensor,
                t0: int, t_end: int, sids=None):
        sids = SM_SCHED_IDS[prog.scheduler] if sids is None else sids
        span = min(chunk_ttis or max(1, t_end - t0), TRAFFIC_MAX_ROWS)
        for c0 in range(t0, t_end, span):
            c1 = min(c0 + span, t_end)
            offered = offered_table(ops, prog.traffic.epoch_us, tr_key, c0,
                                    c1)
            state = run(consts, state, keys, c0, c1, sids, offered=offered)
        return state

    return consts, init_state, advance


def _static_twin(prog: LteSmProgram) -> LteSmProgram:
    """The program without its motion: the consts, the cell structure
    and the kernels' static rows come from its t = 0 lowering."""
    return dataclasses.replace(prog, mobility=None)


# --------------------------------------------------------------------------
# the entry point
# --------------------------------------------------------------------------




def _sm_prog_key(prog: LteSmProgram) -> tuple:
    """The program fields of the reference's ``_sm_cache_key``
    (``lte_sm.py:532``): ``scheduler`` and ``n_ttis`` are absent (the
    scheduler id and the horizon are a launch's operands, not its
    constants), and so are ``geom_stride`` and every mobility and
    workload parameter; the mobility and workload shape keys are in."""
    return (
        prog.gain.tobytes(), prog.serving.tobytes(),
        prog.tx_power_dbm.tobytes(), prog.noise_psd, prog.n_rb,
        prog.pf_alpha, prog.precision,
        None if prog.mobility is None else prog.mobility.shape_key(),
        None if prog.enb_pos is None else np.asarray(prog.enb_pos).tobytes(),
        prog.pathloss,
        None if prog.traffic is None else prog.traffic.shape_key(),
    )


def _burst_duty(traffic) -> float | None:
    """The mean ON share of an ON-OFF workload, else None
    (``lte_sm.py:1084-1094``)."""
    if traffic.model != "onoff":
        return None
    return float(np.clip(
        traffic.rate_pps.sum() / max(float(traffic.peak_pps.sum()), 1e-9),
        0.0, 1.0))


def _sm_arm(prog: LteSmProgram) -> str:
    if prog.traffic is not None:
        return "traffic"
    return "static" if prog.mobility is None else "mobile"


def _sm_unpack(host: dict, shared: dict, fm: dict | None = None) -> dict:
    """Result dict (``lte_sm.py:564``) of one config point from its host
    state, ``(R, ...)`` rows: the 52-bit rx counter rebuilt, per-UE
    rows, and the CQI/MCS/SINR; the FlowMonitor columns under ``flow``
    where ``fm`` holds them."""
    out = {
        k: host[k] for k in ("new_tbs", "retx", "drops")
    }
    out["rx_bits"] = (host["rx_hi"].astype(np.int64) << 20) + host[
        "rx_lo"
    ].astype(np.int64)
    out["ok"] = host["ok_cnt"]
    if "tr_backlog" in host:  # a traffic run (``lte_sm.py:1061-1078``)
        out["backlog_bits"] = host["tr_backlog"]
        out["goodput_bits"] = (
            host["tr_drained_hi"].astype(np.int64) << 20
        ) + host["tr_drained_lo"].astype(np.int64)
    for k in ("cqi", "mcs", "sinr"):
        out[k] = shared[k]
    if fm is not None:
        out["flow"] = fm
    return out


def _lane_sums(state: dict, axes) -> dict:
    """The chunk metrics ``ok``, ``drops`` and ``retx``: int32 sums of
    the counters over ``axes`` (``lte_sm.py:750-753``)."""
    return {name: state[k].sum(dim=axes, dtype=torch.int32)
            for name, k in (("ok", "ok_cnt"), ("drops", "drops"),
                            ("retx", "retx"))}


def lte_sm_study(prog: LteSmProgram, key, replicas=None, mesh=None,
                 device=None):
    """Serving-layer study descriptor (``lte_sm.py:591``): the scheduler
    is the sweep operand, so two studies coalesce onto one launch of C
    scheduler points whenever their static fields, horizon, key, replica
    count, mesh and device all match (the mobility and workload
    parameters too: only the scheduler may differ)."""
    from tpudes_torch.serving.descriptor import (
        StudyDescriptor,
        mesh_fingerprint,
    )

    dev = resolve_device(device)
    ck = (
        prog.gain.tobytes(), prog.serving.tobytes(),
        prog.tx_power_dbm.tobytes(), prog.noise_psd, prog.n_rb,
        prog.pf_alpha, prog.precision, prog.n_ttis,
        np.asarray(key, np.int64).tobytes(), replicas,
        mesh_fingerprint(mesh),
        None if prog.mobility is None else prog.mobility.param_key(),
        int(prog.geom_stride),
        None if prog.traffic is None else prog.traffic.param_key(),
        str(dev),
    )

    def launch(points, block=False):
        # one point rides the plain entry, as every other caller does
        if len(points) == 1:
            return run_lte_sm(
                dataclasses.replace(prog, scheduler=points[0]), key,
                replicas=replicas, mesh=mesh, block=block, device=dev,
            )
        return run_lte_sm(prog, key, replicas=replicas, mesh=mesh,
                          schedulers=list(points), block=block, device=dev)

    def warm(n_points):
        # a 1-TTI run builds the kernel and fills the runner cache
        tiny = dataclasses.replace(prog, n_ttis=1)
        run_lte_sm(tiny, key, replicas=replicas, mesh=mesh, device=dev,
                   schedulers=None if n_points == 1
                   else [prog.scheduler] * n_points)

    return StudyDescriptor("lte_sm", ck, prog.scheduler, launch, warm)


def run_lte_sm(
    prog: LteSmProgram,
    key,
    replicas: int | None = None,
    *,
    device=None,
    chunk_ttis: int | None = None,
    use_kernel: bool = True,
    schedulers=None,
    checkpoint=None,
    block: bool = True,
    mesh=None,
    obs: bool = False,
):
    """Run the full-buffer downlink simulation (``lte_sm.py:1285``).

    ``key`` is a ``(2,)`` threefry key (:func:`tpudes_torch.random.PRNGKey`
    or a JAX key's words).  Without ``replicas``: one run on ``key``,
    per-UE arrays ``{rx_bits, new_tbs, retx, drops, ok, cqi, mcs,
    sinr}``.  With ``replicas=R``: replica ``r`` runs on
    ``fold_in(key, r)`` and the outcome arrays gain a leading ``R``
    axis; the replica axis is padded to its power-of-two bucket
    (``TPUDES_BUCKETING``) and the results sliced back.  A mobile
    program (``prog.mobility``) adds ``geom_refreshes`` and
    ``geom_stride``, and its ``cqi, mcs, sinr`` are the last refresh's.
    A traffic program (``prog.traffic``) adds per UE ``backlog_bits``
    (f32, what is left), ``goodput_bits`` (int64, what drained) and
    ``offered_bits`` (the expected offered load over the horizon,
    ``offered_bits_mean``).  ``schedulers=[...]`` (names of
    ``SM_SCHED_IDS``) runs every point in one launch per chunk and
    returns a list of result dicts, each what the single-point run on
    the same key returns.

    ``device`` defaults to the card; on the card each chunk (the whole
    horizon, or ``chunk_ttis`` TTIs) is one kernel launch unless
    ``use_kernel=False`` asks for the plain loop.  ``checkpoint=`` (a
    path or a :class:`~tpudes_torch.parallel.checkpoint.CarryCheckpoint`)
    saves the carry after each chunk and resumes a matching run from its
    last completed chunk, bit-equal.  ``block=False`` returns an
    :class:`~tpudes_torch.parallel.runtime.EngineFuture`.

    ``obs=True`` adds, for a static program, the FlowMonitor columns of
    each point under ``flow`` (``fm_*`` per UE, ``(R, U)``; ``fm_hist``
    ``(R, U, 16)``, ``fm_ring`` ``(R, 512, 5)``; reduce them with
    :mod:`tpudes_torch.obs.flowmon`), and for every arm streams a chunked
    run's per-chunk metrics to :class:`~tpudes_torch.obs.device.
    ChunkStream`."""
    if mesh is not None:
        raise _not_ported("mesh", "A12")
    names = [prog.scheduler] if schedulers is None else list(schedulers)
    unknown = [n for n in names if n not in SM_SCHED_IDS]
    if unknown or not names:
        raise ValueError(f"schedulers must be names of SM_SCHED_IDS: {names}")
    from tpudes_torch.parallel.checkpoint import checkpoint_ctx

    dev = resolve_device(device)
    r_pad = bucket_replicas(replicas)
    n_cfg = None if schedulers is None else len(names)
    arm = _sm_arm(prog)
    from tpudes_torch.obs.device import CompileTelemetry
    from tpudes_torch.obs.flowmon import flip_ring, flow_carry
    from tpudes_torch.obs.geometry import GeomTelemetry
    from tpudes_torch.obs.traffic import TrafficTelemetry

    t_miss = wall_now()
    consts, compiling = RUNTIME.runner(
        "lte_sm",
        _sm_prog_key(prog) + (use_kernel, r_pad, n_cfg, obs, str(dev), arm),
        lambda: build_sm_consts(_static_twin(prog), device=dev),
    )
    key = to_device(key if isinstance(key, torch.Tensor)
                    else np.asarray(key, np.int64), dev, torch.int64)
    keys = key[None, :] if r_pad is None else replica_keys(key, r_pad)
    C, R = len(names), len(keys)
    sid_list = [SM_SCHED_IDS[n] for n in names]
    sids = None if schedulers is None else to_device(
        np.asarray(sid_list, np.int32), dev)
    build = dict(traffic=build_sm_traffic_advance, static=build_sm_advance,
                 mobile=build_sm_mobile_advance)[arm]
    _, init_state, advance = build(prog, dev, use_kernel, consts=consts)
    # a traffic advance takes the run's traffic key after the replica keys
    tr_args = ((fold_in(key, TRAFFIC_KEY_TAG),) if arm == "traffic"
               else ())
    carry = dict(t=0, state={k: v.unflatten(0, (C, R))
                             for k, v in init_state(C * R).items()})
    if arm == "mobile":
        carry.update(last=None, refreshes=0)
    flows = obs and arm == "static"
    if flows:
        carry["fm"] = flow_carry(prog.n_ue, (C, R), dev)
    # the reference's lanes: (C, R) with a sweep, (R,) with replicas, a
    # scalar lane without
    lane_shape = ((C,) if schedulers is not None else ()) + (
        (R,) if replicas is not None else ())

    def metrics(out):
        """The chunk's fresh metrics: the static arm's per lane, with
        its ring reversed (the reference's lane keeps a (1,) row axis),
        the unbatched arms' sums over every lane (``lte_sm.py:745-757``,
        ``:826-833``)."""
        st = out["state"]
        if not flows:
            return _lane_sums(st, (0, 1, 2))
        m = {k: v.reshape(lane_shape)
             for k, v in _lane_sums(st, (2,)).items()}
        m["fm_ring"] = flip_ring(out["fm"]["fm_ring"]).reshape(
            lane_shape + (1,) + out["fm"]["fm_ring"].shape[2:])
        return m

    def launch(c, bound):
        flat = {k: v.flatten(0, 1) for k, v in c["state"].items()}
        out = dict(c, t=bound)
        if arm == "mobile":
            flat, last, n = advance(flat, keys, c["t"], bound, sids)
            out.update(last=last if last is not None else c["last"],
                       refreshes=c["refreshes"] + n)
        elif flows:
            flat, fm = advance(flat, keys, c["t"], bound, sids,
                               fm={k: v.flatten(0, 1)
                                   for k, v in c["fm"].items()})
            out["fm"] = {k: v.unflatten(0, (C, R)) for k, v in fm.items()}
        else:
            flat = advance(flat, keys, *tr_args, c["t"], bound, sids)
        out["state"] = {k: v.unflatten(0, (C, R)) for k, v in flat.items()}
        return (out, metrics(out)) if obs else out

    mob = arm == "mobile"
    ckpt = checkpoint_ctx(
        checkpoint, engine="lte_sm", key=key, replicas=replicas,
        r_pad=r_pad, n_cfg=n_cfg, obs=obs, axis=1, device=dev,
        extra=_sm_prog_key(prog) + (arm, tuple(sid_list),
                                    int(prog.geom_stride) if mob else None,
                                    prog.mobility.param_key() if mob
                                    else None,
                                    None if prog.traffic is None
                                    else prog.traffic.param_key()),
    )
    with CompileTelemetry.timed("lte_sm", compiling, t_miss):
        carry, flush = drive_chunks(
            "lte_sm", chunk_bounds(prog.n_ttis, chunk_ttis or prog.n_ttis),
            carry, launch, obs=obs, checkpoint=ckpt)
    extra = {}
    if arm == "traffic":
        extra = dict(offered_bits=offered_bits_mean(prog.traffic,
                                                    prog.n_ttis * 1000))
    shared = consts
    if mob:
        extra = dict(geom_refreshes=carry["refreshes"],
                     geom_stride=int(prog.geom_stride))
        # no TTI ran: the rows are still zeros
        shared = carry["last"] or {k: torch.zeros_like(consts[k])
                                   for k in ("cqi", "mcs", "sinr")}
    fetch = dict(state=carry["state"],
                 shared={k: shared[k] for k in ("cqi", "mcs", "sinr")})
    if flows:
        fetch["fm"] = carry["fm"]
    want = 1 if replicas is None else int(replicas)

    def point(tree, i):
        return {k: v[i, :want] if replicas is not None else v[i, 0]
                for k, v in tree.items()}

    def finalize(host):
        points = [
            dict(_sm_unpack(point(host["state"], i), host["shared"],
                            point(host["fm"], i) if flows else None),
                 **extra)
            for i in range(C)
        ]
        if mob:
            # once a launch: the refreshes are shared by every point
            GeomTelemetry.record_device("lte_sm", carry["refreshes"],
                                        prog.n_ttis)
        if arm == "traffic":
            TrafficTelemetry.record(
                "lte_sm", prog.traffic.model,
                offered=float(extra["offered_bits"].sum()) * C * want,
                delivered=float(sum(np.asarray(p["goodput_bits"],
                                               np.float64).sum()
                                    for p in points)),
                duty=_burst_duty(prog.traffic))
        return points if schedulers is not None else points[0]

    fut = EngineFuture("lte_sm", fetch, finalize_with_flush(flush, finalize))
    return fut.result() if block else fut
