"""Carry the reference's programs and kernel states into the port.

The JAX package's ``LteSmProgram``, its ``MobilityProgram``, its
``TrafficProgram``, its ``BssProgram``, its ``DumbbellProgram``, its
``AsFlowsProgram``, its ``WiredProgram`` and their states are numpy-able;
the port takes their numpy values (it never imports the JAX package).
This is how the tests and a user move a scenario lowered by the
reference (``tpudes.scenarios.build_lena`` + ``lower_lte_sm``, ``build_bss`` +
``lower_bss``, ``build_dumbbell`` + ``lower_dumbbell``, or
``build_as_network`` + ``lower_as_flows``, or ``wired_chain``) onto the
card.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from tpudes_torch.device import resolve_device
from tpudes_torch.ops.mobility import MobilityProgram
from tpudes_torch.parallel.as_flows import AsFlowsProgram
from tpudes_torch.parallel.bss_cuda import BSS_STATE
from tpudes_torch.parallel.kernels_cuda import SM_STATE
from tpudes_torch.parallel.lte_sm import LteSmProgram
from tpudes_torch.parallel.replicated import BssProgram
from tpudes_torch.parallel.tcp_dumbbell import (
    SIDE_KEYS,
    TCP_STATE,
    DumbbellProgram,
)
from tpudes_torch.parallel.wired import WIRED_STATE, WiredProgram
from tpudes_torch.traffic.program import TrafficProgram

#: the reference program's fields the port reads
PROGRAM_FIELDS = (
    "gain", "serving", "tx_power_dbm", "noise_psd", "n_rb", "n_ttis",
    "scheduler", "pf_alpha", "precision", "geom_stride", "enb_pos",
    "pathloss",
)

#: the reference ``MobilityProgram``'s fields
MOBILITY_FIELDS = (
    "model", "base_pos", "velocity", "speed", "bounds", "wp_t", "wp_p",
    "seg_us", "n_seg", "mob_seed",
)

#: the reference ``TrafficProgram``'s fields
TRAFFIC_FIELDS = (
    "model", "start_us", "interval_us", "rate_pps", "mmpp_mult", "mmpp_p",
    "peak_pps", "on_pareto", "off_mean_s", "arr_t", "arr_b", "size_pareto",
    "env", "epoch_us", "n_epoch", "n_cycle", "tr_seed", "model_id",
)


#: the reference ``BssProgram``'s fields the port reads (``max_mpdus``
#: and ``subframe_bytes`` carry the 802.11n arm; ``mobility`` and
#: ``traffic`` cross over on their own, :func:`bss_from_numpy`)
BSS_FIELDS = (
    "positions", "data_mode_idx", "ack_mode_idx", "data_bytes",
    "beacon_bytes", "start_us", "interval_us", "stop_us", "sim_end_us",
    "tx_power_dbm", "path_loss_exponent", "reference_loss_db",
    "noise_figure_db", "bandwidth_hz", "rx_sensitivity_dbm", "aifs_us",
    "max_mpdus", "subframe_bytes", "geom_stride",
)


def bss_from_numpy(fields: Mapping,
                   mobility: MobilityProgram | None = None,
                   traffic: TrafficProgram | None = None) -> BssProgram:
    """Port BSS program from the reference ``BssProgram``'s numpy fields
    (:data:`BSS_FIELDS`), moving as ``mobility`` says
    (:func:`mobility_from_numpy`) and with the workload ``traffic``
    (:func:`traffic_from_numpy`)."""
    ints = ("data_mode_idx", "ack_mode_idx", "data_bytes", "beacon_bytes",
            "sim_end_us", "aifs_us", "max_mpdus", "subframe_bytes",
            "geom_stride")
    floats = ("tx_power_dbm", "path_loss_exponent", "reference_loss_db",
              "noise_figure_db", "bandwidth_hz", "rx_sensitivity_dbm")
    return BssProgram(
        positions=np.asarray(fields["positions"], np.float32),
        start_us=np.asarray(fields["start_us"], np.int32),
        interval_us=np.asarray(fields["interval_us"], np.int32),
        stop_us=np.asarray(fields["stop_us"], np.int32),
        **{k: int(fields[k]) for k in ints},
        **{k: float(fields[k]) for k in floats},
        mobility=mobility,
        traffic=traffic,
    )


def bss_state_from_numpy(state: Mapping, device=None) -> dict:
    """Port BSS state (:data:`~tpudes_torch.parallel.bss_cuda.BSS_STATE`)
    from a reference ``build_bss_step`` state dict, on ``device`` (the
    card by default); the reference's ``step`` counter stays behind.  A
    horizon sweep's ``(C, R, ...)`` state carries across as it is (the
    port's sweep layout).  ``geom_t`` is 0 (the reference keeps a mobile
    program's tables, not the time they were built at)."""
    device = resolve_device(device)
    out = {
        k: torch.tensor(np.asarray(state[k]), dtype=torch.bool if dt ==
                        "bool" else torch.int32, device=device)
        for k, _, dt in BSS_STATE if k != "geom_t"
    }
    # the reference carries a mobile program's tables, not their time
    out["geom_t"] = torch.zeros_like(out["t"])
    return out


def mobility_from_numpy(fields: Mapping) -> MobilityProgram:
    """Port motion from the reference ``MobilityProgram``'s numpy
    fields (:data:`MOBILITY_FIELDS`)."""
    return MobilityProgram(
        model=str(fields["model"]),
        base_pos=np.asarray(fields["base_pos"], np.float32),
        velocity=np.asarray(fields["velocity"], np.float32),
        speed=np.asarray(fields["speed"], np.float32),
        bounds=np.asarray(fields["bounds"], np.float32),
        wp_t=np.asarray(fields["wp_t"], np.int32),
        wp_p=np.asarray(fields["wp_p"], np.float32),
        seg_us=int(fields["seg_us"]),
        n_seg=int(fields["n_seg"]),
        mob_seed=int(fields["mob_seed"]),
    )


def traffic_from_numpy(fields: Mapping) -> TrafficProgram:
    """Port workload from the reference ``TrafficProgram``'s numpy
    fields (:data:`TRAFFIC_FIELDS`; ``model_id`` may be missing or
    None)."""
    model_id = fields.get("model_id")
    return TrafficProgram(
        model=str(fields["model"]),
        start_us=np.asarray(fields["start_us"], np.int32),
        interval_us=np.asarray(fields["interval_us"], np.int32),
        rate_pps=np.asarray(fields["rate_pps"], np.float32),
        mmpp_mult=np.asarray(fields["mmpp_mult"], np.float32),
        mmpp_p=np.asarray(fields["mmpp_p"], np.float32),
        peak_pps=np.asarray(fields["peak_pps"], np.float32),
        on_pareto=np.asarray(fields["on_pareto"], np.float32),
        off_mean_s=float(fields["off_mean_s"]),
        arr_t=np.asarray(fields["arr_t"], np.int32),
        arr_b=np.asarray(fields["arr_b"], np.int32),
        size_pareto=np.asarray(fields["size_pareto"], np.float32),
        env=np.asarray(fields["env"], np.float32),
        epoch_us=int(fields["epoch_us"]),
        n_epoch=int(fields["n_epoch"]),
        n_cycle=int(fields["n_cycle"]),
        tr_seed=int(fields["tr_seed"]),
        model_id=None if model_id is None else np.asarray(model_id,
                                                          np.int32),
    )


def program_from_numpy(fields: Mapping,
                       mobility: MobilityProgram | None = None,
                       traffic: TrafficProgram | None = None
                       ) -> LteSmProgram:
    """Port program from the reference ``LteSmProgram``'s numpy fields
    (:data:`PROGRAM_FIELDS`; the mobile ones may be missing or None for
    a static program), moving as
    ``mobility`` says (:func:`mobility_from_numpy`) and with the finite
    backlogs ``traffic`` fills (:func:`traffic_from_numpy`)."""
    enb_pos = fields.get("enb_pos")
    pathloss = fields.get("pathloss")
    return LteSmProgram(
        gain=np.asarray(fields["gain"], dtype=np.float64),
        serving=np.asarray(fields["serving"], dtype=np.int32),
        tx_power_dbm=np.asarray(fields["tx_power_dbm"], dtype=np.float64),
        noise_psd=float(fields["noise_psd"]),
        n_rb=int(fields["n_rb"]),
        n_ttis=int(fields["n_ttis"]),
        scheduler=str(fields["scheduler"]),
        pf_alpha=float(fields["pf_alpha"]),
        precision=str(fields["precision"]),
        mobility=mobility,
        traffic=traffic,
        geom_stride=int(fields.get("geom_stride") or 1),
        enb_pos=None if enb_pos is None else np.asarray(enb_pos, np.float32),
        pathloss=None if pathloss is None else (
            str(pathloss[0]), *(float(v) for v in pathloss[1:])
        ),
    )


def state_from_numpy(state: Mapping, device=None) -> dict:
    """Port kernel state from a reference state dict: per-lane rows
    ``(..., 1, U)`` and columns ``(..., E, 1)`` become ``(R, U)`` and
    ``(R, E)`` (an unbatched reference state becomes ``R = 1``), on
    ``device`` (the card by default)."""
    device = resolve_device(device)
    out = {}
    for k, ax, _ in SM_STATE:
        a = np.asarray(state[k])
        a = a.reshape(-1, a.shape[-1]) if ax == "u" else a.reshape(
            -1, a.shape[-2]
        )
        out[k] = torch.tensor(a, device=device)
    return out


#: the reference ``DumbbellProgram``'s fields (``traffic``, an app-limited
#: workload, crosses as the reference's TrafficProgram or its
#: :data:`TRAFFIC_FIELDS`)
DUMBBELL_FIELDS = (
    "n_flows", "variant_idx", "start_slot", "stop_slot", "max_pkts",
    "slot_s", "n_slots", "ack_lag", "queue_cap", "burst_cap", "base_rtt_s",
    "seg_bytes", "ecn", "qdisc", "red_min_th", "red_max_th", "red_max_p",
    "red_qw", "red_gentle", "red_use_ecn", "red_use_hard_drop", "traffic",
)


def dumbbell_from_numpy(fields: Mapping) -> DumbbellProgram:
    """Port dumbbell program from the reference ``DumbbellProgram``'s
    numpy fields (:data:`DUMBBELL_FIELDS`; ``ecn`` may be None, and
    ``traffic`` None, the reference's TrafficProgram or a mapping of its
    fields, carried over by :func:`traffic_from_numpy`)."""
    ecn = fields.get("ecn")
    traffic = fields.get("traffic")
    if traffic is not None and not isinstance(traffic, Mapping):
        traffic = {k: getattr(traffic, k) for k in TRAFFIC_FIELDS}
    return DumbbellProgram(
        n_flows=int(fields["n_flows"]),
        **{k: np.asarray(fields[k], np.int32)
           for k in ("variant_idx", "start_slot", "stop_slot", "max_pkts")},
        **{k: int(fields[k]) for k in ("n_slots", "ack_lag", "queue_cap",
                                       "burst_cap", "seg_bytes")},
        **{k: float(fields[k]) for k in ("slot_s", "base_rtt_s",
                                         "red_min_th", "red_max_th",
                                         "red_max_p", "red_qw")},
        **{k: bool(fields[k]) for k in ("red_gentle", "red_use_ecn",
                                        "red_use_hard_drop")},
        ecn=None if ecn is None else np.asarray(ecn, bool),
        qdisc=str(fields["qdisc"]),
        traffic=None if traffic is None else traffic_from_numpy(traffic),
    )


def dumbbell_state_from_numpy(state: Mapping, device=None) -> dict:
    """Port dumbbell state (:data:`~tpudes_torch.parallel.tcp_dumbbell.
    TCP_STATE`) from a reference ``build_dumbbell_step`` state dict (its
    ``side`` dict flattened), on ``device`` (the card by default).  An
    ``(R, ...)`` state becomes the grid's C = 1; a sweep's ``(C, R,
    ...)`` state carries across as it is."""
    device = resolve_device(device)
    side = state["side"]
    out = {}
    for k, ax, dt in TCP_STATE:
        a = np.asarray(side[k] if k in SIDE_KEYS else state[k])
        nd = {"f": 2, "lf": 3, "l": 2, "r": 1}[ax]
        if a.ndim == nd:
            a = a[None]
        out[k] = torch.tensor(a, dtype=torch.float32 if dt == "f32"
                              else torch.int32, device=device)
    return out


#: the reference ``AsFlowsProgram``'s fields (``traffic`` crosses through
#: :func:`traffic_from_numpy`; ``surrogate`` by its three fields,
#: :func:`surrogate_from_numpy`)
AS_FIELDS = (
    "n", "edges", "delay_s", "rate_bps", "src", "dst", "flow_bps",
    "pkt_bytes", "sim_s", "max_hops", "spf_rounds", "rate_jitter",
    "spf_metric", "traffic", "surrogate",
)


def surrogate_from_numpy(sur):
    """The port's :class:`~tpudes_torch.diff.Surrogacy` from the
    reference's (its ``temp``, ``gate_temp`` and ``ste``; None stays
    None)."""
    if sur is None:
        return None
    from tpudes_torch.diff.surrogate import Surrogacy

    return Surrogacy(temp=float(sur.temp), gate_temp=float(sur.gate_temp),
                     ste=bool(sur.ste))


def as_from_numpy(fields: Mapping) -> AsFlowsProgram:
    """Port program from the reference ``AsFlowsProgram``'s fields
    (:data:`AS_FIELDS`; those missing take the defaults).  ``traffic`` is
    None or a workload with :data:`TRAFFIC_FIELDS` as attributes (the
    reference's ``TrafficProgram``)."""
    tr = fields.get("traffic")
    if tr is not None:
        tr = traffic_from_numpy({k: getattr(tr, k) for k in TRAFFIC_FIELDS})
    opt = {k: fields[k] for k in ("max_hops", "spf_rounds") if k in fields}
    return AsFlowsProgram(
        n=int(fields["n"]),
        edges=np.asarray(fields["edges"], np.int32),
        delay_s=np.asarray(fields["delay_s"], np.float64),
        rate_bps=np.asarray(fields["rate_bps"], np.float64),
        src=np.asarray(fields["src"], np.int32),
        dst=np.asarray(fields["dst"], np.int32),
        flow_bps=np.asarray(fields["flow_bps"], np.float64),
        pkt_bytes=int(fields["pkt_bytes"]),
        sim_s=float(fields["sim_s"]),
        rate_jitter=float(fields.get("rate_jitter", 0.3)),
        spf_metric=str(fields.get("spf_metric", "hops")),
        traffic=tr, surrogate=surrogate_from_numpy(fields.get("surrogate")),
        **{k: int(v) for k, v in opt.items()},
    )


#: the reference ``WiredProgram``'s fields
WIRED_FIELDS = (
    "n_links", "service_slots", "delay_slots", "paths", "start_slot",
    "period_slots", "n_pkts", "n_slots", "slot_s", "jitter_slots",
    "link_owner",
)


def wired_from_numpy(fields: Mapping) -> WiredProgram:
    """Port program from the reference ``WiredProgram``'s fields
    (:data:`WIRED_FIELDS`; ``link_owner`` may be None)."""
    owner = fields.get("link_owner")
    return WiredProgram(
        n_links=int(fields["n_links"]),
        **{k: np.asarray(fields[k], np.int32)
           for k in ("service_slots", "delay_slots", "paths", "start_slot",
                     "period_slots", "n_pkts")},
        n_slots=int(fields["n_slots"]),
        slot_s=float(fields.get("slot_s", 1e-3)),
        jitter_slots=int(fields.get("jitter_slots", 0)),
        link_owner=None if owner is None else np.asarray(owner, np.int32),
    )


def wired_state_from_numpy(carry: Mapping, device=None) -> dict:
    """Port wired state from a reference ``build_wired_advance`` (or
    ``build_wired_space_advance``) carry: ``t`` an int, ``hop``,
    ``ready``, ``deliver``, ``eg_hop``, ``eg_ready`` ``(R, P)`` and
    ``free``, ``served`` ``(R, Lo)`` int32 (a leading lane axis kept), on
    ``device`` (the card by default)."""
    device = resolve_device(device)
    out = {k: torch.tensor(np.asarray(carry[k]), dtype=torch.int32,
                           device=device) for k, _ in WIRED_STATE}
    out["t"] = int(np.asarray(carry["t"]))
    return out
