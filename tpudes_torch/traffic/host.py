"""Host-side mirrors of the traffic tables (numpy, f64).

Counterpart of ``tpudes/traffic/host.py``'s ``offered_packets`` and
``offered_bits_mean`` (``host.py:37-90``, ``:134-152``): the expected
offered load over a horizon, which the LTE engine reports as
``offered_bits`` beside the bits its backlogs really drained.
``arrival_times`` is not ported (the host DES parity tests use it).
"""

from __future__ import annotations

import numpy as np

from tpudes_torch.traffic.program import (
    GAP_INF,
    TRAFFIC_MODEL_IDS,
    TrafficProgram,
    bounded_pareto_mean,
    traffic_tables,
)

__all__ = ["offered_bits_mean", "offered_packets"]


def offered_packets(prog: TrafficProgram, t_us) -> np.ndarray:
    """(N,) cumulative offered packets in ``[0, t_us]``: the closed form
    of :func:`tpudes_torch.traffic.device.cum_packets` over the same
    tables, in f64."""
    t = traffic_tables(prog)
    tv = np.broadcast_to(np.asarray(t_us, np.int64), (prog.n,))
    tau = np.maximum(tv - prog.start_us.astype(np.int64), 0)
    started = tv >= prog.start_us
    ids = prog.model_ids()

    iv = prog.interval_us.astype(np.int64)
    a_cbr = np.where(
        started & (iv < GAP_INF), tau // np.maximum(iv, 1) + 1, 0
    ).astype(np.float64)

    S = int(prog.n_epoch)
    e = np.clip(tau // int(prog.epoch_us), 0, S - 1).astype(int)
    lam = t["epoch_cum"].astype(np.float64)[e] + t["epoch_rate"].astype(
        np.float64
    )[e] * np.minimum(
        tau - e * int(prog.epoch_us), int(prog.epoch_us)
    ) * 1e-6
    a_mmpp = prog.rate_pps.astype(np.float64) * lam * started

    C = int(prog.n_cycle)
    c = np.clip(
        (t["on_start"].astype(np.int64) <= tau[:, None]).sum(1) - 1,
        0, C - 1,
    )
    rows = np.arange(prog.n)
    on_s = t["on_start"][rows, c].astype(np.float64)
    on_l = t["on_len"][rows, c].astype(np.float64)
    pk = t["peak"][rows, c].astype(np.float64)
    fill = np.clip(tau - on_s, 0.0, on_l) * 1e-6
    a_onoff = (
        t["cum_pk"][rows, c].astype(np.float64) + pk * fill
    ) * started

    live = prog.arr_t < GAP_INF
    a_trace = (
        (live & (prog.arr_t.astype(np.int64) <= tv[:, None]))
        .sum(axis=1)
        .astype(np.float64)
    )

    return np.select(
        [
            ids == TRAFFIC_MODEL_IDS["trace"],
            ids == TRAFFIC_MODEL_IDS["onoff"],
            ids == TRAFFIC_MODEL_IDS["mmpp"],
        ],
        [a_trace, a_onoff, a_mmpp],
        default=a_cbr,
    )


def offered_bits_mean(prog: TrafficProgram, t_us) -> np.ndarray:
    """(N,) expected offered bits by ``t_us``: packets x the mean
    bounded-Pareto size for the generative models, the exact byte sums
    for trace entities."""
    ids = prog.model_ids()
    mean_b = bounded_pareto_mean(
        float(prog.size_pareto[0]), float(prog.size_pareto[1]),
        float(prog.size_pareto[2]),
    )
    gen = np.floor(offered_packets(prog, t_us)) * mean_b * 8.0
    live = prog.arr_t < GAP_INF
    tv = np.broadcast_to(np.asarray(t_us, np.int64), (prog.n,))
    hit = live & (prog.arr_t.astype(np.int64) <= tv[:, None])
    tr = (prog.arr_b * hit).sum(axis=1).astype(np.float64) * 8.0
    return np.where(ids == TRAFFIC_MODEL_IDS["trace"], tr, gen)
