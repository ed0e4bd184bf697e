"""Small BSS, dumbbell and AS programs and workload points, built without the
host graph.

Counterpart of ``tpudes/parallel/programs.py``'s ``toy_bss_program``,
``toy_dumbbell_program``, ``toy_traffic_points`` and ``toy_as_program``
(``programs.py:18-47``, ``:71-89``, ``:92-136``, ``:139-159``): the
deterministic numpy recipes the reference's ``bench_traffic_burst`` and
its workload-sweep tests run, and :func:`bss_onoff_traffic`, that
bench's ON-OFF workload at a matched mean load
(``bench.py:397-458``).
"""

from __future__ import annotations

import math

import numpy as np

from tpudes_torch.helper.topology import BriteTopologyHelper
from tpudes_torch.ops.wifi_error import MODES_BY_NAME
from tpudes_torch.parallel.as_flows import AsFlowsProgram
from tpudes_torch.parallel.replicated import BssProgram
from tpudes_torch.parallel.tcp_dumbbell import INT32_MAX, DumbbellProgram
from tpudes_torch.traffic.program import (
    TrafficProgram,
    bounded_pareto_mean,
    unify_shapes,
)

__all__ = ["bss_onoff_traffic", "toy_as_program", "toy_bss_program",
           "toy_dumbbell_program", "toy_traffic_points"]

#: the ON-OFF workload of ``bench_traffic_burst`` (``bench.py:441-453``):
#: bounded-Pareto ON periods (shape, shortest s, longest s), the mean of
#: the exponential OFF periods and the seed of the cycle tables
BURST_ON = (1.5, 0.05, 0.3)
BURST_OFF_MEAN_S = 0.1
BURST_TR_SEED = 1


def toy_bss_program(n_sta: int = 4, sim_end_us: int = 60_000) -> BssProgram:
    """AP + ``n_sta`` STAs on a 25 m circle, UDP echo arrivals every
    20 ms from 10 ms, AP beacons every 102,400 µs from 0."""
    pos = [(0.0, 0.0, 0.0)] + [
        (25.0 * math.cos(2 * math.pi * i / n_sta),
         25.0 * math.sin(2 * math.pi * i / n_sta), 0.0)
        for i in range(n_sta)
    ]
    n = n_sta + 1
    start = np.full(n, 10_000, dtype=np.int32)
    start[0] = 0
    interval = np.full(n, 20_000, dtype=np.int32)
    interval[0] = 102_400
    return BssProgram(
        positions=np.asarray(pos, np.float32),
        data_mode_idx=MODES_BY_NAME["OfdmRate54Mbps"].index,
        ack_mode_idx=MODES_BY_NAME["OfdmRate24Mbps"].index,
        data_bytes=1084,
        beacon_bytes=78,
        start_us=start,
        interval_us=interval,
        stop_us=np.full(n, 2**30, np.int32),
        sim_end_us=int(sim_end_us),
    )


def toy_dumbbell_program(n_flows: int = 3,
                         n_slots: int = 250) -> DumbbellProgram:
    """A saturated dumbbell, flow ``i`` on variant ``i % 17``: 1 ms
    slots, an ack lag of 10, a 25-packet queue, bursts of 4."""
    return DumbbellProgram(
        n_flows=n_flows,
        variant_idx=(np.arange(n_flows) % 17).astype(np.int32),
        start_slot=np.zeros(n_flows, np.int32),
        stop_slot=np.full(n_flows, 2**30, np.int32),
        max_pkts=np.full(n_flows, INT32_MAX, np.int32),
        slot_s=1e-3,
        n_slots=int(n_slots),
        ack_lag=10,
        queue_cap=25,
        burst_cap=4,
        base_rtt_s=0.011,
        seg_bytes=1000,
    )


def _pin_beacons(tp: TrafficProgram, prog: BssProgram) -> TrafficProgram:
    """``tp`` with entity 0 (the AP) on the program's cbr beacons."""
    return tp.with_cbr_rows(np.arange(prog.n) == 0,
                            int(prog.interval_us[0]), int(prog.start_us[0]))


def bss_onoff_traffic(prog: BssProgram) -> TrafficProgram:
    """``bench_traffic_burst``'s bursty workload on ``prog``: ON-OFF at
    the peak ``rate / duty`` (so the mean load is the STAs' own echo
    rate, ``1e6 / interval_us[1]`` per s), ON periods :data:`BURST_ON`,
    OFF mean :data:`BURST_OFF_MEAN_S`, from the program's start times,
    the AP pinned to its beacons."""
    mean_on = bounded_pareto_mean(*BURST_ON)
    duty = mean_on / (mean_on + BURST_OFF_MEAN_S)
    sta_rate = 1e6 / float(prog.interval_us[1])
    tp = TrafficProgram.onoff(
        prog.n, sta_rate / duty, horizon_us=prog.sim_end_us, on=BURST_ON,
        off_mean_s=BURST_OFF_MEAN_S, start_us=prog.start_us,
        tr_seed=BURST_TR_SEED,
    )
    return _pin_beacons(tp, prog)


def toy_traffic_points(n: int, horizon_us: int, start_us=0,
                       beacon=None) -> list:
    """Eight workload-sweep points over ``n`` entities, shape-unified:
    cbr at 20 and 9 ms, mmpp at 60, 90 and 120 pps (seeds 0-2, 50 ms
    epochs), onoff at 150 pps peak (OFF means 0.1 and 0.2 s, seeds 0-1)
    and one deterministic trace of 24 arrivals per entity.
    ``beacon=(interval_us, start_us)`` pins entity 0 to cbr."""
    start = np.broadcast_to(np.asarray(start_us, np.int32), (n,)).copy()

    def pin(tp):
        if beacon is None:
            return tp
        return tp.with_cbr_rows(np.arange(n) == 0, beacon[0], beacon[1])

    pts = [pin(TrafficProgram.cbr(start, 20_000)),
           pin(TrafficProgram.cbr(start, 9_000))]
    for i in range(3):
        pts.append(pin(TrafficProgram.mmpp(
            n, 60.0 + 30.0 * i, horizon_us=horizon_us, epoch_s=0.05,
            start_us=start, tr_seed=i,
        )))
    for i in range(2):
        pts.append(pin(TrafficProgram.onoff(
            n, 150.0, horizon_us=horizon_us, on=(1.5, 0.05, 0.3),
            off_mean_s=0.1 + 0.1 * i, start_us=start, tr_seed=i,
        )))
    k = 24
    base = (np.linspace(0.08, 0.92, k)[None, :] * horizon_us
            + np.arange(n)[:, None] * 1771).astype(np.int64)
    sizes = (200 + 37 * (np.arange(n * k) % 29)).reshape(n, k)
    pts.append(pin(TrafficProgram.trace_replay(base, sizes)))
    return unify_shapes(pts)


def toy_as_program(n_nodes: int = 64, n_flows: int = 3, spf_rounds: int = 16,
                   seed: int = 1) -> AsFlowsProgram:
    """A BRITE BA graph with ``n_flows`` low-to-high-id CBR flows of 100
    kbit/s (``tpudes/parallel/programs.py:139-159``)."""
    g = BriteTopologyHelper(model="BA", n=n_nodes, m=2, seed=seed).Generate()
    return AsFlowsProgram(
        n=g.n, edges=g.edges, delay_s=g.delay_s, rate_bps=g.rate_bps,
        src=np.arange(1, 1 + n_flows, dtype=np.int32),
        dst=np.arange(g.n - n_flows, g.n, dtype=np.int32),
        flow_bps=np.full(n_flows, 1e5), pkt_bytes=512, sim_s=1.0,
        max_hops=16, spf_rounds=int(spf_rounds))
