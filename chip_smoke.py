"""Smoke run of tpudes_torch on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-with DIR   # DIR's kernels vs this one

Drives the port's paths — the WiFi BSS replica engine
(``tpudes_torch.parallel.replicated.run_replicated_bss``) on
``bench.py::bench_wifi``'s program (an AP and 64 STAs, 802.11a at 54
Mbit/s, UDP echo every 100 ms, 512 replicas x 2 s), on
``bench_wifi_ht``'s (the same BSS under 802.11n at HtMcs7, every 10 ms,
A-MPDUs of up to 64 answered by a BlockAck) and on a four-point horizon
sweep of each (``sim_end_us=[...]``), and the LTE SM engine
(``tpudes_torch.parallel.lte_sm.run_lte_sm``) on the lena hex grid at
bench width (7 eNB x 30 UE/cell = 210 UE, 64 replicas): full buffers,
static and with the UEs moving (const_velocity at 10 m/s, geometry
refreshed every 8 TTIs, ``bench.py::bench_lte_mobility``'s
configuration), finite backlogs under the ON-OFF workload of the
reference's LTE traffic test, the nine-scheduler sweeps, f32 and bf16 —
and holds its CUDA kernels against their plain PyTorch versions:
``lte_sm_advance`` (many TTIs per launch, coins drawn inside;
``run_lte_sm``'s path) in its arms — static rows, the dynamic rows of a
geometry table (mobility), the config sweep (one scheduler id per grid
row), finite backlogs filled from an offered-bits table (traffic) and
bf16 — and ``lte_sm_step`` (one TTI per launch; the single-step route,
``build_sm_step``), f32 and bf16; and ``bss_advance`` (the BSS event
loop, every step of a chunk in one persistent launch;
``run_replicated_bss``'s path) in its arms — legacy, ``AGG`` (A-MPDUs),
the ``(C, R)`` grid of a horizon sweep, ``MOB`` (``bench.py::
bench_mobile_bss``'s drifting STAs, the geometry rebuilt in the kernel
every 8 steps), ``TRF`` (``bench_traffic_burst``'s ON-OFF workload on
bench_wifi's BSS) and the traffic grid (eight workload points, 8 x 512
CTAs).  Phases, in order; any failure exits non-zero and no phase
carries on past one:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``tpudes_torch/csrc`` (``nvcc``, one process
   per source, all started together);
3. each kernel and arm vs its plain version on the card at E=7, U=210,
   R=64 from random states made with numpy from a seed, for every
   scheduler id: all state arrays bit-equal (``lte_sm_advance`` over
   two launches, the second from where the first ended; the dynamic arm
   on a stride-8 table of the moving drop, its second launch starting
   mid-stride; the sweep arm as one launch of all nine ids, on the static
   rows and on the stride-8 table; the traffic arm over two launches on
   the full-width offered table from warm backlogs, and for sid 0 one
   launch per TTI, counting the UE-TTIs the backlog gate held back; bf16
   on the static rows over two launches, and as one sweep launch on the
   stride-8 table and with traffic; the f32 sweep with traffic;
   ``lte_sm_step`` f32 and bf16; retransmissions and drops occur in
   every check); each one's time per launch on the card (CUDA events)
   and the host's, and its bound; then ``bss_advance`` vs the plain loop
   on the card at bench width (64 STAs, 512 replicas, 2 s), legacy and
   (3g-ht) 802.11n: the whole per-replica state, the step count and the
   pending flags bit-equal, for one launch and for two launches split
   at a step boundary (the plain loop's wall there is the measurement
   the choice of a persistent kernel rests on), the plain loop's census
   (a partially decoded A-MPDU and a retry-limit drop required; the
   replica-steps with three or more same-µs winners printed); a small
   BSS program of each through the plain loop on the CPU against the
   kernel on the card; and the horizon sweep of each, 1.25/1.5/1.75/2 s
   x 512 replicas, one grid launch against the plain grid loop and
   against each point's own launch; then (3h) the ``MOB`` arm on
   ``bench_mobile_bss``'s program, ``TRF`` on the ON-OFF program, the
   traffic grid of the eight workload points (8 x 512) and all three
   composed under 802.11n, at 512 replicas x 2 s (the grid x 1.25 s,
   the composed x 1.5 s, ``BSS_ARM_CHECK_S``): the whole state
   (``geom_t`` too), the step counts and the pending flags bit-equal to
   the plain loop over one launch and over two split mid-stride, the
   grid also against each point's own launch, a small program of each
   through the plain loop on the CPU against the kernel on the card; then
   (3p) the stage probe of ``bss_advance`` (its profiling instantiation,
   ``bss_cuda.bss_profile``) on legacy, ``AGG``, ``MOB`` and ``TRF`` at
   bench width: its state bit-equal to the main launch's, and the mean
   cycles a replica-step spends in each stage, beside the SM clock;
4. the slice through the plain loop and through the kernel, both on the
   card, 64 replicas x 500 TTIs, static, moving and with traffic:
   integer outputs (and backlogs) equal; a small program of each through
   the plain loop on the CPU against the kernel (the moving one fed the
   CPU's geometry table, the traffic one the CPU's offered table); and
   the count of entries in which the card's geometry table and offered
   table for the whole horizon differ from the CPU's;
5. each path at bench depth, 64 replicas x 10,000 TTIs, its launch
   counts reset just before and read just after: the single-step route
   (``lte_sm_step`` once per TTI), the static main path (``run_lte_sm``,
   ``lte_sm_advance`` once per chunk, the whole horizon by default), the
   mobile main path (the dynamic arm once per chunk), the sweep of all
   nine scheduler ids on the moving drop (one launch per chunk of 9 x 64
   CTAs), the traffic main path (the offered table and the traffic arm
   once per chunk) at the reference's peak, which overloads the cells,
   and again at a peak near what they carry, each run again one launch
   per TTI to the same state to count the UE-TTIs the backlog gate held
   back, the traffic path's nine-point sweep, and in bf16 the static
   path, the moving drop, its sweep and the single-step route; the
   card's busy share over profiled runs (``torch.profiler``); and
   ``bench_wifi`` and ``bench_wifi_ht``: the BSS main path, one warm run
   and five timed runs on keys 1..5, each one launch, every replica
   done; and the four-point horizon sweep of each at 512 replicas, one
   grid launch a run (``sim_s_per_wall_s`` summed over the points);
   then (5m) ``bench_mobile_bss`` (``wall_vs_static`` against the
   static run in the same call, ``geom_refreshes``), (5t) the ON-OFF
   bench (``stage_overhead`` and ``burst_overhead`` as
   ``bench_traffic_burst`` defines them, the cbr workload's outputs
   equal to ``traffic=None``'s) and (5w) the workload sweep, each one
   launch a run, every replica done;
6. one JSON line with every kernel arm's numbers, then the result line.

Then the TCP dumbbell engine (``tpudes_torch.parallel.tcp_dumbbell.
run_tcp_dumbbell``, BASELINE config #2) and its kernel ``tcp_advance``
(the slot loop, every slot of a chunk in one persistent launch): in
phase 3t, after 3p, at 256 replicas x 2 s, ``bench.py::bench_tcp``'s
program (8 TcpCubic flows), ``bench_tcp_variant_sweep``'s (17 flows,
one per variant, 13 Mbit/s), a RED/ECN program (DCTCP and non-ECT
NewReno flows; CE marks and early drops required) and a four-point
``variants=[...]`` grid of bench_tcp's flows: the whole state bit-equal
to the plain loop on the card over one launch and over two split at a
slot boundary, the grid also per point; a small program of each through
the plain loop on the CPU against the kernel on the card; the launch's
µs per slot beside its bound and the plain loop's wall; the kernel's
branch-free division against ``__fdiv_rn`` on 2^30 pairs; the stage probe
(``tcp_cuda.tcp_profile``) on bench_tcp's, the 17-variant and the RED
programs: its state bit-equal to the main launch's, the cycles a
row-slot spends in each stage and their sum, the slot's chain floor;
and in phase
5tcp, after 5w, ``bench_tcp`` and ``bench_tcp_variant_sweep`` at 256
replicas x 20 s (one warm run, five timed runs on keys 1..5, one launch
each, the busy share; ``vs_scalar`` needs the host DES, which the port
does not have).  The dumbbell's app-limited arm (``TRF``: ``prog.traffic``
and ``traffic_sweep=[...]``): in phase 3w, after the probe, bench_tcp's
flows each app-limited by an ON-OFF workload (:data:`TCP_TRF_ONOFF`) and
the eight toy workload points as one 8 x 256 grid, at 256 rows x 1 s
(:data:`TCP_TRF_CHECK_S`), the whole state bit-equal to the plain loop
over one launch and over two, the grid per point against each workload's
own launch, the clip binding; and in phase 5trf, after 5tcp, the
app-limited bench at 256 x 20 s (one warm run, five timed runs) and the
grid once, counted.

Then the fused WiFi PHY window (``tpudes_torch.parallel.kernels``:
``wifi_phy_window``, ``replicated``, ``multi_window_scan``) and its
kernel ``wifi_window`` at BASELINE.md's round-1 row #3 shape (65 nodes x
512 replicas x 256 windows, ``make_replica_batch``'s layout from the
port's own draws, every OFDM and HT mode, 1,000 B frames, tx_prob 0.25):
in phase 3win, after 3w, the scan's totals against the plain scan over
all 256 windows, the scan's geometry kernel bit-equal in ``rx_w`` and
``det``, the window at the same width (NIST and table) bit-equal in
``ok``, ``sinr`` and ``rx_dbm``, the graft entry's shape
(``__graft_entry__.py:29-38``) on the card against the CPU, each
launch's device time, bound and pair evaluations a second; and in phase
5win, after 5trf, the scan (its geometry and scan kernels) and the
window (NIST, table) each once, counted.

Then the AS flow engine (``tpudes_torch.parallel.as_flows.run_as_flows``,
BASELINE config #5) and its kernels ``as_spf`` (the Bellman-Ford rounds
over a frontier, the next hops and the paths' walk, a CTA a destination
row) and ``as_fluid`` (the replica's draws, the fluid fixed point and the
delays, a CTA a replica) at ``bench.py::bench_as``'s shape
(``scenarios.as_program(10_000, 128, 10.0, seed=3)``, 1,024 replicas):
in phase 3as, after 3win, ``as_spf`` bit-equal to ``spf_math`` and
``walk_math`` (the tables, ``path``, ``hops``, ``reached``) for the hop
metric, the delay metric and 3 rounds (flows left unreachable), its rows
in shared and in device memory; ``as_fluid`` bit-equal to
``as_replica_draws`` and ``fluid_math`` (``z`` and the outputs) for the
bench program, a four-point rate-scale grid whose top points overload
links, an ON-OFF workload and one round a launch; a toy program through
the plain path on the CPU against the kernels on the card; each kernel's
device time, bound and plain wall; and in phase 5as, after 5win,
``bench_as``'s numerator (one warm run, five timed runs on keys 1..5,
each one ``as_spf`` and one ``as_fluid`` launch; ``studies_per_s``, the
busy share, the device operations of a run, the stages of a run apart)
and the grid once, counted.

Then the wired engine (``tpudes_torch.parallel.wired.run_wired``) and the
hybrid PDES (``tpudes_torch.parallel.hybrid.run_hybrid``) and their kernel
``wired_advance`` (every (lane, replica) row's slot loop, a warp a row on
its own clock, its list and link queues in shared memory, a lookahead
window of slots a round, in one launch a window): in phase 3wired, after
3as, the
kernel bit-equal to ``advance_math`` at 1,024 replicas x 5,535 packets
over 2,000 slots (the plain loop's horizon; one launch, two launches but
the egress, a zero-step window) for bench_wired's whole engine and for a
uniform four-lane chain (the space kernel at full width); bench_wired's
own 20,000-slot launch timed with its bound; then the main path's hybrid
launches held against the plain loop as they run: every launch of
bench_hybrid (a) at k = 4 and each split rank's first windows (peer
ingress included), window 40 of each timed beside its plain wall and
bound, and the kernel's stage probe on bench_wired's launch and the
split's rank 3 at window 40 (about 45 s, the plain loops most of it);
in phase 5wired, after 5as, bench_wired (``wired_chain(64, 64, period=200,
n_slots=20_000, jitter_slots=5)`` x 1,024 replicas, a warm run and five
timed runs, each one counted launch; about 2 s) and in phase 5hyb
bench_hybrid: (a) ``bench.py:1178``'s weak-scaling row (k = 1, 2, 4 lanes,
``transport="batched"``, 600-slot windows, one replica; paired rounds)
and (b) the bench chain split four ways at 1,024 replicas,
``transport="local"``, equal to ``run_wired`` (about 11 s together).

Then the engine runtime and the StudyServer over it
(``tpudes_torch.parallel.runtime``, ``tpudes_torch.serving``), after 5hyb:
phase 5srv serves each bench program's studies that differ only in their
sweep operand (four LTE schedulers on bench_lte's program, four BSS
horizons on bench_wifi's, eight variant assignments on bench_tcp's, the
four AS load scales on bench_as's) as one batch each, one counted launch
of the kernel's sweep arm (``RUNTIME`` counting the same), every study
bit-equal to its solo run, in ``pump`` mode and through the scheduler
thread, then runs ``bench.py:988`` bench_serving_closed_loop's row at its
own size with its chaos phase; phase 5rt times each of the six entries'
first call after ``RUNTIME.clear()`` (a miss) against five hits (each
bit-equal to the miss), lists the synchronising calls of a
``block=False`` hit (PyTorch's sync debug mode), runs ``bench.py:924``
bench_pipeline_overlap's row and submits a run behind a sleep kernel (not
done, its result equal); phase 5ckpt kills bench_tcp after the second of
four checkpointed chunks and resumes it, bit-equal.

With ``--compare-with DIR`` it runs only phases 1 and 2 and then
:func:`compare_main`: an earlier design of the BSS kernel
(``DIR/bss_advance.cu``, the same C interface and probe), of the TCP
kernel (``DIR/tcp_advance.cu``, the same C interface), of the window
(``DIR/wifi_window.cu``) and the first AS design's kernels
(``DIR/as_flows.cu``, through that design's C interface kept here) and
the first wired design (``DIR/wired_advance.cu``, through its C
interface kept here, with a ``PROF`` instantiation), each where DIR holds it,
against this checkout's in one call, their outputs equal, their times
taken in turns and both stage probes run.

Needs CUDA, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and the
repository beside this file; imports nothing of JAX or ``tpudes``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

#: the script's start, for the wall it prints before its kernels line
STARTED = time.monotonic()

SEED = 20261016
E, UES_PER_CELL, R = 7, 30, 64
CHECK_TTIS = 500
BENCH_TTIS = 10_000
#: TTIs per launch on the main paths (None: the whole horizon)
BENCH_CHUNK = None
#: lte_sm_advance's check: two launches from TTI ADVANCE_T0 on
ADVANCE_T0, ADVANCE_LAUNCHES = 1000, (60, 80)
#: the dynamic arm's check: two launches, the second from mid-stride
DYNAMIC_LAUNCHES = (61, 80)
#: the moving drop (bench.py::bench_lte_mobility)
MOBILE_STRIDE, MOBILE_SPEED = 8, 10.0
#: TTIs per timed lte_sm_advance launch (the plain loop times the same)
TIMED_TTIS = 1000
#: TTIs per timed sweep launch: the plain loop runs the nine points one
#: after another
SWEEP_TIMED_TTIS = 200
#: calls per timed run: the plain core queues ~60 launches a call, so
#: fewer calls keep its run inside the CUDA launch queue
TIMED_KERNEL_CALLS, TIMED_PLAIN_CALLS = 200, 10
TIMED_ADVANCE_CALLS = 20
#: timed runs per wall figure of a path at bench depth (the median)
WALL_RUNS = 3
#: share of the CQI, MCS and eligibility entries of the horizon's
#: geometry table that may differ between the card and the CPU; both
#: run the same IEEE operations, so none is expected (the offered-bits
#: table may differ in no entry)
TABLE_DIFF_MAX_SHARE = 1e-4
#: H100 SXM rates: HBM bytes/s and f32 operations/s outside the tensor
#: cores (NVIDIA's data sheet); int32 operations/s = 132 SMs x 64 INT32
#: lanes (Hopper architecture white paper) x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: lte_sm_advance's integer work per UE-TTI: the coin (threefry2x32's 72
#: operations, 3 more to make the float), which a replica's config
#: points share, and the admission scan (5) of every lane; f32: the
#: metric, TB bits, BLER (erfcf counted as 20), decode and EMA
COIN_OPS_PER_UE_TTI, SCAN_OPS_PER_UE_TTI = 75, 5
F32_OPS_PER_UE_TTI = 45
#: and the coin's per replica-TTI: fold_in(key, t), one threefry2x32
COIN_OPS_PER_REPLICA_TTI = 72
#: an upper bound on the SM clock (H100 boost 1.98 GHz), so a sleep of
#: ``s * SLEEP_CYCLES_PER_S`` cycles lasts at least ``s`` seconds
SLEEP_CYCLES_PER_S = 2.0e9
INT_KEYS = ("rx_bits", "new_tbs", "retx", "drops", "ok", "cqi", "mcs")
TRAFFIC_KEYS = INT_KEYS + ("goodput_bits",)
#: the ON-OFF peak of the near-capacity traffic run: its mean offered
#: load, about 12.1 Mbit/s per replica, is a little below the 13.0
#: Mbit/s the full-buffer drop delivers (PERF.md), where the reference's
#: peak of 50 pps offers 5.8 times that
NEAR_CAPACITY_PPS = 8.0
#: bench.py::bench_wifi (``:91-93``, ``:114-161``): STAs, replicas,
#: simulated seconds, timed runs (keys 1..5 after a warm run on key 0)
BSS_N_STAS, BSS_R, BSS_SIM_S, BSS_TIMED_RUNS = 64, 512, 2.0, 5
#: bench.py::bench_wifi_ht (``:94-95``, ``:169-180``): the same BSS under
#: 802.11n, 512 B every 10 ms per STA at HtMcs7, A-MPDUs of up to 64
BSS_HT = dict(interval_s=0.01, data_mode="HtMcs7", standard="80211n")
#: the key of the kernel-vs-plain checks
BSS_CHECK_SEED = 7
#: launches per timed bss_advance run (each a whole horizon)
BSS_TIMED_CALLS = 5
#: the horizon sweep's points (s), each at BSS_R replicas
BSS_SWEEP_S = (1.25, 1.5, 1.75, 2.0)
#: bss_advance's least work: per replica-step three threefry hashes (the
#: replica's fold-in and the split; the step's fold-in is shared) and
#: about 25 int32 operations per node (the transmit instant, the
#: reductions, arrivals and updates); per data frame two more hashes
#: (its coin, its redraw) and the PSR chain in f32 (erfc, log, ten
#: exp terms, log1p, exp: about 350 operations).  Under AGG a data
#: frame draws no coin of its own: one hash per frame (its redraw) and
#: one per subframe of a gated frame; the PSR chain is needed once per
#: gated frame with another on the air and once per link for the
#: lone-sender table (2 N a CTA); every gated frame takes the
#: k-dependent tail (its airtime, nbits, two products, a division and
#: exp: about 30 operations)
THREEFRY_OPS = 72
BSS_NODE_OPS = 25
BSS_PSR_OPS = 350
BSS_TAIL_OPS = 30
#: bench.py::bench_mobile_bss (``:241-322``): bench_wifi's BSS, the STAs
#: drifting tangentially at 1 m/s, the geometry rebuilt every 8 steps
BSS_MOBILE = dict(mobility="const_velocity", speed=1.0, geom_stride=8)
#: the horizon (s) of the arm checks whose plain loop is longest (phase
#: 3h): the composed program runs 1.5 s, the workload sweep (8 x 512,
#: whose plain loop took 134.6 s at 1.5 s) 1.25 s, so that the script
#: ends well inside its time limit; their benches run the full 2 s
BSS_ARM_CHECK_S = {"sweep": 1.25, "composed": 1.5}
#: the MOB and TRF arms' work: per refresh each node's position (about
#: 10 f32 operations), its link to the AP (the distance, the compiled
#: log and the loss, about 45 f32 operations, and glibc's exp2 in f64,
#: about 12) and its lone-sender chain (BSS_PSR_OPS); in a step where
#: the AP sends data each winner's link to its destination.  Per gap drawn: mmpp three
#: threefry hashes and about 30 f32 operations (log1p, a division, the
#: rounding), onoff 2 C int32 operations (its cycle's count) and the
#: same 30 f32, trace 2 K int32 (its entry's count), cbr a load
MOB_POS_OPS, MOB_LINK_F32_OPS, MOB_LINK_F64_OPS = 10, 45, 12
GAP_F32_OPS = 30
#: H100 SXM f64 operations/s outside the tensor cores (NVIDIA's data sheet)
F64_OPS_PER_S = 34e12
#: the kernels line's source and replaced code of bss_advance's arms
BSS_SOURCE = "tpudes_torch/csrc/bss_advance.cuh"
BSS_REPLACES = ("tpudes/parallel/replicated.py:1155 (lax.while_loop over "
                "build_bss_step.step_fn; XLA, no pallas_call)")
#: the stage probe's arms (phase 3p): (arm, its program in
#: bss_programs / bss_arm_programs), each at bench width
BSS_PROBE_ARMS = (("legacy", "legacy"), ("agg", "ht"), ("mobile", "mobile"),
                  ("traffic", "onoff"))
#: the programs the compare mode (``--compare-with``) times old against
#: new, in turns: bench_wifi, bench_wifi_ht, the mobile and ON-OFF
#: benches, the workload grid (8 x 512 x 2 s), the 802.11n horizon grid
#: (4 x 512), the composed program and bench_wifi's BSS at
#: BSS_LARGE_STAS STAs (N = 256: 8 slots a lane, held in local memory)
BSS_COMPARE = ("legacy", "ht", "mobile", "onoff", "sweep", "ht_sweep",
               "composed", "large")
BSS_LARGE_STAS = 255
#: bench.py::bench_tcp and bench_tcp_variant_sweep (``:102-111``,
#: ``:780-826``, ``:1343-1391``): replicas, simulated seconds, timed runs
#: (keys 1..5 after a warm run on key 0)
TCP_R, TCP_SIM_S, TCP_TIMED_RUNS = 256, 20.0, 5
#: the kernel-vs-plain checks' horizon (s) and key (phase 3t)
TCP_CHECK_S, TCP_CHECK_SEED = 2.0, 7
#: launches per timed tcp_advance run (each the check's whole horizon)
TCP_TIMED_CALLS = 5
#: the four points of the variant grid check: bench_tcp's eight flows as
#: Cubic, NewReno, the first eight variants and DCTCP/BBR pairs
TCP_GRID = (("TcpCubic",) * 8, ("TcpNewReno",) * 8,
            ("TcpNewReno", "TcpCubic", "TcpScalable", "TcpHighSpeed",
             "TcpVegas", "TcpVeno", "TcpLinuxReno", "TcpBic"),
            ("TcpDctcp", "TcpBbr") * 4)
#: tcp_advance's least work: per slot one threefry hash (the slot's key,
#: which every replica shares); per replica-slot two (its own key and its
#: departure draw; under RED six: its key, the split's three keys and the
#: departure and mark draws) and under RED one per flow (its early-drop
#: draw); per flow-slot about 70 f32 operations (the estimators, the
#: increase, the departure and the admission) and 40 int32 operations
#: (the counters, the warp sums and the scan); under RED a powf per
#: row-slot (about 40 f64 operations)
TCP_HASHES, TCP_RED_HASHES = 2, 6
TCP_FLOW_F32_OPS, TCP_FLOW_INT_OPS, TCP_RED_F64_OPS = 70, 40, 40
TCP_SOURCE = "tpudes_torch/csrc/tcp_advance.cu"
TCP_REPLACES = ("tpudes/parallel/tcp_dumbbell.py:1199 (lax.while_loop over "
                "build_dumbbell_step.step_fn; XLA, no pallas_call)")
#: pairs the fast-division check holds against __fdiv_rn (phase 3t;
#: compare mode)
TCP_DIV_PAIRS = 1 << 30
#: the stage probe's programs (phase 3t; compare mode), each at TCP_R x
#: TCP_CHECK_S, and the compare mode's programs, each at TCP_R x TCP_SIM_S
TCP_PROBE_PROGRAMS = ("bench_tcp", "variants17", "red")
TCP_COMPARE = ("bench_tcp", "variants17")
#: the RED program of the checks: DCTCP and non-ECT NewReno flows over a
#: RED queue that marks ECT packets (tests/test_ecn_dctcp.py's shape)
TCP_RED = dict(MinTh=5.0, MaxTh=15.0, MaxSize=1000, UseEcn=True,
               UseHardDrop=False)
#: the app-limited bench (phases 3w and 5trf): bench_tcp's eight flows,
#: each app-limited by an ON-OFF workload whose mean offered rate is about
#: 0.8 of a flow's 156.25 pkt/s share, its bursts above it; the clip per
#: flow-slot (a load, a difference and a min/max: int32 operations); the
#: TRF checks' horizon (s), shorter than the bench's to bound the plain
#: loop's wall
TCP_TRF_ONOFF = dict(peak_pps=250.0, on=(1.5, 0.2, 5.0), off_mean_s=0.5,
                     tr_seed=0)
TCP_TRF_INT_OPS = 4
TCP_TRF_CHECK_S = 1.0
#: the fused PHY window (phases 3win and 5win) at BASELINE.md's round-1
#: row #3 shape (``tpudes/parallel/mesh.py:112-130``): nodes, replicas,
#: windows, the Bernoulli tx probability, the frame size, the square's
#: side (m) and the batch's seed; the SINR of a pair whose SINR the
#: function needs (the column sum less the pair's power, the noise added,
#: the division: f32 operations)
WIN_N, WIN_R, WIN_W = 65, 512, 256
WIN_TX_PROB, WIN_FRAME_BYTES, WIN_SPREAD, WIN_SEED = 0.25, 1000.0, 50.0, 0
WIN_SINR_F32_OPS = 3
WIN_SOURCE = "tpudes_torch/csrc/wifi_window.cu"
#: the SASS opcodes whose counts the build prints for each window kernel
#: (``cuobjdump -sass``): the conversions, which run at 16 a clock an SM,
#: the f64 arithmetic, the f32 compares of the f64 chain's range test, and
#: the branches and calls
SASS_OPS = ("F2F", "F2I", "I2F", "FRND", "MUFU", "DFMA", "DADD", "DMUL",
            "DSETP", "DMNMX", "FSETP", "BRA", "CALL")
#: the window's launches a timed run of :func:`timed_ms` holds (the scan's,
#: the window's)
WIN_SCAN_CALLS, WIN_WINDOW_CALLS = 3, 10
#: the triples of random bits and of constructed double-rounding ties on
#: which :func:`window_fma_check` holds the window's multiply-add over f64
#: registers against ``xla_math::fma32``
WIN_FMA_TRIPLES, WIN_FMA_TIES = 1 << 28, 1 << 24
WIN_REPLACES = ("tpudes/parallel/kernels.py:56 (wifi_phy_window, vmapped "
                "by replicated :107 and scanned by multi_window_scan :120; "
                "XLA, no pallas_call)")

#: the AS flow engine (phases 3as and 5as) at bench.py::bench_as's shape
#: (``:1395-1431``, ``:106-111``): a 10,000-node BRITE BA graph, 128 CBR
#: flows of 400 kbit/s, 1,024 replicas, ``sim_s`` 10 (the graph's and the
#: flows' seed 3); the key of the kernel-vs-plain checks; the Bellman-Ford
#: rounds of the truncated check (fewer than the graph's hop diameter); the
#: rate-scale grid, whose upper points overload links (the bench's busiest
#: link runs at about 1 % of its capacity); the ON-OFF workload of the
#: checks (a peak of twice the flows' 97.66 pkt/s)
AS_NODES, AS_FLOWS, AS_R, AS_SIM_S, AS_SEED = 10_000, 128, 1024, 10.0, 3
AS_CHECK_KEY, AS_TRUNCATED_ROUNDS, AS_TIMED_RUNS = 7, 3, 5
AS_SCALES = (1.0, 10.0, 100.0, 1000.0)
AS_ONOFF = dict(peak_pps=195.3125, on=(1.5, 0.2, 5.0), off_mean_s=0.5,
                tr_seed=3)
#: launches per timed run of :func:`timed_ms` (as_spf, as_fluid)
AS_SPF_CALLS, AS_FLUID_CALLS = 10, 10
#: f32 and f64 operations of xla_math.cuh's exp and log (each fma32 is one
#: f64 fused multiply-add: 9 in exp, 10 in log; the range reduction,
#: clamps and products around them in f32)
AS_EXP_OPS, AS_LOG_OPS = (10, 9), (12, 10)
#: the draw's erf_inv (fused.erf_inv: log1p's rational, two degree-6
#: polynomials and a division, or a log; the degree-8 polynomial in w;
#: the square root, the products and the clamps), f32 and f64
AS_ERFINV_OPS = (12, 22)
AS_SOURCE = "tpudes_torch/csrc/as_flows.cu"
AS_SPF_REPLACES = ("tpudes/parallel/as_flows.py:227 (device_spf: the "
                   "lax.scan of Bellman-Ford scatter-min rounds :253-257 "
                   "and the next-hop scatter :260-266; and _walk_paths "
                   ":270; XLA, no pallas_call)")
AS_FLUID_REPLACES = ("tpudes/parallel/as_flows.py:309 (_fluid_round, and "
                     "_fluid_delay :358, in the while_loop :485-518; and "
                     "_as_replica_draws :633; XLA, no pallas_call)")
#: bench_wired: wired_chain(64 links, 64 flows, period 200, 20,000 slots
#: of 1 ms, jitter 5) at 1,024 replicas (5,535 packets a replica, 34.9 hops
#: each), one warm run on key 0 and five timed runs on keys 1..5; the
#: checks' horizon for the plain loop (the kernel's width never cut)
WIRED_BENCH = dict(n_links=64, n_flows=64, period=200, n_slots=20_000,
                   jitter_slots=5)
WIRED_R, WIRED_TIMED_RUNS, WIRED_CHECK_SLOTS = 1024, 5, 2_000
#: bench_hybrid part (b): the bench chain split four ways (ragged: 1,613 /
#: 3,037 / 4,365 / 5,535 resident packets, lookahead 242); the space
#: kernel's full-width check, a uniform four-way chain of 5,535 packets a
#: lane
WIRED_SPLIT = dict(WIRED_BENCH, ranks=4, boundary_delay=240)
WIRED_LANES = dict(links_per_rank=16, flows_per_rank=16, period=36,
                   cross_period=80, n_slots=20_000, boundary_delay=240,
                   jitter_slots=5)
#: the main path's hybrid launches held against the plain loop: each
#: split rank's priming advance and first WIRED_HELD_WINDOWS windows (every
#: launch of bench_hybrid (a)), and window WIRED_TIMED_WINDOW of each,
#: which is also timed
WIRED_HELD_WINDOWS, WIRED_TIMED_WINDOW = 3, 40
#: bench_hybrid part (a), bench.py:1178 bench_hybrid_weak_scaling's row:
#: wired_weak_chain(k, 2 links a rank, period 3573, 108,000 slots, boundary
#: delay 600, cross period 8793), transport "batched", window_slots 600,
#: one replica, key 7, k = 1, 2, 4 in turns for HYBRID_PAIRS rounds
HYBRID_WEAK = dict(links_per_rank=2, period=3573, n_slots=108_000,
                   boundary_delay=600, cross_period=8793)
HYBRID_WINDOW, HYBRID_RANKS, HYBRID_PAIRS, HYBRID_KEY = 600, (1, 2, 4), 9, 7
#: part (b)'s timed runs after a warm one
HYBRID_SPLIT_RUNS = 3
#: the least integer work of one service: the head's key compare, the
#: link's free compare, arrival and free sums, the served and hop
#: increments, the last-hop compare, the next link's owner read and test,
#: the state's two writes
WIRED_SERVE_OPS = 11
WIRED_SOURCE = "tpudes_torch/csrc/wired_advance.cu"
WIRED_REPLACES = ("tpudes/parallel/wired.py:578 (build_wired_advance: the "
                  "lax.while_loop :700-836 over _make_lane_step.step :529; "
                  "XLA, no pallas_call)")
WIRED_LANES_REPLACES = ("tpudes/parallel/wired.py:841 "
                        "(build_wired_space_advance: the step vmapped over "
                        "rank lanes; XLA, no pallas_call)")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def sm_clock_line() -> str:
    """The card's SM clock now and its maximum (MHz), as nvidia-smi reads
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(name: str, text: str) -> list:
    """ptxas's registers, shared memory and spills for each kernel
    instantiation of a build log, the instantiation named by its
    template arguments (``bss_advance_kernel<3,1,0,0,0>``: slots, AGG,
    MOB, TRF, PROF)."""
    out, entry = [], name
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = re.search(r"\d+([a-z][a-z_]*_kernel)I((?:L[a-z]+\d+E)+)E",
                           m.group(1))
            entry = (f"{fn.group(1)}<"
                     + ",".join(re.findall(r"L[a-z]+(\d+)E", fn.group(2)))
                     + ">") if fn else m.group(1)
        elif "registers" in line or "spill" in line:
            out.append(f"  {name} {entry}: {line.split(':', 1)[-1].strip()}")
    return out


def sass_counts(path) -> dict:
    """``{kernel: {opcode: count}}`` of the static SASS of a built library
    (``cuobjdump -sass``), each kernel named as :func:`ptxas_lines` names
    it; an opcode counts under its name before the first dot, and the
    ``F2F`` conversions also under their full names.  Empty where the
    toolkit has no ``cuobjdump``."""
    from tpudes_torch import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300)
    counts, name = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = ([None] + list(re.finditer(
                r"\d+([a-z][a-z_]*_kernel)(I\w*E)?", m.group(1))))[-1]
            name = (fn.group(1) + ("<" + ",".join(re.findall(
                r"L[a-z]+(\d+)E", fn.group(2))) + ">" if fn.group(2) else "")
                    if fn else m.group(1))
            counts[name] = {}
            continue
        m = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            line)
        if m and name is not None:
            op = m.group(1)
            c = counts[name]
            c[op.split(".")[0]] = c.get(op.split(".")[0], 0) + 1
            if op.startswith("F2F."):
                c[op] = c.get(op, 0) + 1
            c["all"] = c.get("all", 0) + 1
    return counts


def sass_lines(name: str, path) -> list:
    """One line a kernel of :func:`sass_counts`: the :data:`SASS_OPS`
    counts, the ``F2F`` split by direction, and all instructions."""
    out = []
    for kernel, c in sass_counts(path).items():
        f2f = ", ".join(f"{k} {v}" for k, v in sorted(c.items())
                        if k.startswith("F2F."))
        out.append(f"  {name} {kernel}: SASS "
                   + ", ".join(f"{k} {c.get(k, 0)}" for k in SASS_OPS)
                   + (f" ({f2f})" if f2f else "")
                   + f", {c.get('all', 0)} instructions")
    return out or [f"  {name}: SASS not counted (no cuobjdump)"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def random_state(kc, consts, t, rng, device, lanes=None):
    """A warmed-looking state of ``lanes`` lanes (``R`` by default):
    every HARQ field populated."""
    import torch

    lanes = lanes or R
    U, n_rbg = consts["U"], consts["n_rbg"]
    count_c = consts["count_c"].cpu().numpy()
    u_i = lambda lo, hi: rng.integers(lo, hi, (lanes, U)).astype(np.int32)  # noqa: E731
    host = dict(
        avg=rng.uniform(1.0, 1e7, (lanes, U)).astype(np.float32),
        pend=u_i(0, 2),
        p_mi=rng.uniform(0.0, 1.0, (lanes, U)).astype(np.float32),
        p_tbb=np.floor(rng.uniform(0.0, 2e4, (lanes, U))).astype(np.float32),
        p_nrbg=u_i(1, n_rbg + 1),
        p_txc=u_i(1, 4),
        p_due=u_i(t - 8, t + 9),
        rr_ptr=(rng.integers(0, 1 << 20, (lanes, E)) % np.maximum(count_c, 1))
        .astype(np.int32),
        rx_lo=u_i(0, 1 << 20),
        rx_hi=u_i(0, 4096),
        new_tbs=u_i(0, 5000),
        retx=u_i(0, 500),
        drops=u_i(0, 50),
        ok_cnt=u_i(0, 5000),
    )
    return {k: torch.from_numpy(host[k]).to(device) for k, _, _ in kc.SM_STATE}


def traffic_state(kc, consts, t, rng, device, lanes=None):
    """:func:`random_state` with warm backlogs: a quarter of them empty,
    the rest up to 10^5 bits, and the drained counters populated."""
    import torch

    s = random_state(kc, consts, t, rng, device, lanes)
    shape = s["avg"].shape
    backlog = rng.uniform(0.0, 1e5, shape) * (rng.random(shape) > 0.25)
    host = dict(
        tr_backlog=backlog.astype(np.float32),
        tr_drained_lo=rng.integers(0, 1 << 20, shape).astype(np.int32),
        tr_drained_hi=rng.integers(0, 4096, shape).astype(np.int32),
    )
    s.update({k: torch.from_numpy(v).to(device) for k, v in host.items()})
    return s


def bits_of(x):
    import torch

    return x.view(torch.int32) if x.dtype == torch.float32 else x


def compare_states(kc, got, want, what, traffic=False) -> float:
    """Fail unless the 14 state arrays (and with ``traffic`` the three
    backlog arrays) are bit-equal; the largest absolute difference
    (0.0)."""
    import torch

    err = 0.0
    for k, _, _ in kc.SM_STATE + kc.TR_STATE * traffic:
        if not torch.equal(bits_of(got[k]), bits_of(want[k])):
            fail(f"{what}: {k} differs")
        err = max(err, (got[k].double() - want[k].double()).abs().max().item())
    return err


def timed_ms(fn, n, reps=5):
    """``(device_ms, host_ms)`` per call of ``fn``, medians over ``reps``
    runs of ``n`` back-to-back calls.

    ``host_ms`` is the host clock around a run that ends in a
    synchronise.  ``device_ms`` is one pair of CUDA events around a run
    queued behind a sleep kernel twice as long as that run's host time:
    the card starts the run only when all of it is queued, so the events
    time the card's work and not the host's enqueue."""
    import torch

    fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        host.append(host_s * 1e3 / n)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * host_s * SLEEP_CYCLES_PER_S))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        dev.append(a.elapsed_time(b) / n)
    return statistics.median(dev), statistics.median(host)


def device_busy_share(fn, kernel: str):
    """``(share, kernel_ms)``: the share of the host wall of ``fn()``
    during which the card ran a kernel or a copy, and the device time of
    the kernels whose name holds ``kernel`` (``torch.profiler``); None
    for what the profiler did not see."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    kernel_us = sum(getattr(e, "self_device_time_total", 0) for e in events
                    if kernel in e.key)
    return (busy_us / wall_us if busy_us > 0 else None,
            kernel_us / 1e3 if kernel_us > 0 else None)


def step_bound(consts, s, coin, out, t):
    """Least time for one step: bytes each input and output moves once
    over HBM, and the operations this state needs (the same-cell prefix
    runs only for due UEs) over the f32 rate; the larger wins."""
    U = consts["U"]
    nbytes = coin.nbytes + sum(v.nbytes for v in s.values())
    nbytes += sum(v.nbytes for v in out.values())
    nbytes += sum(
        consts[k].nbytes for k in ("mi0", "rate0", "eff0", "ecr0",
                                   "eligible", "pos", "count_u", "serving",
                                   "count_c")
    )
    due = ((s["pend"] != 0) & (s["p_due"] <= t)).cpu().numpy()
    prefix_ops = int((due * (np.arange(U) + 1)).sum())
    # per replica: two per-cell scans of U, ~40 f32 ops per UE of metric,
    # TB, BLER and update arithmetic
    ops = prefix_ops + R * (2 * consts["E"] * U + 40 * U)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def advance_bound(consts, s, keys, out, ttis, table=None, sids=None):
    """Least time for one ``lte_sm_advance`` launch over ``ttis`` TTIs:
    the keys, constant rows, geometry table (if any), scheduler ids and
    state read once and the state written once over HBM, against the
    integer and f32 work over each type's rate (the two pipes run side
    by side); the largest wins.  The coins are counted once per replica
    (every config point of a replica runs on its coins), the rest once
    per lane (replica x config point)."""
    U = consts["U"]
    replicas, lanes = keys.shape[0], s["avg"].shape[0]
    nbytes = keys.nbytes + sum(v.nbytes for v in s.values())
    nbytes += sum(v.nbytes for v in out.values())
    nbytes += sum(
        consts[k].nbytes for k in ("mi0", "rate0", "eff0", "ecr0",
                                   "eligible", "pos", "count_u", "serving",
                                   "count_c", "cell_order", "cell_start")
    )
    nbytes += sum(v.nbytes for v in (table or {}).values())
    nbytes += 0 if sids is None else sids.nbytes
    int_ops = ttis * (
        replicas * (U * COIN_OPS_PER_UE_TTI + COIN_OPS_PER_REPLICA_TTI)
        + lanes * U * SCAN_OPS_PER_UE_TTI
    )
    times = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "operations": max(int_ops / INT32_OPS_PER_S,
                          lanes * ttis * U * F32_OPS_PER_UE_TTI
                          / F32_OPS_PER_S) * 1e3,
    }
    by = max(times, key=times.get)
    return times[by], by


def step_route(prog, key, device):
    """The single-step route a caller drives: ``build_sm_step``'s step
    once per TTI on coins drawn a chunk of TTIs at a time; returns the
    final state."""
    from tpudes_torch.parallel import kernels_cuda as kc
    from tpudes_torch.parallel.lte_sm import build_sm_step
    from tpudes_torch.random import replica_keys, tti_coins

    _, init_state, step_fn = build_sm_step(prog, device)
    keys = replica_keys(key.to(device), R)
    state = init_state(R)
    chunk = max(1, kc.COIN_CHUNK_ELEMS // (R * prog.n_ue))
    for c0 in range(0, prog.n_ttis, chunk):
        c1 = min(c0 + chunk, prog.n_ttis)
        coins = tti_coins(keys, c0, c1, prog.n_ue)
        for i in range(c1 - c0):
            state = step_fn(state, coins[i], c0 + i)
    return state


def counted(kc, fn, want: dict, what: str):
    """``(result, wall_s, launches)`` of ``fn()`` with the launch counts
    reset just before and read just after; fails unless every count is
    ``want``'s (absent names: 0)."""
    import torch

    kc.reset_launches()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(kc.launches)
    expect = {k: want.get(k, 0) for k in launches}
    if launches != expect:
        fail(f"{what} launched {launches}, want {expect}")
    return out, wall, launches


def median_wall(fn) -> float:
    import torch

    walls = []
    for _ in range(WALL_RUNS):
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
    return statistics.median(walls)


def same_outputs(a: dict, b: dict, keys=INT_KEYS) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in keys)


def gate_census(kc, prog, key, device):
    """A traffic program's main-path run again, one ``lte_sm_advance``
    launch per TTI on the horizon's offered table, counting the UE-TTIs
    the backlog gate held back: an eligible UE whose backlog, the TTI's
    offered bits added, is empty.  ``(result, held, eligible UE-TTIs)``,
    the result in ``run_lte_sm``'s keys for the comparison with the main
    path."""
    import torch
    from tpudes_torch.random import fold_in, replica_keys
    from tpudes_torch.traffic.device import TRAFFIC_KEY_TAG, offered_table

    key = key.to(device)
    consts = kc.build_sm_consts(prog, device=device)
    keys = replica_keys(key, R)
    table = offered_table(prog.traffic.operands(device),
                          prog.traffic.epoch_us,
                          fold_in(key, TRAFFIC_KEY_TAG), 0, prog.n_ttis)
    elig = consts["eligible"] != 0
    sid = kc.SM_SCHED_IDS[prog.scheduler]
    s = kc.sm_init_state(prog.n_enb, prog.n_ue, R, device, traffic=True)
    held = torch.zeros((), dtype=torch.int64, device=device)
    for t in range(prog.n_ttis):
        held += ((s["tr_backlog"] + table[t] == 0) & elig).sum()
        s = kc.sm_advance_cuda(consts, s, keys, t, t + 1, sid,
                               offered=table[t:t + 1])
    h = {k: v.cpu().numpy().astype(np.int64) for k, v in s.items()
         if k != "tr_backlog"}
    out = dict(
        rx_bits=(h["rx_hi"] << 20) + h["rx_lo"],
        goodput_bits=(h["tr_drained_hi"] << 20) + h["tr_drained_lo"],
        backlog_bits=s["tr_backlog"].cpu().numpy(),
        new_tbs=h["new_tbs"], retx=h["retx"], drops=h["drops"],
        ok=h["ok_cnt"],
    )
    return out, int(held), R * prog.n_ttis * int(elig.sum())


def torch_floordiv(x, d: int):
    import torch

    return torch.div(x, d, rounding_mode="floor")


def bss_bound(consts, state, out, done, step0, census=None):
    """Least time for one ``bss_advance`` launch on these inputs: the
    state read once and written once and the constants read once over
    HBM, against the work the run's own steps and data frames need (the
    replica-steps it ran, ``done - step0`` summed, and its data frames,
    ``tx_data``'s growth; under AGG the plain loop's census of the same
    run: gated frames, their subframes and the overlapping ones) over
    each type's rate; the larger wins.  A mobile program adds its
    refreshes and links, a traffic one its gaps (:data:`MOB_POS_OPS`,
    :data:`GAP_F32_OPS`), from the census and the CTAs' stops."""
    n = consts["N"]
    nbytes = sum(v.nbytes for v in state.values())
    nbytes += sum(v.nbytes for v in out.values())
    nbytes += sum(consts[k].nbytes for k in ("rx_w", "det", "interval",
                                             "stop"))
    replica_steps = int((done.long() - step0).sum())
    frames = int((out["tx_data"] - state["tx_data"]).sum())
    int_ops = replica_steps * (3 * THREEFRY_OPS + n * BSS_NODE_OPS)
    f64_ops = 0
    if consts["K"] > 1:
        ctas = done.numel()
        int_ops += (frames + census["mpdus"]) * THREEFRY_OPS
        f32_ops = ((census["overlap"] + ctas * 2 * n) * BSS_PSR_OPS
                   + census["gated"] * BSS_TAIL_OPS)
    else:
        int_ops += frames * 2 * THREEFRY_OPS
        f32_ops = frames * BSS_PSR_OPS
    mob, tr = consts["mob"], consts["tr"]
    if mob is not None:
        # MOB: the refreshes each CTA ran (multiples of the stride in
        # [step0, done)), n positions, links and chains each; a link per
        # transmission
        stride = mob["stride"]
        nbytes += sum(v.nbytes for k, v in mob["ops"].items()
                      if k != "mob_id")
        refreshes = int((torch_floordiv(done.long() - 1, stride)
                         - (step0 - 1) // stride).clamp_min(0).sum())
        links = refreshes * n + census["ed_links"]
        f32_ops += (refreshes * n * (MOB_POS_OPS + BSS_PSR_OPS)
                    + links * MOB_LINK_F32_OPS)
        f64_ops += links * MOB_LINK_F64_OPS
    if tr is not None:
        # TRF: the gaps drawn, by model
        ops = tr["ops"]
        nbytes += sum(v.nbytes for v in ops.values())
        C, K = ops["tr_on_start"].shape[2], ops["tr_arr_t"].shape[2]
        int_ops += (census["gaps_mmpp"] * 3 * THREEFRY_OPS
                    + census["gaps_onoff"] * 2 * C
                    + census["gaps_trace"] * 2 * K)
        f32_ops += (census["gaps_mmpp"] + census["gaps_onoff"]) * GAP_F32_OPS
    times = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "operations": max(int_ops / INT32_OPS_PER_S,
                          f32_ops / F32_OPS_PER_S,
                          f64_ops / F64_OPS_PER_S) * 1e3,
    }
    by = max(times, key=times.get)
    return times[by], by


def bss_programs() -> dict:
    """The BSS programs of the checks and benches: ``bench_wifi``'s and
    ``bench_wifi_ht``'s, and a small one of each for the CPU-vs-card
    check (8 STAs on 12/20/28 m rings; under 802.11n its 28 m ring
    decodes a subframe about half the time)."""
    import warnings

    from tpudes_torch.scenarios import bss_program

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the short-horizon advisory
        return dict(
            legacy=bss_program(BSS_N_STAS, BSS_SIM_S),
            ht=bss_program(BSS_N_STAS, BSS_SIM_S, **BSS_HT),
            small_legacy=bss_program(8, 1.5, radii=(12.0, 20.0, 28.0)),
            small_ht=bss_program(8, 1.5, radii=(12.0, 20.0, 28.0),
                                 **BSS_HT),
        )


def census_line(census: dict) -> str:
    return ", ".join(f"{k} {int(v)}" for k, v in sorted(census.items()))


def bss_sweep_check(kc, dev, which: str) -> dict:
    """The horizon sweep: the ``BSS_SWEEP_S`` points x ``BSS_R``
    replicas of ``which`` as one ``(C, R)`` grid launch against the
    plain grid loop on the card (the whole state, each point's step
    count and pending flags bit-equal) and against each point's own
    single launch (every state array equal); the grid's device time per
    launch and its bound."""
    import torch
    from tpudes_torch.parallel import replicated as bss
    from tpudes_torch.parallel.bss_cuda import (
        BSS_STATE,
        bss_advance_cuda,
        bss_launch,
    )
    from tpudes_torch.random import PRNGKey

    prog = bss_programs()[which]
    ends = [int(round(v * 1e6)) for v in BSS_SWEEP_S]
    C = len(ends)
    consts, init, _ = bss.build_bss_advance(prog, BSS_R, dev)
    key = PRNGKey(BSS_CHECK_SEED, device=dev)
    bound = max(bss._estimate_max_steps(dataclasses.replace(
        prog, sim_end_us=v)) for v in ends)
    s0 = init(C)
    census = {}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    want, w_steps, w_pend = bss.bss_advance_math(
        consts, s0, key, [0] * C, bound, ends, census=census)
    torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    census = {k: int(v) for k, v in census.items()}
    got, steps, pend = bss_advance_cuda(consts, s0, key, [0] * C, bound, ends)
    what = f"bss_advance sweep ({which})"
    if steps != w_steps or not torch.equal(pend, w_pend):
        fail(f"{what}: steps {steps} / pending vs plain grid {w_steps}")
    err = 0.0
    for k, _, _ in BSS_STATE:
        if not torch.equal(got[k], want[k]):
            fail(f"{what} vs plain grid loop: {k} differs")
        err = max(err, (got[k].double() - want[k].double()).abs().max().item())
    for c, end in enumerate(ends):
        one, o_steps, o_pend = bss_advance_cuda(
            consts, {k: v[c:c + 1].contiguous() for k, v in s0.items()}, key,
            [0], bound, [end])
        if o_steps != [steps[c]] or not torch.equal(o_pend[0], pend[c]):
            fail(f"{what}: point {c} steps {steps[c]}, single launch "
                 f"{o_steps}")
        for k, _, _ in BSS_STATE:
            if not torch.equal(got[k][c], one[k][0]):
                fail(f"{what}: point {c} differs from its single launch "
                     f"in {k}")
    if bool(w_pend.any()):
        fail(f"{what}: a replica still pending")
    print(f"{what}: {C} horizons {BSS_SWEEP_S} s x {BSS_R} replicas in "
          f"one grid launch == the plain grid loop (every state array, the "
          f"step counts {steps} and the pending flags) == each point's own "
          f"launch; plain grid wall {plain_s:.3f} s", flush=True)
    ms, host_ms = timed_ms(
        lambda: bss_launch(consts, s0, key, [0] * C, bound, ends),
        BSS_TIMED_CALLS, reps=3)
    out, done, _, _ = bss_launch(consts, s0, key, [0] * C, bound, ends)
    bound_ms, bound_by = bss_bound(consts, s0, out, done, 0, census)
    print(f"{what}: one grid launch of {C} x {BSS_R} CTAs: device "
          f"{ms:.4f} ms/launch (host {host_ms:.4f} ms/call), bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by})", flush=True)
    return dict(err=err, ms=ms, plain_ms=plain_s * 1e3, steps=steps,
                bound=(bound_ms, bound_by), census=census)


def bss_bench(kc, dev, check: dict, which: str) -> dict:
    """Phase 5h (``which`` "legacy", ``bench.py::bench_wifi``) and 5-ht
    ("ht", ``bench_wifi_ht``) on the port: one warm run, then
    ``BSS_TIMED_RUNS`` counted runs on keys 1.. (one launch each, every
    replica done); prints its JSON line and returns its launches."""
    import torch
    from tpudes_torch.parallel.replicated import run_replicated_bss
    from tpudes_torch.random import PRNGKey

    prog = bss_programs()[which]
    want = {"bss_advance": 1}
    if prog.max_mpdus > 1:
        want["bss_advance:agg"] = 1

    def run(seed):
        return run_replicated_bss(prog, BSS_R, PRNGKey(seed), device=dev)

    run(0)                                                  # warm-up
    walls, delivered, steps, launches = [], 0, set(), None
    phase = "bench_wifi" if which == "legacy" else "bench_wifi_ht"
    for i in range(BSS_TIMED_RUNS):
        out, wall, launches = counted(kc, lambda: run(1 + i), want,
                                      f"BSS main path ({which})")
        if not out["all_done"]:
            fail(f"{phase} run {i}: a replica did not finish")
        if out["srv_rx"].shape != (BSS_R,) or out["cli_rx"].shape != (
                BSS_R, BSS_N_STAS + 1):
            fail(f"{phase}: outputs of the wrong shape")
        walls.append(wall)
        delivered += int(out["srv_rx"].sum())
        steps.add(out["steps"])
    busy, kernel_ms = device_busy_share(lambda: run(1), "bss_advance")
    med = statistics.median(walls)
    line = dict(
        phase=phase, replicas=BSS_R, n_stas=BSS_N_STAS,
        sim_s=BSS_SIM_S, steps=sorted(steps),
        sim_s_per_wall_s=BSS_R * BSS_SIM_S / med, wall_median_s=med,
        wall_min_s=min(walls), wall_max_s=max(walls),
        srv_rx_mean=delivered / (BSS_TIMED_RUNS * BSS_R),
    )
    if prog.max_mpdus > 1:
        line["max_mpdus"] = prog.max_mpdus
    line.update(
        kernel_us_per_step=check["us_per_step"],
        kernel_launches=launches,
        device_busy_share=busy if busy is not None else "not measured",
        profiled_kernel_device_ms=(kernel_ms if kernel_ms is not None
                                   else "not measured"),
        plain_loop_wall_s=check["plain_ms"] / 1e3,
        plain_loop_sim_s_per_wall_s=check["plain_sim_s_per_wall_s"],
        plain_loop_steps=check["steps"],
    )
    print(json.dumps(line), flush=True)
    torch.cuda.synchronize()
    return launches


def bss_sweep_bench(kc, dev, which: str) -> dict:
    """The horizon sweep at bench width: the ``BSS_SWEEP_S`` points x
    ``BSS_R`` replicas of ``which`` through ``run_replicated_bss(...,
    sim_end_us=[...])``, one warm run and ``BSS_TIMED_RUNS`` counted runs
    (one grid launch each); prints its JSON line (``sim_s_per_wall_s``
    summed over the points) and returns its launches."""
    from tpudes_torch.parallel.replicated import run_replicated_bss
    from tpudes_torch.random import PRNGKey

    prog = bss_programs()[which]
    ends = [int(round(v * 1e6)) for v in BSS_SWEEP_S]
    want = {"bss_advance": 1, "bss_advance:sweep": 1}
    if prog.max_mpdus > 1:
        want["bss_advance:agg"] = 1

    def run(seed):
        return run_replicated_bss(prog, BSS_R, PRNGKey(seed), device=dev,
                                  sim_end_us=ends)

    run(0)                                                  # warm-up
    walls, steps, launches = [], [], None
    for i in range(BSS_TIMED_RUNS):
        out, wall, launches = counted(kc, lambda: run(1 + i), want,
                                      f"BSS sweep ({which})")
        if not all(p["all_done"] for p in out):
            fail(f"BSS sweep ({which}) run {i}: a replica did not finish")
        walls.append(wall)
        steps.append([p["steps"] for p in out])
    med = statistics.median(walls)
    print(json.dumps(dict(
        phase="bench_bss_sweep", program=which, replicas=BSS_R,
        points_sim_s=list(BSS_SWEEP_S), steps=steps,
        sim_s_per_wall_s=BSS_R * sum(BSS_SWEEP_S) / med,
        wall_median_s=med, wall_min_s=min(walls), wall_max_s=max(walls),
        kernel_launches=launches,
    )), flush=True)
    return launches


def bss_arm_programs() -> dict:
    """The programs of the ``MOB`` and ``TRF`` arms: ``bench_mobile_bss``'s
    (bench_wifi's BSS drifting, :data:`BSS_MOBILE`); bench_wifi's BSS
    under ``bench_traffic_burst``'s ON-OFF workload at its own mean echo
    rate (``programs.bss_onoff_traffic``), and under the cbr workload of
    its own intervals (the ``traffic_off`` pair of ``traffic=None``); the
    eight workload-sweep points on it (``programs.toy_traffic_points``,
    the AP on its beacons); all three composed under 802.11n; and a small
    program of each for the CPU-vs-card check (8 STAs on 12/20/28 m
    rings, 1.3 s)."""
    import warnings

    from tpudes_torch.parallel.programs import (
        bss_onoff_traffic,
        toy_traffic_points,
    )
    from tpudes_torch.scenarios import bss_program
    from tpudes_torch.traffic.program import TrafficProgram

    def points(p):
        return toy_traffic_points(p.n, p.sim_end_us, start_us=p.start_us,
                                  beacon=(int(p.interval_us[0]),
                                          int(p.start_us[0])))

    def onoff(p):
        return dataclasses.replace(p, traffic=bss_onoff_traffic(p))

    rings = dict(radii=(12.0, 20.0, 28.0))
    small_mob = dict(mobility="const_velocity", speed=2.0, geom_stride=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the short-horizon advisory
        base = bss_program(BSS_N_STAS, BSS_SIM_S)
        small = bss_program(8, 1.3, **rings)
        out = dict(
            mobile=bss_program(BSS_N_STAS, BSS_SIM_S, **BSS_MOBILE),
            onoff=onoff(base),
            cbr=dataclasses.replace(base, traffic=TrafficProgram.cbr(
                base.start_us, base.interval_us)),
            composed=onoff(bss_program(BSS_N_STAS, BSS_SIM_S, **BSS_MOBILE,
                                       **BSS_HT)),
            small_mobile=bss_program(8, 1.3, **rings, **small_mob),
            small_onoff=onoff(small),
            small_composed=onoff(bss_program(8, 1.3, **rings, **small_mob,
                                             **BSS_HT)),
        )
    out["sweep_points"] = points(base)
    out["sweep"] = dataclasses.replace(base, traffic=out["sweep_points"][0])
    out["small_sweep_points"] = points(small)
    out["small_sweep"] = dataclasses.replace(
        small, traffic=out["small_sweep_points"][0])
    return out


def bss_check(kc, dev, name: str) -> dict:
    """Phases 3g, 3g-ht and 3h: ``bss_advance`` against the plain loop on
    the card at bench width, ``name`` one of :func:`bss_programs`'s
    legacy and ht (the legacy arm and ``AGG``) or :func:`bss_arm_programs`'s
    mobile, onoff, sweep and composed (``MOB``, ``TRF``, the traffic grid
    of 8 x 512, all three under 802.11n): the whole state (``geom_t``
    too), the step counts and the pending flags bit-equal over one launch
    and over two split mid-stride; the sweep also against each point's
    own launch; the plain loop's census (every run a retry-limit drop;
    under 802.11n a partially decoded A-MPDU; the replica-steps with
    three or more same-µs winners are ROADMAP C2's count); the small
    program's CPU run against its card run; the launch's device time and
    its bound."""
    import torch
    from tpudes_torch.parallel import replicated as bss
    from tpudes_torch.parallel.bss_cuda import (
        BSS_STATE,
        bss_advance_cuda,
        bss_launch,
    )
    from tpudes_torch.random import PRNGKey

    progs = {**bss_programs(), **bss_arm_programs()}
    prog = progs[name]
    if name in BSS_ARM_CHECK_S:
        prog = dataclasses.replace(
            prog, sim_end_us=int(round(BSS_ARM_CHECK_S[name] * 1e6)))
    sweep = progs["sweep_points"] if name == "sweep" else None
    C = len(sweep) if sweep else 1
    ends = [prog.sim_end_us] * C
    consts, init, _ = bss.build_bss_advance(prog, BSS_R, dev, sweep)
    key = PRNGKey(BSS_CHECK_SEED, device=dev)
    bound = max(bss._estimate_max_steps(dataclasses.replace(
        prog, traffic=tp)) for tp in (sweep or [prog.traffic]))
    census = {}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    want, w_steps, w_pend = bss.bss_advance_math(
        consts, init(C), key, [0] * C, bound, ends, census=census)
    torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    census = {k: int(v) for k, v in census.items()}
    got, steps, pend = bss_advance_cuda(consts, init(C), key, [0] * C,
                                        bound, ends)
    stride = consts["mob"]["stride"] if consts["mob"] is not None else 1
    split = min(w_steps) // 2
    split += int(stride > 1 and split % stride == 0)     # mid-stride
    half, h_steps, _ = bss_advance_cuda(consts, init(C), key, [0] * C,
                                        split, ends)
    two, t_steps, t_pend = bss_advance_cuda(consts, half, key, h_steps,
                                            bound, ends)
    torch.cuda.synchronize()
    what = f"bss_advance ({name})"
    if steps != w_steps or t_steps != w_steps or h_steps != [split] * C:
        fail(f"{what} steps {steps}, {h_steps} + {t_steps}; plain loop "
             f"{w_steps} (split at {split})")
    if not (torch.equal(pend, w_pend) and torch.equal(t_pend, w_pend)):
        fail(f"{what} pending flags differ from the plain loop's")
    err = 0.0
    for k, _, _ in BSS_STATE:
        for how, x in (("one launch", got), ("two launches", two)):
            if not torch.equal(x[k], want[k]):
                fail(f"{what} ({how}) vs plain loop: {k} differs")
        err = max(err, (got[k].double() - want[k].double()).abs().max().item())
    if bool(w_pend.any()) or int(want["drops"].sum()) <= 0:
        fail(f"{what} check: a replica still pending, or no drop")
    if prog.max_mpdus > 1 and not (census["mpdus"] > census["gated"]
                                   and census["partial"] > 0):
        fail(f"{what} check: no A-MPDU of several subframes decoded in "
             f"part ({census_line(census)})")
    if sweep:
        for c, tp in enumerate(sweep):
            pc, pinit, _ = bss.build_bss_advance(
                dataclasses.replace(prog, traffic=tp), BSS_R, dev)
            one, o_steps, o_pend = bss_advance_cuda(pc, pinit(), key, [0],
                                                    bound, ends[:1])
            if o_steps != [steps[c]] or not torch.equal(o_pend[0], pend[c]):
                fail(f"{what}: point {c} steps {steps[c]}, its own launch "
                     f"{o_steps}")
            for k, _, _ in BSS_STATE:
                if not torch.equal(got[k][c], one[k][0]):
                    fail(f"{what}: point {c} differs from its own launch "
                         f"in {k}")
    print(f"{what} vs plain loop: {len(BSS_STATE)} state arrays, the step "
          f"counts ({w_steps}) and the pending flags bit-equal at "
          f"N={consts['N']} C={C} R={BSS_R} K={consts['K']}, "
          f"{prog.sim_end_us / 1e6} s, over one launch "
          f"and over two split at step {split} (stride {stride})"
          + ("; each point == its own launch" if sweep else "")
          + f"; srv_rx {int(want['srv_rx'].sum())}, tx_data "
          f"{int(want['tx_data'].sum())}, drops {int(want['drops'].sum())}; "
          f"plain loop wall {plain_s:.3f} s", flush=True)
    print(f"{what} census of the plain loop (C2: three_winners): "
          f"{census_line(census)}", flush=True)

    small = progs[f"small_{name}"]
    kw = ({"traffic_sweep": progs["small_sweep_points"]} if sweep else {})
    on_cpu = bss.run_replicated_bss(small, 8, PRNGKey(3), device="cpu", **kw)
    on_gpu = bss.run_replicated_bss(small, 8, PRNGKey(3), device=dev, **kw)
    sim_s = small.sim_end_us / 1e6
    for c, (a, b) in enumerate(zip(on_cpu if sweep else [on_cpu],
                                   on_gpu if sweep else [on_gpu])):
        for k in ("srv_rx", "cli_rx", "tx_data", "drops", "steps",
                  "all_done") + (("geom_refreshes",) if small.mobility
                                 else ()):
            if not np.array_equal(a[k], b[k]):
                fail(f"small BSS program ({name}, point {c}): CPU plain "
                     f"loop vs kernel differs in {k}")
    print(f"small BSS program ({name}, 8 STAs, {C} x 8 x {sim_s} s): CPU "
          f"plain loop == kernel on the card", flush=True)

    s0 = init(C)
    ms, host_ms = timed_ms(
        lambda: bss_launch(consts, s0, key, [0] * C, bound, ends),
        BSS_TIMED_CALLS, reps=3)
    out, done, _, _ = bss_launch(consts, s0, key, [0] * C, bound, ends)
    bound_ms, bound_by = bss_bound(consts, s0, out, done, 0, census)
    us_step = ms * 1e3 / max(w_steps)
    print(f"{what}: one launch of {C} x {BSS_R} CTAs, {max(w_steps)} steps "
          f"at most: device {ms:.4f} ms/launch = {us_step:.4f} us/step "
          f"(host {host_ms:.4f} ms/call), plain loop wall "
          f"{plain_s * 1e3:.1f} ms, bound {bound_ms * 1e3:.3f} us "
          f"({bound_by})", flush=True)
    return dict(err=err, ms=ms, plain_ms=plain_s * 1e3, steps=max(w_steps),
                us_per_step=us_step, bound=(bound_ms, bound_by),
                plain_sim_s_per_wall_s=C * BSS_R * prog.sim_end_us / 1e6
                / plain_s, census=census)


def bss_timed_runs(kc, run, want: dict, what: str):
    """One warm run (key 0), then ``BSS_TIMED_RUNS`` counted runs on keys
    1.. (each launch count ``want``'s, every replica done): ``(walls,
    outputs, launches)``."""
    run(0)                                                  # warm-up
    walls, outs, launches = [], [], None
    for i in range(BSS_TIMED_RUNS):
        out, wall, launches = counted(kc, lambda: run(1 + i), want, what)
        if not all(p["all_done"] for p in (out if isinstance(out, list)
                                           else [out])):
            fail(f"{what} run {i}: a replica did not finish")
        walls.append(wall)
        outs.append(out)
    return walls, outs, launches


def bss_mobile_bench(kc, dev, check: dict) -> dict:
    """Phase 5m, ``bench.py::bench_mobile_bss`` on the port: the mobile
    program's main path and, in the same call, the static legacy one's
    (``wall_vs_static`` the ratio of their medians); prints its JSON line
    and returns the mobile runs' launches."""
    from tpudes_torch.parallel.replicated import run_replicated_bss
    from tpudes_torch.random import PRNGKey

    mob = bss_arm_programs()["mobile"]
    static = bss_programs()["legacy"]

    def runner(prog):
        return lambda seed: run_replicated_bss(prog, BSS_R, PRNGKey(seed),
                                               device=dev)

    walls, outs, launches = bss_timed_runs(
        kc, runner(mob), {"bss_advance": 1, "bss_advance:mobile": 1},
        "mobile BSS main path")
    s_walls, _, _ = bss_timed_runs(kc, runner(static), {"bss_advance": 1},
                                   "static BSS main path")
    busy, kernel_ms = device_busy_share(lambda: runner(mob)(1),
                                        "bss_advance")
    med, s_med = statistics.median(walls), statistics.median(s_walls)
    print(json.dumps(dict(
        phase="bench_mobile_bss", replicas=BSS_R, n_stas=BSS_N_STAS,
        sim_s=BSS_SIM_S, mob_model=BSS_MOBILE["mobility"],
        speed_mps=BSS_MOBILE["speed"], geom_stride=BSS_MOBILE["geom_stride"],
        steps=[o["steps"] for o in outs],
        geom_refreshes=[o["geom_refreshes"] for o in outs],
        sim_s_per_wall_s=BSS_R * BSS_SIM_S / med,
        static_sim_s_per_wall_s=BSS_R * BSS_SIM_S / s_med,
        wall_vs_static=med / s_med, wall_median_s=med,
        wall_min_s=min(walls), wall_max_s=max(walls),
        static_wall_median_s=s_med,
        srv_rx_mean=sum(int(o["srv_rx"].sum()) for o in outs)
        / (BSS_TIMED_RUNS * BSS_R),
        kernel_launches=launches,
        device_busy_share=busy if busy is not None else "not measured",
        profiled_kernel_device_ms=(kernel_ms if kernel_ms is not None
                                   else "not measured"),
        kernel_check_ms=check["ms"], plain_loop_wall_s=check["plain_ms"] / 1e3,
    )), flush=True)
    return launches


def bss_traffic_bench(kc, dev, check: dict) -> dict:
    """Phase 5t, ``bench.py::bench_traffic_burst``'s measurements on
    bench_wifi's BSS: ``traffic=None``, the cbr workload of its own
    intervals and the ON-OFF workload at the same mean load;
    ``stage_overhead`` = min cbr wall / min ``None`` wall,
    ``burst_overhead`` = min ON-OFF wall / min cbr wall / (ON-OFF steps /
    cbr steps); the cbr runs' outputs equal ``None``'s bit for bit, key
    by key (the ``traffic_off`` pair).  Prints its JSON line and returns
    the ON-OFF runs' launches."""
    from tpudes_torch.parallel.replicated import run_replicated_bss
    from tpudes_torch.random import PRNGKey

    progs = bss_arm_programs()
    none = bss_programs()["legacy"]

    def runner(prog):
        return lambda seed: run_replicated_bss(prog, BSS_R, PRNGKey(seed),
                                               device=dev)

    trf = {"bss_advance": 1, "bss_advance:traffic": 1}
    n_walls, n_outs, _ = bss_timed_runs(kc, runner(none), {"bss_advance": 1},
                                        "BSS main path, traffic=None")
    c_walls, c_outs, _ = bss_timed_runs(kc, runner(progs["cbr"]), trf,
                                        "BSS main path, cbr workload")
    b_walls, b_outs, launches = bss_timed_runs(
        kc, runner(progs["onoff"]), trf, "BSS main path, ON-OFF workload")
    for i, (a, b) in enumerate(zip(c_outs, n_outs)):
        for k in ("srv_rx", "cli_rx", "tx_data", "drops", "steps"):
            if not np.array_equal(a[k], b[k]):
                fail(f"traffic_off pair, key {1 + i}: the cbr workload "
                     f"differs from traffic=None in {k}")
    busy, kernel_ms = device_busy_share(lambda: runner(progs["onoff"])(1),
                                        "bss_advance")
    step_ratio = b_outs[-1]["steps"] / max(c_outs[-1]["steps"], 1)
    med = statistics.median(b_walls)
    tp = progs["onoff"].traffic
    print(json.dumps(dict(
        phase="bench_traffic_burst", replicas=BSS_R, n_stas=BSS_N_STAS,
        sim_s=BSS_SIM_S, peak_pps=float(tp.peak_pps[1]),
        duty=float(tp.rate_pps[1] / tp.peak_pps[1]),
        burst_steps=[o["steps"] for o in b_outs],
        cbr_steps=[o["steps"] for o in c_outs],
        sim_s_per_wall_s=BSS_R * BSS_SIM_S / med, wall_median_s=med,
        wall_min_s=min(b_walls), wall_max_s=max(b_walls),
        wall_none_min_s=min(n_walls), wall_cbr_min_s=min(c_walls),
        stage_overhead=min(c_walls) / min(n_walls),
        burst_wall_ratio=min(b_walls) / min(c_walls),
        burst_overhead=min(b_walls) / min(c_walls) / step_ratio,
        traffic_off_bit_equal=True,
        srv_rx_mean=sum(int(o["srv_rx"].sum()) for o in b_outs)
        / (BSS_TIMED_RUNS * BSS_R),
        kernel_launches=launches,
        device_busy_share=busy if busy is not None else "not measured",
        profiled_kernel_device_ms=(kernel_ms if kernel_ms is not None
                                   else "not measured"),
        kernel_check_ms=check["ms"], plain_loop_wall_s=check["plain_ms"] / 1e3,
    )), flush=True)
    return launches


def bss_workload_sweep_bench(kc, dev, check: dict) -> dict:
    """Phase 5w: the eight workload points on bench_wifi's BSS through
    ``run_replicated_bss(..., traffic_sweep=[...])``, one grid launch of
    8 x ``BSS_R`` CTAs a run (``sim_s_per_wall_s`` summed over the
    points); prints its JSON line and returns its launches."""
    from tpudes_torch.parallel.replicated import run_replicated_bss
    from tpudes_torch.random import PRNGKey

    progs = bss_arm_programs()
    pts = progs["sweep_points"]

    def run(seed):
        return run_replicated_bss(progs["sweep"], BSS_R, PRNGKey(seed),
                                  device=dev, traffic_sweep=pts)

    walls, outs, launches = bss_timed_runs(
        kc, run, {"bss_advance": 1, "bss_advance:traffic": 1,
                  "bss_advance:traffic_sweep": 1}, "BSS workload sweep")
    busy, kernel_ms = device_busy_share(lambda: run(1), "bss_advance")
    med = statistics.median(walls)
    print(json.dumps(dict(
        phase="bench_bss_traffic_sweep", replicas=BSS_R, points=len(pts),
        models=[tp.model for tp in pts], sim_s=BSS_SIM_S,
        steps=[[p["steps"] for p in o] for o in outs],
        sim_s_per_wall_s=BSS_R * len(pts) * BSS_SIM_S / med,
        wall_median_s=med, wall_min_s=min(walls), wall_max_s=max(walls),
        kernel_launches=launches,
        device_busy_share=busy if busy is not None else "not measured",
        profiled_kernel_device_ms=(kernel_ms if kernel_ms is not None
                                   else "not measured"),
        kernel_check_ms=check["ms"], plain_loop_wall_s=check["plain_ms"] / 1e3,
    )), flush=True)
    return launches


def bss_stage_split(dev, label: str) -> dict:
    """Phase 3p: the stage probe (``bss_cuda.bss_profile``: the kernel's
    profiling instantiation, lane 0 of each row reading ``clock64()`` at
    the stage edges) on legacy, ``AGG``, ``MOB`` and ``TRF`` at bench
    width (:data:`BSS_PROBE_ARMS`, ``BSS_R`` replicas x 2 s): its state
    bit-equal to the main launch's, then the mean cycles a replica-step
    spends in each stage (``BSS_PROF_STAGES``), their sum, the probe
    launch's device time, the SM clock that time and the longest row's
    cycles give, and nvidia-smi's SM clock just after.  Returns each
    arm's split."""
    import torch
    from tpudes_torch.parallel import replicated as bss
    from tpudes_torch.parallel.bss_cuda import (
        BSS_PROF_STAGES,
        BSS_STATE,
        bss_launch,
        bss_profile,
    )
    from tpudes_torch.random import PRNGKey

    progs = {**bss_programs(), **bss_arm_programs()}
    split = {}
    for arm, name in BSS_PROBE_ARMS:
        prog = progs[name]
        consts, init, _ = bss.build_bss_advance(prog, BSS_R, dev)
        key = PRNGKey(BSS_CHECK_SEED, device=dev)
        bound = bss._estimate_max_steps(prog)
        s0 = init()
        want = bss_launch(consts, s0, key, [0], bound)
        bss_profile(consts, s0, key, [0], bound)              # warm-up
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        got, cyc = bss_profile(consts, s0, key, [0], bound)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        clock = sm_clock_line()
        for k, _, _ in BSS_STATE:
            if not torch.equal(got[0][k], want[0][k]):
                fail(f"{label} probe ({arm}): {k} differs from the main "
                     f"launch's")
        if not torch.equal(got[1], want[1]):
            fail(f"{label} probe ({arm}): stops differ")
        steps = int(got[1].long().sum())
        per = (cyc.sum(0).double() / steps).tolist()
        rows = cyc.sum(1)
        mhz = float(rows.max()) / (ms * 1e3)
        split[arm] = dict(zip(BSS_PROF_STAGES, per), total=sum(per),
                          probe_ms=ms, clock_mhz_from_probe=mhz,
                          nvidia_smi_clocks_sm_max=clock,
                          us_per_step=sum(per) / mhz)
        print(f"{label} stage probe ({arm}, {BSS_R} x {prog.sim_end_us / 1e6}"
              f" s, {steps} replica-steps): cycles per step "
              + ", ".join(f"{k} {v:.1f}" for k, v in zip(BSS_PROF_STAGES,
                                                        per))
              + f"; total {sum(per):.1f} = {sum(per) / mhz:.4f} us at "
              f"{mhz:.1f} MHz (the longest row's cycles over the probe "
              f"launch's {ms:.4f} ms); nvidia-smi clocks.sm, clocks.max.sm "
              f"{clock}", flush=True)
    return split


def tcp_programs(sim_s: float) -> dict:
    """The TCP dumbbell programs at ``sim_s`` seconds: ``bench_tcp``'s (8
    Cubic flows, 10 Mbit/s), ``bench_tcp_variant_sweep``'s (17 flows, one
    per variant, 13 Mbit/s) and the RED/ECN program (3 DCTCP and 3
    NewReno flows, 5 Mbit/s)."""
    from tpudes_torch.parallel.tcp_dumbbell import VARIANTS
    from tpudes_torch.scenarios import dumbbell_program

    return dict(
        bench_tcp=dumbbell_program(8, sim_s, variant="TcpCubic"),
        variants17=dumbbell_program(17, sim_s, variants=list(VARIANTS),
                                    bottleneck_rate="13Mbps"),
        red=dumbbell_program(6, sim_s, variants=["TcpDctcp",
                                                 "TcpNewReno"] * 3,
                             bottleneck_rate="5Mbps", red=TCP_RED),
    )


def tcp_bound(consts, state, out, slots: int, app=None) -> tuple:
    """Least time for one ``tcp_advance`` launch of ``slots`` slots on
    these inputs: the state (and an app limit's table, each of its rows
    once) read once and written once over HBM, against the hashes and the
    per-flow work (:data:`TCP_FLOW_F32_OPS`, :data:`TCP_FLOW_INT_OPS`,
    and :data:`TCP_TRF_INT_OPS` under an app limit) each type's rate; the
    larger wins."""
    C, R = state["cwnd"].shape[:2]
    F, red = consts["F"], consts["red"]
    nbytes = sum(v.nbytes for v in state.values())
    nbytes += sum(v.nbytes for v in out.values())
    if app is not None:
        nbytes += app[0].nbytes if app.stride(0) == 0 else app.nbytes
    rows = C * R * slots
    hashes = slots + rows * ((TCP_RED_HASHES + F) if red else TCP_HASHES)
    int_ops = hashes * THREEFRY_OPS + rows * F * (
        TCP_FLOW_INT_OPS + (TCP_TRF_INT_OPS if app is not None else 0))
    f32_ops = rows * F * TCP_FLOW_F32_OPS
    f64_ops = rows * TCP_RED_F64_OPS if red else 0
    times = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "operations": max(int_ops / INT32_OPS_PER_S,
                          f32_ops / F32_OPS_PER_S,
                          f64_ops / F64_OPS_PER_S) * 1e3,
    }
    by = max(times, key=times.get)
    return times[by], by


def tcp_check(kc, dev, name: str) -> dict:
    """Phase 3t: ``tcp_advance`` against the plain loop on the card at
    ``TCP_R`` replicas x ``TCP_CHECK_S`` s, ``name`` one of
    :func:`tcp_programs`'s or "grid" (bench_tcp's program as the
    ``TCP_GRID`` points, one ``(C, R)`` launch): the whole state bit-equal
    over one launch and over two split at a slot boundary; the grid also
    against each point's own launch; the RED program must mark and drop
    early; a small program through the plain loop on the CPU against the
    kernel on the card; the launch's device time, µs per slot and
    bound."""
    import torch
    from tpudes_torch.parallel import tcp_dumbbell as tcp
    from tpudes_torch.parallel.tcp_cuda import tcp_launch
    from tpudes_torch.random import PRNGKey

    prog = tcp_programs(TCP_CHECK_S)["bench_tcp" if name == "grid" else name]
    points = [list(p) for p in TCP_GRID] if name == "grid" else None
    consts = tcp.build_tcp_consts(prog, dev)
    var, ecn = tcp.sweep_operands(prog, points)
    var = torch.as_tensor(var, device=dev)
    ecn = torch.as_tensor(ecn, device=dev)
    C, n = var.shape[0], prog.n_slots
    key = PRNGKey(TCP_CHECK_SEED, device=dev)
    s0 = tcp.init_state(consts, TCP_R, C)
    census = {}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    want = tcp.tcp_advance_math(consts, s0, key, 0, n, var, ecn, census)
    torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    got = tcp_launch(consts, s0, key, 0, n, var, ecn)
    split = n // 2 + 1
    two = tcp_launch(consts, tcp_launch(consts, s0, key, 0, split, var, ecn),
                     key, split, n, var, ecn)
    torch.cuda.synchronize()
    what = f"tcp_advance ({name})"
    err = 0.0
    for k, _, _ in tcp.TCP_STATE:
        for how, x in (("one launch", got), ("two launches", two)):
            if not torch.equal(bits_of(x[k]), bits_of(want[k])):
                fail(f"{what} ({how}) vs plain loop: {k} differs")
        err = max(err, (got[k].double() - want[k].double()).abs()
                  .nan_to_num().max().item())
    if census["tail_drops"] + census["early_drops"] <= 0 or int(
            want["delivered"].sum()) <= 0:
        fail(f"{what} check: nothing delivered or nothing dropped")
    if consts["red"] and min(census["ce_marks"], census["early_drops"]) <= 0:
        fail(f"{what} check: RED marked nothing or dropped nothing early "
             f"({census})")
    if points:
        for c in range(C):
            one = tcp_launch(consts, {k: v[c:c + 1].contiguous()
                                      for k, v in s0.items()}, key, 0, n,
                             var[c:c + 1].contiguous(),
                             ecn[c:c + 1].contiguous())
            for k, _, _ in tcp.TCP_STATE:
                if not torch.equal(bits_of(got[k][c]), bits_of(one[k][0])):
                    fail(f"{what}: point {c} differs from its own launch "
                         f"in {k}")
    print(f"{what} vs plain loop: {len(tcp.TCP_STATE)} state arrays "
          f"bit-equal at F={consts['F']} L={consts['L']} C={C} R={TCP_R}, "
          f"{n} slots ({TCP_CHECK_S} s), over one launch and over two split "
          f"at slot {split}" + ("; each point == its own launch" if points
                                else "")
          + f"; delivered {int(want['delivered'].sum())}, census "
          f"{census_line(census)}; plain loop wall {plain_s:.3f} s",
          flush=True)

    small = tcp_programs(0.5)["bench_tcp" if name == "grid" else name]
    on_cpu = tcp.run_tcp_dumbbell(small, PRNGKey(3), 8, variants=points,
                                  device="cpu")
    on_gpu = tcp.run_tcp_dumbbell(small, PRNGKey(3), 8, variants=points,
                                  device=dev)
    for c, (a, b) in enumerate(zip(on_cpu if points else [on_cpu],
                                   on_gpu if points else [on_gpu])):
        for k in ("delivered", "drops", "mean_queue", "cwnd_final"):
            if not np.array_equal(a[k], b[k]):
                fail(f"small dumbbell ({name}, point {c}): CPU plain loop "
                     f"vs kernel differs in {k}")
    print(f"small dumbbell ({name}, {C} x 8 x 0.5 s): CPU plain loop == "
          f"kernel on the card", flush=True)

    ms, host_ms = timed_ms(lambda: tcp_launch(consts, s0, key, 0, n, var,
                                              ecn),
                           TCP_TIMED_CALLS, reps=3)
    bound_ms, bound_by = tcp_bound(consts, s0, got, n)
    us_slot = ms * 1e3 / n
    print(f"{what}: one launch of {C} x {TCP_R} warps, {n} slots: device "
          f"{ms:.4f} ms/launch = {us_slot:.4f} us/slot (host "
          f"{host_ms:.4f} ms/call), plain loop wall {plain_s * 1e3:.1f} ms "
          f"= {plain_s * 1e6 / n:.1f} us/slot, bound {bound_ms * 1e3:.3f} "
          f"us ({bound_by})", flush=True)
    return dict(err=err, ms=ms, plain_ms=plain_s * 1e3, slots=n,
                us_per_slot=us_slot, bound=(bound_ms, bound_by),
                plain_sim_s_per_wall_s=C * TCP_R * TCP_CHECK_S / plain_s,
                census=census)


def tcp_division(dev) -> None:
    """``tcp_advance``'s branch-free division against the card's IEEE
    division (``tcp_cuda.division_check``) on :data:`TCP_DIV_PAIRS`
    hashed operand pairs: every quotient bit-equal."""
    from tpudes_torch.parallel.tcp_cuda import division_check

    t0 = time.monotonic()
    bad, done = division_check(TCP_DIV_PAIRS, seed=TCP_CHECK_SEED,
                               device=dev)
    if bad or done != TCP_DIV_PAIRS:
        fail(f"tcp_advance's fast division differs from __fdiv_rn on {bad} "
             f"of {done} pairs")
    print(f"tcp_advance's fast division == __fdiv_rn on {done} pairs "
          f"({time.monotonic() - t0:.2f} s)", flush=True)


def tcp_stage_split(dev, label: str) -> dict:
    """The stage probe of ``tcp_advance`` (``tcp_cuda.tcp_profile``: the
    kernel's profiling instantiation, each warp reading ``clock64()`` at
    its stage edges) on :data:`TCP_PROBE_PROGRAMS` at ``TCP_R`` replicas
    x ``TCP_CHECK_S`` s: its state bit-equal to the main launch's, then
    the mean cycles a row-slot spends in each stage (``TCP_PROF_STAGES``),
    each warp's sum (``TCP_PROF_WARPS``: a slot of the two-warp kernel
    takes about the larger, one of a one-warp kernel the two together,
    ``total``), the probe launch's device time per slot (CUDA events) and
    nvidia-smi's SM clock just after.  Returns each program's split."""
    import torch
    from tpudes_torch.parallel import tcp_dumbbell as tcp
    from tpudes_torch.parallel.tcp_cuda import (
        TCP_PROF_STAGES,
        TCP_PROF_WARPS,
        tcp_launch,
        tcp_profile,
    )
    from tpudes_torch.random import PRNGKey

    split = {}
    for name in TCP_PROBE_PROGRAMS:
        prog = tcp_programs(TCP_CHECK_S)[name]
        consts = tcp.build_tcp_consts(prog, dev)
        var, ecn = (torch.as_tensor(x, device=dev)
                    for x in tcp.sweep_operands(prog))
        key = PRNGKey(TCP_CHECK_SEED, device=dev)
        s0 = tcp.init_state(consts, TCP_R)
        n = prog.n_slots
        want = tcp_launch(consts, s0, key, 0, n, var, ecn)
        tcp_profile(consts, s0, key, 0, n, var, ecn)            # warm-up
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        got, cyc = tcp_profile(consts, s0, key, 0, n, var, ecn)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        clock = sm_clock_line()
        for k, _, _ in tcp.TCP_STATE:
            if not torch.equal(bits_of(got[k]), bits_of(want[k])):
                fail(f"{label} probe ({name}): {k} differs from the main "
                     f"launch's")
        per = dict(zip(TCP_PROF_STAGES,
                       (cyc.sum(0).double() / (cyc.shape[0] * n)).tolist()))
        warps = {w: sum(per[k] for k in ks) for w, ks in TCP_PROF_WARPS.items()}
        split[name] = dict(per, **{f"{w}_warp": v for w, v in warps.items()},
                           total=sum(per.values()), probe_ms=ms,
                           probe_us_per_slot=ms * 1e3 / n,
                           nvidia_smi_clocks_sm_max=clock)
        print(f"{label} stage probe ({name}, {TCP_R} x {TCP_CHECK_S} s, "
              f"{n} slots): cycles per row-slot "
              + ", ".join(f"{k} {v:.1f}" for k, v in per.items())
              + f"; rules warp {warps['rules']:.1f}, queue warp "
              f"{warps['queue']:.1f}, total {sum(per.values()):.1f}; probe "
              f"launch {ms:.4f} ms = {ms * 1e3 / n:.4f} us/slot; nvidia-smi "
              f"clocks.sm, clocks.max.sm {clock}", flush=True)
    return split


def tcp_bench(kc, dev, check: dict, which: str) -> dict:
    """Phase 5tcp: ``bench_tcp`` (``which`` "bench_tcp") or
    ``bench_tcp_variant_sweep`` ("variants17") on the port at ``TCP_R``
    replicas x ``TCP_SIM_S`` s: one warm run, then ``TCP_TIMED_RUNS``
    counted runs on keys 1.. (one launch each); prints its JSON line
    (``bench.py``'s keys; ``vs_scalar`` needs the host DES, which the port
    does not have) and returns its launches."""
    from tpudes_torch.parallel.tcp_dumbbell import VARIANTS, run_tcp_dumbbell
    from tpudes_torch.random import PRNGKey

    prog = tcp_programs(TCP_SIM_S)[which]
    F = prog.n_flows
    link_mbps = (prog.seg_bytes + 40) * 8 / prog.slot_s / 1e6

    def run(seed):
        return run_tcp_dumbbell(prog, PRNGKey(seed), TCP_R, device=dev)

    run(0)                                                  # warm-up
    walls, goodput, launches, out = [], [], None, None
    for i in range(TCP_TIMED_RUNS):
        out, wall, launches = counted(kc, lambda: run(1 + i),
                                      {"tcp_advance": 1},
                                      f"dumbbell main path ({which})")
        g = out["goodput_mbps"]
        if (g.shape != (TCP_R, F) or out["cwnd_final"].shape != (TCP_R, F)
                or not np.all(np.isfinite(g))
                or not np.all(np.isfinite(out["mean_queue"]))
                or (out["delivered"].sum(1) <= 0).any()
                or (out["delivered"].sum(1) > prog.n_slots).any()
                or g.sum(1).max() > link_mbps):
            fail(f"{which} run {i}: outputs of the wrong shape, not "
                 f"finite, or past the bottleneck")
        walls.append(wall)
        goodput.append(g)
    busy, kernel_ms = device_busy_share(lambda: run(1), "tcp_advance")
    med = statistics.median(walls)
    mean_g = np.mean(goodput, axis=0)
    line = dict(
        phase=which if which == "bench_tcp" else "bench_tcp_variant_sweep",
        replicas=TCP_R, n_flows=F, sim_s=TCP_SIM_S, n_slots=prog.n_slots,
        sim_s_per_wall_s=TCP_R * TCP_SIM_S / med, wall_median_s=med,
        wall_min_s=min(walls), wall_max_s=max(walls),
        agg_goodput_mbps=float(mean_g.sum(1).mean()),
        obs_drops_per_replica=float(out["drops"].sum(1).mean()),
        obs_mean_queue_pkts=float(out["mean_queue"].mean()),
        vs_scalar="not measured: needs the host DES, which the port does "
                  "not have",
    )
    if which == "variants17":
        line["per_variant_mbps"] = {v: float(mean_g[:, i].mean())
                                    for i, v in enumerate(VARIANTS)}
    line.update(
        kernel_us_per_slot=check["us_per_slot"],
        kernel_launches=launches,
        device_busy_share=busy if busy is not None else "not measured",
        profiled_kernel_device_ms=(kernel_ms if kernel_ms is not None
                                   else "not measured"),
        plain_loop_wall_s_at_check=check["plain_ms"] / 1e3,
        plain_loop_sim_s_per_wall_s=check["plain_sim_s_per_wall_s"],
    )
    print(json.dumps(line), flush=True)
    return launches


def tcp_trf_programs(sim_s: float):
    """``(prog, points)``: ``bench_tcp``'s program at ``sim_s`` seconds
    with each flow app-limited by the ON-OFF workload
    :data:`TCP_TRF_ONOFF` (its tables drawn over the bench's 20 s, so a
    shorter horizon runs their first part), and the eight toy workload
    points (``programs.toy_traffic_points``) of the workload grid."""
    from tpudes_torch.parallel.programs import toy_traffic_points
    from tpudes_torch.traffic.program import TrafficProgram

    prog = tcp_programs(sim_s)["bench_tcp"]
    horizon_us = int(TCP_SIM_S * 1e6)
    tp = TrafficProgram.onoff(prog.n_flows, horizon_us=horizon_us,
                              **TCP_TRF_ONOFF)
    points = toy_traffic_points(prog.n_flows, horizon_us)
    return dataclasses.replace(prog, traffic=tp), points


def tcp_trf_check(kc, dev, name: str) -> dict:
    """Phase 3w: the ``TRF`` arm of ``tcp_advance`` against the plain loop
    on the card at ``TCP_R`` rows x ``TCP_TRF_CHECK_S`` s: ``name`` "trf"
    (bench_tcp's flows app-limited by :data:`TCP_TRF_ONOFF`) or
    "trf_sweep" (the eight workload points as one ``8 x TCP_R`` grid).
    The whole state bit-equal over one launch and over two split at a
    slot boundary, the grid also per point against that workload's own
    launch; the clip must bind (a flow's deliveries differ from the bulk
    flows'); a
    small program through the plain loop on the CPU against the kernel on
    the card; the launch's device time, µs per slot and bound."""
    import torch
    from tpudes_torch.parallel import tcp_dumbbell as tcp
    from tpudes_torch.parallel.tcp_cuda import tcp_launch
    from tpudes_torch.random import PRNGKey
    from tpudes_torch.traffic.device import app_cum_table

    prog, points = tcp_trf_programs(TCP_TRF_CHECK_S)
    sweep = points if name == "trf_sweep" else None
    if sweep:
        prog = dataclasses.replace(prog, traffic=points[0])
    consts = tcp.build_tcp_consts(prog, dev)
    ops = tcp.workload_operands(prog, sweep, dev)
    C, n = ops["tr_id"].shape[0], prog.n_slots
    var, ecn = (torch.as_tensor(x, device=dev).repeat(C, 1)
                for x in tcp.sweep_operands(prog))
    key = PRNGKey(TCP_CHECK_SEED, device=dev)
    s0 = tcp.init_state(consts, TCP_R, C)

    def app(t0, t1, ops_=ops):
        return app_cum_table(ops_, prog.traffic.epoch_us, consts["slot_us"],
                             t0, t1)

    table = app(0, n)
    census = {}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    want = tcp.tcp_advance_math(consts, s0, key, 0, n, var, ecn, census,
                                table)
    torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    got = tcp_launch(consts, s0, key, 0, n, var, ecn, table)
    split = n // 2 + 1
    two = tcp_launch(consts, tcp_launch(consts, s0, key, 0, split, var, ecn,
                                        app(0, split)),
                     key, split, n, var, ecn, app(split, n))
    bulk = tcp_launch(consts, s0, key, 0, n, var, ecn)
    torch.cuda.synchronize()
    what = f"tcp_advance ({name})"
    err = 0.0
    for k, _, _ in tcp.TCP_STATE:
        for how, x in (("one launch", got), ("two launches", two)):
            if not torch.equal(bits_of(x[k]), bits_of(want[k])):
                fail(f"{what} ({how}) vs plain loop: {k} differs")
        err = max(err, (got[k].double() - want[k].double()).abs()
                  .nan_to_num().max().item())
    delivered = int(want["delivered"].sum())
    bound_flows = int((want["delivered"] != bulk["delivered"]).sum())
    if delivered <= 0 or bound_flows == 0:
        fail(f"{what}: nothing delivered, or the app limit did not bind "
             f"(every flow delivered what the bulk flows did)")
    if sweep:
        for c, tp in enumerate(points):
            own_ops = tcp.workload_operands(
                dataclasses.replace(prog, traffic=tp), None, dev)
            one = tcp_launch(consts, {k: v[c:c + 1].contiguous()
                                      for k, v in s0.items()}, key, 0, n,
                             var[c:c + 1].contiguous(),
                             ecn[c:c + 1].contiguous(), app(0, n, own_ops))
            for k, _, _ in tcp.TCP_STATE:
                if not torch.equal(bits_of(got[k][c]), bits_of(one[k][0])):
                    fail(f"{what}: point {c} differs from its own launch "
                         f"in {k}")
    print(f"{what} vs plain loop: {len(tcp.TCP_STATE)} state arrays "
          f"bit-equal at F={consts['F']} C={C} R={TCP_R}, {n} slots "
          f"({TCP_TRF_CHECK_S} s), over one launch and over two split at "
          f"slot {split}" + ("; each point == its own launch" if sweep
                             else "")
          + f"; delivered {delivered}, {bound_flows} of "
          f"{want['delivered'].numel()} flow counts differ from the bulk "
          f"flows', census {census_line(census)}; "
          f"plain loop wall {plain_s:.3f} s", flush=True)

    small, small_pts = tcp_trf_programs(0.5)
    if sweep:
        small = dataclasses.replace(small, traffic=small_pts[0])
    kw = dict(traffic_sweep=small_pts) if sweep else {}
    on_cpu = tcp.run_tcp_dumbbell(small, PRNGKey(3), 8, device="cpu", **kw)
    on_gpu = tcp.run_tcp_dumbbell(small, PRNGKey(3), 8, device=dev, **kw)
    for c, (a, b) in enumerate(zip(on_cpu if sweep else [on_cpu],
                                   on_gpu if sweep else [on_gpu])):
        for k in ("delivered", "drops", "mean_queue", "cwnd_final"):
            if not np.array_equal(a[k], b[k]):
                fail(f"small dumbbell ({name}, point {c}): CPU plain loop "
                     f"vs kernel differs in {k}")
    print(f"small dumbbell ({name}, {C} x 8 x 0.5 s): CPU plain loop == "
          f"kernel on the card", flush=True)

    ms, host_ms = timed_ms(lambda: tcp_launch(consts, s0, key, 0, n, var,
                                              ecn, table),
                           TCP_TIMED_CALLS, reps=3)
    bulk_ms, _ = timed_ms(lambda: tcp_launch(consts, s0, key, 0, n, var,
                                             ecn), TCP_TIMED_CALLS, reps=3)
    bound_ms, bound_by = tcp_bound(consts, s0, got, n, table)
    us_slot = ms * 1e3 / n
    print(f"{what}: one launch of {C} x {TCP_R} rows, {n} slots: device "
          f"{ms:.4f} ms/launch = {us_slot:.4f} us/slot (host "
          f"{host_ms:.4f} ms/call; the same launch without the app limit "
          f"{bulk_ms:.4f} ms), plain loop wall {plain_s * 1e3:.1f} ms = "
          f"{plain_s * 1e6 / n:.1f} us/slot, bound {bound_ms * 1e3:.3f} us "
          f"({bound_by})", flush=True)
    return dict(err=err, ms=ms, bulk_ms=bulk_ms, plain_ms=plain_s * 1e3,
                slots=n, us_per_slot=us_slot, bound=(bound_ms, bound_by),
                plain_sim_s_per_wall_s=C * TCP_R * TCP_TRF_CHECK_S / plain_s)


def tcp_trf_bench(kc, dev, check: dict, grid: dict) -> dict:
    """Phase 5trf: the app-limited bench_tcp (:func:`tcp_trf_programs`) at
    ``TCP_R`` replicas x ``TCP_SIM_S`` s, one warm run and
    ``TCP_TIMED_RUNS`` counted runs on keys 1.. (one launch each), then
    the eight-point workload grid once, counted; prints the JSON line and
    returns the launches of each."""
    from tpudes_torch.parallel.tcp_dumbbell import run_tcp_dumbbell
    from tpudes_torch.random import PRNGKey

    prog, points = tcp_trf_programs(TCP_SIM_S)
    F = prog.n_flows
    link_mbps = (prog.seg_bytes + 40) * 8 / prog.slot_s / 1e6

    def run(seed):
        return run_tcp_dumbbell(prog, PRNGKey(seed), TCP_R, device=dev)

    run(0)                                                  # warm-up
    walls, goodput, launches, out = [], [], None, None
    for i in range(TCP_TIMED_RUNS):
        out, wall, launches = counted(
            kc, lambda: run(1 + i), {"tcp_advance": 1, "tcp_advance:trf": 1},
            "app-limited dumbbell main path")
        g = out["goodput_mbps"]
        if (g.shape != (TCP_R, F) or not np.all(np.isfinite(g))
                or (out["delivered"].sum(1) <= 0).any()
                or g.sum(1).max() > link_mbps):
            fail(f"app-limited bench run {i}: outputs of the wrong shape, "
                 f"not finite, or past the bottleneck")
        walls.append(wall)
        goodput.append(g)
    busy, kernel_ms = device_busy_share(lambda: run(1), "tcp_advance")
    med = statistics.median(walls)
    mean_g = np.mean(goodput, axis=0)
    grid_prog = dataclasses.replace(prog, traffic=points[0])
    swept, grid_wall, grid_launches = counted(
        kc, lambda: run_tcp_dumbbell(grid_prog, PRNGKey(1), TCP_R,
                                     traffic_sweep=points, device=dev),
        {"tcp_advance": 1, "tcp_advance:trf": 1, "tcp_advance:trf_sweep": 1},
        "workload grid main path")
    if len(swept) != len(points) or any(
            (p["delivered"].sum(1) <= 0).any() for p in swept):
        fail("workload grid: a point of the wrong count or with a replica "
             "that delivered nothing")
    line = dict(
        phase="bench_tcp_app_limited", replicas=TCP_R, n_flows=F,
        sim_s=TCP_SIM_S, n_slots=prog.n_slots,
        workload=dict(model="onoff", **TCP_TRF_ONOFF),
        sim_s_per_wall_s=TCP_R * TCP_SIM_S / med, wall_median_s=med,
        wall_min_s=min(walls), wall_max_s=max(walls),
        agg_goodput_mbps=float(mean_g.sum(1).mean()),
        obs_drops_per_replica=float(out["drops"].sum(1).mean()),
        obs_mean_queue_pkts=float(out["mean_queue"].mean()),
        kernel_us_per_slot=check["us_per_slot"], kernel_launches=launches,
        device_busy_share=busy if busy is not None else "not measured",
        profiled_kernel_device_ms=(kernel_ms if kernel_ms is not None
                                   else "not measured"),
        plain_loop_wall_s_at_check=check["plain_ms"] / 1e3,
        grid=dict(points=len(points), wall_s=grid_wall,
                  sim_s_per_wall_s=len(points) * TCP_R * TCP_SIM_S
                  / grid_wall,
                  kernel_us_per_slot=grid["us_per_slot"],
                  kernel_launches=grid_launches,
                  agg_goodput_mbps=[float(p["goodput_mbps"].sum(1).mean())
                                    for p in swept]),
    )
    print(json.dumps(line), flush=True)
    return dict(trf=launches, trf_sweep=grid_launches)


def window_batch(dev):
    """BASELINE round-1 row #3's window batch, as
    ``tpudes/parallel/mesh.py:112-130`` (``make_replica_batch``) draws it,
    from the port's own draws: ``k_pos, k_keys = split(PRNGKey(seed))``,
    :data:`WIN_N` positions uniform in a :data:`WIN_SPREAD` m square at z
    = 0, shared by the :data:`WIN_R` replicas, whose keys are
    ``replica_keys(k_keys, R)``; ``mode_idx[i] = i % 20`` (every OFDM and
    HT mode) and 1,000 B frames.  Returns ``(positions, mode, frame_bytes,
    keys)``."""
    import torch
    from tpudes_torch.ops.wifi_error import ALL_MODES
    from tpudes_torch.random import PRNGKey, replica_keys, split, uniform

    k_pos, k_keys = split(PRNGKey(WIN_SEED, device=dev))
    pos = uniform(k_pos, (WIN_N, 3)) * WIN_SPREAD
    pos[:, 2] = 0.0
    mode = (torch.arange(WIN_N, device=dev) % len(ALL_MODES)).to(torch.int32)
    fb = torch.full((WIN_N,), WIN_FRAME_BYTES, device=dev)
    return pos, mode, fb, replica_keys(k_keys, WIN_R)


def window_live_pairs(tx, det) -> int:
    """The pairs of the windows that may decode, a transmitter's frame at
    a receiver that is not transmitting and clears the sensitivity
    (``(W, N)`` bool transmitters, ``(N, N)`` bool ``det``): the pairs
    that run the error model and draw a coin.  Returns their total."""
    import torch

    txf = tx.double()
    d = det.double() * (1.0 - torch.eye(det.shape[0], device=det.device,
                                        dtype=torch.float64))
    return int(((txf @ d) * (1.0 - txf)).sum().item())


def window_bound(n: int, links: int, n_tx: int, sinr_pairs: int,
                 live: int, hashes: int, nbytes: int) -> tuple:
    """Least time for windows of ``n`` nodes on these inputs: ``links``
    links (:data:`MOB_LINK_F32_OPS` f32 and :data:`MOB_LINK_F64_OPS` f64
    operations each), the column sums over the windows' ``n_tx``
    transmitters (``n`` adds each), the SINR of ``sinr_pairs`` pairs
    (:data:`WIN_SINR_F32_OPS`), the PSR chain of the ``live`` pairs that
    may decode (:data:`BSS_PSR_OPS`) and ``hashes`` threefry hashes (the
    tx draws, the windows' keys and the live pairs' coins), each type at
    its rate, against ``nbytes`` over HBM; the larger wins."""
    f32_ops = (links * MOB_LINK_F32_OPS + n * n_tx
               + sinr_pairs * WIN_SINR_F32_OPS + live * BSS_PSR_OPS)
    f64_ops = links * MOB_LINK_F64_OPS
    int_ops = hashes * (THREEFRY_OPS + 3)
    times = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "operations": max(f32_ops / F32_OPS_PER_S, f64_ops / F64_OPS_PER_S,
                          int_ops / INT32_OPS_PER_S) * 1e3,
    }
    by = max(times, key=times.get)
    return times[by], by


def window_fma_check(dev) -> None:
    """The window kernel's multiply-add over f64 registers (``fma32d``,
    ``window_cuda.fma_check``) against ``xla_math::fma32`` on the card:
    :data:`WIN_FMA_TRIPLES` triples of random bits (every class of f32; NaN
    results compared as NaN) in chunks, and :data:`WIN_FMA_TIES` triples
    whose f64 sum lands on an f32 midpoint (``a = 2^-24 (1 + u) 2^k``, ``b
    = 1 - u``, ``c`` in ``2^k``'s binade).  Fails on any differing bit."""
    import torch
    from tpudes_torch.parallel.window_cuda import fma_check

    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.monotonic()
    bad, chunk = 0, min(1 << 25, WIN_FMA_TRIPLES)
    for _ in range(WIN_FMA_TRIPLES // chunk):
        a, b, c = (torch.randint(-2**31, 2**31, (chunk,), device=dev,
                                 generator=gen, dtype=torch.int64)
                   .to(torch.int32).view(torch.float32) for _ in range(3))
        got, want = fma_check(a, b, c)
        nan = torch.isnan(want)
        bad += int((torch.isnan(got) != nan).sum())
        bad += int((got[~nan].view(torch.int32)
                    != want[~nan].view(torch.int32)).sum())
    m = WIN_FMA_TIES
    u = torch.randint(1, 300, (m,), device=dev, generator=gen).double() \
        * 2.0 ** -23
    k = torch.randint(-100, 100, (m,), device=dev, generator=gen).double()
    cm = torch.randint(1, 1 << 23, (m,), device=dev, generator=gen).double()
    got, want = fma_check((2.0 ** -24 * (1 + u) * 2.0 ** k).float(),
                          (1 - u).float(),
                          ((1 + cm * 2.0 ** -23) * 2.0 ** k).float())
    ties = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    torch.cuda.synchronize()
    if bad or ties:
        fail(f"wifi_window's fma32d differs from fma32 on {bad} random and "
             f"{ties} tie triples")
    print(f"wifi_window fma32d == xla_math::fma32 on {WIN_FMA_TRIPLES} "
          f"random-bit triples and {m} double-rounding ties "
          f"({time.monotonic() - t0:.1f} s)", flush=True)


def window_check(kc, dev) -> dict:
    """Phase 3win: ``wifi_window`` against its plain version on the card
    at BASELINE round-1 row #3's shape (:func:`window_batch`, 65 nodes x
    512 replicas x 256 windows, tx_prob 0.25): the scan's ``(R,)`` totals
    equal over all 256 windows; the single window at the same ``(R, N)``,
    its transmitters window 0's draws, ``ok``, ``sinr`` and ``rx_dbm``
    bit-equal for NIST and table, its decodes summing to the scan's first
    window; the graft entry's shape (``__graft_entry__.py:29-38``: 32
    nodes in a 60 m cube, every fourth transmitting, mode 7, 1,000 B)
    through ``wifi_phy_window`` on the card against the CPU; each
    kernel's device time (CUDA events behind a sleep kernel, around its
    launch wrapper on card tensors, so that no host sync falls inside the
    timed run), its bound, the plain version's time and pair evaluations a
    second; the entry point's time (``multi_window_scan``, ``replicated``:
    each call reads the modes' range back to the host) on its own line."""
    import torch
    from tpudes_torch.parallel import kernels as win
    from tpudes_torch.parallel.window_cuda import (
        geometry_launch,
        scan_launch,
        window_launch,
    )
    from tpudes_torch.random import PRNGKey, uniform, window_keys

    window_fma_check(dev)
    pos, mode, fb, keys = window_batch(dev)
    prob = torch.full((WIN_N,), WIN_TX_PROB, device=dev)
    N, R, W = WIN_N, WIN_R, WIN_W
    out = {}

    # the scan
    got = win.multi_window_scan(pos, WIN_TX_PROB, mode, fb, keys, W,
                                device=dev)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    want = win.scan_math(pos, prob, mode, fb, keys, W)
    torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    if not torch.equal(got, want):
        fail(f"wifi_window scan vs plain: {int((got != want).sum())} of {R} "
             f"replicas' totals differ")
    kk = window_keys(keys, W)                               # (R, W, 2, 2)
    tx_all = uniform(kk[:, :, 0], N) < prob                 # (R, W, N)
    n_tx = int(tx_all.sum())
    params = win.WindowParams()
    t0 = time.monotonic()
    rx_dbm, rx_w = win.geometry(pos, params)
    det = rx_dbm >= params.rx_sensitivity_dbm
    torch.cuda.synchronize()
    gplain_s = time.monotonic() - t0
    live = window_live_pairs(tx_all.reshape(-1, N), det)
    # the kernel's time: its two launches on card tensors, no host sync
    # inside the timed run; the entry's (multi_window_scan reads the modes'
    # range back to the host) on its own line
    ms, _ = timed_ms(lambda: scan_launch(pos, prob, mode, fb, keys, W),
                     WIN_SCAN_CALLS, reps=3)
    entry_ms, host_ms = timed_ms(lambda: win.multi_window_scan(
        pos, WIN_TX_PROB, mode, fb, keys, W, device=dev), WIN_SCAN_CALLS,
        reps=3)
    bound = window_bound(N, N * N, n_tx, live, live, R * W * (N + 3) + live,
                         pos.nbytes + prob.nbytes + mode.nbytes + fb.nbytes
                         + keys.nbytes + R * 4)
    pairs = R * W * N * N
    print(f"wifi_window scan vs plain: {R} totals equal at N={N} R={R} "
          f"W={W} (mean {got.double().mean().item():.2f} frames a replica, "
          f"{n_tx / (R * W):.2f} transmitters a window, "
          f"{live} pairs that may decode, {live / (R * W):.1f} a window); "
          f"device {ms:.4f} ms/launch (scan_launch: the geometry and the "
          f"scan kernel) = {pairs / (ms * 1e-3):.4g} pair evaluations/s; "
          f"plain version {plain_s * 1e3:.1f} ms; bound "
          f"{bound[0] * 1e3:.3f} us ({bound[1]})", flush=True)
    print(f"wifi_window scan entry (multi_window_scan, its modes' range "
          f"read back): {entry_ms:.4f} ms/call behind a sleep kernel, host "
          f"{host_ms:.4f} ms/call", flush=True)
    out["scan"] = dict(err=0.0, ms=ms, plain_ms=plain_s * 1e3, bound=bound,
                       pairs_per_s=pairs / (ms * 1e-3), live=live,
                       mean_frames=got.double().mean().item(),
                       entry_ms=entry_ms)

    # the scan's geometry kernel
    g_w, g_det = geometry_launch(pos)
    torch.cuda.synchronize()
    if not torch.equal(bits_of(g_w), bits_of(rx_w)) or not torch.equal(
            g_det, det):
        fail("wifi_window geometry vs plain: rx_w or det differs")
    gms, ghost = timed_ms(lambda: geometry_launch(pos), 20, reps=3)
    gbound = window_bound(N, N * N, 0, 0, 0, 0,
                          pos.nbytes + g_w.nbytes + g_det.nbytes)
    print(f"wifi_window geometry vs plain: rx_w and det bit-equal at N={N} "
          f"({int(det.sum())} of {N * N} pairs detectable); device "
          f"{gms:.4f} ms/launch (host {ghost:.4f} ms/call); plain version "
          f"{gplain_s * 1e3:.2f} ms; bound {gbound[0] * 1e3:.4f} us "
          f"({gbound[1]})", flush=True)
    out["geometry"] = dict(err=0.0, ms=gms, plain_ms=gplain_s * 1e3,
                           bound=gbound)

    # the single window at the same (R, N): window 0's transmitters
    posR = pos.expand(R, N, 3).contiguous()
    modeR = mode.expand(R, N).contiguous()
    fbR = fb.expand(R, N).contiguous()
    tx0 = tx_all[:, 0].contiguous()
    k_phy = kk[:, 0, 1].contiguous()
    first = int(win.multi_window_scan(pos, WIN_TX_PROB, mode, fb, keys, 1,
                                      device=dev).sum())
    for model in ("nist", "table"):
        params = win.WindowParams(error_model=model)
        run = win.replicated()
        g = run(posR, tx0, modeR, fbR, k_phy, params, device=dev)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        w = win.window_math(posR, tx0, modeR, fbR, uniform(k_phy, (N, N)),
                            params)
        torch.cuda.synchronize()
        wplain_s = time.monotonic() - t0
        err = 0.0
        for name, a, b in zip(("ok", "sinr", "rx_dbm"), g, w):
            if not torch.equal(bits_of(a) if a.dtype != torch.bool else a,
                               bits_of(b) if b.dtype != torch.bool else b):
                fail(f"wifi_window ({model}) vs plain: {name} differs")
            if a.dtype != torch.bool:
                err = max(err, (a.double() - b.double()).abs().nan_to_num()
                          .max().item())
        if model == "nist" and int(g[0].sum()) != first:
            fail(f"wifi_window: the window's decodes ({int(g[0].sum())}) "
                 f"differ from the scan's first window's ({first})")
        wms, _ = timed_ms(lambda: window_launch(posR, tx0, modeR, fbR,
                                                k_phy, params),
                          WIN_WINDOW_CALLS, reps=3)
        wentry, whost = timed_ms(lambda: run(posR, tx0, modeR, fbR, k_phy,
                                             params, device=dev),
                                 WIN_WINDOW_CALLS, reps=3)
        wlive = window_live_pairs(tx0, det)
        nbytes = (posR.nbytes + tx0.nbytes + modeR.nbytes + fbR.nbytes
                  + k_phy.nbytes + sum(x.nbytes for x in g))
        wbound = window_bound(N, R * N * N, int(tx0.sum()), R * N * N,
                              wlive, wlive, nbytes)
        print(f"wifi_window ({model}) vs plain: ok, sinr, rx_dbm bit-equal "
              f"at N={N} R={R} ({int(g[0].sum())} frames decoded"
              + (f", the scan's first window's {first}" if model == "nist"
                 else "") + f"); device {wms:.4f} ms/launch "
              f"(window_launch) = {R * N * N / (wms * 1e-3):.4g} pair "
              f"evaluations/s; plain version {wplain_s * 1e3:.1f} ms; bound "
              f"{wbound[0] * 1e3:.3f} us ({wbound[1]})", flush=True)
        print(f"wifi_window ({model}) entry (replicated(), its modes' range "
              f"read back): {wentry:.4f} ms/call behind a sleep kernel, host "
              f"{whost:.4f} ms/call", flush=True)
        out[model] = dict(err=err, ms=wms, plain_ms=wplain_s * 1e3,
                          bound=wbound, entry_ms=wentry)

    # the graft entry's shape (__graft_entry__.py:29-38)
    n = 32
    key = PRNGKey(0, device=dev)
    epos = uniform(key, (n, 3)) * 60.0
    etx = torch.zeros(n, dtype=torch.bool, device=dev)
    etx[::4] = True
    emode = torch.full((n,), 7, dtype=torch.int32, device=dev)
    efb = torch.full((n,), 1000.0, device=dev)
    g = win.wifi_phy_window(epos, etx, emode, efb, key, device=dev)
    w = win.wifi_phy_window(epos.cpu(), etx.cpu(), emode.cpu(), efb.cpu(),
                            key.cpu(), device="cpu")
    for name, a, b in zip(("ok", "sinr", "rx_dbm"), g, w):
        a = a.cpu()
        if a.shape != (n, n) or not torch.equal(
                bits_of(a) if a.dtype != torch.bool else a,
                bits_of(b) if b.dtype != torch.bool else b):
            fail(f"wifi_phy_window (graft entry shape): {name} on the card "
                 f"differs from the CPU's")
    if not torch.isfinite(g[1]).all() or not torch.isfinite(g[2]).all():
        fail("wifi_phy_window (graft entry shape): sinr or rx_dbm not "
             "finite")
    print(f"wifi_phy_window at the graft entry's shape (N={n}, every "
          f"fourth node transmitting, mode 7, 1000 B): card == CPU, "
          f"{int(g[0].sum())} frames decoded", flush=True)
    out["split"] = window_stage_split(dev, "wifi_window")
    return out


def window_inputs(dev) -> dict:
    """The window's bench-width inputs on the card, ready for the launch
    wrappers (no host sync in a call): :func:`window_batch`, ``prob``, and
    the single window at ``(R, N)`` (``posR``, ``modeR``, ``fbR``, window
    0's transmitters ``tx0`` and coin keys ``k_phy``)."""
    import torch
    from tpudes_torch.random import uniform, window_keys

    pos, mode, fb, keys = window_batch(dev)
    kk = window_keys(keys, 1)[:, 0]
    R, N = WIN_R, WIN_N
    return dict(pos=pos, mode=mode, fb=fb, keys=keys,
                prob=torch.full((N,), WIN_TX_PROB, device=dev),
                posR=pos.expand(R, N, 3).contiguous(),
                modeR=mode.expand(R, N).contiguous(),
                fbR=fb.expand(R, N).contiguous(),
                tx0=(uniform(kk[:, 0], N) < WIN_TX_PROB).contiguous(),
                k_phy=kk[:, 1].contiguous())


def same_window(a, b) -> bool:
    """Whether two ``(ok, sinr, rx_dbm)`` are bit-equal."""
    import torch

    return all(torch.equal(bits_of(x), bits_of(y)) for x, y in zip(a, b))


def window_stage_split(dev, label: str) -> dict:
    """The stage probe of ``wifi_window`` (``window_cuda.scan_profile`` and
    ``window_profile``: the kernels' profiling instantiations, each lane
    reading ``clock64()`` at its stage edges) at bench width: the scan of
    :data:`WIN_W` windows and the window (NIST and table) at ``WIN_R x
    WIN_N``, each probe's outputs equal to the main launch's; the
    warp-cycles a window spends in each stage (each warp's slowest lane,
    summed over warps), the probe launch's device time (CUDA events) and
    nvidia-smi's SM clock just after.  Returns the split of each."""
    import torch
    from tpudes_torch.parallel import kernels as win
    from tpudes_torch.parallel.window_cuda import (
        WIN_PROF_STAGES,
        scan_launch,
        scan_profile,
        window_launch,
        window_profile,
    )

    x = window_inputs(dev)
    split = {}
    runs = {"scan": (lambda: scan_launch(x["pos"], x["prob"], x["mode"],
                                         x["fb"], x["keys"], WIN_W),
                     lambda: scan_profile(x["pos"], x["prob"], x["mode"],
                                          x["fb"], x["keys"], WIN_W))}
    for model in ("nist", "table"):
        params = win.WindowParams(error_model=model)
        args = (x["posR"], x["tx0"], x["modeR"], x["fbR"], x["k_phy"], params)
        runs[model] = (lambda a=args: window_launch(*a),
                       lambda a=args: window_profile(*a))
    for name, (main, probe) in runs.items():
        want = main()
        probe()                                                # warm-up
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        got, cyc = probe()
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        clock = sm_clock_line()
        if not (torch.equal(got, want) if name == "scan"
                else same_window(got, want)):
            fail(f"{label} window probe ({name}): outputs differ from the "
                 f"main launch's")
        per = dict(zip(WIN_PROF_STAGES, cyc.tolist()))
        split[name] = dict(per, total=sum(per.values()), probe_ms=ms,
                           nvidia_smi_clocks_sm_max=clock)
        print(f"{label} stage probe ({name}, N={WIN_N} R={WIN_R}"
              + (f" W={WIN_W}" if name == "scan" else "")
              + "): warp-cycles a window "
              + ", ".join(f"{k} {v:.1f}" for k, v in per.items())
              + f"; total {sum(per.values()):.1f}; probe launch {ms:.4f} ms; "
              f"nvidia-smi clocks.sm, clocks.max.sm {clock}", flush=True)
    return split


def window_compare(old_lib, dev, card: str, old_dir: str) -> dict:
    """The window half of the compare mode: the old and new
    ``wifi_window`` equal at bench width (the scan's :data:`WIN_R` totals
    over :data:`WIN_W` windows; the window's ``ok``, ``sinr`` and
    ``rx_dbm`` at ``WIN_R x WIN_N``, NIST and table), their times in turns
    (old, new, new, old): each launch's device time (CUDA events; the scan
    with its geometry launch) and the entry point's wall (median of three
    runs a turn, ``multi_window_scan`` / ``replicated``); then the stage
    probe of the new kernels, and of the old where its library has
    ``wifi_scan_profile``.  Returns the ``window_old_vs_new`` line."""
    import torch
    from tpudes_torch.parallel import kernels as win
    from tpudes_torch.parallel.window_cuda import scan_launch, window_launch

    x = window_inputs(dev)
    result = dict(phase="window_old_vs_new", card=card, old=old_dir,
                  n_nodes=WIN_N, replicas=WIN_R, windows=WIN_W, programs={})
    runs = {"scan": (
        lambda: scan_launch(x["pos"], x["prob"], x["mode"], x["fb"],
                            x["keys"], WIN_W),
        lambda seed: win.multi_window_scan(x["pos"], WIN_TX_PROB, x["mode"],
                                           x["fb"], x["keys"], WIN_W,
                                           device=dev),
        WIN_SCAN_CALLS)}
    for model in ("nist", "table"):
        params = win.WindowParams(error_model=model)
        args = (x["posR"], x["tx0"], x["modeR"], x["fbR"], x["k_phy"], params)
        runs[model] = (lambda a=args: window_launch(*a),
                       lambda seed, a=args: win.replicated()(*a, device=dev),
                       WIN_WINDOW_CALLS)
    for name, (launch, entry, calls) in runs.items():
        new = launch()
        with kernel_library(old_lib, "wifi_window"):
            was = launch()
        torch.cuda.synchronize()
        if not (torch.equal(new, was) if name == "scan"
                else same_window(new, was)):
            fail(f"compare (window {name}): outputs differ between old and "
                 f"new")
        times, walls = in_turns(old_lib, "wifi_window", launch, entry, calls)
        line = dict(old_ms=times["old"], new_ms=times["new"],
                    new_over_old=statistics.mean(times["new"])
                    / statistics.mean(times["old"]),
                    old_wall_s=walls["old"], new_wall_s=walls["new"],
                    wall_new_over_old=statistics.mean(walls["new"])
                    / statistics.mean(walls["old"]))
        result["programs"][name] = line
        print(f"compare (window {name}, N={WIN_N} R={WIN_R}"
              + (f" W={WIN_W}" if name == "scan" else "")
              + f"): outputs equal; old {line['old_ms']} ms, new "
              f"{line['new_ms']} ms a launch (new/old "
              f"{line['new_over_old']:.4f}); walls old {walls['old']}, new "
              f"{walls['new']} s", flush=True)
    result["split_new"] = window_stage_split(dev, "new")
    if hasattr(old_lib, "wifi_scan_profile"):
        with kernel_library(old_lib, "wifi_window"):
            result["split_old"] = window_stage_split(dev, "old")
    else:
        result["split_old"] = "not measured: the old kernel has no probe"
    return result


def window_main(kc, dev) -> dict:
    """Phase 5win: the window's main paths, counted: the scan at BASELINE
    row #3's shape (``multi_window_scan`` over the :data:`WIN_R` replica
    keys, one launch) and the window over the same batch, NIST and table
    (``replicated``, one launch each).  Returns each run's launches."""
    import torch
    from tpudes_torch.parallel import kernels as win
    from tpudes_torch.random import uniform, window_keys

    pos, mode, fb, keys = window_batch(dev)
    total, wall, scan_l = counted(
        kc, lambda: win.multi_window_scan(pos, WIN_TX_PROB, mode, fb, keys,
                                          WIN_W, device=dev),
        {"wifi_window": 2, "wifi_window:geometry": 1, "wifi_window:scan": 1},
        "window scan main path")
    if total.shape != (WIN_R,) or (total <= 0).any():
        fail("window scan main path: totals of the wrong shape or a "
             "replica with no decoded frame")
    kk = window_keys(keys, 1)[:, 0]
    tx0 = uniform(kk[:, 0], WIN_N) < WIN_TX_PROB
    args = (pos.expand(WIN_R, WIN_N, 3), tx0, mode.expand(WIN_R, WIN_N),
            fb.expand(WIN_R, WIN_N), kk[:, 1])
    out = {"scan": scan_l}
    for model in ("nist", "table"):
        params = win.WindowParams(error_model=model)
        (ok, sinr, rx_dbm), _, out[model] = counted(
            kc, lambda: win.replicated()(*args, params, device=dev),
            {"wifi_window": 1, "wifi_window:table": int(model == "table")},
            f"window main path ({model})")
        if ok.shape != (WIN_R, WIN_N, WIN_N) or not torch.isfinite(
                rx_dbm).all() or not torch.isfinite(sinr).all():
            fail(f"window main path ({model}): outputs of the wrong shape "
                 f"or not finite")
    print(json.dumps(dict(
        phase="bench_phy_window", n_nodes=WIN_N, replicas=WIN_R,
        windows=WIN_W, tx_prob=WIN_TX_PROB, frame_bytes=WIN_FRAME_BYTES,
        scan_wall_s=wall,
        pair_evaluations_per_wall_s=WIN_R * WIN_W * WIN_N ** 2 / wall,
        mean_frames_per_replica=total.double().mean().item(),
        kernel_launches=scan_l)), flush=True)
    return out


def as_rounds_needed(g: dict, n: int, rounds: int) -> int:
    """The Bellman-Ford rounds this graph's data needs: those of the first
    ``rounds`` that change the ``(D, N)`` table (the plain rounds of
    ``spf_math``, stopped at the first that changes nothing)."""
    import torch
    from tpudes_torch.parallel.as_flows import INF

    dsts = g["dsts"].long()
    D = dsts.shape[0]
    dist = torch.full((D, n), INF, device=dsts.device)
    dist[torch.arange(D, device=dsts.device), dsts] = 0.0
    idx = g["u"][None, :].expand(D, -1)
    for r in range(rounds):
        new = dist.scatter_reduce(1, idx, dist[:, g["v"]] + g["w"][None, :],
                                  "amin", include_self=True)
        if torch.equal(new, dist):
            return r
        dist = new
    return rounds


def as_spf_bound(g: dict, n: int, needed: int, outs) -> tuple:
    """Least time for one ``as_spf`` launch: the CSR and the destinations
    read once and the three ``(D, N)`` tables written once over HBM,
    against ``D 2E (2 needed + 4)`` f32 operations (each round an add and a
    min an edge; the next hop a score, a min, a product and a compare)."""
    D, E2 = g["dsts"].shape[0], g["col_v"].shape[0]
    nbytes = sum(g[k].nbytes for k in ("row_ptr", "col_v", "col_w", "col_e",
                                       "dsts"))
    nbytes += sum(x.nbytes for x in outs)
    ops = D * E2 * (2 * needed + 4)
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": ops / F32_OPS_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def as_fluid_census(args, z, rounds: int) -> dict:
    """The work the fluid stage's data needs over the ``(C, R)`` grid of
    :func:`fluid_inputs`' ``args`` and the draws ``z``, summed over the
    rows and the rounds each row runs before its fixed point (a row stops
    after a round that moves none of its ``lfrac``; the rounds after it
    would repeat it): ``row_rounds``; ``exps``, the flow-hop
    contributions whose exponent (the sum of ``lfrac`` along the path
    before the hop) is not 0, since ``exp(0)`` is 1; ``logs``, the link
    updates whose argument is not 1 (``log(1)`` is 0, and the new
    ``lfrac`` is not 0 where it is not).  ``fluid_math`` runs the rounds
    one at a time."""
    import torch
    from tpudes_torch.parallel import as_flows as asf

    t, fm, scale = args[:3]
    reached, jitter, hj2 = args[5:8]
    hop_link = t["hop_link"].long()
    F, H = hop_link.shape
    C, R, L = scale.shape[0], z.shape[0], t["c"].shape[0]
    lfrac = torch.zeros((C, R, L), dtype=torch.float32, device=z.device)
    active = torch.ones((C, R, 1), dtype=torch.bool, device=z.device)
    census = dict(row_rounds=0, exps=0, logs=0)
    for _ in range(rounds):
        padded = torch.cat([lfrac, torch.zeros_like(lfrac[..., :1])], -1)
        lg = torch.zeros((C, R, F), dtype=torch.float32, device=z.device)
        for h in range(H):
            census["exps"] += int(((lg != 0) & (hop_link[:, h] >= 0)
                                   & active).sum())
            lg = lg + padded[..., hop_link[:, h] % (L + 1)]
        _, new = asf.fluid_math(t, fm, scale, z, reached, jitter, hj2, 1,
                                lfrac)
        census["logs"] += int(((new != 0) & active).sum())
        census["row_rounds"] += int(active.sum())
        active &= (new.view(torch.int32)
                   != lfrac.view(torch.int32)).any(-1, True)
        lfrac = new
    return census


def as_fluid_bound(t: dict, args, out: dict, census: dict,
                   carry: bool = False) -> tuple:
    """Least time for the draws and the fluid stage over the ``(C, R)``
    grid: the tables' blob, the rates' operands and the key read once and
    the outputs ``out`` written once over HBM (the main path's: no ``z``;
    and the carried log deliveries in and out over a split run), against
    the operations this data needs (:func:`as_fluid_census`): each
    replica's draws (a threefry hash
    for its key and one a flow, then an ``erf_inv`` a flow), a rate exp a
    grid row and flow, each round a row runs before its fixed point
    (``row_rounds``) a contribution (a product, a sum; an exp where its
    exponent is not 0, ``exps``) a flow-hop and a load product, division
    and min a link (a log where its argument is not 1, ``logs``), then a
    delay (a min, a difference, a division, a multiply-add, two sums) a
    link and a sum a flow-hop, and a survival exp a flow; f32 (and the
    hash's integer operations) and f64 (the multiply-adds) each at its
    rate, the larger wins."""
    fm, scale, key, R, reached = args[1:6]
    C = scale.shape[0]
    F = fm.shape[0]
    L = t["c"].shape[0]
    fh = t["fh"]
    nbytes = t["blob"].nbytes + fm.nbytes + scale.nbytes + key.nbytes
    nbytes += reached.nbytes + sum(x.nbytes for x in out.values())
    nbytes += 2 * C * R * L * 4 * carry
    rows = C * R
    f32 = (R * ((1 + F) * THREEFRY_OPS + F * AS_ERFINV_OPS[0])
           + rows * F * (2 * AS_EXP_OPS[0] + 4)
           + census["exps"] * AS_EXP_OPS[0] + census["logs"] * AS_LOG_OPS[0]
           + census["row_rounds"] * (2 * fh + 4 * L) + rows * (6 * L + fh))
    f64 = (R * F * AS_ERFINV_OPS[1] + rows * F * (2 * AS_EXP_OPS[1] + 1)
           + census["exps"] * AS_EXP_OPS[1] + census["logs"] * AS_LOG_OPS[1]
           + rows * L)
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(f32 / F32_OPS_PER_S,
                               f64 / F64_OPS_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def same_bits(x, y) -> bool:
    import torch

    return torch.equal(bits_of(x), bits_of(y))


AS_SPF_OUTPUTS = ("dist", "nh_edge", "nh_node", "path", "hops", "reached")


def as_spf_plain(g: dict, n: int, rounds: int) -> tuple:
    """The plain routing stage and walk (``spf_math``, ``walk_math``)."""
    from tpudes_torch.parallel import as_flows as asf

    dist, nh_edge, nh_node = asf.spf_math(g, n, rounds)
    return (dist, nh_edge, nh_node,
            *asf.walk_math(g, dist, nh_edge, nh_node))


def as_check(kc, dev) -> dict:
    """Phase 3as: ``as_spf`` and ``as_fluid`` against their plain versions
    on the card at bench_as's width (:data:`AS_NODES` nodes,
    :data:`AS_FLOWS` flows, :data:`AS_R` replicas): the routing tables and
    the walk (``dist``, ``nh_edge``, ``nh_node``, ``path``, ``hops``,
    ``reached``) bit-equal to ``spf_math`` and ``walk_math`` for the hop
    metric, the delay metric and :data:`AS_TRUNCATED_ROUNDS` rounds (flows
    left unreachable), the rows in shared memory and in device memory; the
    draws ``z`` and the fluid outputs bit-equal to ``as_replica_draws``
    and ``fluid_math`` for the bench program, the :data:`AS_SCALES` grid
    (``delivered_frac < 1`` required), an ON-OFF workload and a run of one
    round a launch; a toy program through the plain path on the CPU
    against the kernels on the card; each kernel's device time (CUDA
    events behind a sleep kernel, around its launch wrapper on card
    tensors), its bound and the plain version's wall on the card (its
    second call, after the one compared)."""
    import torch
    from tpudes_torch.parallel import as_flows as asf
    from tpudes_torch.parallel.as_cuda import fluid_cuda, spf_cuda
    from tpudes_torch.parallel.programs import toy_as_program
    from tpudes_torch.random import PRNGKey
    from tpudes_torch.scenarios import as_program
    from tpudes_torch.traffic.program import TrafficProgram

    prog = as_program(AS_NODES, AS_FLOWS, AS_SIM_S, seed=AS_SEED)
    out = {}
    for name, p in (("hops", prog),
                    ("delay", dataclasses.replace(prog, spf_metric="delay")),
                    ("truncated", dataclasses.replace(
                        prog, spf_rounds=AS_TRUNCATED_ROUNDS))):
        g = asf.spf_graph(p, dev)
        want = as_spf_plain(g, p.n, p.spf_rounds)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        as_spf_plain(g, p.n, p.spf_rounds)
        torch.cuda.synchronize()
        plain_s = time.monotonic() - t0
        for shared in (None, False):
            got = spf_cuda(g, p.n, p.spf_rounds, shared)
            torch.cuda.synchronize()
            for what, a, b in zip(AS_SPF_OUTPUTS, want, got):
                if not same_bits(a, b):
                    fail(f"as_spf ({name}, rows in "
                         f"{'device' if shared is False else 'shared'} "
                         f"memory) vs spf_math + walk_math: {what} differs")
        unreached = int((want[0] >= asf.INF).sum())
        if name == "truncated" and (not unreached or want[5].all()):
            fail(f"as_spf (truncated): every node or flow reached in "
                 f"{AS_TRUNCATED_ROUNDS} rounds")
        needed = as_rounds_needed(g, p.n, p.spf_rounds)
        ms, host = timed_ms(lambda: spf_cuda(g, p.n, p.spf_rounds),
                            AS_SPF_CALLS, reps=3)
        bound = as_spf_bound(g, p.n, needed, want)
        D = g["dsts"].shape[0]
        print(f"as_spf ({name}) vs spf_math + walk_math: dist, nh_edge, "
              f"nh_node, path, hops, reached bit-equal at N={p.n} D={D} "
              f"2E={g['col_v'].shape[0]} F={AS_FLOWS} "
              f"rounds={p.spf_rounds} ({needed} change the table; "
              f"{unreached} of {D * p.n} entries unreached, "
              f"{int((~want[5]).sum())} flows unreached, mean hops "
              f"{want[4].double().mean().item():.4f}), shared and device "
              f"memory; device {ms:.4f} ms/launch (host {host:.4f} "
              f"ms/call); plain version {plain_s * 1e3:.2f} ms; bound "
              f"{bound[0] * 1e3:.3f} us ({bound[1]})", flush=True)
        if name == "hops":
            # the GLOBAL instantiation, which graphs past the shared rows'
            # limit run, at this graph's width
            gms, ghost = timed_ms(lambda: spf_cuda(g, p.n, p.spf_rounds,
                                                   False), AS_SPF_CALLS,
                                  reps=3)
            print(f"as_spf (hops, rows in device memory): device {gms:.4f} "
                  f"ms/launch (host {ghost:.4f} ms/call)", flush=True)
        out[f"spf_{name}"] = dict(err=0.0, ms=ms, plain_ms=plain_s * 1e3,
                                  bound=bound)

    onoff = dataclasses.replace(prog, traffic=TrafficProgram.onoff(
        AS_FLOWS, AS_ONOFF["peak_pps"], horizon_us=int(AS_SIM_S * 1e6),
        on=AS_ONOFF["on"], off_mean_s=AS_ONOFF["off_mean_s"],
        tr_seed=AS_ONOFF["tr_seed"]))
    cases = (("bench", prog, [1.0], (asf.FP_ROUNDS,)),
             ("sweep", prog, list(AS_SCALES), (asf.FP_ROUNDS,)),
             ("onoff", onoff, [1.0], (asf.FP_ROUNDS,)),
             ("chunked", prog, [1.0], (1,) * asf.FP_ROUNDS))
    for name, p, scales, split in cases:
        args, _ = asf.fluid_inputs(p, PRNGKey(AS_CHECK_KEY), AS_R, scales,
                                   dev)
        want, _, z = asf.fluid_draws_math(*args, asf.FP_ROUNDS)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        asf.fluid_draws_math(*args, asf.FP_ROUNDS)
        torch.cuda.synchronize()
        plain_s = time.monotonic() - t0
        lf = None
        for i, rounds in enumerate(split):
            got, lf = fluid_cuda(*args, rounds, lf,
                                 carry=i + 1 < len(split), z_out=True)
        torch.cuda.synchronize()
        bad = [k for k in want if not same_bits(want[k], got[k])]
        if not same_bits(z, got["z"]):
            bad.append("z")
        if bad:
            fail(f"as_fluid ({name}) vs as_replica_draws + fluid_math: {bad} "
                 f"differ")
        frac = got["delivered_frac"]
        if name == "sweep" and not (frac < 1.0).any():
            fail("as_fluid (sweep): no flow loses at the grid's top scale")
        if not torch.isfinite(frac).all():
            fail(f"as_fluid ({name}): delivered_frac not finite")
        t = args[0]
        census = as_fluid_census(args, z, asf.FP_ROUNDS)
        line = (f"as_fluid ({name}) vs as_replica_draws + fluid_math: z, "
                f"goodput, delay, delivered_frac, max_util bit-equal at "
                f"C={len(scales)} R={AS_R} F={AS_FLOWS} L={t['c'].shape[0]} "
                f"({t['fh']} flow-hops, up to "
                f"{int((t['ptr'][1:] - t['ptr'][:-1]).max())} a link; "
                f"{len(split)} launch(es); {census['row_rounds']} row-rounds "
                f"to the fixed point, {census['exps']} exps and "
                f"{census['logs']} logs the data needs; delivered_frac mean "
                f"{frac.double().mean().item():.6f}, min "
                f"{frac.min().item():.6f}; max_util max "
                f"{got['max_util'].max().item():.4f})")
        if name in ("bench", "sweep"):
            ms, host = timed_ms(lambda: fluid_cuda(*args, asf.FP_ROUNDS),
                                AS_FLUID_CALLS, reps=3)
            bound = as_fluid_bound(t, args, {k: v for k, v in got.items()
                                             if k != "z"}, census)
            line += (f"; device {ms:.4f} ms/launch (host {host:.4f} "
                     f"ms/call); plain version {plain_s * 1e3:.2f} ms; bound "
                     f"{bound[0] * 1e3:.3f} us ({bound[1]})")
            out[f"fluid_{name}"] = dict(err=0.0, ms=ms,
                                        plain_ms=plain_s * 1e3, bound=bound)
        print(line, flush=True)

    # a toy program through the plain path on the CPU vs the kernels
    toy = dataclasses.replace(toy_as_program(64, 6, 16, seed=2),
                              flow_bps=np.linspace(3e6, 9e7, 6))
    key = np.array([0, AS_CHECK_KEY])
    cpu = asf.run_as_flows(toy, key, 8, device="cpu", rate_scale=[1.0, 4.0])
    card = asf.run_as_flows(toy, key, 8, device=dev, rate_scale=[1.0, 4.0])
    for a, b in zip(cpu, card):
        if not same_run(a, b):
            fail("run_as_flows (toy): the card's outputs differ from the "
                 "CPU's")
    print(f"run_as_flows (toy, 64 nodes, 6 flows, 8 replicas, 2 scales): "
          f"card == CPU in every output (delivered_frac min "
          f"{min(float(p['delivered_frac'].min()) for p in card):.4f})",
          flush=True)
    return out


def same_run(a: dict, b: dict) -> bool:
    """Whether two ``run_as_flows`` results (numpy) are equal, floats bit
    for bit."""
    if set(a) != set(b):
        return False
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype == np.float32:
            x, y = x.view(np.uint32), y.view(np.uint32)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            return False
    return True


def as_stage_walls(prog, dev, key: int) -> dict:
    """The host wall (ms, each stage ended by a synchronise) of each stage
    of one ``run_as_flows`` run as the entry point makes it: the graph's
    tables (host numpy and their copies), ``as_spf`` (the routing and the
    walk), the fluid tables (``torch.unique``'s read-back), ``as_fluid``
    (the draws and the fixed point) and the copy back.  The entry point's
    own run has no synchronise between its stages, so the sum exceeds its
    wall."""
    import torch
    from tpudes_torch.parallel import as_flows as asf
    from tpudes_torch.parallel.as_cuda import fluid_launch, spf_launch
    from tpudes_torch.random import PRNGKey

    walls, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        walls[name] = (t1 - t0) * 1e3
        t0 = t1

    g = asf.spf_graph(prog, dev)
    lap("graph")
    _, _, _, path, _, reached = spf_launch(g, prog.n, prog.spf_rounds)
    lap("as_spf")
    t = asf.fluid_tables(prog, path)
    fm = torch.as_tensor(np.float32(prog.flow_bps), device=dev)
    scale = torch.tensor([1.0], device=dev)
    lap("fluid_tables")
    out, _ = fluid_launch(t, fm, scale, PRNGKey(key, device=dev), AS_R,
                          reached, *asf.rate_constants(prog), asf.FP_ROUNDS)
    lap("as_fluid")
    for v in out.values():
        v.cpu()
    lap("copy_back")
    return walls


def device_ops(fn) -> int:
    """The device operations (kernels, copies and fills) the profiler saw
    while ``fn()`` ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def as_bench(kc, dev) -> dict:
    """Phase 5as: bench_as's numerator (``bench.py:1417-1426``): the main
    path ``run_as_flows`` at :data:`AS_NODES` x :data:`AS_FLOWS` x
    :data:`AS_R`, one warm run on key 0 and :data:`AS_TIMED_RUNS` timed
    runs on keys 1..5, each counted (one ``as_spf`` and one ``as_fluid``
    launch, no other launch counter); ``studies_per_s`` is replicas over
    the median wall.  No ``vs_scalar``: it needs the host DES, which the
    port does not have.  Then the busy share and the device operations of
    a run (the profiler), the stages of a run apart
    (:func:`as_stage_walls`, the median of three) and the
    :data:`AS_SCALES` grid once, counted.  Returns the launches of the
    last timed run and of the grid."""
    from tpudes_torch.parallel.as_flows import run_as_flows
    from tpudes_torch.random import PRNGKey
    from tpudes_torch.scenarios import as_program

    prog = as_program(AS_NODES, AS_FLOWS, AS_SIM_S, seed=AS_SEED)

    def run(seed, **kw):
        return run_as_flows(prog, PRNGKey(seed), AS_R, device=dev, **kw)

    run(0)
    walls, frac, launches = [], [], {}
    for i in range(AS_TIMED_RUNS):
        res, wall, launches = counted(kc, lambda: run(1 + i),
                                      {"as_spf": 1, "as_fluid": 1},
                                      "bench_as main path")
        if res["delivered_frac"].shape != (AS_R, AS_FLOWS) or not (
                np.isfinite(res["delivered_frac"]).all()
                and np.isfinite(res["delay_s"]).all()
                and np.isfinite(res["max_util"]).all()):
            fail("bench_as main path: outputs of the wrong shape or not "
                 "finite")
        walls.append(wall)
        frac.append(float(res["delivered_frac"].mean()))
    share, kernel_ms = device_busy_share(lambda: run(AS_TIMED_RUNS + 1),
                                         "as_")
    ops = device_ops(lambda: run(AS_TIMED_RUNS + 1))
    splits = [as_stage_walls(prog, dev, AS_TIMED_RUNS + 1) for _ in range(3)]
    stages = {k: statistics.median(w[k] for w in splits) for k in splits[0]}
    grid, gwall, glaunches = counted(
        kc, lambda: run(AS_TIMED_RUNS + 2, rate_scale=list(AS_SCALES)),
        {"as_spf": 1, "as_fluid": 1, "as_fluid:sweep": 1},
        "bench_as rate-scale grid")
    if len(grid) != len(AS_SCALES) or not (
            grid[-1]["delivered_frac"] < 1.0).any():
        fail("bench_as rate-scale grid: wrong points or no loss at the top")
    med = statistics.median(walls)
    print(json.dumps(dict(
        phase="bench_as", n_nodes=AS_NODES, n_flows=AS_FLOWS,
        replicas=AS_R, studies_per_s=AS_R / med, wall_median_s=med,
        wall_min_s=min(walls), wall_max_s=max(walls), walls_s=walls,
        delivered_frac=sum(frac) / len(frac), busy_share=share,
        kernel_ms=kernel_ms, device_ops_per_run=ops, stage_ms=stages,
        kernel_launches={k: v for k, v in launches.items() if v},
        grid_points=list(AS_SCALES), grid_wall_s=gwall,
        grid_kernel_launches={k: v for k, v in glaunches.items() if v},
        grid_delivered_frac=[float(p["delivered_frac"].mean())
                             for p in grid])), flush=True)
    return {"bench": launches, "grid": glaunches}


def wired_clone(carry: dict) -> dict:
    return {k: (v.clone() if hasattr(v, "clone") else v)
            for k, v in carry.items()}


def wired_bound(tab: dict, before: dict, after: dict) -> tuple:
    """Least time for one ``wired_advance`` launch: the state read once
    (hop, ready, deliver ``(N, P)``, free, served ``(N, Lo)``) and written
    once (those and the egress buffers, the next events and the step
    counts), the tables read once, over HBM; against the served
    packet-hops of this launch (``served`` after less before) times
    :data:`WIRED_SERVE_OPS` integer operations over the int32 issue
    rate.  ``(ms, "bytes" or "operations", services)``."""
    N, P = after["hop"].reshape(-1, after["hop"].shape[-1]).shape
    Lo = after["free"].shape[-1]
    words = N * (3 * P + 2 * Lo) + N * (5 * P + 2 * Lo + 2)
    nbytes = 4 * words + sum(tab[k].nbytes for k in (
        "paths", "nhops", "pkt_flow", "g2l", "svc", "svcdly"))
    serves = int((after["served"] - before["served"]).sum())
    times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": serves * WIRED_SERVE_OPS / INT32_OPS_PER_S * 1e3}
    by = max(times, key=times.get)
    return times[by], by, serves


def wired_same(want, wm, got, gm, keys, what: str) -> None:
    """Fail unless ``keys`` of two carries, and their ``t``,
    ``next_event`` and ``n_steps`` (where ``gm`` is given), are equal."""
    import torch

    for k in keys:
        if not torch.equal(want[k], got[k]):
            fail(f"wired_advance ({what}) differs from advance_math in {k}")
    if gm is not None and not (
            want["t"] == got["t"]
            and torch.equal(wm["next_event"], gm["next_event"])
            and int(wm["n_steps"]) == int(gm["n_steps"])):
        fail(f"wired_advance ({what}): t, next_event or n_steps differs")


def wired_held(run, hold, timed, what: str) -> tuple:
    """``run()`` (a ``run_hybrid`` call) with ``wired_cuda.advance_launch``
    wrapped: each engine's launches (its priming advance is launch 0)
    whose index ``i`` has ``hold(i)`` or ``timed(i)`` are held against
    ``advance_math`` on a copy of the carry they get, the whole state,
    ``t``, ``next_event`` and ``n_steps`` bit-equal; those with
    ``timed(i)`` are also timed (CUDA events on copies of their carry),
    beside the plain loop's wall and their bound.  Fails unless every
    engine had a timed launch.  Returns ``(run's result, [per timed
    launch dict(ms, plain_ms, bound_ms, bound_by, services, rows,
    packets, slots)], held launches)``; ``ms`` times the wrapper,
    ``kernel_ms`` the kernel alone (``wired_cuda.enqueue``, the wrapper
    without its error word's read-back)."""
    import torch
    from tpudes_torch.parallel import wired as wd
    from tpudes_torch.parallel import wired_cuda

    real = wired_cuda.advance_launch
    index, numbers, held, engines_timed = {}, [], [0], set()

    def launch(tab, carry, t_grant):
        i = index[id(tab)] = index.get(id(tab), -1) + 1
        if not hold(i) and not timed(i):
            return real(tab, carry, t_grant)
        before = wired_clone(carry)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        want, wm = wd.advance_math(tab, wired_clone(carry), t_grant)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        if timed(i):
            pool = [wired_clone(before) for _ in range(11)]
            ms, _ = timed_ms(lambda: wired_cuda.wired_cuda(
                tab, pool.pop(), t_grant), 1)
            # the kernel alone: the wrapper without its error word's
            # read-back (checked after)
            pool = [wired_clone(before) for _ in range(11)]
            errs = []
            kernel_ms, _ = timed_ms(lambda: errs.append(wired_cuda.enqueue(
                tab, pool.pop(), t_grant)[2]), 1)
            if any(e is not None and int(e.item()) != wired_cuda.NO_ERROR
                   for e in errs):
                fail(f"wired_advance ({what}): a timed launch overflowed")
            del pool
        got, gm = real(tab, carry, t_grant)
        torch.cuda.synchronize()
        wired_same(want, wm, got, gm, [k for k, _ in wd.WIRED_STATE],
                   f"{what}, launch {i}")
        held[0] += 1
        if timed(i):
            engines_timed.add(id(tab))
            bound_ms, by, serves = wired_bound(tab, before, want)
            numbers.append(dict(
                ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by,
                services=serves,
                rows=want["hop"].numel() // want["hop"].shape[-1],
                packets=want["hop"].shape[-1],
                slots=int(t_grant) - int(before["t"])))
        return got, gm

    wired_cuda.advance_launch = launch
    try:
        out = run()
    finally:
        wired_cuda.advance_launch = real
    if engines_timed != set(index):
        fail(f"wired_advance ({what}): an engine had no timed launch")
    return out, numbers, held[0]


def wired_check(kc, dev) -> dict:
    """Phase 3wired: ``wired_advance`` against ``advance_math`` on the card.

    - The whole engine on bench_wired's program at full width
      (:data:`WIRED_R` replicas, 5,535 packets a row) over
      :data:`WIRED_CHECK_SLOTS` slots: one launch, two launches (but the
      egress, which a launch clears) and a zero-step window, every state
      array, ``t``, ``next_event`` and ``n_steps`` bit-equal; the plain
      loop's wall.  Then the main path's own launch, 20,000 slots at
      ``SPAN_SLOTS``, timed (CUDA events around the wrapper on copies of
      the carry, behind a sleep kernel) with its bound from its state
      before and after.
    - The space kernel at full width: the four lanes of
      :data:`WIRED_LANES` (1,024 rows a lane, 5,535 packets), the same
      checks.
    - The main path's own launches, ``run_hybrid`` as phase 5hyb runs it
      (:func:`wired_held`): bench_hybrid (a) at k = 4, every launch held
      and timed, and (b), the four-way split at 1,024 replicas, each
      rank's priming advance and first :data:`WIRED_HELD_WINDOWS` windows
      held (real peer ingress from the second on), and its window
      :data:`WIRED_TIMED_WINDOW` held and timed.
    - The stage probe (:func:`wired_stage_split`) on bench_wired's launch
      and the split's rank 3 at its window :data:`WIRED_TIMED_WINDOW`.

    Returns the numbers of the kernels line's three entries: for the
    hybrid's two, the means over the timed launches (device time, plain
    wall, bound)."""
    import torch
    from tpudes_torch.parallel import wired as wd
    from tpudes_torch.parallel import wired_cuda
    from tpudes_torch.parallel.hybrid import run_hybrid

    bench = wd.wired_chain(**WIRED_BENCH)
    lanes = wd.wired_weak_chain(4, **WIRED_LANES)
    key = np.array([0, 11])
    init, _ = wd.build_wired_advance(bench, WIRED_R, device=dev)
    cases = {"whole": (wd.wired_tables(bench, [(bench, None, None)], dev),
                       init(key))}
    init, _, parts = wd.build_wired_space_advance(lanes, WIRED_R, dev)
    cases["lanes"] = (wd.wired_tables(
        lanes, [(s, np.asarray(lanes.link_owner) == k, f)
                for k, (s, f, _) in enumerate(parts)], dev), init(key))
    state = [k for k, _ in wd.WIRED_STATE]
    half = WIRED_CHECK_SLOTS // 2
    out = {}
    for name, (tab, carry0) in cases.items():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        want, wm = wd.advance_math(tab, wired_clone(carry0),
                                   WIRED_CHECK_SLOTS)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        one, om = wired_cuda.wired_cuda(tab, wired_clone(carry0),
                                        WIRED_CHECK_SLOTS)
        zero, zm = wired_cuda.wired_cuda(tab, wired_clone(carry0), 0)
        pz, pzm = wd.advance_math(tab, wired_clone(carry0), 0)
        two, _ = wired_cuda.wired_cuda(tab, wired_clone(carry0), half)
        two, tm = wired_cuda.wired_cuda(tab, two, WIRED_CHECK_SLOTS)
        torch.cuda.synchronize()
        wired_same(want, wm, one, om, state, f"{name}, one launch")
        wired_same(pz, pzm, zero, zm, state, f"{name}, zero-step")
        # a launch clears the egress: two launches hold only the second's
        wired_same(want, wm, two, None, [
            k for k in state if k not in ("eg_hop", "eg_ready")],
            f"{name}, two launches")
        if not torch.equal(wm["next_event"], tm["next_event"]):
            fail(f"wired_advance ({name}, two launches): next_event differs")
        delivered = int((want["deliver"] >= 0).sum())
        egress = int((want["eg_hop"] >= 0).sum())
        if delivered == 0 or (name == "lanes" and egress == 0):
            fail(f"wired_advance ({name}) check delivered or handed over "
                 f"nothing")
        pool = [wired_clone(carry0) for _ in range(11)]
        ms, _ = timed_ms(lambda: wired_cuda.wired_cuda(
            tab, pool.pop(), WIRED_CHECK_SLOTS), 1)
        del pool
        _, _, serves = wired_bound(tab, carry0, want)
        N = want["hop"].numel() // want["hop"].shape[-1]
        print(f"wired_advance ({name}) vs advance_math: state, t, "
              f"next_event, n_steps bit-equal at {N} rows x "
              f"{want['hop'].shape[-1]} packets over {WIRED_CHECK_SLOTS} "
              f"slots (one launch; two launches but the egress; a "
              f"zero-step window), n_steps {int(wm['n_steps'])}, "
              f"{serves} services, {delivered} delivered, egress {egress}; "
              f"device {ms:.4f} ms a launch, plain loop {plain_ms:.1f} ms",
              flush=True)
        out[name] = dict(ms=ms, plain_ms=plain_ms)

    # the main path's launch: bench_wired's whole horizon in one launch
    tab, carry0 = cases["whole"]
    n_slots = WIRED_BENCH["n_slots"]
    after, _ = wired_cuda.wired_cuda(tab, wired_clone(carry0), n_slots)
    pool = [wired_clone(carry0) for _ in range(11)]
    ms, _ = timed_ms(lambda: wired_cuda.wired_cuda(tab, pool.pop(),
                                                   n_slots), 1)
    del pool
    bound_ms, by, serves = wired_bound(tab, carry0, after)
    print(f"wired_advance (whole, the main path's launch): device {ms:.4f} "
          f"ms a launch of {n_slots} slots x {WIRED_R} rows (span "
          f"{wired_cuda.SPAN_SLOTS}), {serves} services, bound "
          f"{bound_ms:.5f} ms ({by})", flush=True)
    numbers = {"whole": dict(ms=ms, plain_ms=out["whole"]["plain_ms"],
                             bound=(bound_ms, by))}

    hkey = np.array([0, HYBRID_KEY])
    weak = wd.wired_weak_chain(4, **HYBRID_WEAK)
    split = wd.wired_chain(**WIRED_SPLIT)
    for name, run, hold, timed in (
            ("lanes", lambda: run_hybrid(
                weak, hkey, 1, transport="batched",
                window_slots=HYBRID_WINDOW, device=dev),
             lambda i: True, lambda i: True),
            ("owned", lambda: run_hybrid(split, hkey, WIRED_R,
                                         transport="local", device=dev),
             lambda i: i <= WIRED_HELD_WINDOWS,
             lambda i: i == WIRED_TIMED_WINDOW)):
        _, per, held = wired_held(run, hold, timed, name)
        if len(per) <= 8:
            for n in per:
                print(f"wired_advance ({name}, the main path's window "
                      f"{WIRED_TIMED_WINDOW}): {n['rows']} rows x "
                      f"{n['packets']} packets over {n['slots']} slots, "
                      f"{n['services']} services; device {n['ms']:.4f} ms "
                      f"(the kernel alone {n['kernel_ms']:.4f}), "
                      f"plain loop {n['plain_ms']:.1f} ms, bound "
                      f"{n['bound_ms']:.5f} ms ({n['bound_by']})",
                      flush=True)
        top = max(per, key=lambda n: n["bound_ms"])
        numbers[name] = dict(
            ms=statistics.mean(n["ms"] for n in per),
            kernel_ms=statistics.mean(n["kernel_ms"] for n in per),
            plain_ms=statistics.mean(n["plain_ms"] for n in per),
            bound=(statistics.mean(n["bound_ms"] for n in per),
                   top["bound_by"]))
        print(f"wired_advance ({name}): {held} launches of the main path "
              f"bit-equal to advance_math; over its {len(per)} timed "
              f"launches ({per[0]['rows']} rows, "
              f"{sum(n['services'] for n in per)} services) device "
              f"{numbers[name]['ms']:.4f} ms a launch (the kernel alone "
              f"{numbers[name]['kernel_ms']:.4f}; min "
              f"{min(n['ms'] for n in per):.4f}, max "
              f"{max(n['ms'] for n in per):.4f}), plain loop "
              f"{numbers[name]['plain_ms']:.2f} ms, bound "
              f"{numbers[name]['bound'][0]:.6f} ms ({top['bound_by']})",
              flush=True)
    wired_stage_split(dev, "phase 3wired", wired_shapes(dev))
    return numbers


def wired_bench(kc, dev) -> dict:
    """Phase 5wired: bench_wired, ``run_wired`` on :data:`WIRED_BENCH` at
    :data:`WIRED_R` replicas, one warm run on key 0 and five timed runs on
    keys 1..5, each counted (one ``wired_advance`` launch, no other
    counter); ``sim_s_per_wall_s`` = R x simulated seconds over the median
    wall.  Rows 1,016..1,023 of the last run must equal a run of 8
    replicas at ``replica_offset=1016``, at least 90 % of the packets be
    delivered and none before its path's least latency; the busy share
    (the profiler).
    Returns the launches of the last timed run."""
    from tpudes_torch.parallel.wired import (
        packet_table,
        run_wired,
        wired_chain,
    )

    prog = wired_chain(**WIRED_BENCH)
    sim_s = prog.n_slots * prog.slot_s

    def run(seed, **kw):
        return run_wired(prog, np.array([0, seed]), kw.pop("r", WIRED_R),
                         device=dev, **kw)

    run(0)
    walls, launches, res = [], {}, None
    for i in range(WIRED_TIMED_RUNS):
        res, wall, launches = counted(kc, lambda: run(1 + i),
                                      {"wired_advance": 1},
                                      "bench_wired main path")
        walls.append(wall)
    tail = run(WIRED_TIMED_RUNS, r=8, replica_offset=WIRED_R - 8)
    for k in ("deliver_slot", "delivered", "served"):
        if not np.array_equal(tail[k], res[k][WIRED_R - 8:]):
            fail(f"bench_wired: rows {WIRED_R - 8}.. differ from a "
                 f"replica_offset run in {k}")
    n_pkts = int(np.asarray(prog.n_pkts).sum())
    flow, birth, _ = packet_table(prog)
    paths = np.asarray(prog.paths)
    cost = np.asarray(prog.service_slots) + np.asarray(prog.delay_slots)
    least = np.where(paths >= 0, cost[np.maximum(paths, 0)], 0).sum(1)
    got = res["deliver_slot"]
    delivered = float((got >= 0).mean())
    if (got.shape != (WIRED_R, n_pkts) or delivered < 0.9
            or ((got >= 0) & (got < (birth + least[flow])[None])).any()):
        fail(f"bench_wired: outputs of the wrong shape, too few deliveries "
             f"({delivered}) or one before its path's least latency")
    share, kernel_ms = device_busy_share(lambda: run(1), "wired_advance")
    med = statistics.median(walls)
    print(json.dumps(dict(
        phase="bench_wired", replicas=WIRED_R, n_links=prog.n_links,
        n_flows=prog.n_flows, packets=n_pkts, n_slots=prog.n_slots,
        slot_s=prog.slot_s, sim_s_per_wall_s=WIRED_R * sim_s / med,
        wall_median_s=med, wall_min_s=min(walls), wall_max_s=max(walls),
        walls_s=walls, delivered_share=delivered,
        services=int(res["served"].sum()),
        busy_share=share if share is not None else "not measured",
        kernel_ms=kernel_ms if kernel_ms is not None else "not measured",
        kernel_launches={k: v for k, v in launches.items() if v},
        equals_replica_offset_rows=True)), flush=True)
    return launches


def hybrid_bench(kc, dev) -> dict:
    """Phase 5hyb: bench_hybrid.  (a) ``bench.py:1178``'s row as it builds
    it, :data:`HYBRID_WEAK` for k = 1, 2, 4, ``transport="batched"``,
    ``window_slots=600``, one replica: a warm run each, then
    :data:`HYBRID_PAIRS` rounds of k in turns; aggregate
    ``sim_s_per_wall_s`` = k x 108 s over the median wall, ``windows``,
    ``ratio_vs_1rank`` (the median of each round's k wall_1 / wall_k);
    each k's result equal to ``run_wired``'s; the k = 4 run counted (one
    ``wired_advance:lanes`` launch a window and the priming one).  (b)
    :data:`WIRED_SPLIT` at :data:`WIRED_R` replicas, ``transport=
    "local"``: a warm run, a counted run (four ``wired_advance:owned``
    launches a window and four priming ones), equal to ``run_wired`` of
    the same program, and :data:`HYBRID_SPLIT_RUNS` timed runs.  Returns
    the counted runs' launches."""
    from tpudes_torch.parallel.hybrid import run_hybrid
    from tpudes_torch.parallel.wired import (
        partition_flows,
        run_wired,
        wired_chain,
        wired_weak_chain,
    )

    key = np.array([0, HYBRID_KEY])
    progs = {k: wired_weak_chain(k, **HYBRID_WEAK) for k in HYBRID_RANKS}

    def once(k):
        t0 = time.monotonic()
        out = run_hybrid(progs[k], key, 1, transport="batched",
                         window_slots=HYBRID_WINDOW, device=dev)
        return time.monotonic() - t0, out

    windows = {}
    for k in HYBRID_RANKS:
        out = once(k)[1]
        want = run_wired(progs[k], key, 1, device=dev)
        for f in ("deliver_slot", "delivered", "served"):
            if not np.array_equal(out[f], want[f]):
                fail(f"bench_hybrid (a) k={k} differs from run_wired in {f}")
        windows[k] = out["windows"]
    walls = {k: [] for k in HYBRID_RANKS}
    for _ in range(HYBRID_PAIRS):
        for k in HYBRID_RANKS:
            walls[k].append(once(k)[0])
    k4 = HYBRID_RANKS[-1]
    n4 = windows[k4] + 1
    _, _, batched = counted(kc, lambda: once(k4),
                            {"wired_advance": n4, "wired_advance:lanes": n4},
                            "bench_hybrid (a) k=4")
    rows = {}
    for k in HYBRID_RANKS:
        med = statistics.median(walls[k])
        ratios = [k * w1 / wk for w1, wk in zip(walls[1], walls[k])]
        rows[str(k)] = dict(
            wall_med_s=med, windows=windows[k],
            agg_sim_s_per_wall_s=k * progs[k].n_slots * progs[k].slot_s / med,
            ratio_vs_1rank=statistics.median(ratios),
            ratio_min=min(ratios), ratio_max=max(ratios))
    print(json.dumps(dict(phase="bench_hybrid_weak_scaling",
                          transport="batched", window_slots=HYBRID_WINDOW,
                          replicas=1, n_slots=HYBRID_WEAK["n_slots"],
                          pairs=HYBRID_PAIRS, rows=rows,
                          kernel_launches_k4={k: v for k, v in
                                              batched.items() if v})),
          flush=True)

    split = wired_chain(**WIRED_SPLIT)

    def local():
        return run_hybrid(split, key, WIRED_R, transport="local", device=dev)

    local()
    kc.reset_launches()
    t0 = time.monotonic()
    got = local()
    cwall = time.monotonic() - t0
    owned = dict(kc.launches)
    n = 4 * (got["windows"] + 1)
    want_counts = {k: 0 for k in owned}
    want_counts.update({"wired_advance": n, "wired_advance:owned": n})
    if owned != want_counts:
        fail(f"bench_hybrid (b) launched {owned}, want {want_counts}")
    want = run_wired(split, key, WIRED_R, device=dev)
    for f in ("deliver_slot", "delivered", "served"):
        if not np.array_equal(got[f], want[f]):
            fail(f"bench_hybrid (b) differs from run_wired in {f}")
    swalls = []
    for _ in range(HYBRID_SPLIT_RUNS):
        t0 = time.monotonic()
        local()
        swalls.append(time.monotonic() - t0)
    med = statistics.median(swalls)
    sim_s = split.n_slots * split.slot_s
    print(json.dumps(dict(
        phase="bench_hybrid_split", transport="local", ranks=4,
        replicas=WIRED_R, windows=got["windows"],
        resident_packets=[int(partition_flows(split, r)[2].size)
                          for r in range(split.n_ranks)],
        sim_s_per_wall_s=WIRED_R * sim_s / med, wall_median_s=med,
        walls_s=swalls, counted_wall_s=cwall, equals_run_wired=True,
        kernel_launches={k: v for k, v in owned.items() if v})),
        flush=True)
    return {"batched": batched, "local": owned}


#: the serving phase (5srv): the four engines' batches at bench width —
#: LTE studies differing in scheduler, BSS studies in horizon (s), TCP
#: studies in their flows' variant (each of the first eight of the 17),
#: AS studies in load scale (AS_SCALES)
SRV_LTE_SCHEDULERS = ("pf", "rr", "tdmt", "fdbet")
SRV_BSS_ENDS_S = (1.4, 1.6, 1.8, 2.0)
SRV_TCP_STUDIES = 8
#: bench.py:976-981 bench_serving_closed_loop's row at its own size
SERVING_CLIENTS, SERVING_STUDIES_PER_CLIENT = 16, 6
SERVING_SLOTS, SERVING_REPLICAS = 50, 1
SERVING_MAX_WAIT_S, SERVING_MAX_BATCH = 0.004, 8
SERVING_CHAOS_NTH = (2, 5, 9)
#: the runtime phase (5rt): hits timed a miss; bench.py:924
#: bench_pipeline_overlap's horizons (fractions of bench_lte's 10 s)
RT_HITS = 5
PIPELINE_FRACTIONS = (0.6, 0.8, 1.0, 1.2, 0.7, 0.9)
PIPELINE_RUNS = 5
#: the sleep kernel a submitted run is queued behind (s)
RT_SLEEP_S = 0.25
#: the checkpoint phase (5ckpt): bench_tcp in this many chunks, killed
#: after the chunk CKPT_KILL_AFTER
CKPT_CHUNKS, CKPT_KILL_AFTER = 4, 2


def same_result(a, b) -> bool:
    """Two results (a dict, or a list of dicts) equal in every field, bit
    for bit."""
    a = a if isinstance(a, list) else [a]
    b = b if isinstance(b, list) else [b]
    return len(a) == len(b) and all(
        set(x) == set(y) and all(np.array_equal(np.asarray(x[k]),
                                                np.asarray(y[k]),
                                                equal_nan=np.asarray(
                                                    x[k]).dtype.kind == "f")
                                 for k in x)
        for x, y in zip(a, b))


def serving_programs(dev) -> dict:
    """The 5srv studies at bench width: ``{engine: (replicas, [(prog,
    extra submit_study kwargs), ...], solo(prog, extra))}``."""
    import torch
    from tpudes_torch.parallel.as_flows import run_as_flows
    from tpudes_torch.parallel.lte_sm import run_lte_sm
    from tpudes_torch.parallel.replicated import run_replicated_bss
    from tpudes_torch.parallel.tcp_dumbbell import (
        VARIANTS,
        run_tcp_dumbbell,
        variant_ecn,
    )
    from tpudes_torch.scenarios import (
        as_program,
        lena_grid_program,
        lena_ue_drop,
    )

    key = np.array([0, SEED])
    enb_pos, ue_pos = lena_ue_drop(
        E, UES_PER_CELL, generator=torch.Generator().manual_seed(SEED))
    lte = lena_grid_program(enb_pos, ue_pos, BENCH_TTIS)
    bss = bss_programs()["legacy"]
    tcp = tcp_programs(TCP_SIM_S)["bench_tcp"]
    tcp_studies = []
    for v in VARIANTS[:SRV_TCP_STUDIES]:
        ids = np.full(tcp.n_flows, VARIANTS.index(v), np.int32)
        tcp_studies.append((dataclasses.replace(
            tcp, variant_idx=ids, ecn=variant_ecn(ids)), {}))
    aspr = as_program(AS_NODES, AS_FLOWS, AS_SIM_S, seed=AS_SEED)
    return dict(
        lte_sm=(R, [(dataclasses.replace(lte, scheduler=s), {})
                    for s in SRV_LTE_SCHEDULERS],
                lambda p, x: run_lte_sm(p, key, replicas=R, device=dev)),
        bss=(BSS_R, [(dataclasses.replace(bss, sim_end_us=int(s * 1e6)), {})
                     for s in SRV_BSS_ENDS_S],
             lambda p, x: run_replicated_bss(p, BSS_R, key, device=dev)),
        dumbbell=(TCP_R, tcp_studies,
                  lambda p, x: run_tcp_dumbbell(p, key, TCP_R, device=dev)),
        as_flows=(AS_R, [(aspr, dict(rate_scale=s)) for s in AS_SCALES],
                  lambda p, x: run_as_flows(p, key, AS_R, device=dev,
                                            rate_scale=[x["rate_scale"]])[0]),
    ), key


#: each engine's batch: the kernel counters one coalesced launch makes
SRV_LAUNCHES = {
    "lte_sm": {"lte_sm_advance": 1, "lte_sm_advance:sweep": 1},
    "bss": {"bss_advance": 1, "bss_advance:sweep": 1},
    "dumbbell": {"tcp_advance": 1, "tcp_advance:sweep": 1},
    "as_flows": {"as_spf": 1, "as_fluid": 1, "as_fluid:sweep": 1},
}
#: each engine's kernel counted once a chunk, as RUNTIME counts the engine
SRV_CHUNK_KERNEL = {"lte_sm": "lte_sm_advance", "bss": "bss_advance",
                    "dumbbell": "tcp_advance", "as_flows": "as_fluid"}


def check_batch_launches(engine: str, launches: dict, runtime_n: int):
    """One batch's kernel counts must be :data:`SRV_LAUNCHES`' and its
    chunk kernel's count ``RUNTIME``'s count of the engine's launches."""
    want = {k: SRV_LAUNCHES[engine].get(k, 0) for k in launches}
    if launches != want or runtime_n != launches[SRV_CHUNK_KERNEL[engine]]:
        fail(f"5srv {engine}: the batch launched {launches} (RUNTIME "
             f"{runtime_n}), want {want}")


def serving_batches(kc, dev, programs, key, started: bool) -> dict:
    """One coalesced batch an engine through a StudyServer (``pump``
    mode, or the scheduler thread with ``started``): each batch counted
    (one launch of its kernel's sweep arm, equal to ``RUNTIME``'s count
    of the engine's launches), each study's result against ``solos``."""
    import torch
    from tpudes_torch.parallel.runtime import RUNTIME
    from tpudes_torch.serving import StudyServer

    out = {}
    for engine, (reps, studies, _) in programs.items():
        server = StudyServer(start=started, max_wait_s=0.05,
                             max_batch=len(studies))
        before = RUNTIME.launches(engine)
        kc.reset_launches()
        t0 = time.monotonic()
        handles = [server.submit_study(engine, p, key, reps, device=dev,
                                       tenant=f"t{i}", **x)
                   for i, (p, x) in enumerate(studies)]
        if not started:
            server.pump()
        results = [h.result(timeout=300) for h in handles]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        server.close()
        launches = dict(kc.launches)
        runtime_n = RUNTIME.launches(engine) - before
        check_batch_launches(engine, launches, runtime_n)
        if any(h.batch_size != len(studies) for h in handles):
            fail(f"5srv {engine}: the studies were not one batch")
        out[engine] = dict(results=results, wall_s=wall,
                           launches={k: v for k, v in launches.items() if v},
                           runtime_launches=runtime_n)
    return out


def serving_closed_loop(dev) -> dict:
    """``bench.py:988`` bench_serving_closed_loop's row on the port at its
    own size: 16 clients x 6 studies of the toy dumbbell (3 flows, 50
    slots, one replica; study ``i`` all flows on variant ``i mod 17``),
    served through a StudyServer (``max_wait_s`` 4 ms, batches of up to
    8) against the same stream through serialized ``RUNTIME.submit``;
    then the chaos phase (launch errors at the 2nd, 5th and 9th dispatch,
    a quarter of the clients gold).  Every served result must equal its
    serialized run."""
    import threading

    import tpudes_torch.chaos as chaos
    from tpudes_torch.obs.serving import ServingTelemetry
    from tpudes_torch.parallel.programs import toy_dumbbell_program
    from tpudes_torch.parallel.runtime import RUNTIME
    from tpudes_torch.parallel.tcp_dumbbell import (
        VARIANTS,
        run_tcp_dumbbell,
        variant_ecn,
    )
    from tpudes_torch.serving import StudyServer

    n_clients, per_client = SERVING_CLIENTS, SERVING_STUDIES_PER_CLIENT
    prog = toy_dumbbell_program(n_flows=3, n_slots=SERVING_SLOTS)
    key = np.array([0, 0])

    def study_prog(i):
        ids = np.full(prog.n_flows, i % len(VARIANTS), np.int32)
        return dataclasses.replace(prog, variant_idx=ids,
                                   ecn=variant_ecn(ids))

    total = n_clients * per_client
    stream = [study_prog(i) for i in range(total)]
    RUNTIME.clear("dumbbell")
    run_tcp_dumbbell(stream[0], key, SERVING_REPLICAS, device=dev)  # warm
    t0 = time.monotonic()
    futs = [RUNTIME.submit(run_tcp_dumbbell, p, key, SERVING_REPLICAS,
                           device=dev) for p in stream]
    serial = [f.result() for f in futs]
    wall_serial = time.monotonic() - t0

    def closed_loop(slo_of=None):
        ServingTelemetry.reset()
        server = StudyServer(
            max_wait_s=SERVING_MAX_WAIT_S, max_batch=SERVING_MAX_BATCH,
            retry_backoff_s=0.002,
            warm=[dict(engine="dumbbell", prog=stream[0], key=key,
                       replicas=SERVING_REPLICAS, device=dev)])
        got = [None] * total

        def client(c):
            for j in range(per_client):
                i = c * per_client + j
                h = server.submit_study(
                    "dumbbell", stream[i], key, SERVING_REPLICAS,
                    tenant=f"tenant{c}", device=dev,
                    slo=slo_of(c) if slo_of else "standard")
                got[i] = h.result(timeout=300)

        t0 = time.monotonic()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t0
        metrics = server.metrics()
        server.close()
        if any(t.is_alive() for t in threads) or not all(
                same_result(g, s) for g, s in zip(got, serial)):
            fail("bench_serving_closed_loop: a served study differs from "
                 "its serialized run, or a client did not finish")
        return wall, metrics

    wall_served, metrics = closed_loop()
    chaos.arm(chaos.ChaosSchedule([
        chaos.ChaosEvent("launch_error", "local_launch", nth=n)
        for n in SERVING_CHAOS_NTH]))
    try:
        wall_degraded, m_deg = closed_loop(
            slo_of=lambda c: "gold" if c < max(1, n_clients // 4)
            else "standard")
    finally:
        chaos.disarm()
    f, slo = m_deg["failures"], m_deg["slo"]
    eng = metrics["engines"]["dumbbell"]
    return dict(
        phase="bench_serving_closed_loop", requests=total,
        clients=n_clients, smoke=False,
        rps_serialized=total / wall_serial,
        rps_coalesced=total / wall_served,
        coalesced_speedup=wall_serial / wall_served,
        launches=eng["launches"],
        coalesced_launches=eng["coalesced_launches"],
        coalesce_rate=metrics["coalesce_rate"],
        batch_occupancy=eng["batch_occupancy"],
        latency_p50_ms=eng["study_latency_s"]["p50"] * 1e3,
        latency_p99_ms=eng["study_latency_s"]["p99"] * 1e3,
        launch_p99_ms=eng["launch_wall_s"]["p99"] * 1e3,
        injected_failures=f["injected_failures"],
        requeued_studies=f["requeued_studies"],
        retry_budget_exhausted=f["retry_budget_exhausted"],
        rps_degraded=total / wall_degraded,
        degraded_speedup=wall_serial / wall_degraded,
        slo_attainment={n: s["attainment"] for n, s in slo.items()},
        gold_p99_ms=slo.get("gold", {}).get("latency_s", {}).get(
            "p99", 0.0) * 1e3,
        equals_serialized=True,
    )


def serving_phase(kc, dev) -> dict:
    """Phase 5srv: the StudyServer at full width.  Each engine's studies
    (:data:`SRV_LTE_SCHEDULERS` on bench_lte's program at R x 10,000
    TTIs, :data:`SRV_BSS_ENDS_S` on bench_wifi's at 512 replicas, eight
    variant assignments on bench_tcp's at 256 x 20 s, :data:`AS_SCALES`
    on bench_as's at 1,024) are one batch, one counted launch of the
    kernel's sweep arm (``RUNTIME`` counting the same), first in ``pump``
    mode and then through the scheduler thread (``start()``); every
    study's result bit-equal to its solo run.  Then
    :func:`serving_closed_loop`.  Returns the pump batches' launches."""
    import torch
    from tpudes_torch.obs.serving import ServingTelemetry

    programs, key = serving_programs(dev)
    solos = {e: [solo(p, x) for p, x in studies]
             for e, (_, studies, solo) in programs.items()}
    torch.cuda.synchronize()
    ServingTelemetry.reset()
    rows = {}
    for started in (False, True):
        served = serving_batches(kc, dev, programs, key, started)
        for engine, got in served.items():
            if not all(same_result(g, s)
                       for g, s in zip(got["results"], solos[engine])):
                fail(f"5srv {engine}: a served study differs from its solo "
                     f"run ({'start()' if started else 'pump'})")
            rows.setdefault(engine, {})["started" if started else "pump"] = \
                {k: v for k, v in got.items() if k != "results"}
    print(json.dumps(dict(phase="serving_batches", studies={
        e: len(s) for e, (_, s, _) in programs.items()}, rows=rows,
        equals_solo=True)), flush=True)
    print(json.dumps(serving_closed_loop(dev)), flush=True)
    return {e: r["pump"]["launches"] for e, r in rows.items()}


def runtime_entries(dev) -> dict:
    """The six entries at their bench width: ``{name: (engine, run(**kw))}``
    (the hybrid takes no ``block=``)."""
    import torch
    from tpudes_torch.parallel.as_flows import run_as_flows
    from tpudes_torch.parallel.hybrid import run_hybrid
    from tpudes_torch.parallel.lte_sm import run_lte_sm
    from tpudes_torch.parallel.replicated import run_replicated_bss
    from tpudes_torch.parallel.tcp_dumbbell import run_tcp_dumbbell
    from tpudes_torch.parallel.wired import run_wired, wired_chain
    from tpudes_torch.scenarios import (
        as_program,
        lena_grid_program,
        lena_ue_drop,
    )

    key = np.array([0, SEED])
    enb_pos, ue_pos = lena_ue_drop(
        E, UES_PER_CELL, generator=torch.Generator().manual_seed(SEED))
    lte = lena_grid_program(enb_pos, ue_pos, BENCH_TTIS)
    bss = bss_programs()["legacy"]
    tcp = tcp_programs(TCP_SIM_S)["bench_tcp"]
    aspr = as_program(AS_NODES, AS_FLOWS, AS_SIM_S, seed=AS_SEED)
    whole, split = wired_chain(**WIRED_BENCH), wired_chain(**WIRED_SPLIT)
    return {
        "run_lte_sm": ("lte_sm", lambda **kw: run_lte_sm(
            lte, key, replicas=R, device=dev, **kw)),
        "run_replicated_bss": ("bss", lambda **kw: run_replicated_bss(
            bss, BSS_R, key, device=dev, **kw)),
        "run_tcp_dumbbell": ("dumbbell", lambda **kw: run_tcp_dumbbell(
            tcp, key, TCP_R, device=dev, **kw)),
        "run_as_flows": ("as_flows", lambda **kw: run_as_flows(
            aspr, key, AS_R, device=dev, **kw)),
        "run_wired": ("wired", lambda **kw: run_wired(
            whole, key, WIRED_R, device=dev, **kw)),
        "run_hybrid": ("wired_hybrid", lambda **kw: run_hybrid(
            split, key, WIRED_R, transport="local", device=dev, **kw)),
    }


def synchronises(fn) -> list:
    """The synchronising CUDA calls ``fn()`` makes, as PyTorch's sync
    debug mode reports them (its first line each)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message).splitlines()[0] for w in caught
                 if "called a synchronizing" in str(w.message)]


def runtime_phase(kc, dev) -> dict:
    """Phase 5rt: the runtime.  For each of the six entries at bench
    width: the wall of the first call after ``RUNTIME.clear()`` (a miss)
    and the median of :data:`RT_HITS` hits, each hit bit-equal to the
    miss; the synchronising calls of a hit launched ``block=False`` (the
    hybrid: of a whole run).  Then ``bench.py:924`` bench_pipeline_overlap's
    row (bench_lte's program at :data:`PIPELINE_FRACTIONS` of its 10 s,
    R replicas, blocking against ``RUNTIME.submit``), and a run submitted
    behind a ``torch.cuda._sleep`` kernel of :data:`RT_SLEEP_S`: not done
    when submitted, its result equal to the blocking run's."""
    import torch
    from tpudes_torch.parallel.lte_sm import run_lte_sm
    from tpudes_torch.parallel.runtime import RUNTIME, EngineFuture
    from tpudes_torch.random import PRNGKey, fold_in
    from tpudes_torch.scenarios import lena_grid_program, lena_ue_drop

    rows = {}
    for name, (engine, run) in runtime_entries(dev).items():
        RUNTIME.clear()
        misses = RUNTIME.misses
        t0 = time.monotonic()
        miss = run()
        torch.cuda.synchronize()
        miss_s = time.monotonic() - t0
        if RUNTIME.misses <= misses:
            fail(f"5rt {name}: the first call after clear() was no miss")
        hits0, walls = RUNTIME.hits, []
        for _ in range(RT_HITS):
            t0 = time.monotonic()
            hit = run()
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
            if not same_result(hit, miss):
                fail(f"5rt {name}: a hit differs from the miss")
        if RUNTIME.hits - hits0 < RT_HITS:
            fail(f"5rt {name}: the runs after the miss were not hits")
        if engine == "wired_hybrid":
            res, syncs = synchronises(run)
        else:
            fut, syncs = synchronises(lambda: run(block=False))
            if not isinstance(fut, EngineFuture):
                fail(f"5rt {name}: block=False returned no EngineFuture")
            res = fut.result()
        if not same_result(res, miss):
            fail(f"5rt {name}: the block=False run differs from the miss")
        rows[name] = dict(miss_wall_s=miss_s,
                          hit_wall_median_s=statistics.median(walls),
                          hit_walls_s=walls, hits_equal_miss=True,
                          synchronises=len(syncs),
                          synchronise_calls=sorted(set(syncs)))
    print(json.dumps(dict(phase="runtime_cache", rows=rows)), flush=True)

    enb_pos, ue_pos = lena_ue_drop(
        E, UES_PER_CELL, generator=torch.Generator().manual_seed(SEED))
    bench = lena_grid_program(enb_pos, ue_pos, BENCH_TTIS)
    progs = [dataclasses.replace(bench, n_ttis=int(BENCH_TTIS * f))
             for f in PIPELINE_FRACTIONS]
    RUNTIME.clear()
    run_lte_sm(progs[0], PRNGKey(0), replicas=R, device=dev)  # warm
    block_walls, submit_walls = [], []
    for i in range(PIPELINE_RUNS):
        key = PRNGKey(1 + i)
        t0 = time.monotonic()
        blocked = [run_lte_sm(p, fold_in(key, j), replicas=R, device=dev)
                   for j, p in enumerate(progs)]
        block_walls.append(time.monotonic() - t0)
        t0 = time.monotonic()
        futs = [RUNTIME.submit(run_lte_sm, p, fold_in(key, j), replicas=R,
                               device=dev) for j, p in enumerate(progs)]
        submitted = [f.result() for f in futs]
        submit_walls.append(time.monotonic() - t0)
        if not all(same_result(a, b) for a, b in zip(blocked, submitted)):
            fail("pipeline overlap: a submitted run differs from blocking")
    stats = RUNTIME.stats()
    blk, sub = statistics.median(block_walls), statistics.median(submit_walls)
    print(json.dumps(dict(
        phase="bench_pipeline_overlap", points=len(progs), replicas=R,
        horizons_ttis=[p.n_ttis for p in progs],
        wall_blocking_s=blk, wall_submitted_s=sub,
        overlap_speedup=blk / sub, max_in_flight=stats["max_in_flight"],
        submitted=stats["submitted"], block_walls_s=block_walls,
        submit_walls_s=submit_walls, equals_blocking=True)), flush=True)

    key = PRNGKey(SEED)
    want = run_lte_sm(bench, key, replicas=R, device=dev)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(RT_SLEEP_S * SLEEP_CYCLES_PER_S))
    t0 = time.perf_counter()
    fut = run_lte_sm(bench, key, replicas=R, device=dev, block=False)
    submit_s = time.perf_counter() - t0
    behind = fut.done()
    t1 = time.perf_counter()
    got = fut.result()
    wait_s = time.perf_counter() - t1
    if behind or not same_result(got, want):
        fail(f"5rt: a run submitted behind a sleep kernel was done at once "
             f"({behind}) or differs from the blocking run")
    print(json.dumps(dict(
        phase="submitted_behind_sleep", sleep_s=RT_SLEEP_S,
        submit_wall_s=submit_s, done_when_submitted=behind,
        result_wait_s=wait_s, equals_blocking=True)), flush=True)
    return rows


def checkpoint_phase(kc, dev) -> dict:
    """Phase 5ckpt: bench_tcp (256 x 20 s) in :data:`CKPT_CHUNKS` chunks
    with a checkpoint, aborted by a chaos schedule after chunk
    :data:`CKPT_KILL_AFTER`'s save, then resumed: the resume launches only
    the chunks left (counted), and its result is bit-equal to the
    uninterrupted one-launch run's.  The checkpoint lives in a temporary
    directory, removed after."""
    import shutil
    import tempfile

    import torch
    import tpudes_torch.chaos as chaos
    from tpudes_torch.parallel.tcp_dumbbell import run_tcp_dumbbell

    prog = tcp_programs(TCP_SIM_S)["bench_tcp"]
    key = np.array([0, SEED])
    chunk = -(-prog.n_slots // CKPT_CHUNKS)
    want = run_tcp_dumbbell(prog, key, TCP_R, device=dev)
    tmp = tempfile.mkdtemp(prefix="tpudes_ckpt_")
    path = os.path.join(tmp, "bench_tcp.ckpt")
    try:
        chaos.arm(chaos.ChaosSchedule([chaos.ChaosEvent(
            "checkpoint_kill", "checkpoint_save", nth=CKPT_KILL_AFTER,
            param="dumbbell")]))
        t0 = time.monotonic()
        try:
            run_tcp_dumbbell(prog, key, TCP_R, device=dev, chunk_slots=chunk,
                             checkpoint=path)
            fail("5ckpt: the chaos kill did not fire")
        except chaos.ChaosInjected:
            pass
        finally:
            chaos.disarm()
        killed_s = time.monotonic() - t0
        size = os.path.getsize(path)
        resumed, wall, launches = counted(
            kc, lambda: run_tcp_dumbbell(prog, key, TCP_R, device=dev,
                                         chunk_slots=chunk, checkpoint=path),
            {"tcp_advance": CKPT_CHUNKS - CKPT_KILL_AFTER},
            "5ckpt resumed run")
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not same_result(resumed, want):
        fail("5ckpt: the resumed run differs from the uninterrupted run")
    row = dict(phase="checkpoint_resume", replicas=TCP_R,
               n_slots=prog.n_slots, chunks=CKPT_CHUNKS,
               killed_after_chunk=CKPT_KILL_AFTER,
               killed_run_wall_s=killed_s, resumed_wall_s=wall,
               checkpoint_bytes=size,
               kernel_launches={k: v for k, v in launches.items() if v},
               equals_uninterrupted=True)
    print(json.dumps(row), flush=True)
    return row


#: the first design's C signatures of ``csrc/as_flows.cu``, through which the
#: compare mode launches an earlier ``DIR/as_flows.cu``:
#: ``as_spf_launch(row_ptr, col_v, col_w, col_e, dsts, scratch, dist,
#: nh_edge, nh_node, N, D, rounds, smem, inf, slack, stream)`` (smem 8 N +
#: 16 bytes, or 0 with scratch ``(D, 2, N)``) and ``as_fluid_launch(
#: hop_link, ptr, slot, c, k, dly, fm, scale, z, reached, lfrac_in,
#: lfrac_out, goodput, delay, frac, max_util, F, H, L, C, R, rounds, smem,
#: fold, jitter, -hj2, UTIL_MIN, RHO_MAX, stream)`` (smem 4 (2 L + 2 F + H F
#: + 4) bytes); each probe (``as_spf_profile``, ``as_fluid_profile``) takes
#: its ``prof`` words before the stream
OLD_AS_SPF_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
OLD_AS_FLUID_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 8
                         + [ctypes.c_float] * 4 + [ctypes.c_void_p])


def old_as_entry(lib, symbol: str, argtypes: list, *args) -> None:
    """Call an earlier ``as_flows`` library's entry; fail on an error."""
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        fail(f"the old {symbol} failed: CUDA error {err}")


def old_as_spf(lib, g: dict, n: int, rounds: int, prof=None) -> tuple:
    """The first design's ``as_spf`` from ``lib`` on ``g`` (its rows in
    shared memory where ``2 n`` floats fit): ``(dist, nh_edge,
    nh_node)``; with ``prof`` (int64 words) its probe."""
    import torch
    from tpudes_torch.parallel.as_flows import INF, NEXT_HOP_SLACK

    dev = g["w"].device
    D = g["dsts"].shape[0]
    smem = 8 * n + 16 if 8 * n + 16 <= 227 * 1024 else 0
    scratch = None if smem else torch.empty((D, 2, n), device=dev)
    outs = (torch.empty((D, n), device=dev),
            torch.empty((D, n), dtype=torch.int32, device=dev),
            torch.empty((D, n), dtype=torch.int32, device=dev))
    args = [g["row_ptr"].data_ptr(), g["col_v"].data_ptr(),
            g["col_w"].data_ptr(), g["col_e"].data_ptr(),
            g["dsts"].data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            *(x.data_ptr() for x in outs), n, D, int(rounds), smem,
            ctypes.c_float(INF), ctypes.c_float(NEXT_HOP_SLACK)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if prof is None:
        old_as_entry(lib, "as_spf_launch", OLD_AS_SPF_ARGTYPES, *args, stream)
    else:
        old_as_entry(lib, "as_spf_profile", OLD_AS_SPF_ARGTYPES[:-1]
                     + [ctypes.c_void_p] * 2, *args, prof.data_ptr(), stream)
    return outs


def old_as_fluid(lib, t: dict, fm, scale, z, reached, jitter: float,
                 hj2: float, rounds: int, prof=None) -> dict:
    """The first design's ``as_fluid`` from ``lib`` over the ``(C, R)``
    grid of the draws ``z`` ``(R, F)``: the outputs; with ``prof`` its
    probe."""
    import torch
    from tpudes_torch.parallel.as_flows import RHO_MAX, UTIL_MIN

    dev = z.device
    F, H = t["hop_link"].shape
    L = t["c"].shape[0]
    C, R = scale.shape[0], z.shape[0]
    out = {k: torch.empty((C, R, F), device=dev)
           for k in ("goodput_bps", "delay_s", "delivered_frac")}
    out["max_util"] = torch.empty((C, R), device=dev)
    f = ctypes.c_float
    args = [t["hop_link"].data_ptr(), t["ptr"].data_ptr(),
            t["slot"].data_ptr(), t["c"].data_ptr(), t["k"].data_ptr(),
            t["dly"].data_ptr(), fm.data_ptr(), scale.data_ptr(),
            z.data_ptr(), reached.data_ptr(), None, None,
            out["goodput_bps"].data_ptr(), out["delay_s"].data_ptr(),
            out["delivered_frac"].data_ptr(), out["max_util"].data_ptr(),
            F, H, L, C, R, int(rounds), 4 * (2 * L + 2 * F + H * F + 4),
            int(t["fold"]), f(jitter), f(-hj2), f(UTIL_MIN), f(RHO_MAX)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if prof is None:
        old_as_entry(lib, "as_fluid_launch", OLD_AS_FLUID_ARGTYPES, *args,
                     stream)
    else:
        old_as_entry(lib, "as_fluid_profile", OLD_AS_FLUID_ARGTYPES[:-1]
                     + [ctypes.c_void_p] * 2, *args, prof.data_ptr(), stream)
    return out


def as_inputs(dev, metric: str = "hops") -> dict:
    """bench_as's program and every input of both kernels on the card,
    from the plain versions: the graph ``g``, the routing outputs
    ``spf`` (``dist``, ``nh_edge``, ``nh_node``, ``path``, ``hops``,
    ``reached``), the fluid tables ``t``, ``fm``, the check key ``key``,
    its draws ``z`` (:data:`AS_R` replicas) and the rate constants."""
    import torch
    from tpudes_torch.parallel import as_flows as asf
    from tpudes_torch.random import PRNGKey, as_replica_draws
    from tpudes_torch.scenarios import as_program

    prog = dataclasses.replace(
        as_program(AS_NODES, AS_FLOWS, AS_SIM_S, seed=AS_SEED),
        spf_metric=metric)
    g = asf.spf_graph(prog, dev)
    spf = dict(zip(AS_SPF_OUTPUTS, as_spf_plain(g, prog.n, prog.spf_rounds)))
    key = PRNGKey(AS_CHECK_KEY, device=dev)
    return dict(prog=prog, g=g, spf=spf, t=asf.fluid_tables(prog,
                                                            spf["path"]),
        fm=torch.as_tensor(np.float32(prog.flow_bps), device=dev), key=key,
        z=as_replica_draws(key, AS_R, len(prog.src)),
        consts=asf.rate_constants(prog))


def as_stage_split(dev, label: str, old_lib=None) -> dict:
    """The stage probe of ``as_spf`` and ``as_fluid`` (their ``PROF``
    instantiations: clock64() at each warp's stage edges) at bench_as's
    width: the routing stage (hop metric) and the fluid stage at one rate
    scale and at the :data:`AS_SCALES` grid, each probe's outputs equal
    to the plain versions'; the cycles a CTA in each stage
    (``as_cuda.spf_stages`` / ``fluid_stages``), the probe launch's device
    time (CUDA events) and nvidia-smi's SM clock just after.  ``old_lib``:
    the first design's kernels, through their own C signatures."""
    import torch
    from tpudes_torch.parallel import as_cuda
    from tpudes_torch.parallel import as_flows as asf

    x = as_inputs(dev)
    g, prog, t = x["g"], x["prog"], x["t"]
    D = g["dsts"].shape[0]
    split = {}

    def timed(fn):
        fn()                                                   # warm-up
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = fn()
        b.record()
        torch.cuda.synchronize()
        return res, a.elapsed_time(b)

    def spf_probe():
        prof = torch.zeros(as_cuda.SPF_PROF_WORDS, dtype=torch.int64,
                           device=dev)
        if old_lib is not None:
            outs = old_as_spf(old_lib, g, prog.n, prog.spf_rounds, prof)
        else:
            outs = as_cuda.spf_profile(g, prog.n, prog.spf_rounds, prof)
        return outs, prof

    (outs, prof), ms = timed(spf_probe)
    for k, got in zip(AS_SPF_OUTPUTS, outs):
        if not same_bits(got, x["spf"][k]):
            fail(f"{label} as_spf probe: {k} differs from the plain version")
    per = as_cuda.spf_stages(prof.tolist(), D)
    split["spf"] = dict(per, probe_ms=ms, nvidia_smi_clocks_sm_max=
                        sm_clock_line())
    print(f"{label} as_spf stage probe (N={prog.n} D={D}): cycles a CTA "
          f"{json.dumps(per)}; probe launch {ms:.4f} ms; nvidia-smi "
          f"clocks.sm, clocks.max.sm {split['spf']['nvidia_smi_clocks_sm_max']}",
          flush=True)
    for name, scales in (("bench", [1.0]), ("sweep", list(AS_SCALES))):
        scale = torch.tensor(scales, device=dev)
        C = len(scales)
        want, _ = asf.fluid_math(t, x["fm"], scale, x["z"],
                                 x["spf"]["reached"], *x["consts"],
                                 asf.FP_ROUNDS)

        def fluid_probe():
            prof = torch.zeros(as_cuda.FLUID_PROF_WORDS, dtype=torch.int64,
                               device=dev)
            if old_lib is not None:
                out = old_as_fluid(old_lib, t, x["fm"], scale, x["z"],
                                   x["spf"]["reached"], *x["consts"],
                                   asf.FP_ROUNDS, prof)
            else:
                out = as_cuda.fluid_profile(
                    t, x["fm"], scale, x["key"], AS_R, x["spf"]["reached"],
                    *x["consts"], asf.FP_ROUNDS, prof)
            return out, prof

        (out, prof), ms = timed(fluid_probe)
        bad = [k for k in want if not same_bits(want[k], out[k])]
        if bad:
            fail(f"{label} as_fluid probe ({name}): {bad} differ from the "
                 f"plain version")
        per = as_cuda.fluid_stages(prof.tolist(), C * AS_R, asf.FP_ROUNDS)
        clock = sm_clock_line()
        split[f"fluid_{name}"] = dict(per, probe_ms=ms,
                                      nvidia_smi_clocks_sm_max=clock)
        print(f"{label} as_fluid stage probe ({name}, C={C} R={AS_R} "
              f"F={AS_FLOWS} L={t['c'].shape[0]}): cycles a CTA "
              f"{json.dumps(per)}; probe launch {ms:.4f} ms; nvidia-smi "
              f"clocks.sm, clocks.max.sm {clock}", flush=True)
    return split

def old_as_run(lib, prog, seed: int, dev) -> dict:
    """The first design's ``run_as_flows`` on its kernels from ``lib``,
    step for step: the graph's tables, one ``as_spf`` launch, the walk and the
    draws as small torch ops (``walk_paths``, ``as_replica_draws``), the
    fluid tables, one ``as_fluid`` launch and the copy back."""
    import torch
    from tpudes_torch.parallel import as_flows as asf
    from tpudes_torch.random import PRNGKey, as_replica_draws

    g = asf.spf_graph(prog, dev)
    dist, nh_edge, nh_node = old_as_spf(lib, g, prog.n, prog.spf_rounds)
    path, hops, arrived = asf.walk_paths(prog, g["ddst"], nh_edge, nh_node)
    src = torch.as_tensor(np.asarray(prog.src), device=dev).long()
    reached = (dist[g["ddst"], src] < asf.INF) & arrived
    t = asf.fluid_tables(prog, path)
    fm = torch.as_tensor(np.float32(prog.flow_bps), device=dev)
    z = as_replica_draws(PRNGKey(seed, device=dev), AS_R, len(prog.src))
    out = old_as_fluid(lib, t, fm, torch.tensor([1.0], device=dev), z,
                       reached, *asf.rate_constants(prog), asf.FP_ROUNDS)
    host = {k: v[0].cpu().numpy() for k, v in out.items()}
    return dict(host, hops=hops.cpu().numpy(),
                unreachable=(~reached).cpu().numpy())


def as_compare(old_lib, dev, card: str, old_dir: str) -> dict:
    """The AS half of the compare mode: the first design's ``as_flows.cu``
    (``DIR/as_flows.cu``, launched through its own C signatures,
    :func:`old_as_spf` and :func:`old_as_fluid`) against this checkout's
    at bench_as's width: the routing tables equal, the new walk equal to
    the plain one; the fluid outputs equal at one scale and at the
    :data:`AS_SCALES` grid, the old kernel fed the draws the new one
    writes out (equal to ``as_replica_draws``); the first design's main
    path (:func:`old_as_run`) equal to ``run_as_flows``; then in turns (old,
    new, new, old) each kernel's device time (CUDA events, :func:`timed_ms`
    of its launch, median of three) and the main path's wall (median of
    three runs on keys 1..3 after one on key 0); each path's device
    operations a run (the profiler); then both stage probes (the old one's
    where its library has ``as_spf_profile``).  Returns the
    ``as_old_vs_new`` line."""
    import torch
    from tpudes_torch.parallel import as_flows as asf
    from tpudes_torch.parallel.as_cuda import fluid_cuda, spf_cuda
    from tpudes_torch.random import PRNGKey

    x = as_inputs(dev)
    g, prog, t, plain = x["g"], x["prog"], x["t"], x["spf"]
    new = spf_cuda(g, prog.n, prog.spf_rounds)
    was = old_as_spf(old_lib, g, prog.n, prog.spf_rounds)
    torch.cuda.synchronize()
    for k, a, b, p in zip(AS_SPF_OUTPUTS, new, was, plain.values()):
        if not same_bits(a, b) or not same_bits(a, p):
            fail(f"compare (as_spf): {k} differs between old and new")
    for k, a in list(zip(AS_SPF_OUTPUTS, new))[3:]:
        if not same_bits(a, plain[k]):
            fail(f"compare (as_spf): the walk's {k} differs from walk_math")
    scales = {"bench": [1.0], "sweep": list(AS_SCALES)}
    for name, sc in scales.items():
        scale = torch.tensor(sc, device=dev)
        got, _ = fluid_cuda(t, x["fm"], scale, x["key"], AS_R,
                            plain["reached"], *x["consts"], asf.FP_ROUNDS,
                            z_out=True)
        prev = old_as_fluid(old_lib, t, x["fm"], scale, got["z"],
                            plain["reached"], *x["consts"], asf.FP_ROUNDS)
        torch.cuda.synchronize()
        if not same_bits(got["z"], x["z"]):
            fail(f"compare (as_fluid {name}): the draws differ from "
                 f"as_replica_draws")
        bad = [k for k in prev if not same_bits(prev[k], got[k])]
        if bad:
            fail(f"compare (as_fluid {name}): {bad} differ between old and "
                 f"new")

    def entry(seed):
        return asf.run_as_flows(prog, PRNGKey(seed), AS_R, device=dev)

    if not same_run(entry(1), old_as_run(old_lib, prog, 1, dev)):
        fail("compare (bench_as): the first design's main path and "
             "run_as_flows differ")
    scale1 = torch.tensor([1.0], device=dev)
    launches = {
        "old": (lambda: old_as_spf(old_lib, g, prog.n, prog.spf_rounds),
                lambda: old_as_fluid(old_lib, t, x["fm"], scale1, x["z"],
                                     plain["reached"], *x["consts"],
                                     asf.FP_ROUNDS),
                lambda seed: old_as_run(old_lib, prog, seed, dev)),
        "new": (lambda: spf_cuda(g, prog.n, prog.spf_rounds),
                lambda: fluid_cuda(t, x["fm"], scale1, x["key"], AS_R,
                                   plain["reached"], *x["consts"],
                                   asf.FP_ROUNDS),
                entry)}
    times = {k: {"as_spf": [], "as_fluid": [], "wall": []}
             for k in launches}
    for turn in ("old", "new", "new", "old"):
        spf, fluid, run = launches[turn]
        times[turn]["as_spf"].append(timed_ms(spf, AS_SPF_CALLS, reps=3)[0])
        times[turn]["as_fluid"].append(
            timed_ms(fluid, AS_FLUID_CALLS, reps=3)[0])
        run(0)
        w = []
        for i in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run(1 + i)
            torch.cuda.synchronize()
            w.append(time.perf_counter() - t1)
        times[turn]["wall"].append(statistics.median(w))
    ops = {k: device_ops(lambda r=v[2]: r(4)) for k, v in launches.items()}
    result = dict(phase="as_old_vs_new", card=card, old=old_dir,
                  n_nodes=AS_NODES, n_flows=AS_FLOWS, replicas=AS_R,
                  times=times, device_ops_per_run=ops)
    for k in ("as_spf", "as_fluid", "wall"):
        result[f"{k}_new_over_old"] = (statistics.mean(times["new"][k])
                                       / statistics.mean(times["old"][k]))
    print(f"compare (AS, N={AS_NODES} F={AS_FLOWS} R={AS_R}): outputs "
          f"equal; as_spf old {times['old']['as_spf']} ms, new "
          f"{times['new']['as_spf']} ms; as_fluid old "
          f"{times['old']['as_fluid']} ms, new {times['new']['as_fluid']} "
          f"ms; main path walls old {times['old']['wall']}, new "
          f"{times['new']['wall']} s; device operations a run old "
          f"{ops['old']}, new {ops['new']}", flush=True)
    result["split_new"] = as_stage_split(dev, "new")
    if hasattr(old_lib, "as_spf_profile"):
        result["split_old"] = as_stage_split(dev, "old", old_lib)
    else:
        result["split_old"] = "not measured: the old kernel has no probe"
    return result


#: compare mode launches an earlier ``DIR/wired_advance.cu`` (the first
#: design) through its own C interface: ``wired_advance_launch(paths,
#: nhops, pkt_flow, g2l, svc, svcdly, hop, ready, free, deliver, eg_hop,
#: eg_ready, served, list, next_out, steps_out, K, R, P, F, H, L, Lo, t,
#: t_grant, span, smem, stream)`` (list an ``(N, P, 4)`` int32 scratch,
#: smem 24 Lo + 4 L bytes, span its SPAN_SLOTS); its probe
#: ``wired_advance_profile`` takes ``prof`` before the stream
OLD_WIRED_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 11
                      + [ctypes.c_void_p])
OLD_WIRED_SPAN = 128
#: launches a turn of the wired compare, per shape
WIRED_COMPARE_CALLS = {"bench": 1, "split_w40": 5}


def old_wired(lib, tab: dict, carry: dict, t_grant: int, prof=None):
    """One launch of an earlier ``wired_advance`` library (the first
    design's C interface) on ``carry``, in place, as ``wired_cuda.wired_cuda``
    returns it: ``(carry, metrics)``; ``prof`` (an ``(N, 12)`` int64
    tensor) runs its probe instead."""
    import torch
    from tpudes_torch.parallel.wired import WIRED_STATE

    dev = carry["hop"].device
    K, F, H = tab["paths"].shape
    P = tab["pkt_flow"].shape[1]
    Lo, L = tab["svc"].shape[1], tab["L"]
    N = carry["hop"].numel() // P
    t0 = int(carry["t"])
    scratch = torch.empty((N, P, 4), dtype=torch.int32, device=dev)
    nxt = torch.empty((N,), dtype=torch.int32, device=dev)
    steps = torch.empty((N,), dtype=torch.int32, device=dev)
    args = [*(tab[k].data_ptr() for k in ("paths", "nhops", "pkt_flow",
                                          "g2l", "svc", "svcdly")),
            *(carry[k].data_ptr() for k, _ in WIRED_STATE),
            scratch.data_ptr(), nxt.data_ptr(), steps.data_ptr(),
            K, N // K, P, F, H, L, Lo, t0, int(t_grant), OLD_WIRED_SPAN,
            24 * Lo + 4 * L]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if prof is None:
        fn, types_ = lib.wired_advance_launch, OLD_WIRED_ARGTYPES
    else:
        fn = lib.wired_advance_profile
        types_ = OLD_WIRED_ARGTYPES[:-1] + [ctypes.c_void_p] * 2
        args.append(prof.data_ptr())
    fn.argtypes, fn.restype = types_, ctypes.c_int
    err = fn(*args, stream)
    if err != 0:
        fail(f"the old wired_advance failed: CUDA error {err}")
    carry["t"] = max(t0, int(t_grant))
    next_event = nxt.view(K, -1).amin(1)
    return carry, dict(next_event=next_event if carry["hop"].dim() == 3
                       else next_event[0], n_steps=steps.max())


def wired_shapes(dev) -> dict:
    """The two main-path launches the wired probe and compare take, each
    ``(tab, carry, t_grant)``: ``bench``, bench_wired's one launch
    (:data:`WIRED_BENCH` at :data:`WIRED_R` replicas, 20,000 slots, key
    ``[0, 11]``), and ``split_w40``, the four-way split's rank 3 (5,535
    resident packets) at its window :data:`WIRED_TIMED_WINDOW`, its carry
    taken from ``run_hybrid`` as phase 5hyb runs it (peer ingress
    written)."""
    from tpudes_torch.parallel import wired as wd
    from tpudes_torch.parallel import wired_cuda
    from tpudes_torch.parallel.hybrid import run_hybrid

    bench = wd.wired_chain(**WIRED_BENCH)
    init, _ = wd.build_wired_advance(bench, WIRED_R, device=dev)
    shapes = {"bench": (wd.wired_tables(bench, [(bench, None, None)], dev),
                        init(np.array([0, 11])), bench.n_slots)}
    real = wired_cuda.advance_launch
    index, order = {}, []

    class Taken(Exception):
        pass

    def launch(tab, carry, t_grant):
        if id(tab) not in index:
            order.append(id(tab))
        i = index[id(tab)] = index.get(id(tab), -1) + 1
        if order.index(id(tab)) == 3 and i == WIRED_TIMED_WINDOW:
            shapes["split_w40"] = (tab, wired_clone(carry), int(t_grant))
            raise Taken
        return real(tab, carry, t_grant)

    wired_cuda.advance_launch = launch
    try:
        run_hybrid(wd.wired_chain(**WIRED_SPLIT), np.array([0, HYBRID_KEY]),
                   WIRED_R, transport="local", device=dev)
    except Taken:
        pass
    finally:
        wired_cuda.advance_launch = real
    if "split_w40" not in shapes:
        fail("wired shapes: the split never reached rank 3's window "
             f"{WIRED_TIMED_WINDOW}")
    return shapes


def wired_stage_split(dev, label: str, shapes: dict, old_lib=None) -> dict:
    """The stage probe of ``wired_advance`` (its ``PROF`` instantiation:
    clock64() at each warp's stage edges, the refreshes, windows and list
    lengths counted) on each of :func:`wired_shapes`: the probe's state,
    ``next_event`` and ``n_steps`` equal to the same kernel's plain
    launch; the mean cycles a row in each stage and their shares
    (``wired_cuda.wired_stages``), the probe launch's device time (CUDA
    events) and nvidia-smi's SM clock just after.  ``old_lib``: the first
    design's kernel through its own C interface (:func:`old_wired`)."""
    import torch
    from tpudes_torch.parallel import wired as wd
    from tpudes_torch.parallel import wired_cuda

    split = {}
    for name, (tab, carry0, t_grant) in shapes.items():
        N = carry0["hop"].numel() // carry0["hop"].shape[-1]
        prof = torch.zeros((N, wired_cuda.PROF_WORDS), dtype=torch.int64,
                           device=dev)
        if old_lib is not None:
            want, wm = old_wired(old_lib, tab, wired_clone(carry0), t_grant)
            probe = lambda: old_wired(old_lib, tab, wired_clone(carry0),
                                      t_grant, prof)
        else:
            want, wm = wired_cuda.wired_cuda(tab, wired_clone(carry0),
                                             t_grant)
            probe = lambda: wired_cuda.wired_profile(
                tab, wired_clone(carry0), t_grant, prof)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        got, gm = probe()
        b.record()
        torch.cuda.synchronize()
        wired_same(want, wm, got, gm, [k for k, _ in wd.WIRED_STATE],
                   f"{label} probe, {name}")
        per = wired_cuda.wired_stages(prof.cpu())
        clock = sm_clock_line()
        split[name] = dict(per, probe_ms=a.elapsed_time(b),
                           nvidia_smi_clocks_sm_max=clock)
        print(f"{label} wired_advance stage probe ({name}: {N} rows x "
              f"{carry0['hop'].shape[-1]} packets, slots {carry0['t']}.."
              f"{t_grant}): {json.dumps(per)}; probe launch "
              f"{split[name]['probe_ms']:.4f} ms; nvidia-smi clocks.sm, "
              f"clocks.max.sm {clock}", flush=True)
    return split


def wired_compare(old_lib, dev, card: str, old_dir: str) -> dict:
    """The wired half of the compare mode: the first design's kernel
    (``DIR/wired_advance.cu``, through its own C interface,
    :func:`old_wired`) against this checkout's on both of
    :func:`wired_shapes`: every state array, ``t``, ``next_event`` and
    ``n_steps`` equal (and the split's to ``advance_math``); then in
    turns (old, new, new, old) each launch's device time (:func:`timed_ms`
    on copies of the carry, CUDA events behind a sleep kernel, median of
    three); then both stage probes.  Returns the ``wired_old_vs_new``
    line."""
    import torch
    from tpudes_torch.parallel import wired as wd
    from tpudes_torch.parallel import wired_cuda

    shapes = wired_shapes(dev)
    state = [k for k, _ in wd.WIRED_STATE]
    for name, (tab, carry0, t_grant) in shapes.items():
        new, nm = wired_cuda.wired_cuda(tab, wired_clone(carry0), t_grant)
        was, om = old_wired(old_lib, tab, wired_clone(carry0), t_grant)
        torch.cuda.synchronize()
        wired_same(was, om, new, nm, state, f"compare {name}, old vs new")
        if name == "split_w40":
            want, wm = wd.advance_math(tab, wired_clone(carry0), t_grant)
            wired_same(want, wm, new, nm, state, f"compare {name}")
    times = {k: {n: [] for n in shapes} for k in ("old", "new")}
    for turn in ("old", "new", "new", "old"):
        for name, (tab, carry0, t_grant) in shapes.items():
            calls = WIRED_COMPARE_CALLS[name]
            pool = [wired_clone(carry0) for _ in range(6 * calls + 1)]
            if turn == "old":
                fn = lambda: old_wired(old_lib, tab, pool.pop(), t_grant)
            else:
                fn = lambda: wired_cuda.wired_cuda(tab, pool.pop(), t_grant)
            times[turn][name].append(timed_ms(fn, calls, reps=3)[0])
            del pool
    # the new kernel alone (wired_cuda.enqueue, its error word read once
    # after the timed launches): the wrapper's time above also holds its
    # host work around the error word's read-back, a synchronise
    kernel_ms = {}
    for name, (tab, carry0, t_grant) in shapes.items():
        calls = WIRED_COMPARE_CALLS[name]
        pool = [wired_clone(carry0) for _ in range(6 * calls + 1)]
        errs = []

        def raw():
            errs.append(wired_cuda.enqueue(tab, pool.pop(), t_grant)[2])

        kernel_ms[name] = timed_ms(raw, calls, reps=3)[0]
        if any(e is not None and int(e.item()) != wired_cuda.NO_ERROR
               for e in errs):
            fail(f"compare {name}: a timed launch's list overflowed")
        del pool
    result = dict(phase="wired_old_vs_new", card=card, old=old_dir,
                  replicas=WIRED_R, times=times, kernel_ms=kernel_ms)
    for name in shapes:
        result[f"{name}_new_over_old"] = (
            statistics.mean(times["new"][name])
            / statistics.mean(times["old"][name]))
    print(f"compare (wired, {WIRED_R} rows): outputs equal; "
          + "; ".join(f"{n} old {times['old'][n]} ms, new "
                      f"{times['new'][n]} ms" for n in shapes)
          + f"; the new kernel alone {kernel_ms} ms", flush=True)
    result["split_new"] = wired_stage_split(dev, "new", shapes)
    result["split_old"] = wired_stage_split(dev, "old", shapes, old_lib)
    return result


@contextlib.contextmanager
def kernel_library(lib, name: str = "bss_advance"):
    """Run kernel ``name`` from ``lib`` (a loaded library with the same C
    interface) inside the block."""
    from tpudes_torch import _build

    saved = _build._LOADED.get(name)
    _build._LOADED[name] = lib
    try:
        yield
    finally:
        if saved is None:
            _build._LOADED.pop(name, None)
        else:
            _build._LOADED[name] = saved


class OldTcpEntry:
    """An entry of an earlier ``tcp_advance`` library (``fn``: its
    ``tcp_advance_launch`` or ``tcp_advance_profile``), called with the
    blocks and shared bytes of its own geometry in place of this
    checkout's: ``rpb`` rows a block, ``handoff`` words a row ahead of the
    rings.  ``at`` is the place of ``blocks`` among the arguments, from
    the end; ``shared`` follows it."""

    def __init__(self, fn, rpb: int, handoff: int, at: int):
        self.fn, self.rpb, self.handoff, self.at = fn, rpb, handoff, at

    @property
    def argtypes(self):
        return self.fn.argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.fn.argtypes = value

    @property
    def restype(self):
        return self.fn.restype

    @restype.setter
    def restype(self, value):
        self.fn.restype = value

    def __call__(self, *args):
        from tpudes_torch.parallel.bss_cuda import SHARED_OPTIN_MAX

        args = list(args)
        C, R, F, L = args[8:12]
        smem = 4 * self.rpb * L * (3 * F + 1)
        fits = smem + 4 * self.rpb * self.handoff <= SHARED_OPTIN_MAX
        args[-self.at] = -(-C * R // self.rpb)
        args[-self.at + 1] = smem if fits else 0
        return self.fn(*args)


def old_tcp_library(lib, old_dir: str):
    """An earlier ``tcp_advance`` library, its entries launched at the
    geometry its source (``DIR/tcp_advance.cu``) names:
    ``TCP_ROWS_PER_BLOCK`` and ``TCP_HANDOFF_WORDS`` (0 where it has
    none).  Returns ``(library, rows a block)``."""
    import types

    text = open(os.path.join(old_dir, "tcp_advance.cu")).read()
    rpb = re.search(r"constexpr int TCP_ROWS_PER_BLOCK = (\d+);", text)
    if rpb is None:
        fail(f"{old_dir}/tcp_advance.cu names no TCP_ROWS_PER_BLOCK")
    handoff = re.search(r"constexpr int TCP_HANDOFF_WORDS = (\d+);", text)
    rpb, handoff = int(rpb[1]), int(handoff[1]) if handoff else 0
    entries = dict(tcp_advance_launch=OldTcpEntry(
        lib.tcp_advance_launch, rpb, handoff, 3))
    if hasattr(lib, "tcp_advance_profile"):
        entries["tcp_advance_profile"] = OldTcpEntry(
            lib.tcp_advance_profile, rpb, handoff, 4)
    return types.SimpleNamespace(**entries), rpb


def build_old(name: str, old_dir: str):
    """Start nvcc on ``DIR/<name>.cu`` (an earlier design with the same C
    interface; its headers from ``DIR``, else this checkout's) into
    ``build/lib<name>_old.so``.  Returns ``(proc, path)``."""
    from tpudes_torch import _build

    path = _build.BUILD / f"lib{name}_old.so"
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", old_dir, "-I",
         str(_build.CSRC), "-o", str(path), os.path.join(old_dir,
                                                         f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, path


def bss_compare(old_lib, dev, card: str, old_dir: str) -> dict:
    """The BSS half of the compare mode: for each of :data:`BSS_COMPARE`
    at bench width the two launches' outputs equal (state, stops, next
    times, pending flags), their times in turns (old, new, new, old):
    the launch's device time (CUDA events) and the entry point's wall
    (median of three runs a turn); then both stage probes.  Returns the
    ``bss_old_vs_new`` line."""
    import torch
    from tpudes_torch.parallel import replicated as bss
    from tpudes_torch.parallel.bss_cuda import BSS_STATE, bss_launch
    from tpudes_torch.random import PRNGKey

    progs = {**bss_programs(), **bss_arm_programs()}
    result = dict(phase="bss_old_vs_new", card=card, old=old_dir,
                  replicas=BSS_R, programs={})
    for name in BSS_COMPARE:
        pts, ends = None, None
        if name == "sweep":
            prog, pts = progs["sweep"], progs["sweep_points"]
        elif name == "ht_sweep":
            prog = progs["ht"]
            ends = [int(round(v * 1e6)) for v in BSS_SWEEP_S]
        elif name == "large":
            from tpudes_torch.scenarios import bss_program

            prog = bss_program(BSS_LARGE_STAS, BSS_SIM_S)
        else:
            prog = progs[name]
        C = len(pts) if pts else len(ends) if ends else 1
        ends = ends or [prog.sim_end_us] * C
        consts, init, _ = bss.build_bss_advance(prog, BSS_R, dev, pts)
        key = PRNGKey(BSS_CHECK_SEED, device=dev)
        bound = max(bss._estimate_max_steps(dataclasses.replace(
            prog, traffic=tp, sim_end_us=e))
            for tp in (pts or [prog.traffic]) for e in ends)
        s0 = init(C)

        def launch():
            return bss_launch(consts, s0, key, [0] * C, bound, ends)

        new = launch()
        with kernel_library(old_lib):
            was = launch()
        torch.cuda.synchronize()
        for k, _, _ in BSS_STATE:
            if not torch.equal(new[0][k], was[0][k]):
                fail(f"compare ({name}): {k} differs between old and new")
        for a, b in zip(new[1:], was[1:]):
            if not torch.equal(a, b):
                fail(f"compare ({name}): stops or pending flags differ")
        steps = int(new[1].max())

        def entry(seed):
            kw = ({"traffic_sweep": pts} if pts
                  else {"sim_end_us": ends} if C > 1 else {})
            return bss.run_replicated_bss(prog, BSS_R, PRNGKey(seed),
                                          device=dev, **kw)

        times, walls = in_turns(old_lib, "bss_advance", launch, entry,
                                BSS_TIMED_CALLS)
        line = dict(
            points=C, steps_max=steps,
            old_ms=times["old"], new_ms=times["new"],
            old_us_per_step=statistics.mean(times["old"]) * 1e3 / steps,
            new_us_per_step=statistics.mean(times["new"]) * 1e3 / steps,
            new_over_old=statistics.mean(times["new"])
            / statistics.mean(times["old"]),
            old_wall_s=walls["old"], new_wall_s=walls["new"],
            wall_new_over_old=statistics.mean(walls["new"])
            / statistics.mean(walls["old"]),
        )
        result["programs"][name] = line
        print(f"compare ({name}, N={consts['N']}, {C} x {BSS_R}, {steps} "
              f"steps at most): old "
              f"{line['old_ms']} ms, new {line['new_ms']} ms a launch "
              f"(new/old {line['new_over_old']:.4f}: "
              f"{line['old_us_per_step']:.4f} -> "
              f"{line['new_us_per_step']:.4f} us/step); walls old "
              f"{walls['old']}, new {walls['new']} s", flush=True)
    result["split_new"] = bss_stage_split(dev, "new")
    with kernel_library(old_lib):
        result["split_old"] = bss_stage_split(dev, "old")
    return result


def in_turns(old_lib, name: str, launch, entry, calls: int):
    """``(times, walls)``: ``launch``'s device time (ms, :func:`timed_ms`
    of ``calls`` launches, median of three) and ``entry``'s wall (s, the
    median of three runs on keys 1..3 after one on key 0), each taken in
    turns old, new, new, old (the old turns with kernel ``name`` from
    ``old_lib``)."""
    import torch

    times = {"old": [], "new": []}
    walls = {"old": [], "new": []}
    for turn in ("old", "new", "new", "old"):
        ctx = (kernel_library(old_lib, name) if turn == "old"
               else contextlib.nullcontext())
        with ctx:
            times[turn].append(timed_ms(launch, calls, reps=3)[0])
            entry(0)
            w = []
            for i in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                entry(1 + i)
                torch.cuda.synchronize()
                w.append(time.perf_counter() - t1)
            walls[turn].append(statistics.median(w))
    return times, walls


def tcp_compare(old_lib, dev, card: str, old_dir: str) -> dict:
    """The TCP half of the compare mode: for each of :data:`TCP_COMPARE`
    at ``TCP_R`` replicas x ``TCP_SIM_S`` s the two kernels' states equal
    after one launch of the whole horizon, their times in turns (old,
    new, new, old): the launch's device time (CUDA events) and
    ``run_tcp_dumbbell``'s wall (median of three runs a turn); then the
    stage probe of the new kernel, and of the old one where its library
    has ``tcp_advance_profile``.  The old kernel runs at the rows a block
    its source names (:func:`old_tcp_library`), so an edited copy of this
    checkout's source times another geometry.  Returns the
    ``tcp_old_vs_new`` line."""
    import torch
    from tpudes_torch.parallel import tcp_dumbbell as tcp
    from tpudes_torch.parallel.tcp_cuda import TCP_ROWS_PER_BLOCK, tcp_launch
    from tpudes_torch.random import PRNGKey

    old_lib, old_rpb = old_tcp_library(old_lib, old_dir)
    tcp_division(dev)
    result = dict(phase="tcp_old_vs_new", card=card, old=old_dir,
                  replicas=TCP_R, sim_s=TCP_SIM_S,
                  rows_per_block=dict(old=old_rpb, new=TCP_ROWS_PER_BLOCK),
                  programs={})
    for name in TCP_COMPARE:
        prog = tcp_programs(TCP_SIM_S)[name]
        consts = tcp.build_tcp_consts(prog, dev)
        var, ecn = (torch.as_tensor(x, device=dev)
                    for x in tcp.sweep_operands(prog))
        key = PRNGKey(TCP_CHECK_SEED, device=dev)
        s0 = tcp.init_state(consts, TCP_R)
        n = prog.n_slots

        def launch():
            return tcp_launch(consts, s0, key, 0, n, var, ecn)

        def same(a, b):
            return all(torch.equal(bits_of(a[k]), bits_of(b[k]))
                       for k, _, _ in tcp.TCP_STATE)

        new = launch()
        with kernel_library(old_lib, "tcp_advance"):
            was = launch()
        torch.cuda.synchronize()
        if not same(new, was):
            fail(f"compare ({name}): the states differ between old and new")

        def entry(seed):
            return tcp.run_tcp_dumbbell(prog, PRNGKey(seed), TCP_R,
                                        device=dev)

        times, walls = in_turns(old_lib, "tcp_advance", launch, entry, 1)
        line = dict(
            n_flows=prog.n_flows, slots=n,
            old_ms=times["old"], new_ms=times["new"],
            old_us_per_slot=statistics.mean(times["old"]) * 1e3 / n,
            new_us_per_slot=statistics.mean(times["new"]) * 1e3 / n,
            new_over_old=statistics.mean(times["new"])
            / statistics.mean(times["old"]),
            old_wall_s=walls["old"], new_wall_s=walls["new"],
            wall_new_over_old=statistics.mean(walls["new"])
            / statistics.mean(walls["old"]),
        )
        result["programs"][name] = line
        print(f"compare ({name}, F={prog.n_flows}, {TCP_R} x {TCP_SIM_S} s, "
              f"{n} slots): states equal; old {line['old_ms']} ms, new "
              f"{line['new_ms']} ms a launch (new/old "
              f"{line['new_over_old']:.4f}: {line['old_us_per_slot']:.4f} "
              f"-> {line['new_us_per_slot']:.4f} us/slot); walls old "
              f"{walls['old']}, new {walls['new']} s (rows a block old "
              f"{old_rpb}, new {TCP_ROWS_PER_BLOCK})", flush=True)
    result["split_new"] = tcp_stage_split(dev, "new")
    if hasattr(old_lib, "tcp_advance_profile"):
        with kernel_library(old_lib, "tcp_advance"):
            result["split_old"] = tcp_stage_split(dev, "old")
    else:
        result["split_old"] = "not measured: the old kernel has no probe"
    return result


def compare_main(old_dir: str, device: str = "cuda") -> int:
    """``python3 chip_smoke.py --compare-with DIR``: each of
    ``DIR/bss_advance.cu``, ``DIR/tcp_advance.cu``, ``DIR/wifi_window.cu``
    (an earlier design of the kernel with the same C interface),
    ``DIR/as_flows.cu`` (the first design's, through its own C
    interface) and ``DIR/wired_advance.cu`` (the first wired design's,
    through its own C interface) that is there against this checkout's,
    in one call on one card.  Builds all of them in parallel (printing
    the window kernels' SASS counts); runs :func:`bss_compare`,
    :func:`tcp_compare`, :func:`window_compare`, :func:`as_compare` and
    :func:`wired_compare` and prints each one's JSON line (``phase:
    bss_old_vs_new`` / ``tcp_old_vs_new`` / ``window_old_vs_new`` /
    ``as_old_vs_new`` / ``wired_old_vs_new``)."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from tpudes_torch import _build

    dev = torch.device(device)
    card = card_line()
    print(card, flush=True)
    names = [k for k in ("bss_advance", "tcp_advance", "wifi_window",
                         "as_flows", "wired_advance")
             if os.path.isfile(os.path.join(old_dir, f"{k}.cu"))]
    if not names:
        fail(f"{old_dir} holds none of bss_advance.cu, tcp_advance.cu, "
             f"wifi_window.cu, as_flows.cu, wired_advance.cu")
    t0 = time.monotonic()
    old = {k: build_old(k, old_dir) for k in names}
    logs = _build.build(names)
    new_s = time.monotonic() - t0
    libs = {}
    for k, (proc, path) in old.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"the old {k} build failed:\n{log}")
        print("\n".join(ptxas_lines(k, logs[k])
                        + ptxas_lines(f"{k} (old)", log)), flush=True)
        if k == "wifi_window":
            print("\n".join(sass_lines(k, _build.library_path(k))
                            + sass_lines(f"{k} (old)", path)), flush=True)
        libs[k] = ctypes.CDLL(str(path))
    print(f"build: new {new_s:.2f} s, old {time.monotonic() - t0:.2f} s "
          f"(in parallel)", flush=True)
    compares = {"bss_advance": bss_compare, "tcp_advance": tcp_compare,
                "wifi_window": window_compare, "as_flows": as_compare,
                "wired_advance": wired_compare}
    for k in names:
        print(json.dumps(compares[k](libs[k], dev, card, old_dir)),
              flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def main(device: str = "cuda") -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from tpudes_torch import _build
    from tpudes_torch.parallel import kernels_cuda as kc
    from tpudes_torch.parallel.lte_sm import (
        TRAFFIC_MAX_ROWS,
        geom_rows,
        run_lte_sm,
    )
    from tpudes_torch.random import PRNGKey, fold_in, replica_keys
    from tpudes_torch.scenarios import (
        ONOFF_OFF_MEAN_S,
        ONOFF_ON,
        ONOFF_PEAK_PPS,
        ONOFF_TR_SEED,
        lena_grid_program,
        lena_mobile_program,
        lena_traffic_program,
        lena_ue_drop,
    )
    from tpudes_torch.traffic.device import TRAFFIC_KEY_TAG, offered_table
    from tpudes_torch.traffic.program import TrafficProgram

    dev = torch.device(device)

    # 1. the card
    card = card_line()
    print(card, flush=True)

    # 2. build every kernel of the path, in parallel
    t0 = time.monotonic()
    logs = _build.build(["lte_sm_step", "lte_sm_advance", "bss_advance",
                         "tcp_advance", "wifi_window", "as_flows",
                         "wired_advance"])
    print(f"build: {time.monotonic() - t0:.2f} s", flush=True)
    for name, text in logs.items():
        print("\n".join(ptxas_lines(name, text)), flush=True)
    print("\n".join(sass_lines("wifi_window",
                               _build.library_path("wifi_window"))),
          flush=True)

    gen = torch.Generator().manual_seed(SEED)
    enb_pos, ue_pos = lena_ue_drop(E, UES_PER_CELL, generator=gen)
    prog = lena_grid_program(enb_pos, ue_pos, CHECK_TTIS)
    U = prog.n_ue
    consts = kc.build_sm_consts(prog, device=dev)
    # the same drop, moving: lena_mobile_program draws the drop first
    mobile = lena_mobile_program(
        E, UES_PER_CELL, BENCH_TTIS, "const_velocity", MOBILE_SPEED,
        MOBILE_STRIDE, generator=torch.Generator().manual_seed(SEED),
    )
    if not np.array_equal(mobile.gain, prog.gain):
        fail("the moving drop does not start on the static drop")

    # 3. each kernel vs its plain version, every scheduler id, random
    #    warmed states
    rng = np.random.default_rng(SEED)
    max_err, t = 0.0, 1000
    for sched, sid in kc.SM_SCHED_IDS.items():
        s = random_state(kc, consts, t, rng, dev)
        coin = torch.from_numpy(
            rng.uniform(0.0, 1.0, (R, U)).astype(np.float32)
        ).to(dev)
        got = kc.sm_step_cuda(consts, s, coin, t, sid)
        want = kc.sm_step_math(consts, s, coin, t, sid)
        torch.cuda.synchronize()
        max_err = max(max_err, compare_states(
            kc, got, want, f"lte_sm_step vs plain core, sid={sid} ({sched})"
        ))
    print(f"lte_sm_step vs plain core: 14 state arrays bit-equal for sids "
          f"0-8 at E={E} U={U} R={R}", flush=True)
    s = random_state(kc, consts, t, rng, dev)
    coin = torch.rand((R, U), device=dev)
    ms_kernel, host_kernel = timed_ms(
        lambda: kc.sm_step_cuda(consts, s, coin, t, 0), TIMED_KERNEL_CALLS
    )
    ms_plain, host_plain = timed_ms(
        lambda: kc.sm_step_math(consts, s, coin, t, 0), TIMED_PLAIN_CALLS
    )
    bound_ms, bound_by = step_bound(
        consts, s, coin, kc.sm_step_cuda(consts, s, coin, t, 0), t
    )
    print(f"lte_sm_step: device {ms_kernel * 1e3:.2f} us/launch (host "
          f"{host_kernel * 1e3:.2f} us/call), plain core device "
          f"{ms_plain * 1e3:.2f} us/call (host {host_plain * 1e3:.2f} "
          f"us/call), bound {bound_ms * 1e3:.3f} us ({bound_by})",
          flush=True)

    # first-tx MI pulled below the code rate for some UEs, so that new
    # failures, retx and drops keep occurring through the check
    mi_scale = torch.linspace(0.1, 1.0, U, device=dev)
    harq = dict(consts, mi0=(consts["mi0"] * mi_scale).contiguous())
    adv_err, ladder = 0.0, {"retx": 0, "drops": 0}
    ta = ADVANCE_T0
    tb, tc = ta + ADVANCE_LAUNCHES[0], ta + sum(ADVANCE_LAUNCHES)
    for sched, sid in kc.SM_SCHED_IDS.items():
        s = random_state(kc, consts, ta, rng, dev)
        keys = replica_keys(PRNGKey(SEED + sid, device=dev), R)
        got = kc.sm_advance_cuda(
            harq, kc.sm_advance_cuda(harq, s, keys, ta, tb, sid),
            keys, tb, tc, sid,
        )
        want = kc.sm_advance_math(harq, s, keys, ta, tc, sid)
        torch.cuda.synchronize()
        adv_err = max(adv_err, compare_states(
            kc, got, want, f"lte_sm_advance vs plain loop, sid={sid} ({sched})"
        ))
        for k in ladder:
            ladder[k] += int((got[k] - s[k]).sum())
    if min(ladder.values()) <= 0:
        fail(f"lte_sm_advance check ran no retx or no drop: {ladder}")
    print(f"lte_sm_advance vs plain loop: 14 state arrays bit-equal for "
          f"sids 0-8 at E={E} U={U} R={R} over 2 launches (TTIs "
          f"[{ta}, {tb}) and [{tb}, {tc})); retx {ladder['retx']}, drops "
          f"{ladder['drops']}", flush=True)
    s = random_state(kc, consts, ta, rng, dev)
    keys = replica_keys(PRNGKey(SEED, device=dev), R)
    ms_adv, host_adv = timed_ms(
        lambda: kc.sm_advance_cuda(consts, s, keys, ta, ta + TIMED_TTIS, 0),
        TIMED_ADVANCE_CALLS,
    )
    ms_adv_plain, host_adv_plain = timed_ms(
        lambda: kc.sm_advance_math(consts, s, keys, ta, ta + TIMED_TTIS, 0),
        1, reps=3,
    )
    adv_bound_ms, adv_bound_by = advance_bound(
        consts, s, keys,
        kc.sm_advance_cuda(consts, s, keys, ta, ta + TIMED_TTIS, 0),
        TIMED_TTIS,
    )
    print(f"lte_sm_advance: {TIMED_TTIS} TTIs/launch: device "
          f"{ms_adv * 1e3:.2f} us/launch = {ms_adv * 1e3 / TIMED_TTIS:.4f} "
          f"us/TTI (host {host_adv * 1e3:.2f} us/call), plain loop device "
          f"{ms_adv_plain * 1e3:.2f} us/call (host "
          f"{host_adv_plain * 1e3:.2f} us/call), bound "
          f"{adv_bound_ms * 1e3:.3f} us ({adv_bound_by})", flush=True)

    # 3b. the dynamic arm: a stride-8 geometry table of the moving drop,
    #     built on the card, its first-tx MI pulled down as above
    mconsts = kc.build_sm_consts(mobile, device=dev)

    def table(t0_, t1_):
        j0 = t0_ // MOBILE_STRIDE
        rows = geom_rows(mobile, mconsts, MOBILE_STRIDE * torch.arange(
            j0, j0 + kc.table_rows(t0_, t1_, MOBILE_STRIDE), device=dev,
        ))
        out = {k: rows[k].contiguous() for k in kc.SM_DYNAMIC_ROWS}
        out["mi0"] = (out["mi0"] * mi_scale).contiguous()
        return out

    dyn_err, ladder = 0.0, {"retx": 0, "drops": 0}
    tb, tc = ta + DYNAMIC_LAUNCHES[0], ta + sum(DYNAMIC_LAUNCHES)
    for sched, sid in kc.SM_SCHED_IDS.items():
        s = random_state(kc, mconsts, ta, rng, dev)
        keys = replica_keys(PRNGKey(SEED + sid, device=dev), R)
        got = kc.sm_advance_cuda(
            mconsts, kc.sm_advance_cuda(mconsts, s, keys, ta, tb, sid,
                                        table(ta, tb), MOBILE_STRIDE),
            keys, tb, tc, sid, table(tb, tc), MOBILE_STRIDE,
        )
        want = kc.sm_advance_math(mconsts, s, keys, ta, tc, sid,
                                  table(ta, tc), MOBILE_STRIDE)
        torch.cuda.synchronize()
        dyn_err = max(dyn_err, compare_states(
            kc, got, want, f"dynamic arm vs plain loop, sid={sid} ({sched})"
        ))
        for k in ladder:
            ladder[k] += int((got[k] - s[k]).sum())
    if min(ladder.values()) <= 0:
        fail(f"dynamic arm check ran no retx or no drop: {ladder}")
    print(f"lte_sm_advance dynamic arm vs plain loop: 14 state arrays "
          f"bit-equal for sids 0-8 at E={E} U={U} R={R}, stride "
          f"{MOBILE_STRIDE}, over 2 launches (TTIs [{ta}, {tb}) and "
          f"[{tb}, {tc})); retx {ladder['retx']}, drops {ladder['drops']}",
          flush=True)
    s = random_state(kc, mconsts, ta, rng, dev)
    keys = replica_keys(PRNGKey(SEED, device=dev), R)
    tab = table(ta, ta + TIMED_TTIS)
    ms_dyn, host_dyn = timed_ms(
        lambda: kc.sm_advance_cuda(mconsts, s, keys, ta, ta + TIMED_TTIS, 0,
                                   tab, MOBILE_STRIDE),
        TIMED_ADVANCE_CALLS,
    )
    ms_dyn_plain, _ = timed_ms(
        lambda: kc.sm_advance_math(mconsts, s, keys, ta, ta + TIMED_TTIS, 0,
                                   tab, MOBILE_STRIDE),
        1, reps=3,
    )
    dyn_bound_ms, dyn_bound_by = advance_bound(
        mconsts, s, keys,
        kc.sm_advance_cuda(mconsts, s, keys, ta, ta + TIMED_TTIS, 0, tab,
                           MOBILE_STRIDE),
        TIMED_TTIS, table=tab,
    )
    print(f"lte_sm_advance dynamic arm: {TIMED_TTIS} TTIs/launch: device "
          f"{ms_dyn * 1e3:.2f} us/launch = {ms_dyn * 1e3 / TIMED_TTIS:.4f} "
          f"us/TTI (static arm {ms_adv * 1e3 / TIMED_TTIS:.4f} us/TTI; host "
          f"{host_dyn * 1e3:.2f} us/call), plain loop device "
          f"{ms_dyn_plain * 1e3:.2f} us/call, bound "
          f"{dyn_bound_ms * 1e3:.3f} us ({dyn_bound_by})", flush=True)

    # 3c. the sweep arm: one launch of all nine ids against the plain
    #     loop, on the static rows and on the stride-8 table (the launch
    #     the mobile sweep makes), first-tx MI pulled down as above
    C = len(kc.SM_SCHED_IDS)
    sids = torch.tensor(list(kc.SM_SCHED_IDS.values()), dtype=torch.int32,
                        device=dev)
    keys = replica_keys(PRNGKey(SEED + 99, device=dev), R)
    sweep_err = 0.0
    for rows_of, cs, rows in (("static rows", harq, None),
                              (f"a stride-{MOBILE_STRIDE} table", mconsts,
                               table(ta, tc))):
        s = random_state(kc, cs, ta, rng, dev, lanes=C * R)
        got = kc.sm_advance_cuda(cs, s, keys, ta, tc, sids, rows,
                                 MOBILE_STRIDE)
        want = kc.sm_advance_math(cs, s, keys, ta, tc, sids, rows,
                                  MOBILE_STRIDE)
        torch.cuda.synchronize()
        for i, sched in enumerate(kc.SM_SCHED_IDS):
            lanes = slice(i * R, (i + 1) * R)
            sweep_err = max(sweep_err, compare_states(
                kc, {k: v[lanes] for k, v in got.items()},
                {k: v[lanes] for k, v in want.items()},
                f"sweep arm on {rows_of} vs plain loop, point {i} ({sched})",
            ))
        ladder = {k: int((got[k] - s[k]).sum()) for k in ("retx", "drops")}
        if min(ladder.values()) <= 0:
            fail(f"sweep arm check on {rows_of} ran no retx or no drop: "
                 f"{ladder}")
        print(f"lte_sm_advance sweep arm on {rows_of} vs plain loop: one "
              f"launch of {C} x {R} CTAs (TTIs [{ta}, {tc})), 14 state "
              f"arrays bit-equal per point; retx {ladder['retx']}, drops "
              f"{ladder['drops']}", flush=True)
    # timed on the stride-8 table, as the mobile sweep launches it
    tt = ta + SWEEP_TIMED_TTIS
    stab = {k: v[:kc.table_rows(ta, tt, MOBILE_STRIDE)].contiguous()
            for k, v in tab.items()}
    s = random_state(kc, mconsts, ta, rng, dev, lanes=C * R)
    ms_sweep, host_sweep = timed_ms(
        lambda: kc.sm_advance_cuda(mconsts, s, keys, ta, tt, sids, stab,
                                   MOBILE_STRIDE),
        TIMED_ADVANCE_CALLS,
    )
    ms_sweep_plain, _ = timed_ms(
        lambda: kc.sm_advance_math(mconsts, s, keys, ta, tt, sids, stab,
                                   MOBILE_STRIDE),
        1, reps=2,
    )
    sweep_bound_ms, sweep_bound_by = advance_bound(
        mconsts, s, keys,
        kc.sm_advance_cuda(mconsts, s, keys, ta, tt, sids, stab,
                           MOBILE_STRIDE),
        SWEEP_TIMED_TTIS, table=stab, sids=sids,
    )
    print(f"lte_sm_advance sweep arm on a stride-{MOBILE_STRIDE} table: "
          f"{C} x {R} CTAs, {SWEEP_TIMED_TTIS} "
          f"TTIs/launch: device {ms_sweep * 1e3:.2f} us/launch = "
          f"{ms_sweep * 1e3 / SWEEP_TIMED_TTIS:.4f} us/TTI for all points "
          f"(host {host_sweep * 1e3:.2f} us/call), plain loop device "
          f"{ms_sweep_plain * 1e3:.2f} us/call, bound "
          f"{sweep_bound_ms * 1e3:.3f} us ({sweep_bound_by})", flush=True)

    # 3d. the traffic arm: two launches per scheduler id on the full-width
    #     offered table of the ON-OFF workload, from warm backlogs, first-tx
    #     MI pulled down as above; for sid 0 also one launch per TTI, which
    #     must give the same state, counting the UE-TTIs the backlog gate
    #     held back (an eligible UE with an empty backlog)
    tr_prog = lena_traffic_program(
        E, UES_PER_CELL, BENCH_TTIS,
        generator=torch.Generator().manual_seed(SEED),
    )
    if not np.array_equal(tr_prog.gain, prog.gain):
        fail("the traffic drop does not start on the static drop")
    tconsts = kc.build_sm_consts(tr_prog, device=dev)
    tharq = dict(tconsts, mi0=(tconsts["mi0"] * mi_scale).contiguous())
    tr_ops = tr_prog.traffic.operands(dev)
    tr_key = fold_in(PRNGKey(SEED, device=dev), TRAFFIC_KEY_TAG)

    def offered(t0_, t1_, prog_=tr_prog, ops_=None, key_=None):
        return offered_table(ops_ or tr_ops, prog_.traffic.epoch_us,
                             tr_key if key_ is None else key_, t0_, t1_)

    tb, tc = ta + ADVANCE_LAUNCHES[0], ta + sum(ADVANCE_LAUNCHES)
    off, off_b, off_c = offered(ta, tc), offered(ta, tb), offered(tb, tc)
    trf_err, gated, left = 0.0, 0, 0
    ladder = {"retx": 0, "drops": 0}
    elig = tharq["eligible"] != 0
    for sched, sid in kc.SM_SCHED_IDS.items():
        s = traffic_state(kc, tconsts, ta, rng, dev)
        keys = replica_keys(PRNGKey(SEED + sid, device=dev), R)
        got = kc.sm_advance_cuda(
            tharq, kc.sm_advance_cuda(tharq, s, keys, ta, tb, sid,
                                      offered=off_b),
            keys, tb, tc, sid, offered=off_c,
        )
        want = kc.sm_advance_math(tharq, s, keys, ta, tc, sid, offered=off)
        torch.cuda.synchronize()
        trf_err = max(trf_err, compare_states(
            kc, got, want, f"traffic arm vs plain loop, sid={sid} ({sched})",
            traffic=True,
        ))
        if sid == 0:
            one = s
            for i in range(tc - ta):
                gated += int(((one["tr_backlog"] + off[i] == 0)
                              & elig).sum())
                one = kc.sm_advance_cuda(tharq, one, keys, ta + i,
                                         ta + i + 1, sid,
                                         offered=off[i:i + 1])
            compare_states(kc, one, got, "traffic arm one launch per TTI "
                           "vs two launches", traffic=True)
        left += int((got["tr_backlog"] > 0).sum())
        for k in ladder:
            ladder[k] += int((got[k] - s[k]).sum())
    if gated <= 0 or left <= 0 or min(ladder.values()) <= 0:
        fail(f"traffic arm check: gate held back {gated} UE-TTIs, {left} "
             f"backlogs left, {ladder}")
    print(f"lte_sm_advance traffic arm vs plain loop: 14 state arrays and "
          f"the 3 backlog arrays bit-equal for sids 0-8 at E={E} U={U} "
          f"R={R} over 2 launches (TTIs [{ta}, {tb}) and [{tb}, {tc})) on "
          f"the full-width offered table (and, sid 0, one launch per TTI: "
          f"the same state; the gate held back {gated} eligible UE-TTIs "
          f"with an empty backlog); {left} backlogs left; retx "
          f"{ladder['retx']}, drops {ladder['drops']}", flush=True)
    s = traffic_state(kc, tconsts, ta, rng, dev)
    keys = replica_keys(PRNGKey(SEED, device=dev), R)
    off_t = offered(ta, ta + TIMED_TTIS)
    ms_trf, host_trf = timed_ms(
        lambda: kc.sm_advance_cuda(tconsts, s, keys, ta, ta + TIMED_TTIS, 0,
                                   offered=off_t),
        TIMED_ADVANCE_CALLS,
    )
    ms_trf_plain, _ = timed_ms(
        lambda: kc.sm_advance_math(tconsts, s, keys, ta, ta + TIMED_TTIS, 0,
                                   offered=off_t),
        1, reps=3,
    )
    trf_bound_ms, trf_bound_by = advance_bound(
        tconsts, s, keys,
        kc.sm_advance_cuda(tconsts, s, keys, ta, ta + TIMED_TTIS, 0,
                           offered=off_t),
        TIMED_TTIS, table={"offered": off_t},
    )
    print(f"lte_sm_advance traffic arm: {TIMED_TTIS} TTIs/launch: device "
          f"{ms_trf * 1e3:.2f} us/launch = {ms_trf * 1e3 / TIMED_TTIS:.4f} "
          f"us/TTI (static arm {ms_adv * 1e3 / TIMED_TTIS:.4f} us/TTI; host "
          f"{host_trf * 1e3:.2f} us/call), plain loop device "
          f"{ms_trf_plain * 1e3:.2f} us/call, bound "
          f"{trf_bound_ms * 1e3:.3f} us ({trf_bound_by})", flush=True)

    # 3e. bf16: the static rows over two launches per scheduler id; then
    #     one launch of all nine ids on each other arm: the stride-8
    #     table of the moving drop, the offered table, and (f32) the
    #     sweep with traffic
    b_prog = dataclasses.replace(prog, precision="bf16")
    bconsts = kc.build_sm_consts(b_prog, device=dev)
    bharq = dict(bconsts, mi0=(bconsts["mi0"] * mi_scale).contiguous())
    bf_err, ladder = 0.0, {"retx": 0, "drops": 0}
    tb, tc = ta + ADVANCE_LAUNCHES[0], ta + sum(ADVANCE_LAUNCHES)
    for sched, sid in kc.SM_SCHED_IDS.items():
        s = random_state(kc, bconsts, ta, rng, dev)
        keys = replica_keys(PRNGKey(SEED + sid, device=dev), R)
        got = kc.sm_advance_cuda(
            bharq, kc.sm_advance_cuda(bharq, s, keys, ta, tb, sid),
            keys, tb, tc, sid,
        )
        want = kc.sm_advance_math(bharq, s, keys, ta, tc, sid)
        torch.cuda.synchronize()
        bf_err = max(bf_err, compare_states(
            kc, got, want, f"bf16 static arm vs plain loop, sid={sid} "
            f"({sched})"))
        for k in ladder:
            ladder[k] += int((got[k] - s[k]).sum())
    if min(ladder.values()) <= 0:
        fail(f"bf16 static arm check ran no retx or no drop: {ladder}")
    print(f"lte_sm_advance bf16 static arm vs plain loop: 14 state arrays "
          f"bit-equal for sids 0-8 at E={E} U={U} R={R} over 2 launches; "
          f"retx {ladder['retx']}, drops {ladder['drops']}", flush=True)
    b_mobile = dataclasses.replace(mobile, precision="bf16")
    bmconsts = kc.build_sm_consts(b_mobile, device=dev)
    j0 = ta // MOBILE_STRIDE
    brows = geom_rows(b_mobile, bmconsts, MOBILE_STRIDE * torch.arange(
        j0, j0 + kc.table_rows(ta, tc, MOBILE_STRIDE), device=dev))
    brows = {k: brows[k].contiguous() for k in kc.SM_DYNAMIC_ROWS}
    brows["mi0"] = (brows["mi0"] * mi_scale).contiguous()
    tb16 = kc.build_sm_consts(dataclasses.replace(tr_prog, precision="bf16"),
                              device=dev)
    tb16 = dict(tb16, mi0=(tb16["mi0"] * mi_scale).contiguous())
    keys = replica_keys(PRNGKey(SEED + 98, device=dev), R)
    for what, cs, rows, off_, traffic in (
        (f"bf16 on a stride-{MOBILE_STRIDE} table", bmconsts, brows, None,
         False),
        ("bf16 with traffic", tb16, None, off, True),
        ("f32 with traffic", tharq, None, off, True),
    ):
        s = (traffic_state if traffic else random_state)(
            kc, cs, ta, rng, dev, lanes=C * R)
        got = kc.sm_advance_cuda(cs, s, keys, ta, tc, sids, rows,
                                 MOBILE_STRIDE, off_)
        want = kc.sm_advance_math(cs, s, keys, ta, tc, sids, rows,
                                  MOBILE_STRIDE, off_)
        torch.cuda.synchronize()
        for i, sched in enumerate(kc.SM_SCHED_IDS):
            lanes = slice(i * R, (i + 1) * R)
            err = compare_states(
                kc, {k: v[lanes] for k, v in got.items()},
                {k: v[lanes] for k, v in want.items()},
                f"sweep arm {what} vs plain loop, point {i} ({sched})",
                traffic=traffic,
            )
            if what.startswith("bf16"):
                bf_err = max(bf_err, err)
            else:
                trf_err = max(trf_err, err)
        ladder = {k: int((got[k] - s[k]).sum()) for k in ("retx", "drops")}
        if min(ladder.values()) <= 0:
            fail(f"sweep arm {what} ran no retx or no drop: {ladder}")
        print(f"lte_sm_advance sweep arm {what} vs plain loop: one launch "
              f"of {C} x {R} CTAs (TTIs [{ta}, {tc})), state bit-equal per "
              f"point; retx {ladder['retx']}, drops {ladder['drops']}",
              flush=True)
    s = random_state(kc, bconsts, ta, rng, dev)
    keys = replica_keys(PRNGKey(SEED, device=dev), R)
    ms_bf, host_bf = timed_ms(
        lambda: kc.sm_advance_cuda(bconsts, s, keys, ta, ta + TIMED_TTIS, 0),
        TIMED_ADVANCE_CALLS,
    )
    ms_f32_again, _ = timed_ms(
        lambda: kc.sm_advance_cuda(consts, s, keys, ta, ta + TIMED_TTIS, 0),
        TIMED_ADVANCE_CALLS,
    )
    ms_bf_plain, _ = timed_ms(
        lambda: kc.sm_advance_math(bconsts, s, keys, ta, ta + TIMED_TTIS, 0),
        1, reps=3,
    )
    bf_bound_ms, bf_bound_by = advance_bound(
        bconsts, s, keys,
        kc.sm_advance_cuda(bconsts, s, keys, ta, ta + TIMED_TTIS, 0),
        TIMED_TTIS,
    )
    print(f"lte_sm_advance bf16 static arm: {TIMED_TTIS} TTIs/launch: "
          f"device {ms_bf * 1e3:.2f} us/launch = "
          f"{ms_bf * 1e3 / TIMED_TTIS:.4f} us/TTI (f32 static arm, same "
          f"state, timed after it: {ms_f32_again * 1e3 / TIMED_TTIS:.4f} "
          f"us/TTI; host {host_bf * 1e3:.2f} us/call), plain loop device "
          f"{ms_bf_plain * 1e3:.2f} us/call, bound {bf_bound_ms * 1e3:.3f} "
          f"us ({bf_bound_by})", flush=True)

    # 3f. lte_sm_step in bf16, every scheduler id
    step_bf_err = 0.0
    for sched, sid in kc.SM_SCHED_IDS.items():
        s = random_state(kc, bconsts, t, rng, dev)
        coin = torch.from_numpy(
            rng.uniform(0.0, 1.0, (R, U)).astype(np.float32)
        ).to(dev)
        got = kc.sm_step_cuda(bconsts, s, coin, t, sid)
        want = kc.sm_step_math(bconsts, s, coin, t, sid)
        torch.cuda.synchronize()
        step_bf_err = max(step_bf_err, compare_states(
            kc, got, want, f"lte_sm_step bf16 vs plain core, sid={sid} "
            f"({sched})"))
    s = random_state(kc, bconsts, t, rng, dev)
    coin = torch.rand((R, U), device=dev)
    ms_step_bf, host_step_bf = timed_ms(
        lambda: kc.sm_step_cuda(bconsts, s, coin, t, 0), TIMED_KERNEL_CALLS
    )
    ms_step_bf_plain, _ = timed_ms(
        lambda: kc.sm_step_math(bconsts, s, coin, t, 0), TIMED_PLAIN_CALLS
    )
    step_bf_bound = step_bound(
        bconsts, s, coin, kc.sm_step_cuda(bconsts, s, coin, t, 0), t
    )
    print(f"lte_sm_step bf16 vs plain core: 14 state arrays bit-equal for "
          f"sids 0-8; device {ms_step_bf * 1e3:.2f} us/launch (host "
          f"{host_step_bf * 1e3:.2f} us/call), plain core device "
          f"{ms_step_bf_plain * 1e3:.2f} us/call, bound "
          f"{step_bf_bound[0] * 1e3:.3f} us ({step_bf_bound[1]})",
          flush=True)

    # 3g. bss_advance vs the plain loop at bench width, legacy and (3g-ht)
    #     802.11n A-MPDUs; then the horizon sweep's grid of each
    bss_numbers = bss_check(kc, dev, "legacy")
    ht_numbers = bss_check(kc, dev, "ht")
    sweep_numbers = {w: bss_sweep_check(kc, dev, w) for w in ("legacy", "ht")}
    # 3h. the MOB and TRF arms and the traffic grid at bench width
    arm_numbers = {w: bss_check(kc, dev, w)
                   for w in ("mobile", "onoff", "sweep", "composed")}
    # 3p. the stage probe of bss_advance on legacy, AGG, MOB and TRF
    bss_stage_split(dev, "bss_advance")
    # 3t. tcp_advance's fast division vs __fdiv_rn; tcp_advance vs the
    #     plain loop at bench width: bench_tcp, the 17-variant program,
    #     RED/ECN and the four-point variant grid
    tcp_division(dev)
    tcp_numbers = {w: tcp_check(kc, dev, w)
                   for w in ("bench_tcp", "variants17", "red", "grid")}
    #     and the stage probe of tcp_advance on bench_tcp, the 17-variant
    #     and the RED programs
    tcp_stage_split(dev, "tcp_advance")
    # 3w. tcp_advance's TRF arm vs the plain loop: bench_tcp's flows
    #     app-limited, and the eight-point workload grid
    t_phase = time.monotonic()
    trf_numbers = {w: tcp_trf_check(kc, dev, w)
                   for w in ("trf", "trf_sweep")}
    print(f"phase 3w: {time.monotonic() - t_phase:.1f} s", flush=True)
    # 3win. wifi_window vs its plain version at BASELINE row #3's shape
    t_phase = time.monotonic()
    win_numbers = window_check(kc, dev)
    print(f"phase 3win: {time.monotonic() - t_phase:.1f} s", flush=True)
    # 3as. as_spf and as_fluid vs their plain versions at bench_as's width
    t_phase = time.monotonic()
    as_numbers = as_check(kc, dev)
    print(f"phase 3as: {time.monotonic() - t_phase:.1f} s", flush=True)
    # 3wired. wired_advance vs its plain version at bench_wired's width
    t_phase = time.monotonic()
    wired_numbers = wired_check(kc, dev)
    print(f"phase 3wired: {time.monotonic() - t_phase:.1f} s", flush=True)

    # 4. the slice through the plain loop and the kernel, on the card;
    #    a small program through the plain loop on the CPU vs the kernel
    key = PRNGKey(SEED & 0x7FFFFFFF)
    plain = run_lte_sm(prog, key, replicas=R, device=dev, use_kernel=False)
    kern = run_lte_sm(prog, key, replicas=R, device=dev)
    if not same_outputs(plain, kern):
        fail("slice plain vs kernel differs in its integer outputs")
    if not np.array_equal(plain["sinr"].view(np.int32),
                          kern["sinr"].view(np.int32)):
        fail("slice plain vs kernel differs in sinr")
    print(f"slice plain vs kernel: integer outputs equal at {R} x "
          f"{CHECK_TTIS} TTIs (rx {int(kern['rx_bits'].sum())} bits, "
          f"retx {int(kern['retx'].sum())}, drops "
          f"{int(kern['drops'].sum())})", flush=True)
    small_pos = lena_ue_drop(2, 4, generator=torch.Generator().manual_seed(1))
    small = lena_grid_program(*small_pos, 300)
    on_cpu = run_lte_sm(small, key, replicas=4, device="cpu")
    on_gpu = run_lte_sm(small, key, replicas=4, device=dev)
    if not same_outputs(on_cpu, on_gpu):
        fail("small program: CPU plain loop vs kernel differs")
    print("small program (2 x 4 UE, 4 x 300 TTIs): CPU plain loop == "
          "kernel on the card", flush=True)

    # 4b. the same for the moving drop
    mobile_check = dataclasses.replace(mobile, n_ttis=CHECK_TTIS)
    plain = run_lte_sm(mobile_check, key, replicas=R, device=dev,
                       use_kernel=False)
    kern = run_lte_sm(mobile_check, key, replicas=R, device=dev)
    if not same_outputs(plain, kern, INT_KEYS + ("geom_refreshes",)):
        fail("mobile slice plain vs kernel differs in its integer outputs")
    if not np.array_equal(plain["sinr"].view(np.int32),
                          kern["sinr"].view(np.int32)):
        fail("mobile slice plain vs kernel differs in sinr")
    print(f"mobile slice plain vs kernel: integer outputs equal at {R} x "
          f"{CHECK_TTIS} TTIs, stride {MOBILE_STRIDE}, "
          f"{kern['geom_refreshes']} refreshes (rx "
          f"{int(kern['rx_bits'].sum())} bits, retx "
          f"{int(kern['retx'].sum())}, drops {int(kern['drops'].sum())})",
          flush=True)
    small_mob = lena_mobile_program(
        2, 4, 300, "const_velocity", MOBILE_SPEED, MOBILE_STRIDE,
        generator=torch.Generator().manual_seed(1),
    )
    cpu_consts = kc.build_sm_consts(small_mob, device="cpu")
    cpu_rows = geom_rows(small_mob, cpu_consts, MOBILE_STRIDE * torch.arange(
        kc.table_rows(0, 300, MOBILE_STRIDE)))
    cpu_rows = {k: cpu_rows[k].contiguous() for k in kc.SM_DYNAMIC_ROWS}
    cpu_keys = replica_keys(key, 4)
    want = kc.sm_advance_math(
        cpu_consts, kc.sm_init_state(2, 8, 4, device="cpu"), cpu_keys, 0,
        300, 0, cpu_rows, MOBILE_STRIDE,
    )
    got = kc.sm_advance_cuda(
        kc.build_sm_consts(small_mob, device=dev),
        kc.sm_init_state(2, 8, 4, device=dev), cpu_keys.to(dev), 0, 300, 0,
        {k: v.to(dev) for k, v in cpu_rows.items()}, MOBILE_STRIDE,
    )
    compare_states(kc, {k: v.cpu() for k, v in got.items()}, want,
                   "small moving program: CPU plain loop vs kernel fed the "
                   "CPU's table")
    if not same_outputs(run_lte_sm(small_mob, key, replicas=4, device="cpu"),
                        run_lte_sm(small_mob, key, replicas=4, device=dev)):
        fail("small moving program: CPU run vs card run differs")
    horizon = MOBILE_STRIDE * torch.arange(
        kc.table_rows(0, BENCH_TTIS, MOBILE_STRIDE))
    on_card = geom_rows(mobile, mconsts, horizon.to(dev))
    on_host = geom_rows(mobile, kc.build_sm_consts(mobile, device="cpu"),
                        horizon)
    table_diff = sum(int((on_card[k].cpu() != on_host[k]).sum())
                     for k in ("cqi", "mcs", "eligible"))
    sinr_diff = int((bits_of(on_card["sinr"]).cpu()
                     != bits_of(on_host["sinr"])).sum())
    entries = 3 * on_host["cqi"].numel()
    print(f"small moving program (2 x 4 UE, 4 x 300 TTIs): CPU plain loop "
          f"== kernel fed the CPU's table (14 state arrays bit-equal), and "
          f"CPU run == card run; the horizon's geometry table "
          f"({len(horizon)} refreshes x {U} UEs) card vs CPU: "
          f"{table_diff} of {entries} CQI/MCS/eligible entries differ "
          f"(bound {TABLE_DIFF_MAX_SHARE * entries:.0f}), {sinr_diff} SINR "
          f"values", flush=True)
    if table_diff > TABLE_DIFF_MAX_SHARE * entries:
        fail(f"card and CPU geometry tables differ in {table_diff} entries")

    # 4c. the traffic slice: plain loop vs kernel on the card; a small
    #     traffic program through the CPU's plain loop vs the kernel fed
    #     the CPU's offered table; the horizon's offered table card vs CPU
    tr_check = dataclasses.replace(tr_prog, n_ttis=CHECK_TTIS)
    plain = run_lte_sm(tr_check, key, replicas=R, device=dev,
                       use_kernel=False)
    kern = run_lte_sm(tr_check, key, replicas=R, device=dev)
    if not same_outputs(plain, kern, TRAFFIC_KEYS) or not np.array_equal(
            plain["backlog_bits"].view(np.int32),
            kern["backlog_bits"].view(np.int32)):
        fail("traffic slice plain vs kernel differs")
    print(f"traffic slice plain vs kernel: integer outputs and backlogs "
          f"equal at {R} x {CHECK_TTIS} TTIs (rx {int(kern['rx_bits'].sum())} "
          f"bits, goodput {int(kern['goodput_bits'].sum())} bits, "
          f"{int((kern['backlog_bits'] > 0).sum())} backlogs left, retx "
          f"{int(kern['retx'].sum())}, drops {int(kern['drops'].sum())})",
          flush=True)
    small_tr = lena_traffic_program(
        2, 4, 300, generator=torch.Generator().manual_seed(1))
    cpu_consts = kc.build_sm_consts(small_tr, device="cpu")
    cpu_ops = small_tr.traffic.operands("cpu")
    cpu_tr_key = fold_in(key, TRAFFIC_KEY_TAG)
    cpu_tab = offered(0, 300, small_tr, cpu_ops, cpu_tr_key)
    cpu_keys = replica_keys(key, 4)
    want = kc.sm_advance_math(
        cpu_consts, kc.sm_init_state(2, 8, 4, "cpu", traffic=True), cpu_keys,
        0, 300, 0, offered=cpu_tab,
    )
    got = kc.sm_advance_cuda(
        kc.build_sm_consts(small_tr, device=dev),
        kc.sm_init_state(2, 8, 4, dev, traffic=True), cpu_keys.to(dev), 0,
        300, 0, offered=cpu_tab.to(dev),
    )
    compare_states(kc, {k: v.cpu() for k, v in got.items()}, want,
                   "small traffic program: CPU plain loop vs kernel fed the "
                   "CPU's offered table", traffic=True)
    if not same_outputs(run_lte_sm(small_tr, key, replicas=4, device="cpu"),
                        run_lte_sm(small_tr, key, replicas=4, device=dev),
                        TRAFFIC_KEYS):
        fail("small traffic program: CPU run vs card run differs")
    tab_card = offered(0, BENCH_TTIS)
    tab_host = offered(0, BENCH_TTIS, tr_prog, tr_prog.traffic.operands("cpu"),
                       tr_key.cpu())
    offered_diff = int((bits_of(tab_card).cpu() != bits_of(tab_host)).sum())
    print(f"small traffic program (2 x 4 UE, 4 x 300 TTIs): CPU plain loop "
          f"== kernel fed the CPU's offered table (17 state arrays "
          f"bit-equal), and CPU run == card run; the horizon's offered table "
          f"({BENCH_TTIS} TTIs x {U} UEs) card vs CPU: {offered_diff} of "
          f"{tab_host.numel()} entries differ (bound 0)", flush=True)
    if offered_diff > 0:
        fail(f"card and CPU offered tables differ in {offered_diff} entries")

    # 5. each path at bench depth, counted: the single-step route, the
    #    static main path, the mobile main path, the sweep
    bench = dataclasses.replace(prog, n_ttis=BENCH_TTIS)
    sim_s = BENCH_TTIS * 1e-3
    n_launch = -(-BENCH_TTIS // (BENCH_CHUNK or BENCH_TTIS))
    step_route(dataclasses.replace(prog, n_ttis=50), key, dev)  # warm-up
    routed, step_wall, step_launches = counted(
        kc, lambda: step_route(bench, key, dev),
        {"lte_sm_step": BENCH_TTIS}, "single-step route",
    )
    print(json.dumps(dict(
        phase="bench_step_route", replicas=R, n_enb=E, n_ue=U,
        n_ttis=BENCH_TTIS, wall_s=step_wall,
        sim_s_per_wall_s=R * sim_s / step_wall,
        ttis_per_wall_s=R * BENCH_TTIS / step_wall,
        kernel_launches=step_launches,
    )), flush=True)

    def static_run():
        return run_lte_sm(bench, key, replicas=R, device=dev,
                          chunk_ttis=BENCH_CHUNK)

    run_lte_sm(dataclasses.replace(prog, n_ttis=50), key, replicas=R,
               device=dev, chunk_ttis=BENCH_CHUNK)          # warm-up
    out, wall, launches = counted(
        kc, static_run, {"lte_sm_advance": n_launch}, "static main path",
    )
    for k, v in out.items():
        if not np.all(np.isfinite(v)):
            fail(f"non-finite {k}")
    if out["rx_bits"].shape != (R, U) or out["rx_bits"].sum() <= 0:
        fail("bench run delivered nothing")
    routed = {k: v.cpu().numpy() for k, v in routed.items()}
    routed_rx = (routed["rx_hi"].astype(np.int64) << 20) + routed["rx_lo"]
    if not (np.array_equal(routed_rx, out["rx_bits"])
            and all(np.array_equal(routed[k], out[k])
                    for k in ("new_tbs", "retx", "drops"))
            and np.array_equal(routed["ok_cnt"], out["ok"])):
        fail("single-step route and main path differ at bench depth")
    busy, adv_profiled_ms = device_busy_share(static_run, "lte_sm_advance")
    print(json.dumps(dict(
        phase="bench", replicas=R, n_enb=E, n_ue=U, n_ttis=BENCH_TTIS,
        ttis_per_launch=BENCH_CHUNK or BENCH_TTIS,
        wall_s=wall, sim_s_per_wall_s=R * sim_s / wall,
        ttis_per_wall_s=R * BENCH_TTIS / wall,
        agg_dl_mbps=float(out["rx_bits"].sum()) / R / sim_s / 1e6,
        kernel_launches=launches,
        device_busy_share=busy if busy is not None else "not measured",
        profiled_ttis=BENCH_TTIS,
        profiled_advance_device_ms=(adv_profiled_ms
                                    if adv_profiled_ms is not None
                                    else "not measured"),
        equals_step_route=True,
    )), flush=True)

    # 5b. the mobile main path on the same drop
    def mobile_run(**kw):
        return run_lte_sm(mobile, key, replicas=R, device=dev,
                          chunk_ttis=BENCH_CHUNK, **kw)

    run_lte_sm(dataclasses.replace(mobile, n_ttis=50), key, replicas=R,
               device=dev, chunk_ttis=BENCH_CHUNK)          # warm-up
    mout, mwall, mlaunches = counted(
        kc, mobile_run,
        {"lte_sm_advance": n_launch, "lte_sm_advance:dynamic": n_launch},
        "mobile main path",
    )
    for k, v in mout.items():
        if not np.all(np.isfinite(v)):
            fail(f"mobile: non-finite {k}")
    refreshes = -(-BENCH_TTIS // MOBILE_STRIDE)
    if mout["geom_refreshes"] != refreshes or mout["rx_bits"].sum() <= 0:
        fail(f"mobile run: {mout['geom_refreshes']} refreshes (want "
             f"{refreshes}), {int(mout['rx_bits'].sum())} bits")
    if np.array_equal(mout["sinr"], out["sinr"]):
        fail("mobile run: the last refresh's SINR is the t = 0 drop's")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    geom_rows(mobile, mconsts, horizon.to(dev))
    torch.cuda.synchronize()
    table_s = time.monotonic() - t0
    table_busy, _ = device_busy_share(
        lambda: geom_rows(mobile, mconsts, horizon.to(dev)), "elementwise")
    mbusy, dyn_profiled_ms = device_busy_share(mobile_run, "lte_sm_advance")
    static_med, mobile_med = median_wall(static_run), median_wall(mobile_run)
    print(json.dumps(dict(
        phase="bench_mobile", replicas=R, n_enb=E, n_ue=U,
        n_ttis=BENCH_TTIS, mobility="const_velocity", speed_mps=MOBILE_SPEED,
        geom_stride=MOBILE_STRIDE, geom_refreshes=mout["geom_refreshes"],
        ttis_per_launch=BENCH_CHUNK or BENCH_TTIS, wall_s=mwall,
        sim_s_per_wall_s=R * sim_s / mwall,
        ttis_per_wall_s=R * BENCH_TTIS / mwall,
        agg_dl_mbps=float(mout["rx_bits"].sum()) / R / sim_s / 1e6,
        table_build_s=table_s,
        table_device_busy_share=(table_busy if table_busy is not None
                                 else "not measured"),
        kernel_launches=mlaunches,
        device_busy_share=mbusy if mbusy is not None else "not measured",
        profiled_advance_device_ms=(dyn_profiled_ms
                                    if dyn_profiled_ms is not None
                                    else "not measured"),
        wall_median_s=mobile_med, static_wall_median_s=static_med,
        wall_vs_static=mobile_med / static_med,
    )), flush=True)

    # 5c. the nine-scheduler sweep on the moving drop, one launch
    names = list(kc.SM_SCHED_IDS)
    swept, swall, slaunches = counted(
        kc, lambda: mobile_run(schedulers=names),
        {"lte_sm_advance": n_launch, "lte_sm_advance:dynamic": n_launch,
         "lte_sm_advance:sweep": n_launch},
        "nine-scheduler sweep",
    )
    for name, point in zip(names, swept):
        single = mout if name == mobile.scheduler else run_lte_sm(
            dataclasses.replace(mobile, scheduler=name), key, replicas=R,
            device=dev, chunk_ttis=BENCH_CHUNK,
        )
        if not same_outputs(point, single, INT_KEYS + ("geom_refreshes",)):
            fail(f"sweep point {name} differs from its single-point run")
    sbusy, _ = device_busy_share(lambda: mobile_run(schedulers=names),
                                 "lte_sm_advance")
    print(json.dumps(dict(
        phase="bench_sweep", points=names, replicas=R, n_enb=E, n_ue=U,
        n_ttis=BENCH_TTIS, geom_stride=MOBILE_STRIDE, wall_s=swall,
        sim_s_per_wall_s=len(names) * R * sim_s / swall,
        ttis_per_wall_s=len(names) * R * BENCH_TTIS / swall,
        kernel_launches=slaunches,
        device_busy_share=sbusy if sbusy is not None else "not measured",
        wall_vs_single_point=swall / mwall,
        equals_single_point=names,
    )), flush=True)

    # 5d. the traffic main path: the ON-OFF drop at bench depth, one
    #     offered table and one traffic-arm launch per chunk; then the
    #     same run one launch per TTI, which must end in the same state,
    #     counting the UE-TTIs the gate held back over the whole run
    n_tr = -(-BENCH_TTIS // min(BENCH_CHUNK or BENCH_TTIS, TRAFFIC_MAX_ROWS))

    def traffic_bench(p, what):
        """``(run, out, wall, launches, held, eligible UE-TTIs)`` of the
        counted main-path run of the traffic program ``p``."""
        def run(**kw):
            return run_lte_sm(p, key, replicas=R, device=dev,
                              chunk_ttis=BENCH_CHUNK, **kw)

        run_lte_sm(dataclasses.replace(p, n_ttis=50), key, replicas=R,
                   device=dev, chunk_ttis=BENCH_CHUNK)      # warm-up
        o, w, l_ = counted(
            kc, run, {"lte_sm_advance": n_tr, "lte_sm_advance:traffic": n_tr},
            what,
        )
        for k, v in o.items():
            if not np.all(np.isfinite(v)):
                fail(f"{what}: non-finite {k}")
        if (o["goodput_bits"].sum() <= 0
                or (o["goodput_bits"] > o["rx_bits"]).any()
                or (o["backlog_bits"] < 0).any()):
            fail(f"{what}: no goodput, goodput above delivery, or a "
                 f"negative backlog")
        census, held, elig_ttis = gate_census(kc, p, key, dev)
        if not (same_outputs(census, o, TRAFFIC_KEYS[:5] + ("goodput_bits",))
                and np.array_equal(census["backlog_bits"].view(np.int32),
                                   o["backlog_bits"].view(np.int32))):
            fail(f"{what}: one launch per TTI differs from the main path")
        if held <= 0:
            fail(f"{what}: the gate held back no UE-TTI")
        return run, o, w, l_, held, elig_ttis

    traffic_run, tout, twall, tlaunches, theld, telig = traffic_bench(
        tr_prog, "traffic main path")
    run_tr_key = fold_in(key.to(dev), TRAFFIC_KEY_TAG)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    offered(0, BENCH_TTIS, tr_prog, tr_ops, run_tr_key)
    torch.cuda.synchronize()
    tr_table_s = time.monotonic() - t0
    tr_table_busy, _ = device_busy_share(
        lambda: offered(0, BENCH_TTIS, tr_prog, tr_ops, run_tr_key),
        "elementwise")
    tbusy, trf_profiled_ms = device_busy_share(traffic_run, "lte_sm_advance")
    traffic_med, static_med = median_wall(traffic_run), median_wall(static_run)
    print(json.dumps(dict(
        phase="bench_traffic", replicas=R, n_enb=E, n_ue=U,
        n_ttis=BENCH_TTIS, traffic="onoff", peak_pps=ONOFF_PEAK_PPS,
        n_cycle=int(tr_prog.traffic.n_cycle),
        ttis_per_launch=min(BENCH_CHUNK or BENCH_TTIS, TRAFFIC_MAX_ROWS),
        wall_s=twall, sim_s_per_wall_s=R * sim_s / twall,
        ttis_per_wall_s=R * BENCH_TTIS / twall,
        agg_dl_mbps=float(tout["rx_bits"].sum()) / R / sim_s / 1e6,
        goodput_mbps=float(tout["goodput_bits"].sum()) / R / sim_s / 1e6,
        offered_mbps=float(tout["offered_bits"].sum()) / sim_s / 1e6,
        backlogs_left=int((tout["backlog_bits"] > 0).sum()),
        gate_held_ue_ttis=theld, eligible_ue_ttis=telig,
        gate_held_share=theld / telig, equals_one_launch_per_tti=True,
        table_build_s=tr_table_s,
        table_device_busy_share=(tr_table_busy if tr_table_busy is not None
                                 else "not measured"),
        kernel_launches=tlaunches,
        device_busy_share=tbusy if tbusy is not None else "not measured",
        profiled_advance_device_ms=(trf_profiled_ms
                                    if trf_profiled_ms is not None
                                    else "not measured"),
        wall_median_s=traffic_med, full_buffer_wall_median_s=static_med,
        wall_vs_full_buffer=traffic_med / static_med,
    )), flush=True)

    # 5d'. the same drop and ON-OFF shape at a peak near what the cells
    #      carry, so backlogs empty all run long and the gate keeps biting
    near = TrafficProgram.onoff(
        U, NEAR_CAPACITY_PPS, horizon_us=BENCH_TTIS * 1000, on=ONOFF_ON,
        off_mean_s=ONOFF_OFF_MEAN_S, tr_seed=ONOFF_TR_SEED,
    )
    near_prog = dataclasses.replace(tr_prog, traffic=dataclasses.replace(
        near, size_pareto=tr_prog.traffic.size_pareto))
    near_run, nout, nwall, nlaunches, nheld, nelig = traffic_bench(
        near_prog, "near-capacity traffic main path")
    near_med = median_wall(near_run)
    print(json.dumps(dict(
        phase="bench_traffic_near_capacity", replicas=R, n_enb=E, n_ue=U,
        n_ttis=BENCH_TTIS, traffic="onoff", peak_pps=NEAR_CAPACITY_PPS,
        wall_s=nwall, sim_s_per_wall_s=R * sim_s / nwall,
        ttis_per_wall_s=R * BENCH_TTIS / nwall,
        agg_dl_mbps=float(nout["rx_bits"].sum()) / R / sim_s / 1e6,
        goodput_mbps=float(nout["goodput_bits"].sum()) / R / sim_s / 1e6,
        offered_mbps=float(nout["offered_bits"].sum()) / sim_s / 1e6,
        backlogs_left=int((nout["backlog_bits"] > 0).sum()),
        gate_held_ue_ttis=nheld, eligible_ue_ttis=nelig,
        gate_held_share=nheld / nelig, equals_one_launch_per_tti=True,
        kernel_launches=nlaunches,
        wall_median_s=near_med, full_buffer_wall_median_s=static_med,
        wall_vs_full_buffer=near_med / static_med,
        wall_vs_saturated=near_med / traffic_med,
    )), flush=True)

    # 5e. the bf16 static path at bench depth
    b_bench = dataclasses.replace(b_prog, n_ttis=BENCH_TTIS)

    def bf16_run():
        return run_lte_sm(b_bench, key, replicas=R, device=dev,
                          chunk_ttis=BENCH_CHUNK)

    run_lte_sm(dataclasses.replace(b_prog, n_ttis=50), key, replicas=R,
               device=dev, chunk_ttis=BENCH_CHUNK)          # warm-up
    bout, bwall, blaunches = counted(
        kc, bf16_run, {"lte_sm_advance": n_launch,
                       "lte_sm_advance:bf16": n_launch},
        "bf16 static main path",
    )
    if bout["rx_bits"].sum() <= 0 or not np.all(np.isfinite(bout["sinr"])):
        fail("bf16 run delivered nothing")
    bbusy, _ = device_busy_share(bf16_run, "lte_sm_advance")
    print(json.dumps(dict(
        phase="bench_bf16", replicas=R, n_enb=E, n_ue=U, n_ttis=BENCH_TTIS,
        wall_s=bwall, sim_s_per_wall_s=R * sim_s / bwall,
        ttis_per_wall_s=R * BENCH_TTIS / bwall,
        agg_dl_mbps=float(bout["rx_bits"].sum()) / R / sim_s / 1e6,
        f32_agg_dl_mbps=float(out["rx_bits"].sum()) / R / sim_s / 1e6,
        cqi_differs_from_f32=int((bout["cqi"] != out["cqi"]).sum()),
        kernel_launches=blaunches,
        device_busy_share=bbusy if bbusy is not None else "not measured",
        wall_median_s=median_wall(bf16_run), f32_wall_median_s=static_med,
    )), flush=True)

    # 5f. the traffic sweep of all nine ids at bench depth, each point its
    #     single-point run
    tswept, tswall, tslaunches = counted(
        kc, lambda: traffic_run(schedulers=names),
        {"lte_sm_advance": n_tr, "lte_sm_advance:traffic": n_tr,
         "lte_sm_advance:sweep": n_tr},
        "nine-scheduler traffic sweep",
    )
    for name, point in zip(names, tswept):
        single = tout if name == tr_prog.scheduler else run_lte_sm(
            dataclasses.replace(tr_prog, scheduler=name), key, replicas=R,
            device=dev, chunk_ttis=BENCH_CHUNK,
        )
        if not same_outputs(point, single, TRAFFIC_KEYS):
            fail(f"traffic sweep point {name} differs from its single run")
    print(json.dumps(dict(
        phase="bench_traffic_sweep", points=names, replicas=R, n_enb=E,
        n_ue=U, n_ttis=BENCH_TTIS, wall_s=tswall,
        sim_s_per_wall_s=len(names) * R * sim_s / tswall,
        kernel_launches=tslaunches, wall_vs_single_point=tswall / twall,
        equals_single_point=names,
    )), flush=True)

    # 5g. bf16 on the moving drop, its nine-point sweep and the
    #     single-step route, at bench depth, each after a warm-up and
    #     beside its f32 twin's figure
    def bf16_mobile_run(**kw):
        return run_lte_sm(b_mobile, key, replicas=R, device=dev,
                          chunk_ttis=BENCH_CHUNK, **kw)

    run_lte_sm(dataclasses.replace(b_mobile, n_ttis=50), key, replicas=R,
               device=dev, chunk_ttis=BENCH_CHUNK)          # warm-up
    bmout, bmwall, bmlaunches = counted(
        kc, bf16_mobile_run,
        {"lte_sm_advance": n_launch, "lte_sm_advance:dynamic": n_launch,
         "lte_sm_advance:bf16": n_launch},
        "bf16 mobile path",
    )
    if bmout["rx_bits"].sum() <= 0 or bmout["geom_refreshes"] != refreshes:
        fail("bf16 mobile run delivered nothing or missed refreshes")
    bmswept, bmswall, bmslaunches = counted(
        kc, lambda: bf16_mobile_run(schedulers=names),
        {"lte_sm_advance": n_launch, "lte_sm_advance:dynamic": n_launch,
         "lte_sm_advance:sweep": n_launch, "lte_sm_advance:bf16": n_launch},
        "bf16 nine-scheduler mobile sweep",
    )
    if not same_outputs(bmswept[names.index(b_mobile.scheduler)], bmout,
                        INT_KEYS + ("geom_refreshes",)):
        fail("bf16 mobile sweep point differs from its single run")
    bmobile_med = median_wall(bf16_mobile_run)
    step_route(dataclasses.replace(b_prog, n_ttis=50), key, dev)  # warm-up
    brouted, bswall, bslaunches = counted(
        kc, lambda: step_route(b_bench, key, dev),
        {"lte_sm_step": BENCH_TTIS, "lte_sm_step:bf16": BENCH_TTIS},
        "bf16 single-step route",
    )
    brouted = {k: v.cpu().numpy() for k, v in brouted.items()}
    if not (np.array_equal((brouted["rx_hi"].astype(np.int64) << 20)
                           + brouted["rx_lo"], bout["rx_bits"])
            and all(np.array_equal(brouted[k], bout[k])
                    for k in ("new_tbs", "retx", "drops"))
            and np.array_equal(brouted["ok_cnt"], bout["ok"])):
        fail("bf16 single-step route and bf16 main path differ at bench "
             "depth")
    print(json.dumps(dict(
        phase="bench_bf16_more", replicas=R, n_enb=E, n_ue=U,
        n_ttis=BENCH_TTIS,
        mobile=dict(wall_s=bmwall, sim_s_per_wall_s=R * sim_s / bmwall,
                    kernel_launches=bmlaunches, wall_median_s=bmobile_med,
                    f32_wall_median_s=mobile_med,
                    wall_vs_f32=bmobile_med / mobile_med),
        mobile_sweep=dict(wall_s=bmswall,
                          sim_s_per_wall_s=len(names) * R * sim_s / bmswall,
                          kernel_launches=bmslaunches, f32_wall_s=swall,
                          wall_vs_f32=bmswall / swall),
        step_route=dict(wall_s=bswall, sim_s_per_wall_s=R * sim_s / bswall,
                        kernel_launches=bslaunches, f32_wall_s=step_wall,
                        wall_vs_f32=bswall / step_wall,
                        equals_main_path=True),
    )), flush=True)

    # 5h. bench_wifi: the BSS main path at bench width; 5-ht. bench_wifi_ht;
    #     then the four-point horizon sweep of each
    wlaunches = bss_bench(kc, dev, bss_numbers, "legacy")
    htlaunches = bss_bench(kc, dev, ht_numbers, "ht")
    swlaunches = {w: bss_sweep_bench(kc, dev, w) for w in ("legacy", "ht")}
    # 5m. bench_mobile_bss; 5t. the ON-OFF bench; 5w. the workload sweep
    mob_launches = bss_mobile_bench(kc, dev, arm_numbers["mobile"])
    trf_launches = bss_traffic_bench(kc, dev, arm_numbers["onoff"])
    wsw_launches = bss_workload_sweep_bench(kc, dev, arm_numbers["sweep"])
    # 5tcp. bench_tcp and bench_tcp_variant_sweep at bench width
    tcp_launches = tcp_bench(kc, dev, tcp_numbers["bench_tcp"], "bench_tcp")
    tcp_bench(kc, dev, tcp_numbers["variants17"], "variants17")
    # 5trf. the app-limited bench_tcp and the workload grid at bench width
    t_phase = time.monotonic()
    tcp_trf_launches = tcp_trf_bench(kc, dev, trf_numbers["trf"],
                                     trf_numbers["trf_sweep"])
    print(f"phase 5trf: {time.monotonic() - t_phase:.1f} s", flush=True)
    # 5win. the window's main paths at BASELINE row #3's shape
    t_phase = time.monotonic()
    win_launches = window_main(kc, dev)
    print(f"phase 5win: {time.monotonic() - t_phase:.1f} s", flush=True)
    # 5as. bench_as's numerator: the AS flow engine's main path
    t_phase = time.monotonic()
    as_launches = as_bench(kc, dev)
    print(f"phase 5as: {time.monotonic() - t_phase:.1f} s", flush=True)
    # 5wired. bench_wired; 5hyb. bench_hybrid (a) and (b)
    t_phase = time.monotonic()
    wired_launches = wired_bench(kc, dev)
    print(f"phase 5wired: {time.monotonic() - t_phase:.1f} s", flush=True)
    t_phase = time.monotonic()
    hybrid_launches = hybrid_bench(kc, dev)
    print(f"phase 5hyb: {time.monotonic() - t_phase:.1f} s", flush=True)
    # 5srv. the StudyServer at full width; 5rt. the runtime; 5ckpt.
    t_phase = time.monotonic()
    serving_phase(kc, dev)
    print(f"phase 5srv: {time.monotonic() - t_phase:.1f} s", flush=True)
    t_phase = time.monotonic()
    runtime_phase(kc, dev)
    print(f"phase 5rt: {time.monotonic() - t_phase:.1f} s", flush=True)
    t_phase = time.monotonic()
    checkpoint_phase(kc, dev)
    print(f"phase 5ckpt: {time.monotonic() - t_phase:.1f} s", flush=True)

    # 6. the kernels line, then the result line
    def entry(name, launches_, err, ms, plain_ms, bound,
              source=None, replaces="tpudes/parallel/kernels_pallas.py:473"):
        return dict(
            name=name, route="cuda",
            source=source or ("tpudes_torch/csrc/lte_sm_step.cu"
                              if name.startswith("lte_sm_step")
                              else "tpudes_torch/csrc/lte_sm_advance.cu"),
            replaces=replaces,
            launches=launches_, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=None,
        )

    print(f"wall: {time.monotonic() - STARTED:.1f} s from the script's "
          f"start, the build included", flush=True)
    print(json.dumps({"kernels": [
        entry("lte_sm_advance", launches["lte_sm_advance"], adv_err, ms_adv,
              ms_adv_plain, (adv_bound_ms, adv_bound_by)),
        entry("lte_sm_advance:dynamic",
              mlaunches["lte_sm_advance:dynamic"], dyn_err, ms_dyn,
              ms_dyn_plain, (dyn_bound_ms, dyn_bound_by)),
        entry("lte_sm_advance:sweep", slaunches["lte_sm_advance:sweep"],
              sweep_err, ms_sweep, ms_sweep_plain,
              (sweep_bound_ms, sweep_bound_by)),
        entry("lte_sm_advance:traffic", tlaunches["lte_sm_advance:traffic"],
              trf_err, ms_trf, ms_trf_plain, (trf_bound_ms, trf_bound_by)),
        entry("lte_sm_advance:bf16", blaunches["lte_sm_advance:bf16"],
              bf_err, ms_bf, ms_bf_plain, (bf_bound_ms, bf_bound_by)),
        entry("lte_sm_step", step_launches["lte_sm_step"], max_err,
              ms_kernel, ms_plain, (bound_ms, bound_by)),
        entry("lte_sm_step:bf16", bslaunches["lte_sm_step:bf16"],
              step_bf_err, ms_step_bf, ms_step_bf_plain, step_bf_bound),
        entry("bss_advance", wlaunches["bss_advance"], bss_numbers["err"],
              bss_numbers["ms"], bss_numbers["plain_ms"],
              bss_numbers["bound"], source=BSS_SOURCE, replaces=BSS_REPLACES),
        entry("bss_advance:agg", htlaunches["bss_advance:agg"],
              ht_numbers["err"], ht_numbers["ms"], ht_numbers["plain_ms"],
              ht_numbers["bound"], source=BSS_SOURCE,
              replaces=BSS_REPLACES + ", its A-MPDU branch :919-1021"),
        entry("bss_advance:sweep", swlaunches["ht"]["bss_advance:sweep"],
              sweep_numbers["ht"]["err"], sweep_numbers["ht"]["ms"],
              sweep_numbers["ht"]["plain_ms"], sweep_numbers["ht"]["bound"],
              source=BSS_SOURCE,
              replaces=BSS_REPLACES + ", vmapped over horizons :1403-1422"),
        entry("bss_advance:mobile", mob_launches["bss_advance:mobile"],
              arm_numbers["mobile"]["err"], arm_numbers["mobile"]["ms"],
              arm_numbers["mobile"]["plain_ms"],
              arm_numbers["mobile"]["bound"], source=BSS_SOURCE,
              replaces=BSS_REPLACES + ", its geometry stage :864-891"),
        entry("bss_advance:traffic", trf_launches["bss_advance:traffic"],
              arm_numbers["onoff"]["err"], arm_numbers["onoff"]["ms"],
              arm_numbers["onoff"]["plain_ms"],
              arm_numbers["onoff"]["bound"], source=BSS_SOURCE,
              replaces=BSS_REPLACES + ", its traffic stage :792-807"),
        entry("bss_advance:traffic_sweep",
              wsw_launches["bss_advance:traffic_sweep"],
              arm_numbers["sweep"]["err"], arm_numbers["sweep"]["ms"],
              arm_numbers["sweep"]["plain_ms"],
              arm_numbers["sweep"]["bound"], source=BSS_SOURCE,
              replaces=BSS_REPLACES + ", vmapped over workloads :1397-1459"),
        entry("tcp_advance", tcp_launches["tcp_advance"],
              tcp_numbers["bench_tcp"]["err"], tcp_numbers["bench_tcp"]["ms"],
              tcp_numbers["bench_tcp"]["plain_ms"],
              tcp_numbers["bench_tcp"]["bound"], source=TCP_SOURCE,
              replaces=TCP_REPLACES),
        entry("tcp_advance:trf", tcp_trf_launches["trf"]["tcp_advance:trf"],
              trf_numbers["trf"]["err"], trf_numbers["trf"]["ms"],
              trf_numbers["trf"]["plain_ms"], trf_numbers["trf"]["bound"],
              source=TCP_SOURCE,
              replaces=TCP_REPLACES + ", its app limit :955-973"),
        entry("tcp_advance:trf_sweep",
              tcp_trf_launches["trf_sweep"]["tcp_advance:trf_sweep"],
              trf_numbers["trf_sweep"]["err"], trf_numbers["trf_sweep"]["ms"],
              trf_numbers["trf_sweep"]["plain_ms"],
              trf_numbers["trf_sweep"]["bound"], source=TCP_SOURCE,
              replaces=TCP_REPLACES + ", vmapped over workloads :1224-1226"),
        entry("wifi_window", win_launches["nist"]["wifi_window"],
              win_numbers["nist"]["err"], win_numbers["nist"]["ms"],
              win_numbers["nist"]["plain_ms"], win_numbers["nist"]["bound"],
              source=WIN_SOURCE, replaces=WIN_REPLACES),
        entry("wifi_window:table", win_launches["table"]["wifi_window:table"],
              win_numbers["table"]["err"], win_numbers["table"]["ms"],
              win_numbers["table"]["plain_ms"], win_numbers["table"]["bound"],
              source=WIN_SOURCE,
              replaces=WIN_REPLACES + ", its table model "
              "tpudes/ops/wifi_error.py:289"),
        entry("wifi_window:geometry",
              win_launches["scan"]["wifi_window:geometry"],
              win_numbers["geometry"]["err"], win_numbers["geometry"]["ms"],
              win_numbers["geometry"]["plain_ms"],
              win_numbers["geometry"]["bound"], source=WIN_SOURCE,
              replaces="tpudes/parallel/kernels.py:73-80 and :96 "
              "(wifi_phy_window's distances, rx power and detectability, "
              "shared by multi_window_scan's windows; XLA, no pallas_call)"),
        entry("wifi_window:scan", win_launches["scan"]["wifi_window:scan"],
              win_numbers["scan"]["err"], win_numbers["scan"]["ms"],
              win_numbers["scan"]["plain_ms"], win_numbers["scan"]["bound"],
              source=WIN_SOURCE,
              replaces="tpudes/parallel/kernels.py:120 (multi_window_scan, "
              "a lax.scan over wifi_phy_window; XLA, no pallas_call)"),
        entry("as_spf", as_launches["bench"]["as_spf"], 0.0,
              as_numbers["spf_hops"]["ms"],
              as_numbers["spf_hops"]["plain_ms"],
              as_numbers["spf_hops"]["bound"], source=AS_SOURCE,
              replaces=AS_SPF_REPLACES),
        entry("as_fluid", as_launches["bench"]["as_fluid"], 0.0,
              as_numbers["fluid_bench"]["ms"],
              as_numbers["fluid_bench"]["plain_ms"],
              as_numbers["fluid_bench"]["bound"], source=AS_SOURCE,
              replaces=AS_FLUID_REPLACES),
        entry("as_fluid:sweep", as_launches["grid"]["as_fluid:sweep"], 0.0,
              as_numbers["fluid_sweep"]["ms"],
              as_numbers["fluid_sweep"]["plain_ms"],
              as_numbers["fluid_sweep"]["bound"], source=AS_SOURCE,
              replaces=AS_FLUID_REPLACES + ", vmapped over rate scales "
              ":536-540"),
        entry("wired_advance", wired_launches["wired_advance"], 0.0,
              wired_numbers["whole"]["ms"],
              wired_numbers["whole"]["plain_ms"],
              wired_numbers["whole"]["bound"], source=WIRED_SOURCE,
              replaces=WIRED_REPLACES),
        entry("wired_advance:owned",
              hybrid_launches["local"]["wired_advance:owned"], 0.0,
              wired_numbers["owned"]["ms"],
              wired_numbers["owned"]["plain_ms"],
              wired_numbers["owned"]["bound"], source=WIRED_SOURCE,
              replaces=WIRED_REPLACES + ", one rank's owned links and "
              "resident flows (tpudes/parallel/hybrid.py:149 HybridRank)"),
        entry("wired_advance:lanes",
              hybrid_launches["batched"]["wired_advance:lanes"], 0.0,
              wired_numbers["lanes"]["ms"],
              wired_numbers["lanes"]["plain_ms"],
              wired_numbers["lanes"]["bound"], source=WIRED_SOURCE,
              replaces=WIRED_LANES_REPLACES),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--compare-with":
        sys.exit(compare_main(sys.argv[2]))
    if len(sys.argv) > 1:
        fail("usage: python3 chip_smoke.py [--compare-with DIR]")
    sys.exit(main())
