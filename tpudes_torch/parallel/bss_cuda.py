"""The BSS event loop as one persistent CUDA kernel: the wrapper.

``csrc/bss_advance.cu`` (the kernel in ``csrc/bss_advance.cuh``) replaces
the reference's device event loop
(``tpudes/parallel/replicated.py:1155``, a ``lax.while_loop`` over
``build_bss_step.step_fn``; XLA code, no ``pallas_call``): one launch
runs every step of a chunk for every replica, one warp per (point,
replica) row and :data:`BSS_ROWS_PER_BLOCK` rows a block, node ``i`` on
lane ``i % 32``, slot ``i // 32`` (its state in registers up to
:data:`BSS_REG_SLOTS` slots), warp-synchronous steps with ``redux.sync``
reductions, the draws made inside; an A-MPDU program runs its ``AGG``
arm, a mobile one its ``MOB`` arm (the geometry rebuilt in the kernel
every stride steps), a traffic one its ``TRF`` arm (each arrival's next
gap drawn in the kernel), and a sweep's points are rows of the same
launch, each with its own horizon or, in a workload sweep, its own
traffic operands (:func:`launch_geometry`).  Each row stops when its own
replica has no event left before its horizon (or at the step bound);
:func:`join_stops` then gives the replicas that stopped before the last
one of their point the one move of ``t`` the reference's loop makes in
their place, so the state equals the plain loop's
(:func:`tpudes_torch.parallel.replicated.bss_advance_math`) bit for bit;
for a mobile program it also gives them the geometry refresh the
reference's loop makes in their place (``geom_t``), and with the obs
columns the ring rows of those steps (:func:`idle_ring_rows`).

A state with the obs keys (``obs=True``) runs the kernel's ``OBS`` arm
(``csrc/bss_advance_obs_s*.cu``, counted also under ``bss_advance:obs``):
each node's FlowMonitor columns in its lane's slot arrays, its delay
histogram in global memory (a delivery adds to one bin), the replica's
failed exchanges, and lane 0's ring row a step.

State layout (:data:`BSS_STATE`): a grid of C horizons, per node
``(C, R, N)``, per replica ``(C, R)``; a single run is C = 1.
``immediate`` is bool, the rest int32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpudes_torch.obs.flowmon import bin_scale
from tpudes_torch.ops.wifi_error import (
    ALL_MODES,
    ampdu_params,
    ber_constants,
    pe_constants,
)
from tpudes_torch.parallel.kernels_cuda import _check, _launch

#: state layout: (key, axis, dtype) with axis "n" = (C, R, N), "r" =
#: (C, R), in the reference's init_state order (``replicated.py:689-707``),
#: then ``geom_t``: the event time a mobile program's geometry was last
#: rebuilt at (the reference carries the ``(R, N, N)`` tables themselves;
#: they are a function of this time), 0 and never read for a static one
BSS_STATE = (
    ("t", "r", "i32"), ("next_arr", "n", "i32"), ("queue", "n", "i32"),
    ("ap_pend", "n", "i32"), ("bcn_pend", "r", "i32"),
    ("backoff", "n", "i32"), ("hold", "n", "i32"),
    ("immediate", "n", "bool"), ("cw", "n", "i32"),
    ("retries", "n", "i32"), ("busy_until", "r", "i32"),
    ("srv_rx", "r", "i32"), ("cli_rx", "n", "i32"),
    ("tx_data", "r", "i32"), ("drops", "r", "i32"),
    ("geom_t", "r", "i32"),
)
_DTYPES = {"i32": torch.int32, "bool": torch.bool}

#: nodes one row holds (BSS_MAX_N in csrc/bss_advance.cuh): 32 slots of a
#: warp's 32 lanes
BSS_MAX_N = 1024
#: the last step a launch may reach (BSS_MAX_STEP): step + 31, a warp's
#: key lookahead, stays below 2^31
BSS_MAX_STEP = 2147483000
#: horizons one launch holds (BSS_MAX_POINTS: its points, each horizon and
#: first step passed by value in the kernel's parameters)
BSS_MAX_POINTS = 64
#: an A-MPDU's subframe cap the kernel holds: two coins per lane of a warp
BSS_MAX_MPDUS = 64
#: rows (warps, one per (point, replica)) a block (BSS_ROWS_PER_BLOCK)
BSS_ROWS_PER_BLOCK = 4
#: slots a lane holds in registers (BSS_REG_SLOTS): a template
#: instantiation each for N <= 128; past it one instantiation holds the
#: slots in local memory
BSS_REG_SLOTS = 4
#: shared memory a block takes without the opt-in, and the most it may
#: opt in to (H100: 227 KB)
SHARED_DEFAULT_MAX = 48 * 1024
SHARED_OPTIN_MAX = 232_448
#: the probe's stages (BSS_PROF_STAGES), in a step's order, and the slot
#: count it is built for (BSS_PROF_SLOTS: the bench's N = 65)
BSS_PROF_STAGES = ("reduce", "refresh", "draws_winners", "arrivals", "phy",
                   "outcome")
BSS_PROF_SLOTS = 3


def launch_geometry(n: int, points: int, replicas: int,
                    mobile: bool) -> dict:
    """The launch's shape for ``n`` nodes and ``points`` x ``replicas``
    rows, as ``bss_advance_launch`` checks it: ``slots`` a lane holds
    (ceil(n / 32)) and the instantiation that holds them
    (``template_slots``: the count itself up to :data:`BSS_REG_SLOTS`, 0
    past it), ``rows`` (point-major, row ``p R + r``), ``blocks`` of
    ``threads`` (:data:`BSS_ROWS_PER_BLOCK` warps, the last block ragged),
    each row's slice of dynamic shared memory (``row_bytes``: per node
    two floats, under MOB five, and a byte, rounded up to 16), the
    block's ``shared`` bytes and whether they need the opt-in past 48
    KB."""
    slots = -(-n // 32)
    rows = points * replicas
    row_bytes = -(-((5 if mobile else 2) * 4 * n + n) // 16) * 16
    shared = BSS_ROWS_PER_BLOCK * row_bytes
    return dict(
        slots=slots,
        template_slots=slots if slots <= BSS_REG_SLOTS else 0,
        rows=rows, blocks=-(-rows // BSS_ROWS_PER_BLOCK),
        threads=32 * BSS_ROWS_PER_BLOCK, row_bytes=row_bytes,
        shared=shared, optin=shared > SHARED_DEFAULT_MAX,
    )


def node_lane_slot(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Each node's ``(lane, slot)`` in its row's warp: node ``i`` on lane
    ``i % 32``, slot ``i // 32`` (the ballot word and bit of its win)."""
    i = np.arange(n)
    return i % 32, i // 32


def row_point_replica(block: int, warp: int, replicas: int):
    """The ``(point, replica)`` of the row that warp ``warp`` of block
    ``block`` runs (None past the last row is the caller's check)."""
    row = block * BSS_ROWS_PER_BLOCK + warp
    return divmod(row, replicas)


def psr_params(mode_index: int) -> list:
    """The error model's per-mode constants as the kernel takes them:
    the BER's scale and factor, the union bound's ten weights' logs and
    distances (a zero weight's term skipped: its distance passed as 0
    and its mask bit clear), the rate's factor and the term mask."""
    mode = ALL_MODES[int(mode_index)]
    scale, factor = ber_constants(mode.constellation)
    coeffs, log_c, exps, b = pe_constants(mode.rate_class)
    mask = sum(1 << k for k, a in enumerate(coeffs) if a > 0.0)
    return [scale, factor, *log_c, *exps, b, mask]


class MobArgs(ctypes.Structure):
    """``Mob`` of csrc/bss_advance.cuh: the position math's operands and
    the link physics (:func:`mob_args`)."""
    _fields_ = [
        ("model", ctypes.c_int), ("stride", ctypes.c_int),
        *[(k, ctypes.c_void_p) for k in ("base", "vel", "speed", "bounds",
                                         "wp_t", "wp_p", "walk")],
        ("W", ctypes.c_int), ("n_seg", ctypes.c_int),
        *[(k, ctypes.c_float) for k in ("seg_us", "tx", "tx30", "k_loss",
                                        "ref_loss", "sens")],
    ]


class TrafficArgs(ctypes.Structure):
    """``Traffic`` of csrc/bss_advance.cuh: the stacked operand tables
    (:func:`traffic_args`)."""
    _fields_ = [
        *[(k, ctypes.c_void_p) for k in ("id", "start", "interval", "rate",
                                         "epoch_rate", "on_start", "on_len",
                                         "peak", "arr_t")],
        *[(k, ctypes.c_int) for k in ("S", "C", "K", "epoch_us", "multi")],
    ]


#: the mobility operands the kernel reads, their dtype and shape past N
_MOB_OPS = (("mob_base", torch.float32, (3,)), ("mob_vel", torch.float32, (3,)),
            ("mob_speed", torch.float32, (2,)))


def mob_args(mob: dict, n: int, dev) -> MobArgs:
    """The ``MOB`` arm's arguments from ``consts["mob"]``
    (:func:`tpudes_torch.parallel.replicated.build_bss_consts`), its
    tensors checked for the launch."""
    from tpudes_torch.ops.mobility import MOB_MODEL_IDS
    from tpudes_torch.ops.propagation import _folded

    ops = mob["ops"]
    for k, dt, tail in _MOB_OPS:
        _check(k, ops[k], (n, *tail), dt, dev)
    W = ops["mob_wp_t"].shape[1]
    S = ops["mob_walk_vels"].shape[0]
    _check("mob_bounds", ops["mob_bounds"], (4,), torch.float32, dev)
    _check("mob_wp_t", ops["mob_wp_t"], (n, W), torch.int32, dev)
    _check("mob_wp_p", ops["mob_wp_p"], (n, W, 3), torch.float32, dev)
    _check("mob_walk_vels", ops["mob_walk_vels"], (S, n, 2), torch.float32,
           dev)
    tx = float(np.float32(mob["tx_dbm"]))
    return MobArgs(
        MOB_MODEL_IDS[mob["model"]], int(mob["stride"]),
        *[ops[k].data_ptr() for k in ("mob_base", "mob_vel", "mob_speed",
                                      "mob_bounds", "mob_wp_t", "mob_wp_p",
                                      "mob_walk_vels")],
        W, S, float(mob["seg_us"]), tx,
        float(np.float32(tx) - np.float32(30.0)),
        _folded(10.0 * mob["exponent"]), float(np.float32(mob["ref_loss"])),
        float(np.float32(mob["sens"])),
    )


#: the traffic operands the kernel reads, their dtype and shape past the
#: point axis (N entities; S epochs, C cycles, K trace entries)
_TR_OPS = (("tr_id", torch.int32, "n"), ("tr_start", torch.int32, "n"),
           ("tr_interval", torch.int32, "n"), ("tr_rate", torch.float32, "n"),
           ("tr_epoch_rate", torch.float32, "s"),
           ("tr_on_start", torch.int32, "nc"),
           ("tr_on_len", torch.int32, "nc"), ("tr_peak", torch.float32, "nc"),
           ("tr_arr_t", torch.int32, "nk"))


def traffic_args(tr: dict, n: int, points: int, dev) -> TrafficArgs:
    """The ``TRF`` arm's arguments from ``consts["tr"]``: ``P`` operand
    sets, one per point (``P = points``, a workload sweep) or one shared
    (``P = 1``)."""
    ops = tr["ops"]
    P = ops["tr_id"].shape[0]
    if P not in (1, points):
        raise ValueError(
            f"bss_advance takes 1 traffic operand set or one per point; "
            f"got {P} sets for {points} points")
    S = ops["tr_epoch_rate"].shape[1]
    C = ops["tr_on_start"].shape[2]
    K = ops["tr_arr_t"].shape[2]
    dims = {"n": (n,), "s": (S,), "nc": (n, C), "nk": (n, K)}
    for k, dt, ax in _TR_OPS:
        _check(k, ops[k], (P, *dims[ax]), dt, dev)
    return TrafficArgs(*[ops[k].data_ptr() for k, _, _ in _TR_OPS],
                       S, C, K, int(tr["epoch_us"]), int(P > 1))


def _launch_args(consts: dict, state: dict, key: torch.Tensor, step0,
                 step1: int, sim_end, prof) -> tuple:
    """Check a launch's operands and allocate its outputs: ``(args,
    (out, done, t_next, still), arms)``, ``args`` the C launcher's
    arguments (``prof`` the probe's output, or None).  A state with the
    obs keys (``replicated.obs_keys``) runs the ``OBS`` arm on copies of
    them, which ``out`` returns."""
    ends = [int(v) for v in (sim_end if sim_end is not None
                             else [consts["sim_end"]])]
    starts = [int(v) for v in step0]
    C = len(ends)
    if not 1 <= C <= BSS_MAX_POINTS or len(starts) != C:
        raise ValueError(
            f"bss_advance runs 1..{BSS_MAX_POINTS} points, a horizon and a "
            f"counter each; got {len(ends)} horizons, {len(starts)} counters"
        )
    if not all(0 <= v <= step1 <= BSS_MAX_STEP for v in starts):
        raise ValueError(
            f"bss_advance runs 0 <= step0 <= step1 <= {BSS_MAX_STEP}; got "
            f"step0={step0}, step1={step1}"
        )
    dev = key.device
    n, K = consts["N"], consts["K"]
    R = state["queue"].shape[1]
    if not 1 <= n <= BSS_MAX_N:
        raise ValueError(f"bss_advance holds 1..{BSS_MAX_N} nodes; got {n}")
    if not 1 <= K <= BSS_MAX_MPDUS:
        raise ValueError(
            f"bss_advance holds A-MPDUs of 1..{BSS_MAX_MPDUS}; got {K}")
    if C * R * n >= 2**31:
        raise ValueError(
            f"bss_advance indexes state in int32; C*R*N={C * R * n}")
    _check("key", key, (2,), torch.int64, dev)
    _check("rx_w", consts["rx_w"], (n, n), torch.float32, dev)
    _check("det", consts["det"], (n, n), torch.bool, dev)
    for k in ("interval", "stop"):
        _check(k, consts[k], (n,), torch.int32, dev)
    out = {}
    for k, ax, dt in BSS_STATE:
        shape = (C, R, n) if ax == "n" else (C, R)
        _check(k, state[k], shape, _DTYPES[dt], dev)
        out[k] = torch.empty(shape, dtype=_DTYPES[dt], device=dev)
    done = torch.empty((C, R), dtype=torch.int32, device=dev)
    t_next = torch.empty((C, R), dtype=torch.int32, device=dev)
    still = torch.empty((C, R), dtype=torch.bool, device=dev)
    psr = psr_params(consts["mode"])
    sub8, inv_ndbps, rate, preamble = ampdu_params(consts["subframe_bytes"],
                                                   consts["mode"])
    mob = tr = None
    if consts["mob"] is not None:
        mob = mob_args(consts["mob"], n, dev)
    if consts["tr"] is not None:
        tr = traffic_args(consts["tr"], n, C, dev)
    multi = tr is not None and tr.multi
    from tpudes_torch.parallel.replicated import obs_bin_width

    geo = launch_geometry(n, C, R, mob is not None)
    obs = _obs_io(state, C, R, n, dev)
    if obs and prof is not None:
        raise ValueError("the bss_advance probe runs without the obs columns")
    out.update(obs)
    args = (
        consts["rx_w"].data_ptr(), consts["det"].data_ptr(),
        consts["interval"].data_ptr(), consts["stop"].data_ptr(),
        key.data_ptr(),
        *[state[k].data_ptr() for k, _, _ in BSS_STATE],
        *[out[k].data_ptr() for k, _, _ in BSS_STATE],
        done.data_ptr(), t_next.data_ptr(), still.data_ptr(),
        R, n, consts["aifs"], consts["data_dur"], consts["resp_dur"],
        consts["exch_beacon"], (ctypes.c_int * C)(*ends),
        (ctypes.c_int * C)(*starts), C, int(step1),
        ctypes.c_float(consts["nbits"]), ctypes.c_float(consts["noise_w"]),
        *[ctypes.c_float(v) for v in psr[:-1]], psr[-1],
        K, preamble, ctypes.c_float(sub8), ctypes.c_float(inv_ndbps),
        ctypes.c_float(rate),
        None if mob is None else ctypes.byref(mob),
        None if tr is None else ctypes.byref(tr),
        geo["slots"], geo["blocks"], geo["shared"],
        None if prof is None else prof.data_ptr(),
        (ctypes.c_void_p * len(obs))(*[v.data_ptr() for v in obs.values()])
        if obs else None,
        consts["pkt_bytes"],
        ctypes.c_float(bin_scale(obs_bin_width(consts)) if obs else 1.0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    arms = (("agg",) * (K > 1) + ("sweep",) * (C > 1 and not multi)
            + ("mobile",) * (mob is not None)
            + ("traffic",) * (tr is not None) + ("traffic_sweep",) * multi
            + ("obs",) * bool(obs))
    return args, (out, done, t_next, still), arms


def _obs_io(state: dict, C: int, R: int, n: int, dev) -> dict:
    """Check the obs state and return contiguous copies for the ``OBS``
    arm to update in place (empty without the obs keys)."""
    from tpudes_torch.obs.flowmon import FLOW_DELAY_BINS, FLOW_RING_CAP
    from tpudes_torch.parallel.replicated import obs_keys

    out = {}
    for k in obs_keys(state):
        shape = ((C, R) if k == "retx"
                 else (C, R, n, FLOW_DELAY_BINS) if k == "fm_hist"
                 else (C, R, FLOW_RING_CAP, 5) if k == "fm_ring"
                 else (C, R, n))
        dt = torch.float32 if k in ("fm_dsum", "fm_jsum", "fm_dlast",
                                    "fm_t0", "fm_t1") else torch.int32
        _check(k, state[k], shape, dt, dev)
        out[k] = state[k].clone()
    return out


def bss_launch(consts: dict, state: dict, key: torch.Tensor, step0,
               step1: int, sim_end=None):
    """Launch ``bss_advance`` once for steps ``[step0, step1)`` of a grid
    of C horizons: a warp per replica and point runs its steps until its
    replica is no longer pending or the bound.  ``state`` is ``(C, R,
    ...)``, ``step0`` a list of C counters, ``sim_end`` a list of C
    horizons (None: the program's, C = 1).  Returns ``(state, done,
    t_next, pending)``, all on the card and nothing copied back: each
    replica's state where its row stopped, the ``(C, R)`` step it
    stopped at, the ``t`` one more step would give it, and whether it is
    still pending.  Raises on a bad argument or a launch error."""
    args, outs, arms = _launch_args(consts, state, key, step0, step1,
                                    sim_end, None)
    _launch("bss_advance", *args, argtypes=LAUNCH_ARGTYPES, arms=arms)
    return outs


def bss_profile(consts: dict, state: dict, key: torch.Tensor, step0,
                step1: int, sim_end=None):
    """The probe: the launch :func:`bss_launch` makes, run by the kernel's
    profiling instantiation (lane 0 of each row reads ``clock64()`` at
    the stage edges), for N in 65..96 (:data:`BSS_PROF_SLOTS`) and one
    arm at a time.  Returns ``(outs, cycles)``: :func:`bss_launch`'s
    outputs and the ``(C R, len(BSS_PROF_STAGES))`` int64 cycles each
    row spent in each stage, summed over its steps.  Not the main path:
    not counted in ``kernels_cuda.launches``."""
    from tpudes_torch.parallel.kernels_cuda import _launcher

    C = len(step0)
    R = state["queue"].shape[1]
    prof = torch.zeros((C * R, len(BSS_PROF_STAGES)), dtype=torch.int64,
                       device=key.device)
    from tpudes_torch.obs.device import KernelProfile, timed_launch

    args, outs, _ = _launch_args(consts, state, key, step0, step1, sim_end,
                                 prof)
    with timed_launch(key.device) as wall:
        err = _launcher("bss_advance", LAUNCH_ARGTYPES)(*args)
    if err != 0:
        raise RuntimeError(f"bss_advance probe failed: CUDA error {err}")
    KernelProfile.record_cycles(
        "bss_advance", dict(zip(BSS_PROF_STAGES, prof.sum(0).tolist())),
        C * R, wall[0])
    return outs, prof


def idle_ring_rows(ring: torch.Tensor, done: torch.Tensor,
                   last: torch.Tensor, first: torch.Tensor,
                   end: torch.Tensor, pkt: int) -> torch.Tensor:
    """``ring`` (``(C, R, 512, 5)``) with each row's idle steps ``[done,
    last)`` written as the reference's shared loop writes them: step -1,
    at the event ``first`` (``(C, R)``) in step ``done`` and at the
    horizon ``end`` (``(C, 1)``) after it, flow 0, ``pkt`` bytes, a send.
    Ring slot ``j`` holds the last such step ``s = last - 1 - (last - 1 -
    j) mod 512`` where ``s >= done``."""
    cap = ring.shape[-2]
    j = torch.arange(cap, device=ring.device)
    lm = (last - 1)[:, None, None]                        # (C, 1, 1)
    s = lm - torch.remainder(lm - j, cap)                 # (C, 1, cap)
    d = done[:, :, None]                                  # (C, R, 1)
    write = s >= d                                        # (C, R, cap)
    col1 = torch.where(s == d, first[:, :, None], end[:, :, None])
    row = torch.stack(torch.broadcast_tensors(
        torch.full_like(col1, -1), col1, torch.zeros_like(col1),
        torch.full_like(col1, pkt), torch.zeros_like(col1)), -1)
    return torch.where(write[..., None], row.to(ring.dtype), ring)


def join_stops(state: dict, done: torch.Tensor, t_next: torch.Tensor,
               stride: int | None = None, sim_end=None, pkt: int = 0):
    """``(state, steps)`` of the loop from the replicas' own ``(C, R)``
    stops, each point joined on its own (its own loop): the loop ran to
    the point's last stop, and a replica that stopped before it took the
    steps between, in the first of which ``t`` moves to its next event
    (at or past the horizon), and in which nothing else changes
    (``replicated.py:776-777``) but, for a mobile program (``stride``
    given, with the C horizons ``sim_end``), the geometry: the last of
    those steps that is a multiple of ``stride`` rebuilds it, at that
    next event if it is the first step, else at the horizon, and sets
    ``geom_t`` to it.  With the obs columns (``pkt`` a packet's bytes),
    each of those steps writes its idle ring row (:func:`idle_ring_rows`,
    ``replicated.py:1060-1070``).  ``steps``, a list of C counts, is
    copied to the host."""
    last = done.amax(1)
    late = done < last[:, None]
    out = dict(state, t=torch.where(late, t_next, state["t"]))
    if stride is not None or "fm_ring" in state:
        end = torch.tensor(sim_end, dtype=torch.int32,
                           device=done.device)[:, None]
        first = torch.where(state["t"] < end, t_next, end)
    if "fm_ring" in state:
        out["fm_ring"] = idle_ring_rows(state["fm_ring"], done, last, first,
                                        end, pkt)
    if stride is not None:
        m = torch.div(last - 1, stride, rounding_mode="floor") * stride
        m = m[:, None].expand_as(done)
        out["geom_t"] = torch.where(
            late & (m >= done), torch.where(m == done, first, end),
            state["geom_t"])
    return out, last.tolist()


def bss_advance_cuda(consts: dict, state: dict, key: torch.Tensor,
                     step0, step1: int, sim_end=None):
    """Steps ``[step0, step1)`` in one launch (:func:`bss_launch`), joined
    into the loop's state (:func:`join_stops`).  Returns ``(state, steps,
    pending)`` as the plain loop does.  Never takes the plain loop."""
    out, done, t_next, still = bss_launch(consts, state, key, step0, step1,
                                          sim_end)
    mob = consts["mob"]
    ends = [int(v) for v in (sim_end if sim_end is not None
                             else [consts["sim_end"]])]
    out, steps = join_stops(out, done, t_next,
                            None if mob is None else mob["stride"], ends,
                            consts["pkt_bytes"])
    return out, steps, still


#: ctypes signature of ``bss_advance_launch`` (csrc/bss_advance.cu):
#: rx_w, det, interval, stop, key, state in, state out, done, t_next,
#: pending, six ints (R, N, aifs, data_dur, resp_dur, exch_beacon), the
#: C horizons and C first steps (host arrays), C, step1, nbits, noise_w,
#: the 23 floats of psr_params and its int term mask, the A-MPDU cap K
#: and the data preamble, the three floats of ampdu_params, the MOB and
#: TRF arms' arguments (host structs, or null), the geometry's slots,
#: blocks and shared bytes (:func:`launch_geometry`), the probe's output
#: (or null), the OBS arm's pointers (host array, or null), its packet
#: bytes and bin factor, stream
LAUNCH_ARGTYPES = (
    [ctypes.c_void_p] * (5 + 2 * len(BSS_STATE) + 3)
    + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 2
    + [ctypes.c_int] * 2 + [ctypes.c_float] * (2 + 23) + [ctypes.c_int]
    + [ctypes.c_int] * 2 + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
    + [ctypes.c_float] + [ctypes.c_void_p]
)
