"""Smoke run of tpudes_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the full-buffer LTE SM engine
(``tpudes_torch.parallel.lte_sm.run_lte_sm``) on the lena hex grid at
bench width (7 eNB x 30 UE/cell = 210 UE, 64 replicas, f32) — and holds
its CUDA kernels against their plain PyTorch versions: ``lte_sm_advance``
(many TTIs per launch, coins drawn inside; ``run_lte_sm``'s path) and
``lte_sm_step`` (one TTI per launch; the single-step route,
``build_sm_step``).  Phases, in order; any failure exits non-zero and no
phase carries on past one:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``tpudes_torch/csrc`` (``nvcc``, one process
   per source, all started together);
3. each kernel vs its plain version on the card at E=7, U=210, R=64 from
   random states made with numpy from a seed, for every scheduler id:
   all 14 state arrays bit-equal (``lte_sm_advance`` over two launches,
   the second from where the first ended); each one's time per launch on
   the card (CUDA events) and the host's, and its bound;
4. the slice through the plain loop and through the kernel, both on the
   card, 64 replicas x 500 TTIs: integer outputs equal; and a small
   program through the plain loop on the CPU against the kernel;
5. each route at bench depth, 64 replicas x 10,000 TTIs, its launch
   counts reset just before and read just after: the single-step route
   (``lte_sm_step`` once per TTI), then the main path (``run_lte_sm``,
   ``lte_sm_advance`` once per chunk, the whole horizon by default); both
   end in the same integers; then the card's busy share over a profiled
   main-path run (``torch.profiler``);
6. one JSON line with every kernel's numbers, then the result line.

Needs CUDA, ``nvcc`` (``$CUDA_HOME`` or ``/usr/local/cuda``) and the
repository beside this file; imports nothing of JAX or ``tpudes``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
E, UES_PER_CELL, R = 7, 30, 64
CHECK_TTIS = 500
BENCH_TTIS = 10_000
#: TTIs per launch on the main path (None: the whole horizon)
BENCH_CHUNK = None
#: lte_sm_advance's check: two launches from TTI ADVANCE_T0 on
ADVANCE_T0, ADVANCE_LAUNCHES = 1000, (60, 80)
#: TTIs per timed lte_sm_advance launch (the plain loop times the same)
TIMED_TTIS = 1000
#: calls per timed run: the plain core queues ~60 launches a call, so
#: fewer calls keep its run inside the CUDA launch queue
TIMED_KERNEL_CALLS, TIMED_PLAIN_CALLS = 200, 10
TIMED_ADVANCE_CALLS = 20
#: H100 SXM rates: HBM bytes/s and f32 operations/s outside the tensor
#: cores (NVIDIA's data sheet); int32 operations/s = 132 SMs x 64 INT32
#: lanes (Hopper architecture white paper) x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: lte_sm_advance's work per UE-TTI: the coin (threefry2x32's 72 integer
#: operations, 3 more to make the float) and the admission scan (5);
#: f32: the metric, TB bits, BLER (erfcf counted as 20), decode and EMA
INT_OPS_PER_UE_TTI, F32_OPS_PER_UE_TTI = 80, 45
#: and per replica-TTI: fold_in(key, t), one threefry2x32
INT_OPS_PER_REPLICA_TTI = 72
#: an upper bound on the SM clock (H100 boost 1.98 GHz), so a sleep of
#: ``s * SLEEP_CYCLES_PER_S`` cycles lasts at least ``s`` seconds
SLEEP_CYCLES_PER_S = 2.0e9


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def random_state(kc, consts, t, rng, device):
    """A warmed-looking state: every HARQ field populated."""
    import torch

    U, n_rbg = consts["U"], consts["n_rbg"]
    count_c = consts["count_c"].cpu().numpy()
    u_i = lambda lo, hi: rng.integers(lo, hi, (R, U)).astype(np.int32)  # noqa: E731
    host = dict(
        avg=rng.uniform(1.0, 1e7, (R, U)).astype(np.float32),
        pend=u_i(0, 2),
        p_mi=rng.uniform(0.0, 1.0, (R, U)).astype(np.float32),
        p_tbb=np.floor(rng.uniform(0.0, 2e4, (R, U))).astype(np.float32),
        p_nrbg=u_i(1, n_rbg + 1),
        p_txc=u_i(1, 4),
        p_due=u_i(t - 8, t + 9),
        rr_ptr=(rng.integers(0, 1 << 20, (R, E)) % np.maximum(count_c, 1))
        .astype(np.int32),
        rx_lo=u_i(0, 1 << 20),
        rx_hi=u_i(0, 4096),
        new_tbs=u_i(0, 5000),
        retx=u_i(0, 500),
        drops=u_i(0, 50),
        ok_cnt=u_i(0, 5000),
    )
    return {k: torch.from_numpy(host[k]).to(device) for k, _, _ in kc.SM_STATE}


def bits_of(x):
    import torch

    return x.view(torch.int32) if x.dtype == torch.float32 else x


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


def advance_bound(consts, s, keys, out, ttis):
    """Least time for one ``lte_sm_advance`` launch over ``ttis`` TTIs:
    the keys, constant rows and state read once and the state written
    once over HBM, against the integer and f32 work over each type's
    rate (the two pipes run side by side); the largest wins."""
    U = consts["U"]
    nbytes = keys.nbytes + sum(v.nbytes for v in s.values())
    nbytes += sum(v.nbytes for v in out.values())
    nbytes += sum(
        consts[k].nbytes for k in ("mi0", "rate0", "eff0", "ecr0",
                                   "eligible", "pos", "count_u", "serving",
                                   "count_c", "cell_order", "cell_start")
    )
    int_ops = R * ttis * (U * INT_OPS_PER_UE_TTI + INT_OPS_PER_REPLICA_TTI)
    times = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "operations": max(int_ops / INT32_OPS_PER_S,
                          R * ttis * U * F32_OPS_PER_UE_TTI / F32_OPS_PER_S)
        * 1e3,
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


def main(device: str = "cuda") -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from tpudes_torch import _build
    from tpudes_torch.parallel import kernels_cuda as kc
    from tpudes_torch.parallel.lte_sm import run_lte_sm
    from tpudes_torch.random import PRNGKey, replica_keys
    from tpudes_torch.scenarios import lena_grid_program, lena_ue_drop

    dev = torch.device(device)

    # 1. the card
    card = card_line()
    print(card, flush=True)

    # 2. build every kernel of the path, in parallel
    t0 = time.monotonic()
    logs = _build.build(["lte_sm_step", "lte_sm_advance"])
    print(f"build: {time.monotonic() - t0:.2f} s", flush=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(SEED)
    enb_pos, ue_pos = lena_ue_drop(E, UES_PER_CELL, generator=gen)
    prog = lena_grid_program(enb_pos, ue_pos, CHECK_TTIS)
    U = prog.n_ue
    consts = kc.build_sm_consts(prog, device=dev)

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
        for k, _, _ in kc.SM_STATE:
            if not torch.equal(bits_of(got[k]), bits_of(want[k])):
                fail(f"kernel != plain core: sid={sid} ({sched}) {k}")
            err = (got[k].double() - want[k].double()).abs().max().item()
            max_err = max(max_err, err)
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
    harq = dict(consts, mi0=(consts["mi0"] * torch.linspace(
        0.1, 1.0, U, device=dev)).contiguous())
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
        for k, _, _ in kc.SM_STATE:
            if not torch.equal(bits_of(got[k]), bits_of(want[k])):
                fail(f"lte_sm_advance != plain loop: sid={sid} ({sched}) {k}")
            err = (got[k].double() - want[k].double()).abs().max().item()
            adv_err = max(adv_err, err)
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

    # 4. the slice through the plain loop and the kernel, on the card;
    #    a small program through the plain loop on the CPU vs the kernel
    key = PRNGKey(SEED & 0x7FFFFFFF)
    plain = run_lte_sm(prog, key, replicas=R, device=dev, use_kernel=False)
    kern = run_lte_sm(prog, key, replicas=R, device=dev)
    int_keys = ("rx_bits", "new_tbs", "retx", "drops", "ok", "cqi", "mcs")
    for k in int_keys:
        if not np.array_equal(plain[k], kern[k]):
            fail(f"slice plain vs kernel differs in {k}")
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
    for k in int_keys:
        if not np.array_equal(on_cpu[k], on_gpu[k]):
            fail(f"small program: CPU plain loop vs kernel differs in {k}")
    print("small program (2 x 4 UE, 4 x 300 TTIs): CPU plain loop == "
          "kernel on the card", flush=True)

    # 5. each route at bench depth, counted: the single-step route, then
    #    the main path
    bench = dataclasses.replace(prog, n_ttis=BENCH_TTIS)
    sim_s = BENCH_TTIS * 1e-3
    step_route(dataclasses.replace(prog, n_ttis=50), key, dev)  # warm-up
    kc.reset_launches()
    t0 = time.monotonic()
    routed = step_route(bench, key, dev)
    torch.cuda.synchronize()
    step_wall = time.monotonic() - t0
    step_launches = dict(kc.launches)
    if step_launches != {"lte_sm_step": BENCH_TTIS, "lte_sm_advance": 0}:
        fail(f"single-step route launched {step_launches}, want "
             f"lte_sm_step {BENCH_TTIS} times and lte_sm_advance 0")
    print(json.dumps(dict(
        phase="bench_step_route", replicas=R, n_enb=E, n_ue=U,
        n_ttis=BENCH_TTIS, wall_s=step_wall,
        sim_s_per_wall_s=R * sim_s / step_wall,
        ttis_per_wall_s=R * BENCH_TTIS / step_wall,
        kernel_launches=step_launches,
    )), flush=True)

    run_lte_sm(dataclasses.replace(prog, n_ttis=50), key, replicas=R,
               device=dev, chunk_ttis=BENCH_CHUNK)          # warm-up
    kc.reset_launches()
    t0 = time.monotonic()
    out = run_lte_sm(bench, key, replicas=R, device=dev,
                     chunk_ttis=BENCH_CHUNK)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(kc.launches)
    want_launches = -(-BENCH_TTIS // (BENCH_CHUNK or BENCH_TTIS))
    if launches != {"lte_sm_step": 0, "lte_sm_advance": want_launches}:
        fail(f"main path launched {launches}, want lte_sm_advance "
             f"{want_launches} times and lte_sm_step 0")
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
    busy, adv_profiled_ms = device_busy_share(lambda: run_lte_sm(
        bench, key, replicas=R, device=dev, chunk_ttis=BENCH_CHUNK,
    ), "lte_sm_advance")
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

    # 6. the kernels line, then the result line
    print(json.dumps({"kernels": [dict(
        name="lte_sm_advance", route="cuda",
        source="tpudes_torch/csrc/lte_sm_advance.cu",
        replaces="tpudes/parallel/kernels_pallas.py:473",
        launches=launches["lte_sm_advance"], max_abs_err=adv_err,
        ms=ms_adv, plain_ms=ms_adv_plain, bound_ms=adv_bound_ms,
        bound_by=adv_bound_by, library_ms=None,
    ), dict(
        name="lte_sm_step", route="cuda",
        source="tpudes_torch/csrc/lte_sm_step.cu",
        replaces="tpudes/parallel/kernels_pallas.py:473",
        launches=step_launches["lte_sm_step"], max_abs_err=max_err,
        ms=ms_kernel, plain_ms=ms_plain, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None,
    )]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
