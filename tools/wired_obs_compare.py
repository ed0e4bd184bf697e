"""The wired engine's first ``OBS`` design against this checkout's, in one
call on one card.

The first design was a simple kernel of its own (``wired_advance_obs.cu``:
a warp a row, three passes over the row's packets a visit, each row on
its own clock) with its own C interface; this checkout's is the ``OBS``
instantiation of ``wired_advance.cu``'s kernel and the union pass.  Run
from the root of the repository, on a machine with a card and ``nvcc``::

    python3 tools/wired_obs_compare.py DIR

``DIR`` holds the earlier checkout's ``wired_advance_obs.cu`` and the
``wired_advance.cu`` it was built beside, e.g. ``git archive <commit>
tpudes_torch/csrc`` unpacked into a git-ignored directory.  Both are
built beside this checkout's ``wired_advance`` library (nvcc in
parallel).  On bench_wired's program at ``chip_smoke.WIRED_R`` rows over
``chip_smoke.OBS_WIRED_SLOTS`` slots: the state and the columns that do
not depend on the clock equal between the two (the first design steps
each row on its own clock, so ``fm_t0``, the ring and ``n_steps`` differ
with more than one replica), this checkout's equal to ``advance_math`` in
everything; each one's device time for the same launch in turns (old,
new, new, old; the new one through its wrapper, the arm and the union
pass); both stage probes (the old one's where its library exports
``wired_advance_obs_profile``); the obs-off ``wired_advance``
instantiations' SASS (``cuobjdump``) against ``DIR/wired_advance.cu``'s.
Prints the ``wired_obs_old_vs_new`` JSON line, the card's name and power
limit, and ``chip_smoke.py``'s last line.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

#: the first design's C interface: the host array of its 29 device
#: pointers (the tables lo_at, pkt_flow, svc, svcdly, f_first, f_period,
#: f_npk; the state; next and steps out; then OLD_OBS_COLS), nine ints (R,
#: P, F, H, Lo, t, t_grant, the carried mark, a packet's bytes), the bin
#: factor, stage, stream; its probe takes its words before the stream
OLD_OBS_COLS = ("fm_birth", "fm_tx", "fm_txb", "fm_rx", "fm_rxb", "fm_lost",
                "fm_dsum", "fm_jsum", "fm_dlast", "fm_t0", "fm_t1",
                "fm_hist", "fm_ring")
OLD_OBS_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 9
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
#: the columns that do not depend on the clock
CLOCK_FREE_COLS = ("fm_tx", "fm_txb", "fm_rx", "fm_rxb", "fm_lost",
                   "fm_dsum", "fm_jsum", "fm_dlast", "fm_t1", "fm_hist")


def old_wired_obs(lib, tab: dict, carry: dict, t_grant: int, prof=None):
    """One launch of the first design's kernel on ``carry``, in place, as
    ``wired_cuda.wired_obs_cuda`` returns it: ``(carry, metrics)``
    (``n_steps`` the most visits of a row); ``prof`` (an ``(R, 12)``
    int64 tensor) runs its probe instead."""
    import torch
    from tpudes_torch.obs.flowmon import bin_scale, flip_ring
    from tpudes_torch.parallel.wired import WIRED_PKT_BYTES, WIRED_STATE

    dev = carry["hop"].device
    K, F, H = tab["paths"].shape
    P = tab["pkt_flow"].shape[1]
    Lo = tab["svc"].shape[1]
    R = carry["hop"].shape[0]
    t0 = int(carry["t"])
    out = torch.empty((2 * R,), dtype=torch.int32, device=dev)
    ptrs = [*(tab[k].data_ptr() for k in ("lo_at", "pkt_flow", "svc",
                                          "svcdly", "f_first", "f_period",
                                          "f_npk")),
            *(carry[k].data_ptr() for k, _ in WIRED_STATE),
            out[:R].data_ptr(), out[R:].data_ptr(),
            *(carry[k].data_ptr() for k in OLD_OBS_COLS)]
    args = [(ctypes.c_void_p * len(ptrs))(*ptrs), R, P, F, H, Lo, t0,
            int(t_grant), int(carry["fm_mark"]), WIRED_PKT_BYTES,
            ctypes.c_float(bin_scale(tab["bin_slots"])), 1]
    if prof is None:
        fn, types_ = lib.wired_advance_obs_launch, OLD_OBS_ARGTYPES
    else:
        fn = lib.wired_advance_obs_profile
        types_ = OLD_OBS_ARGTYPES[:-1] + [ctypes.c_void_p] * 2
        args.append(prof.data_ptr())
    fn.argtypes, fn.restype = types_, ctypes.c_int
    err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        cs.fail(f"the old wired_advance:obs failed: CUDA error {err}")
    carry["t"] = max(t0, int(t_grant))
    carry["fm_mark"] = int(t_grant) - 1
    return carry, dict(next_event=out[:R].amin(), n_steps=out[R:].max(),
                       fm_ring=flip_ring(carry["fm_ring"]))


def sass_text(path) -> dict:
    """``{function: [instruction, ...]}`` of a built library's SASS
    (``cuobjdump -sass``), each instruction's text without its address;
    empty where the toolkit has no ``cuobjdump``."""
    from tpudes_torch import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return {}
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300)
    funcs, name = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            funcs[name].append(m.group(1))
    return funcs


def obs_off_sass(base_path) -> dict:
    """The obs-off ``wired_advance`` instantiations' SASS in this
    checkout's library against the same kernels built from ``base_path``
    (an earlier ``wired_advance.cu``, whose template has the ``PROF`` flag
    only): ``{instantiation: (instructions, instructions that differ)}``."""
    from tpudes_torch import _build

    new = sass_text(_build.library_path("wired_advance"))
    old = sass_text(base_path)
    out = {}
    for prof in (0, 1):
        a = old.get(f"_ZN12wired_kernel13wired_advanceILb{prof}EEEvNS_4ArgsE")
        b = new.get(f"_ZN12wired_kernel13wired_advanceILb{prof}ELb0EEEvNS_"
                    "4ArgsE")
        if a is None or b is None:
            cs.fail(f"obs-off SASS: wired_advance<PROF={prof}> not found "
                    f"(old {a is not None}, new {b is not None})")
        differ = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        out[f"PROF={prof}"] = (len(b), differ)
    return out


def wired_obs_compare(old_lib, base_path, dev, card: str,
                      old_dir: str) -> dict:
    """The compare (the module's docstring).  Returns the
    ``wired_obs_old_vs_new`` line."""
    import torch
    from tpudes_torch.parallel import wired as wd
    from tpudes_torch.parallel import wired_cuda

    bench = wd.wired_chain(**cs.WIRED_BENCH)
    tab = wd.wired_tables(bench, [(bench, None, None)], dev)
    init, _ = wd.build_wired_advance(bench, cs.WIRED_R, device=dev, obs=True,
                                     tab=tab)
    carry0 = init(np.array([0, 11]))
    n = cs.OBS_WIRED_SLOTS
    new, nm = wired_cuda.wired_obs_cuda(tab, cs.wired_clone(carry0), n)
    was, _ = old_wired_obs(old_lib, tab, cs.wired_clone(carry0), n)
    want, wm = wd.advance_math(tab, cs.wired_clone(carry0), n)
    torch.cuda.synchronize()
    state = [k for k, _ in wd.WIRED_STATE]
    cs.same_trees({k: was[k] for k in state + list(CLOCK_FREE_COLS)}, new,
                  "compare wired_advance:obs, old vs new")
    cs.same_trees(want, new, "compare wired_advance:obs vs advance_math")
    cs.same_trees(wm, nm, "compare wired_advance:obs metrics vs "
                  "advance_math")
    times = {"old": [], "new": []}
    for turn in ("old", "new", "new", "old"):
        pool = [cs.wired_clone(carry0) for _ in range(7)]
        if turn == "old":
            fn = lambda: old_wired_obs(old_lib, tab, pool.pop(), n)
        else:
            fn = lambda: wired_cuda.wired_obs_cuda(tab, pool.pop(), n)
        times[turn].append(cs.timed_ms(fn, 1, reps=3)[0])
        del pool
    parts = cs.obs_wired_times(tab, carry0, n)
    result = dict(phase="wired_obs_old_vs_new", card=card, old=old_dir,
                  replicas=cs.WIRED_R, slots=n, times=times, new_parts=parts,
                  old_over_new=statistics.mean(times["old"])
                  / statistics.mean(times["new"]))
    print(f"compare (wired_advance:obs, {cs.WIRED_R} rows x {n} slots): the "
          f"state and clock-free columns equal, the new pair equal to "
          f"advance_math; old {times['old']} ms, new {times['new']} ms "
          f"(the arm {parts['arm_ms']:.4f}, the union pass "
          f"{parts['union_ms']:.4f} ms apart)", flush=True)
    result["split_new"] = cs.obs_stage_split(dev, "new", tab, carry0, n,
                                             parts["union_ms"])
    if hasattr(old_lib, "wired_advance_obs_profile"):
        result["split_old"] = cs.obs_stage_split(
            dev, "old", tab, carry0, n,
            launch=lambda c, t, prof=None: old_wired_obs(old_lib, tab, c, t,
                                                         prof))
    else:
        result["split_old"] = "not measured: the old kernel has no probe"
    result["obs_off_sass"] = obs_off_sass(base_path)
    print(f"obs-off wired_advance SASS against {old_dir}/wired_advance.cu: "
          f"{result['obs_off_sass']} (instructions, of which differ)",
          flush=True)
    return result


def main(old_dir: str) -> int:
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    from tpudes_torch import _build

    for name in ("wired_advance_obs", "wired_advance"):
        if not os.path.isfile(os.path.join(old_dir, f"{name}.cu")):
            cs.fail(f"{old_dir} holds no {name}.cu")
    card = cs.card_line()
    print(card, flush=True)
    old = {k: cs.build_old(k, old_dir)
           for k in ("wired_advance_obs", "wired_advance")}
    logs = _build.build(["wired_advance"])
    for k, (proc, _) in old.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"the old {k} build failed:\n{log}")
        if k == "wired_advance_obs":
            print("\n".join(cs.ptxas_lines("wired_advance", logs[
                "wired_advance"]) + cs.ptxas_lines(f"{k} (old)", log)),
                flush=True)
    lib = ctypes.CDLL(str(old["wired_advance_obs"][1]))
    print(json.dumps(wired_obs_compare(lib, old["wired_advance"][1],
                                       torch.device("cuda"), card, old_dir)),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        cs.fail("usage: python3 tools/wired_obs_compare.py DIR")
    sys.exit(main(sys.argv[1]))
