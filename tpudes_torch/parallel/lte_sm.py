"""Full-buffer (RLC-SM) LTE downlink engine on the card.

Counterpart of ``tpudes/parallel/lte_sm.py`` for static programs: under
RLC saturation every buffer is always full, so the only evolving state
is scheduler/HARQ bookkeeping, and a static grid makes SINR, CQI, MCS
and MI per-UE constants.  The TTI math is
:mod:`tpudes_torch.parallel.kernels_cuda`: on the card one launch of
the multi-TTI kernel runs a whole range of TTIs, on the CPU the plain
loop runs them; this module owns the program, the replica keys and the
result assembly.

Each replica ``r`` draws its TTI-``t`` coins as
``uniform(fold_in(fold_in(key, r), t), (U,))`` — the reference's
streams bit for bit (:mod:`tpudes_torch.random`) — so a run is
comparable with the JAX engine per replica, on integers.  The horizon
is a fixed count, so a host loop over chunks of TTIs is exact.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``precision="bf16"``, mobility, traffic, ``schedulers=`` sweeps,
``mesh`` and the ``TpudesObs`` FlowMonitor columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpudes_torch.device import resolve_device
from tpudes_torch.parallel.kernels_cuda import (
    SM_SCHED_IDS,
    build_sm_consts,
    sm_advance,
    sm_advance_math,
    sm_init_state,
    sm_step,
    sm_step_math,
)
from tpudes_torch.random import replica_keys


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to tpudes_torch yet (ROADMAP {item})"
    )


@dataclass(frozen=True)
class LteSmProgram:
    """Static description of a full-buffer LTE downlink scenario
    (the static fields of ``tpudes/parallel/lte_sm.py:131``)."""

    gain: np.ndarray          # (E, U) linear DL path gain
    serving: np.ndarray       # (U,) int32
    tx_power_dbm: np.ndarray  # (E,)
    noise_psd: float
    n_rb: int
    n_ttis: int
    scheduler: str            # any key of SM_SCHED_IDS
    pf_alpha: float = 0.05
    precision: str = "f32"
    mobility: object = None
    traffic: object = None

    def __post_init__(self):
        if self.scheduler not in SM_SCHED_IDS:
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
        if self.precision != "f32":
            raise _not_ported(f"precision={self.precision!r}", "B1 bf16 arm")
        if self.mobility is not None:
            raise _not_ported("mobility", "B1 mobility arm")
        if self.traffic is not None:
            raise _not_ported("traffic", "B1 traffic arm")

    @property
    def n_enb(self) -> int:
        return int(self.gain.shape[0])

    @property
    def n_ue(self) -> int:
        return int(self.gain.shape[1])


def build_sm_step(prog: LteSmProgram, device=None, use_kernel: bool = True):
    """``(consts, init_state, step_fn)`` with
    ``step_fn(state, coin (R, U), t) -> state`` (``lte_sm.py:397``), on
    ``device`` (the card by default).

    ``use_kernel=False`` runs the plain core on any device (the card's
    comparison path); otherwise the step is :func:`sm_step`, which
    launches the single-TTI kernel for CUDA tensors."""
    device = resolve_device(device)
    consts = build_sm_consts(prog, device=device)
    sid = SM_SCHED_IDS[prog.scheduler]
    step = sm_step if use_kernel else sm_step_math

    def init_state(replicas: int) -> dict:
        return sm_init_state(prog.n_enb, prog.n_ue, replicas, device)

    def step_fn(state: dict, coin: torch.Tensor, t: int) -> dict:
        return step(consts, state, coin, t, sid)

    return consts, init_state, step_fn


def build_sm_advance(prog: LteSmProgram, device=None,
                     use_kernel: bool = True, chunk_ttis: int | None = None):
    """``(consts, init_state, advance)`` with
    ``advance(state, keys (R, 2), t0, t_end) -> state`` running TTIs
    ``[t0, t_end)`` (``lte_sm.py:646``), ``chunk_ttis`` at a time (the
    whole range by default), on ``device`` (the card by default).

    Each chunk is :func:`sm_advance`: one launch of the multi-TTI kernel
    for CUDA tensors, the plain loop (coins drawn in memory-bounded
    chunks) for CPU tensors.  ``use_kernel=False`` runs the plain loop
    on any device."""
    consts, init_state, _ = build_sm_step(prog, device, use_kernel)
    sid = SM_SCHED_IDS[prog.scheduler]
    run = sm_advance if use_kernel else sm_advance_math

    def advance(state: dict, keys: torch.Tensor, t0: int, t_end: int):
        chunk = chunk_ttis or max(1, t_end - t0)
        for c0 in range(t0, t_end, chunk):
            state = run(consts, state, keys, c0, min(c0 + chunk, t_end), sid)
        return state

    return consts, init_state, advance


def _sm_unpack(state: dict, consts: dict, replicas) -> dict:
    """Host result dict (``lte_sm.py:564``): the 52-bit rx counter
    rebuilt, per-UE rows, and the static CQI/MCS/SINR."""
    host = {k: v.cpu().numpy() for k, v in state.items()}
    if replicas is None:
        host = {k: v[0] for k, v in host.items()}
    out = {
        k: host[k] for k in ("new_tbs", "retx", "drops")
    }
    out["rx_bits"] = (host["rx_hi"].astype(np.int64) << 20) + host[
        "rx_lo"
    ].astype(np.int64)
    out["ok"] = host["ok_cnt"]
    for k in ("cqi", "mcs", "sinr"):
        out[k] = consts[k].cpu().numpy()
    return out


def run_lte_sm(
    prog: LteSmProgram,
    key,
    replicas: int | None = None,
    *,
    device=None,
    chunk_ttis: int | None = None,
    use_kernel: bool = True,
    schedulers=None,
    mesh=None,
    obs: bool = False,
) -> dict:
    """Run the full-buffer downlink simulation (``lte_sm.py:1285``).

    ``key`` is a ``(2,)`` threefry key (:func:`tpudes_torch.random.PRNGKey`
    or a JAX key's words).  Without ``replicas``: one run on ``key``,
    per-UE arrays ``{rx_bits, new_tbs, retx, drops, ok, cqi, mcs,
    sinr}``.  With ``replicas=R``: replica ``r`` runs on
    ``fold_in(key, r)`` and the outcome arrays gain a leading ``R``
    axis.  ``device`` defaults to the card; on the card the horizon is
    one kernel launch (``chunk_ttis`` TTIs per launch if given) unless
    ``use_kernel=False`` asks for the plain loop."""
    if schedulers is not None:
        raise _not_ported("schedulers= sweeps", "B1 scheduler-sweep arm")
    if mesh is not None:
        raise _not_ported("mesh", "A12")
    if obs:
        raise _not_ported("TpudesObs", "A10")
    dev = resolve_device(device)
    key = torch.as_tensor(np.asarray(key, dtype=np.int64), device=dev)
    keys = key[None, :] if replicas is None else replica_keys(key, replicas)
    consts, init_state, advance = build_sm_advance(
        prog, dev, use_kernel, chunk_ttis
    )
    state = advance(init_state(len(keys)), keys, 0, prog.n_ttis)
    return _sm_unpack(state, consts, replicas)
