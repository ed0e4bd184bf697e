"""Design search: descent where gradients exist, megabatched ES where they don't.

Counterpart of ``tpudes/diff/search.py``:

- :func:`descend_design`: gradient descent on a design objective (the
  calibration loop, :func:`~tpudes_torch.diff.calibrate.descend`);
- :func:`es_search`: antithetic evolution strategies for the engines
  whose programs stay integer / event-stepped.  Each generation draws P
  Gaussian perturbations ``normal(fold_in(key, gen), (P, D))`` (the
  port's threefry, so the populations are the reference's) and evaluates
  the 2P candidates ``theta +- sigma eps`` as one launch through the
  caller's ``evaluate`` hook; :func:`fd_gradient` is the same machinery
  as a central-difference probe.

:func:`bss_interval_design` is the worked example: the per-STA offered
interval of a BSS cell, optimised for decoded echo requests, one
``run_replicated_bss(..., traffic_sweep=points)`` call a generation (one
``bss_advance`` launch with the ``traffic_sweep`` grid on the card).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["ESResult", "bss_interval_design", "descend_design", "es_search",
           "fd_gradient"]


@dataclass
class ESResult:
    """One evolution-strategies run (``search.py:42``)."""

    theta: np.ndarray          # (D,) final parameters
    fitness: np.ndarray        # (generations,) best candidate per gen
    mean_fitness: np.ndarray   # (generations,) population mean
    launches: int              # device launches consumed (== generations)


def _key(key) -> torch.Tensor:
    return torch.as_tensor(np.asarray(key, np.int64))


def _gen_eps(key, gen: int, shape) -> np.ndarray:
    """Generation ``gen``'s perturbations, ``normal(fold_in(key, gen),
    shape)`` in f32, as f64 (``search.py:51``)."""
    from tpudes_torch.random import fold_in, normal

    return normal(fold_in(_key(key), int(gen)), tuple(shape)).numpy().astype(
        np.float64)


def es_search(evaluate, theta0, *, key, generations: int = 10, pop: int = 8,
              sigma: float = 0.15, lr: float = 0.25, maximize: bool = True,
              clip=None) -> ESResult:
    """Antithetic ES over ``evaluate(thetas (2P, D)) -> (2P,) fitness``,
    the caller running the 2P candidates as one launch
    (``search.py:62``); ``clip`` an optional ``(lo, hi)`` box."""
    theta = np.asarray(theta0, np.float64).copy()
    best_hist, mean_hist = [], []
    launches = 0
    for g in range(int(generations)):
        eps = _gen_eps(key, g, (int(pop), theta.shape[0]))
        cand = np.concatenate(
            [theta[None, :] + sigma * eps, theta[None, :] - sigma * eps])
        if clip is not None:
            cand = np.clip(cand, clip[0], clip[1])
        f = np.asarray(evaluate(cand), np.float64)
        launches += 1
        if f.shape != (2 * pop,):
            raise ValueError(
                f"evaluate returned shape {f.shape}, wanted {(2 * pop,)}")
        adv = f[:pop] - f[pop:]
        step = (adv[:, None] * eps).sum(axis=0) * (lr / (2.0 * pop * sigma))
        theta = theta + (step if maximize else -step)
        if clip is not None:
            theta = np.clip(theta, clip[0], clip[1])
        best_hist.append(float(f.max() if maximize else f.min()))
        mean_hist.append(float(f.mean()))
    return ESResult(theta=theta, fitness=np.asarray(best_hist),
                    mean_fitness=np.asarray(mean_hist), launches=launches)


def fd_gradient(evaluate, theta, *, eps: float = 1e-3) -> np.ndarray:
    """Central differences over one batched ``evaluate`` call of the 2D
    probes (``search.py:112``)."""
    theta = np.asarray(theta, np.float64)
    D = theta.shape[0]
    probes = np.concatenate([theta[None, :] + eps * np.eye(D),
                             theta[None, :] - eps * np.eye(D)])
    f = np.asarray(evaluate(probes), np.float64)
    return (f[:D] - f[D:]) / (2.0 * eps)


def descend_design(grad_step, theta0: dict, *, key, steps: int = 60,
                   lr: float = 0.05, opt: str = "adam",
                   runtime_key: tuple | None = None, engine: str = "diff",
                   device=None):
    """Gradient descent on a design objective (``search.py:127``): the
    calibration loop, ``grad_step`` already negating a KPI to maximise."""
    from tpudes_torch.diff.calibrate import descend

    return descend(grad_step, theta0, steps=steps, lr=lr, key=key, opt=opt,
                   runtime_key=runtime_key, engine=engine, device=device)


def bss_interval_design(prog, key, replicas: int, *, generations: int = 6,
                        pop: int = 4, sigma: float = 0.25, lr: float = 0.4,
                        log_interval_bounds=(np.log(2_000.0),
                                             np.log(60_000.0)),
                        es_key=None, device=None) -> ESResult:
    """Optimise the per-STA offered CBR interval of a BSS cell for decoded
    echo requests (``search.py:150``): theta the STAs' log intervals (µs;
    entity 0, the AP beacon, keeps its cadence), each generation's 2P
    candidates one ``traffic_sweep`` run, fitness the replica-mean
    ``srv_rx``.  ``prog.traffic`` must be a cbr program (the sweep's shape
    class).  ``device`` defaults to the card."""
    from tpudes_torch.parallel.replicated import run_replicated_bss
    from tpudes_torch.random import fold_in
    from tpudes_torch.traffic.program import TrafficProgram

    if prog.traffic is None:
        raise ValueError(
            "bss_interval_design needs prog.traffic set (a cbr "
            "TrafficProgram, the sweep's shape class)")
    base = prog.traffic
    theta0 = np.log(np.maximum(np.asarray(base.interval_us, np.float64),
                               1.0))[1:]

    def evaluate(thetas):
        points = []
        for row in thetas:
            iv = np.asarray(base.interval_us, np.int64).copy()
            iv[1:] = np.clip(np.exp(row), 1.0, 2.0**30).astype(np.int64)
            points.append(TrafficProgram.cbr(base.start_us, iv))
        out = run_replicated_bss(prog, replicas, key, traffic_sweep=points,
                                 device=device)
        return np.asarray([float(np.mean(p["srv_rx"])) for p in out],
                          np.float64)

    return es_search(
        evaluate, theta0,
        key=fold_in(_key(key), 0x5EA) if es_key is None else es_key,
        generations=generations, pop=pop, sigma=sigma, lr=lr,
        maximize=True, clip=log_interval_bounds)
