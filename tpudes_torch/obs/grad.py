"""Gradient observability: what the diff subsystem descended and how.

Counterpart of ``tpudes/obs/grad.py``.  :class:`GradTelemetry` is the
process-wide record of every grad and calibration launch: per engine the
launch and step counts, bounded rings of the recent losses and gradient
norms, and the count of non-finite ones (the canary for a surrogate
temperature set too cold).  ``python -m tpudes_torch.obs --grad
metrics.json`` is the schema gate.
"""

from __future__ import annotations

import math

__all__ = ["GradTelemetry", "validate_grad_metrics"]

#: ring capacity (loss / grad-norm histories per engine)
_RING = 256


class GradTelemetry:
    """Process-wide gradient counters, per engine (``grad.py:26``)."""

    _engines: dict[str, dict] = {}

    @classmethod
    def _engine(cls, engine: str) -> dict:
        return cls._engines.setdefault(
            engine,
            {"launches": 0, "steps": 0, "loss_ring": [],
             "grad_norm_ring": [], "last_loss": None, "nonfinite": 0,
             "batched_points": 0},
        )

    @classmethod
    def _push(cls, e: dict, loss: float, grad_norm: float) -> None:
        if not (math.isfinite(loss) and math.isfinite(grad_norm)):
            e["nonfinite"] += 1
        e["loss_ring"].append(float(loss))
        e["grad_norm_ring"].append(float(grad_norm))
        del e["loss_ring"][:-_RING]
        del e["grad_norm_ring"][:-_RING]
        e["last_loss"] = float(loss)

    @classmethod
    def record(cls, engine: str, *, loss: float, grad_norm: float,
               batched: int | None = None) -> None:
        """One grad launch (a C-point batch counts its points in
        ``batched_points``)."""
        e = cls._engine(engine)
        e["launches"] += 1
        e["steps"] += 1
        e["batched_points"] += int(batched or 1)
        cls._push(e, loss, grad_norm)

    @classmethod
    def record_descent(cls, engine: str, losses, grad_norms) -> None:
        """One descent launch: its whole per-step history."""
        e = cls._engine(engine)
        e["launches"] += 1
        for lo, gn in zip(losses, grad_norms):
            e["steps"] += 1
            cls._push(e, float(lo), float(gn))

    @classmethod
    def snapshot(cls) -> dict:
        engines = {}
        for name, e in sorted(cls._engines.items()):
            engines[name] = {
                "launches": e["launches"],
                "steps": e["steps"],
                "batched_points": e["batched_points"],
                "last_loss": e["last_loss"],
                "loss_ring": [round(v, 6) for v in e["loss_ring"]],
                "grad_norm_ring": [round(v, 6) for v in e["grad_norm_ring"]],
                "nonfinite": e["nonfinite"],
            }
        return {"version": 1, "engines": engines}

    @classmethod
    def engine(cls, engine: str) -> dict:
        return dict(cls._engine(engine))

    @classmethod
    def reset(cls) -> None:
        cls._engines = {}


def validate_grad_metrics(doc) -> list[str]:
    """Schema check of a :meth:`GradTelemetry.snapshot` document
    (``grad.py:101``)."""
    from tpudes_torch.obs.schema import make_need

    problems: list[str] = []
    need = make_need(problems)
    if not isinstance(doc, dict):
        return ["top level: not a JSON object"]
    if doc.get("version") != 1:
        problems.append("version: expected 1")
    engines = need(doc, "engines", dict, "top level")
    for name, e in (engines or {}).items():
        where = f"engines.{name}"
        for k in ("launches", "steps", "batched_points", "nonfinite"):
            v = need(e, k, int, where)
            if isinstance(v, int) and v < 0:
                problems.append(f"{where}.{k}: negative")
        last = e.get("last_loss")
        if last is not None and not isinstance(last, (int, float)):
            problems.append(f"{where}.last_loss: not a number")
        for ring in ("loss_ring", "grad_norm_ring"):
            r = need(e, ring, list, where)
            if r is None:
                continue
            if len(r) > _RING:
                problems.append(f"{where}.{ring}: over the {_RING} cap")
            if not all(isinstance(v, (int, float)) for v in r):
                problems.append(f"{where}.{ring}: non-number entry")
        steps = e.get("steps")
        r = e.get("loss_ring")
        if isinstance(steps, int) and isinstance(r, list) and len(r) > steps:
            problems.append(f"{where}: loss_ring longer than steps")
    return problems
