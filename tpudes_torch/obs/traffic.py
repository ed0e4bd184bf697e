"""Workload observability: what the traffic stage offered and what was
delivered.

A copy of ``tpudes/obs/traffic.py`` (:class:`TrafficTelemetry` ``:29``,
:func:`validate_traffic_metrics` ``:107``).  The port's traffic arms
(``run_lte_sm`` and ``run_replicated_bss`` with a traffic program) record
one entry a launch:

- ``offered`` / ``delivered``: load per engine, in the engine's ``unit``
  (bits for the LTE backlog engine, packets for the arrival engines);
- ``runs`` / ``models``: launches per workload model;
- ``duty``: the mean ON share of ON-OFF workloads.

``python -m tpudes_torch.obs --traffic metrics.json`` is the schema gate.
"""

from __future__ import annotations

__all__ = ["TrafficTelemetry", "validate_traffic_metrics"]


class TrafficTelemetry:
    """Process-wide workload counters, per engine."""

    _engines: dict[str, dict] = {}

    @classmethod
    def _engine(cls, engine: str) -> dict:
        return cls._engines.setdefault(
            engine,
            {
                "offered": 0.0, "delivered": 0.0, "runs": 0,
                "models": {}, "duty_sum": 0.0, "duty_n": 0,
                "unit": "packets",
            },
        )

    @classmethod
    def record(
        cls, engine: str, model: str, *, offered: float,
        delivered: float, unit: str = "bits", duty: float | None = None,
    ) -> None:
        e = cls._engine(engine)
        e["offered"] += float(offered)
        e["delivered"] += float(delivered)
        e["runs"] += 1
        e["unit"] = unit
        e["models"][model] = e["models"].get(model, 0) + 1
        if duty is not None:
            e["duty_sum"] += float(duty)
            e["duty_n"] += 1

    @classmethod
    def snapshot(cls) -> dict:
        engines = {}
        for name, e in sorted(cls._engines.items()):
            engines[name] = {
                "offered": round(e["offered"], 3),
                "delivered": round(e["delivered"], 3),
                "delivered_frac": (
                    round(min(e["delivered"] / e["offered"], 1.0), 4)
                    if e["offered"] > 0
                    else 0.0
                ),
                "runs": e["runs"],
                "models": dict(e["models"]),
                "burst_duty": (
                    round(e["duty_sum"] / e["duty_n"], 4)
                    if e["duty_n"] > 0
                    else None
                ),
                "unit": e["unit"],
            }
        return {"version": 1, "engines": engines}

    @classmethod
    def engine(cls, engine: str) -> dict:
        return dict(cls._engine(engine))

    @classmethod
    def reset(cls) -> None:
        cls._engines = {}


def validate_traffic_metrics(doc) -> list[str]:
    """Schema check for a :meth:`TrafficTelemetry.snapshot` document
    (dependency-free, mirroring ``validate_geometry_metrics``).
    Returns human-readable problems; empty means valid."""
    from tpudes_torch.obs.schema import make_need

    problems: list[str] = []
    need = make_need(problems)

    if not isinstance(doc, dict):
        return ["top level: not a JSON object"]
    if doc.get("version") != 1:
        problems.append("version: expected 1")
    engines = need(doc, "engines", dict, "top level")
    if engines is not None:
        for name, e in engines.items():
            where = f"engines.{name}"
            offered = need(e, "offered", (int, float), where)
            delivered = need(e, "delivered", (int, float), where)
            frac = need(e, "delivered_frac", (int, float), where)
            runs = need(e, "runs", int, where)
            models = need(e, "models", dict, where)
            need(e, "unit", str, where)
            for k, v in (("offered", offered), ("delivered", delivered)):
                if isinstance(v, (int, float)) and v < 0:
                    problems.append(f"{where}.{k}: negative")
            if isinstance(runs, int) and runs < 0:
                problems.append(f"{where}.runs: negative")
            if isinstance(frac, (int, float)) and not (
                0.0 <= float(frac) <= 1.0
            ):
                problems.append(f"{where}.delivered_frac: outside [0, 1]")
            if isinstance(models, dict):
                total = 0
                for m, c in models.items():
                    if not isinstance(c, int) or c < 0:
                        problems.append(
                            f"{where}.models.{m}: not a count"
                        )
                    else:
                        total += c
                if isinstance(runs, int) and total != runs:
                    problems.append(
                        f"{where}: model counts sum {total} != runs "
                        f"{runs}"
                    )
            duty = e.get("burst_duty")
            if duty is not None and (
                not isinstance(duty, (int, float))
                or not (0.0 <= float(duty) <= 1.0)
            ):
                problems.append(f"{where}.burst_duty: outside [0, 1]")
    return problems
