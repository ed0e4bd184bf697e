"""Geometry-refresh observability: who recomputed the loss matrices.

A copy of ``tpudes/obs/geometry.py`` (:class:`GeomTelemetry` ``:29``,
:func:`validate_geometry_metrics` ``:84``).  The port's mobile engines
(``run_lte_sm`` and ``run_replicated_bss`` with a mobility program)
record their in-kernel refreshes here once a launch:

- ``device_refreshes``: refreshes of the device geometry stage;
- ``host_refreshes``: host geometry rebuilds (the port has no host
  controller, so nothing records these yet);
- ``steps``: geometry-consuming steps, so ``stride_hit_rate`` = 1 -
  refreshes / steps is the share of steps served from the carried rows.

``python -m tpudes_torch.obs --geometry metrics.json`` is the schema gate.
"""

from __future__ import annotations

__all__ = ["GeomTelemetry", "validate_geometry_metrics"]


class GeomTelemetry:
    """Process-wide geometry-refresh counters, per engine."""

    _engines: dict[str, dict] = {}

    @classmethod
    def _engine(cls, engine: str) -> dict:
        return cls._engines.setdefault(
            engine,
            {"device_refreshes": 0, "host_refreshes": 0, "steps": 0},
        )

    @classmethod
    def record_device(cls, engine: str, refreshes: int, steps: int) -> None:
        e = cls._engine(engine)
        e["device_refreshes"] += int(refreshes)
        e["steps"] += int(steps)

    @classmethod
    def record_host(cls, engine: str, refreshes: int = 1) -> None:
        cls._engine(engine)["host_refreshes"] += int(refreshes)

    @classmethod
    def snapshot(cls) -> dict:
        engines = {}
        for name, e in sorted(cls._engines.items()):
            steps = e["steps"]
            engines[name] = {
                "device_refreshes": e["device_refreshes"],
                "host_refreshes": e["host_refreshes"],
                "steps": steps,
                "stride_hit_rate": (
                    round(1.0 - e["device_refreshes"] / steps, 4)
                    if steps > 0
                    else 0.0
                ),
            }
        return {"version": 1, "engines": engines}

    @classmethod
    def engine(cls, engine: str) -> dict:
        return dict(cls._engine(engine))

    @classmethod
    def reset(cls) -> None:
        cls._engines = {}


def validate_geometry_metrics(doc) -> list[str]:
    """Schema check for a :meth:`GeomTelemetry.snapshot` document
    (dependency-free, mirroring ``validate_fuzz_metrics``).  Returns
    human-readable problems; empty means valid."""
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
            dev = need(e, "device_refreshes", int, where)
            need(e, "host_refreshes", int, where)
            steps = need(e, "steps", int, where)
            rate = need(e, "stride_hit_rate", (int, float), where)
            for k, v in (("device_refreshes", dev), ("steps", steps)):
                if isinstance(v, int) and v < 0:
                    problems.append(f"{where}.{k}: negative")
            if (
                isinstance(dev, int)
                and isinstance(steps, int)
                and steps > 0
                and dev > steps
            ):
                problems.append(f"{where}: device_refreshes > steps")
            if isinstance(rate, (int, float)) and not (
                0.0 <= float(rate) <= 1.0
            ):
                problems.append(f"{where}.stride_hit_rate: outside [0, 1]")
    return problems
