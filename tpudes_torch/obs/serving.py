"""Serving-layer observability: the StudyServer's metrics surface.

A copy of ``tpudes/obs/serving.py`` (``ServingTelemetry`` at ``:33``,
``validate_serving_metrics`` at ``:272``) for the port.
:class:`ServingTelemetry` is the process-global registry
:class:`tpudes_torch.serving.StudyServer` records into — queue depth,
coalesce rate, batch occupancy, per-engine launch latency and end-to-end
study latency, the failure and recovery counters (requeues, members
lost, retry-budget exhaustion, chaos injections per kind, checkpoint
saves and restores) and per-SLO-class attainment — and
:func:`validate_serving_metrics` is its schema check.  Recording is a
dict update; the latency samples are bounded rings (:data:`CAP`).
"""

from __future__ import annotations

__all__ = ["ServingTelemetry", "validate_serving_metrics"]


def _percentile(samples: list[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 1]) of a non-empty list."""
    xs = sorted(samples)
    idx = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[idx]


class ServingTelemetry:
    """Process-wide serving metrics registry.

    Counters are cumulative since the last :meth:`reset`; the latency
    rings keep the most recent :data:`CAP` samples per engine.  A
    *coalesced* launch is one that carried more than one real study;
    *pad_points* counts the duplicated tail points a pow2 config-bucket
    pad added (device work spent on no study — the occupancy cost of
    executable reuse).
    """

    #: bound on retained latency samples per engine (recent window)
    CAP = 4096

    _counters: dict[str, int] = {}
    _queue_depth = 0
    _queue_depth_max = 0
    _engines: dict[str, dict] = {}
    #: failure/recovery counters: requeues, member loss,
    #: retry-budget exhaustion, chaos injections, checkpoint traffic
    _failures: dict[str, int] = {}
    #: SLO class -> {"studies", "attained", "latency_s" ring}
    _slo: dict[str, dict] = {}

    # --- recording hooks (called by tpudes_torch.serving) ----------------

    @classmethod
    def _bump(cls, name: str, n: int = 1) -> None:
        cls._counters[name] = cls._counters.get(name, 0) + int(n)

    @classmethod
    def _engine(cls, engine: str) -> dict:
        return cls._engines.setdefault(
            engine,
            {
                "launches": 0,
                "studies": 0,
                "coalesced_launches": 0,
                "real_points": 0,
                "padded_points": 0,
                "launch_wall_s": [],
                "study_latency_s": [],
            },
        )

    @classmethod
    def record_submit(cls, engine: str, queue_depth: int) -> None:
        cls._bump("submitted")
        cls._queue_depth = int(queue_depth)
        cls._queue_depth_max = max(cls._queue_depth_max, int(queue_depth))

    @classmethod
    def record_reject(cls, tenant: str) -> None:
        del tenant  # per-tenant breakdown is the server's, not global
        cls._bump("rejected")

    @classmethod
    def record_dispatch(cls, engine: str, n_real: int, n_padded: int,
                        queue_depth: int) -> None:
        cls._queue_depth = int(queue_depth)
        e = cls._engine(engine)
        e["launches"] += 1
        e["real_points"] += int(n_real)
        e["padded_points"] += int(n_padded)
        cls._bump("launches")
        if n_real > 1:
            e["coalesced_launches"] += 1
            cls._bump("coalesced_launches")
            cls._bump("coalesced_studies", n_real)
        cls._bump("pad_points", int(n_padded) - int(n_real))

    @classmethod
    def record_launch_done(cls, engine: str, wall_s: float) -> None:
        ring = cls._engine(engine)["launch_wall_s"]
        ring.append(float(wall_s))
        del ring[: max(0, len(ring) - cls.CAP)]

    @classmethod
    def record_study_done(cls, engine: str, latency_s: float,
                          slo: str | None = None,
                          attained: bool | None = None) -> None:
        e = cls._engine(engine)
        e["studies"] += 1
        cls._bump("completed")
        ring = e["study_latency_s"]
        ring.append(float(latency_s))
        del ring[: max(0, len(ring) - cls.CAP)]
        if slo is not None:
            s = cls._slo.setdefault(
                slo, {"studies": 0, "attained": 0, "latency_s": []}
            )
            s["studies"] += 1
            if attained:
                s["attained"] += 1
            s["latency_s"].append(float(latency_s))
            del s["latency_s"][: max(0, len(s["latency_s"]) - cls.CAP)]

    # --- failure/recovery hooks -----------------------------------------

    @classmethod
    def _fail_bump(cls, name: str, n: int = 1) -> None:
        cls._failures[name] = cls._failures.get(name, 0) + int(n)

    @classmethod
    def record_requeue(cls, engine: str, n_studies: int) -> None:
        """A batch transiently failed and went back to the queue."""
        del engine
        cls._fail_bump("requeued_batches")
        cls._fail_bump("requeued_studies", n_studies)

    @classmethod
    def record_member_lost(cls, n_members: int = 1) -> None:
        cls._fail_bump("members_lost", n_members)

    @classmethod
    def record_retry_exhausted(cls, n: int = 1) -> None:
        cls._fail_bump("retry_budget_exhausted", n)

    @classmethod
    def record_injected(cls, kind: str) -> None:
        """A chaos schedule fired (kind-tagged, plus the total the
        schema gates on)."""
        cls._fail_bump("injected_failures")
        cls._fail_bump(f"injected_{kind}")

    @classmethod
    def record_checkpoint(cls, event: str) -> None:
        """``event`` is ``save`` or ``restore``."""
        cls._fail_bump(f"checkpoint_{event}s")

    @classmethod
    def record_backstop(cls) -> None:
        """The scheduler loop's belt-and-braces catch fired — a bug
        the per-batch poisoning should have handled.  Counted (never
        silently swallowed) so a hot backstop shows up on dashboards."""
        cls._fail_bump("scheduler_backstop")

    @classmethod
    def record_queue_depth(cls, depth: int) -> None:
        cls._queue_depth = int(depth)
        cls._queue_depth_max = max(cls._queue_depth_max, int(depth))

    @classmethod
    def record_warm(cls, engine: str, n_programs: int, wall_s: float) -> None:
        del engine
        cls._bump("warm_programs", n_programs)
        cls._warm_wall = getattr(cls, "_warm_wall", 0.0) + float(wall_s)

    # --- reading ----------------------------------------------------------

    @classmethod
    def snapshot(cls) -> dict:
        """The exported metrics document (see
        :func:`validate_serving_metrics` for the schema)."""

        def dist(ring: list[float]) -> dict:
            if not ring:
                return {"p50": 0.0, "p99": 0.0, "n": 0}
            return {
                "p50": round(_percentile(ring, 0.50), 6),
                "p99": round(_percentile(ring, 0.99), 6),
                "n": len(ring),
            }

        counters = {
            k: cls._counters.get(k, 0)
            for k in (
                "submitted", "completed", "rejected", "launches",
                "coalesced_launches", "coalesced_studies", "pad_points",
                "warm_programs",
            )
        }
        done = counters["completed"]
        engines = {}
        for name, e in sorted(cls._engines.items()):
            occupancy = (
                e["real_points"] / e["padded_points"]
                if e["padded_points"]
                else 0.0
            )
            engines[name] = {
                "launches": e["launches"],
                "studies": e["studies"],
                "coalesced_launches": e["coalesced_launches"],
                "batch_occupancy": round(occupancy, 4),
                "launch_wall_s": dist(e["launch_wall_s"]),
                "study_latency_s": dist(e["study_latency_s"]),
            }
        failures = {
            k: cls._failures.get(k, 0)
            for k in (
                "requeued_batches", "requeued_studies", "members_lost",
                "retry_budget_exhausted", "injected_failures",
                "checkpoint_saves", "checkpoint_restores",
                "scheduler_backstop",
            )
        }
        # kind-tagged injection counters ride along verbatim
        failures.update({
            k: v for k, v in sorted(cls._failures.items())
            if k.startswith("injected_")
        })
        slo = {}
        for name, s in sorted(cls._slo.items()):
            slo[name] = {
                "studies": s["studies"],
                "attained": s["attained"],
                "attainment": round(
                    s["attained"] / s["studies"], 4
                ) if s["studies"] else 0.0,
                "latency_s": dist(s["latency_s"]),
            }
        return {
            "version": 1,
            "counters": counters,
            "coalesce_rate": round(
                counters["coalesced_studies"] / done, 4
            ) if done else 0.0,
            "warm_wall_s": round(getattr(cls, "_warm_wall", 0.0), 3),
            "queue": {
                "depth": cls._queue_depth,
                "depth_max": cls._queue_depth_max,
            },
            "failures": failures,
            "slo": slo,
            "engines": engines,
        }

    @classmethod
    def reset(cls) -> None:
        cls._counters = {}
        cls._engines = {}
        cls._queue_depth = 0
        cls._queue_depth_max = 0
        cls._warm_wall = 0.0
        cls._failures = {}
        cls._slo = {}


def validate_serving_metrics(doc) -> list[str]:
    """Schema check for a :meth:`ServingTelemetry.snapshot` document
    (dependency-free, mirroring ``validate_chrome_trace``).  Returns a
    list of human-readable problems; empty means valid."""
    from tpudes_torch.obs.schema import make_need

    problems: list[str] = []
    need = make_need(problems)

    if not isinstance(doc, dict):
        return ["top level: not a JSON object"]
    if doc.get("version") != 1:
        problems.append("version: expected 1")
    counters = need(doc, "counters", dict, "top level")
    if counters is not None:
        for k in (
            "submitted", "completed", "rejected", "launches",
            "coalesced_launches", "coalesced_studies", "pad_points",
        ):
            v = need(counters, k, int, "counters")
            if isinstance(v, int) and v < 0:
                problems.append(f"counters.{k}: negative")
    need(doc, "coalesce_rate", (int, float), "top level")
    queue = need(doc, "queue", dict, "top level")
    if queue is not None:
        need(queue, "depth", int, "queue")
        need(queue, "depth_max", int, "queue")
    failures = need(doc, "failures", dict, "top level")
    if failures is not None:
        for k in (
            "requeued_batches", "requeued_studies", "members_lost",
            "retry_budget_exhausted", "injected_failures",
            "checkpoint_saves", "checkpoint_restores",
        ):
            v = need(failures, k, int, "failures")
            if isinstance(v, int) and v < 0:
                problems.append(f"failures.{k}: negative")
    slo = need(doc, "slo", dict, "top level")
    if slo is not None:
        for name, s in slo.items():
            where = f"slo.{name}"
            if not isinstance(s, dict):
                problems.append(f"{where}: not an object")
                continue
            n = need(s, "studies", int, where)
            att = need(s, "attained", int, where)
            rate = need(s, "attainment", (int, float), where)
            if rate is not None and not (0.0 <= rate <= 1.0):
                problems.append(f"{where}.attainment: not in [0, 1]")
            if (
                isinstance(n, int) and isinstance(att, int) and att > n
            ):
                problems.append(f"{where}: attained > studies")
            d = need(s, "latency_s", dict, where)
            if d is not None:
                need(d, "p50", (int, float), f"{where}.latency_s")
                need(d, "p99", (int, float), f"{where}.latency_s")
                need(d, "n", int, f"{where}.latency_s")
    engines = need(doc, "engines", dict, "top level")
    if engines is not None:
        for name, e in engines.items():
            where = f"engines.{name}"
            need(e, "launches", int, where)
            need(e, "studies", int, where)
            need(e, "coalesced_launches", int, where)
            occ = need(e, "batch_occupancy", (int, float), where)
            if occ is not None and not (0.0 <= occ <= 1.0):
                problems.append(f"{where}.batch_occupancy: not in [0, 1]")
            for dk in ("launch_wall_s", "study_latency_s"):
                d = need(e, dk, dict, where)
                if d is not None:
                    need(d, "p50", (int, float), f"{where}.{dk}")
                    need(d, "p99", (int, float), f"{where}.{dk}")
                    need(d, "n", int, f"{where}.{dk}")
    return problems
