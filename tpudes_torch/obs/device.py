"""Device-side observability: compile telemetry, stage profiles and the
chunk stream.

A copy of ``tpudes/obs/device.py`` for the port:

- :class:`CompileTelemetry` (``:41``): one entry each time an engine's
  runner cache misses (the port's counterpart of a jit-cache miss: the
  engine builds its tables and constants), with the wall time of the
  missing call, and one entry a kernel that ``tpudes_torch._build``
  compiles with ``nvcc`` (engine ``"nvcc:<kernel>"``).  A nine-scheduler
  LTE sweep shows ``compiles("lte_sm") == 1``, as the reference pins.
  Recording is always on.
- :class:`KernelProfile` (``:85``): per-stage device timings, recorded by
  the port's stage probes (``bss_profile``, ``tcp_profile``,
  ``scan_profile``, ``window_profile``, ``spf_profile``,
  ``fluid_profile``, ``wired_profile``).
- :class:`ChunkStream` (``:127``): each chunk of a chunked run with
  ``obs=True`` records its small metrics dict here, chunk k only after
  chunk k + 1 is launched (:func:`tpudes_torch.parallel.runtime.
  drive_chunks`), so the copy back overlaps the next chunk's work.

The port takes ``obs=`` as an explicit argument of each entry in place of
the reference's ``TpudesObs`` GlobalValue, so there is no
``device_metrics_enabled``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

__all__ = ["ChunkStream", "CompileTelemetry", "KernelProfile", "timed_launch"]


class CompileTelemetry:
    """Process-wide per-engine compile counters."""

    _entries: dict[str, dict] = {}

    @classmethod
    def record(cls, engine: str, wall_s: float) -> None:
        entry = cls._entries.setdefault(
            engine, {"compiles": 0, "wall_s": 0.0}
        )
        entry["compiles"] += 1
        entry["wall_s"] += float(wall_s)

    @classmethod
    def snapshot(cls) -> dict[str, dict]:
        return {
            engine: {"compiles": e["compiles"], "wall_s": round(e["wall_s"], 3)}
            for engine, e in sorted(cls._entries.items())
        }

    @classmethod
    def compiles(cls, engine: str) -> int:
        return cls._entries.get(engine, {}).get("compiles", 0)

    @classmethod
    def reset(cls) -> None:
        cls._entries.clear()

    @classmethod
    @contextmanager
    def timed(cls, engine: str, compiling: bool, since: float | None = None):
        """Record one compile entry for the wrapped block when
        ``compiling`` (a runner-cache miss), timed from ``since`` (a
        ``time.monotonic()`` reading taken before the miss's build) or
        from the block's start."""
        if not compiling:
            yield
            return
        t0 = time.monotonic() if since is None else since
        yield
        cls.record(engine, time.monotonic() - t0)


class KernelProfile:
    """Per-stage device-kernel timings: each stage probe records the
    time of each stage of its kernel here (``wall_s``, the stage's share
    of the launch's device time) with the batch it ran."""

    _entries: dict[str, dict[str, dict]] = {}

    @classmethod
    def record(
        cls, engine: str, stage: str, wall_s: float, batch: int
    ) -> None:
        cls._entries.setdefault(engine, {})[stage] = {
            "wall_s": float(wall_s),
            "batch": int(batch),
        }

    @classmethod
    def stages(cls, engine: str) -> dict[str, dict]:
        return dict(cls._entries.get(engine, {}))

    @classmethod
    def snapshot(cls) -> dict[str, dict]:
        return {
            engine: {
                stage: {"wall_us": round(e["wall_s"] * 1e6, 1),
                        "batch": e["batch"]}
                for stage, e in stages.items()
            }
            for engine, stages in sorted(cls._entries.items())
        }

    @classmethod
    def record_cycles(cls, engine: str, cycles: dict, batch: int,
                      wall_s: float) -> None:
        """Record one probe launch: each stage's share of the stages'
        summed cycles times the launch's wall time ``wall_s``."""
        total = float(sum(cycles.values()))
        for stage, c in cycles.items():
            cls.record(engine, stage,
                       wall_s * float(c) / total if total > 0 else 0.0, batch)

    @classmethod
    def reset(cls) -> None:
        cls._entries.clear()


@contextmanager
def timed_launch(device):
    """Time the wrapped launch(es) on ``device``: yields a one-entry list
    that holds the wall seconds afterwards, the card synchronised on both
    sides (a probe's timing, never the main path's)."""
    import torch

    cuda = getattr(device, "type", str(device)) == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    out = [0.0]
    t0 = time.perf_counter()
    yield out
    if cuda:
        torch.cuda.synchronize(device)
    out[0] = time.perf_counter() - t0


class ChunkStream:
    """Per-chunk metrics streamed by chunked engine runs.

    Bounded (oldest entries drop past :data:`CAP`): the stream is a
    progress feed, not an archive."""

    CAP = 4096
    _entries: list[dict] = []
    _dropped = 0

    @classmethod
    def record(cls, engine: str, t_end: int, metrics: dict) -> None:
        cls._entries.append(
            {"engine": engine, "t_end": int(t_end), "metrics": metrics}
        )
        if len(cls._entries) > cls.CAP:
            del cls._entries[: len(cls._entries) - cls.CAP]
            cls._dropped += 1

    @classmethod
    def entries(cls, engine: str | None = None) -> list[dict]:
        if engine is None:
            return list(cls._entries)
        return [e for e in cls._entries if e["engine"] == engine]

    @classmethod
    def reset(cls) -> None:
        cls._entries.clear()
        cls._dropped = 0
