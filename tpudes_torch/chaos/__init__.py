"""tpudes_torch.chaos — deterministic failure injection for the serving
layer.

A copy of ``tpudes/chaos/__init__.py`` (``:1-153``) for the port: a
:class:`~tpudes_torch.chaos.schedule.ChaosSchedule`, derivable from one
integer seed, is armed process-globally here; the serving stack calls
:func:`fire` / :func:`filter_frame` / :func:`maybe_fail` at its
injection sites and the schedule decides, by deterministic per-site
ordinals, when a launch fails or a checkpointed run aborts between
chunks.  Nothing is injected unless a schedule is armed (explicitly, or
by ``TPUDES_CHAOS=<seed>``), so the production path pays one ``is None``
check.  The in-process drill is :func:`tpudes_torch.chaos.scenario.
run_local_scenario`; the spawned fleet drill and ``python -m`` replay
wait for A12.
"""

from __future__ import annotations

import os
import time

from tpudes_torch.chaos.schedule import (
    KINDS,
    SITES,
    ChaosEvent,
    ChaosSchedule,
    canonical_schedule,
)

__all__ = [
    "KINDS",
    "SITES",
    "ChaosEvent",
    "ChaosInjected",
    "ChaosSchedule",
    "arm",
    "armed",
    "canonical_schedule",
    "disarm",
    "filter_frame",
    "fire",
    "maybe_fail",
]


class ChaosInjected(RuntimeError):
    """A planted failure fired.  The serving layer treats this as a
    *transient* fault (retry/requeue under the retry budget), mirroring
    how a real launch-time OOM or preempted member would be handled."""


#: the armed schedule; None = chaos off (the production state)
_armed: ChaosSchedule | None = None
_env_checked = False


def arm(schedule: ChaosSchedule) -> ChaosSchedule:
    """Arm ``schedule`` process-globally (replacing any armed one)."""
    global _armed, _env_checked
    _armed = schedule
    _env_checked = True
    return schedule


def disarm() -> None:
    """Disarm (and forget any ``TPUDES_CHAOS`` env arming)."""
    global _armed, _env_checked
    _armed = None
    _env_checked = True


def reset() -> None:
    """Test isolation: drop the armed schedule AND re-read the env on
    the next :func:`armed` call."""
    global _armed, _env_checked
    _armed = None
    _env_checked = False


def armed() -> ChaosSchedule | None:
    """The armed schedule, lazily arming from ``TPUDES_CHAOS=<seed>``
    (+ optional ``TPUDES_CHAOS_MEMBERS=<n>``) on first query — the
    path a spawned member process takes, since it inherits the
    launcher's environment but not its Python state."""
    global _armed, _env_checked
    if not _env_checked:
        _env_checked = True
        raw = os.environ.get("TPUDES_CHAOS")
        if raw:
            try:
                members = int(os.environ.get("TPUDES_CHAOS_MEMBERS", "0"))
                _armed = canonical_schedule(int(raw), members)
            except ValueError:
                _armed = None
    return _armed


def fire(site: str, member: int | None = None,
         tag: object = None) -> ChaosEvent | None:
    """Visit injection ``site``; returns the due event (already counted
    into the schedule's ``injected`` telemetry) or None."""
    sched = armed()
    if sched is None:
        return None
    ev = sched.fire(site, member=member, tag=tag)
    if ev is not None:
        from tpudes_torch.obs.serving import ServingTelemetry

        ServingTelemetry.record_injected(ev.kind)
    return ev


def filter_frame(site: str, blob: bytes,
                 member: int | None = None) -> bytes:
    """Wire-layer injection: pass a framed blob through the armed
    schedule.  ``wire_truncate`` cuts the frame mid-payload and
    ``wire_corrupt`` flips the version byte — both deterministic
    :class:`WireFormatError` shapes at the receiver of A12's
    framed wire, never silent garbage."""
    ev = fire(site, member=member)
    if ev is None:
        return blob
    if ev.kind == "wire_truncate":
        return blob[: max(1, len(blob) // 2)]
    if ev.kind == "wire_corrupt":
        return bytes((blob[0] ^ 0x7F,)) + blob[1:]
    return blob


def maybe_fail(site: str, what: str = "launch",
               member: int | None = None, tag: object = None) -> None:
    """Control-plane injection: raise a compile/OOM-shaped
    :class:`ChaosInjected` (``launch_error`` / ``checkpoint_kill``) or
    sleep (``slow_member``) when the armed schedule says so."""
    ev = fire(site, member=member, tag=tag)
    if ev is None:
        return
    if ev.kind == "launch_error":
        raise ChaosInjected(
            f"RESOURCE_EXHAUSTED: chaos-injected {what} failure at "
            f"{site!r} (compile/OOM shape)"
        )
    if ev.kind == "checkpoint_kill":
        raise ChaosInjected(
            f"chaos-injected kill after checkpoint save at {site!r}"
        )
    if ev.kind == "slow_member":
        time.sleep(float(ev.param or 0.1))
