"""Seed-keyed chaos schedules: every failure scenario is one integer.

A copy of ``tpudes/chaos/schedule.py`` (``:1-213``) for the port, which
imports nothing of the reference.  The site names, the kinds and the
per-site ordinals are the reference's, so one seed fires at the same
points in both packages.

A :class:`ChaosSchedule` is a list of :class:`ChaosEvent` entries, each
"at the ``nth`` visit of injection ``site`` (optionally: by ``member``),
inject ``kind``"; :meth:`ChaosSchedule.from_seed` and
:func:`canonical_schedule` derive the whole list from one seed.

Injection sites (where the serving stack calls
:func:`tpudes_torch.chaos.fire`):

``local_launch``
    the StudyServer dispatching a batch through the local runtime —
    ``launch_error`` raises a launch-shaped
    :class:`~tpudes_torch.chaos.ChaosInjected` before the card sees work.
``member_study``, ``router_send`` / ``router_recv``
    a routed member process and the framed wire to it; the router that
    visits them waits for A12.
``checkpoint_save``
    a chunked run's carry checkpoint just saved — ``checkpoint_kill``
    aborts the run after the save (the resume path's regression hook).

Counters are per-(site, member) ordinals inside one schedule instance.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

__all__ = [
    "KINDS",
    "SITES",
    "ChaosEvent",
    "ChaosSchedule",
    "canonical_schedule",
]

#: failure kinds a schedule may inject
KINDS = frozenset({
    "kill_member", "slow_member", "wire_truncate", "wire_corrupt",
    "launch_error", "checkpoint_kill",
})

#: site -> kinds meaningful there (validated at schedule build)
SITES = {
    "local_launch": {"launch_error"},
    "member_study": {"kill_member", "slow_member"},
    "router_send": {"wire_truncate", "wire_corrupt"},
    "router_recv": {"wire_truncate", "wire_corrupt"},
    "checkpoint_save": {"checkpoint_kill"},
}


@dataclass(frozen=True)
class ChaosEvent:
    """One planted failure: at the ``nth`` (1-based) visit of ``site``
    — counting per member when ``member`` is set, site-wide otherwise —
    inject ``kind``.  ``param`` carries kind-specific detail: the sleep
    seconds for ``slow_member``, the string ``"raise"`` to make
    ``kill_member`` raise instead of SIGKILL (thread-member test mode),
    the engine name filter for ``checkpoint_kill``."""

    kind: str
    site: str
    nth: int
    member: int | None = None
    param: object = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown chaos site {self.site!r}")
        if self.kind not in SITES[self.site]:
            raise ValueError(
                f"kind {self.kind!r} cannot fire at site {self.site!r} "
                f"(supported: {sorted(SITES[self.site])})"
            )
        if self.nth < 1:
            raise ValueError("nth is 1-based and must be >= 1")


class ChaosSchedule:
    """An ordered set of planted failures plus the ordinal counters
    that decide when each fires.  Each event fires AT MOST ONCE."""

    def __init__(self, events: list[ChaosEvent]):
        self.events = list(events)
        #: (site, member) -> visits so far; member None = site-wide
        self._counts: dict[tuple, int] = {}
        self._fired: set[int] = set()
        #: kind -> times injected (recovery-telemetry cross-check)
        self.injected: dict[str, int] = {}

    def fire(self, site: str, member: int | None = None,
             tag: object = None) -> ChaosEvent | None:
        """Record one visit of ``site`` (by ``member``, under ``tag``)
        and return the event due at this ordinal, if any.  An event
        whose ``member`` is set counts that member's visits; a
        ``checkpoint_save`` event whose ``param`` names an engine
        counts that engine's saves (``tag``); otherwise the site-wide
        ordinal decides."""
        n_site = self._counts[(site, None)] = (
            self._counts.get((site, None), 0) + 1
        )
        n_member = None
        if member is not None:
            n_member = self._counts[(site, member)] = (
                self._counts.get((site, member), 0) + 1
            )
        n_tag = None
        if tag is not None:
            tkey = (site, ("tag", tag))
            n_tag = self._counts[tkey] = self._counts.get(tkey, 0) + 1
        for i, ev in enumerate(self.events):
            if i in self._fired or ev.site != site:
                continue
            if ev.site == "checkpoint_save" and ev.param is not None:
                hit = tag == ev.param and n_tag == ev.nth
            elif ev.member is None:
                hit = n_site == ev.nth
            else:
                hit = member == ev.member and n_member == ev.nth
            if hit:
                self._fired.add(i)
                self.injected[ev.kind] = self.injected.get(ev.kind, 0) + 1
                return ev
        return None

    def remaining(self) -> int:
        """Events not yet fired (a finished scenario should usually
        have drained the schedule)."""
        return len(self.events) - len(self._fired)

    @classmethod
    def from_seed(cls, seed: int, members: int = 0,
                  n_events: int = 3) -> "ChaosSchedule":
        """Derive a schedule from one integer: every draw comes from
        ``random.Random(seed)``, so the same (seed, members, n_events)
        always yields the same planted failures."""
        # host-side schedule derivation, deliberately stdlib: chaos
        # schedules live outside the simulation's seeded streams
        rng = random.Random(int(seed))  # tpudes: ignore[RNG002]
        kinds = ["launch_error", "wire_truncate", "wire_corrupt"]
        if members > 0:
            kinds += ["kill_member", "slow_member"]
        events = []
        for _ in range(int(n_events)):
            kind = rng.choice(kinds)
            site = {
                "launch_error": "local_launch",
                "wire_truncate": rng.choice(["router_send", "router_recv"]),
                "wire_corrupt": rng.choice(["router_send", "router_recv"]),
                "kill_member": "member_study",
                "slow_member": "member_study",
            }[kind]
            member = (
                1 + rng.randrange(members)
                if site in ("member_study",) and members > 0
                else None
            )
            param = 0.05 * (1 + rng.randrange(4)) \
                if kind == "slow_member" else None
            events.append(ChaosEvent(
                kind, site, nth=1 + rng.randrange(3), member=member,
                param=param,
            ))
        return cls(events)


def canonical_schedule(seed: int, members: int) -> ChaosSchedule:
    """The fixed replay scenario's schedule (the reference's ``python -m
    tpudes.chaos --replay SEED``, ``schedule.py:188``): with members,
    SIGKILL one seed-chosen member on its FIRST routed study
    (mid-coalesced-batch — the other blocks are in flight); without
    members, plant two seed-placed launch-shaped
    errors (the drill dispatches one study at a time, so both are
    guaranteed to fire).  Pure in (seed, members)."""
    # same stdlib-by-design rationale as from_seed above
    rng = random.Random(int(seed))  # tpudes: ignore[RNG002]
    events = []
    if members > 0:
        victim = 1 + int(seed) % members
        events.append(ChaosEvent(
            "kill_member", "member_study", nth=1, member=victim,
        ))
        events.append(ChaosEvent(
            "launch_error", "local_launch", nth=2 + rng.randrange(2),
        ))
    else:
        events.append(ChaosEvent(
            "launch_error", "local_launch", nth=2 + rng.randrange(3),
        ))
        events.append(ChaosEvent(
            "launch_error", "local_launch", nth=5 + rng.randrange(3),
        ))
    return ChaosSchedule(events)
