"""The port's chaos layer (``tpudes_torch/chaos``) against the reference's.

The schedules are copies of the reference's: one seed must give the
same planted events in both packages, fire at the same per-site,
per-member and per-engine ordinals, and mangle a frame the same way.
The in-process drill (``run_local_scenario``) must give, for the same
seed, the reference's failure and recovery counters, every study
completed and equal to its solo run.
"""

import pytest

import tpudes.chaos as ref_chaos
import tpudes_torch.chaos as chaos
from tpudes.chaos.scenario import run_local_scenario as ref_scenario
from tpudes.obs.serving import ServingTelemetry as RefTelemetry
from tpudes.parallel.runtime import RUNTIME as REF_RUNTIME
from tpudes_torch.chaos import (
    ChaosEvent,
    ChaosInjected,
    ChaosSchedule,
    canonical_schedule,
)
from tpudes_torch.chaos.scenario import run_local_scenario
from tpudes_torch.obs.serving import ServingTelemetry, validate_serving_metrics
from tpudes_torch.parallel.runtime import RUNTIME


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (chaos, ref_chaos):
        mod.reset()
    for tel in (ServingTelemetry, RefTelemetry):
        tel.reset()
    yield
    for mod in (chaos, ref_chaos):
        mod.reset()
    ServingTelemetry.reset()
    RUNTIME.clear()
    REF_RUNTIME.clear()


def _events(schedule):
    return [(e.kind, e.site, e.nth, e.member, e.param)
            for e in schedule.events]


@pytest.mark.parametrize("seed", [0, 7, 42, 2**31 - 1])
@pytest.mark.parametrize("members", [0, 2, 5])
def test_schedules_from_a_seed_equal_the_reference(seed, members):
    assert _events(ChaosSchedule.from_seed(seed, members)) == _events(
        ref_chaos.ChaosSchedule.from_seed(seed, members))
    assert _events(canonical_schedule(seed, members)) == _events(
        ref_chaos.canonical_schedule(seed, members))


def test_kinds_and_sites_equal_the_reference():
    assert chaos.KINDS == ref_chaos.KINDS
    assert chaos.SITES == ref_chaos.SITES


def test_ordinals_fire_where_the_reference_fires():
    def visits(mod):
        s = mod.ChaosSchedule([
            mod.ChaosEvent("launch_error", "local_launch", nth=3),
            mod.ChaosEvent("kill_member", "member_study", nth=2, member=2),
            mod.ChaosEvent("checkpoint_kill", "checkpoint_save", nth=1,
                           param="lte_sm"),
        ])
        seq = [("local_launch", None, None)] * 4 + [
            ("member_study", 1, None), ("member_study", 2, None),
            ("member_study", 1, None), ("member_study", 2, None),
            ("checkpoint_save", None, "dumbbell"),
            ("checkpoint_save", None, "lte_sm"),
        ]
        fired = [s.fire(site, member=m, tag=t) for site, m, t in seq]
        return ([None if e is None else e.kind for e in fired], s.injected,
                s.remaining())

    assert visits(chaos) == visits(ref_chaos)
    kinds, injected, remaining = visits(chaos)
    assert kinds.count("launch_error") == 1 and remaining == 0


def test_invalid_events_refused():
    with pytest.raises(ValueError, match="site"):
        ChaosEvent("launch_error", "nowhere", nth=1)
    with pytest.raises(ValueError, match="cannot fire"):
        ChaosEvent("kill_member", "local_launch", nth=1)
    with pytest.raises(ValueError, match="nth"):
        ChaosEvent("launch_error", "local_launch", nth=0)


def test_env_arming_and_reset(monkeypatch):
    monkeypatch.setenv("TPUDES_CHAOS", "9")
    monkeypatch.setenv("TPUDES_CHAOS_MEMBERS", "2")
    chaos.reset()
    assert _events(chaos.armed()) == _events(canonical_schedule(9, 2))
    monkeypatch.delenv("TPUDES_CHAOS")
    chaos.reset()
    assert chaos.armed() is None


@pytest.mark.parametrize("kind, site", [("wire_truncate", "router_recv"),
                                        ("wire_corrupt", "router_send")])
def test_filter_frame_mangles_as_the_reference(kind, site):
    blob = bytes(range(1, 41))
    out = []
    for mod in (chaos, ref_chaos):
        mod.arm(mod.ChaosSchedule([mod.ChaosEvent(kind, site, nth=1)]))
        out.append(mod.filter_frame(site, blob))
        mod.disarm()
    assert out[0] == out[1] != blob
    assert chaos.filter_frame(site, blob) == blob, "unarmed: identity"


def test_maybe_fail_raises_and_counts():
    chaos.arm(ChaosSchedule([ChaosEvent("launch_error", "local_launch",
                                        nth=1)]))
    with pytest.raises(ChaosInjected, match="RESOURCE_EXHAUSTED"):
        chaos.maybe_fail("local_launch")
    chaos.maybe_fail("local_launch")  # single-shot
    f = ServingTelemetry.snapshot()["failures"]
    assert f["injected_failures"] == 1 and f["injected_launch_error"] == 1


@pytest.mark.parametrize("seed", [7])
def test_local_drill_gives_the_reference_counters(seed):
    want = ref_scenario(seed, n_studies=4)
    got = run_local_scenario(seed, n_studies=4, device="cpu")
    assert got["completed"] == want["completed"] == 4
    assert got["equal"] and want["equal"]
    assert got["injected"] == want["injected"]
    assert got["telemetry"]["failures"] == want["telemetry"]["failures"]
    assert got["telemetry"]["failures"]["requeued_studies"] >= 1
    assert validate_serving_metrics(got["telemetry"]) == []
