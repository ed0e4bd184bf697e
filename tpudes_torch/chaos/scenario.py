"""The in-process chaos drill: a replayable serving scenario.

Counterpart of ``tpudes/chaos/scenario.py::run_local_scenario``
(``:79``): an in-process :class:`~tpudes_torch.serving.StudyServer`, in
its deterministic ``pump`` mode, under seed-planted launch errors
(:func:`~tpudes_torch.chaos.schedule.canonical_schedule` without
members); every study must complete through requeue and retry, equal to
its solo run.  Same seed, same injected failures, same recovery
counters — the reference's, as one seed fires at the same ordinals in
both packages.  The spawned fleet drill (``run_scenario``,
``chaos_serving_rank``) and ``python -m tpudes.chaos`` wait for A12.
"""

from __future__ import annotations

__all__ = ["run_local_scenario"]

#: studies a scenario runs (``scenario.py:28``)
N_STUDIES = 6


def _bss_studies(n_studies: int):
    """The reference's drill studies (``scenario.py:31``): the toy BSS,
    key 3, one horizon a study."""
    from tpudes_torch.parallel.programs import toy_bss_program
    from tpudes_torch.random import PRNGKey

    prog = toy_bss_program(n_sta=4, sim_end_us=40_000)
    horizons = [40_000 + 2_000 * i for i in range(n_studies)]
    return prog, PRNGKey(3).numpy(), horizons


def _serve_and_check(server, prog, key, horizons, timeout_s: float,
                     device, pump_each: bool = False):
    """Submit one BSS study a horizon, pump to the end, and compare every
    result with a solo run (``scenario.py:42``)."""
    import dataclasses

    import numpy as np

    from tpudes_torch.parallel.replicated import run_replicated_bss

    handles = []
    for i, h in enumerate(horizons):
        handles.append(server.submit_study(
            "bss", dataclasses.replace(prog, sim_end_us=h), key, 2,
            tenant=f"t{i}", slo="gold" if i == 0 else "standard",
            device=device,
        ))
        if pump_each:
            server.pump(force=True)
    server.pump(force=True)
    completed = equal = 0
    for h, handle in zip(horizons, handles):
        res = handle.result(timeout=timeout_s)
        completed += 1
        solo = run_replicated_bss(dataclasses.replace(prog, sim_end_us=h), 2,
                                  key, device=device)
        if all(np.array_equal(np.asarray(res[k]), np.asarray(solo[k]))
               for k in solo):
            equal += 1
    return completed, equal


def run_local_scenario(seed: int, n_studies: int = N_STUDIES,
                       device=None) -> dict:
    """The in-process drill (``scenario.py:79``): seed-planted launch
    errors against a ``start=False`` StudyServer, the studies on
    ``device`` (the card by default).  Returns ``completed``, ``equal``
    (every study equal to its solo run), ``injected`` and the serving
    telemetry's snapshot."""
    import tpudes_torch.chaos as chaos
    from tpudes_torch.obs.serving import ServingTelemetry
    from tpudes_torch.serving import StudyServer

    prog, key, horizons = _bss_studies(n_studies)
    ServingTelemetry.reset()
    chaos.arm(chaos.canonical_schedule(seed, members=0))
    try:
        with StudyServer(start=False, retry_backoff_s=0.005,
                         retry_budget=3) as server:
            completed, equal = _serve_and_check(
                server, prog, key, horizons, timeout_s=120.0,
                device=device, pump_each=True,
            )
            snapshot = server.metrics()
    finally:
        chaos.disarm()
    return dict(
        completed=completed,
        equal=equal == n_studies,
        injected=dict(chaos=snapshot["failures"]["injected_failures"]),
        telemetry=snapshot,
    )
