"""The port's StudyServer (``tpudes_torch/serving``) against the reference's.

For each engine, the same studies (the reference's toy programs carried
over as numpy fields, the same key) are served by both packages'
servers in their deterministic ``pump`` mode: every study's result must
equal the reference's served result per replica (integers equal, floats
within the engine's stated bounds: bit-equal for the BSS, the dumbbell
and the AS flows, the LTE SINR within 1e-6), the port's batch must be one
counted launch, and the port's coalesced result must equal its own solo
run.  Then the scheduling rules on the port alone: the batching deadline,
admission caps, gold preemption, pow2 batch buckets by tail
duplication, requeue under the retry budget on ``ChaosInjected``,
poisoning of only the failed batch, the warm pool, the schema of the
metrics, and the scheduler thread (``start()``), each with a timeout.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest

import _torch_cpu

import tpudes.chaos as ref_chaos
import tpudes_torch.chaos as chaos
from tpudes.obs.serving import ServingTelemetry as RefTelemetry
from tpudes.parallel import programs as ref_programs
from tpudes.parallel.runtime import RUNTIME as REF_RUNTIME
from tpudes.serving import StudyServer as RefServer
from tpudes_torch.chaos import ChaosEvent, ChaosSchedule
from tpudes_torch.convert import (
    AS_FIELDS,
    BSS_FIELDS,
    DUMBBELL_FIELDS,
    PROGRAM_FIELDS,
    as_from_numpy,
    bss_from_numpy,
    dumbbell_from_numpy,
    program_from_numpy,
)
from tpudes_torch.obs.serving import ServingTelemetry, validate_serving_metrics
from tpudes_torch.parallel.runtime import RUNTIME
from tpudes_torch.serving import AdmissionError, RetryBudgetError, StudyServer

_torch_cpu.one_thread()

SEED = 11
KEY = np.array([0, SEED])
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _fresh():
    for rt in (RUNTIME, REF_RUNTIME):
        rt.clear()
    for tel in (ServingTelemetry, RefTelemetry):
        tel.reset()
    chaos.reset()
    ref_chaos.reset()
    yield
    chaos.reset()
    ref_chaos.reset()
    RUNTIME.clear()


def _fields(prog, names):
    return {k: getattr(prog, k) for k in names}


def _studies(engine):
    """``(reference studies, port studies)``: lists of ``(prog, kwargs)``
    submit_study arguments, one a study."""
    if engine == "lte_sm":
        ref = ref_programs.toy_lte_program(n_enb=2, n_ue=4, n_ttis=60)
        progs = [dataclasses.replace(ref, scheduler=s)
                 for s in ("pf", "rr", "fdmt")]
        port = [program_from_numpy(_fields(p, PROGRAM_FIELDS))
                for p in progs]
        return [(p, {}) for p in progs], [(p, {}) for p in port], 3
    if engine == "bss":
        ref = ref_programs.toy_bss_program(n_sta=4, sim_end_us=40_000)
        progs = [dataclasses.replace(ref, sim_end_us=e)
                 for e in (40_000, 60_000)]
        port = [bss_from_numpy(_fields(p, BSS_FIELDS)) for p in progs]
        return [(p, {}) for p in progs], [(p, {}) for p in port], 5
    if engine == "dumbbell":
        from tpudes.parallel.tcp_dumbbell import VARIANTS, _variant_ecn

        ref = ref_programs.toy_dumbbell_program(n_flows=3, n_slots=120)
        progs = []
        for v in ("TcpNewReno", "TcpCubic", "TcpBic"):
            ids = np.full(3, VARIANTS.index(v), np.int32)
            progs.append(dataclasses.replace(ref, variant_idx=ids,
                                             ecn=_variant_ecn(ids)))
        port = [dumbbell_from_numpy(_fields(p, DUMBBELL_FIELDS))
                for p in progs]
        return [(p, {}) for p in progs], [(p, {}) for p in port], 3
    ref = ref_programs.toy_as_program(n_nodes=64, n_flows=3)
    port = as_from_numpy(_fields(ref, AS_FIELDS))
    scales = (1.0, 4.0, 16.0)
    return ([(ref, dict(rate_scale=s)) for s in scales],
            [(port, dict(rate_scale=s)) for s in scales], 4)


def _serve(server_cls, engine, studies, replicas, key, **kw):
    with server_cls(start=False) as server:
        handles = [server.submit_study(engine, p, key, replicas,
                                       tenant=f"t{i}", **extra, **kw)
                   for i, (p, extra) in enumerate(studies)]
        server.pump()
        out = [h.result(timeout=60) for h in handles]
        sizes = [h.batch_size for h in handles]
        metrics = server.metrics()
    return out, sizes, metrics


def _assert_same(engine, got: dict, want: dict):
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, (engine, k)
        if engine == "lte_sm" and k == "sinr":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        elif w.dtype.kind == "f":
            assert np.array_equal(g.view(np.int32) if g.dtype == np.float32
                                  else g, w.view(np.int32)
                                  if w.dtype == np.float32 else w), (
                engine, k)
        else:
            assert np.array_equal(g, w), (engine, k)


@pytest.mark.parametrize("engine", ["lte_sm", "bss", "dumbbell", "as_flows"])
def test_served_studies_equal_the_reference_per_replica(engine):
    ref_studies, port_studies, R = _studies(engine)
    want, _, _ = _serve(RefServer, engine, ref_studies, R,
                        jax.random.PRNGKey(SEED))
    got, sizes, metrics = _serve(StudyServer, engine, port_studies, R, KEY,
                                 **CPU)
    assert RUNTIME.launches(engine) == 1, "one batch, one counted launch"
    assert sizes == [len(port_studies)] * len(port_studies)
    assert metrics["counters"]["coalesced_launches"] == 1
    for g, w in zip(got, want):
        _assert_same(engine, g, w)


# --- the scheduling rules, on the port ---------------------------------------


def _tcp(n_slots=60):
    from tpudes_torch.parallel.programs import toy_dumbbell_program

    return toy_dumbbell_program(n_flows=3, n_slots=n_slots)


def _variant(prog, name):
    from tpudes_torch.parallel.tcp_dumbbell import (
        VARIANTS,
        variant_ecn,
    )

    ids = np.full(prog.n_flows, VARIANTS.index(name), np.int32)
    return dataclasses.replace(prog, variant_idx=ids, ecn=variant_ecn(ids))


def test_coalesced_results_equal_solo_runs_with_a_pow2_pad():
    from tpudes_torch.parallel.tcp_dumbbell import run_tcp_dumbbell

    progs = [_variant(_tcp(), v)
             for v in ("TcpNewReno", "TcpCubic", "TcpHtcp")]
    with StudyServer(start=False) as server:
        handles = [server.submit_study("dumbbell", p, KEY, 3, **CPU)
                   for p in progs]
        server.pump()
        m = server.metrics()
    assert m["counters"]["pad_points"] == 1  # 3 studies -> a bucket of 4
    assert m["engines"]["dumbbell"]["batch_occupancy"] == 0.75
    for h, p in zip(handles, progs):
        solo = run_tcp_dumbbell(p, KEY, 3, **CPU)
        for k in solo:
            assert np.array_equal(h.result(timeout=10)[k], solo[k]), k


def test_ecn_mismatch_is_served_alone():
    prog = dataclasses.replace(_variant(_tcp(), "TcpCubic"),
                               ecn=np.ones(3, bool))
    with StudyServer(start=False) as server:
        a = server.submit_study("dumbbell", prog, KEY, 2, **CPU)
        b = server.submit_study("dumbbell", _variant(_tcp(), "TcpCubic"),
                                KEY, 2, **CPU)
        server.pump()
        assert a.result(timeout=10) is not None
        assert a.batch_size == 1 and b.batch_size == 1
    assert RUNTIME.launches("dumbbell") == 2


def test_lone_study_goes_at_its_deadline():
    server = StudyServer(start=False, max_wait_s=0.05, max_batch=8)
    h = server.submit_study("dumbbell", _tcp(), KEY, 2, **CPU)
    assert server.pump(force=False) == 0, "not due before its deadline"
    time.sleep(0.06)
    assert server.pump(force=False) == 1
    assert h.batch_size == 1
    server.close()


def test_gold_preempts_the_batching_deadline():
    server = StudyServer(start=False, max_wait_s=60.0, max_batch=8)
    std = server.submit_study("dumbbell", _variant(_tcp(), "TcpCubic"), KEY,
                              2, **CPU)
    gold = server.submit_study("dumbbell", _variant(_tcp(), "TcpBic"), KEY,
                               2, slo="gold", **CPU)
    assert server.pump(force=False) == 2, "gold dispatches with its mates"
    assert gold.batch_size == 2 and std.done()
    m = server.metrics()
    assert m["slo"]["gold"]["studies"] == 1
    server.close()


def test_admission_cap_rejects_and_is_counted():
    server = StudyServer(start=False, tenant_cap=2)
    for _ in range(2):
        server.submit_study("dumbbell", _tcp(), KEY, 2, tenant="a", **CPU)
    with pytest.raises(AdmissionError):
        server.submit_study("dumbbell", _tcp(), KEY, 2, tenant="a", **CPU)
    server.submit_study("dumbbell", _tcp(), KEY, 2, tenant="b", **CPU)
    server.close()
    assert server.metrics()["counters"]["rejected"] == 1
    with pytest.raises(RuntimeError, match="closed"):
        server.submit_study("dumbbell", _tcp(), KEY, 2, **CPU)


def test_chaos_launch_error_requeues_within_the_budget():
    from tpudes_torch.parallel.tcp_dumbbell import run_tcp_dumbbell

    chaos.arm(ChaosSchedule([ChaosEvent("launch_error", "local_launch",
                                        nth=1)]))
    prog = _variant(_tcp(), "TcpVegas")
    with StudyServer(start=False, retry_backoff_s=0.0) as server:
        h = server.submit_study("dumbbell", prog, KEY, 2, **CPU)
        server.pump()
        got = h.result(timeout=10)
        f = server.metrics()["failures"]
    assert f["requeued_batches"] == 1 and f["injected_launch_error"] == 1
    for k, v in run_tcp_dumbbell(prog, KEY, 2, **CPU).items():
        assert np.array_equal(got[k], v), k


def test_retry_budget_exhaustion_surfaces_through_the_handle():
    chaos.arm(ChaosSchedule([ChaosEvent("launch_error", "local_launch",
                                        nth=n) for n in (1, 2)]))
    with StudyServer(start=False, retry_budget=1,
                     retry_backoff_s=0.0) as server:
        h = server.submit_study("dumbbell", _tcp(), KEY, 2, **CPU)
        server.pump()
        with pytest.raises(RetryBudgetError):
            h.result(timeout=10)
    assert server.metrics()["failures"]["retry_budget_exhausted"] == 1


def test_a_failing_batch_poisons_only_its_handles():
    from tpudes_torch.serving import StudyDescriptor

    def broken(points, block=False):
        raise ValueError("broken program")

    bad = StudyDescriptor("dumbbell", ("bad",), 0, broken)
    with StudyServer(start=False) as server:
        hb = server.submit(bad)
        ok = server.submit_study("dumbbell", _tcp(), KEY, 2, **CPU)
        server.pump()
        with pytest.raises(ValueError, match="broken"):
            hb.result(timeout=10)
        assert ok.result(timeout=10)["delivered"].shape == (2, 3)


def test_warm_pool_fills_the_runner_cache():
    server = StudyServer(start=False, max_batch=4)
    n = server.warm([dict(engine="dumbbell", prog=_tcp(), key=KEY,
                          replicas=2, **CPU)])
    assert n == 3  # batch buckets 1, 2 and 4
    misses = RUNTIME.misses
    h = server.submit_study("dumbbell", _tcp(), KEY, 2, **CPU)
    server.pump()
    h.result(timeout=10)
    assert RUNTIME.misses == misses, "a warmed bucket is a hit"
    server.close()
    assert server.metrics()["counters"]["warm_programs"] == 3


def test_metrics_validate_against_the_schema():
    with StudyServer(start=False) as server:
        server.submit_study("dumbbell", _tcp(), KEY, 2, **CPU)
        server.pump()
        doc = server.metrics()
    assert validate_serving_metrics(doc) == []
    assert validate_serving_metrics({"version": 2}) != []


def test_scheduler_thread_serves_and_closes():
    server = StudyServer(max_wait_s=0.001, max_batch=4)
    try:
        handles = [server.submit_study("dumbbell", _variant(_tcp(), v), KEY,
                                       2, **CPU)
                   for v in ("TcpNewReno", "TcpCubic")]
        for h in handles:
            assert h.result(timeout=60)["delivered"].shape == (2, 3)
    finally:
        server.close()
    assert server.metrics()["counters"]["completed"] == 2
