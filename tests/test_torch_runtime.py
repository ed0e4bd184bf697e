"""The port's engine runtime (``tpudes_torch/parallel/runtime.py``) against
the reference's.

- The runtime's own rules: pow2 buckets and ``TPUDES_BUCKETING``, the
  in-flight window, chunk bounds, and the runner registry's true LRU
  order, hits, misses and ``stats()`` keys, driven through the same
  calls as the reference's registry.
- Replica buckets: at R = 3 and 5 with bucketing on, the BSS engine
  equals the reference on every output, ``steps`` included (ROADMAP C1),
  and the hybrid PDES on its outcomes and its ``windows`` (C5).
- The runner caches: every entry's first call is a miss and the next
  two hits, bit-equal to the miss; each cache key moves with exactly the
  program fields the reference's key function moves with (a one-field
  flip of every field, the JXL004 check of ``tpudes/parallel/wired.py``);
  and a launch that writes into a cached table makes a hit differ from
  its miss, which the miss-hit-hit comparison catches.
- Submitted runs: ``block=False`` returns an ``EngineFuture`` whose
  result equals the blocking run; ``RUNTIME.submit`` keeps the in-flight
  window.
"""

import dataclasses

import jax
import numpy as np
import pytest

from tpudes.parallel import programs as ref_programs
from tpudes.parallel import runtime as ref_runtime
from tpudes_torch.convert import (
    AS_FIELDS,
    BSS_FIELDS,
    DUMBBELL_FIELDS,
    PROGRAM_FIELDS,
    WIRED_FIELDS,
    as_from_numpy,
    bss_from_numpy,
    dumbbell_from_numpy,
    program_from_numpy,
    wired_from_numpy,
)
from tpudes_torch.parallel import runtime
from tpudes_torch.parallel.runtime import RUNTIME, EngineFuture

KEY = np.array([0, 5])


@pytest.fixture(autouse=True)
def _fresh():
    RUNTIME.clear()
    ref_runtime.RUNTIME.clear()
    yield
    RUNTIME.clear()
    ref_runtime.RUNTIME.clear()


def _fields(prog, names):
    return {k: getattr(prog, k) for k in names}


# --- the runtime's own rules -------------------------------------------------


@pytest.mark.parametrize("env", [None, "0", "off", "1"])
def test_buckets_follow_the_reference(env, monkeypatch):
    if env is not None:
        monkeypatch.setenv("TPUDES_BUCKETING", env)
    for r in (None, 1, 2, 3, 5, 8, 9, 1000):
        assert runtime.bucket_replicas(r) == ref_runtime.bucket_replicas(r)
    assert runtime.bucketing_enabled() == ref_runtime.bucketing_enabled()


@pytest.mark.parametrize("env", [None, "", "1", "7", "x"])
def test_inflight_window_follows_the_reference(env, monkeypatch):
    if env is not None:
        monkeypatch.setenv("TPUDES_INFLIGHT", env)
    assert runtime.inflight_window() == ref_runtime.inflight_window()


@pytest.mark.parametrize("total, chunk", [(10, 4), (10, 10), (10, 0),
                                          (120, 40), (7, 100), (0, 3)])
def test_chunk_bounds_follow_the_reference(total, chunk):
    assert runtime.chunk_bounds(total, chunk) == ref_runtime.chunk_bounds(
        total, chunk)


def test_lru_order_hits_misses_and_stats_match_the_reference():
    port, ref = runtime.EngineRuntime(capacity=3), \
        ref_runtime.EngineRuntime(capacity=3)
    calls = [("a", (1,)), ("b", (1,)), ("a", (1,)), ("c", (2,)),
             ("d", (3,)), ("b", (1,)), ("a", (1,)), ("c", (2,))]
    for rt in (port, ref):
        for i, (engine, key) in enumerate(calls):
            rt.runner(engine, key, lambda i=i: i)
        rt.record_launch("a", 2)
    assert port.stats() == ref.stats()
    assert list(port._runners) == list(ref._runners)
    assert port.size("a") == ref.size("a")
    port.clear("a")
    ref.clear("a")
    assert port.stats() == ref.stats()
    port.clear()
    ref.clear()
    assert port.stats() == ref.stats()


# --- replica buckets at odd R ------------------------------------------------


@pytest.mark.parametrize("replicas", [3, 5])
def test_bucketed_bss_equals_the_reference_steps_included(replicas):
    from tpudes.parallel.replicated import run_replicated_bss as ref_run
    from tpudes_torch.parallel.replicated import run_replicated_bss

    ref = ref_programs.toy_bss_program(n_sta=4, sim_end_us=60_000)
    want = ref_run(ref, replicas, jax.random.PRNGKey(2))
    got = run_replicated_bss(bss_from_numpy(_fields(ref, BSS_FIELDS)),
                             replicas, np.array([0, 2]), device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


@pytest.mark.parametrize("replicas", [3, 5])
def test_bucketed_hybrid_equals_the_reference_windows_included(replicas):
    from tpudes.fuzz.engines import ENGINE_FUZZERS, scenario_key
    from tpudes.fuzz.envelope import ScenarioGen
    from tpudes.parallel.hybrid import run_hybrid as ref_hybrid
    from tpudes_torch.parallel.hybrid import run_hybrid

    fuzzer = ENGINE_FUZZERS["wired"]
    cfg = dict(fuzzer.envelope.draw(ScenarioGen(1)), replicas=replicas)
    prog = fuzzer.build(cfg)
    want = ref_hybrid(prog, scenario_key(cfg), replicas, ranks=2,
                      transport="local")
    got = run_hybrid(wired_from_numpy(_fields(prog, WIRED_FIELDS)),
                     np.array([0, int(cfg["key_seed"])]), replicas, ranks=2,
                     transport="local", device="cpu")
    for k in ("deliver_slot", "delivered", "served", "windows"):
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


# --- the runner caches -------------------------------------------------------


def _lte_prog():
    return program_from_numpy(_fields(
        ref_programs.toy_lte_program(n_enb=2, n_ue=4, n_ttis=40),
        PROGRAM_FIELDS))


def _bss_prog():
    return bss_from_numpy(_fields(
        ref_programs.toy_bss_program(n_sta=4, sim_end_us=30_000),
        BSS_FIELDS))


def _tcp_prog():
    return dumbbell_from_numpy(_fields(
        ref_programs.toy_dumbbell_program(n_flows=3, n_slots=60),
        DUMBBELL_FIELDS))


def _as_prog():
    return as_from_numpy(_fields(
        ref_programs.toy_as_program(n_nodes=64, n_flows=3), AS_FIELDS))


def _wired_prog():
    from tpudes_torch.parallel.wired import wired_weak_chain

    return wired_weak_chain(2, links_per_rank=3, flows_per_rank=2,
                            period=40, n_slots=600, jitter_slots=3)


def _entry(name):
    """``(engine, run(**kw))`` of one of the six entries on the CPU."""
    from tpudes_torch.parallel.as_flows import run_as_flows
    from tpudes_torch.parallel.hybrid import run_hybrid
    from tpudes_torch.parallel.lte_sm import run_lte_sm
    from tpudes_torch.parallel.replicated import run_replicated_bss
    from tpudes_torch.parallel.tcp_dumbbell import run_tcp_dumbbell
    from tpudes_torch.parallel.wired import run_wired

    cpu = dict(device="cpu")
    return {
        "lte_sm": ("lte_sm", lambda **kw: run_lte_sm(
            _lte_prog(), KEY, replicas=3, schedulers=["pf", "rr"], **cpu,
            **kw)),
        "bss": ("bss", lambda **kw: run_replicated_bss(
            _bss_prog(), 3, KEY, **cpu, **kw)),
        "dumbbell": ("dumbbell", lambda **kw: run_tcp_dumbbell(
            _tcp_prog(), KEY, 3, **cpu, **kw)),
        "as_flows": ("as_flows", lambda **kw: run_as_flows(
            _as_prog(), KEY, 3, rate_scale=[1.0, 8.0], **cpu, **kw)),
        "wired": ("wired", lambda **kw: run_wired(
            _wired_prog(), KEY, 3, window_slots=200, **cpu, **kw)),
        "hybrid": ("wired_hybrid", lambda **kw: run_hybrid(
            _wired_prog(), KEY, 3, transport="local", **cpu, **kw)),
    }[name]


def _same(a, b) -> bool:
    a = a if isinstance(a, list) else [a]
    b = b if isinstance(b, list) else [b]
    return len(a) == len(b) and all(
        set(x) == set(y) and all(
            np.array_equal(np.asarray(x[k]), np.asarray(y[k])) for k in x)
        for x, y in zip(a, b))


def miss_hit_hit(run) -> tuple:
    """Three runs from a cleared cache: ``(first, second, third)``."""
    RUNTIME.clear()
    return run(), run(), run()


ENTRIES = ["lte_sm", "bss", "dumbbell", "as_flows", "wired", "hybrid"]


@pytest.mark.parametrize("name", ENTRIES)
def test_hits_are_bit_equal_to_the_miss(name):
    engine, run = _entry(name)
    hits = RUNTIME.hits
    miss, hit1, hit2 = miss_hit_hit(run)
    assert _same(miss, hit1) and _same(miss, hit2)
    assert RUNTIME.size(engine) >= 1
    assert RUNTIME.hits > hits


def test_a_launch_writing_into_a_cached_table_is_caught(monkeypatch):
    """The mutant: the AS fluid launch scales the cached link capacities
    after it runs, so only the second call sees the change."""
    from tpudes_torch.parallel import as_cuda

    _, run = _entry("as_flows")
    miss, hit1, _ = miss_hit_hit(run)
    assert _same(miss, hit1)
    real = as_cuda.fluid_launch

    def mutant(t, *args, **kw):
        out = real(t, *args, **kw)
        t["c"].mul_(2.0)
        t["blob"][-1] += 1
        return out

    monkeypatch.setattr(as_cuda, "fluid_launch", mutant)
    miss, hit1, _ = miss_hit_hit(run)
    assert not _same(miss, hit1), "a write into a cached table must show"


_STRINGS = {"fifo": "red", "red": "fifo", "hops": "delay", "delay": "hops",
            "f32": "bf16", "bf16": "f32", "pf": "rr", "rr": "pf"}


def _flip(v):
    if isinstance(v, np.ndarray):
        return ~v if v.dtype == bool else v + np.ones_like(v)
    if isinstance(v, (bool, np.bool_)):
        return not v
    if isinstance(v, (int, np.integer)):
        return v + 1
    if isinstance(v, (float, np.floating)):
        return v * 1.5 + 1.0
    if isinstance(v, str) and v in _STRINGS:
        return _STRINGS[v]
    return None


def _key_fns(engine):
    """``(reference program, port-from-reference, ref key, port key)``."""
    if engine == "lte_sm":
        from tpudes.parallel.lte_sm import _sm_cache_key
        from tpudes_torch.parallel.lte_sm import _sm_prog_key

        return (ref_programs.toy_lte_program(),
                lambda p: program_from_numpy(_fields(p, PROGRAM_FIELDS)),
                lambda p: _sm_cache_key(p, 4, None, False, True),
                _sm_prog_key)
    if engine == "bss":
        from tpudes.parallel.replicated import _prog_cache_key as ref_key
        from tpudes_torch.parallel.replicated import _prog_cache_key

        return (ref_programs.toy_bss_program(),
                lambda p: bss_from_numpy(_fields(p, BSS_FIELDS)),
                ref_key, _prog_cache_key)
    if engine in ("dumbbell", "dumbbell_red"):
        from tpudes.parallel.tcp_dumbbell import dumbbell_prog_key as ref_key
        from tpudes_torch.parallel.tcp_dumbbell import dumbbell_prog_key

        prog = ref_programs.toy_dumbbell_program()
        if engine == "dumbbell_red":
            prog = dataclasses.replace(prog, qdisc="red")
        return (prog, lambda p: dumbbell_from_numpy(_fields(
            p, DUMBBELL_FIELDS)), ref_key, dumbbell_prog_key)
    if engine == "as_flows":
        from tpudes.parallel.as_flows import as_prog_key as ref_key
        from tpudes_torch.parallel.as_flows import as_prog_key

        return (ref_programs.toy_as_program(),
                lambda p: as_from_numpy(_fields(p, AS_FIELDS)), ref_key,
                as_prog_key)
    from tpudes.parallel.wired import wired_cache_key as ref_key
    from tpudes_torch.parallel.wired import wired_cache_key

    from tpudes.parallel.wired import wired_chain

    return (wired_chain(), lambda p: wired_from_numpy(_fields(
        p, WIRED_FIELDS)), ref_key, wired_cache_key)


#: fields the port keys on and the reference does not: the AS node count
#: (the reference's ``as_prog_key`` leaves it out; a stronger key)
STRONGER = {"as_flows": {"n"}}


@pytest.mark.parametrize("engine", ["lte_sm", "bss", "dumbbell",
                                    "dumbbell_red", "as_flows", "wired"])
def test_cache_keys_move_with_the_reference_fields(engine):
    prog, to_port, ref_key, port_key = _key_fns(engine)
    base_ref, base_port = ref_key(prog), port_key(to_port(prog))
    checked = 0
    for f in dataclasses.fields(prog):
        new = _flip(getattr(prog, f.name))
        if new is None:
            continue
        try:
            flipped = dataclasses.replace(prog, **{f.name: new})
            port_prog = to_port(flipped)
        except (ValueError, TypeError, KeyError, IndexError):
            continue
        ref_moved = ref_key(flipped) != base_ref
        port_moved = port_key(port_prog) != base_port
        if f.name in STRONGER.get(engine, ()):
            assert port_moved, f.name
        else:
            assert port_moved == ref_moved, (engine, f.name, ref_moved)
        checked += 1
    assert checked >= 5


# --- submitted runs ----------------------------------------------------------


@pytest.mark.parametrize("name", ["lte_sm", "bss", "dumbbell", "as_flows",
                                  "wired"])
def test_block_false_is_a_future_equal_to_the_blocking_run(name):
    _, run = _entry(name)
    fut = run(block=False)
    assert isinstance(fut, EngineFuture)
    assert fut.done(), "a CPU run is done when it returns"
    assert _same(fut.result(), run())
    assert fut.result() is fut.result(), "memoised"


def test_submit_keeps_the_inflight_window(monkeypatch):
    monkeypatch.setenv("TPUDES_INFLIGHT", "2")
    from tpudes_torch.parallel.tcp_dumbbell import run_tcp_dumbbell

    futs = [RUNTIME.submit(run_tcp_dumbbell, _tcp_prog(), np.array([0, i]),
                           2, device="cpu") for i in range(3)]
    s = RUNTIME.stats()
    assert s["max_in_flight"] == 2 and s["submitted"] == 3
    assert s["retired"] == 1 and s["in_flight"] == 2
    assert RUNTIME.poll() == 2
    RUNTIME.drain()
    assert RUNTIME.stats()["retired"] == 3
    assert set(RUNTIME.stats()) == set(ref_runtime.RUNTIME.stats())
    assert futs[0].result()["delivered"].shape == (2, 3)
    with pytest.raises(TypeError, match="EngineFuture"):
        RUNTIME.submit(lambda block: None)
