"""The port against the reference on fuzz-drawn configurations.

For each ported engine — the TCP dumbbell, the WiFi BSS, the LTE SM
engine and the AS flow engine — a few configurations are drawn by seed from the reference
fuzzer's envelope (``tpudes/fuzz/engines.py``: ``DumbbellFuzzer``
``:778``, ``BssFuzzer`` ``:376``, ``LteSmFuzzer`` ``:545``), built with
the fuzzer's own ``build`` (the reference's scenario builders and
lowerings), run through the JAX engine (the fuzzer's ``run_scalar``) and
through the port on the CPU with the same key, and compared with the
fuzzer's ``first_diff`` (``:70``), whose report names the first
diverging field, index and values.

Compared bit for bit: the dumbbell's every output; the BSS's
``outcome_fields`` (its ``steps`` differs where R is not a power of two,
ROADMAP C1); the LTE engine's integer and traffic outputs, its ``sinr``
to a relative 1e-6 (the bound of the port's LTE tests).  A random-walk
BSS draw takes the reference's walk velocities (ROADMAP C3, an ulp in
about one value of 75).  The dumbbell's app-limited ``traffic`` draws
run too (``DumbbellProgram.traffic`` crosses with the program).  The AS
flow engine's draws take ``surrogate="off"`` (the smooth surrogate is not
ported, ROADMAP A14) and are compared bit for bit in every output, their
workload draws included.  The wired engine's draws (two-partition chains,
deterministic CBR, ``wired.py:149``) run the reference's 2-rank hybrid
protocol and the port's (``run_hybrid(..., ranks=2, transport="local")``)
and are compared bit for bit in ``deliver_slot``, ``delivered`` and
``served``, with the port's ``run_wired`` too, and in the number of
windows with the reference's replica bucketing off (its padded replicas
join the grant, so where R is not a power of two its window schedule can
differ; ROADMAP C5).  One draw per engine also runs through
``block=False`` (an ``EngineFuture``), equal to its blocking run.
"""

import numpy as np
import pytest
import torch

from tpudes.fuzz.engines import ENGINE_FUZZERS, first_diff
from tpudes.fuzz.envelope import ScenarioGen
from tpudes.ops.mobility import MobilityProgram as JaxMobility
from tpudes.ops.mobility import walk_segment_velocities as jax_walk
from tpudes_torch.convert import (
    AS_FIELDS,
    BSS_FIELDS,
    DUMBBELL_FIELDS,
    MOBILITY_FIELDS,
    PROGRAM_FIELDS,
    TRAFFIC_FIELDS,
    WIRED_FIELDS,
    as_from_numpy,
    bss_from_numpy,
    dumbbell_from_numpy,
    mobility_from_numpy,
    program_from_numpy,
    traffic_from_numpy,
    wired_from_numpy,
)
from tpudes_torch.ops import mobility as port_mobility
from tpudes_torch.parallel.as_flows import run_as_flows
from tpudes_torch.parallel.hybrid import run_hybrid
from tpudes_torch.parallel.lte_sm import run_lte_sm
from tpudes_torch.parallel.replicated import run_replicated_bss
from tpudes_torch.parallel.tcp_dumbbell import run_tcp_dumbbell
from tpudes_torch.parallel.wired import run_wired

SEEDS = range(4)
LTE_INT_KEYS = ("rx_bits", "new_tbs", "retx", "drops", "ok", "cqi", "mcs")
LTE_TRAFFIC_KEYS = ("goodput_bits", "backlog_bits", "offered_bits")


def _fields(obj, names):
    return {k: getattr(obj, k) for k in names}


def _mobility(prog):
    return None if prog.mobility is None else mobility_from_numpy(
        _fields(prog.mobility, MOBILITY_FIELDS))


def _traffic(prog):
    return None if prog.traffic is None else traffic_from_numpy(
        _fields(prog.traffic, TRAFFIC_FIELDS))


def _draw(engine: str, seed: int):
    fuzzer = ENGINE_FUZZERS[engine]
    cfg = fuzzer.envelope.draw(ScenarioGen(seed))
    return fuzzer, cfg


def _key(cfg):
    return np.asarray([0, int(cfg["key_seed"])], np.int64)


def _assert_agree(engine, cfg, want, got, fields, **tol):
    diff = first_diff({k: np.asarray(want[k]) for k in fields},
                      {k: np.asarray(got[k]) for k in fields}, fields,
                      **tol)
    assert diff is None, f"{engine} {cfg}: first diff {diff}"


@pytest.mark.parametrize("seed", SEEDS)
def test_dumbbell_draw_equals_reference(seed):
    fuzzer, cfg = _draw("dumbbell", seed)
    prog = fuzzer.build(cfg)
    want = fuzzer.run_scalar(prog, cfg)
    got = run_tcp_dumbbell(dumbbell_from_numpy(_fields(prog,
                                                       DUMBBELL_FIELDS)),
                           _key(cfg), int(cfg["replicas"]), device="cpu")
    _assert_agree("dumbbell", cfg, want, got, sorted(want))
    assert set(got) == set(want)


@pytest.fixture
def reference_walks(monkeypatch):
    """The port's walk velocities replaced by the reference's (ROADMAP
    C3)."""

    def carried(prog, device=None):
        ref = JaxMobility(**_fields(prog, MOBILITY_FIELDS))
        return torch.as_tensor(np.array(jax_walk(ref)),
                               device=torch.device(device or "cpu"))

    monkeypatch.setattr(port_mobility, "walk_segment_velocities", carried)


@pytest.mark.parametrize("seed", range(3))
def test_bss_draw_equals_reference(seed, reference_walks):
    fuzzer, cfg = _draw("bss", seed)
    prog = fuzzer.build(cfg)
    want = fuzzer.run_scalar(prog, cfg)
    port = bss_from_numpy(_fields(prog, BSS_FIELDS), _mobility(prog),
                          _traffic(prog))
    got = run_replicated_bss(port, int(cfg["replicas"]), _key(cfg),
                             device="cpu")
    _assert_agree("bss", cfg, want, got, list(fuzzer.outcome_fields))


@pytest.mark.parametrize("seed", SEEDS)
def test_lte_sm_draw_equals_reference(seed):
    fuzzer, cfg = _draw("lte_sm", seed)
    prog = fuzzer.build(cfg)
    want = fuzzer.run_scalar(prog, cfg)
    port = program_from_numpy(_fields(prog, PROGRAM_FIELDS), _mobility(prog),
                              _traffic(prog))
    got = run_lte_sm(port, _key(cfg), replicas=int(cfg["replicas"]),
                     device="cpu")
    ints = [k for k in LTE_INT_KEYS + LTE_TRAFFIC_KEYS if k in want]
    _assert_agree("lte_sm", cfg, want, got, ints)
    _assert_agree("lte_sm", cfg, want, got, ["sinr"], rtol=1e-6)


@pytest.mark.parametrize("seed", range(6))
def test_as_flows_draw_equals_reference(seed):
    fuzzer, cfg = _draw("as_flows", seed)
    cfg = dict(cfg, surrogate="off")
    prog = fuzzer.build(cfg)
    want = fuzzer.run_scalar(prog, cfg)
    got = run_as_flows(as_from_numpy(_fields(prog, AS_FIELDS)), _key(cfg),
                       int(cfg["replicas"]), device="cpu")
    assert set(got) == set(want)
    _assert_agree("as_flows", cfg, want, got, sorted(want))


def test_as_flows_fuzz_axes_are_the_reference_envelope():
    from tpudes.parallel.as_flows import FUZZ_ENVELOPE
    from tpudes_torch.parallel.as_flows import FUZZ_AXES

    assert FUZZ_AXES == dict(FUZZ_ENVELOPE.axes)


@pytest.mark.parametrize("seed", SEEDS)
def test_wired_hybrid_draw_equals_reference(seed, monkeypatch):
    from tpudes.fuzz.engines import scenario_key
    from tpudes.parallel.hybrid import run_hybrid as ref_hybrid

    monkeypatch.setenv("TPUDES_BUCKETING", "0")
    fuzzer, cfg = _draw("wired", seed)
    prog = fuzzer.build(cfg)
    R = int(cfg["replicas"])
    want = ref_hybrid(prog, scenario_key(cfg), R, ranks=2,
                      transport="local")
    port = wired_from_numpy(_fields(prog, WIRED_FIELDS))
    got = run_hybrid(port, _key(cfg), R, ranks=2, transport="local",
                     device="cpu")
    fields = list(fuzzer.outcome_fields)
    _assert_agree("wired", cfg, want, got, fields)
    _assert_agree("wired", cfg, want, run_wired(port, _key(cfg), R,
                                                device="cpu"), fields)
    assert got["windows"] == want["windows"]


@pytest.mark.parametrize("engine", ["dumbbell", "bss", "lte_sm", "as_flows",
                                    "wired"])
def test_submitted_draw_equals_the_blocking_run(engine):
    from tpudes_torch.parallel.runtime import EngineFuture

    fuzzer, cfg = _draw(engine, 0)
    cfg = dict(cfg, surrogate="off") if engine == "as_flows" else cfg
    prog = fuzzer.build(cfg)
    R, key = int(cfg["replicas"]), _key(cfg)
    if engine == "dumbbell":
        port = dumbbell_from_numpy(_fields(prog, DUMBBELL_FIELDS))
        run = lambda **kw: run_tcp_dumbbell(port, key, R, **kw)  # noqa: E731
    elif engine == "bss":
        port = bss_from_numpy(_fields(prog, BSS_FIELDS), _mobility(prog),
                              _traffic(prog))
        run = lambda **kw: run_replicated_bss(port, R, key, **kw)  # noqa: E731
    elif engine == "lte_sm":
        port = program_from_numpy(_fields(prog, PROGRAM_FIELDS),
                                  _mobility(prog), _traffic(prog))
        run = lambda **kw: run_lte_sm(port, key, replicas=R, **kw)  # noqa: E731
    elif engine == "as_flows":
        port = as_from_numpy(_fields(prog, AS_FIELDS))
        run = lambda **kw: run_as_flows(port, key, R, **kw)  # noqa: E731
    else:
        port = wired_from_numpy(_fields(prog, WIRED_FIELDS))
        run = lambda **kw: run_wired(port, key, R, **kw)  # noqa: E731
    fut = run(device="cpu", block=False)
    assert isinstance(fut, EngineFuture)
    got, want = fut.result(), run(device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
