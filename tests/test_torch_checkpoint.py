"""Checkpoint and resume of the port's chunked runs
(``tpudes_torch/parallel/checkpoint.py``), the counterparts of
``tests/test_checkpoint.py``'s cases.

A run killed between chunks (the chaos ``checkpoint_kill`` site fires
after the save) resumes from its last completed chunk and finishes
bit-equal to the uninterrupted run, for all four engines with
``checkpoint=``; at chunk boundary 0 (nothing saved yet), after the
final chunk (no launch at all), and across ``TPUDES_INFLIGHT`` and
``TPUDES_BUCKETING`` changes.  A checkpoint that is not this run's (another
key, another chunk schedule, a corrupt file) is refused.  The programs
are the reference's toy programs carried over as numpy fields.
"""

import numpy as np
import pytest

import tpudes_torch.chaos as chaos
from tpudes.parallel import programs as ref_programs
from tpudes_torch.chaos import ChaosEvent, ChaosInjected, ChaosSchedule
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
from tpudes_torch.obs.serving import ServingTelemetry
from tpudes_torch.parallel.checkpoint import CarryCheckpoint, CheckpointError
from tpudes_torch.parallel.runtime import RUNTIME

KEY = np.array([0, 17])


@pytest.fixture(autouse=True)
def _fresh():
    RUNTIME.clear()
    chaos.reset()
    yield
    chaos.reset()
    RUNTIME.clear()


def _fields(prog, names):
    return {k: getattr(prog, k) for k in names}


def _dumbbell(key=KEY, chunk=40, **kw):
    from tpudes_torch.parallel.tcp_dumbbell import run_tcp_dumbbell

    prog = dumbbell_from_numpy(_fields(
        ref_programs.toy_dumbbell_program(n_flows=3, n_slots=120),
        DUMBBELL_FIELDS))
    return run_tcp_dumbbell(prog, key, 5, chunk_slots=chunk, device="cpu",
                            **kw)


def _lte(**kw):
    from tpudes_torch.parallel.lte_sm import run_lte_sm

    prog = program_from_numpy(_fields(
        ref_programs.toy_lte_program(n_enb=2, n_ue=4, n_ttis=60),
        PROGRAM_FIELDS))
    return run_lte_sm(prog, KEY, replicas=3, chunk_ttis=20, device="cpu",
                      **kw)


def _bss(**kw):
    from tpudes_torch.parallel.replicated import run_replicated_bss

    prog = bss_from_numpy(_fields(
        ref_programs.toy_bss_program(n_sta=4, sim_end_us=40_000),
        BSS_FIELDS))
    return run_replicated_bss(prog, 2, KEY, chunk_steps=150, device="cpu",
                              **kw)


def _as(**kw):
    from tpudes_torch.parallel.as_flows import run_as_flows

    prog = as_from_numpy(_fields(
        ref_programs.toy_as_program(n_nodes=64, n_flows=3), AS_FIELDS))
    return run_as_flows(prog, KEY, 4, chunk_rounds=2, device="cpu", **kw)


ENGINES = {"dumbbell": _dumbbell, "lte_sm": _lte, "bss": _bss,
           "as_flows": _as}


def _assert_equal(a, b):
    a_list = a if isinstance(a, list) else [a]
    b_list = b if isinstance(b, list) else [b]
    assert len(a_list) == len(b_list)
    for pa, pb in zip(a_list, b_list):
        for k in pb:
            np.testing.assert_array_equal(np.asarray(pa[k]),
                                          np.asarray(pb[k]),
                                          err_msg=f"field {k!r}")


def _kill_after(nth, engine=None):
    chaos.arm(ChaosSchedule([ChaosEvent("checkpoint_kill", "checkpoint_save",
                                        nth=nth, param=engine)]))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_kill_between_chunks_resumes_bit_equal(engine, tmp_path):
    run = ENGINES[engine]
    ref = run()
    ckpt = CarryCheckpoint(tmp_path / f"{engine}.ckpt")
    _kill_after(1, engine)
    with pytest.raises(ChaosInjected):
        run(checkpoint=ckpt)
    chaos.disarm()
    assert ckpt.exists(), "the kill fires only after the save"
    before = RUNTIME.launches(engine)
    out = run(checkpoint=ckpt)
    _assert_equal(out, ref)
    full = {"dumbbell": 3, "lte_sm": 3, "bss": None, "as_flows": 2}[engine]
    if full is not None:
        assert RUNTIME.launches(engine) - before == full - 1


def test_fresh_checkpoint_path_is_boundary_zero(tmp_path):
    ref = _dumbbell()
    ckpt = CarryCheckpoint(tmp_path / "fresh.ckpt")
    _assert_equal(_dumbbell(checkpoint=ckpt), ref)
    assert ckpt.exists()


def test_resume_after_final_chunk_is_noop(tmp_path):
    ref = _dumbbell()
    ckpt = CarryCheckpoint(tmp_path / "done.ckpt")
    _dumbbell(checkpoint=ckpt)
    before = RUNTIME.launches("dumbbell")
    out = _dumbbell(checkpoint=ckpt)
    assert RUNTIME.launches("dumbbell") == before
    _assert_equal(out, ref)


def test_resume_under_different_inflight_window(tmp_path, monkeypatch):
    ref = _dumbbell()
    ckpt = CarryCheckpoint(tmp_path / "win.ckpt")
    _kill_after(2)
    with pytest.raises(ChaosInjected):
        _dumbbell(checkpoint=ckpt)
    chaos.disarm()
    monkeypatch.setenv("TPUDES_INFLIGHT", "1")
    _assert_equal(RUNTIME.submit(_dumbbell, checkpoint=ckpt).result(), ref)


def test_resume_across_bucketing_flip(tmp_path, monkeypatch):
    """Saved with 5 replicas padded to 8, resumed unpadded, and the other
    way round: both resume bit-equal."""
    ckpt = CarryCheckpoint(tmp_path / "buck.ckpt")
    _kill_after(1)
    with pytest.raises(ChaosInjected):
        _dumbbell(checkpoint=ckpt)
    chaos.disarm()
    monkeypatch.setenv("TPUDES_BUCKETING", "0")
    _assert_equal(_dumbbell(checkpoint=ckpt), _dumbbell())
    ckpt2 = CarryCheckpoint(tmp_path / "buck2.ckpt")
    _kill_after(1)
    with pytest.raises(ChaosInjected):
        _dumbbell(checkpoint=ckpt2)
    chaos.disarm()
    monkeypatch.delenv("TPUDES_BUCKETING")
    _assert_equal(_dumbbell(checkpoint=ckpt2), _dumbbell())


@pytest.mark.parametrize("case", ["wrong_key", "chunk_schedule", "corrupt"])
def test_a_checkpoint_that_is_not_this_runs_is_refused(case, tmp_path):
    ckpt = CarryCheckpoint(tmp_path / "other.ckpt")
    if case == "corrupt":
        (tmp_path / "other.ckpt").write_bytes(b"not a pickle")
        with pytest.raises(CheckpointError, match="unreadable"):
            _dumbbell(checkpoint=ckpt)
        return
    _dumbbell(checkpoint=ckpt)
    if case == "wrong_key":
        with pytest.raises(CheckpointError, match="fingerprint"):
            _dumbbell(key=np.array([0, 99]), checkpoint=ckpt)
    else:
        with pytest.raises(CheckpointError, match="chunk schedule"):
            _dumbbell(chunk=60, checkpoint=ckpt)


def test_checkpoint_telemetry_counters(tmp_path):
    ServingTelemetry.reset()
    ckpt = CarryCheckpoint(tmp_path / "tel.ckpt")
    _kill_after(2)
    with pytest.raises(ChaosInjected):
        _dumbbell(checkpoint=ckpt)
    chaos.disarm()
    _dumbbell(checkpoint=ckpt)
    f = ServingTelemetry.snapshot()["failures"]
    assert f["checkpoint_saves"] == 3  # 2 before the kill + the last one
    assert f["checkpoint_restores"] == 1
    assert f["injected_checkpoint_kill"] == 1
    ServingTelemetry.reset()
