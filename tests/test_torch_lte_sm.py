"""The port's LTE SM slice end to end against the JAX engine.

One program, lowered by the reference (``build_lena(2, 4)`` +
``lower_lte_sm(..., 0.25)``) and carried across with
``program_from_numpy``, runs through ``tpudes.parallel.lte_sm.run_lte_sm``
and the port's ``run_lte_sm`` on the CPU with key ``PRNGKey(3)``.
Tolerances: per replica and UE the integer outputs (``rx_bits``,
``new_tbs``, ``retx``, ``drops``, ``ok``, ``cqi``, ``mcs``) are equal;
``sinr`` rtol 1e-6.  The only admissible integer mismatch is a decode
coin within an ulp of a BLER computed by the two different ``erfc``
implementations; none occurs on these programs.  The port's own lena
lowering reproduces the reference's gain (rtol 1e-6), serving map and
noise PSD from the same positions.
"""

import ast
import dataclasses
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpudes.core.world import reset_world
from tpudes.parallel.lte_sm import SM_SCHED_IDS, lower_lte_sm
from tpudes.parallel.lte_sm import run_lte_sm as jax_run_lte_sm
from tpudes.scenarios import build_lena
from tpudes.scenarios import hex_grid as jax_hex_grid
from tpudes_torch.convert import PROGRAM_FIELDS, program_from_numpy
from tpudes_torch.ops.mobility import MobilityProgram
from tpudes_torch.parallel.lte_sm import LteSmProgram, run_lte_sm
from tpudes_torch.random import PRNGKey
from tpudes_torch.scenarios import hex_grid, lena_grid_program, lena_ue_drop
from tpudes_torch.traffic.program import TrafficProgram

REPO = Path(__file__).resolve().parents[1]
INT_KEYS = ("rx_bits", "new_tbs", "retx", "drops", "ok", "cqi", "mcs")
KEY_SEED = 3
REPLICAS = 4


@pytest.fixture(scope="module")
def lena():
    """The reference's lowered lena program and its node positions."""
    reset_world()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the short-horizon advisory
        lte, _ = build_lena(2, 4)
        prog = lower_lte_sm(lte, 0.25)
    ctrl = lte.controller
    pos = (ctrl._positions(ctrl.enbs), ctrl._positions(ctrl.ues))
    reset_world()
    return prog, pos


def _port(prog):
    return program_from_numpy({k: getattr(prog, k) for k in PROGRAM_FIELDS})


def _assert_same_outputs(got, want, msg):
    for k in INT_KEYS:
        assert got[k].shape == np.asarray(want[k]).shape, (msg, k)
        assert np.array_equal(got[k], np.asarray(want[k])), (msg, k)
    np.testing.assert_allclose(got["sinr"], want["sinr"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("sched", list(SM_SCHED_IDS))
def test_slice_matches_jax_engine_per_replica(lena, sched):
    prog = dataclasses.replace(lena[0], scheduler=sched)
    want = jax_run_lte_sm(prog, jax.random.PRNGKey(KEY_SEED),
                          replicas=REPLICAS)
    got = run_lte_sm(_port(prog), PRNGKey(KEY_SEED), replicas=REPLICAS,
                     device="cpu")
    assert got["rx_bits"].shape == (REPLICAS, prog.n_ue)
    _assert_same_outputs(got, want, sched)
    assert got["rx_bits"].sum() > 0 and got["retx"].sum() > 0


def test_unbatched_run_and_chunking(lena):
    """No replica axis runs on the key itself; any chunking of the coin
    draws gives the same run."""
    prog = lena[0]
    want = jax_run_lte_sm(prog, jax.random.PRNGKey(KEY_SEED))
    port = _port(prog)
    one = run_lte_sm(port, PRNGKey(KEY_SEED), device="cpu")
    assert one["rx_bits"].shape == (prog.n_ue,)
    _assert_same_outputs(one, want, "unbatched")
    chunked = run_lte_sm(port, PRNGKey(KEY_SEED), device="cpu",
                         chunk_ttis=7)
    for k in INT_KEYS:
        assert np.array_equal(chunked[k], one[k]), k


def test_jax_key_words_are_accepted(lena):
    port = _port(dataclasses.replace(lena[0], n_ttis=40))
    a = run_lte_sm(port, np.asarray(jax.random.PRNGKey(KEY_SEED)),
                   replicas=2, device="cpu")
    b = run_lte_sm(port, PRNGKey(KEY_SEED), replicas=2, device="cpu")
    for k in INT_KEYS:
        assert np.array_equal(a[k], b[k]), k


def test_lena_grid_program_reproduces_reference_lowering(lena):
    prog, (enb_pos, ue_pos) = lena
    got = lena_grid_program(enb_pos, ue_pos, prog.n_ttis)
    np.testing.assert_allclose(got.gain, prog.gain, rtol=1e-6, atol=0)
    assert np.array_equal(got.serving, prog.serving)
    assert got.noise_psd == prog.noise_psd
    assert np.array_equal(got.tx_power_dbm, prog.tx_power_dbm)
    assert (got.n_rb, got.n_ttis, got.scheduler, got.pf_alpha) == (
        prog.n_rb, prog.n_ttis, prog.scheduler, prog.pf_alpha
    )


@pytest.mark.parametrize("n", [1, 2, 7, 19])
def test_hex_grid_copy(n):
    assert hex_grid(n, 500.0) == jax_hex_grid(n, 500.0)


def test_lena_ue_drop_geometry():
    gen = torch.Generator().manual_seed(5)
    enb_pos, ue_pos = lena_ue_drop(7, 30, generator=gen)
    assert enb_pos.shape == (7, 3) and ue_pos.shape == (210, 3)
    assert np.all(enb_pos[:, 2] == 30.0) and np.all(ue_pos[:, 2] == 1.5)
    own = np.repeat(enb_pos[:, :2], 30, axis=0)
    assert np.all(np.hypot(*(ue_pos[:, :2] - own).T) <= 500.0 * 0.45)
    again = lena_ue_drop(7, 30, generator=torch.Generator().manual_seed(5))
    assert np.array_equal(again[1], ue_pos)
    prog = lena_grid_program(enb_pos, ue_pos, 10)
    assert prog.gain.shape == (7, 210) and prog.serving.shape == (210,)


@pytest.mark.parametrize(
    "kwargs, match",
    [(dict(precision="f16"), "precision"),
     (dict(traffic=TrafficProgram.cbr(np.zeros(3), 1000)), "entities")],
)
def test_unported_program_arms_raise(lena, kwargs, match):
    """Every arm of K1 is ported; what the reference refuses, the port
    refuses: a precision other than f32 and bf16, and a workload whose
    entity count is not the UE count."""
    fields = {k: getattr(lena[0], k) for k in PROGRAM_FIELDS}
    fields.update(kwargs)
    with pytest.raises(ValueError, match=match):
        LteSmProgram(**fields)


def _static_mobility(lena):
    """The lena program with its UEs standing still on the mobile path."""
    prog, (enb_pos, ue_pos) = lena
    fields = {k: getattr(prog, k) for k in PROGRAM_FIELDS}
    fields.update(enb_pos=np.asarray(enb_pos, np.float32),
                  pathloss=("friis", 2.12e9, 1.0, 0.0), geom_stride=4)
    return fields, MobilityProgram.static(ue_pos)


def test_program_takes_mobility(lena):
    """The mobility arm runs; traffic on a mobile program is refused, as
    the reference refuses it."""
    fields, mob = _static_mobility(lena)
    prog = LteSmProgram(**dict(fields, n_ttis=40), mobility=mob)
    out = run_lte_sm(prog, PRNGKey(KEY_SEED), replicas=2, device="cpu")
    assert (out["geom_refreshes"], out["geom_stride"]) == (10, 4)
    assert out["rx_bits"].shape == (2, prog.n_ue) and out["rx_bits"].sum() > 0
    static = run_lte_sm(dataclasses.replace(prog, mobility=None),
                        PRNGKey(KEY_SEED), replicas=2, device="cpu")
    assert np.array_equal(out["cqi"], static["cqi"])
    with pytest.raises(ValueError, match="traffic"):
        LteSmProgram(**fields, mobility=mob,
                     traffic=TrafficProgram.cbr(np.zeros(prog.n_ue), 1000))


def test_run_takes_schedulers(lena):
    """A sweep returns one dict per point, each the single-point run on
    the same key."""
    port = _port(dataclasses.replace(lena[0], n_ttis=60))
    swept = run_lte_sm(port, PRNGKey(KEY_SEED), replicas=2, device="cpu",
                       schedulers=["pf", "rr"])
    assert isinstance(swept, list) and len(swept) == 2
    for sched, got in zip(["pf", "rr"], swept):
        one = run_lte_sm(dataclasses.replace(port, scheduler=sched),
                         PRNGKey(KEY_SEED), replicas=2, device="cpu")
        for k in INT_KEYS:
            assert np.array_equal(got[k], one[k]), (sched, k)


@pytest.mark.parametrize("kwargs", [dict(mesh=object()), dict(obs=True)])
def test_unported_run_options_raise(lena, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_lte_sm(_port(lena[0]), PRNGKey(0), device="cpu", **kwargs)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_sources():
    return sorted((REPO / "tpudes_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"
    ]


def test_port_imports_neither_jax_nor_the_reference_package():
    sources = _port_sources()
    assert (REPO / "chip_smoke.py").is_file()
    assert len(sources) > 10
    assert {"program.py", "device.py", "host.py"} <= {
        p.name for p in sources if p.parent.name == "traffic"
    }
    assert {"replicated.py", "bss_cuda.py", "tcp_dumbbell.py",
            "tcp_cuda.py"} <= {
        p.name for p in sources if p.parent.name == "parallel"
    }
    assert {"wifi_error.py", "interference.py", "fused.py"} <= {
        p.name for p in sources if p.parent.name == "ops"
    }
    assert {"runtime.py", "checkpoint.py"} <= {
        p.name for p in sources if p.parent.name == "parallel"
    }
    for sub, names in (("serving", {"server.py", "descriptor.py",
                                    "errors.py"}),
                       ("chaos", {"schedule.py", "scenario.py"}),
                       ("obs", {"serving.py", "schema.py"})):
        assert names | {"__init__.py"} <= {
            p.name for p in sources if p.parent.name == sub
        }, sub
    for path in sources:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpudes"), (path, mod)
