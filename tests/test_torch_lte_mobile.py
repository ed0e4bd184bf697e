"""The port's mobile LTE SM path and scheduler sweep against the JAX engine.

The reference lowers a moving lena drop (``build_lena(2, 4, mobility=m,
speed=10)`` + ``lower_lte_sm(..., 0.1, geom_stride=s)``, 100 TTIs); the
program and its ``MobilityProgram`` are carried across with
``program_from_numpy`` / ``mobility_from_numpy`` and run through both
engines on the CPU with key ``PRNGKey(3)``, 4 replicas.

Tolerances: per replica and UE the integer outputs (``rx_bits``,
``new_tbs``, ``retx``, ``drops``, ``ok``, ``cqi``, ``mcs``) and
``geom_refreshes`` are equal; ``sinr`` rtol 1e-6.  The geometry rows at
refresh times: const-velocity rows are bit-equal (the port writes out
the reference's compiled arithmetic, ``tpudes_torch/ops/fused.py``); the
walk's integer rows (``cqi``, ``mcs``, ``eligible``) and the rows that
are table lookups of them (``rate0``, ``eff0``, ``ecr0``) are equal, its
``sinr`` and ``mi0`` within rtol 1e-6 (its velocities' ``sin``/``cos``
round differently by an ulp now and then).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudes.core.world import reset_world
from tpudes.parallel.kernels_pallas import build_sm_consts as jax_consts
from tpudes.parallel.lte_sm import SM_SCHED_IDS, _build_geom_fn, lower_lte_sm
from tpudes.parallel.lte_sm import run_lte_sm as jax_run_lte_sm
from tpudes.scenarios import build_lena
from tpudes_torch.convert import (
    MOBILITY_FIELDS,
    PROGRAM_FIELDS,
    mobility_from_numpy,
    program_from_numpy,
)
from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel.lte_sm import (
    SM_DYNAMIC_ROWS,
    build_sm_mobile_advance,
    geom_rows,
    run_lte_sm,
)
from tpudes_torch.random import PRNGKey, replica_keys

INT_KEYS = ("rx_bits", "new_tbs", "retx", "drops", "ok", "cqi", "mcs")
KEY_SEED = 3
REPLICAS = 4
SIM_S = 0.1
_CACHE = {}


def _reference(model: str, stride: int):
    """The reference's lowered mobile lena program (cached per case)."""
    if (model, stride) not in _CACHE:
        reset_world()
        lte, _ = build_lena(2, 4, mobility=model, speed=10.0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the stride advisory
            _CACHE[model, stride] = lower_lte_sm(lte, SIM_S,
                                                 geom_stride=stride)
        reset_world()
    return _CACHE[model, stride]


def _port(prog):
    return program_from_numpy(
        {k: getattr(prog, k) for k in PROGRAM_FIELDS},
        None if prog.mobility is None else mobility_from_numpy(
            {k: getattr(prog.mobility, k) for k in MOBILITY_FIELDS}
        ),
    )


def _assert_same(got, want, msg):
    for k in INT_KEYS:
        assert got[k].shape == np.asarray(want[k]).shape, (msg, k)
        assert np.array_equal(got[k], np.asarray(want[k])), (msg, k)
    np.testing.assert_allclose(got["sinr"], want["sinr"], rtol=1e-6, atol=0)
    for k in ("geom_refreshes", "geom_stride"):
        assert (k in got) == (k in want), (msg, k)
        if k in want:
            assert got[k] == want[k], (msg, k)


@pytest.mark.parametrize("stride", [1, 8])
@pytest.mark.parametrize("sched", list(SM_SCHED_IDS))
def test_const_velocity_matches_jax_engine(sched, stride):
    prog = dataclasses.replace(_reference("const_velocity", stride),
                               scheduler=sched)
    want = jax_run_lte_sm(prog, jax.random.PRNGKey(KEY_SEED),
                          replicas=REPLICAS)
    got = run_lte_sm(_port(prog), PRNGKey(KEY_SEED), replicas=REPLICAS,
                     device="cpu")
    assert got["rx_bits"].shape == (REPLICAS, prog.n_ue)
    assert got["geom_refreshes"] == -(-prog.n_ttis // stride)
    _assert_same(got, want, (sched, stride))
    assert got["rx_bits"].sum() > 0


def test_random_walk_matches_jax_engine():
    prog = _reference("random_walk", 8)
    want = jax_run_lte_sm(prog, jax.random.PRNGKey(KEY_SEED),
                          replicas=REPLICAS)
    got = run_lte_sm(_port(prog), PRNGKey(KEY_SEED), replicas=REPLICAS,
                     device="cpu")
    _assert_same(got, want, "random_walk")


@pytest.mark.parametrize("model", ["const_velocity", "random_walk"])
def test_geom_rows_match_reference_rows(model):
    prog = _reference(model, 1)
    pos_at, rows_from_pos, _ = _build_geom_fn(prog, jax_consts(prog))
    ops = prog.mobility.operands()
    rows_at = jax.jit(lambda t: rows_from_pos(pos_at(ops, t)))
    t = np.array([0, 1, 7, 8, 40, 63, 99])
    want = {k: np.stack([np.asarray(rows_at(jnp.int32(x))[k])[0] for x in t])
            for k in (*SM_DYNAMIC_ROWS, "sinr", "cqi", "mcs")}
    port = _port(prog)
    got = geom_rows(port, kc.build_sm_consts(port, device="cpu"), t)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == (len(t), prog.n_ue) and g.dtype == w.dtype, k
        if k in ("sinr", "mi0") and model == "random_walk":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=k)
        else:
            assert np.array_equal(g, w), k
    assert not np.array_equal(got["sinr"][0], got["sinr"][-1])


@pytest.mark.parametrize("model", ["const_velocity", "random_walk"])
def test_chunked_runs_equal_unchunked(model):
    """Chunks of 7 TTIs (not a multiple of the stride: most chunks start
    mid-stride on the carried refresh) give the unchunked run."""
    port = _port(_reference(model, 8))
    one = run_lte_sm(port, PRNGKey(KEY_SEED), replicas=2, device="cpu")
    chunked = run_lte_sm(port, PRNGKey(KEY_SEED), replicas=2, device="cpu",
                         chunk_ttis=7)
    for k in (*INT_KEYS, "sinr", "geom_refreshes"):
        assert np.array_equal(chunked[k], one[k]), k


def test_advance_reports_refreshes_per_range():
    """``geom_refreshes`` counts the multiples of the stride a range
    covers: a range that starts mid-stride reuses the carried refresh."""
    port = _port(_reference("const_velocity", 8))
    _, init_state, advance = build_sm_mobile_advance(port, "cpu")
    keys = replica_keys(PRNGKey(KEY_SEED), 2)
    s = init_state(2)
    for (t0, t1), n in (((0, 5), 1), ((5, 8), 0), ((8, 9), 1),
                        ((9, 33), 3), ((33, 33), 0)):
        s, last, refreshes = advance(s, keys, t0, t1)
        assert refreshes == n, (t0, t1)
        if t1 > t0:
            want = geom_rows(port, kc.build_sm_consts(port, device="cpu"),
                             [8 * ((t1 - 1) // 8)])
            assert torch.equal(last["cqi"], want["cqi"][0])


@pytest.mark.parametrize("model", [None, "const_velocity"])
def test_scheduler_sweep_matches_jax_sweep(model):
    names = ["pf", "rr", "tdbet", "fdmt"]
    if model is None:
        prog = _reference("const_velocity", 1)
        prog = dataclasses.replace(prog, mobility=None, n_ttis=60)
    else:
        prog = _reference(model, 8)
    want = jax_run_lte_sm(prog, jax.random.PRNGKey(KEY_SEED),
                          replicas=REPLICAS, schedulers=names)
    port = _port(prog)
    got = run_lte_sm(port, PRNGKey(KEY_SEED), replicas=REPLICAS,
                     device="cpu", schedulers=names)
    assert isinstance(got, list) and len(got) == len(names)
    for name, g, w in zip(names, got, want):
        _assert_same(g, w, name)
        one = run_lte_sm(dataclasses.replace(port, scheduler=name),
                         PRNGKey(KEY_SEED), replicas=REPLICAS, device="cpu")
        for k in (*INT_KEYS, "sinr"):
            assert np.array_equal(g[k], one[k]), (name, k)


def test_sweep_rejects_unknown_schedulers():
    port = _port(_reference("const_velocity", 8))
    for bad in (["pf", "nope"], []):
        with pytest.raises(ValueError, match="SM_SCHED_IDS"):
            run_lte_sm(port, PRNGKey(0), device="cpu", schedulers=bad)


def test_mobile_program_checks_its_geometry():
    port = _port(_reference("const_velocity", 8))
    for bad, match in ((dict(enb_pos=None), "enb_pos"),
                       (dict(pathloss=("okumura", 1.0)), "pathloss"),
                       (dict(geom_stride=0), "geom_stride")):
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(port, **bad)
    with pytest.raises(ValueError, match="moves"):
        dataclasses.replace(port, gain=port.gain[:, :3],
                            serving=port.serving[:3])


@pytest.mark.parametrize("model", ["const_velocity", "random_walk"])
def test_lena_mobile_program_is_the_moving_drop(model):
    """The port's own moving drop: the static drop's lowering at t = 0,
    the reference's pathloss descriptor, UEs moving at the asked speed
    (inside the reference's walk box)."""
    from tpudes_torch.scenarios import (
        lena_grid_program,
        lena_mobile_program,
        lena_ue_drop,
    )

    gen = lambda: torch.Generator().manual_seed(8)  # noqa: E731
    prog = lena_mobile_program(3, 4, 2000, model, speed=6.0, geom_stride=2,
                               generator=gen())
    static = lena_grid_program(*lena_ue_drop(3, 4, generator=gen()), 2000)
    assert np.array_equal(prog.gain, static.gain)
    assert np.array_equal(prog.serving, static.serving)
    assert prog.pathloss == _reference(model, 8).pathloss
    assert prog.enb_pos.shape == (3, 3) and prog.geom_stride == 2
    mob = prog.mobility
    assert mob.model == model and mob.n == prog.n_ue
    if model == "const_velocity":
        np.testing.assert_allclose(np.hypot(*mob.velocity[:, :2].T), 6.0,
                                   rtol=1e-6)
    else:
        assert np.all(mob.speed == np.float32([3.0, 6.0]))
        xs, ys = prog.enb_pos[:, 0], prog.enb_pos[:, 1]
        pad = 500.0 * 0.45 + 50.0
        np.testing.assert_allclose(
            mob.bounds, [xs.min() - pad, xs.max() + pad, ys.min() - pad,
                         ys.max() + pad], rtol=1e-6)
    with pytest.warns(UserWarning, match="coherence"):
        lena_mobile_program(3, 4, 100, model, speed=30.0, geom_stride=100,
                            generator=gen())
    with pytest.raises(ValueError, match="unknown mobility"):
        lena_mobile_program(3, 4, 100, "teleport")
