"""The port's mobile WiFi BSS against the JAX engine.

A mobile program rebuilds each replica's ``(N, N)`` rx power and
detectability tables at its own next event time every ``geom_stride``
steps.  Held against the reference on the CPU, on the same numpy inputs:
the geometry stage (positions, distances, loss, ``dbm_to_w``) bit for
bit at random positions and times, the trajectory, the lowering and its
mutual-sensing guard, the step's whole state with its tables for 200
steps, and per-replica outputs, ``steps`` and ``geom_refreshes`` of
whole runs, chunked and swept.

Tolerances: none.  The random walk's segment velocities take ``sin`` and
``cos``, which the port and the reference round an ulp apart for about
one value in 75 (``ops/mobility.py::walk_segment_velocities``): a walk's
run carries the reference's velocities across, and the class is counted
on its own.  Three or more winners on one µs sum their interference in
the reference's dot order, not the port's pairwise tree (ROADMAP C2):
the census counts them.
"""

import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudes.core.world import reset_world
from tpudes.ops.mobility import MobilityProgram as JaxMobility
from tpudes.ops.mobility import build_position_fn as jax_position_fn
from tpudes.ops.mobility import trajectory_positions as jax_trajectory
from tpudes.ops.mobility import walk_segment_velocities as jax_walk
from tpudes.ops.propagation import dbm_to_w as jax_dbm_to_w
from tpudes.ops.propagation import log_distance as jax_log_distance
from tpudes.parallel.programs import toy_bss_program as jax_toy_bss
from tpudes.parallel.replicated import UnliftableScenarioError
from tpudes.parallel.replicated import build_bss_step as jax_build_bss_step
from tpudes.parallel.replicated import lower_bss
from tpudes.parallel.replicated import run_replicated_bss as jax_run_bss
from tpudes.scenarios import build_bss
from tpudes_torch.convert import (
    BSS_FIELDS,
    MOBILITY_FIELDS,
    bss_from_numpy,
    bss_state_from_numpy,
    mobility_from_numpy,
)
from tpudes_torch.ops import mobility as port_mobility
from tpudes_torch.parallel import replicated as bss
from tpudes_torch.parallel.bss_cuda import BSS_STATE, join_stops
from tpudes_torch.random import PRNGKey, bss_draws
from tpudes_torch.scenarios import bss_program

OUT_KEYS = ("srv_rx", "cli_rx", "tx_data", "drops", "steps", "all_done",
            "geom_refreshes", "geom_stride")


def _lower(n_stas, sim_s, geom_stride=1, **kwargs):
    reset_world()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # short horizons, stride advice
        sta, ap, clients, _ = build_bss(n_stas, sim_s, **kwargs)
        prog = lower_bss([sta.Get(i) for i in range(sta.GetN())], ap,
                         clients, sim_s, geom_stride=geom_stride)
    reset_world()
    return prog


def _mob(m):
    return None if m is None else mobility_from_numpy(
        {k: getattr(m, k) for k in MOBILITY_FIELDS})


def _port(prog):
    return bss_from_numpy({k: getattr(prog, k) for k in BSS_FIELDS},
                          _mob(prog.mobility))


def _toy_motion(model, prog, seed=0):
    """A reference mobility program of ``model`` over the toy BSS's
    nodes, the AP pinned: drifts, a walk in a 60 m box, three-leg
    waypoints."""
    n = prog.n
    rng = np.random.default_rng(seed)
    base = prog.positions
    if model == "static":
        return JaxMobility.static(base)
    if model == "const_velocity":
        vel = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
        vel[0] = 0.0
        vel[:, 2] = 0.0
        return JaxMobility.constant_velocity(base, vel)
    if model == "random_walk":
        band = np.array([[0.0, 0.0]] + [[1.0, 3.0]] * (n - 1), np.float32)
        return JaxMobility.random_walk(base, (-30.0, 30.0, -30.0, 30.0),
                                       band, seg_s=0.2, horizon_us=700_000,
                                       mob_seed=seed + 3)
    wt = np.tile(np.array([0, 150_000, 400_000, 650_000]), (n, 1))
    wt[0] = [0, 1, 2, 3]
    wp = np.repeat(base[:, None, :], 4, 1).copy()
    wp[1:, 1, :2] += rng.uniform(-6.0, 6.0, (n - 1, 2))
    wp[1:, 2, :2] -= rng.uniform(-6.0, 6.0, (n - 1, 2))
    return JaxMobility.waypoints(wt, wp)


@pytest.fixture(autouse=True)
def _walk_velocities_carried(monkeypatch):
    """The port's walk velocities replaced by the reference's for the
    programs of this file (the sin/cos class, counted in its own test)."""
    own = port_mobility.walk_segment_velocities

    def carried(prog, device=None):
        ref = JaxMobility(**{k: getattr(prog, k) for k in MOBILITY_FIELDS})
        return torch.as_tensor(np.array(jax_walk(ref)),
                               device=torch.device(device or "cpu"))

    monkeypatch.setattr(port_mobility, "walk_segment_velocities", carried)
    yield own


MODELS = ("static", "const_velocity", "random_walk", "waypoint")


def _jax_geom_tables(prog, mob, t_vec):
    """``build_bss_step``'s ``geom_tables`` (``replicated.py:654-672``),
    its body as the reference writes it, jitted as the step compiles it."""
    pos_fn = jax_position_fn(mob)
    n = prog.n
    eye = jnp.eye(n, dtype=bool)

    def tables(ops, t):
        pos = jax.vmap(lambda tt: pos_fn(ops, tt))(t)
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        d = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
        rx_dbm = jax_log_distance(
            jnp.float32(prog.tx_power_dbm), d,
            exponent=prog.path_loss_exponent,
            reference_loss_db=prog.reference_loss_db)
        rx_w = jnp.where(eye[None], 0.0, jax_dbm_to_w(rx_dbm))
        return rx_w.astype(jnp.float32), rx_dbm >= prog.rx_sensitivity_dbm

    rx_w, det = jax.jit(tables)(mob.operands(), jnp.asarray(t_vec, jnp.int32))
    return np.asarray(rx_w), np.asarray(det)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("model", MODELS)
def test_geom_tables_bit_equal_at_random_times(model, seed):
    """The port's geometry stage (``replicated.geom_tables``: positions,
    ``pairwise_distance``, ``log_distance_loss``, ``dbm_to_w``) equals
    the reference's jitted stage bit for bit at 64 random times."""
    prog = jax_toy_bss(8, 700_000)
    mob = _toy_motion(model, prog, seed)
    t = np.random.default_rng(seed).integers(0, 900_000, 64)
    want_w, want_det = _jax_geom_tables(prog, mob, t)
    port = dataclasses.replace(_port(prog), mobility=_mob(mob))
    consts = bss.build_bss_consts(port, "cpu")
    got_w, got_det = bss.geom_tables(consts, torch.as_tensor(t, dtype=torch.int32))
    assert np.array_equal(got_w.view(torch.int32).numpy(),
                          want_w.view(np.int32)), model
    assert np.array_equal(got_det.numpy(), want_det), model
    assert (got_w.numpy() > 0).sum() == 64 * 8 * 9


@pytest.mark.parametrize("model", MODELS)
def test_trajectory_positions_equal_reference(model):
    """``trajectory_positions`` (the guard's sampler) equals the
    reference's on a grid that runs past the horizon: bit for bit but
    for the walk.  The reference's sampler is its position function
    jitted alone, where the walk's displacement sum over segments is a
    dot of its own order; in the step (the geometry test above) it is
    the port's order.  A position that cancels to near 0 can then round
    apart, by micrometres: the entries are counted, and the guard's
    verdicts compared below."""
    prog = jax_toy_bss(8, 700_000)
    mob = _toy_motion(model, prog, 2)
    grid = np.linspace(0, 1_000_000, 65).astype(np.int64)
    want = jax_trajectory(mob, grid)
    got = port_mobility.trajectory_positions(_mob(mob), grid)
    assert got.dtype == np.float32
    apart = got.view(np.int32) != want.view(np.int32)
    if model != "random_walk":
        assert not apart.any()
    assert apart.sum() <= got.size // 100
    assert np.abs(got - want).max() <= 1e-5


def test_walk_velocity_class_is_counted(_walk_velocities_carried):
    """The port's own walk velocities (f64 ``cos``/``sin`` rounded)
    against the reference's: equal but for the counted class, at most one
    ulp, in under 1 in 20 values."""
    prog = jax_toy_bss(16, 700_000)
    walk = _toy_motion("random_walk", prog, 5)
    mine = _walk_velocities_carried(_mob(walk), "cpu").numpy()
    ref = np.asarray(jax_walk(walk))
    gap = np.abs(mine.view(np.int32).astype(np.int64)
                 - ref.view(np.int32).astype(np.int64))
    assert gap.max() <= 1
    assert (gap > 0).sum() <= mine.size // 20


@pytest.mark.parametrize("mobility, speed", [("const_velocity", 1.0),
                                             ("random_walk", 2.0)])
def test_bss_program_mobile_equals_reference_lowering(mobility, speed):
    """``bss_program(..., mobility, speed, geom_stride)`` gives
    ``lower_bss(build_bss(...), geom_stride)``'s fields and motion."""
    want = _lower(16, 2.0, geom_stride=8, mobility=mobility, speed=speed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = bss_program(16, 2.0, mobility=mobility, speed=speed,
                          geom_stride=8)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "mobility":
            for k in MOBILITY_FIELDS:
                x, y = getattr(a, k), getattr(b, k)
                assert np.array_equal(np.asarray(x), np.asarray(y)), k
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


#: (n_stas, sim_s, build_bss keywords): inside and outside the guard
GUARD_CASES = [
    (8, 1.3, dict(mobility="const_velocity", speed=1.0)),
    (8, 1.3, dict(mobility="const_velocity", speed=60.0,
                  radii=(30.0, 34.0))),
    (8, 2.0, dict(mobility="const_velocity", speed=80.0, radii=(34.0,))),
    (8, 2.0, dict(mobility="const_velocity", speed=120.0, radii=(34.0,))),
    (8, 1.3, dict(mobility="random_walk", speed=2.0)),
    (8, 1.3, dict(mobility="random_walk", speed=2.0, radii=(90.0,))),
    (8, 1.3, dict(mobility="random_walk", speed=2.0, radii=(150.0,))),
    (8, 1.3, dict(mobility="static", radii=(300.0,))),
]
#: the cases the reference refuses: a drift out of range, a walk box
#: whose corners are, a static ring that is
REFUSED = (2, 3, 5, 6, 7)


@pytest.mark.parametrize("case", range(len(GUARD_CASES)))
def test_guard_refuses_what_the_reference_refuses(case):
    """The mutual-sensing guard over the trajectory (and a walk's worst
    corner) refuses exactly the programs ``lower_bss`` refuses."""
    n, sim_s, kw = GUARD_CASES[case]
    try:
        _lower(n, sim_s, **kw)
        refused = False
    except UnliftableScenarioError:
        refused = True
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if refused:
            with pytest.raises(ValueError, match="hidden-node"):
                bss_program(n, sim_s, **kw)
        else:
            bss_program(n, sim_s, **kw)
    assert refused == (case in REFUSED)


def test_stride_advisory_warns_as_the_reference():
    """A stride that lets the fastest node drift past the coherence
    length warns (the run still runs)."""
    with pytest.warns(UserWarning, match="geom_stride"):
        bss_program(8, 2.0, mobility="const_velocity", speed=30.0,
                    radii=(10.0,), geom_stride=400)


@pytest.mark.parametrize("stride", [1, 3])
def test_step_state_and_tables_equal_reference_for_200_steps(stride):
    """The plain ``step_fn`` and the JAX ``step_fn`` from the same state
    on the same draws: every field, the ``(R, N, N)`` tables and their
    time included, after each of the first 200 steps of a drifting
    program."""
    jp = dataclasses.replace(_lower(8, 1.3, mobility="const_velocity",
                                    speed=4.0, radii=(12.0, 20.0, 28.0)),
                             geom_stride=stride)
    R = 4
    init, _, step = jax_build_bss_step(jp, R)
    geom = dict(stride=jnp.int32(stride), **jp.mobility.operands())
    jstep = jax.jit(lambda s, k: step(s, k, jnp.int32(jp.sim_end_us), geom))
    js = init()
    _, port_init, _, _, port_step, _ = bss.build_bss_step(_port(jp), R, "cpu")
    ps = port_init()
    key = jax.random.PRNGKey(3)
    u_back, u_coin = bss_draws(PRNGKey(3), 0, 200, R, jp.n)
    refreshed = 0
    for s in range(200):
        js = jstep(js, key)
        ps = port_step(ps, u_back[s], u_coin[s], step=s)
        want = bss_state_from_numpy(js, "cpu")
        for k, _, _ in BSS_STATE:
            if k != "geom_t":
                assert torch.equal(ps[k], want[k]), (stride, s + 1, k)
        assert np.array_equal(ps["geom_rx_w"].view(torch.int32).numpy(),
                              np.asarray(js["geom_rx_w"]).view(np.int32)), s
        assert np.array_equal(ps["geom_det"].numpy(),
                              np.asarray(js["geom_det"])), s
        # the tables are a function of geom_t: rebuilt, they are the same
        rebuilt = bss.with_tables(
            bss.build_bss_consts(_port(jp), "cpu"),
            {"geom_t": ps["geom_t"]})
        assert torch.equal(rebuilt["geom_rx_w"], ps["geom_rx_w"])
        refreshed += s % stride == 0
    assert refreshed == math.ceil(200 / stride)
    assert int(ps["tx_data"].sum()) > 0 and int(ps["srv_rx"].sum()) > 0


def _toy_run(model, stride, R=4, seed=1, **kw):
    jp = jax_toy_bss(8, 500_000)
    jp = dataclasses.replace(jp, mobility=_toy_motion(model, jp),
                             geom_stride=stride)
    want = jax_run_bss(jp, R, jax.random.PRNGKey(seed), **kw)
    got = bss.run_replicated_bss(_port(jp), R, PRNGKey(seed), device="cpu",
                                 **kw)
    return jp, want, got


def _equal(got, want, keys=OUT_KEYS):
    for k in keys:
        assert np.array_equal(got[k], np.asarray(want[k])), k


@pytest.mark.parametrize("model, stride", [("const_velocity", 8),
                                           ("waypoint", 3),
                                           ("random_walk", 2),
                                           ("static", 5)])
def test_run_equals_jax_per_replica(model, stride):
    """Whole runs per replica: the outputs, ``steps``, ``geom_refreshes``
    and ``geom_stride`` equal the JAX engine's."""
    _, want, got = _toy_run(model, stride)
    _equal(got, want)
    assert got["all_done"] and got["geom_refreshes"] == -(-got["steps"]
                                                          // stride)


def test_chunks_split_mid_stride():
    """``chunk_steps`` not a multiple of the stride: the chunk boundaries
    fall between refreshes, and the run equals the unchunked one and the
    JAX engine's chunked run."""
    jp, want, got = _toy_run("const_velocity", 7, chunk_steps=150)
    one = bss.run_replicated_bss(_port(jp), 4, PRNGKey(1), device="cpu")
    _equal(got, want)
    _equal(got, one)


def test_geom_per_step_equals_jax():
    """``geom_per_step=True`` rebuilds every step, as the reference's
    unconditional recompute; ``geom_refreshes`` still counts by the
    program's stride, as the reference reports it."""
    _, want, got = _toy_run("waypoint", 4, geom_per_step=True)
    _equal(got, want)


def test_horizon_sweep_of_a_mobile_program_equals_jax_sweep():
    """``sim_end_us=[...]`` on a mobile program: each point equals the
    JAX sweep's, its own ``steps`` and ``geom_refreshes``."""
    ends = [350_000, 500_000, 420_000]
    _, want, got = _toy_run("const_velocity", 5, sim_end_us=ends)
    for c in range(len(ends)):
        _equal(got[c], want[c])
    assert len({p["steps"] for p in got}) == len(ends)


def test_per_replica_stops_join_with_their_refreshes():
    """The ``MOB`` kernel's design on the CPU: each (point, replica)
    steps alone until its own stop; ``join_stops`` gives the replicas
    that stopped early the ``t`` and the geometry refresh of the steps
    the shared loop runs in their place, and equals the plain grid
    loop's state, ``geom_t`` included."""
    jp = jax_toy_bss(4, 400_000)
    jp = dataclasses.replace(jp, mobility=_toy_motion("const_velocity", jp),
                             geom_stride=3)
    port = _port(jp)
    R, ends = 3, [300_000, 400_000]
    consts, init, _ = bss.build_bss_advance(port, R, "cpu")
    key = PRNGKey(2)
    want, w_steps, _ = bss.bss_advance_math(consts, init(2), key, [0, 0],
                                            10_000, ends)
    u_back, u_coin = bss_draws(key, 0, max(w_steps), R, port.n)
    got, done, t_next = {k: [] for k in want}, [], []
    for end in ends:
        for r in range(R):
            one = bss.with_tables(consts, {k: v[0, r:r + 1]
                                           for k, v in init().items()})
            n = 0
            while bool(bss.pending(consts, one, end)[0]):
                one = bss.step_fn(consts, one, u_back[n, r:r + 1],
                                  u_coin[n, r:r + 1], end,
                                  refresh=n % 3 == 0)
                n += 1
            nxt = torch.minimum(bss.tx_times(consts, one).amin(1),
                                one["next_arr"].amin(1))
            t_next.append(torch.where(one["t"] < end,
                                      torch.maximum(one["t"], nxt),
                                      one["t"]))
            done.append(n)
            for k in got:
                got[k].append(one[k])
    got = {k: torch.cat(v).unflatten(0, (2, R)) for k, v in got.items()}
    done = torch.tensor(done, dtype=torch.int32).view(2, R)
    joined, steps = join_stops(got, done, torch.cat(t_next).view(2, R), 3,
                               ends)
    assert steps == w_steps
    assert int((done < done.amax(1, keepdim=True)).sum()) > 0
    for k in want:
        assert torch.equal(joined[k], want[k]), k


def test_three_winner_census_of_a_mobile_run():
    """ROADMAP C2 under motion: the plain loop's census counts the
    replica-steps with three or more same-µs winners (their mobile
    interference sum is the tie class); the run still equals the JAX
    engine's."""
    jp = dataclasses.replace(
        _lower(10, 1.15, mobility="const_velocity", speed=2.0,
               interval_s=0.01), geom_stride=4)
    consts, init, _ = bss.build_bss_advance(_port(jp), 4, "cpu")
    census = {}
    state, steps, _ = bss.bss_advance_math(
        consts, init(), PRNGKey(7), [0], bss._estimate_max_steps(jp),
        census=census)
    want = jax_run_bss(jp, 4, jax.random.PRNGKey(7))
    assert steps[0] == want["steps"]
    for k in ("srv_rx", "tx_data", "drops"):
        assert np.array_equal(state[k][0].numpy(), np.asarray(want[k])), k
    assert int(census["gated"]) > 0 and int(census["overlap"]) > 0
    assert int(census["three_winners"]) >= 0
