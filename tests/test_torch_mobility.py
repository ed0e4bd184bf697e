"""The port's closed-form mobility (``tpudes_torch.ops.mobility``) against
``tpudes.ops.mobility`` on the CPU.

One motion of each model, made with numpy from a seed, is built with the
reference's factories and carried across with ``mobility_from_numpy``.
Positions on a grid of times are compared with the reference's compiled
position kernel (``trajectory_positions``, the kernel the engines trace).

Tolerances: ``static``, ``const_velocity`` and ``waypoint`` positions are
bit-equal.  The walk's velocities take ``sin``/``cos``, which the C
library (the reference) and the port's f64 rounded to f32 round
differently now and then: they are within ``WALK_VEL_ULP`` ulp, and the
walk's positions (displacements summed over segments from those
velocities) within ``WALK_POS_ATOL`` metres.
``fold_into_bounds`` and ``max_speed_mps`` are exact.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu

from tpudes.ops import mobility as ref
from tpudes_torch.convert import MOBILITY_FIELDS, mobility_from_numpy
from tpudes_torch.ops import mobility as mob

_torch_cpu.one_thread()

N = 12
HORIZON_US = 3_500_000
T_US = np.concatenate([
    [0, 1, 999, 1000, 123_457, 999_999, 1_000_000, 1_000_001],
    np.linspace(0, HORIZON_US, 37).astype(np.int64),
]).astype(np.int32)
WALK_VEL_ULP = 1
WALK_POS_ATOL = 1e-4


def _ref_programs():
    rng = np.random.default_rng(7)
    base = rng.uniform(-300.0, 300.0, (N, 3)).astype(np.float32)
    base[:, 2] = 1.5
    vel = rng.uniform(-15.0, 15.0, (N, 3)).astype(np.float32)
    vel[:, 2] = 0.0
    speed = np.tile([2.0, 12.0], (N, 1)).astype(np.float32)
    speed[0] = 0.0                                      # a pinned node
    wp_t = np.sort(rng.integers(0, HORIZON_US, (N, 4)), axis=1)
    wp_t[1] = wp_t[1, 0]                                 # all pauses
    wp_p = rng.uniform(-200.0, 200.0, (N, 4, 3)).astype(np.float32)
    return {
        "static": ref.MobilityProgram.static(base),
        "const_velocity": ref.MobilityProgram.constant_velocity(base, vel),
        "random_walk": ref.MobilityProgram.random_walk(
            base, (-250.0, 250.0, -200.0, 220.0), speed,
            seg_s=0.5, horizon_us=HORIZON_US, mob_seed=5,
        ),
        "waypoint": ref.MobilityProgram.waypoints(wp_t, wp_p),
    }


REF = _ref_programs()


def _port(prog):
    return mobility_from_numpy({k: getattr(prog, k) for k in MOBILITY_FIELDS})


def _positions(prog):
    port = _port(prog)
    got = mob.build_position_fn(port)(
        port.operands("cpu"), torch.from_numpy(T_US)
    ).numpy()
    want = ref.trajectory_positions(prog, T_US.tolist())
    return got, want


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("model", ["static", "const_velocity", "waypoint"])
def test_closed_form_positions_bit_equal(model):
    got, want = _positions(REF[model])
    assert got.shape == (len(T_US), N, 3) and got.dtype == np.float32
    assert np.array_equal(got, want)
    if model != "static":
        assert not np.array_equal(got[0], got[-1])


def test_walk_velocities_within_ulps():
    prog = REF["random_walk"]
    got = mob.walk_segment_velocities(_port(prog), "cpu").numpy()
    want = np.asarray(ref.walk_segment_velocities(prog))
    assert got.shape == want.shape == (prog.n_seg, N, 2)
    assert _ulps(got, want).max() <= WALK_VEL_ULP
    assert np.all(got[:, 0] == 0.0)                    # the pinned node


def test_walk_positions_within_bound_and_inside_the_box():
    got, want = _positions(REF["random_walk"])
    np.testing.assert_allclose(got, want, rtol=0, atol=WALK_POS_ATOL)
    xmin, xmax, ymin, ymax = REF["random_walk"].bounds
    walkers = got[:, 1:]
    assert np.all((walkers[..., 0] >= xmin) & (walkers[..., 0] <= xmax))
    assert np.all((walkers[..., 1] >= ymin) & (walkers[..., 1] <= ymax))
    assert np.all(got[:, 0] == REF["random_walk"].base_pos[0])


def test_walk_draw_is_the_flat_uniform_reshaped():
    """The reference draws ``uniform(key, (n, 2))``; the port draws the
    flat ``2n`` and reshapes: the same bits."""
    from tpudes_torch.random import PRNGKey, fold_in, uniform

    key = jax.random.fold_in(jax.random.PRNGKey(mob._MOB_ROOT_SEED), 5)
    want = np.asarray(jax.random.uniform(jax.random.fold_in(key, 3), (N, 2)))
    tkey = fold_in(fold_in(PRNGKey(mob._MOB_ROOT_SEED), 5), 3)
    got = uniform(tkey, 2 * N).reshape(N, 2).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(-250.0, 250.0), (10.0, 13.5), (5.0, 5.0),
                                   (7.0, -1.0)])
def test_fold_into_bounds_equals_reference(lo, hi):
    x = np.random.default_rng(3).uniform(-2000.0, 2000.0, 4000).astype(
        np.float32
    )
    x[:4] = [lo, hi, 2 * hi - lo, lo - (hi - lo)]
    want = np.asarray(jax.jit(ref.fold_into_bounds)(
        jnp.asarray(x), jnp.float32(lo), jnp.float32(hi)
    ))
    got = mob.fold_into_bounds(
        torch.from_numpy(x), torch.tensor(np.float32(lo)),
        torch.tensor(np.float32(hi)),
    ).numpy()
    assert np.array_equal(got, want)
    if hi > lo:
        assert np.all((got >= lo) & (got <= hi))
    else:
        assert np.all(got == np.float32(lo))


@pytest.mark.parametrize("model", list(mob.MOB_MODEL_IDS))
def test_max_speed_and_keys_equal_reference(model):
    prog = REF[model]
    port = _port(prog)
    assert mob.max_speed_mps(port) == ref.max_speed_mps(prog)
    assert port.shape_key() == prog.shape_key()
    assert port.param_key() == prog.param_key()
    assert port.operands("cpu")["mob_id"] == ref.MOB_MODEL_IDS[model]


def test_factories_equal_reference():
    prog = REF["random_walk"]
    again = mob.MobilityProgram.random_walk(
        prog.base_pos, prog.bounds, prog.speed, seg_s=0.5,
        horizon_us=HORIZON_US, mob_seed=5,
    )
    assert again.param_key() == prog.param_key()
    wp = REF["waypoint"]
    assert mob.MobilityProgram.waypoints(
        wp.wp_t, wp.wp_p
    ).param_key() == wp.param_key()
    with pytest.raises(ValueError, match="ascend"):
        mob.MobilityProgram.waypoints([[5, 1]], np.zeros((1, 2, 3)))
    with pytest.raises(ValueError, match="unknown mobility"):
        mob.MobilityProgram._fill("teleport", np.zeros((1, 3)))


def test_stride_advisory():
    cv = _port(REF["const_velocity"])
    with pytest.warns(UserWarning, match="coherence"):
        mob.warn_geom_stride("t", cv, 400, 1e-3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mob.warn_geom_stride("t", cv, 1, 1e-3)
        mob.warn_geom_stride("t", _port(REF["static"]), 10**6, 1e-3)
