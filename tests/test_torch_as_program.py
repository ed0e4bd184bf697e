"""The AS flow engine's inputs in the port against the reference.

- MRG32k3a at ``(seed, 0, 0)`` (``tpudes_torch.core.rng.RngStream``) draws
  what the reference's ``RngStream`` draws, ``RandU01`` and ``RandInt``;
- ``seeded_bulk_generator`` and the BA generator
  (``tpudes_torch.helper.topology``) give the reference's arrays, at the
  bench's 10,000 nodes too;
- ``scenarios.as_program`` equals ``lower_as_flows(build_as_network(...))``
  field by field (``reset_world()`` before and after the host build);
- ``random.normal`` and ``random.as_replica_draws`` are bit-equal to
  ``jax.random.normal`` and the reference's ``_as_replica_draws``, and
  ``toy_as_program`` to the reference's.

Tolerance: none (bits and integers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu

from tpudes.core.rng import RngStream as JaxRng
from tpudes.core.world import reset_world
from tpudes.helper.topology import BriteTopologyHelper as JaxBrite
from tpudes.parallel.as_flows import _as_replica_draws, lower_as_flows
from tpudes.parallel.programs import toy_as_program as jax_toy
from tpudes.scenarios import build_as_network
from tpudes_torch import random as port_random
from tpudes_torch.convert import AS_FIELDS
from tpudes_torch.core.rng import RngStream, seeded_bulk_generator
from tpudes_torch.helper.topology import BriteTopologyHelper, component_labels
from tpudes_torch.parallel.programs import toy_as_program
from tpudes_torch.scenarios import as_program

_torch_cpu.one_thread()


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [1, 3, 7, 12345, 4294967087, 2**33 + 5])
def test_mrg32k3a_draws_equal_reference(seed):
    a, b = JaxRng(seed, 0, 0), RngStream(seed, 0, 0)
    assert [a.RandU01() for _ in range(500)] == [b.RandU01()
                                                  for _ in range(500)]
    assert [a.RandInt(0, 9_999) for _ in range(500)] == [
        b.RandInt(0, 9_999) for _ in range(500)]
    assert a.get_state() == b.get_state()


def test_other_streams_are_refused():
    with pytest.raises(NotImplementedError):
        RngStream(1, 1, 0)


@pytest.mark.parametrize("stream", [0, 3, 9])
def test_bulk_generator_equals_reference(stream):
    from tpudes.core.rng import seeded_bulk_generator as jax_bulk

    reset_world()
    want = jax_bulk(stream).integers(0, 2**31, 1000)
    got = seeded_bulk_generator(stream, 1, 1).integers(0, 2**31, 1000)
    assert np.array_equal(want, got)
    other = seeded_bulk_generator(stream, 1, 2).integers(0, 2**31, 1000)
    assert not np.array_equal(want, other)


@pytest.mark.parametrize("n, seed", [(60, 8), (500, 9), (10_000, 3)])
def test_ba_generate_equals_reference(n, seed):
    reset_world()
    want = JaxBrite(model="BA", n=n, m=2, seed=seed).Generate()
    got = BriteTopologyHelper(model="BA", n=n, m=2, seed=seed).Generate()
    assert got.n == want.n and got.m == want.m
    assert np.array_equal(got.edges, want.edges)
    for name in ("delay_s", "rate_bps", "pos"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    if n <= 500:
        assert got.is_connected()
        assert np.array_equal(component_labels(n, got.edges),
                              component_labels(n, want.edges))


def test_waxman_is_refused():
    with pytest.raises(NotImplementedError):
        BriteTopologyHelper(model="Waxman")


def _lowered(n, flows, sim_s, **kw):
    reset_world()
    try:
        build_as_network(n, flows, sim_s, **kw)
        return lower_as_flows(sim_s)
    finally:
        reset_world()


@pytest.mark.parametrize("n, flows, kw", [
    (60, 4, dict(seed=8)),
    (60, 7, dict(seed=2, flow_kbps=800.0, pkt_bytes=256)),
    (200, 12, dict(seed=5, flow_kbps=200.0)),
    (200, 9, dict(seed=1, m=3)),
])
def test_as_program_equals_lowering(n, flows, kw):
    want = _lowered(n, flows, 2.0, **kw)
    got = as_program(n, flows, 2.0, **kw)
    for name in AS_FIELDS:
        a, b = getattr(want, name), getattr(got, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert np.array_equal(a, b), name
        else:
            assert a == b, name


def test_toy_program_equals_reference():
    reset_world()
    want, got = jax_toy(40, 5, 8, seed=3), toy_as_program(40, 5, 8, seed=3)
    for name in AS_FIELDS:
        a, b = getattr(want, name), getattr(got, name)
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b


def test_normal_equals_jax_on_many_keys():
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(96))
    keys = jnp.concatenate([keys, jax.random.split(jax.random.PRNGKey(7),
                                                   32)])
    want = np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (2048,), jnp.float32))(keys))
    got = port_random.normal(torch.as_tensor(np.asarray(keys, np.int64)),
                             2048).numpy()
    assert np.array_equal(_bits(want), _bits(got))
    assert np.isfinite(got).all() and abs(got.mean()) < 0.01


def test_normal_shapes_and_erf_inv_edges():
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.normal(key, (3, 5), jnp.float32))
    got = port_random.normal(torch.tensor([0, 11]), (3, 5)).numpy()
    assert np.array_equal(_bits(want), _bits(got))
    from tpudes_torch.ops.fused import erf_inv

    x = np.float32([-1.0, 1.0, 0.0, -0.99999994, 0.5, 0.999])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x)))
    got = erf_inv(torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(want), _bits(got))


@pytest.mark.parametrize("seed, replicas, flows", [(0, 64, 128), (3, 5, 7),
                                                   (2**31 - 1, 9, 1)])
def test_as_replica_draws_equal_reference(seed, replicas, flows):
    class Prog:
        src = np.zeros(flows, np.int32)

    want = np.asarray(_as_replica_draws(Prog, jax.random.PRNGKey(seed),
                                        replicas))
    got = port_random.as_replica_draws(torch.tensor([0, seed]), replicas,
                                       flows).numpy()
    assert np.array_equal(_bits(want), _bits(got))
