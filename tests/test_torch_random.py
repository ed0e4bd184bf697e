"""The port's threefry draws are bit-equal to jax.random.

Held against jax 0.9.0's defaults (threefry2x32, partitionable, x64
off) over the key chains the LTE SM engine draws from:
``replica_keys`` (tpudes/parallel/runtime.py:139), then
``fold_in(k, t)`` and ``uniform(., (U,), f32)`` (lte_sm.py:678, :423);
and the BSS engine's ``split(fold_in(fold_in(key, step), r))`` then
``uniform(., (N,), f32)`` of each half (replicated.py:744-770).
Tolerance: none — every word and every float is compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudes.parallel.runtime import replica_keys as jax_replica_keys
from tpudes_torch import random as tr

SEEDS = (0, 1, 3, 11, 2**31 - 1, -7)


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_words(seed):
    assert np.array_equal(tr.PRNGKey(seed).numpy(), _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bit_equal(seed):
    data = np.random.default_rng(seed & 0xFFFF).integers(0, 2**31 - 1, 6)
    key = jax.random.PRNGKey(seed)
    got = tr.fold_in(tr.PRNGKey(seed), torch.as_tensor(data)).numpy()
    want = np.stack([_words(jax.random.fold_in(key, int(d))) for d in data])
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 4, 64])
def test_replica_keys_bit_equal(n):
    key = jax.random.PRNGKey(5)
    got = tr.replica_keys(tr.PRNGKey(5), n).numpy()
    assert np.array_equal(got, _words(jax_replica_keys(key, n)))


def test_threefry_hash_bit_equal():
    from jax._src.prng import threefry_2x32

    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(threefry_2x32(jnp.asarray(k), jnp.asarray(x)))
    kt = torch.as_tensor(k.astype(np.int64))
    xt = torch.as_tensor(x.astype(np.int64))
    y0, y1 = tr.threefry2x32(kt[0], kt[1], xt[:32], xt[32:])
    assert np.array_equal(torch.cat([y0, y1]).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [1, 7, 210])
def test_uniform_bit_equal(n):
    key = jax.random.fold_in(jax.random.PRNGKey(9), 123)
    got = tr.uniform(torch.as_tensor(_words(key)), n).numpy()
    want = np.asarray(jax.random.uniform(key, (n,), jnp.float32))
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", [0, 3])
def test_engine_coin_chain_bit_equal(seed):
    """``tti_coins`` draws a (T, R, U) chunk equal, element by element,
    to the reference's per-(replica, TTI) draws."""
    R, U, t0, t1 = 3, 5, 17, 21
    keys = jax_replica_keys(jax.random.PRNGKey(seed), R)
    got = tr.tti_coins(tr.replica_keys(tr.PRNGKey(seed), R), t0, t1, U)
    assert got.shape == (t1 - t0, R, U)
    for i, t in enumerate(range(t0, t1)):
        for r in range(R):
            want = jax.random.uniform(
                jax.random.fold_in(keys[r], t), (U,), jnp.float32
            )
            assert np.array_equal(
                got[i, r].numpy().view(np.int32),
                np.asarray(want).view(np.int32),
            ), (t, r)


def test_seed_out_of_range_is_refused():
    with pytest.raises(ValueError):
        tr.PRNGKey(2**32)


def test_split_bit_equal_on_1000_keys():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, (1000, 2), dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jax.vmap(jax.random.split)(jnp.asarray(words)))
    got = tr.split(torch.as_tensor(words.astype(np.int64))).numpy()
    assert got.shape == (1000, 2, 2)
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed, s0", [(0, 0), (5, 987)])
def test_bss_draw_chain_bit_equal(seed, s0):
    """``bss_draws`` for 1,000 steps x 4 replicas x 65 nodes equals the
    reference's per-(step, replica) chain, step folded in first."""
    R, N, S = 4, 65, 1000
    key = jax.random.PRNGKey(seed)

    def chain(step):
        k = jax.random.fold_in(key, step)

        def draw(r):
            k_back, k_coin = jax.random.split(jax.random.fold_in(k, r))
            return (jax.random.uniform(k_back, (N,), jnp.float32),
                    jax.random.uniform(k_coin, (N,), jnp.float32))

        return jax.vmap(draw)(jnp.arange(R))

    wb, wc = jax.jit(jax.vmap(chain))(jnp.arange(s0, s0 + S))
    gb, gc = tr.bss_draws(tr.PRNGKey(seed), s0, s0 + S, R, N)
    assert gb.shape == (S, R, N) and gc.shape == (S, R, N)
    assert np.array_equal(gb.numpy().view(np.int32),
                          np.asarray(wb).view(np.int32))
    assert np.array_equal(gc.numpy().view(np.int32),
                          np.asarray(wc).view(np.int32))
