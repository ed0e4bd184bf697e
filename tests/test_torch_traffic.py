"""The port's traffic programs against ``tpudes.traffic``.

Each program is built by the reference's factories and carried across
with ``traffic_from_numpy``.  Tolerances: none.  The eager tables and
the operands are bit-equal; ``offered_table``'s rows are bit-equal to
the reference's jitted ``bits_fn`` at the same windows and traffic key
(0 ulp: the port writes out the compiled arithmetic, glibc's ``powf``
included); ``offered_bits_mean`` is equal.  The draws the tables and the
per-window sizes take (``uniform`` of shapes ``()`` and ``(2,)``, the
``TRAFFIC_KEY_TAG`` fold) are bit-equal to ``jax.random``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu

from tpudes.traffic.device import TRAFFIC_KEY_TAG as JAX_TAG
from tpudes.traffic.device import build_bits_fn
from tpudes.traffic.host import offered_bits_mean as jax_offered_bits_mean
from tpudes.traffic.program import TrafficProgram as JaxTraffic
from tpudes.traffic.program import traffic_tables as jax_tables
from tpudes_torch.convert import TRAFFIC_FIELDS, traffic_from_numpy
from tpudes_torch.ops.fused import powf
from tpudes_torch.random import PRNGKey, fold_in, uniform
from tpudes_torch.traffic.device import (
    TRAFFIC_KEY_TAG,
    offered_table,
    pareto_sizes,
)
from tpudes_torch.traffic.host import offered_bits_mean
from tpudes_torch.traffic.program import TrafficProgram, traffic_tables

_torch_cpu.one_thread()

N = 6
HORIZON_US = 400_000
SIZES = np.asarray([1.4, 800.0, 12000.0], np.float32)


def _trace(n=N):
    rng = np.random.default_rng(5)
    k = 40
    t = np.sort(rng.integers(0, HORIZON_US, (n, k)), axis=1)
    t[:, -5:] = 2**31 - 1                      # padding past GAP_INF
    b = rng.integers(40, 1500, (n, k))
    return JaxTraffic.trace_replay(t, b)


def _programs():
    mmpp = JaxTraffic.mmpp(N, 400.0, horizon_us=HORIZON_US, epoch_s=0.01,
                           envelope=(0.5, 0.2, 0.1), tr_seed=3)
    onoff = JaxTraffic.onoff(N, 900.0, horizon_us=HORIZON_US,
                             on=(1.5, 0.01, 0.05), off_mean_s=0.02,
                             start_us=np.arange(N) * 1000, tr_seed=2)
    cbr = JaxTraffic.cbr(np.arange(N) * 700, np.arange(N) * 900 + 450)
    mixed = dataclasses.replace(
        onoff, model_id=np.asarray([0, 1, 2, 2, 1, 0], np.int32),
        interval_us=np.full(N, 1300, np.int32),
        rate_pps=np.full(N, 500.0, np.float32),
        mmpp_mult=mmpp.mmpp_mult, mmpp_p=mmpp.mmpp_p,
        epoch_us=mmpp.epoch_us, n_epoch=mmpp.n_epoch,
    )
    progs = dict(cbr=cbr, mmpp=mmpp, onoff=onoff, trace=_trace(),
                 mixed=mixed)
    return {k: dataclasses.replace(p, size_pareto=SIZES)
            for k, p in progs.items()}


PROGRAMS = _programs()


def _port(prog):
    return traffic_from_numpy({k: getattr(prog, k) for k in TRAFFIC_FIELDS})


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_tables_and_operands_bit_equal(name):
    prog = PROGRAMS[name]
    want, got = jax_tables(prog), traffic_tables(_port(prog))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k
    want_ops = prog.operands()
    got_ops = _port(prog).operands("cpu")
    assert set(got_ops) == set(want_ops)
    for k, w in want_ops.items():
        g = got_ops[k].numpy()
        assert g.dtype == np.asarray(w).dtype, k
        assert np.array_equal(_bits(g), _bits(w)), k


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_offered_table_bit_equal_to_bits_fn(name):
    """200 TTI windows from TTI 50: each row is the reference's ``bits_fn``
    of that window, 0 ulp."""
    prog = PROGRAMS[name]
    key = jax.random.fold_in(jax.random.PRNGKey(9), JAX_TAG)
    bits_fn = jax.jit(build_bits_fn(prog))
    ops = prog.operands()
    t0, t1 = 50, 250
    want = np.stack([
        np.asarray(bits_fn(ops, key, jnp.int32(t * 1000),
                           jnp.int32((t + 1) * 1000)))
        for t in range(t0, t1)
    ])
    port = _port(prog)
    got = offered_table(port.operands("cpu"), port.epoch_us,
                        torch.as_tensor(np.asarray(key, np.int64)), t0, t1)
    assert got.shape == (t1 - t0, N) and got.dtype == torch.float32
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    assert want.sum() > 0


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_offered_bits_mean_equal(name):
    prog = PROGRAMS[name]
    for t_us in (0, 123_456, HORIZON_US):
        assert np.array_equal(offered_bits_mean(_port(prog), t_us),
                              jax_offered_bits_mean(prog, t_us))


def test_traffic_key_fold_and_scalar_draws_bit_equal():
    assert TRAFFIC_KEY_TAG == JAX_TAG
    jkey = jax.random.fold_in(jax.random.PRNGKey(7), JAX_TAG)
    tkey = fold_in(PRNGKey(7), TRAFFIC_KEY_TAG)
    assert np.array_equal(tkey.numpy(), np.asarray(jkey).astype(np.int64))
    for d in (0, 1, 5, 1234567):
        k1, k2 = (jax.random.fold_in(jkey, i) for i in (d, d + 1))
        t1, t2 = (fold_in(tkey, i) for i in (d, d + 1))
        one = np.asarray(jax.random.uniform(k1, (), jnp.float32))
        two = np.asarray(jax.random.uniform(k2, (2,), jnp.float32))
        assert _bits(uniform(t1, 1)[0].numpy()) == _bits(one)
        assert np.array_equal(_bits(uniform(t2, 2).numpy()), _bits(two))


def test_powf_and_pareto_sizes_bit_equal():
    """glibc ``powf`` written out, against the reference's compiled
    ``power`` over seeded operands; the size draw's whole arithmetic."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0.0, 1.0, 40000),
                        10.0 ** rng.uniform(-30.0, 30.0, 40000),
                        [0.0, 1.0, 2.0]]).astype(np.float32)
    y = np.concatenate([rng.uniform(-4.0, 4.0, 80000),
                        [2.0, -1.0, 0.0]]).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: a ** b)(x, y))
    got = powf(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    from tpudes.traffic.device import _traced_pareto_sizes

    u = rng.uniform(0.0, 1.0, 50000).astype(np.float32)
    for sizes in (SIZES, np.asarray([0.9, 40.0, 1500.0], np.float32),
                  np.asarray([0.0, 512.0, 512.0], np.float32)):
        want = np.asarray(jax.jit(_traced_pareto_sizes)(u, sizes))
        got = pareto_sizes(torch.from_numpy(u), torch.from_numpy(sizes))
        assert np.array_equal(_bits(got.numpy()), _bits(want)), sizes


def test_factories_equal_reference():
    """The port's factories give the reference's programs."""
    pairs = (
        (TrafficProgram.cbr(np.arange(4), 1000),
         JaxTraffic.cbr(np.arange(4), 1000)),
        (TrafficProgram.mmpp(4, 50.0, horizon_us=10**6, tr_seed=1),
         JaxTraffic.mmpp(4, 50.0, horizon_us=10**6, tr_seed=1)),
        (TrafficProgram.onoff(4, 50.0, horizon_us=10**6,
                              envelope=(0.3, 1.0, 0.0)),
         JaxTraffic.onoff(4, 50.0, horizon_us=10**6,
                          envelope=(0.3, 1.0, 0.0))),
        (TrafficProgram.trace_replay([[5, 9, 2**31 - 1]], [[100, 200]]),
         JaxTraffic.trace_replay([[5, 9, 2**31 - 1]], [[100, 200]])),
    )
    for got, want in pairs:
        assert got.param_key() == want.param_key()
        assert got.shape_key() == want.shape_key()
        assert np.array_equal(got.model_ids(), want.model_ids())
    with pytest.raises(ValueError, match="ascend"):
        TrafficProgram.trace_replay([[9, 5]])
    with pytest.raises(ValueError, match="unknown traffic model"):
        dataclasses.replace(pairs[0][0], model="poisson")
