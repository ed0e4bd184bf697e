"""The port's compiled-arithmetic ops (``tpudes_torch.ops.fused``,
``ops/propagation.py``, the compiled CQI/MI chain of ``ops/lte.py``:
``gapped_log2(fused=True)``) against the reference's ops under ``jax.jit`` on the CPU.

The reference's device geometry stage runs under ``jit``: fused
multiply-adds, XLA's own ``log``, glibc's ``powf``, subnormals flushed.
The port writes that arithmetic out in IEEE f32/f64 and integer
operations; on inputs drawn with numpy from a seed over the ranges the
geometry stage meets (and beyond), every output here is bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu

from tpudes.ops import lte as ref_lte
from tpudes.ops import propagation as ref_prop
from tpudes_torch.ops import fused
from tpudes_torch.ops import lte, propagation

_torch_cpu.one_thread()

RNG = np.random.default_rng(20261016)


def _f32(a):
    return np.asarray(a, np.float32)


def _equal(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    return got.numpy().dtype == want.dtype and np.array_equal(
        got.numpy().view(np.int32), want.view(np.int32)
    )


@pytest.mark.parametrize("lo,hi", [(-200.0, 60.0), (-1600.0, 1400.0)])
def test_db_to_ratio_is_the_references_powf(lo, hi):
    """Bit-equal to ``10 ** (db / 10)`` compiled, the results that
    underflow f32's normal range flushed to 0 as the reference's are."""
    db = _f32(RNG.uniform(lo, hi, 400_000))
    want = jax.jit(ref_prop.db_to_ratio)(jnp.asarray(db))
    assert _equal(propagation.db_to_ratio(torch.from_numpy(db)), want)


@pytest.mark.parametrize("args", [(2.12e9, 1.0, 0.0), (5.15e9, 1.5, 30.0)])
def test_fused_friis_equals_compiled_friis(args):
    d = _f32(RNG.uniform(0.5, 3000.0, 200_000))
    d[:3] = [0.0, 1.0, 1e-3]
    want = jax.jit(lambda x: ref_prop.friis(jnp.float32(0.0), x, *args))(
        jnp.asarray(d)
    )
    td = torch.from_numpy(d)
    got = propagation.friis(fused.f32(td, 0.0), td, *args, fused=True)
    assert _equal(got, want)


@pytest.mark.parametrize("args", [(3.0, 1.0, 46.6777), (2.5, 2.0, 40.0)])
def test_log_distance_equals_compiled_log_distance(args):
    d = _f32(RNG.uniform(0.5, 3000.0, 200_000))
    want = jax.jit(
        lambda x: ref_prop.log_distance(jnp.float32(0.0), x, *args)
    )(jnp.asarray(d))
    td = torch.from_numpy(d)
    assert _equal(propagation.log_distance(fused.f32(td, 0.0), td, *args),
                  want)


def test_log_is_the_compilers_log():
    x = _f32(np.abs(RNG.standard_normal(300_000))
             * 10.0 ** RNG.uniform(-30.0, 30.0, 300_000))
    want = jax.jit(jnp.log)(jnp.asarray(x))
    assert _equal(fused.log(torch.from_numpy(x)), want)


def test_fma_and_sqrt_round_once():
    a, b, c = (_f32(RNG.standard_normal(200_000) * 100.0) for _ in range(3))
    want = jax.jit(lambda a, b, c: a * b + c)(a, b, c)
    got = fused.fma(*(torch.from_numpy(v) for v in (a, b, c)))
    assert _equal(got, want)
    x = _f32(RNG.uniform(1e-6, 1e7, 300_000))
    assert _equal(fused.sqrt(torch.from_numpy(x)), np.sqrt(x))


def test_fused_cqi_and_mi_chain_equals_compiled_chain():
    sinr = _f32(10.0 ** RNG.uniform(-2.5, 3.5, 200_000))
    mcs = RNG.integers(0, 29, sinr.shape)
    qm = ref_lte._MCS_QM[mcs]

    def chain(s, q):
        return ref_lte.cqi_from_sinr(s), ref_lte.mi_per_rb(s, q)

    want_cqi, want_mi = jax.jit(chain)(jnp.asarray(sinr), jnp.asarray(qm))
    ts = torch.from_numpy(sinr)
    se = lte.gapped_log2(ts, fused=True)
    assert np.array_equal(lte.cqi_from_efficiency(se).numpy(),
                          np.asarray(want_cqi))
    assert _equal(lte.mi_from_efficiency(se, torch.from_numpy(qm)), want_mi)
