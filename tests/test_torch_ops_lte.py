"""The port's LTE link chain against tpudes.ops.lte (f32 path).

Tolerances: CQI and MCS exactly equal on a seeded SINR sweep (the port
follows the reference's compiled arithmetic, see tpudes_torch/ops/lte.py);
``mi_per_rb`` rtol 1e-6 (the two f32 ``log`` implementations may differ
by an ulp); ``tb_bler_ecr`` atol 1e-6 (jax's erfc is its own polynomial,
the port's is the platform's ``erfc``).  Tables and constants are copies
and compare exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudes.models.lte.scheduler as ref_sched
import tpudes.ops.lte as ref
import tpudes.ops.propagation as ref_prop
import tpudes_torch.models.lte.scheduler as port_sched
import tpudes_torch.ops.lte as port
import tpudes_torch.ops.propagation as port_prop


def _sinr_sweep(n=4096, seed=0):
    """Seeded SINRs from -15 dB to 35 dB plus exact CQI boundaries."""
    rng = np.random.default_rng(seed)
    db = rng.uniform(-15.0, 35.0, n)
    edges = (2.0 ** np.asarray(ref.CQI_EFFICIENCY[1:]) - 1.0) * ref.SNR_GAP
    return np.concatenate([10.0 ** (db / 10.0), edges]).astype(np.float32)


@pytest.mark.parametrize(
    "name",
    ["CQI_EFFICIENCY", "MCS_EFFICIENCY", "MCS_QM", "MCS_ECR", "SNR_GAP",
     "BLER_DISPERSION", "BLER_TARGET_Q", "RB_BANDWIDTH_HZ",
     "RE_PER_RB_DATA", "BOLTZMANN_T", "_CQI_EFF", "_MCS_EFF", "_MCS_QM",
     "_MCS_ECR", "_CQI_TO_MCS"],
)
def test_tables_are_exact_copies(name):
    a, b = np.asarray(getattr(ref, name)), np.asarray(getattr(port, name))
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("nf_db", [5.0, 9.0])
def test_noise_psd_equal(nf_db):
    assert port.noise_psd_w(nf_db) == ref.noise_psd_w(nf_db)


def test_scheduler_constants_and_rbg_sizes():
    assert port_sched.HARQ_RTT_TTIS == ref_sched.HARQ_RTT_TTIS
    assert port_sched.HARQ_MAX_TX == ref_sched.HARQ_MAX_TX
    for n_rb in range(1, 111):
        assert port_sched.rbg_size_for(n_rb) == ref_sched.rbg_size_for(n_rb)


@pytest.mark.parametrize("seed", [0, 1])
def test_cqi_and_mcs_exact(seed):
    sinr = _sinr_sweep(seed=seed)
    want_cqi = np.asarray(ref.cqi_from_sinr(jnp.asarray(sinr)))
    got_cqi = port.cqi_from_sinr(torch.from_numpy(sinr))
    assert got_cqi.dtype == torch.int32
    assert np.array_equal(got_cqi.numpy(), want_cqi)
    want_mcs = np.asarray(ref.mcs_from_cqi(jnp.asarray(want_cqi)))
    assert np.array_equal(port.mcs_from_cqi(got_cqi).numpy(), want_mcs)


def test_mi_per_rb_rtol():
    sinr = _sinr_sweep(seed=2)
    qm = np.random.default_rng(2).choice([2.0, 4.0, 6.0], sinr.size)
    qm = qm.astype(np.float32)
    want = np.asarray(ref.mi_per_rb(jnp.asarray(sinr), jnp.asarray(qm)))
    got = port.mi_per_rb(torch.from_numpy(sinr), torch.from_numpy(qm))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_tb_bler_ecr_atol():
    rng = np.random.default_rng(3)
    n = 4096
    mi = rng.uniform(0.0, 1.0, n).astype(np.float32)
    ecr = np.asarray(ref.MCS_ECR, np.float32)[rng.integers(0, 29, n)]
    tbb = np.floor(rng.uniform(0.0, 2e4, n)).astype(np.float32)
    want = np.asarray(
        ref.tb_bler_ecr(jnp.asarray(mi), jnp.asarray(ecr), jnp.asarray(tbb))
    )
    got = port.tb_bler_ecr(
        torch.from_numpy(mi), torch.from_numpy(ecr), torch.from_numpy(tbb)
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_friis_matches_reference_f32():
    """Friis at 2.12 GHz over seeded f32 distances (and d = 0): rtol
    1e-6 in dB (the f32 ``log`` may differ by an ulp)."""
    d = np.random.default_rng(4).uniform(1.0, 2000.0, 1024)
    d = np.concatenate([[0.0], d]).astype(np.float32)
    want = np.asarray(ref_prop.friis(jnp.float32(0.0), jnp.asarray(d), 2.12e9))
    got = port_prop.friis(
        torch.zeros((), dtype=torch.float32), torch.from_numpy(d), 2.12e9
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
