"""The port's NIST error model against the reference's compiled one.

The reference's BSS step runs ``mode_chunk_success_rate`` under ``jit``
with the mode and ``nbits`` constants, so its CPU executable folds the
per-mode numbers and runs XLA's own ``erfc``, ``exp``, ``log`` and
``log1p`` with fused multiply-adds (``tpudes_torch/ops/fused.py``).  The
reference side here is that: each function jitted with the mode (or the
constellation, or the rate class) and ``nbits`` closed over as
constants.  A naive PyTorch form (``torch.special.erfc``, ``exp``,
``log1p``) differs from it on 46 % of the SNRs where a coin decides.

Tolerance: none — bit-equal on every SNR of a grid from -10 to 40 dB
(20,001 points) for all 20 modes and nbits in {100, 5832, 12000}; the
share that differs (0) is printed with the share of mid-range rates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import erfc as jax_erfc

import _torch_cpu

from tpudes.ops import wifi_error as ref
from tpudes_torch.ops import fused
from tpudes_torch.ops import interference
from tpudes_torch.ops import wifi_error as port

_torch_cpu.one_thread()

SNR_DB = np.linspace(-10.0, 40.0, 20001)
SNR = (10.0 ** (SNR_DB / 10.0)).astype(np.float32)
NBITS = (100.0, 5832.0, 12000.0)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _differ(got: torch.Tensor, want) -> np.ndarray:
    return _bits(got.numpy()) != _bits(want)


@pytest.mark.parametrize("mode", range(len(ref.ALL_MODES)))
def test_mode_chunk_success_rate_bit_equal(mode):
    for nbits in NBITS:
        f = jax.jit(lambda s: ref.mode_chunk_success_rate(
            s, jnp.asarray(nbits, jnp.float32), jnp.asarray(mode)))
        want = np.asarray(f(SNR))
        got = port.mode_chunk_success_rate(torch.from_numpy(SNR), nbits, mode)
        differ = _differ(got, want)
        mid = (want > 1e-3) & (want < 0.999)
        print(f"mode {mode} ({ref.ALL_MODES[mode].name}), nbits {nbits:g}: "
              f"{differ.mean():.3%} of {SNR.size} differ, {mid.sum()} "
              f"mid-range, {(differ & mid).sum()} of them differ")
        assert not differ.any(), (mode, nbits, SNR[differ][:5])


@pytest.mark.parametrize("constellation", [2, 4, 16, 64, 256, 1024])
def test_uncoded_ber_bit_equal(constellation):
    f = jax.jit(lambda s: ref.uncoded_ber(s, jnp.float32(constellation)))
    got = port.uncoded_ber(torch.from_numpy(SNR), constellation)
    assert not _differ(got, f(SNR)).any()
    if constellation >= 16:
        g = jax.jit(lambda s: ref._qam_ber(s, jnp.float32(constellation)))
        assert not _differ(port._qam_ber(torch.from_numpy(SNR),
                                         constellation), g(SNR)).any()


@pytest.mark.parametrize("rate_class", range(4))
def test_coded_pe_bit_equal(rate_class):
    ber = np.concatenate([
        np.linspace(0.0, 0.5, 20001),
        10.0 ** np.linspace(-30.0, -0.31, 20001),
    ]).astype(np.float32)
    f = jax.jit(lambda b: ref.coded_pe(b, jnp.int32(rate_class)))
    got = port.coded_pe(torch.from_numpy(ber), rate_class)
    assert not _differ(got, f(ber)).any()


def test_chunk_success_rate_bit_equal():
    f = jax.jit(lambda s: ref.chunk_success_rate(
        s, jnp.float32(5832.0), jnp.float32(64.0), jnp.int32(2)))
    got = port.chunk_success_rate(torch.from_numpy(SNR), 5832.0, 64, 2)
    assert not _differ(got, f(SNR)).any()


def _grid(rng, lo, hi, n=200_000):
    return rng.uniform(lo, hi, n).astype(np.float32)


@pytest.mark.parametrize("name", ["exp", "log1p", "erfc"])
def test_compiled_transcendentals_bit_equal(name):
    """``fused.exp``, ``log1p`` and ``erfc`` against the compiled ones
    over their ranges in the chain, subnormal results flushed to 0."""
    rng = np.random.default_rng(0)
    x = {
        "exp": np.concatenate([_grid(rng, -100.0, 100.0),
                               _grid(rng, -1.0, 1.0)]),
        "log1p": np.concatenate([
            _grid(rng, -0.45, 0.45),
            -np.exp(_grid(rng, -25.0, -0.8)).astype(np.float32),
            _grid(rng, -0.99, 3.0)]),
        "erfc": np.concatenate([_grid(rng, 0.0, 12.0), _grid(rng, -3.0, 3.0)]),
    }[name]
    want = jax.jit({"exp": jnp.exp, "log1p": jnp.log1p,
                    "erfc": jax_erfc}[name])(x)
    got = getattr(fused, name)(torch.from_numpy(x))
    assert not _differ(got, want).any()


def test_naive_torch_chain_differs_where_coins_decide():
    """Why the chain is written out: PyTorch's own ``erfc``/``exp``/
    ``log1p`` in the same order differ from the compiled reference on a
    large share of the mid-range success rates (printed)."""
    snr = torch.from_numpy(SNR)
    f = jax.jit(lambda s: ref.mode_chunk_success_rate(
        s, jnp.float32(5832.0), jnp.asarray(7)))
    want = np.asarray(f(SNR))
    z = torch.sqrt(snr / 21.0)
    ber = (2.0 * (1.0 - 1.0 / 8.0) / 6.0) * torch.special.erfc(z)
    p = ber.clamp(0.0, 0.5)
    log_d = torch.log(torch.sqrt(4.0 * p * (1.0 - p)).clamp_min(1e-35))
    c = torch.tensor(ref.PE_COEFFS_TABLE[2], dtype=torch.float32)
    e = torch.tensor(ref.PE_EXPONENTS_TABLE[2], dtype=torch.float32)
    pe = (torch.exp(torch.log(c) + e * log_d[:, None]).sum(-1) / 6.0)
    naive = torch.exp(5832.0 * torch.log1p(-pe.clamp(0.0, 1.0)))
    mid = (want > 1e-3) & (want < 0.999)
    share = _differ(naive, want)[mid].mean()
    print(f"naive torch chain: {share:.1%} of {mid.sum()} mid-range rates "
          f"differ from the compiled reference")
    assert share > 0.05


def test_mode_tables_equal_the_reference():
    assert [(m.name, m.index, m.constellation, m.rate_class, m.data_rate_bps,
             m.bits_per_symbol, m.standard) for m in port.ALL_MODES] == [
        (m.name, m.index, m.constellation, m.rate_class, m.data_rate_bps,
         m.bits_per_symbol, m.standard) for m in ref.ALL_MODES]
    assert port.MODES_BY_NAME.keys() == ref.MODES_BY_NAME.keys()
    for a, b in ((port.MODE_CONSTELLATION, ref.MODE_CONSTELLATION),
                 (port.MODE_RATE_CLASS, ref.MODE_RATE_CLASS),
                 (port.MODE_DATA_RATE, ref.MODE_DATA_RATE)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert port.B_FACTOR_TABLE == ref.B_FACTOR_TABLE
    assert port.PE_COEFFS_TABLE == ref.PE_COEFFS_TABLE
    assert port.PE_EXPONENTS_TABLE == ref.PE_EXPONENTS_TABLE
    assert port.QAM_DIVISORS == ref.QAM_DIVISORS


@pytest.mark.parametrize("bw, nf", [(20e6, 7.0), (40e6, 9.0), (5e6, 0.0)])
def test_thermal_noise_equals_the_reference(bw, nf):
    from tpudes.ops.interference import thermal_noise_w

    assert interference.thermal_noise_w(bw, nf) == thermal_noise_w(bw, nf)
