"""The port's fused PHY window against the reference's, on the CPU.

``tpudes_torch.parallel.kernels`` (``wifi_phy_window``, ``replicated``,
``multi_window_scan``) is held against ``tpudes.parallel.kernels``, the
reference jitted as its own tests run it on the CPU (the window under
``jax.jit``, ``replicated`` jitted, the scan jitted and vmapped over
replica keys); the inputs are made with numpy from a seed.  The
per-element error model (``mode_chunk_success_rate`` with a mode tensor,
``table_chunk_success_rate``), the compiled ``log10``, the float64 PER
table and ``uniform(key, (n, n))`` are held against the reference's too.

Tolerance: none.  ``sinr`` and ``rx_dbm`` are bit-equal, diagonal
included; the error models' rates are bit-equal on an SNR sweep of 1,001
points for every mode; so the ``ok`` masks are equal, and the count of
``coin`` draws within an f32 ulp of their pair's PSR (the pairs where
any difference in the PSR's last bit could flip a decode) is printed.
The scan's totals are equal.

The CUDA kernel ``csrc/wifi_window.cu`` runs here too: built by ``g++``
against ``tpudes_torch/csrc/mock/cuda_runtime.h`` (a thread per CUDA
thread) and called through its wrapper on CPU tensors, it must equal the
plain version bit for bit (skips where ``g++`` is missing); on the card
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it.
"""

import ctypes
import shutil
import subprocess
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudes.ops import wifi_error as ref_err
from tpudes.parallel import kernels as J
from tpudes_torch import _build
from tpudes_torch.ops import fused
from tpudes_torch.ops import wifi_error as port_err
from tpudes_torch.parallel import kernels as P
from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel import window_cuda
from tpudes_torch.random import PRNGKey, replica_keys, uniform, window_keys

M = len(ref_err.ALL_MODES)
SNR = (10.0 ** (np.linspace(-10.0, 45.0, 1001) / 10.0)).astype(np.float32)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got: torch.Tensor, want) -> bool:
    g, w = got.numpy(), np.asarray(want)
    return g.shape == w.shape and np.array_equal(_bits(g), _bits(w))


def _inputs(n: int, seed: int, replicas=None):
    """A window's inputs from numpy: nodes in a 40 m square (z = 0),
    about 30 % transmitting (node 0 always, node 1 never), modes over
    every OFDM and HT mode, four frame sizes."""
    rng = np.random.default_rng(seed)
    sh = (n,) if replicas is None else (replicas, n)
    pos = rng.uniform(0.0, 40.0, sh + (3,)).astype(np.float32)
    pos[..., 2] = 0.0
    tx = rng.random(sh) < 0.3
    tx[..., 0], tx[..., 1] = True, False
    mode = rng.integers(0, M, sh).astype(np.int32)
    fb = rng.choice([100.0, 500.0, 1000.0, 1500.0], sh).astype(np.float32)
    return pos, tx, mode, fb


def _near_ties(coin: np.ndarray, psr: np.ndarray, live: np.ndarray) -> int:
    """Pairs that may decode whose coin lies within an f32 ulp of its
    PSR."""
    ulp = np.spacing(np.abs(psr).astype(np.float32))
    return int((live & (np.abs(coin - psr) <= ulp)).sum())


# --------------------------------------------------------------------------
# the per-element error models, log10 and the draws
# --------------------------------------------------------------------------


@pytest.mark.parametrize("nbits", [100.0, 8000.0, 12000.0])
@pytest.mark.parametrize("model", ["nist", "table"])
def test_error_models_per_element_bit_equal(model, nbits):
    """Every mode over the 1,001-point SNR sweep, the mode a traced
    operand: the jitted reference's rates bit for bit."""
    snr = np.broadcast_to(SNR, (M, SNR.size)).copy()
    mode = np.broadcast_to(np.arange(M, dtype=np.int32)[:, None],
                           snr.shape).copy()
    nb = np.full(snr.shape, nbits, np.float32)
    ref = (ref_err.table_chunk_success_rate if model == "table"
           else ref_err.mode_chunk_success_rate)
    port = (port_err.table_chunk_success_rate if model == "table"
            else port_err.mode_chunk_success_rate)
    want = np.asarray(jax.jit(ref)(snr, nb, mode))
    got = port(torch.from_numpy(snr), torch.from_numpy(nb),
               torch.from_numpy(mode))
    mid = (want > 1e-3) & (want < 0.999)
    print(f"{model}, nbits {nbits:g}: {mid.sum()} mid-range rates")
    assert _same(got, want)


def test_per_table_equals_reference():
    want = ref_err.per_table()
    got = port_err.per_table()
    assert got.dtype == np.float64 and np.array_equal(got, want)
    assert np.array_equal(port_err.per_table_f32(), want.astype(np.float32))


def test_log10_equals_compiled():
    x = np.concatenate([SNR, np.float32(10.0) ** np.random.default_rng(0)
                        .uniform(-30, 30, 20000).astype(np.float32)])
    want = jax.jit(jnp.log10)(x)
    assert _same(fused.log10(torch.from_numpy(x)), want)


@pytest.mark.parametrize("n", [8, 33, 65])
def test_uniform_square_equals_jax(n):
    key = jax.random.PRNGKey(17)
    want = jax.random.uniform(key, (n, n))
    assert _same(uniform(PRNGKey(17), (n, n)), want)


def test_window_keys_equal_jax():
    key = jax.random.PRNGKey(5)
    got = window_keys(PRNGKey(5), 6)
    for i in range(6):
        k_tx, k_phy = jax.random.split(jax.random.fold_in(key, i))
        assert np.array_equal(got[i, 0].numpy(), np.asarray(k_tx))
        assert np.array_equal(got[i, 1].numpy(), np.asarray(k_phy))


@pytest.mark.parametrize("n", [8, 32, 33, 63, 65, 96, 129, 300])
def test_column_sum_order_equals_compiled(n):
    """The window's column sum: the reference's CPU backend sums past 32
    rows in padded blocks of 32 (``kernels.sum_blocks``)."""

    def total(p, tx):
        eye = jnp.eye(p.shape[0], dtype=bool)
        return jnp.sum(jnp.where(eye, 0.0, p) * tx.astype(jnp.float32)[:,
                                                                       None],
                       axis=0)

    rng = np.random.default_rng(n)
    p = (10.0 ** rng.uniform(-13, -9, (n, n))).astype(np.float32)
    tx = rng.random(n) < 0.5
    want = jax.jit(total)(p, tx)
    x = torch.where(torch.eye(n, dtype=torch.bool), 0.0,
                    torch.from_numpy(p)) * torch.from_numpy(tx).float()[:,
                                                                        None]
    assert _same(P._column_sum(x), want)


# --------------------------------------------------------------------------
# the window, replicated and the scan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 32, 65])
@pytest.mark.parametrize("model", ["nist", "table"])
def test_window_equals_reference(model, n):
    pos, tx, mode, fb = _inputs(n, n)
    key = jax.random.PRNGKey(n)
    params = J.WindowParams(error_model=model)
    want = jax.jit(lambda a, b, c, d, k: J.wifi_phy_window(
        a, b, c, d, k, params))(pos, tx, mode, fb, key)
    got = P.wifi_phy_window(pos, tx, mode, fb, np.asarray(key),
                            P.WindowParams(error_model=model), device="cpu")
    for name, g, w in zip(("ok", "sinr", "rx_dbm"), got, want):
        assert _same(g, w), name
    # the diagonal: rx_dbm finite (max(d, 1)), sinr 0 / noise
    assert np.isfinite(got[2].diagonal().numpy()).all()
    assert (got[1].diagonal() == 0.0).all()
    txf = torch.from_numpy(tx).float()
    live = ((txf[:, None] > 0) & (txf[None, :] == 0)).numpy()
    coin = uniform(torch.as_tensor(np.asarray(key, np.int64)),
                   (n, n)).numpy()
    rx_w = P.geometry(torch.from_numpy(pos), P.WindowParams())[1] * txf[:,
                                                                        None]
    den = (P._column_sum(rx_w)[None, :] - rx_w) + fused.f32(
        rx_w, P.WindowParams().noise_w)
    psr = P.psr_math(rx_w, den, rx_w / den, torch.from_numpy(mode),
                     torch.from_numpy(fb),
                     P.WindowParams(error_model=model)).numpy()
    print(f"{model} N={n}: {int(got[0].sum())} frames decoded, "
          f"{_near_ties(coin, psr, live)} coin~psr near-ties")
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("model", ["nist", "table"])
def test_replicated_equals_reference(model):
    pos, tx, mode, fb = _inputs(65, 1, replicas=4)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3), i))(
        jnp.arange(4))
    params = J.WindowParams(error_model=model)
    want = jax.jit(lambda *a: J.replicated()(*a, params))(pos, tx, mode, fb,
                                                          keys)
    got = P.replicated()(pos, tx, mode, fb, np.asarray(keys),
                         P.WindowParams(error_model=model), device="cpu")
    for name, g, w in zip(("ok", "sinr", "rx_dbm"), got, want):
        assert _same(g, w), name
    # another kernel runs once a replica, to the same result
    own = P.replicated(lambda *a, **kw: P.wifi_phy_window(*a, **kw))(
        pos, tx, mode, fb, np.asarray(keys),
        P.WindowParams(error_model=model), device="cpu")
    for g, o in zip(got, own):
        assert torch.equal(g, o)


@pytest.mark.parametrize("n_windows", [8, 16])
def test_scan_equals_reference(n_windows):
    pos, _, mode, fb = _inputs(65, 5)
    key = jax.random.PRNGKey(9)
    want = J.multi_window_scan(pos, 0.25, mode, fb, key, n_windows=n_windows)
    got = P.multi_window_scan(pos, 0.25, mode, fb, np.asarray(key),
                              n_windows, device="cpu")
    assert got.shape == () and got.dtype == torch.int32
    assert int(got) == int(want) > 0
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(4))
    want = jax.vmap(J.multi_window_scan,
                    in_axes=(None, None, None, None, 0, None))(
        pos, 0.25, mode, fb, keys, n_windows)
    got = P.multi_window_scan(pos, 0.25, mode, fb, np.asarray(keys),
                              n_windows, device="cpu")
    assert got.shape == (4,) and np.array_equal(got.numpy(), want)


def test_graft_entry_shape_equals_reference():
    """``__graft_entry__``'s window: 32 nodes in a 60 m cube, every fourth
    transmitting, mode 7, 1,000 B frames."""
    n, key = 32, jax.random.PRNGKey(0)
    pos = np.asarray(jax.random.uniform(key, (n, 3), minval=0.0,
                                        maxval=60.0))
    tx = np.zeros(n, bool)
    tx[::4] = True
    mode = np.full(n, 7, np.int32)
    fb = np.full(n, 1000.0, np.float32)
    want = jax.jit(J.wifi_phy_window)(pos, tx, mode, fb, key)
    got = P.wifi_phy_window(pos, tx, mode, fb, np.asarray(key), device="cpu")
    for g, w in zip(got, want):
        assert _same(g, w)


def test_window_refusals():
    pos, tx, mode, fb = _inputs(8, 0)
    with pytest.raises(ValueError, match="mode indices"):
        P.wifi_phy_window(pos, tx, np.full(8, 20, np.int32), fb,
                          np.asarray(PRNGKey(0)), device="cpu")
    with pytest.raises(ValueError, match="error_model"):
        P.WindowParams(error_model="ber")
    with pytest.raises(ValueError, match="N <= 1024"):
        P.sum_blocks(1025)


# --------------------------------------------------------------------------
# the kernel's own source on the CPU (g++ against the CUDA mock)
# --------------------------------------------------------------------------

CSRC = Path(_build.CSRC)
GXX_FLAGS = ("-x", "c++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
             "-shared", "-pthread")


@pytest.fixture(scope="module")
def mock_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/wifi_window.cu against the "
                    "CUDA mock")
    lib = tmp_path_factory.mktemp("win_mock") / "libwifi_window_mock.so"
    subprocess.run(
        [gxx, *GXX_FLAGS, "-I", str(CSRC / "mock"), "-I", str(CSRC), "-o",
         str(lib), str(CSRC / "wifi_window.cu")],
        check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture
def kernel(mock_lib, monkeypatch):
    monkeypatch.setitem(_build._LOADED, "wifi_window", mock_lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    kc.reset_launches()


@pytest.mark.parametrize("n, replicas", [(8, 3), (40, 2), (65, 2)])
@pytest.mark.parametrize("model", ["nist", "table"])
def test_mock_window_kernel_bit_equal(kernel, model, n, replicas):
    pos, tx, mode, fb = (torch.from_numpy(a)
                         for a in _inputs(n, 7 + n, replicas))
    keys = replica_keys(PRNGKey(n), replicas)
    params = P.WindowParams(error_model=model)
    got = window_cuda.window_launch(pos, tx, mode, fb, keys, params)
    want = P.window_math(pos, tx, mode, fb, uniform(keys, (n, n)), params)
    for name, g, w in zip(("ok", "sinr", "rx_dbm"), got, want):
        assert torch.equal(g, w) if g.dtype == torch.bool else torch.equal(
            g.view(torch.int32), w.view(torch.int32)), name
    assert kc.launches["wifi_window"] == 1
    assert kc.launches["wifi_window:table"] == (model == "table")


@pytest.mark.parametrize("n", [8, 65])
def test_mock_scan_kernel_equals_plain(kernel, n):
    pos, _, mode, fb = (torch.from_numpy(a) for a in _inputs(n, 3, 1))
    keys = replica_keys(PRNGKey(2), 3)
    prob = torch.full((n,), 0.25)
    got = window_cuda.scan_launch(pos[0], prob, mode[0].contiguous(),
                                  fb[0].contiguous(), keys, 8)
    want = P.scan_math(pos[0], prob, mode[0], fb[0], keys, 8)
    assert torch.equal(got, want) and int(want.sum()) > 0
    assert (kc.launches["wifi_window"], kc.launches["wifi_window:geometry"],
            kc.launches["wifi_window:scan"]) == (2, 1, 1)


@pytest.mark.parametrize("spread", [1.0, 40.0])
@pytest.mark.parametrize("n", [8, 65])
def test_mock_geometry_kernel_bit_equal(kernel, n, spread):
    """At a spread of 40 (a 1.6 km square) some pairs fall below the
    sensitivity, so both values of ``det`` are held."""
    pos = torch.from_numpy(_inputs(n, 5, 1)[0][0]) * spread
    rx_w, det = window_cuda.geometry_launch(pos)
    params = P.WindowParams()
    rx_dbm, want = P.geometry(pos, params)
    assert torch.equal(rx_w.view(torch.int32), want.view(torch.int32))
    assert torch.equal(det, rx_dbm >= params.rx_sensitivity_dbm)
    assert bool(det.all()) == (spread == 1.0)
    assert (kc.launches["wifi_window"], kc.launches["wifi_window:geometry"],
            kc.launches["wifi_window:scan"]) == (1, 1, 0)


def test_mock_scan_of_no_windows_launches_nothing(kernel):
    pos, _, mode, fb = (torch.from_numpy(a) for a in _inputs(8, 3, 1))
    got = window_cuda.scan_launch(pos[0], torch.full((8,), 0.25),
                                  mode[0].contiguous(), fb[0].contiguous(),
                                  replica_keys(PRNGKey(2), 3), 0)
    assert torch.equal(got, torch.zeros(3, dtype=torch.int32))
    assert kc.launches["wifi_window"] == 0


def test_mock_window_mutant_fails(tmp_path, monkeypatch):
    """A copy of the source with the column sum's block 32 rows to 16: the
    comparison above sees it (at 65 nodes)."""
    source = (CSRC / "wifi_window.cu").read_text()
    was = "constexpr int SUM_BLOCK = 32;"
    assert source.count(was) == 1
    mutant = tmp_path / "wifi_window.cu"
    mutant.write_text(source.replace(was, "constexpr int SUM_BLOCK = 16;"))
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    lib = tmp_path / "libmutant.so"
    subprocess.run([gxx, *GXX_FLAGS, "-I", str(CSRC / "mock"), "-I",
                    str(CSRC), "-o", str(lib), str(mutant)], check=True,
                   capture_output=True, text=True)
    monkeypatch.setitem(_build._LOADED, "wifi_window", ctypes.CDLL(str(lib)))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    pos, tx, mode, fb = (torch.from_numpy(a) for a in _inputs(65, 4, 2))
    tx[:] = True
    tx[:, ::3] = False
    keys = replica_keys(PRNGKey(1), 2)
    got = window_cuda.window_launch(pos, tx, mode, fb, keys,
                                    P.WindowParams())
    want = P.window_math(pos, tx, mode, fb, uniform(keys, (65, 65)))
    assert not torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))
