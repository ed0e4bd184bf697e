"""The redesigned ``csrc/wifi_window.cu`` on the CPU, through the CUDA mock.

The kernel's source is built by ``g++`` against
``tpudes_torch/csrc/mock/cuda_runtime.h`` (a fiber per CUDA thread) and
called through its wrappers (``window_cuda``) on CPU tensors:

- its multiply-add over f64 registers (``F32d::fma``: the f64 fused
  multiply-add rounded to f32 by Veltkamp's split, ``xla_math::fma32``
  for results outside f32's normal range) against the f64 definition,
  ``float32(float64(a) * float64(b) + float64(c))`` in numpy (the product
  of two floats is exact in f64, so the sum rounds once there), and
  against ``xla_math::fma32``: over 2^20 random triples of wide exponents,
  constructed double-rounding ties, results near FLT_MIN and FLT_MAX,
  subnormal operands, signed zeros, infinities and NaN;
- its exp, log, log1p and erfc over f64 registers against xla_math.cuh's
  f32 functions, on random bits and dense draws of the model's domains
  (equal wherever the f64 chain stays in range, its unchecked steps
  included);
- both kernels bit-equal to the plain versions (``kernels.window_math``,
  ``kernels.scan_math``) at N = 8, 33, 65 and 200 (past the size whose
  geometry fits in shared memory), with sparse and dense transmitter
  sets, NIST and table, two or three replicas; the stage probe's outputs
  equal to the main launch's;
- mutant builds that must fail: the multiply-add rounded once (the
  double rounding's ties lost), and the column sum taken in list order
  without the compiled blocks.

Tolerance: none (bits).  Skips where ``g++`` is missing.  The same source
runs on the card in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_cpu

from tpudes_torch import _build
from tpudes_torch.parallel import kernels as P
from tpudes_torch.parallel import kernels_cuda as kc
from tpudes_torch.parallel import window_cuda
from tpudes_torch.random import PRNGKey, replica_keys, uniform

_torch_cpu.one_thread()

CSRC = Path(_build.CSRC)
GXX_FLAGS = ("-x", "c++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
             "-shared", "-pthread")
M = 20


#: the mutants, by name: (the source's text, its replacement)
MUTANTS = {
    "single_rounding": (
        "  return r24(__fma_rn(a, b, c));",
        "  return __fmaf_rn(static_cast<float>(a), static_cast<float>(b), "
        "static_cast<float>(c));"),
    "sum_out_of_block_order": (
        "  return n <= SUM_BLOCK\n             ? 0\n",
        "  return n <= 1 << 30\n             ? 0\n"),
}


def _start_build(source: Path, out: Path) -> subprocess.Popen:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build csrc/wifi_window.cu against the "
                    "CUDA mock")
    return subprocess.Popen([gxx, *GXX_FLAGS, "-I", str(CSRC / "mock"), "-I",
                             str(CSRC), "-o", str(out), str(source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """The kernel's mock build and each of :data:`MUTANTS`', all ``g++``
    processes started together; the libraries' paths by name."""
    root = tmp_path_factory.mktemp("win_mock")
    sources = {"main": CSRC / "wifi_window.cu"}
    text = (CSRC / "wifi_window.cu").read_text()
    for name, (was, now) in MUTANTS.items():
        assert text.count(was) == 1
        (root / name).mkdir()
        sources[name] = root / name / "wifi_window.cu"
        sources[name].write_text(text.replace(was, now))
    procs = {name: (_start_build(src, root / f"lib{name}.so"),
                    root / f"lib{name}.so") for name, src in sources.items()}
    for name, (proc, _) in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, f"{name}: {out}"
    return {name: path for name, (_, path) in procs.items()}


@pytest.fixture(scope="module")
def mock_lib(builds):
    return ctypes.CDLL(str(builds["main"]))


def _use(lib, monkeypatch):
    monkeypatch.setitem(_build._LOADED, "wifi_window", lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    kc.reset_launches()


@pytest.fixture
def kernel(mock_lib, monkeypatch):
    _use(mock_lib, monkeypatch)


def _bits(x: np.ndarray) -> np.ndarray:
    """f32 bits, every NaN one pattern."""
    b = x.view(np.uint32).copy()
    b[np.isnan(x)] = 0x7FFFFFFF
    return b


# --------------------------------------------------------------------------
# the multiply-add over f64 registers
# --------------------------------------------------------------------------


def _f32(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def _random_triples(rng, n):
    """Random signs, mantissas and exponents: a and b over f32's range,
    c near the product's scale (2^-60 .. 2^60 of it) or anywhere."""
    def draw(lo, hi):
        e = rng.integers(lo, hi, n)
        m = rng.integers(0, 1 << 23, n)
        s = rng.integers(0, 2, n)
        return _f32((s << 31) | (e << 23) | m)

    a, b = draw(1, 255), draw(1, 255)
    with np.errstate(over="ignore", under="ignore"):
        ab = np.abs(a.astype(np.float64) * b.astype(np.float64))
    scale = np.clip(np.floor(np.log2(np.maximum(ab, 1e-300))), -149, 127)
    near = scale + rng.integers(-60, 61, n)
    ce = np.clip(near + 127, 1, 254).astype(np.int64)
    c = _f32((rng.integers(0, 2, n) << 31) | (ce << 23)
             | rng.integers(0, 1 << 23, n))
    far = rng.random(n) < 0.25
    c[far] = draw(0, 255)[far]
    return a, b, c


def _ties(rng, n):
    """a b + c within 2^-70 of an f32 midpoint, so that the f64 sum rounds
    onto the midpoint and f32's tie decides: a = 2^-24 (1 + u) 2^k, b = (1
    - u), c an f32 of odd (or even) mantissa in 2^k's binade, u = j 2^-23
    (j < 300); the product lies 2^-24 u^2 below the half ulp; signs and
    scales random."""
    j = rng.integers(1, 300, n).astype(np.float64)
    u = j * 2.0 ** -23
    k = rng.integers(-100, 100, n).astype(np.float64)
    a = (2.0 ** -24 * (1 + u) * 2.0 ** k).astype(np.float32)
    b = (1 - u).astype(np.float32)
    cm = rng.integers(1, 1 << 23, n)
    c = ((1 + cm * 2.0 ** -23) * 2.0 ** k).astype(np.float32)
    sa = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    sc = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    return a * sa, b, c * sc


def _edges(rng, n):
    """Results near FLT_MIN (subnormal and just normal), near FLT_MAX and
    past it, subnormal operands, and every mix of +-0, +-inf and NaN."""
    tiny = np.float32(2.0 ** -126)
    out = []
    x = (rng.uniform(0.5, 2.0, n) * 2.0 ** rng.integers(-80, -40, n)
         ).astype(np.float32)
    y = (rng.uniform(0.5, 2.0, n) * 2.0 ** rng.integers(-90, -40, n)
         ).astype(np.float32)
    out.append((x, y, (rng.uniform(-2, 2, n) * tiny).astype(np.float32)))
    big = (rng.uniform(1.0, 2.0, n) * 2.0 ** 64).astype(np.float32)
    out.append((big, big, (rng.uniform(-1, 1, n) * 2.0 ** 127
                           ).astype(np.float32)))
    sub = _f32(rng.integers(1, 1 << 23, n))
    out.append((sub, (rng.uniform(-4, 4, n)).astype(np.float32),
                (rng.uniform(-1, 1, n) * tiny).astype(np.float32)))
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.5,
                        3.4e38, 1.2e-38, 1e-45], np.float32)
    g = np.array(np.meshgrid(special, special, special)).reshape(3, -1)
    out.append((g[0], g[1], g[2]))
    return tuple(np.concatenate(z) for z in zip(*out))


def _definition(a, b, c) -> np.ndarray:
    with np.errstate(all="ignore"):
        return (a.astype(np.float64) * b.astype(np.float64)
                + c.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "edges"])
def test_fma_routine_equals_f64_definition(kernel, kind):
    rng = np.random.default_rng({"random": 1, "ties": 2, "edges": 3}[kind])
    a, b, c = {"random": lambda: _random_triples(rng, 1 << 20),
               "ties": lambda: _ties(rng, 1 << 16),
               "edges": lambda: _edges(rng, 1 << 14)}[kind]()
    got, want = window_cuda.fma_check(*(torch.from_numpy(x) for x in (a, b,
                                                                      c)))
    ref = _definition(a, b, c)
    assert np.array_equal(_bits(got.numpy()), _bits(ref))
    assert np.array_equal(_bits(want.numpy()), _bits(ref))
    if kind == "ties":
        # the construction's f64 sums land on f32 midpoints (the 29 bits
        # f32 drops are 1 then zeros), where f32's tie to even decides
        y = a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)
        low = y.view(np.uint64) & np.uint64((1 << 29) - 1)
        assert (low == np.uint64(1 << 28)).mean() > 0.99
    assert kc.launches["wifi_window"] == 0


def _chain_inputs(rng, fn, n):
    """Random bits of every f32 class (a NaN made quiet: arithmetic makes no
    signalling NaN, and glibc's fmaxf, unlike the card's, does not drop
    one), and dense draws over the domain the error model gives ``fn``,
    its edges and tiny values."""
    raw = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    nan = (raw & 0x7F800000) == 0x7F800000
    nan &= (raw & 0x7FFFFF) != 0
    bits = _f32(np.where(nan, raw | 0x00400000, raw))
    tiny = (rng.uniform(0.5, 1.0, n) * 2.0 ** rng.integers(-149, -40, n)
            ).astype(np.float32)
    dense = {"exp": (-95.0, 95.0), "log": (1e-38, 4.0),
             "log1p": (-1.0, 1.0), "erfc": (-1.0, 10.0)}[fn]
    parts = [bits, tiny, -tiny, rng.uniform(*dense, n).astype(np.float32)]
    if fn == "exp":
        k = rng.integers(-127, 128, n)
        parts.append((k * np.log(2.0) + rng.uniform(-1e-6, 1e-6, n)
                      ).astype(np.float32))
    if fn == "log":
        parts.append(np.nextafter(np.float32(1.0), rng.choice(
            [np.float32(0), np.float32(2)], n)).astype(np.float32))
    if fn == "log1p":
        parts.append(rng.uniform(-0.4143, 0.4143, n).astype(np.float32))
    if fn == "erfc":
        parts.append(rng.uniform(0.9, 2.1, n).astype(np.float32))
    return np.concatenate(parts)


@pytest.mark.parametrize("fn", window_cuda.CHAIN_FUNCTIONS)
def test_chain_over_f64_equals_f32(kernel, fn):
    """Each function of the error model over f64 registers (``exp_d``,
    ``log_d``, ``log1p_d``, ``erfc_d``) against xla_math.cuh's f32
    function: equal wherever the f64 chain stays in range (its unchecked
    steps included), which is nearly everywhere in the model's domain."""
    rng = np.random.default_rng(CHAIN_SEEDS[fn])
    x = _chain_inputs(rng, fn, 1 << 16)
    got, want, in_range = window_cuda.chain_check(torch.from_numpy(x), fn)
    ok = in_range.numpy()
    assert np.array_equal(_bits(got.numpy())[ok], _bits(want.numpy())[ok])
    assert ok[-(1 << 16):].mean() > 0.99
    assert kc.launches["wifi_window"] == 0


CHAIN_SEEDS = {"exp": 5, "log": 6, "log1p": 7, "erfc": 8}


# --------------------------------------------------------------------------
# the kernels against the plain versions
# --------------------------------------------------------------------------


def _window_inputs(n, replicas, density, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 40.0 + n / 2, (replicas, n, 3)).astype(np.float32)
    pos[..., 2] = 0.0
    tx = rng.random((replicas, n)) < density
    tx[:, 0], tx[:, 1] = True, False
    mode = rng.integers(0, M, (replicas, n)).astype(np.int32)
    fb = rng.choice([100.0, 500.0, 1000.0, 1500.0],
                    (replicas, n)).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (pos, tx, mode, fb))


def _same_window(got, want) -> bool:
    return all(torch.equal(g, w) if g.dtype == torch.bool
               else torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


@pytest.mark.parametrize("density", [0.1, 0.6])
@pytest.mark.parametrize("n", [8, 33, 65, 200])
@pytest.mark.parametrize("model", ["nist", "table"])
def test_window_kernel_bit_equal(kernel, model, n, density):
    replicas = 2 if n == 200 else 3
    pos, tx, mode, fb = _window_inputs(n, replicas, density, n + 7)
    keys = replica_keys(PRNGKey(n), replicas)
    params = P.WindowParams(error_model=model)
    got = window_cuda.window_launch(pos, tx, mode, fb, keys, params)
    want = P.window_math(pos, tx, mode, fb, uniform(keys, (n, n)), params)
    assert _same_window(got, want)
    assert int(want[0].sum()) > 0
    assert kc.launches["wifi_window"] == 1
    assert kc.launches["wifi_window:table"] == (model == "table")


@pytest.mark.parametrize("prob", [0.1, 0.6])
@pytest.mark.parametrize("n", [8, 33, 65, 200])
def test_scan_kernel_equals_plain(kernel, n, prob):
    pos, _, mode, fb = _window_inputs(n, 1, 0.5, n)
    windows = 2 if n == 200 else 6
    keys = replica_keys(PRNGKey(n + 1), 2 if n == 200 else 3)
    p = torch.full((n,), prob)
    got = window_cuda.scan_launch(pos[0], p, mode[0].contiguous(),
                                  fb[0].contiguous(), keys, windows)
    want = P.scan_math(pos[0], p, mode[0], fb[0], keys, windows)
    assert torch.equal(got, want) and int(want.sum()) > 0
    assert (kc.launches["wifi_window"], kc.launches["wifi_window:geometry"],
            kc.launches["wifi_window:scan"]) == (2, 1, 1)


def test_scan_of_no_windows(kernel):
    pos, _, mode, fb = _window_inputs(33, 1, 0.5, 0)
    keys = replica_keys(PRNGKey(3), 4)
    got = window_cuda.scan_launch(pos[0], torch.full((33,), 0.25),
                                  mode[0].contiguous(), fb[0].contiguous(),
                                  keys, 0)
    assert torch.equal(got, torch.zeros(4, dtype=torch.int32))
    assert kc.launches["wifi_window"] == 0
    with pytest.raises(ValueError, match="needs a window"):
        window_cuda.scan_profile(pos[0], torch.full((33,), 0.25),
                                 mode[0].contiguous(), fb[0].contiguous(),
                                 keys, 0)


@pytest.mark.parametrize("what", ["window", "scan"])
def test_probe_equals_main_launch(kernel, what):
    """The ``PROF`` instantiation's outputs equal the main launch's, and
    its cycles are finite, none negative, some stage's positive."""
    pos, tx, mode, fb = _window_inputs(40, 2, 0.3, 11)
    keys = replica_keys(PRNGKey(6), 2)
    if what == "window":
        params = P.WindowParams()
        want = window_cuda.window_launch(pos, tx, mode, fb, keys, params)
        got, cyc = window_cuda.window_profile(pos, tx, mode, fb, keys, params)
        assert _same_window(got, want)
    else:
        args = (pos[0], torch.full((40,), 0.3), mode[0].contiguous(),
                fb[0].contiguous(), keys, 4)
        want = window_cuda.scan_launch(*args)
        got, cyc = window_cuda.scan_profile(*args)
        assert torch.equal(got, want)
    assert cyc.shape == (len(window_cuda.WIN_PROF_STAGES),)
    assert torch.isfinite(cyc).all() and (cyc >= 0).all() and cyc.sum() > 0


# --------------------------------------------------------------------------
# mutants
# --------------------------------------------------------------------------


def _mutant(builds, monkeypatch, name: str):
    _use(ctypes.CDLL(str(builds[name])), monkeypatch)


def test_mutant_single_rounding_fails(builds, monkeypatch):
    """The multiply-add rounded once (f32's own fma): the constructed ties
    see it."""
    _mutant(builds, monkeypatch, "single_rounding")
    a, b, c = _ties(np.random.default_rng(2), 1 << 12)
    got, _ = window_cuda.fma_check(*(torch.from_numpy(x) for x in (a, b, c)))
    assert not np.array_equal(_bits(got.numpy()), _bits(_definition(a, b, c)))


def test_mutant_sum_out_of_block_order_fails(builds, monkeypatch):
    """The column sum over the transmitter list in one run, not the
    compiled blocks of 32: the window's sinr sees it at 65 nodes."""
    _mutant(builds, monkeypatch, "sum_out_of_block_order")
    pos, tx, mode, fb = _window_inputs(65, 2, 0.7, 4)
    keys = replica_keys(PRNGKey(1), 2)
    got = window_cuda.window_launch(pos, tx, mode, fb, keys, P.WindowParams())
    want = P.window_math(pos, tx, mode, fb, uniform(keys, (65, 65)))
    assert not torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32))
