"""f32 arithmetic as the reference compiles it inside a jitted function.

The reference's device geometry stage (``tpudes/parallel/lte_sm.py``,
``_build_geom_fn``) runs under ``jit``, and its compiler does not
evaluate the source's operations one by one (the optimised HLO of the
stage on the CPU shows it):

- a product feeding a sum becomes one fused multiply-add (a reduction
  accumulates ``acc + x * y`` the same way), rounded once;
- ``log`` is the compiler's own polynomial (Cephes ``logf`` as in
  Eigen's ``plog_float``), not the C library's, and ``log10`` / ``log2``
  multiply it by one folded f32 constant;
- a division by a constant is a multiplication by its f32 reciprocal;
- ``power`` is the C library's ``powf`` (glibc's table-driven one), for
  ``10 ** x`` and for a general ``x ** y`` alike (the optimised HLO
  keeps ``power``, and it equals glibc's ``powf`` on every operand
  tried).

The WiFi error model's chain (``tpudes/ops/wifi_error.py``, compiled
inside the BSS step) adds three more, read from the CPU executable of
``mode_chunk_success_rate`` (its optimised HLO, LLVM IR and machine
code):

- ``exp`` is the compiler's own (Cephes ``expf``: ``x`` clamped to
  ``[-87.8, 88.8]``, ``n = floor(x log2 e + 1/2)`` clamped to
  ``[-127, 127]``, ``r = x - n ln 2`` in two parts, a degree-5
  polynomial, times ``2**n`` built from bits);
- ``log1p`` is the compiler's Cephes rational ``x - x^2/2 + x^3 P/Q``
  below ``|x| = sqrt 2 - 1`` and ``log(1 + x)`` above;
- ``erfc`` is expanded in the HLO itself (XLA's f32 ``erfc``: a
  polynomial in ``x^2`` below 1, ``exp(-x^2) / x`` times one of two
  polynomials in ``1 / x^2`` above);

all with their multiply-adds fused, and every result below the smallest
normal f32 flushed to 0 (the CPU runs with subnormals flushed).

The TCP dumbbell's step (``tpudes/parallel/tcp_dumbbell.py``) adds
``cbrt``, which the CPU backend computes as ``copysign(powf(|x|, 1/3),
x)`` with glibc's ``powf`` (it equals that on every value tried, and
glibc's own ``cbrtf`` on only about two thirds of them).

``jax.random.normal`` (the AS flow engine's rate jitter) adds ``erf_inv``,
XLA's f32 polynomial in ``-log1p(-x^2)`` with its multiply-adds fused
(read from the optimised HLO of a jitted ``jax.random.normal``).

:func:`fma`, :func:`log`, :func:`log10`, :func:`exp10`, :func:`powf`,
:func:`cbrt`, :func:`exp`, :func:`log1p`, :func:`erfc` and :func:`erf_inv`
reproduce these from IEEE f32 and f64 operations and integer bit operations,
which round the same way on the CPU and on the card.  An f64 product of
two f32 values is exact, so ``fma`` rounds the f64 sum once more to
f32: it can differ from a true fused multiply-add only where the f64
sum lands exactly on an f32 tie.
"""

from __future__ import annotations

from decimal import Decimal, localcontext

import numpy as np
import torch

#: Cephes ``logf``: the polynomial coefficients, then the split of ln 2
_LOG_P = (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
    -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
    2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1,
)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRT_HALF = 0.70710677
_FLT_MIN = 1.17549435e-38
_MANT_MASK = -2139095041   # 0x807FFFFF: sign and mantissa bits
_HALF_BITS = 0x3F000000    # the exponent of 0.5

#: glibc ``powf(10, y)``: ``log2(10)`` as its table-driven log2 returns
#: it (table entry 13 and its degree-5 polynomial), then its exp2 of
#: ``y * log2(10)`` in f64: the nearest multiple of 1/32, a 32-entry
#: table of ``2 ** (i / 32)`` and a cubic for the rest
_POWF_LOG2_10 = float.fromhex("0x1.a934f0979b22dp+1")
_EXP2F_POLY = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1",
))
_EXP2F_SHIFT = float.fromhex("0x1.8p+52") / 32

#: glibc ``powf``'s log2 (``e_powf_log2_data.c``): 16 subintervals of
#: ``[OFF, 2 OFF)``, each ``(1/c, log2 c)``, and the degree-5 polynomial
#: of ``log1p(r) / ln 2``
_POWF_OFF = 0x3F330000
_POWF_LOG2_TAB = tuple(
    (float.fromhex(a), float.fromhex(b)) for a, b in (
        ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
        ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
        ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
        ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
        ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
        ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
        ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
        ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
        ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
        ("0x1.0000000000000p+0", "0x0.0p+0"),
        ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
        ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
        ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
        ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
        ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
        ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"),
    )
)
_POWF_LOG2_POLY = tuple(float.fromhex(h) for h in (
    "0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2", "0x1.ec70a6ca7baddp-2",
    "-0x1.7154748bef6c8p-1", "0x1.71547652ab82bp+0",
))
#: ``y log2 x`` past which glibc's powf overflows / underflows
_POWF_OFLOW = float.fromhex("0x1.fffffffd1d571p+6")
_POWF_UFLOW = -150.0


def _exp2f_table() -> np.ndarray:
    """The bits of ``2 ** (i / 32)``, i < 32, rounded to f64 (glibc's
    ``__exp2f_data.tab`` with its index term added back)."""
    with localcontext() as ctx:
        ctx.prec = 60
        vals = [float(Decimal(2) ** (Decimal(i) / 32)) for i in range(32)]
    return np.asarray(vals, np.float64).view(np.int64)


_EXP2F_TAB_BITS = _exp2f_table()
_POWF_INVC = np.asarray([a for a, _ in _POWF_LOG2_TAB], np.float64)
_POWF_LOGC = np.asarray([b for _, b in _POWF_LOG2_TAB], np.float64)


_ON_DEVICE: dict = {}


def f32(like: torch.Tensor, value) -> torch.Tensor:
    """A 0-dim f32 tensor holding ``float32(value)`` on ``like``'s device,
    made there once (a fill, not a copy from the host) and kept."""
    v = float(np.float32(value))
    key = (v, like.device)
    out = _ON_DEVICE.get(key)
    if out is None:
        out = _ON_DEVICE[key] = torch.full((), v, dtype=torch.float32,
                                           device=like.device)
    return out


def f32_in_f64(like: torch.Tensor, value) -> torch.Tensor:
    """:func:`f32`'s value held in a 0-dim f64 tensor (exact): a
    constant operand of :func:`fma`'s f64 arithmetic, kept."""
    v = float(np.float32(value))
    key = ("f64", v, like.device)
    out = _ON_DEVICE.get(key)
    if out is None:
        out = _ON_DEVICE[key] = torch.full((), v, dtype=torch.float64,
                                           device=like.device)
    return out


def device_table(table: np.ndarray, device) -> torch.Tensor:
    """A module's constant numpy ``table`` on ``device``, copied there
    once per device and kept."""
    key = (id(table), str(torch.device(device)))
    out = _ON_DEVICE.get(key)
    if out is None:
        out = _ON_DEVICE[key] = torch.as_tensor(table, device=device)
    return out


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (tensors or 0-dim tensors)."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of f32 ``x >= 0`` (the
    reference's and the card's ``sqrtf``).  PyTorch's vectorised roots on
    the CPU are not correctly rounded (the f32 one misses about one value
    in 150, the f64 one by an f64 ulp), so the f64 root rounded to f32 is
    checked against the two midpoints around it: each has 25 bits, so
    its square is exact in f64, and the root moves to a neighbour when a
    midpoint's square shows the true root on the other side."""
    x64 = x.double()
    y = torch.sqrt(x64).float()
    up = torch.nextafter(y, torch.full_like(y, float("inf")))
    down = torch.nextafter(y, torch.zeros_like(y))
    hi = (y.double() + up.double()) * 0.5
    lo = (y.double() + down.double()) * 0.5
    return torch.where(hi * hi < x64, up,
                       torch.where(lo * lo > x64, down, y))


def log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive f32 ``x`` as the reference's compiled
    ``log`` computes it: range reduction to ``[sqrt(1/2), sqrt 2)``,
    the Cephes polynomial with its multiply-adds fused, and the
    exponent times ln 2 in two parts."""
    x = torch.clamp_min(x, f32(x, _FLT_MIN))
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & _MANT_MASK) | _HALF_BITS).view(torch.float32)  # [0.5, 1)
    low = m < f32(x, _SQRT_HALF)
    e = e - low.to(torch.float32)
    z = (m - 1.0) + torch.where(low, m, f32(x, 0.0))
    z2 = z * z
    z3 = z2 * z
    p = [f32(x, v) for v in _LOG_P]
    y0 = fma(fma(z, p[0], p[1]), z, p[2])
    y1 = fma(fma(z, p[3], p[4]), z, p[5])
    y2 = fma(fma(z, p[6], p[7]), z, p[8])
    y = fma(fma(y0, z3, y1), z3, y2)
    y = fma(y, z3, e * f32(x, _LOG_Q1))
    return (fma(f32(x, -0.5), z2, z) + y) + e * f32(x, _LOG_Q2)


#: ``1 / ln 10`` in f32: the compiled ``log10`` is ``log(x)`` times it
_INV_LN10 = float(np.float32(0.4342944819032518))


def log10(x: torch.Tensor) -> torch.Tensor:
    """``log10`` of positive f32 ``x`` as the reference's compiled
    ``jnp.log10`` computes it on the CPU (its optimised HLO): :func:`log`
    times the f32 ``1 / ln 10``, one rounding.  A constant factor before
    it folds into that constant (``10 log10(x)`` is ``log(x)`` times
    ``f32(10) * f32(1 / ln 10)``)."""
    return log(x) * f32(x, _INV_LN10)


def _exp2(x: torch.Tensor) -> torch.Tensor:
    """glibc ``powf``'s exp2 of the f64 ``x`` before its last rounding:
    ``x = k/32 + r``, ``2 ** (k/32)`` from the table with ``k >> 5``
    added to its exponent, times the cubic in ``r`` (f64)."""
    c0, c1, c2 = _EXP2F_POLY
    kd = (x + _EXP2F_SHIFT) - _EXP2F_SHIFT                  # k / 32
    r = x - kd
    k = (kd * 32.0).to(torch.int64)
    tab = device_table(_EXP2F_TAB_BITS, x.device)
    s = (tab[k & 31] + ((k >> 5) << 52)).view(torch.float64)
    return ((c0 * r + c1) * (r * r) + (c2 * r + 1.0)) * s


def _flush(out: torch.Tensor) -> torch.Tensor:
    """f64 to f32, a result below the smallest normal f32 made 0 (the
    reference's CPU runs with subnormals flushed)."""
    return torch.where(out < _FLT_MIN, 0.0, out).float()


def exp10(y: torch.Tensor) -> torch.Tensor:
    """``10 ** y`` for f32 ``y`` as the reference's compiled ``power``
    computes it (glibc ``powf``): ``x = y log2(10)`` in f64 and
    :func:`_exp2` of it, rounded once to f32."""
    return _flush(_exp2(y.double() * _POWF_LOG2_10))


def _log2(x: torch.Tensor) -> torch.Tensor:
    """glibc ``powf``'s f64 ``log2`` of positive normal f32 ``x``:
    ``x = 2**k z`` with ``z`` in ``[OFF, 2 OFF)``, one of 16 table
    subintervals around ``c``, ``log2 x = k + log2 c + log1p(z/c - 1) /
    ln 2`` with the degree-5 polynomial."""
    a0, a1, a2, a3, a4 = _POWF_LOG2_POLY
    ix = x.view(torch.int32).to(torch.int64)
    tmp = (ix - _POWF_OFF) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    iz = (ix - top) & 0xFFFFFFFF
    k = (top.to(torch.int32) >> 23).to(torch.float64)      # arithmetic
    z = iz.to(torch.int32).view(torch.float32).double()
    r = z * device_table(_POWF_INVC, x.device)[i] - 1.0
    y0 = device_table(_POWF_LOGC, x.device)[i] + k
    r2 = r * r
    q = a4 * r + y0
    q = (a2 * r + a3) * r2 + q
    return (a0 * r + a1) * (r2 * r2) + q


def powf(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x ** y`` for f32 ``x`` (0 or normal) and ``y`` as the
    reference's compiled ``power`` computes it (glibc ``powf``):
    ``y log2 x`` in f64, then :func:`_exp2` of it, rounded once to f32;
    ``x = 0`` gives 0 (``y > 0``) or ``inf`` (``y < 0``), ``y = 0`` or
    ``x = 1`` gives 1, a negative ``x`` NaN."""
    x, y = torch.broadcast_tensors(x, y)
    ylogx = y.double() * _log2(torch.where(x > 0, x, f32(x, 1.0)))
    out = _flush(_exp2(ylogx.clamp(-200.0, 200.0)))
    out = torch.where(ylogx > _POWF_OFLOW, float("inf"), out)
    out = torch.where(ylogx <= _POWF_UFLOW, 0.0, out)
    zero = torch.where(y > 0, 0.0, torch.where(y < 0, float("inf"), 1.0))
    out = torch.where(x == 0, zero, out)
    out = torch.where(x < 0, float("nan"), out)
    return torch.where((y == 0) | (x == 1), 1.0, out).float()


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """The cube root of f32 ``x`` as the reference's compiled ``cbrt``
    computes it on the CPU: ``copysign(powf(|x|, (float)(1/3)), x)``
    (:func:`powf`)."""
    return torch.copysign(powf(torch.abs(x), f32(x, 1.0 / 3.0)), x)


#: XLA's CPU ``exp`` (Cephes ``expf``): the input clamp, ``log2 e``,
#: ``ln 2`` in two parts and the polynomial, last coefficient 1/2
_EXP_LO, _EXP_HI = -87.8, 88.8
_LOG2E = 1.44269502
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 0.5)

#: XLA's ``log1p`` (Cephes ``log1p``): below ``sqrt 2 - 1`` the rational
#: ``x - x^2/2 + x^3 P(x)/Q(x)``, coefficients highest degree first
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)

#: XLA's f32 ``erfc`` as its HLO expands it: the polynomial in ``x^2``
#: below ``|x| = 1``, and those in ``1 / x^2`` for ``|x| < 2`` and above;
#: ``exp(-x^2)`` is 0 below this
_ERFC_NEAR = (7.85386146e-05, -0.000801019371, 0.00518832775,
              -0.0268538129, 0.112835854, -0.37612626, 1.12837911)
_ERFC_MID = (0.0232682, -0.138703942, 0.368742466, -0.582473278,
             0.621000469, -0.494451523, 0.340488, -0.274112701,
             0.563825965)
_ERFC_FAR = (-10.477664, 12.9772, -7.49551868, 2.92101908, -1.01526523,
             0.42184633, -0.282076746, 0.564189494)
_ERFC_EXP_MIN = -88.7228394


def ftz(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` with a value below the smallest normal f32 made 0."""
    return torch.where(torch.abs(x) < _FLT_MIN, 0.0, x)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    """``((c0 x + c1) x + c2) x + ...`` with every step one fused
    multiply-add (:func:`fma`'s arithmetic), coefficients rounded to
    f32."""
    x64 = x.double()
    acc = f32_in_f64(x, coeffs[0])
    for c in coeffs[1:]:
        acc = torch.addcmul(f32_in_f64(x, c), acc, x64).float().double()
    return acc.float()


def exp(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of f32 ``x`` as the reference's compiled ``exponential``
    computes it on the CPU (XLA's Cephes ``expf``), flushed to 0 below
    the smallest normal f32."""
    x = torch.clamp(x, f32(x, _EXP_LO), f32(x, _EXP_HI))
    n = torch.floor(torch.addcmul(f32_in_f64(x, 0.5), x.double(),
                                  f32_in_f64(x, _LOG2E)).float())
    n = torch.clamp(n, -127.0, 127.0)
    n64 = n.double()
    r = torch.addcmul(x.double(), n64, f32_in_f64(x, -_EXP_C1)).float()
    r = torch.addcmul(r.double(), n64, f32_in_f64(x, -_EXP_C2)).float()
    y = fma(_horner(r, _EXP_P), r * r, r) + 1.0
    pow2 = ((n.to(torch.int32) << 23) + 0x3F800000).view(torch.float32)
    return ftz(y * pow2)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + x)`` of f32 ``x > -1`` as the reference's compiled
    ``log-plus-one`` computes it on the CPU: the Cephes rational (its
    ``-x^2/2`` term fused into the sum) below ``|x| = sqrt 2 - 1``,
    :func:`log` of ``1 + x`` above."""
    q = _horner(x, _LOG1P_P) / _horner(x, _LOG1P_Q)
    x2 = x * x
    small = x + fma(x2, f32(x, -0.5), (x * x2) * q)
    return torch.where(torch.abs(x) < f32(x, _LOG1P_SMALL), small,
                       log(x + 1.0))


def erfc(x: torch.Tensor) -> torch.Tensor:
    """``erfc`` of f32 ``x`` as the reference's compiled HLO expands it
    (``jax.scipy.special.erfc`` in f32), with :func:`exp`."""
    ax = torch.abs(x)
    x2 = x * x
    near = fma(-x, _horner(x2, _ERFC_NEAR), f32(x, 1.0))
    w = 1.0 / x2
    poly = torch.where(ax < 2.0, _horner(w, _ERFC_MID), _horner(w, _ERFC_FAR))
    far = ftz(ftz(exp(-x2) * (1.0 / ax)) * poly)
    far = torch.where(-x2 < f32(x, _ERFC_EXP_MIN), 0.0, far)
    far = torch.where(x < 0.0, 2.0 - far, far)
    return torch.where(ax < 1.0, near, far)


#: XLA's f32 ``erf_inv`` (the CHLO expansion): the polynomials in ``w``
#: for ``w < 5`` and above, highest degree first
_ERFINV_NEAR = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                -4.39150654e-06, 0.00021858087, -0.00125372503,
                -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_FAR = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``erf_inv`` of f32 ``x`` in ``[-1, 1]`` as the reference's compiled
    HLO expands it on the CPU: ``w = -log1p(-x^2)`` (:func:`log1p`), then
    ``w - 2.5`` below 5 or ``sqrt(w) - 3`` above, the matching degree-8
    polynomial in it with its multiply-adds fused, times ``x``; ``x * inf``
    at ``|x| = 1``."""
    w = -log1p(x * -x)
    near = w < 5.0
    t = torch.where(near, w - 2.5, sqrt(w) - 3.0)
    t64 = t.double()
    acc = torch.where(near, f32_in_f64(x, _ERFINV_NEAR[0]),
                      f32_in_f64(x, _ERFINV_FAR[0]))
    for a, b in zip(_ERFINV_NEAR[1:], _ERFINV_FAR[1:]):
        c = torch.where(near, f32_in_f64(x, a), f32_in_f64(x, b))
        acc = torch.addcmul(c, acc, t64).float().double()
    out = acc.float() * x
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), out)
