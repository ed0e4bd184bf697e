// xla_math.cuh — the f32 arithmetic the reference's compiled WiFi error
// model runs, written out as tpudes_torch/ops/fused.py and ops/wifi_error.py
// write it: the same IEEE operations in the same order, so that the CUDA
// kernel and the plain PyTorch version agree bit for bit on the card.
//
// - fma32(a, b, c): a * b + c in f64 (the product of two floats is exact
//   there), rounded once to f64 and once to f32 — fused.fma's arithmetic,
//   not the card's f32 FMA (which rounds once);
// - xla_log: XLA's Cephes logf (fused.log);
// - xla_exp: XLA's CPU exp (fused.exp), flushed below FLT_MIN;
// - xla_log1p: XLA's Cephes log1p (fused.log1p);
// - xla_erfc: XLA's f32 erfc as its HLO expands it (fused.erfc);
// - xla_erf_inv: XLA's f32 erf_inv as its HLO expands it (fused.erf_inv);
// - xla_exp10: 10 ** y as the compiled power computes it, glibc's powf
//   (fused.exp10), in f64 operations each rounded on its own;
// - xla_powf: x ** y the same way, glibc powf's table-driven log2 then its
//   exp2 (fused.powf); xla_cbrt: copysign(xla_powf(|x|, 1/3), x), the
//   compiled cbrt (fused.cbrt);
// - nist_psr: mode_chunk_success_rate with the mode folded into Psr;
//   nist_lg its SNR part, log1p(-pe); mpdu_rate an A-MPDU subframe's rate.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc cannot contract), divisions are __fdiv_rn and roots
// __fsqrt_rn.  Constants are written as the double literals the Python code
// holds and rounded to f32 from there, as np.float32 rounds them.  Build
// without --use_fast_math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace xla_math {

constexpr float kFltMin = 1.17549435e-38f;

__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < kFltMin ? 0.0f : x;
}

__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(__fma_rn(static_cast<double>(a),
                                    static_cast<double>(b),
                                    static_cast<double>(c)));
}

// ((c0 x + c1) x + c2) x + ..., every step one fma32
template <int K>
__device__ __forceinline__ float horner(float x, const double (&c)[K]) {
  float acc = static_cast<float>(c[0]);
#pragma unroll
  for (int k = 1; k < K; ++k) acc = fma32(acc, x, static_cast<float>(c[k]));
  return acc;
}

// Cephes logf as XLA compiles it (fused.log)
__device__ __forceinline__ float xla_log(float x) {
  constexpr double kP[9] = {
      7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
      -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
      2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1};
  const float q1 = static_cast<float>(-2.12194440e-4);
  const float q2 = static_cast<float>(0.693359375);
  const float sqrt_half = static_cast<float>(0.70710677);
  x = fmaxf(x, kFltMin);
  const int bits = __float_as_int(x);
  float e = __fadd_rn(static_cast<float>((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & static_cast<int>(0x807FFFFF)) |
                                 0x3F000000);
  const bool low = m < sqrt_half;
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float z = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float z2 = __fmul_rn(z, z);
  const float z3 = __fmul_rn(z2, z);
  const float p[9] = {
      static_cast<float>(kP[0]), static_cast<float>(kP[1]),
      static_cast<float>(kP[2]), static_cast<float>(kP[3]),
      static_cast<float>(kP[4]), static_cast<float>(kP[5]),
      static_cast<float>(kP[6]), static_cast<float>(kP[7]),
      static_cast<float>(kP[8])};
  const float y0 = fma32(fma32(z, p[0], p[1]), z, p[2]);
  const float y1 = fma32(fma32(z, p[3], p[4]), z, p[5]);
  const float y2 = fma32(fma32(z, p[6], p[7]), z, p[8]);
  float y = fma32(fma32(y0, z3, y1), z3, y2);
  y = fma32(y, z3, __fmul_rn(e, q1));
  return __fadd_rn(__fadd_rn(fma32(-0.5f, z2, z), y), __fmul_rn(e, q2));
}

// XLA's CPU exp (Cephes expf), flushed below FLT_MIN (fused.exp)
__device__ __forceinline__ float xla_exp(float x) {
  constexpr double kP[6] = {1.9875691500e-4, 1.3981999507e-3,
                            8.3334519073e-3, 4.1665795894e-2,
                            1.6666665459e-1, 0.5};
  x = fminf(fmaxf(x, static_cast<float>(-87.8)), static_cast<float>(88.8));
  float n = floorf(fma32(x, static_cast<float>(1.44269502), 0.5f));
  n = fminf(fmaxf(n, -127.0f), 127.0f);
  float r = fma32(n, -static_cast<float>(0.693359375), x);
  r = fma32(n, -static_cast<float>(-2.12194440e-4), r);
  const float y =
      __fadd_rn(fma32(horner(r, kP), __fmul_rn(r, r), r), 1.0f);
  const float pow2 =
      __int_as_float((static_cast<int>(n) << 23) + 0x3F800000);
  return ftz(__fmul_rn(y, pow2));
}

// XLA's Cephes log1p (fused.log1p)
__device__ __forceinline__ float xla_log1p(float x) {
  constexpr double kQ[7] = {
      1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
      2.2176239823732856465394e2, 3.0909872225312059774938e2,
      2.1642788614495947685003e2, 6.0118660497603843919306e1};
  constexpr double kP[7] = {
      4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
      6.5787325942061044846969e0, 2.9911919328553073277375e1,
      6.0949667980987787057556e1, 5.7112963590585538103336e1,
      2.0039553499201281259648e1};
  if (fabsf(x) < static_cast<float>(0.41421356237309504880)) {
    const float q = __fdiv_rn(horner(x, kP), horner(x, kQ));
    const float x2 = __fmul_rn(x, x);
    return __fadd_rn(
        x, fma32(x2, -0.5f, __fmul_rn(__fmul_rn(x, x2), q)));
  }
  return xla_log(__fadd_rn(x, 1.0f));
}

// XLA's f32 erfc as its HLO expands it (fused.erfc)
__device__ __forceinline__ float xla_erfc(float x) {
  constexpr double kNear[7] = {7.85386146e-05, -0.000801019371,
                               0.00518832775,  -0.0268538129,
                               0.112835854,    -0.37612626,
                               1.12837911};
  constexpr double kMid[9] = {0.0232682,   -0.138703942, 0.368742466,
                              -0.582473278, 0.621000469,  -0.494451523,
                              0.340488,     -0.274112701, 0.563825965};
  constexpr double kFar[8] = {-10.477664,  12.9772,     -7.49551868,
                              2.92101908,  -1.01526523, 0.42184633,
                              -0.282076746, 0.564189494};
  const float ax = fabsf(x);
  const float x2 = __fmul_rn(x, x);
  if (ax < 1.0f) return fma32(-x, horner(x2, kNear), 1.0f);
  if (-x2 < static_cast<float>(-88.7228394)) return x < 0.0f ? 2.0f : 0.0f;
  const float w = __fdiv_rn(1.0f, x2);
  const float poly = ax < 2.0f ? horner(w, kMid) : horner(w, kFar);
  float far = ftz(__fmul_rn(ftz(__fmul_rn(xla_exp(-x2), __fdiv_rn(1.0f, ax))),
                            poly));
  return x < 0.0f ? __fsub_rn(2.0f, far) : far;
}

// XLA's f32 erf_inv as its HLO expands it (fused.erf_inv): w = -log1p(-x^2),
// the degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3 with its
// multiply-adds fused, times x; x * inf at |x| = 1
__device__ __forceinline__ float xla_erf_inv(float x) {
  constexpr double kNear[9] = {2.81022636e-08,  3.43273939e-07, -3.5233877e-06,
                               -4.39150654e-06, 0.00021858087,  -0.00125372503,
                               -0.00417768164, 0.246640727,    1.50140941};
  constexpr double kFar[9] = {-0.000200214257, 0.000100950558, 0.00134934322,
                              -0.00367342844,  0.00573950773,  -0.0076224613,
                              0.00943887047,   1.00167406,     2.83297682};
  const float w = -xla_log1p(__fmul_rn(x, -x));
  const bool near = w < 5.0f;
  const float t =
      near ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float acc = static_cast<float>(near ? kNear[0] : kFar[0]);
#pragma unroll
  for (int k = 1; k < 9; ++k)
    acc = fma32(acc, t, static_cast<float>(near ? kNear[k] : kFar[k]));
  return fabsf(x) == 1.0f ? __fmul_rn(x, INFINITY) : __fmul_rn(acc, x);
}

// glibc powf's exp2 table: the bits of 2 ** (i / 32) in f64 (fused.py::
// _exp2f_table)
static __constant__ long long kExp2Tab[32] = {
    0x3ff0000000000000LL, 0x3ff059b0d3158574LL, 0x3ff0b5586cf9890fLL,
    0x3ff11301d0125b51LL, 0x3ff172b83c7d517bLL, 0x3ff1d4873168b9aaLL,
    0x3ff2387a6e756238LL, 0x3ff29e9df51fdee1LL, 0x3ff306fe0a31b715LL,
    0x3ff371a7373aa9cbLL, 0x3ff3dea64c123422LL, 0x3ff44e086061892dLL,
    0x3ff4bfdad5362a27LL, 0x3ff5342b569d4f82LL, 0x3ff5ab07dd485429LL,
    0x3ff6247eb03a5585LL, 0x3ff6a09e667f3bcdLL, 0x3ff71f75e8ec5f74LL,
    0x3ff7a11473eb0187LL, 0x3ff82589994cce13LL, 0x3ff8ace5422aa0dbLL,
    0x3ff93737b0cdc5e5LL, 0x3ff9c49182a3f090LL, 0x3ffa5503b23e255dLL,
    0x3ffae89f995ad3adLL, 0x3ffb7f76f2fb5e47LL, 0x3ffc199bdd85529cLL,
    0x3ffcb720dcef9069LL, 0x3ffd5818dcfba487LL, 0x3ffdfc97337b9b5fLL,
    0x3ffea4afa2a490daLL, 0x3fff50765b6e4540LL};

// glibc powf's exp2 of f64 x before its last rounding (fused.py::_exp2):
// x = k / 32 + r, 2 ** (k / 32) from the table times a cubic in r
__device__ __forceinline__ double glibc_exp2(double x) {
  const double c0 = 0x1.c6af84b912394p-5, c1 = 0x1.ebfce50fac4f3p-3,
               c2 = 0x1.62e42ff0c52d6p-1, shift = 0x1.8p+47;
  const double kd = __dsub_rn(__dadd_rn(x, shift), shift);
  const double r = __dsub_rn(x, kd);
  const long long k = static_cast<long long>(__dmul_rn(kd, 32.0));
  const double s = __longlong_as_double(kExp2Tab[k & 31] + ((k >> 5) << 52));
  return __dmul_rn(
      __dadd_rn(__dmul_rn(__dadd_rn(__dmul_rn(c0, r), c1), __dmul_rn(r, r)),
                __dadd_rn(__dmul_rn(c2, r), 1.0)),
      s);
}

// an f64 result rounded to f32, below FLT_MIN flushed to 0 (fused._flush)
__device__ __forceinline__ float flush_f32(double out) {
  return out < 1.17549435e-38 ? 0.0f : __double2float_rn(out);
}

// 10 ** y for f32 y as glibc's powf(10, y) computes it (fused.exp10):
// x = y log2(10) in f64, then glibc_exp2, rounded once to f32
__device__ __forceinline__ float xla_exp10(float y) {
  return flush_f32(glibc_exp2(
      __dmul_rn(static_cast<double>(y), 0x1.a934f0979b22dp+1)));
}

// glibc powf's log2 (e_powf_log2_data.c): (1 / c, log2 c) of 16
// subintervals of [OFF, 2 OFF), and the degree-5 polynomial (fused.py::
// _POWF_LOG2_TAB, _POWF_LOG2_POLY)
static __constant__ double kPowfInvc[16] = {
    0x1.661ec79f8f3bep+0, 0x1.571ed4aaf883dp+0, 0x1.49539f0f010b0p+0,
    0x1.3c995b0b80385p+0, 0x1.30d190c8864a5p+0, 0x1.25e227b0b8ea0p+0,
    0x1.1bb4a4a1a343fp+0, 0x1.12358f08ae5bap+0, 0x1.0953f419900a7p+0,
    0x1.0000000000000p+0, 0x1.e608cfd9a47acp-1, 0x1.ca4b31f026aa0p-1,
    0x1.b2036576afce6p-1, 0x1.9c2d163a1aa2dp-1, 0x1.886e6037841edp-1,
    0x1.767dcf5534862p-1};
static __constant__ double kPowfLogc[16] = {
    -0x1.efec65b963019p-2, -0x1.b0b6832d4fca4p-2, -0x1.7418b0a1fb77bp-2,
    -0x1.39de91a6dcf7bp-2, -0x1.01d9bf3f2b631p-2, -0x1.97c1d1b3b7af0p-3,
    -0x1.2f9e393af3c9fp-3, -0x1.960cbbf788d5cp-4, -0x1.a6f9db6475fcep-5,
    0x0.0p+0,              0x1.338ca9f24f53dp-4,  0x1.476a9543891bap-3,
    0x1.e840b4ac4e4d2p-3,  0x1.40645f0c6651cp-2,  0x1.88e9c2c1b9ff8p-2,
    0x1.ce0a44eb17bccp-2};

// glibc powf's f64 log2 of positive normal f32 x (fused.py::_log2)
__device__ __forceinline__ double glibc_log2(float x) {
  const double a0 = 0x1.27616c9496e0bp-2, a1 = -0x1.71969a075c67ap-2,
               a2 = 0x1.ec70a6ca7baddp-2, a3 = -0x1.7154748bef6c8p-1,
               a4 = 0x1.71547652ab82bp+0;
  const uint32_t ix = __float_as_uint(x);
  const uint32_t tmp = ix - 0x3F330000u;
  const int i = static_cast<int>((tmp >> 19) & 15u);
  const uint32_t top = tmp & 0xFF800000u;
  const double z = static_cast<double>(__uint_as_float(ix - top));
  const double k = static_cast<double>(static_cast<int32_t>(top) >> 23);
  const double r = __dsub_rn(__dmul_rn(z, kPowfInvc[i]), 1.0);
  const double y0 = __dadd_rn(kPowfLogc[i], k);
  const double r2 = __dmul_rn(r, r);
  double q = __dadd_rn(__dmul_rn(a4, r), y0);
  q = __dadd_rn(__dmul_rn(__dadd_rn(__dmul_rn(a2, r), a3), r2), q);
  return __dadd_rn(
      __dmul_rn(__dadd_rn(__dmul_rn(a0, r), a1), __dmul_rn(r2, r2)), q);
}

// x ** y for f32 x (0 or normal) and y as the compiled power computes it,
// glibc's powf (fused.powf): y log2 x in f64, glibc_exp2 of it clamped to
// [-200, 200], rounded once; past the overflow bound inf, at or below -150
// zero; x = 0 gives 0 (y > 0) or inf (y < 0), y = 0 or x = 1 gives 1, a
// negative x NaN
__device__ __forceinline__ float xla_powf(float x, float y) {
  if (y == 0.0f || x == 1.0f) return 1.0f;
  if (x < 0.0f) return __int_as_float(0x7FC00000);
  if (x == 0.0f) return y > 0.0f ? 0.0f : (y < 0.0f ? INFINITY : 1.0f);
  const double ylogx = __dmul_rn(static_cast<double>(y), glibc_log2(x));
  if (ylogx > 0x1.fffffffd1d571p+6) return INFINITY;
  if (ylogx <= -150.0) return 0.0f;
  return flush_f32(glibc_exp2(fmin(fmax(ylogx, -200.0), 200.0)));
}

// the compiled cbrt: copysign(powf(|x|, (float)(1 / 3)), x) (fused.cbrt)
__device__ __forceinline__ float xla_cbrt(float x) {
  return copysignf(xla_powf(fabsf(x), static_cast<float>(1.0 / 3.0)), x);
}

// the error model's per-mode constants (bss_cuda.py::psr_params)
struct Psr {
  float scale, factor;  // ber = factor * erfc(sqrt(snr * scale))
  float log_c[10], exps[10];
  float b;              // the rate's factor
  int mask;             // bit k: term k has a nonzero weight
};

// log1p(-pe) of the error model at snr: the part of the success rate the
// SNR alone decides (ops/wifi_error.py::log1p_neg_pe)
__device__ __forceinline__ float nist_lg(float snr, const Psr& p) {
  const float ber = ftz(__fmul_rn(
      p.factor, xla_erfc(__fsqrt_rn(__fmul_rn(snr, p.scale)))));
  const float pc = fminf(fmaxf(ber, 0.0f), 0.5f);
  const float d =
      __fsqrt_rn(__fmul_rn(__fmul_rn(pc, 4.0f), __fsub_rn(1.0f, pc)));
  const float log_d = xla_log(fmaxf(d, static_cast<float>(1e-35)));
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 10; ++k)
    if ((p.mask >> k) & 1)
      acc = __fadd_rn(acc, xla_exp(fma32(log_d, p.exps[k], p.log_c[k])));
  float pe = fminf(fmaxf(ftz(__fmul_rn(acc, p.b)), 0.0f), 1.0f);
  pe = fminf(pe, static_cast<float>(1.0 - 1e-12));
  return xla_log1p(-pe);
}

// mode_chunk_success_rate(snr, nbits, mode) (ops/wifi_error.py)
__device__ __forceinline__ float nist_psr(float snr, const Psr& p,
                                          float nbits) {
  return xla_exp(__fmul_rn(nbits, nist_lg(snr, p)));
}

// one subframe's success rate in an A-MPDU of k (ops/wifi_error.py::
// mpdu_success_rate): psr ** (1 / k) as the compiled step computes it,
// exp((nbits * lg) * (1 / k)); k = 1 gives nist_psr's value
__device__ __forceinline__ float mpdu_rate(float lg, float nbits, int k) {
  return xla_exp(__fmul_rn(__fmul_rn(nbits, lg),
                           __fdiv_rn(1.0f, static_cast<float>(k))));
}

}  // namespace xla_math
