// wifi_window.cu — the fused WiFi PHY window as a CUDA kernel, and its C
// interface.
//
// Replaces the reference's window kernel, tpudes/parallel/kernels.py:56-104
// (wifi_phy_window: XLA code, no pallas_call; replicated, :107-116, vmaps it
// over replicas) and its scan, :119-140 (multi_window_scan, a lax.scan over
// windows, vmapped over replica keys).  The plain version is
// parallel/kernels.py (window_math, scan_math), which this kernel equals bit
// for bit.
//
// Three entries, each launching one kernel:
// - the window (wifi_window_launch): one CTA of eight warps a replica, (R,
//   N) inputs and (R, 2) keys, writing ok, sinr and rx_dbm (R, N, N), NIST
//   or table;
// - the scan's geometry (wifi_geometry_launch): the shared positions' rx
//   power in W (0 on the diagonal) and detectability, N x N;
// - the scan (wifi_scan_launch), over that geometry: a warp a (window,
//   replica) at a time, SCAN_ITEMS of them in turn, replica-major, adding
//   its count of decoded frames to delivered[r] with an integer atomic when
//   it leaves a replica (exact in any order).
//
// Bound.  Every pair is independent given the window's transmitters and
// column sums, so the work is R x W x N^2 pair evaluations, of which only
// those that may decode (a transmitter's frame at a receiver that is not
// transmitting and clears the sensitivity: about 780 of the 4,225 at the
// bench's 65 nodes) run the error model and draw a coin; that model's f32
// chain (erfc, log, up to ten exps, log1p, exp) bounds the kernel
// (chip_smoke.py::window_bound counts it), not bytes (a window reads N
// positions and writes one count).  The design follows from it:
// - the chain's multiply-adds (xla_math::fma32: a * b + c rounded to f64
//   and then to f32) keep their values in f64 registers and round each
//   result to f32 in the f64 pipe (r24 below), off the f32 <-> f64
//   conversions, which run at 16 a clock an SM;
// - a warp draws its window's transmitters by ballots into a list (about 16
//   of 65), sums each receiver's column over that list only, and streams
//   the pairs that may decode through a ring in shared memory, so that its
//   lanes run the chain full, 32 pairs at a time;
// - the geometry (the scan's rx_w and det, the window's own links, each
//   computed once) sits in shared memory where N allows, else in device
//   memory (the window: its own sinr and rx_dbm slabs, outputs it
//   overwrites).
//
// Order.  The column sum total_w[rx] = sum over tx of rx_w[tx, rx] takes
// the reference's order: up to 32 rows from the first, else in blocks of 32
// rows (the rows padded to a multiple of 32, half the pad in front), each
// block from its first row, then the blocks in order (the CPU backend's
// reduce-window then reduce; kernels.py::sum_blocks).  A row whose node is
// idle adds +0.0, which leaves every partial sum's bits as they are (the
// terms are +0.0 or positive), so the sum over the transmitter list, block
// by block in list order, is the same sum.
//
// Arithmetic.  Every f32 product, sum and quotient is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, or their f64 forms
// rounded by r24, which nvcc cannot contract); log, exp, log1p and erfc
// are xla_math.cuh's, written out here over f64 registers, and 10 ** x is
// xla_math::xla_exp10.  The per-mode numbers (the QAM factor and divisor,
// the union bound's logs) arrive from the wrapper as the plain version
// computes them (ops/wifi_error.py::mode_table).  Build without
// --use_fast_math.
//
// The stage probe (wifi_window_profile, wifi_scan_profile: the PROF
// instantiations) reads clock64() at each stage's edges in every lane and
// adds, for each warp, its slowest lane's cycles in each stage to prof[stage]
// (window_cuda.py::WIN_PROF_STAGES).  wifi_fma_check holds the f64
// multiply-add against xla_math::fma32, wifi_chain_check the f64 exp, log,
// log1p and erfc against xla_math.cuh's.
//
// The source also builds with g++ against csrc/mock/cuda_runtime.h, which
// runs it on the CPU (tests/test_torch_window_mock.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "xla_math.cuh"

// the kernels' dynamic shared memory
extern __shared__ __align__(16) unsigned char dyn_smem[];

namespace win_kernel {

// the most nodes a window holds (kernels.py::MAX_NODES): the column sum's
// two levels of 32-row blocks
constexpr int WIN_MAX_NODES = 1024;
constexpr int SUM_BLOCK = 32;
constexpr int N_MODES = 20;
constexpr int N_TERMS = 10;
// a mode's row of the per-mode table: constellation, div, factor, b, then
// the ten log_c and the ten exps (window_cuda.py::MODE_COLUMNS)
constexpr int MODE_COLS = 4 + 2 * N_TERMS;
constexpr int TABLE_POINTS = 91;
constexpr unsigned FULL = 0xFFFFFFFFu;
// a CTA's warps (both kernels), the (window, replica) items a scan warp
// takes in turn, and a warp's ring of pairs that may decode
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int SCAN_ITEMS = 16;
constexpr int RING = 64;
// the most shared memory a CTA gives the geometry (5 N^2 bytes: N up to
// 140) before it reads it from device memory
constexpr int GEOM_SMEM_MAX = 96 * 1024;

// the probe's stages (window_cuda.py::WIN_PROF_STAGES): the keys and the
// transmitters, the column sums, a pair's link and SINR, its BER (erfc, or
// the table's interpolation), log_d, the union bound's terms, log1p, the
// last exp, the coin, and the count or the stores
enum Stage {
  S_SETUP, S_SUMS, S_LINK, S_BER, S_LOGD, S_TERMS, S_LOG1P, S_EXP, S_COIN,
  S_OUT, N_STAGES
};

// under PROF each lane reads clock64() at the stage edges and adds the
// cycles since the last edge to the stage's count; start() restarts without
// counting (a lane's wait for the warp's other lanes is no stage's)
template <bool PROF>
struct Clock {
  long long last = 0, acc[N_STAGES] = {};
  __device__ __forceinline__ void start() {
    if constexpr (PROF) last = clock64();
  }
  __device__ __forceinline__ void mark(int stage) {
    if constexpr (PROF) {
      const long long now = clock64();
      acc[stage] += now - last;
      last = now;
    }
  }
  // each warp's slowest lane, added to prof[stage] (every lane calls it)
  __device__ __forceinline__ void flush(long long* prof) {
    if constexpr (PROF) {
      for (int k = 0; k < N_STAGES; ++k) {
        const int c = __reduce_max_sync(
            FULL, static_cast<int>(acc[k] < 0x7FFFFFFF ? acc[k] : 0x7FFFFFFF));
        if ((threadIdx.x & 31) == 0)
          atomicAdd(reinterpret_cast<unsigned long long*>(prof + k),
                    static_cast<unsigned long long>(c));
      }
    }
  }
};

// ---------------------------------------------------------------------------
// f32 values in f64 registers
//
// xla_math::fma32(a, b, c) is a * b + c rounded once to f64 (the product of
// two floats is exact there) and once to f32.  Its two conversions between
// f32 and f64 run at 16 a clock an SM, an eighth of the f32 rate, and the
// error model runs ~150 of them a pair.  So the chains below hold each value
// as an f64 that is an f32 value and round every result to f32 in the f64
// pipe: Veltkamp's split with the factor 2^29 + 1 gives an f64's nearest
// 24-bit value, ties to even (binary arithmetic rounding to nearest even),
// which is f32's rounding wherever f32 holds the result as a normal number
// or as zero; a chain with a result elsewhere (|y| below 2^-126 or at 2^127
// and above, infinities, NaN) runs again as the f32 chain over
// xla_math::fma32 (rare: subnormal or huge results).  A sum, difference or
// product of two f32 values taken in f64 and rounded to f32 equals the f32
// operation (53 >= 2 x 24 + 2: that double rounding is innocuous), so the
// chains take those in f64 too; a quotient goes through __fdiv_rn.
// ---------------------------------------------------------------------------

// the arithmetic of the chains: ok stays true while every result lies
// where r24 is f32's rounding; a chain that clears it is redone by the f32
// path (xla_math.cuh's functions), so its result is exact either way.  The
// test reads y's high word as an f32 (|y|'s exponent and top mantissa bits):
// 2^-126 <= |y| < 2^127 is [0x1.2p-15, 0x1.cp16) there, and zero is zero.
//
// Most steps need no test: every step of the polynomials below (exp's,
// log's and log1p's, erfc's three) over its input's domain, and exp's
// reduction, lies in [7e-4, 420] or is an exact f32 (sampled at 8 M points
// of each domain; the smallest step value, 7.2e-4, is erfc's first near
// one); those round by round24 and fmau.
struct F32d {
  bool ok = true;
  // y rounded to its nearest 24-bit value (Veltkamp's split)
  __device__ __forceinline__ static double round24(double y) {
    const double c = __dmul_rn(y, 536870913.0);
    return __dsub_rn(c, __dsub_rn(c, y));
  }
  // y rounded to f32, as an f64, clearing ok where that is not f32's
  __device__ __forceinline__ double r24(double y) {
    const float e = fabsf(__int_as_float(__double2hiint(y)));
    ok = ok & ((e >= 0x1.2p-15f & e < 0x1.cp16f) | e == 0.0f);
    return round24(y);
  }
  // xla_math::fma32 on f32 values held in f64: a * b + c rounded to f64,
  // then to f32
  __device__ __forceinline__ double fma(double a, double b, double c) {
    return r24(__fma_rn(a, b, c));
  }
  // the same for a result known to lie in f32's normal range
  __device__ __forceinline__ static double fmau(double a, double b,
                                                double c) {
    return round24(__fma_rn(a, b, c));
  }
  // the same for a result known to lie in [2^E, 2^(E + 1)): y + 1.5 *
  // 2^(E + 29) rounds y to that binade's f32 grid, ties to even
  template <int E>
  __device__ __forceinline__ static double fma_in(double a, double b,
                                                  double c) {
    constexpr double m = 1.5 * static_cast<double>(1ll << (E + 40)) /
                         static_cast<double>(1ll << 11);
    return __dsub_rn(__dadd_rn(__fma_rn(a, b, c), m), m);
  }
  // x is an f32 value: clears ok where it is nonzero below 2^-60 (exp_d's
  // reduction keeps such an x whole, whose square leaves f32's range)
  __device__ __forceinline__ void not_tiny(double x) {
    const float e = fabsf(__int_as_float(__double2hiint(x)));
    ok = ok & (e >= 0x1.6p-7f | e == 0.0f);
  }
  __device__ __forceinline__ double add(double a, double b) {
    return r24(__dadd_rn(a, b));
  }
  __device__ __forceinline__ double mul(double a, double b) {
    return r24(__dmul_rn(a, b));
  }
  // ((c0 x + c1) x + c2) x + ..., every step one fma32 (the polynomials of
  // exp, log1p and erfc, each step in range)
  template <int K>
  __device__ __forceinline__ static double horner(double x,
                                                  const double (&c)[K]) {
    double acc = static_cast<float>(c[0]);
#pragma unroll
    for (int k = 1; k < K; ++k) acc = fmau(acc, x, static_cast<float>(c[k]));
    return acc;
  }
};

__device__ __forceinline__ double ftz_d(double x) {
  return fabs(x) < 0x1p-126 ? 0.0 : x;
}

// xla_math::xla_exp of an f32 value: Cephes expf as XLA's CPU backend
// compiles it, flushed below FLT_MIN; floor(u) is u + 1.5 * 2^52 rounded
// down, whose low word is the exponent's integer
__device__ __forceinline__ double exp_d(F32d& f, double x) {
  constexpr double kP[6] = {1.9875691500e-4, 1.3981999507e-3,
                            8.3334519073e-3, 4.1665795894e-2,
                            1.6666665459e-1, 0.5};
  constexpr double kMagic = 0x1.8p52;
  x = fmin(fmax(x, static_cast<double>(static_cast<float>(-87.8))),
           static_cast<double>(static_cast<float>(88.8)));
  // u (|u| <= 129, a multiple of 2^-48), r (a multiple of 2^-36, or x:
  // |r| <= 0.771), the polynomial's steps (the first four each in one
  // binade), r^2, the last multiply-add (each 0 or at least 2^-120 in
  // size once x is 0 or at least 2^-60) and y (in [0.7, 2.2]) lie in range
  f.not_tiny(x);
  const double u = f.fmau(x, static_cast<float>(1.44269502), 0.5);
  const double s = __dadd_rd(u, kMagic);
  const int ni = max(min(__double2loint(s), 127), -127);
  const double n = ni;
  double r = f.fmau(n, -static_cast<float>(0.693359375), x);
  r = f.fmau(n, -static_cast<float>(-2.12194440e-4), r);
  double q = f.fma_in<-10>(static_cast<float>(kP[0]), r,
                           static_cast<float>(kP[1]));
  q = f.fma_in<-7>(q, r, static_cast<float>(kP[2]));
  q = f.fma_in<-5>(q, r, static_cast<float>(kP[3]));
  q = f.fma_in<-3>(q, r, static_cast<float>(kP[4]));
  q = f.fmau(q, r, static_cast<float>(kP[5]));
  const double v = f.fmau(q, f.round24(__dmul_rn(r, r)), r);
  const double y = f.round24(__dadd_rn(v, 1.0));
  // y * 2^n as f32 multiplies it: exact from FLT_MIN up (y, in (0.5, 2.2),
  // holds 24 bits), so for n in -125 .. 126; infinite from 2^128, below
  // FLT_MIN rounded to a subnormal, which the flush zeroes unless it rounds
  // up to FLT_MIN (2^n is 0 at n = -127)
  const double p = __dmul_rn(y, __hiloint2double((ni + 1023) << 20, 0));
  if (ni >= -125 && ni <= 126) return p;
  if (p >= 0x1p128) return __longlong_as_double(0x7FF0000000000000LL);
  return p >= 0x1.fffffep-127 ? fmax(p, 0x1p-126) : 0.0;
}

// xla_math::xla_log: Cephes logf as XLA compiles it
__device__ __forceinline__ double log_d(F32d& f, float x) {
  constexpr double kP[9] = {
      7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
      -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
      2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1};
  const float q1 = static_cast<float>(-2.12194440e-4);
  const float q2 = static_cast<float>(0.693359375);
  const float sqrt_half = static_cast<float>(0.70710677);
  x = fmaxf(x, xla_math::kFltMin);
  const int bits = __float_as_int(x);
  float e = __fadd_rn(static_cast<float>((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & static_cast<int>(0x807FFFFF)) |
                                 0x3F000000);
  const bool low = m < sqrt_half;
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float z = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float z2 = __fmul_rn(z, z);
  const double zd = z, z3 = __fmul_rn(z2, z);
  double p[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) p[k] = static_cast<float>(kP[k]);
  // z in [sqrt(0.5) - 1, sqrt(2) - 1]: y0, y1, y2 and the next two steps
  // lie in range
  const double y0 = f.fmau(f.fmau(zd, p[0], p[1]), zd, p[2]);
  const double y1 = f.fmau(f.fmau(zd, p[3], p[4]), zd, p[5]);
  const double y2 = f.fmau(f.fmau(zd, p[6], p[7]), zd, p[8]);
  double y = f.fmau(f.fmau(y0, z3, y1), z3, y2);
  y = f.fma(y, z3, __fmul_rn(e, q1));
  return f.add(f.add(f.fma(-0.5, z2, zd), y), __fmul_rn(e, q2));
}

// xla_math::xla_log1p of an f32 value: Cephes log1p
__device__ __forceinline__ double log1p_d(F32d& f, double x) {
  constexpr double kQ[7] = {
      1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
      2.2176239823732856465394e2, 3.0909872225312059774938e2,
      2.1642788614495947685003e2, 6.0118660497603843919306e1};
  constexpr double kP[7] = {
      4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
      6.5787325942061044846969e0, 2.9911919328553073277375e1,
      6.0949667980987787057556e1, 5.7112963590585538103336e1,
      2.0039553499201281259648e1};
  if (fabs(x) < static_cast<float>(0.41421356237309504880)) {
    const double q = __fdiv_rn(static_cast<float>(f.horner(x, kP)),
                               static_cast<float>(f.horner(x, kQ)));
    const double x2 = f.mul(x, x);
    return f.add(x, f.fma(x2, -0.5, f.mul(f.mul(x, x2), q)));
  }
  return log_d(f, __fadd_rn(static_cast<float>(x), 1.0f));
}

// xla_math::xla_erfc: XLA's f32 erfc as its HLO expands it
__device__ __forceinline__ double erfc_d(F32d& f, float x) {
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
  if (ax < 1.0f) return f.fmau(-x, f.horner(x2, kNear), 1.0);  // erfc(x)
  if (-x2 < static_cast<float>(-88.7228394)) return x < 0.0f ? 2.0 : 0.0;
  const double w = __fdiv_rn(1.0f, x2);
  const double poly = ax < 2.0f ? f.horner(w, kMid) : f.horner(w, kFar);
  const double far = ftz_d(f.mul(
      ftz_d(f.mul(exp_d(f, -x2), __fdiv_rn(1.0f, ax))), poly));
  return x < 0.0f ? f.add(2.0, -far) : far;
}

// ---------------------------------------------------------------------------
// the error model
// ---------------------------------------------------------------------------

// a mode's numbers in shared memory, the union bound's in f64
struct ModeRow {
  double log_c[N_TERMS], exps[N_TERMS];
  float c, div, factor, b;
  int keep, pad;
};

struct Args {
  const float* pos;        // (R, N, 3) window; (N, 3) geometry
  const uint8_t* tx;       // (R, N) window
  const float* prob;       // (N,) scan
  const int* mode;         // (R, N) window; (N,) scan
  const float* fb;         // (R, N) window; (N,) scan
  const long long* keys;   // (R, 2)
  const float* modes;      // (N_MODES, MODE_COLS)
  const int* keep;         // (N_MODES,) bit k: term k's weight is nonzero
  const float* per;        // (N_MODES, TABLE_POINTS) f32 PER table, or null
  float* rx_w;             // (N, N) scan's geometry
  uint8_t* det;            // (N, N)
  uint8_t* ok;             // (R, N, N) window's outputs
  float* sinr;
  float* rx_dbm;
  int* delivered;          // (R,) scan's counts
  long long* prof;         // the probe's (N_STAGES,) cycles, or null
  int R, N, W, table, geom_smem;
  float tx_dbm, tx30, k_loss, ref_loss, sens, noise, db_per_ln, table_scale;
};

// log1p(-pe) of the NIST model with the transmitter's mode (ops/
// wifi_error.py::log1p_neg_pe_at): the BPSK, QPSK or QAM argument of one
// erfc (the QAM argument sqrt(rx_w / (den div)) as the compiled window
// divides once), then the union bound
template <bool PROF>
__device__ __forceinline__ double nist_lg(F32d& f, const ModeRow& md,
                                          float sinr, float rx_w, float den,
                                          Clock<PROF>& clk) {
  float arg, fac = 0.5f;
  if (md.c <= 2.0f) {
    arg = __fsqrt_rn(sinr);
  } else if (md.c <= 4.0f) {
    arg = __fsqrt_rn(__fmul_rn(sinr, 0.5f));
  } else {
    arg = __fsqrt_rn(__fdiv_rn(rx_w, __fmul_rn(den, md.div)));
    fac = md.factor;
  }
  const double ber = ftz_d(f.mul(erfc_d(f, arg), fac));
  clk.mark(S_BER);
  const float pc = static_cast<float>(fmin(fmax(ber, 0.0), 0.5));
  const float d =
      __fsqrt_rn(__fmul_rn(__fmul_rn(pc, 4.0f), __fsub_rn(1.0f, pc)));
  const double ld = log_d(f, fmaxf(d, static_cast<float>(1e-35)));
  clk.mark(S_LOGD);
  // each term is 0 or in [2^-126, e^80] (ld <= 0, exps >= 0, log_c <= 80:
  // window_cuda.py::mode_args holds the table to that), so their sum lies
  // in range
  double acc = 0.0;
#pragma unroll 1
  for (int k = 0; k < N_TERMS; ++k)
    if ((md.keep >> k) & 1)
      acc = f.round24(
          __dadd_rn(acc, exp_d(f, f.fma(ld, md.exps[k], md.log_c[k]))));
  double pe = fmin(fmax(ftz_d(f.mul(acc, md.b)), 0.0), 1.0);
  pe = fmin(pe, static_cast<double>(static_cast<float>(1.0 - 1e-12)));
  clk.mark(S_TERMS);
  const double lg = log1p_d(f, -pe);
  clk.mark(S_LOG1P);
  return lg;
}

// log1p(-per_ref) of the table model (ops/wifi_error.py::table_lg)
template <bool PROF>
__device__ __forceinline__ double table_lg(F32d& f, const Args& a, int m,
                                           float sinr, Clock<PROF>& clk) {
  const double lg = log_d(f, fmaxf(sinr, static_cast<float>(1e-30)));
  float x =
      static_cast<float>(f.mul(f.fma(lg, a.db_per_ln, 5.0), 2.0));
  x = fminf(fmaxf(x, 0.0f), static_cast<float>(TABLE_POINTS - 1));
  const int lo = min(max(__float2int_rz(x), 0), TABLE_POINTS - 2);
  const float frac = __fsub_rn(x, static_cast<float>(lo));
  const float* row = a.per + m * TABLE_POINTS;
  double per = f.fma(row[lo + 1], frac,
                      __fmul_rn(row[lo], __fsub_rn(1.0f, frac)));
  per = fmin(per, static_cast<double>(static_cast<float>(1.0 - 1e-7)));
  clk.mark(S_BER);
  const double out = log1p_d(f, -per);
  clk.mark(S_LOG1P);
  return out;
}

// the f32 chain (xla_math.cuh's functions, xla_math::fma32 at each
// multiply-add), for a pair whose f64 chain left r24's range: log1p(-pe) of
// the NIST model, or of the table's
__device__ __noinline__ float lg_f32(const Args& a, const ModeRow& md, int m,
                                     float sinr, float rx_w, float den) {
  using namespace xla_math;
  if (a.table) {
    const float lg = xla_log(fmaxf(sinr, static_cast<float>(1e-30)));
    float x = __fmul_rn(fma32(lg, a.db_per_ln, 5.0f), 2.0f);
    x = fminf(fmaxf(x, 0.0f), static_cast<float>(TABLE_POINTS - 1));
    const int lo = min(max(__float2int_rz(x), 0), TABLE_POINTS - 2);
    const float frac = __fsub_rn(x, static_cast<float>(lo));
    const float* row = a.per + m * TABLE_POINTS;
    float per =
        fma32(row[lo + 1], frac, __fmul_rn(row[lo], __fsub_rn(1.0f, frac)));
    per = fminf(per, static_cast<float>(1.0 - 1e-7));
    return xla_log1p(-per);
  }
  float ber;
  if (md.c <= 2.0f) {
    ber = ftz(__fmul_rn(xla_erfc(__fsqrt_rn(sinr)), 0.5f));
  } else if (md.c <= 4.0f) {
    ber = ftz(__fmul_rn(xla_erfc(__fsqrt_rn(__fmul_rn(sinr, 0.5f))), 0.5f));
  } else {
    const float z = __fsqrt_rn(__fdiv_rn(rx_w, __fmul_rn(den, md.div)));
    ber = ftz(__fmul_rn(md.factor, xla_erfc(z)));
  }
  const float pc = fminf(fmaxf(ber, 0.0f), 0.5f);
  const float d =
      __fsqrt_rn(__fmul_rn(__fmul_rn(pc, 4.0f), __fsub_rn(1.0f, pc)));
  const float log_d = xla_log(fmaxf(d, static_cast<float>(1e-35)));
  float acc = 0.0f;
  for (int k = 0; k < N_TERMS; ++k)
    if ((md.keep >> k) & 1)
      acc = __fadd_rn(acc, xla_exp(fma32(log_d, static_cast<float>(md.exps[k]),
                                         static_cast<float>(md.log_c[k]))));
  float pe = fminf(fmaxf(ftz(__fmul_rn(acc, md.b)), 0.0f), 1.0f);
  pe = fminf(pe, static_cast<float>(1.0 - 1e-12));
  return xla_log1p(-pe);
}

// whether the coin decodes a frame of fb bytes from a transmitter in mode m:
// coin < psr, the success rate exp(bits * lg), over f64 registers, or
// where that chain leaves r24's range over the f32 chain
template <bool PROF, bool TABLE>
__device__ __forceinline__ bool decodes(const Args& a, const ModeRow* rows,
                                        int m, float fb, float sinr,
                                        float rx_w, float den, float coin,
                                        Clock<PROF>& clk) {
  F32d f;
  const float bits = __fmul_rn(fb, TABLE ? a.table_scale : 8.0f);
  double lg;
  if constexpr (TABLE)
    lg = table_lg(f, a, m, sinr, clk);
  else
    lg = nist_lg(f, rows[m], sinr, rx_w, den, clk);
  double psr = exp_d(f, f.mul(bits, lg));
  if (!f.ok)
    psr = xla_math::xla_exp(
        __fmul_rn(bits, lg_f32(a, rows[m], m, sinr, rx_w, den)));
  clk.mark(S_EXP);
  return static_cast<double>(coin) < psr;
}

// ---------------------------------------------------------------------------
// the shared pieces of both kernels
// ---------------------------------------------------------------------------

// the block of the column sum that row t falls in (kernels.py::sum_blocks)
__device__ __forceinline__ int sum_block(int t, int n) {
  return n <= SUM_BLOCK
             ? 0
             : (t + ((n + SUM_BLOCK - 1) / SUM_BLOCK * SUM_BLOCK - n) / 2) /
                   SUM_BLOCK;
}

// the column sum of rx over the transmitter list txl[0 .. n_tx) (ascending)
// in the compiled block order: each block's terms from its first, then the
// blocks in order; idle rows, +0.0, dropped
template <class Col>
__device__ __forceinline__ float column_sum(const int* txl, int n_tx, int n,
                                            Col col) {
  float total = 0.0f, acc = 0.0f;
  int blk = n_tx > 0 ? sum_block(txl[0], n) : 0;
  for (int k = 0; k < n_tx; ++k) {
    const int t = txl[k];
    const int b = sum_block(t, n);
    if (b != blk) {
      total = __fadd_rn(total, acc);
      acc = 0.0f;
      blk = b;
    }
    acc = __fadd_rn(acc, col(t));
  }
  return __fadd_rn(total, acc);
}

__device__ __forceinline__ bool bit(const unsigned* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

__device__ __forceinline__ void load_modes(const Args& a, ModeRow* rows) {
  for (int m = threadIdx.x; m < N_MODES; m += blockDim.x) {
    const float* md = a.modes + m * MODE_COLS;
    ModeRow& r = rows[m];
    r.c = md[0];
    r.div = md[1];
    r.factor = md[2];
    r.b = md[3];
    for (int k = 0; k < N_TERMS; ++k) {
      r.log_c[k] = md[4 + k];
      r.exps[k] = md[4 + N_TERMS + k];
    }
    r.keep = a.keep[m];
    r.pad = 0;
  }
}

// a warp's stream of pairs that may decode: src(j, pair) says whether its
// lane's candidate of chunk j (0 .. chunks - 1; every lane asks with the
// same j) may decode, and a ballot appends those to the ring; f(pair) then
// runs on lane i with the i-th waiting pair, 32 at a time, and on the first
// lanes for what is left once the chunks run out (one call site, so that
// the error model's code is there once)
template <class Src, class F>
__device__ __forceinline__ void stream_pairs(int* ring, int chunks, Src src,
                                             F f) {
  const int lane = threadIdx.x & 31;
  int pushed = 0, done = 0, j = 0;
  for (;;) {
    while (pushed - done < 32 && j < chunks) {
      int pair = 0;
      const bool live = src(j++, pair);
      const unsigned m = __ballot_sync(FULL, live);
      if (live)
        ring[(pushed + __popc(m & ((1u << lane) - 1u))) & (RING - 1)] = pair;
      pushed += __popc(m);
    }
    const int avail = min(pushed - done, 32);
    if (avail == 0) break;
    __syncwarp();
    const int mine = ring[(done + lane) & (RING - 1)];
    __syncwarp();
    done += avail;
    if (lane < avail) f(mine);
  }
}

// the dynamic shared memory's layout: the mode rows, then the kernel's own
// arrays (each 16-byte aligned)
__device__ __host__ inline size_t up16(size_t x) { return (x + 15) & ~15ull; }

struct ScanLayout {
  size_t modes, prob, mode, fb, rxw, det, warp, warp_bytes, bytes;
  __device__ __host__ ScanLayout(int n, bool geom) {
    modes = 0;
    prob = up16(sizeof(ModeRow) * N_MODES);
    mode = prob + up16(4 * n);
    fb = mode + up16(4 * n);
    rxw = fb + up16(4 * n);
    det = rxw + (geom ? up16(4ull * n * n) : 0);
    warp = det + (geom ? up16(1ull * n * n) : 0);
    // a warp's transmitter bits (32 words), list, column sums and ring
    warp_bytes = up16(4 * 32) + up16(4 * n) + up16(4 * n) + up16(4 * RING);
    bytes = warp + WARPS * warp_bytes;
  }
};

struct WindowLayout {
  size_t modes, mode, fb, bits, count, txl, tot, ring, rxw, det, bytes;
  __device__ __host__ WindowLayout(int n, bool geom) {
    modes = 0;
    mode = up16(sizeof(ModeRow) * N_MODES);
    fb = mode + up16(4 * n);
    bits = fb + up16(4 * n);
    count = bits + up16(4 * 32);
    txl = count + 16;
    tot = txl + up16(4 * n);
    ring = tot + up16(4 * n);
    rxw = ring + up16(4 * RING * WARPS);
    det = rxw + (geom ? up16(4ull * n * n) : 0);
    bytes = det + (geom ? up16(1ull * n * n) : 0);
  }
};

// whether N's geometry sits in shared memory
__device__ __host__ inline bool geom_in_smem(int n) {
  return 5ll * n * n <= GEOM_SMEM_MAX;
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// the link from p to q (ops/propagation.py's compiled arithmetic): its rx
// power in dBm and, unless a node to itself, in W (the scan's geometry)
__device__ __forceinline__ void link(const Args& a, const float* p,
                                     const float* q, bool self, float& dbm,
                                     float& w) {
  const float dx = __fsub_rn(p[0], q[0]), dy = __fsub_rn(p[1], q[1]),
              dz = __fsub_rn(p[2], q[2]);
  const float ss =
      xla_math::fma32(dz, dz, xla_math::fma32(dy, dy, __fmul_rn(dx, dx)));
  const float loss = xla_math::fma32(
      xla_math::xla_log(fmaxf(__fsqrt_rn(ss), 1.0f)), a.k_loss, a.ref_loss);
  dbm = __fsub_rn(a.tx_dbm, loss);
  w = self ? 0.0f
           : xla_math::xla_exp10(__fmul_rn(__fsub_rn(a.tx30, loss), 0.1f));
}

// the same link over f64 registers (the window's): rx power in dBm, and in
// W where want_w (a transmitter to another node), else 0; where the chain
// leaves r24's range, the f32 link above
__device__ __forceinline__ void link_d(const Args& a, const float* p,
                                       const float* q, bool want_w,
                                       float& dbm, float& w) {
  const float dx = __fsub_rn(p[0], q[0]), dy = __fsub_rn(p[1], q[1]),
              dz = __fsub_rn(p[2], q[2]);
  F32d f;
  const float ss =
      static_cast<float>(f.fma(dz, dz, f.fma(dy, dy, __fmul_rn(dx, dx))));
  float loss = static_cast<float>(
      f.fma(log_d(f, fmaxf(__fsqrt_rn(ss), 1.0f)), a.k_loss, a.ref_loss));
  if (!f.ok) {
    link(a, p, q, !want_w, dbm, w);
    return;
  }
  dbm = __fsub_rn(a.tx_dbm, loss);
  w = want_w ? xla_math::xla_exp10(__fmul_rn(__fsub_rn(a.tx30, loss), 0.1f))
             : 0.0f;
}

// the window of replica blockIdx.x: its transmitters (a list), each pair's
// link once (rx_dbm out, rx_w and det kept), the column sums over the list,
// the pairs that may decode streamed through each warp's ring (a warp a
// transmitter of the list at a time), then every pair's sinr and the ok of
// the rest
template <bool PROF, bool TABLE>
__global__ void __launch_bounds__(THREADS)
    window_kernel(const Args a) {
  const int r = blockIdx.x, n = a.N, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool geom = a.geom_smem != 0;
  const WindowLayout L(n, geom);
  ModeRow* rows = reinterpret_cast<ModeRow*>(dyn_smem + L.modes);
  int* mode_s = reinterpret_cast<int*>(dyn_smem + L.mode);
  float* fb_s = reinterpret_cast<float*>(dyn_smem + L.fb);
  unsigned* bits = reinterpret_cast<unsigned*>(dyn_smem + L.bits);
  int* txl = reinterpret_cast<int*>(dyn_smem + L.txl);
  float* tot = reinterpret_cast<float*>(dyn_smem + L.tot);
  int* n_tx = reinterpret_cast<int*>(dyn_smem + L.count);
  const size_t base = static_cast<size_t>(r) * n * n;
  // the geometry: in shared memory, or the CTA's own output slabs
  float* rxw = geom ? reinterpret_cast<float*>(dyn_smem + L.rxw)
                    : a.sinr + base;
  uint8_t* det = geom ? dyn_smem + L.det : nullptr;
  Clock<PROF> clk;
  clk.start();

  load_modes(a, rows);
  for (int i = tid; i < n; i += THREADS) {
    mode_s[i] = a.mode[static_cast<size_t>(r) * n + i];
    fb_s[i] = a.fb[static_cast<size_t>(r) * n + i];
  }
  for (int j = warp; j * 32 < n; j += WARPS) {
    const int i = j * 32 + lane;
    const unsigned m = __ballot_sync(
        FULL, i < n && a.tx[static_cast<size_t>(r) * n + i] != 0);
    if (lane == 0) bits[j] = m;
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int j = 0; j * 32 < n; ++j) {
      const unsigned m = bits[j];
      if ((m >> lane) & 1u)
        txl[count + __popc(m & ((1u << lane) - 1u))] = j * 32 + lane;
      count += __popc(m);
    }
    if (lane == 0) *n_tx = count;
  }
  const uint32_t k0 = static_cast<uint32_t>(a.keys[2 * r]);
  const uint32_t k1 = static_cast<uint32_t>(a.keys[2 * r + 1]);
  const float* pos = a.pos + static_cast<size_t>(r) * n * 3;
  clk.mark(S_SETUP);

  // each pair's link, once
  clk.start();
  for (int p = tid; p < n * n; p += THREADS) {
    const int t = p / n, rx = p - t * n;
    float dbm, w;
    link_d(a, pos + 3 * t, pos + 3 * rx, t != rx && bit(bits, t), dbm, w);
    a.rx_dbm[base + p] = dbm;
    rxw[p] = w;
    if (geom) det[p] = dbm >= a.sens ? 1 : 0;
  }
  clk.mark(S_LINK);
  __syncthreads();
  const int ntx = *n_tx;

  // the column sums over the transmitter list
  clk.start();
  for (int rx = tid; rx < n; rx += THREADS)
    tot[rx] = column_sum(txl, ntx, n, [&](int t) { return rxw[t * n + rx]; });
  clk.mark(S_SUMS);
  __syncthreads();

  // the pairs that may decode: a warp a transmitter at a time
  const int rows_of_warp = ntx > warp ? (ntx - warp + WARPS - 1) / WARPS : 0;
  const int per_row = (n + 31) / 32;
  clk.start();
  stream_pairs(
      reinterpret_cast<int*>(dyn_smem + L.ring) + warp * RING,
      rows_of_warp * per_row,
      [&](int j, int& pair) {
        const int t = txl[warp + (j / per_row) * WARPS];
        const int rx = (j % per_row) * 32 + lane;
        pair = (t << 16) | rx;
        if (rx >= n || bit(bits, rx)) return false;
        const int p = t * n + rx;
        return geom ? det[p] != 0 : a.rx_dbm[base + p] >= a.sens;
      },
      [&](int pair) {
        const int t = pair >> 16, rx = pair & 0xFFFF, p = t * n + rx;
        const float w = rxw[p];
        const float den = __fadd_rn(__fsub_rn(tot[rx], w), a.noise);
        const float sinr = __fdiv_rn(w, den);
        clk.mark(S_LINK);
        const bool ok = decodes<PROF, TABLE>(
            a, rows, mode_s[t], fb_s[t], sinr, w, den,
            threefry::uniform(k0, k1, static_cast<uint32_t>(p)), clk);
        a.ok[base + p] = ok ? 1 : 0;
        clk.mark(S_COIN);
      });
  __syncthreads();

  // every pair's sinr, and the ok of the pairs that may not decode
  clk.start();
  for (int p = tid; p < n * n; p += THREADS) {
    const int t = p / n, rx = p - t * n;
    const bool on = bit(bits, t);
    const float w = on ? rxw[p] : 0.0f;
    const float den = __fadd_rn(__fsub_rn(tot[rx], w), a.noise);
    const float sinr = __fdiv_rn(w, den);
    const bool live =
        on && !bit(bits, rx) &&
        (geom ? det[p] != 0 : a.rx_dbm[base + p] >= a.sens);
    if (!live) a.ok[base + p] = 0;
    a.sinr[base + p] = sinr;
  }
  clk.mark(S_OUT);
  clk.flush(a.prof);
}

// the scan's shared geometry: each pair's rx power in W (0 on the
// diagonal) and whether it clears the sensitivity
__global__ void geometry_kernel(const Args a) {
  const int n = a.N;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n * n;
       p += gridDim.x * blockDim.x) {
    const int tx = p / n, rx = p % n;
    float dbm, w;
    link(a, a.pos + 3 * tx, a.pos + 3 * rx, tx == rx, dbm, w);
    a.rx_w[p] = w;
    a.det[p] = dbm >= a.sens ? 1 : 0;
  }
}

// the scan: warp g of the grid takes the (window, replica) items g *
// SCAN_ITEMS .. + SCAN_ITEMS - 1, replica-major (item i is window i % W of
// replica i / W).  Window w's keys are split(fold_in(key, w)), its
// transmitters uniform(k_tx, (N,)) < prob, its coins uniform(k_phy, (N, N))
template <bool PROF>
__global__ void __launch_bounds__(THREADS) scan_kernel(const Args a) {
  const int n = a.N, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool geom = a.geom_smem != 0;
  const ScanLayout L(n, geom);
  ModeRow* rows = reinterpret_cast<ModeRow*>(dyn_smem + L.modes);
  float* prob = reinterpret_cast<float*>(dyn_smem + L.prob);
  int* mode_s = reinterpret_cast<int*>(dyn_smem + L.mode);
  float* fb_s = reinterpret_cast<float*>(dyn_smem + L.fb);
  const float* rxw = geom ? reinterpret_cast<float*>(dyn_smem + L.rxw)
                          : a.rx_w;
  const uint8_t* det = geom ? dyn_smem + L.det : a.det;
  unsigned char* mine = dyn_smem + L.warp + warp * L.warp_bytes;
  unsigned* bits = reinterpret_cast<unsigned*>(mine);
  int* txl = reinterpret_cast<int*>(mine + up16(4 * 32));
  float* tot = reinterpret_cast<float*>(mine + up16(4 * 32) + up16(4 * n));
  int* ring = reinterpret_cast<int*>(mine + up16(4 * 32) + 2 * up16(4 * n));
  Clock<PROF> clk;
  clk.start();

  load_modes(a, rows);
  for (int i = tid; i < n; i += THREADS) {
    prob[i] = a.prob[i];
    mode_s[i] = a.mode[i];
    fb_s[i] = a.fb[i];
  }
  if (geom) {
    float* rw = reinterpret_cast<float*>(dyn_smem + L.rxw);
    uint8_t* dt = dyn_smem + L.det;
    for (int p = tid; p < n * n; p += THREADS) {
      rw[p] = a.rx_w[p];
      dt[p] = a.det[p];
    }
  }
  clk.mark(S_SETUP);
  __syncthreads();

  const long long items = static_cast<long long>(a.R) * a.W;
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * WARPS + warp) * SCAN_ITEMS;
  const long long i1 = i0 + SCAN_ITEMS < items ? i0 + SCAN_ITEMS : items;
  int cur = -1, count = 0;
  for (long long i = i0; i < i1; ++i) {
    clk.start();
    const int r = static_cast<int>(i / a.W);
    const int w = static_cast<int>(i - static_cast<long long>(r) * a.W);
    if (r != cur) {
      const int c = __reduce_add_sync(FULL, count);
      if (cur >= 0 && lane == 0 && c) atomicAdd(&a.delivered[cur], c);
      cur = r;
      count = 0;
    }
    uint32_t k0 = static_cast<uint32_t>(a.keys[2 * r]);
    uint32_t k1 = static_cast<uint32_t>(a.keys[2 * r + 1]);
    threefry::fold_in(k0, k1, static_cast<uint32_t>(w));
    uint32_t t0 = k0, t1 = k1, c0 = k0, c1 = k1;
    threefry::fold_in(t0, t1, 0u);
    threefry::fold_in(c0, c1, 1u);
    // the transmitters, by ballots, into the list
    int ntx = 0;
    for (int j = 0; j * 32 < n; ++j) {
      const int x = j * 32 + lane;
      const bool on =
          x < n && threefry::uniform(t0, t1, static_cast<uint32_t>(x)) <
                       prob[x];
      const unsigned m = __ballot_sync(FULL, on);
      if (lane == 0) bits[j] = m;
      if (on) txl[ntx + __popc(m & ((1u << lane) - 1u))] = x;
      ntx += __popc(m);
    }
    __syncwarp();
    clk.mark(S_SETUP);
    // the receivers' column sums over the list
    for (int rx = lane; rx < n; rx += 32)
      if (!bit(bits, rx))
        tot[rx] = column_sum(txl, ntx, n,
                             [&](int t) { return rxw[t * n + rx]; });
    __syncwarp();
    clk.mark(S_SUMS);
    // the pairs that may decode, 32 at a time
    const int per_row = (n + 31) / 32;
    stream_pairs(
        ring, ntx * per_row,
        [&](int j, int& pair) {
          const int t = txl[j / per_row];
          const int rx = (j % per_row) * 32 + lane;
          pair = (t << 16) | rx;
          return rx < n && !bit(bits, rx) && det[t * n + rx] != 0;
        },
        [&](int pair) {
          const int t = pair >> 16, rx = pair & 0xFFFF, p = t * n + rx;
          const float v = rxw[p];
          const float den = __fadd_rn(__fsub_rn(tot[rx], v), a.noise);
          const float sinr = __fdiv_rn(v, den);
          clk.mark(S_LINK);
          count += decodes<PROF, false>(
              a, rows, mode_s[t], fb_s[t], sinr, v, den,
              threefry::uniform(c0, c1, static_cast<uint32_t>(p)), clk);
          clk.mark(S_COIN);
        });
  }
  clk.start();
  count = __reduce_add_sync(FULL, count);
  if (cur >= 0 && lane == 0 && count) atomicAdd(&a.delivered[cur], count);
  clk.mark(S_OUT);
  clk.flush(a.prof);
}

// the fma routine's check: got[i] F32d's multiply-add of a[i], b[i], c[i]
// (xla_math::fma32 where it leaves r24's range) and want[i]
// xla_math::fma32's, both as f32
__global__ void fma_check_kernel(const float* a, const float* b,
                                 const float* c, float* got, float* want,
                                 long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    F32d f;
    const double y = f.fma(a[i], b[i], c[i]);
    want[i] = xla_math::fma32(a[i], b[i], c[i]);
    got[i] = f.ok ? static_cast<float>(y) : want[i];
  }
}

// the chains' check: got[i] exp_d, log_d, log1p_d or erfc_d (which 0 .. 3)
// of x[i] over f64 registers, want[i] xla_math.cuh's f32 function, and
// in_range[i] whether the f64 chain stayed in r24's range (where it did
// not, the kernels take the f32 function)
__global__ void chain_check_kernel(const float* x, float* got, float* want,
                                   uint8_t* in_range, long long n,
                                   int which) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    F32d f;
    const float v = x[i];
    double y;
    float w;
    if (which == 0) {
      y = exp_d(f, v);
      w = xla_math::xla_exp(v);
    } else if (which == 1) {
      y = log_d(f, v);
      w = xla_math::xla_log(v);
    } else if (which == 2) {
      y = log1p_d(f, v);
      w = xla_math::xla_log1p(v);
    } else {
      y = erfc_d(f, v);
      w = xla_math::xla_erfc(v);
    }
    got[i] = static_cast<float>(y);
    want[i] = w;
    in_range[i] = f.ok ? 1 : 0;
  }
}

template <class K>
int launch(K kernel, const Args& a, int blocks, size_t smem,
           cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  void* args[] = {const_cast<Args*>(&a)};
  const cudaError_t e = cudaLaunchKernel(kernel, dim3(blocks), dim3(THREADS),
                                         args, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const int* mode, const float* fb, const long long* keys,
               const float* modes, const int* keep, int R, int N,
               float tx_dbm, float tx30, float k_loss, float ref_loss,
               float sens, float noise) {
  Args a{};
  a.mode = mode;
  a.fb = fb;
  a.keys = keys;
  a.modes = modes;
  a.keep = keep;
  a.R = R;
  a.N = N;
  a.tx_dbm = tx_dbm;
  a.tx30 = tx30;
  a.k_loss = k_loss;
  a.ref_loss = ref_loss;
  a.sens = sens;
  a.noise = noise;
  return a;
}

}  // namespace win_kernel

// The window: pos (R, N, 3) f32, tx (R, N) bool, mode (R, N) int32, fb (R,
// N) f32, keys (R, 2) int64, the per-mode table (20, MODE_COLS) f32 and its
// term masks (20,) int32, the f32 PER table (20, 91) (used when table != 0);
// writes ok (R, N, N) bool, sinr and rx_dbm (R, N, N) f32.  floats: tx_dbm,
// tx - 30, the loss's slope and intercept, the sensitivity, the noise, the
// table's dB factor and its size scale (8 / ref_bits).
#define WIN_LAUNCH_PARAMS                                                    \
  const float *pos, const uint8_t *tx, const int *mode, const float *fb,     \
      const long long *keys, const float *modes, const int *keep,            \
      const float *per, uint8_t *ok, float *sinr, float *rx_dbm, int R,      \
      int N, int table, float tx_dbm, float tx30, float k_loss,              \
      float ref_loss, float sens, float noise, float db_per_ln,              \
      float table_scale
#define WIN_LAUNCH_ARGS                                                      \
  pos, tx, mode, fb, keys, modes, keep, per, ok, sinr, rx_dbm, R, N, table,  \
      tx_dbm, tx30, k_loss, ref_loss, sens, noise, db_per_ln, table_scale

namespace win_kernel {

template <bool PROF>
int window_entry(WIN_LAUNCH_PARAMS, long long* prof, cudaStream_t st) {
  if (R <= 0 || N <= 0 || N > WIN_MAX_NODES || (table && per == nullptr) ||
      static_cast<long long>(R) * N * N >= (1LL << 31) ||
      (PROF && prof == nullptr))
    return cudaErrorInvalidValue;
  Args a = make_args(mode, fb, keys, modes, keep, R, N, tx_dbm, tx30,
                     k_loss, ref_loss, sens, noise);
  a.pos = pos;
  a.tx = tx;
  a.per = per;
  a.ok = ok;
  a.sinr = sinr;
  a.rx_dbm = rx_dbm;
  a.table = table;
  a.db_per_ln = db_per_ln;
  a.table_scale = table_scale;
  a.prof = prof;
  a.geom_smem = geom_in_smem(N);
  const size_t smem = WindowLayout(N, a.geom_smem != 0).bytes;
  return table ? launch(window_kernel<PROF, true>, a, R, smem, st)
               : launch(window_kernel<PROF, false>, a, R, smem, st);
}

template <bool PROF>
int scan_entry(const float* prob, const int* mode, const float* fb,
               const long long* keys, const float* modes, const int* keep,
               float* rx_w, uint8_t* det, int* delivered, int R, int N, int W,
               float noise, long long* prof, cudaStream_t st) {
  if (R <= 0 || N <= 0 || N > WIN_MAX_NODES || W <= 0 ||
      static_cast<long long>(W) * R >= (1LL << 31) ||
      (PROF && prof == nullptr))
    return cudaErrorInvalidValue;
  Args a = make_args(mode, fb, keys, modes, keep, R, N, 0.0f, 0.0f, 0.0f,
                     0.0f, 0.0f, noise);
  a.prob = prob;
  a.rx_w = rx_w;
  a.det = det;
  a.delivered = delivered;
  a.W = W;
  a.prof = prof;
  a.geom_smem = geom_in_smem(N);
  const long long per_block = static_cast<long long>(WARPS) * SCAN_ITEMS;
  const int blocks = static_cast<int>(
      (static_cast<long long>(W) * R + per_block - 1) / per_block);
  return launch(scan_kernel<PROF>, a, blocks,
                ScanLayout(N, a.geom_smem != 0).bytes, st);
}

}  // namespace win_kernel

extern "C" int wifi_window_launch(WIN_LAUNCH_PARAMS, void* stream) {
  return win_kernel::window_entry<false>(WIN_LAUNCH_ARGS, nullptr,
                                         static_cast<cudaStream_t>(stream));
}

// the stage probe: the same launch by the PROF instantiation, adding each
// warp's cycles in each stage to prof (N_STAGES,) int64 (zeroed by the
// caller)
extern "C" int wifi_window_profile(WIN_LAUNCH_PARAMS, long long* prof,
                                   void* stream) {
  return win_kernel::window_entry<true>(WIN_LAUNCH_ARGS, prof,
                                        static_cast<cudaStream_t>(stream));
}

// The scan's geometry: pos (N, 3) f32; writes rx_w (N, N) f32 and det (N,
// N) bool.  floats as the window's first six.
extern "C" int wifi_geometry_launch(const float* pos, float* rx_w,
                                    uint8_t* det, int N, float tx_dbm,
                                    float tx30, float k_loss, float ref_loss,
                                    float sens, float noise, void* stream) {
  using namespace win_kernel;
  if (N <= 0 || N > WIN_MAX_NODES) return cudaErrorInvalidValue;
  Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr, 1, N,
                     tx_dbm, tx30, k_loss, ref_loss, sens, noise);
  a.pos = pos;
  a.rx_w = rx_w;
  a.det = det;
  const int cover = (N * N + 255) / 256;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchKernel(
      geometry_kernel, dim3(cover < 132 ? cover : 132), dim3(256), args, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The scan: windows 0 .. W - 1 (W >= 1) of R replicas over the shared
// prob, mode and fb (N,) and the geometry rx_w (N, N) f32 and det (N, N)
// bool that wifi_geometry_launch wrote, NIST; keys (R, 2) int64; adds each
// replica's decoded frames to delivered (R,) int32 (zeroed by the caller).
// noise: the window's noise in W.
extern "C" int wifi_scan_launch(const float* prob, const int* mode,
                                const float* fb, const long long* keys,
                                const float* modes, const int* keep,
                                float* rx_w, uint8_t* det, int* delivered,
                                int R, int N, int W, float noise,
                                void* stream) {
  return win_kernel::scan_entry<false>(prob, mode, fb, keys, modes, keep,
                                       rx_w, det, delivered, R, N, W, noise,
                                       nullptr,
                                       static_cast<cudaStream_t>(stream));
}

// the scan's stage probe, as wifi_window_profile
extern "C" int wifi_scan_profile(const float* prob, const int* mode,
                                 const float* fb, const long long* keys,
                                 const float* modes, const int* keep,
                                 float* rx_w, uint8_t* det, int* delivered,
                                 int R, int N, int W, float noise,
                                 long long* prof, void* stream) {
  return win_kernel::scan_entry<true>(prob, mode, fb, keys, modes, keep,
                                      rx_w, det, delivered, R, N, W, noise,
                                      prof,
                                      static_cast<cudaStream_t>(stream));
}

// The fma routine's check on n triples a, b, c (n,) f32: got the kernel's
// multiply-add over f64 registers, want xla_math::fma32's, (n,) f32.
extern "C" int wifi_fma_check(const float* a, const float* b, const float* c,
                              float* got, float* want, long long n,
                              void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
#ifdef TPUDES_CUDA_MOCK
  constexpr long long most = 4;  // the mock runs a thread per CUDA thread
#else
  constexpr long long most = 4096;
#endif
  const long long cover = (n + 255) / 256;
  void* args[] = {&a, &b, &c, &got, &want, &n};
  const cudaError_t e = cudaLaunchKernel(
      win_kernel::fma_check_kernel,
      dim3(static_cast<unsigned>(cover < most ? cover : most)), dim3(256),
      args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The chains' check on n values x (n,) f32: got and want (n,) f32,
// in_range (n,) bool; which: 0 exp, 1 log, 2 log1p, 3 erfc.
extern "C" int wifi_chain_check(const float* x, float* got, float* want,
                                uint8_t* in_range, long long n, int which,
                                void* stream) {
  if (n <= 0 || which < 0 || which > 3) return cudaErrorInvalidValue;
#ifdef TPUDES_CUDA_MOCK
  constexpr long long most = 4;  // the mock runs a thread per CUDA thread
#else
  constexpr long long most = 4096;
#endif
  const long long cover = (n + 255) / 256;
  void* args[] = {&x, &got, &want, &in_range, &n, &which};
  const cudaError_t e = cudaLaunchKernel(
      win_kernel::chain_check_kernel,
      dim3(static_cast<unsigned>(cover < most ? cover : most)), dim3(256),
      args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
