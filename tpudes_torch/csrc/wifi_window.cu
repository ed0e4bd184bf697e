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
// - the window (wifi_window_launch): one CTA a replica, (R, N) inputs and
//   (R, 2) keys, writing ok, sinr and rx_dbm (R, N, N), NIST or table;
// - the scan's geometry (wifi_geometry_launch): the shared positions' rx
//   power in W (0 on the diagonal) and detectability, N x N;
// - the scan (wifi_scan_launch), over that geometry: one CTA a (window,
//   replica) draws the window's N tx coins, sums the columns and decodes
//   its pairs, adding its count of decoded frames to delivered[r] with an
//   integer atomic (exact in any order).
//
// Bound.  Every pair is independent given the window's transmitters and
// column sums, so the work is R x W x N^2 pair evaluations: the kernel is
// bound by arithmetic (chip_smoke.py::window_bound counts it), not bytes
// (a window reads N positions and writes one count).  A pair that cannot
// decode (its transmitter idle, its receiver transmitting, the diagonal, or
// below the sensitivity) skips the error model and its coin, which is most
// of the cost; pairs are laid out tx-major so a warp's 32 pairs mostly
// share a transmitter and take the same branch.  The column sum
// total_w[rx] = sum over tx of rx_w[tx, rx] is one thread a column, in the
// reference's order: from the first row up to 32 rows, else in blocks of
// 32 rows (the rows padded to a multiple of 32, half the pad in front),
// each block from its first row, then the blocks in order (the CPU
// backend's reduce-window then reduce; kernels.py::sum_blocks).
//
// Arithmetic.  Every f32 product, sum and quotient is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, which nvcc cannot
// contract); a multiply-add the reference's compiled window fuses is fma32,
// log, exp, log1p, erfc and 10 ** x are xla_math.cuh's.  The per-mode
// numbers (the QAM factor and divisor, the union bound's logs) arrive from
// the wrapper as the plain version computes them
// (ops/wifi_error.py::mode_table).  Build without --use_fast_math.
//
// The source also builds with g++ against csrc/mock/cuda_runtime.h, which
// runs it on the CPU (tests/test_torch_phy_window.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "xla_math.cuh"

namespace win_kernel {

// the most nodes a window holds (kernels.py::MAX_NODES): one thread a
// column, and the column sum's two levels of 32-row blocks
constexpr int WIN_MAX_NODES = 1024;
constexpr int SUM_BLOCK = 32;
constexpr int N_MODES = 20;
constexpr int N_TERMS = 10;
// a mode's row of the per-mode table: constellation, div, factor, b, then
// the ten log_c and the ten exps (window_cuda.py::MODE_COLUMNS)
constexpr int MODE_COLS = 4 + 2 * N_TERMS;
constexpr int TABLE_POINTS = 91;
constexpr unsigned FULL = 0xFFFFFFFFu;

// the window's transmitters (1 or 0) and column sums, and the CTA's count
__shared__ float win_txf[WIN_MAX_NODES];
__shared__ float win_total[WIN_MAX_NODES];
__shared__ int win_count;

struct Args {
  const float* pos;        // (R, N, 3) window; (N, 3) scan
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
  int R, N, W, table;
  float tx_dbm, tx30, k_loss, ref_loss, sens, noise, db_per_ln, table_scale;
};

// the link from a to b (ops/propagation.py's compiled arithmetic): its rx
// power in dBm and, unless a node to itself, in W
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

// the compiled column sum over n rows of col(i) (kernels.py::sum_blocks)
template <class Col>
__device__ __forceinline__ float column_sum(int n, Col col) {
  if (n <= SUM_BLOCK) {
    float acc = col(0);
    for (int i = 1; i < n; ++i) acc = __fadd_rn(acc, col(i));
    return acc;
  }
  const int nb = (n + SUM_BLOCK - 1) / SUM_BLOCK;
  const int low = (nb * SUM_BLOCK - n) / 2;
  float total = 0.0f;
  for (int j = 0; j < nb; ++j) {
    const int lo = max(0, j * SUM_BLOCK - low);
    const int hi = min(n, (j + 1) * SUM_BLOCK - low);
    float acc = col(lo);
    for (int i = lo + 1; i < hi; ++i) acc = __fadd_rn(acc, col(i));
    total = j == 0 ? acc : __fadd_rn(total, acc);
  }
  return total;
}

// log1p(-pe) of the NIST model with the transmitter's mode resolved per
// element (ops/wifi_error.py::log1p_neg_pe_at): the BPSK, QPSK or QAM
// branch of the mode's constellation, the QAM argument sqrt(rx_w / (den
// div)) as the compiled window divides once
__device__ __forceinline__ float nist_lg_at(const Args& a, int m, float sinr,
                                            float rx_w, float den) {
  const float* md = a.modes + m * MODE_COLS;
  const float c = md[0];
  float ber;
  if (c <= 2.0f) {
    ber = xla_math::ftz(
        __fmul_rn(xla_math::xla_erfc(__fsqrt_rn(sinr)), 0.5f));
  } else if (c <= 4.0f) {
    ber = xla_math::ftz(__fmul_rn(
        xla_math::xla_erfc(__fsqrt_rn(__fmul_rn(sinr, 0.5f))), 0.5f));
  } else {
    const float z = __fsqrt_rn(__fdiv_rn(rx_w, __fmul_rn(den, md[1])));
    ber = xla_math::ftz(__fmul_rn(md[2], xla_math::xla_erfc(z)));
  }
  const float pc = fminf(fmaxf(ber, 0.0f), 0.5f);
  const float d =
      __fsqrt_rn(__fmul_rn(__fmul_rn(pc, 4.0f), __fsub_rn(1.0f, pc)));
  const float log_d =
      xla_math::xla_log(fmaxf(d, static_cast<float>(1e-35)));
  const int keep = a.keep[m];
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < N_TERMS; ++k)
    if ((keep >> k) & 1)
      acc = __fadd_rn(acc, xla_math::xla_exp(xla_math::fma32(
                               log_d, md[4 + N_TERMS + k], md[4 + k])));
  float pe = fminf(fmaxf(xla_math::ftz(__fmul_rn(acc, md[3])), 0.0f), 1.0f);
  pe = fminf(pe, static_cast<float>(1.0 - 1e-12));
  return xla_math::xla_log1p(-pe);
}

// log1p(-per_ref) of the table model (ops/wifi_error.py::table_lg)
__device__ __forceinline__ float table_lg_at(const Args& a, int m,
                                             float sinr) {
  const float lg = xla_math::xla_log(fmaxf(sinr, static_cast<float>(1e-30)));
  float x = __fmul_rn(xla_math::fma32(lg, a.db_per_ln, 5.0f), 2.0f);
  x = fminf(fmaxf(x, 0.0f), static_cast<float>(TABLE_POINTS - 1));
  const int lo = min(max(__float2int_rz(x), 0), TABLE_POINTS - 2);
  const float frac = __fsub_rn(x, static_cast<float>(lo));
  const float* row = a.per + m * TABLE_POINTS;
  float per = xla_math::fma32(row[lo + 1], frac,
                              __fmul_rn(row[lo], __fsub_rn(1.0f, frac)));
  per = fminf(per, static_cast<float>(1.0 - 1e-7));
  return xla_math::xla_log1p(-per);
}

// the success rate of a frame of fb bytes from a transmitter in mode m
__device__ __forceinline__ float psr_at(const Args& a, int m, float fb,
                                        float sinr, float rx_w, float den) {
  if (a.table)
    return xla_math::xla_exp(
        __fmul_rn(__fmul_rn(fb, a.table_scale), table_lg_at(a, m, sinr)));
  return xla_math::xla_exp(
      __fmul_rn(__fmul_rn(fb, 8.0f), nist_lg_at(a, m, sinr, rx_w, den)));
}

// the window of replica blockIdx.x: the transmitters, the column sums, then
// each (tx, rx) pair's rx power, SINR and decode
__global__ void window_kernel(const Args a) {
  const int r = blockIdx.x, n = a.N;
  const float* pos = a.pos + static_cast<size_t>(r) * n * 3;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    win_txf[i] = a.tx[static_cast<size_t>(r) * n + i] ? 1.0f : 0.0f;
  __syncthreads();
  for (int rx = threadIdx.x; rx < n; rx += blockDim.x)
    win_total[rx] = column_sum(n, [&](int tx) {
      if (win_txf[tx] == 0.0f) return 0.0f;
      float dbm, w;
      link(a, pos + 3 * tx, pos + 3 * rx, tx == rx, dbm, w);
      return w;
    });
  __syncthreads();
  const uint32_t k0 = static_cast<uint32_t>(a.keys[2 * r]);
  const uint32_t k1 = static_cast<uint32_t>(a.keys[2 * r + 1]);
  const size_t base = static_cast<size_t>(r) * n * n;
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
    const int tx = p / n, rx = p % n;
    float dbm, w0;
    link(a, pos + 3 * tx, pos + 3 * rx, tx == rx, dbm, w0);
    const float txf = win_txf[tx];
    const float rx_w = __fmul_rn(w0, txf);
    const float den = __fadd_rn(__fsub_rn(win_total[rx], rx_w), a.noise);
    const float sinr = __fdiv_rn(rx_w, den);
    bool ok = false;
    if (txf > 0.0f && __fsub_rn(1.0f, win_txf[rx]) > 0.0f && tx != rx &&
        dbm >= a.sens) {
      const int i = static_cast<int>(static_cast<size_t>(r) * n) + tx;
      const float psr = psr_at(a, a.mode[i], a.fb[i], sinr, rx_w, den);
      ok = threefry::uniform(k0, k1, static_cast<uint32_t>(p)) < psr;
    }
    a.ok[base + p] = ok ? 1 : 0;
    a.sinr[base + p] = sinr;
    a.rx_dbm[base + p] = dbm;
  }
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

// window blockIdx.x / R of replica blockIdx.x % R: window i's keys
// are split(fold_in(key, i)), its transmitters uniform(k_tx, (N,)) < prob,
// its coins uniform(k_phy, (N, N)); its decoded frames join delivered[r]
__global__ void scan_kernel(const Args a) {
  const int r = blockIdx.x % a.R, w = blockIdx.x / a.R, n = a.N;
  uint32_t k0 = static_cast<uint32_t>(a.keys[2 * r]);
  uint32_t k1 = static_cast<uint32_t>(a.keys[2 * r + 1]);
  threefry::fold_in(k0, k1, static_cast<uint32_t>(w));
  uint32_t t0 = k0, t1 = k1, c0 = k0, c1 = k1;
  threefry::fold_in(t0, t1, 0u);
  threefry::fold_in(c0, c1, 1u);
  if (threadIdx.x == 0) win_count = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    win_txf[i] = threefry::uniform(t0, t1, static_cast<uint32_t>(i)) <
                         a.prob[i]
                     ? 1.0f
                     : 0.0f;
  __syncthreads();
  for (int rx = threadIdx.x; rx < n; rx += blockDim.x)
    win_total[rx] = column_sum(n, [&](int tx) {
      return __fmul_rn(a.rx_w[tx * n + rx], win_txf[tx]);
    });
  __syncthreads();
  int count = 0;
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
    const int tx = p / n, rx = p % n;
    if (win_txf[tx] > 0.0f && __fsub_rn(1.0f, win_txf[rx]) > 0.0f &&
        tx != rx && a.det[p]) {
      const float rx_w = __fmul_rn(a.rx_w[p], win_txf[tx]);
      const float den = __fadd_rn(__fsub_rn(win_total[rx], rx_w), a.noise);
      const float sinr = __fdiv_rn(rx_w, den);
      const float psr = psr_at(a, a.mode[tx], a.fb[tx], sinr, rx_w, den);
      count += threefry::uniform(c0, c1, static_cast<uint32_t>(p)) < psr;
    }
  }
  count = __reduce_add_sync(FULL, count);
  if ((threadIdx.x & 31) == 0 && count) atomicAdd(&win_count, count);
  __syncthreads();
  if (threadIdx.x == 0 && win_count) atomicAdd(&a.delivered[r], win_count);
}

// the launch's threads: one a column, whole warps, at least two warps
inline int threads_for(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < 64 ? 64 : t;
}

int launch(void (*kernel)(Args), const Args& a, int blocks, int threads,
           cudaStream_t st) {
  void* args[] = {const_cast<Args*>(&a)};
  const cudaError_t e =
      cudaLaunchKernel(kernel, dim3(blocks), dim3(threads), args, 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const float* pos, const int* mode, const float* fb,
               const long long* keys, const float* modes, const int* keep,
               int R, int N, float tx_dbm, float tx30, float k_loss,
               float ref_loss, float sens, float noise) {
  Args a{};
  a.pos = pos;
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
extern "C" int wifi_window_launch(
    const float* pos, const uint8_t* tx, const int* mode, const float* fb,
    const long long* keys, const float* modes, const int* keep,
    const float* per, uint8_t* ok, float* sinr, float* rx_dbm, int R, int N,
    int table, float tx_dbm, float tx30, float k_loss, float ref_loss,
    float sens, float noise, float db_per_ln, float table_scale,
    void* stream) {
  using namespace win_kernel;
  if (R <= 0 || N <= 0 || N > WIN_MAX_NODES || (table && per == nullptr) ||
      static_cast<long long>(R) * N * N >= (1LL << 31))
    return cudaErrorInvalidValue;
  Args a = make_args(pos, mode, fb, keys, modes, keep, R, N, tx_dbm, tx30,
                     k_loss, ref_loss, sens, noise);
  a.tx = tx;
  a.per = per;
  a.ok = ok;
  a.sinr = sinr;
  a.rx_dbm = rx_dbm;
  a.table = table;
  a.db_per_ln = db_per_ln;
  a.table_scale = table_scale;
  return launch(window_kernel, a, R, threads_for(N),
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
  Args a = make_args(pos, nullptr, nullptr, nullptr, nullptr, nullptr, 1, N,
                     tx_dbm, tx30, k_loss, ref_loss, sens, noise);
  a.rx_w = rx_w;
  a.det = det;
  const int cover = (N * N + 255) / 256;
  return launch(geometry_kernel, a, cover < 132 ? cover : 132, 256,
                static_cast<cudaStream_t>(stream));
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
  using namespace win_kernel;
  if (R <= 0 || N <= 0 || N > WIN_MAX_NODES || W <= 0 ||
      static_cast<long long>(W) * R >= (1LL << 31))
    return cudaErrorInvalidValue;
  Args a = make_args(nullptr, mode, fb, keys, modes, keep, R, N, 0.0f, 0.0f,
                     0.0f, 0.0f, 0.0f, noise);
  a.prob = prob;
  a.rx_w = rx_w;
  a.det = det;
  a.delivered = delivered;
  a.W = W;
  return launch(scan_kernel, a, W * R, threads_for(N),
                static_cast<cudaStream_t>(stream));
}
