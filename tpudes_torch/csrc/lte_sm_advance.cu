// lte_sm_advance.cu — TTIs [t0, t1) of the full-buffer LTE SM engine, every
// replica, in one launch, with the decode coins drawn inside.
//
// Replaces the same TPU kernel as lte_sm_step.cu — build_sm_step_fn
// (tpudes/parallel/kernels_pallas.py:396, pl.pallas_call at :473, body
// sm_step_math at :371) — together with the reference's device TTI loop
// around it (tpudes/parallel/lte_sm.py:741, a lax.while_loop) and its
// per-TTI coin draw (lte_sm.py:678, :423).
//
// Design, for the H100:
// - One CTA per replica.  Thread j holds the UEs at cell-sorted positions
//   j, j + B, ... (B = blockDim = U rounded up to 32, at most 512), i.e. UEs
//   cell_order[j + kB].  Their 13 state values and 8 constant rows live in
//   registers for the whole launch, the cells' RR pointers in shared memory:
//   state is read from HBM once and written once.
// - Coins: uniform(fold_in(key_r, t), (U,))[u], as tpudes_torch/random.py
//   draws it, in uint32 threefry2x32.  Every 32 TTIs lane l of each warp
//   folds TTI t + l into the replica's key; each TTI shuffles its key across
//   the warp and every thread hashes its own UE index.
// - Admission: UEs sorted stably by cell make each cell a contiguous range
//   in UE order, so a UE's same-cell prefix of requests is a difference of
//   one block-wide inclusive scan, scan(p) - scan(cell_start[e] - 1), exact
//   in int32.  Warps scan their 32 positions with shuffles and publish the
//   totals; after the barrier every warp scans the (at most 64) chunk totals
//   itself, so the scan costs one barrier.
// - Per-cell sums and winner: the lanes of one cell in one warp (found once
//   with __match_any_sync) reduce under their own mask with __reduce_*_sync;
//   the group's lowest lane adds the cell's admitted RBGs to a shared counter
//   and atomicMax-es the 64-bit key orderable(metric) << 32 | ~u: the highest
//   metric, then the lowest UE index among equals, as sm_dispatch picks
//   (-0.0 is made +0.0 first: the plain core's == treats them as equal).
//   One atomic per (warp, cell) group: a cell of 30 UEs takes one or two.
// - Two barriers per TTI.  The per-cell counters are double-buffered by TTI
//   parity, and the idle buffer is cleared between the two barriers.
//
// Arithmetic: lte_sm_common.cuh's, bit-identical on the card to the plain
// PyTorch loop sm_advance_math (tpudes_torch/parallel/kernels_cuda.py).
//
// Bound: at E=7, U=210, R=64 the state moves once each way (about 1.4 MB,
// 0.4 us at 3.35 TB/s), so over a horizon the bound is the work: about 80
// int32 operations per UE-TTI (the coin's threefry and the scan) over the
// card's int32 rate, 0.64 ms at 10,000 TTIs.  With 64 CTAs on 132 SMs the
// time is set by each TTI's chain of dependent steps (hash, scan, barrier,
// reductions and atomics, barrier, BLER), not by throughput.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lte_sm_common.cuh"

#define ADV_MAX_U 2048
#define ADV_MAX_E 256
#define ADV_MAX_THREADS 512
// the last TTI a launch may reach: t + 31 (a lane's fold-in) and t + 8
// (a retx due time) stay below 2^31
#define ADV_MAX_T 2147483000

namespace {

using namespace lte_sm;

constexpr unsigned kFull = 0xFFFFFFFFu;

// threefry2x32's rotation for round j of group i
__device__ __forceinline__ constexpr int rot(int i, int j) {
  return (i % 2 == 0) ? (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6)
                      : (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24);
}

// the 20-round Threefry-2x32 hash of counter (x0, x1) under key (k0, k1),
// in place (tpudes_torch/random.py::threefry2x32)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rot(i, j)) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// float bits in an order that unsigned comparison keeps; -0.0 maps as +0.0
__device__ __forceinline__ uint32_t orderable(float m) {
  const uint32_t b = __float_as_uint(__fadd_rn(m, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

template <int K>
__global__ void __launch_bounds__(ADV_MAX_THREADS)
    lte_sm_advance_kernel(Consts c, StateIn si, StateOut so,
                          const long long* __restrict__ keys, Params p,
                          int t0, int t1) {
  __shared__ int s_scan[ADV_MAX_U];         // in-chunk inclusive request scan
  __shared__ int s_chunk[ADV_MAX_U / 32];   // each 32-position chunk's total
  __shared__ int s_rr[ADV_MAX_E];           // the cells' RR pointers
  __shared__ int s_used[2][ADV_MAX_E];      // RBGs the admitted retx take
  __shared__ unsigned long long s_key[2][ADV_MAX_E];  // the winner's key

  const int U = p.U, E = p.E, B = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int r = blockIdx.x;
  const int nchunk = (U + 31) >> 5;

  // the positions this thread holds: their UE, cell, constants and state
  bool valid[K], elig[K];
  int ue[K], cell[K], before_cell[K], pos[K], count_u[K], count_c[K];
  unsigned group[K];
  float mi0[K], rate0[K], eff0[K], ecr0[K];
  Ue st[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = k * B + tid;
    valid[k] = q < U;
    const int u = valid[k] ? c.cell_order[q] : 0;
    const int e = valid[k] ? c.serving[u] : -1;
    ue[k] = u;
    cell[k] = e;
    before_cell[k] = valid[k] ? c.cell_start[e] - 1 : -1;
    elig[k] = valid[k] && c.eligible[u] != 0;
    pos[k] = c.pos[u];
    count_u[k] = c.count_u[u];
    count_c[k] = valid[k] ? c.count_c[e] : 1;
    mi0[k] = c.mi0[u];
    rate0[k] = c.rate0[u];
    eff0[k] = c.eff0[u];
    ecr0[k] = c.ecr0[u];
    st[k] = valid[k] ? load_ue(si, r * U + u) : Ue{};
    group[k] = __match_any_sync(kFull, e);
  }
  for (int e = tid; e < E; e += B) {
    s_rr[e] = si.rr_ptr[r * E + e];
    s_used[0][e] = s_used[1][e] = 0;
    s_key[0][e] = s_key[1][e] = 0ull;
  }
  const uint32_t key0 = static_cast<uint32_t>(keys[2 * r]);
  const uint32_t key1 = static_cast<uint32_t>(keys[2 * r + 1]);
  // a cell's key above this holds a candidate metric above kNeg
  const unsigned long long no_win =
      (static_cast<unsigned long long>(orderable(kNeg)) << 32) | 0xFFFFFFFFull;
  uint32_t kt0 = 0u, kt1 = 0u;  // fold_in(key, t + lane) for this 32-TTI run
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, b = i & 1;
    if ((i & 31) == 0) {
      kt0 = 0u;
      kt1 = static_cast<uint32_t>(t + lane);
      threefry2x32(key0, key1, kt0, kt1);
    }
    const uint32_t k0 = __shfl_sync(kFull, kt0, i & 31);
    const uint32_t k1 = __shfl_sync(kFull, kt1, i & 31);

    // A. due retx and their requests, scanned per warp; each UE's coin
    bool due[K], fit[K];
    int incl[K];
    float coin[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = k * B + tid;
      due[k] = elig[k] && st[k].pend != 0 && st[k].p_due <= t;
      incl[k] = warp_inclusive_scan(due[k] ? st[k].p_nrbg : 0, lane);
      if (q < U) s_scan[q] = incl[k];
      if (lane == 31 && (q >> 5) < nchunk) s_chunk[q >> 5] = incl[k];
      uint32_t x0 = 0u, x1 = static_cast<uint32_t>(ue[k]);
      threefry2x32(k0, k1, x0, x1);
      coin[k] = __fsub_rn(__uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u),
                          1.0f);
    }
    __syncthreads();

    // B. chunk totals scanned by every warp; admission against the cell's
    //    budget; per-cell admitted RBGs and winner keys
    const int ca = warp_inclusive_scan(lane < nchunk ? s_chunk[lane] : 0,
                                       lane);
    const int cb = nchunk > 32
                       ? warp_inclusive_scan(
                             lane + 32 < nchunk ? s_chunk[lane + 32] : 0, lane)
                       : 0;
    const int ca_total = __shfl_sync(kFull, ca, 31);
    // requests at positions before chunk ch (all lanes call it together)
    auto chunks_before = [&](int ch) {
      const int first32 = __shfl_sync(kFull, ca, (ch - 1) & 31);
      const int next32 = __shfl_sync(kFull, cb, (ch - 1) & 31);
      return ch == 0 ? 0 : (ch <= 32 ? first32 : ca_total + next32);
    };
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = k * B + tid;
      const int bq = before_cell[k];
      const int through_q = chunks_before(q >> 5) + incl[k];
      const int upto_cell = chunks_before(max(bq, 0) >> 5);
      const int before = bq < 0 ? 0 : upto_cell + s_scan[bq];
      fit[k] = due[k] && through_q - before <= p.n_rbg;
      const bool leader = lane == __ffs(static_cast<int>(group[k])) - 1;
      const int used =
          __reduce_add_sync(group[k], fit[k] ? st[k].p_nrbg : 0);
      if (valid[k] && leader && used != 0)
        atomicAdd(&s_used[b][cell[k]], used);

      const bool cand = elig[k] && st[k].pend == 0;
      const uint32_t hi =
          cand ? orderable(metric(p.sid, rate0[k], st[k].avg, pos[k],
                                  s_rr[max(cell[k], 0)], count_u[k]))
               : 0u;
      const uint32_t best = __reduce_max_sync(group[k], hi);
      const uint32_t lo =
          (cand && hi == best) ? ~static_cast<uint32_t>(ue[k]) : 0u;
      const uint32_t first = __reduce_max_sync(group[k], lo);
      if (valid[k] && leader && best != 0u)
        atomicMax(&s_key[b][cell[k]],
                  (static_cast<unsigned long long>(best) << 32) | first);
    }
    for (int e = tid; e < E; e += B) {
      s_used[b ^ 1][e] = 0;
      s_key[b ^ 1][e] = 0ull;
    }
    __syncthreads();

    // C. the winner takes its cell's RBGs left and moves the RR pointer;
    //    TB bits, decode and the state update
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!valid[k]) continue;
      const int e = cell[k];
      const unsigned long long key = s_key[b][e];
      const int rem = p.n_rbg - s_used[b][e];
      const bool winner = key > no_win && rem > 0 &&
                          static_cast<uint32_t>(key) ==
                              ~static_cast<uint32_t>(ue[k]);
      if (winner) s_rr[e] = (pos[k] + 1) % count_c[k];
      decode_update(st[k], fit[k], winner, winner ? rem : 0, coin[k],
                    eff0[k], mi0[k], ecr0[k], t, p);
    }
  }

  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (valid[k]) store_ue(so, r * U + ue[k], st[k]);
  for (int e = tid; e < E; e += B) so.rr_ptr[r * E + e] = s_rr[e];
}

template <int K>
int launch(const Consts& c, const StateIn& si, const StateOut& so,
           const long long* keys, const Params& p, int R, int B, int t0,
           int t1, cudaStream_t stream) {
  lte_sm_advance_kernel<K><<<R, B, 0, stream>>>(c, si, so, keys, p, t0, t1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lte_sm_advance_launch(
    const float* mi0, const float* rate0, const float* eff0,
    const float* ecr0, const int* eligible, const int* pos,
    const int* count_u, const int* serving, const int* count_c,
    const int* cell_order, const int* cell_start, const long long* keys,
    const float* avg, const int* pend, const float* p_mi, const float* p_tbb,
    const int* p_nrbg, const int* p_txc, const int* p_due, const int* rr_ptr,
    const int* rx_lo, const int* rx_hi, const int* new_tbs, const int* retx,
    const int* drops, const int* ok_cnt,
    float* o_avg, int* o_pend, float* o_p_mi, float* o_p_tbb, int* o_p_nrbg,
    int* o_p_txc, int* o_p_due, int* o_rr_ptr, int* o_rx_lo, int* o_rx_hi,
    int* o_new_tbs, int* o_retx, int* o_drops, int* o_ok_cnt,
    int R, int E, int U, int n_rbg, int rbg_size, int n_rb,
    float alpha, float one_minus_alpha, float inv_sqrt2, int t0, int t1,
    int sid, void* stream) {
  if (U <= 0 || U > ADV_MAX_U || E <= 0 || E > ADV_MAX_E || R <= 0 ||
      t0 < 0 || t1 < t0 || t1 > ADV_MAX_T)
    return cudaErrorInvalidValue;
  const Consts c{mi0,     rate0,   eff0,    ecr0,       eligible,  pos,
                 count_u, serving, count_c, cell_order, cell_start};
  const StateIn si{avg, pend, p_mi, p_tbb, p_nrbg, p_txc, p_due, rr_ptr,
                   rx_lo, rx_hi, new_tbs, retx, drops, ok_cnt};
  const StateOut so{o_avg, o_pend, o_p_mi, o_p_tbb, o_p_nrbg, o_p_txc,
                    o_p_due, o_rr_ptr, o_rx_lo, o_rx_hi, o_new_tbs, o_retx,
                    o_drops, o_ok_cnt};
  const Params p{E, U, n_rbg, rbg_size, n_rb, sid,
                 alpha, one_minus_alpha, inv_sqrt2};
  const int padded = ((U + 31) / 32) * 32;
  const int B = padded < ADV_MAX_THREADS ? padded : ADV_MAX_THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((U + B - 1) / B) {
    case 1: return launch<1>(c, si, so, keys, p, R, B, t0, t1, st);
    case 2: return launch<2>(c, si, so, keys, p, R, B, t0, t1, st);
    case 3: return launch<3>(c, si, so, keys, p, R, B, t0, t1, st);
    default: return launch<4>(c, si, so, keys, p, R, B, t0, t1, st);
  }
}
