// lte_sm_advance.cu — TTIs [t0, t1) of the full-buffer LTE SM engine, every
// replica, in one launch, with the decode coins drawn inside.
//
// Replaces the same TPU kernel as lte_sm_step.cu — build_sm_step_fn
// (tpudes/parallel/kernels_pallas.py:396, pl.pallas_call at :473, body
// sm_step_math at :371) — in its static arm, its dynamic-row arm
// (dynamic=SM_DYNAMIC_ROWS, kernels_pallas.py:406-411, :477-484) and its
// config sweep (the sid axis vmapped, tpudes/parallel/lte_sm.py:766,
// :817), together with the reference's device TTI loops around it
// (lte_sm.py:741 and :820, lax.while_loops, the latter with the geometry
// refresh cond at :799) and its per-TTI coin draw (lte_sm.py:678, :806).
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
// - Dynamic rows (the mobile path, template flag DYN): the five
//   SINR-derived rows mi0, rate0, eff0, ecr0, eligible come from a table of
//   geometry refreshes, row j holding the refresh at TTI
//   stride * (t0 / stride + j).  At t == t0 and at every t % stride == 0
//   (counted, not divided) each thread takes its UEs' five values of row
//   t / stride - t0 / stride,
//   before stage A, so a launch that starts mid-stride runs on the refresh
//   it starts inside.  Row 0 is loaded at t0; every later row was loaded
//   into five more registers at the refresh before it, so its loads have a
//   stride of TTIs to arrive.  The table is shared by every replica and
//   config point.  The static arm (DYN false) loads the program's rows
//   once, as before.
// - Config sweep: the grid is (R, C); CTA (r, c) runs replica r of config
//   point c with scheduler id sids[c] on state row c * R + r, and draws
//   replica r's coins (the keys are shared across points, as the
//   reference's sweep shares them).
// - Finite backlogs (the traffic path, template flag TRF; the reference's
//   build_sm_traffic_advance, lte_sm.py:839-946, which runs K1 with
//   dynamic=("eligible",)): each UE's backlog and its 20-bit split drained
//   counter live in three more registers for the launch.  Before TTI t the
//   backlog takes row t - t0 of the offered-bits table (T, U), shared by
//   every replica and config point and read one TTI ahead, capped at 2^30
//   bits; the UE is eligible only with a non-empty backlog; after the
//   decode the backlog drains by min(served, backlog), where served is the
//   TTI's own delivered bits (the reference's rx-counter difference: the
//   same integer below 2^24).  TRF and DYN exclude each other, as the
//   reference refuses traffic with mobility; the sweep grid takes either.
// - bf16 (template flag BF16, precision="bf16"): lte_sm_common.cuh's metric
//   and BLER with the reference's bf16 roundings; orthogonal to the arms.
// - FlowMonitor columns (template flag OBS, obs=True; the reference's obs
//   arm, lte_sm.py:650-757, in its static arm only): each UE's columns in
//   registers, updated from the TTI's counter differences, and one ring
//   row a TTI; instantiated in lte_sm_advance_obs.cu, its own translation
//   unit, and every line of it under if constexpr, so the arms without it
//   keep their code.
//
// Arithmetic: lte_sm_common.cuh's, bit-identical on the card to the plain
// PyTorch loop sm_advance_math (tpudes_torch/parallel/kernels_cuda.py).
//
// Bound: at E=7, U=210, R=64 the state moves once each way (about 1.4 MB,
// 0.4 us at 3.35 TB/s; the traffic arm adds its table, 840 B per TTI read
// once, 8.4 MB at 10,000 TTIs), so over a horizon the bound is the work:
// about 80 int32 operations per UE-TTI (the coin's threefry and the scan)
// over the card's int32 rate, 0.64 ms at 10,000 TTIs.  With 64 CTAs on 132
// SMs the time is set by each TTI's chain of dependent steps (hash, scan,
// barrier, reductions and atomics, barrier, BLER), not by throughput.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lte_sm_common.cuh"
#include "threefry.cuh"

#define ADV_MAX_U 2048
#define ADV_MAX_E 256
#define ADV_MAX_THREADS 512
// the last TTI a launch may reach: t + 31 (a lane's fold-in) and t + 8
// (a retx due time) stay below 2^31
#define ADV_MAX_T 2147483000

namespace lte_adv {

using namespace lte_sm;

// the geometry refreshes of one launch: (J, U) rows, row-major
struct Table {
  const float *mi0, *rate0, *eff0, *ecr0;
  const int* eligible;
};

// the traffic arm: the offered bits (T, U) and the backlog state in / out
struct Traffic {
  const float* offered;
  const float* backlog;
  const int *drained_lo, *drained_hi;
  float* o_backlog;
  int *o_drained_lo, *o_drained_hi;
};

// the OBS arm's FlowMonitor columns (flow = UE), updated in place: (rows,
// U) each, hist (rows, U, 16), ring (rows, 512, 5); delay is the one-TTI
// MAC-to-ACK latency (also the TTI's length in seconds), bin its histogram
// bin
struct Obs {
  int *tx, *txb, *rx, *rxb, *lost;
  float *dsum, *jsum, *dlast, *t0, *t1;
  int *hist, *ring;
  float delay;
  int bin;
};
constexpr int kObsBins = 16;
constexpr int kRingCap = 512;
constexpr int kRingCols = 5;

// one UE's event key for the ring's argmax: the count, then the lowest UE
// index, then the UE's bytes this TTI (a count is 0 or 1 a TTI)
__device__ __forceinline__ unsigned long long obs_key(int v, int u,
                                                      int bytes) {
  return (static_cast<unsigned long long>(v) << 48) |
         (static_cast<unsigned long long>(0xFFFF - u) << 32) |
         static_cast<uint32_t>(bytes);
}

// the ring row of TTI tt from its two keys (deliveries, sends), by one
// thread: the UE with the most deliveries (the lowest index on a tie),
// else the one with the most sends; step -1 where neither happened
__device__ __forceinline__ void obs_ring_row(int* ring, int row, int tt,
                                             unsigned long long k_ok,
                                             unsigned long long k_tx) {
  const bool got = k_ok != 0ull, sent = k_tx != 0ull;
  const unsigned long long k = got ? k_ok : k_tx;
  int* w = ring + (static_cast<long long>(row) * kRingCap + tt % kRingCap) *
                      kRingCols;
  w[0] = got || sent ? tt : -1;
  w[1] = static_cast<int>(static_cast<unsigned>(tt) * 1000u);
  w[2] = k != 0ull ? 0xFFFF - static_cast<int>((k >> 32) & 0xFFFFull) : 0;
  w[3] = k != 0ull ? static_cast<int>(static_cast<uint32_t>(k)) : 0;
  w[4] = got ? 1 : 0;
}

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kBacklogCap = 1073741824.0f;  // 2^30 bits

using threefry::threefry2x32;

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

// row j of the table into the five registers of each position held
template <int K>
__device__ __forceinline__ void load_row(const Table& tab, int j, int U,
                                         const int (&ue)[K],
                                         const bool (&valid)[K],
                                         float (&mi0)[K], float (&rate0)[K],
                                         float (&eff0)[K], float (&ecr0)[K],
                                         int (&elig)[K]) {
  const long long base = static_cast<long long>(j) * U;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long q = base + (valid[k] ? ue[k] : 0);
    mi0[k] = tab.mi0[q];
    rate0[k] = tab.rate0[q];
    eff0[k] = tab.eff0[q];
    ecr0[k] = tab.ecr0[q];
    elig[k] = tab.eligible[q];
  }
}

template <int K, bool DYN, bool TRF, bool BF16, bool OBS = false>
__global__ void __launch_bounds__(ADV_MAX_THREADS)
    lte_sm_advance_kernel(Consts c, Table tab, Traffic tr, StateIn si,
                          StateOut so, const long long* __restrict__ keys,
                          const int* __restrict__ sids, Params p, int t0,
                          int t1, int stride, Obs ob) {
  __shared__ int s_scan[ADV_MAX_U];         // in-chunk inclusive request scan
  __shared__ int s_chunk[ADV_MAX_U / 32];   // each 32-position chunk's total
  __shared__ int s_rr[ADV_MAX_E];           // the cells' RR pointers
  __shared__ int s_used[2][ADV_MAX_E];      // RBGs the admitted retx take
  __shared__ unsigned long long s_key[2][ADV_MAX_E];  // the winner's key

  const int U = p.U, E = p.E, B = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int r = blockIdx.x;                      // replica: its coins
  const int row = blockIdx.y * gridDim.x + r;    // its state row
  const int sid = sids != nullptr ? sids[blockIdx.y] : p.sid;
  const int nchunk = (U + 31) >> 5;

  // the positions this thread holds: their UE, cell, constants and state
  bool valid[K], elig[K], elig0[K];
  int ue[K], cell[K], before_cell[K], pos[K], count_u[K], count_c[K];
  unsigned group[K];
  float mi0[K], rate0[K], eff0[K], ecr0[K];
  Ue st[K];
  // the traffic arm: backlog, drained counter, this TTI's capped backlog
  // and the next TTI's offered bits in flight
  float backlog[K], bl[K], off_nx[K];
  int drained_lo[K], drained_hi[K];
  // the OBS arm: each UE's columns, and its deliveries into the bin
  int f_tx[K], f_txb[K], f_rx[K], f_rxb[K], f_lost[K], f_hist[K];
  float f_dsum[K], f_jsum[K], f_dlast[K], f_t0[K], f_t1[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int q = k * B + tid;
    valid[k] = q < U;
    const int u = valid[k] ? c.cell_order[q] : 0;
    const int e = valid[k] ? c.serving[u] : -1;
    ue[k] = u;
    cell[k] = e;
    before_cell[k] = valid[k] ? c.cell_start[e] - 1 : -1;
    pos[k] = c.pos[u];
    count_u[k] = c.count_u[u];
    count_c[k] = valid[k] ? c.count_c[e] : 1;
    // the static arm's rows, once; the dynamic arm loads them at t0; the
    // traffic arm gates the static eligibility by the backlog every TTI
    elig0[k] = !DYN && valid[k] && c.eligible[u] != 0;
    elig[k] = elig0[k];
    mi0[k] = DYN ? 0.0f : c.mi0[u];
    rate0[k] = DYN ? 0.0f : c.rate0[u];
    eff0[k] = DYN ? 0.0f : c.eff0[u];
    ecr0[k] = DYN ? 0.0f : c.ecr0[u];
    st[k] = valid[k] ? load_ue(si, row * U + u) : Ue{};
    group[k] = __match_any_sync(kFull, e);
    if (TRF) {
      const int i = row * U + u;
      backlog[k] = valid[k] ? tr.backlog[i] : 0.0f;
      drained_lo[k] = valid[k] ? tr.drained_lo[i] : 0;
      drained_hi[k] = valid[k] ? tr.drained_hi[i] : 0;
      off_nx[k] = t1 > t0 ? tr.offered[u] : 0.0f;
    }
    if constexpr (OBS) {
      const int i = row * U + u;
      f_tx[k] = valid[k] ? ob.tx[i] : 0;
      f_txb[k] = valid[k] ? ob.txb[i] : 0;
      f_rx[k] = valid[k] ? ob.rx[i] : 0;
      f_rxb[k] = valid[k] ? ob.rxb[i] : 0;
      f_lost[k] = valid[k] ? ob.lost[i] : 0;
      f_dsum[k] = valid[k] ? ob.dsum[i] : 0.0f;
      f_jsum[k] = valid[k] ? ob.jsum[i] : 0.0f;
      f_dlast[k] = valid[k] ? ob.dlast[i] : -1.0f;
      f_t0[k] = valid[k] ? ob.t0[i] : -1.0f;
      f_t1[k] = valid[k] ? ob.t1[i] : -1.0f;
      f_hist[k] = 0;
    }
  }
  // the OBS arm's ring keys of the TTI, by parity
  unsigned long long* s_obs = nullptr;
  if constexpr (OBS) {
    __shared__ unsigned long long s_obs_buf[2][2];
    s_obs = &s_obs_buf[0][0];
    if (tid < 4) s_obs[tid] = 0ull;
  }
  for (int e = tid; e < E; e += B) {
    s_rr[e] = si.rr_ptr[row * E + e];
    s_used[0][e] = s_used[1][e] = 0;
    s_key[0][e] = s_key[1][e] = 0ull;
  }
  const uint32_t key0 = static_cast<uint32_t>(keys[2 * r]);
  const uint32_t key1 = static_cast<uint32_t>(keys[2 * r + 1]);
  // a cell's key above this holds a candidate metric above kNeg
  const unsigned long long no_win =
      (static_cast<unsigned long long>(orderable(kNeg)) << 32) | 0xFFFFFFFFull;
  uint32_t kt0 = 0u, kt1 = 0u;  // fold_in(key, t + lane) for this 32-TTI run
  // the dynamic arm's last table row, its eligibility as loaded and the
  // next refresh's five values in flight
  const int j_last = DYN ? (t1 - 1) / stride - t0 / stride : 0;
  // the refresh TTI after t0 (a multiple of stride) and the row held
  long long next_refresh =
      DYN ? (static_cast<long long>(t0 / stride) + 1) * stride : 0;
  int j = 0;
  int elig_n[K], nx_elig[K];
  float nx_mi0[K], nx_rate0[K], nx_eff0[K], nx_ecr0[K];
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, b = i & 1;
    if (DYN && (t == t0 || t == next_refresh)) {
      // the refresh this TTI runs on, row j = t / stride - t0 / stride:
      // loaded now at t0, else prefetched at the refresh before; then
      // the next row's prefetch, which has a stride of TTIs to land
      if (t == next_refresh) {
        ++j;
        next_refresh += stride;
      }
      if (t == t0) load_row(tab, 0, U, ue, valid, mi0, rate0, eff0, ecr0,
                            elig_n);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (t != t0) {
          mi0[k] = nx_mi0[k];
          rate0[k] = nx_rate0[k];
          eff0[k] = nx_eff0[k];
          ecr0[k] = nx_ecr0[k];
          elig_n[k] = nx_elig[k];
        }
        elig[k] = valid[k] && elig_n[k] != 0;
      }
      if (j < j_last)
        load_row(tab, j + 1, U, ue, valid, nx_mi0, nx_rate0, nx_eff0,
                 nx_ecr0, nx_elig);
    }
    if (TRF) {
      // this TTI's offered bits into the backlog, the next TTI's load
      // issued now; the gate
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float off = off_nx[k];
        if (t + 1 < t1)
          off_nx[k] = tr.offered[static_cast<long long>(i + 1) * U + ue[k]];
        bl[k] = fminf(__fadd_rn(backlog[k], off), kBacklogCap);
        elig[k] = elig0[k] && bl[k] > 0.0f;
      }
    }
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
          cand ? orderable(metric<BF16>(sid, rate0[k], st[k].avg, pos[k],
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
    if constexpr (OBS) {
      // the TTI before's ring row (its keys landed before the barrier)
      if (tid == 0 && t > t0) {
        obs_ring_row(ob.ring, row, t - 1, s_obs[2 * (b ^ 1)],
                     s_obs[2 * (b ^ 1) + 1]);
        s_obs[2 * (b ^ 1)] = s_obs[2 * (b ^ 1) + 1] = 0ull;
      }
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
      const Ue before = st[k];
      const float served =
          decode_update<BF16>(st[k], fit[k], winner, winner ? rem : 0,
                              coin[k], eff0[k], mi0[k], ecr0[k], t, p);
      if constexpr (OBS) {
        // the TTI's counter differences: acked bytes from the split rx
        // counter, sends, deliveries and drops (lte_sm.py:688-733)
        const int d_ok = st[k].ok_cnt - before.ok_cnt;
        const int d_tx = (st[k].new_tbs - before.new_tbs) +
                         (st[k].retx - before.retx);
        const int d_drop = st[k].drops - before.drops;
        const int d_bits = static_cast<int>(
            (static_cast<unsigned>(st[k].rx_hi - before.rx_hi) << 20) +
            static_cast<unsigned>(st[k].rx_lo - before.rx_lo));
        const int d_bytes = d_bits >> 3;
        const bool got = d_ok > 0;
        const float ts = __fmul_rn(static_cast<float>(t), ob.delay);
        f_tx[k] += d_tx;
        f_txb[k] += d_bytes;
        f_rx[k] += d_ok;
        f_rxb[k] += d_bytes;
        f_lost[k] += d_drop;
        f_dsum[k] =
            __fadd_rn(f_dsum[k], __fmul_rn(ob.delay, static_cast<float>(d_ok)));
        f_jsum[k] = __fadd_rn(
            f_jsum[k], got && f_dlast[k] >= 0.0f
                           ? fabsf(__fsub_rn(ob.delay, f_dlast[k]))
                           : 0.0f);
        if (got) {
          f_dlast[k] = ob.delay;
          f_t1[k] = ts;
        }
        if (d_tx > 0 && f_t0[k] < 0.0f) f_t0[k] = ts;
        f_hist[k] += d_ok;
        if (got) atomicMax(&s_obs[2 * b], obs_key(d_ok, ue[k], d_bytes));
        if (d_tx > 0)
          atomicMax(&s_obs[2 * b + 1], obs_key(d_tx, ue[k], d_bytes));
      }
      if (TRF) {
        // only the backlog's bits drain (a larger TB is padding)
        const float drain = fminf(served, bl[k]);
        const int lo = drained_lo[k] + __float2int_rn(drain);
        backlog[k] = __fsub_rn(bl[k], drain);
        drained_lo[k] = lo & 0xFFFFF;
        drained_hi[k] += lo >> 20;
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!valid[k]) continue;
    const int i = row * U + ue[k];
    store_ue(so, i, st[k]);
    if (TRF) {
      tr.o_backlog[i] = backlog[k];
      tr.o_drained_lo[i] = drained_lo[k];
      tr.o_drained_hi[i] = drained_hi[k];
    }
    if constexpr (OBS) {
      ob.tx[i] = f_tx[k];
      ob.txb[i] = f_txb[k];
      ob.rx[i] = f_rx[k];
      ob.rxb[i] = f_rxb[k];
      ob.lost[i] = f_lost[k];
      ob.dsum[i] = f_dsum[k];
      ob.jsum[i] = f_jsum[k];
      ob.dlast[i] = f_dlast[k];
      ob.t0[i] = f_t0[k];
      ob.t1[i] = f_t1[k];
      ob.hist[static_cast<long long>(i) * kObsBins + ob.bin] += f_hist[k];
    }
  }
  if constexpr (OBS) {
    if (tid == 0 && t1 > t0) {
      const int b = (t1 - 1 - t0) & 1;
      obs_ring_row(ob.ring, row, t1 - 1, s_obs[2 * b], s_obs[2 * b + 1]);
    }
  }
  for (int e = tid; e < E; e += B) so.rr_ptr[row * E + e] = s_rr[e];
}

struct Launch {
  Consts c;
  Table tab;
  Traffic tr;
  StateIn si;
  StateOut so;
  const long long* keys;
  const int* sids;
  Params p;
  int R, C, B, t0, t1, stride;
  cudaStream_t stream;
  Obs ob;
};

template <int K, bool DYN, bool TRF, bool BF16, bool OBS = false>
int launch_arm(const Launch& a) {
  lte_sm_advance_kernel<K, DYN, TRF, BF16, OBS>
      <<<dim3(a.R, a.C), a.B, 0, a.stream>>>(a.c, a.tab, a.tr, a.si, a.so,
                                             a.keys, a.sids, a.p, a.t0, a.t1,
                                             a.stride, a.ob);
  return static_cast<int>(cudaGetLastError());
}

// the OBS arm (static rows, full buffers; either precision, any point
// count): lte_sm_advance_obs.cu
int launch_obs(const Launch& a, int K, bool bf16);

template <int K, bool BF16>
int launch_arms(const Launch& a) {
  if (a.tab.mi0 != nullptr) return launch_arm<K, true, false, BF16>(a);
  if (a.tr.offered != nullptr) return launch_arm<K, false, true, BF16>(a);
  return launch_arm<K, false, false, BF16>(a);
}

template <int K>
int launch(const Launch& a, bool bf16) {
  return bf16 ? launch_arms<K, true>(a) : launch_arms<K, false>(a);
}

}  // namespace lte_adv

#ifndef LTE_ADV_OBS_PART
using namespace lte_adv;

extern "C" int lte_sm_advance_launch(
    const float* mi0, const float* rate0, const float* eff0,
    const float* ecr0, const int* eligible, const int* pos,
    const int* count_u, const int* serving, const int* count_c,
    const int* cell_order, const int* cell_start, const float* tab_mi0,
    const float* tab_rate0, const float* tab_eff0, const float* tab_ecr0,
    const int* tab_eligible, const float* offered, const long long* keys,
    const int* sids,
    const float* avg, const int* pend, const float* p_mi, const float* p_tbb,
    const int* p_nrbg, const int* p_txc, const int* p_due, const int* rr_ptr,
    const int* rx_lo, const int* rx_hi, const int* new_tbs, const int* retx,
    const int* drops, const int* ok_cnt, const float* tr_backlog,
    const int* tr_drained_lo, const int* tr_drained_hi,
    float* o_avg, int* o_pend, float* o_p_mi, float* o_p_tbb, int* o_p_nrbg,
    int* o_p_txc, int* o_p_due, int* o_rr_ptr, int* o_rx_lo, int* o_rx_hi,
    int* o_new_tbs, int* o_retx, int* o_drops, int* o_ok_cnt,
    float* o_tr_backlog, int* o_tr_drained_lo, int* o_tr_drained_hi,
    int R, int C, int E, int U, int n_rbg, int rbg_size, int n_rb,
    float alpha, float one_minus_alpha, float inv_sqrt2, int t0, int t1,
    int sid, int stride, int bf16, void* stream, void* const* obs,
    float obs_delay, int obs_bin) {
  const bool dyn = tab_mi0 != nullptr;
  const bool trf = offered != nullptr;
  if (obs != nullptr &&
      (dyn || trf || obs_bin < 0 || obs_bin >= kObsBins))
    return cudaErrorInvalidValue;
  if (obs != nullptr)
    for (int q = 0; q < 12; ++q)
      if (obs[q] == nullptr) return cudaErrorInvalidValue;
  if (U <= 0 || U > ADV_MAX_U || E <= 0 || E > ADV_MAX_E || R <= 0 ||
      C <= 0 || C > 65535 || (C > 1 && sids == nullptr) || t0 < 0 ||
      t1 < t0 || t1 > ADV_MAX_T || stride <= 0 || (dyn && trf) ||
      (dyn && (tab_rate0 == nullptr || tab_eff0 == nullptr ||
               tab_ecr0 == nullptr || tab_eligible == nullptr)) ||
      (trf && (tr_backlog == nullptr || tr_drained_lo == nullptr ||
               tr_drained_hi == nullptr || o_tr_backlog == nullptr ||
               o_tr_drained_lo == nullptr || o_tr_drained_hi == nullptr)))
    return cudaErrorInvalidValue;
  const Consts c{mi0,     rate0,   eff0,    ecr0,       eligible,  pos,
                 count_u, serving, count_c, cell_order, cell_start};
  const Table tab{tab_mi0, tab_rate0, tab_eff0, tab_ecr0, tab_eligible};
  const Traffic tr{offered,      tr_backlog,      tr_drained_lo,
                   tr_drained_hi, o_tr_backlog,   o_tr_drained_lo,
                   o_tr_drained_hi};
  const StateIn si{avg, pend, p_mi, p_tbb, p_nrbg, p_txc, p_due, rr_ptr,
                   rx_lo, rx_hi, new_tbs, retx, drops, ok_cnt};
  const StateOut so{o_avg, o_pend, o_p_mi, o_p_tbb, o_p_nrbg, o_p_txc,
                    o_p_due, o_rr_ptr, o_rx_lo, o_rx_hi, o_new_tbs, o_retx,
                    o_drops, o_ok_cnt};
  const Params p{E, U, n_rbg, rbg_size, n_rb, sid,
                 alpha, one_minus_alpha, inv_sqrt2};
  const int padded = ((U + 31) / 32) * 32;
  const int B = padded < ADV_MAX_THREADS ? padded : ADV_MAX_THREADS;
  Obs ob{};
  if (obs != nullptr) {
    int* const* q = reinterpret_cast<int* const*>(obs);
    ob = Obs{q[0], q[1], q[2], q[3], q[4],
             reinterpret_cast<float*>(q[5]), reinterpret_cast<float*>(q[6]),
             reinterpret_cast<float*>(q[7]), reinterpret_cast<float*>(q[8]),
             reinterpret_cast<float*>(q[9]), q[10], q[11], obs_delay,
             obs_bin};
  }
  const Launch a{c,    tab, tr, si, so, keys, sids, p, R, C, B, t0, t1,
                 stride, static_cast<cudaStream_t>(stream), ob};
  if (obs != nullptr) return launch_obs(a, (U + B - 1) / B, bf16 != 0);
  switch ((U + B - 1) / B) {
    case 1:
      return launch<1>(a, bf16 != 0);
    case 2:
      return launch<2>(a, bf16 != 0);
    case 3:
      return launch<3>(a, bf16 != 0);
    default:
      return launch<4>(a, bf16 != 0);
  }
}
#endif  // LTE_ADV_OBS_PART
