// bss_advance.cuh — the WiFi BSS replica engine's event loop, every step of
// a chunk for every replica, in one persistent launch: the kernel, its
// launch and the arms, shared by bss_advance.cu (the C interface) and the
// translation units that instantiate each slot count (bss_advance_s*.cu).
//
// Replaces the reference's device event loop: build_bss_advance's
// lax.while_loop (tpudes/parallel/replicated.py:1155) over
// build_bss_step.step_fn (:738-1093), static or mobile, legacy or
// aggregated, with or without a traffic program, and its vmap over horizons
// or workloads (:1403-1422); XLA code, no pallas_call.  Its plain
// version is tpudes_torch/parallel/replicated.py::bss_advance_math (step_fn
// in a loop under the reference's loop condition), which it equals bit for
// bit on the card.
//
// What bounds it.  A replica's steps are sequential: each step is a chain
// of dependent stages (the earliest transmit instant, the winners, the
// power they put at the destinations, the PHY of the gated frames, the
// outcome counts), and the next step starts from its result.  The state
// crosses HBM once each way (about 0.2 MB at the bench), and the work is
// a few hundred integer operations a node-step plus a threefry hash per
// draw and a PSR chain per overlapping frame: at the bench the operations
// bound is about 1/30 of the time.  So the kernel is bound by the latency
// of one step's chain, times the steps.  It has no matrix product (no
// tensor cores) and no tile to stage (no TMA): the design cuts the chain.
//
// Design, for the H100:
// - One warp per (point, replica) row, BSS_ROWS_PER_BLOCK rows a block and
//   no barrier between them: a warp runs its replica's steps on its own,
//   warp-synchronous.  Node i lives on lane i % 32, slot i / 32; a lane
//   holds its S = ceil(N / 32) slots' state (next_arr, queue, ap_pend,
//   backoff, hold, immediate, cw, retries, cli_rx; interval, stop and its
//   link to the AP) in registers, S a template parameter for N <= 128
//   (the bench's N = 65 is 3 slots), and in local memory past it (S = 0:
//   up to 32 slots, counted at run time).  The replica's scalars (t,
//   bcn_pend, busy_until, srv_rx, tx_data, drops) are held by every lane.
//   State is read from HBM once and written once.  The row index maps to
//   (point, replica) as the (C, R) state does; a ragged last block's extra
//   warps leave at once.
// - Reductions: a lane folds its slots, then one warp operation.  The
//   integer ones (the earliest STA transmit instant, the earliest arrival,
//   the lowest node with an echo pending (under AGG packed with its count),
//   the outcome sums and the longest occupancy) are one redux.sync each.
//   The power sums keep replicated.py::tree_sum's order: each slot's
//   32-lane pairwise tree (shuffles, the slots' ladders interleaved), then
//   the pairwise tree over the slots in registers, which is the order the
//   zero-padded tree takes for every N.  Ballots of the winners are one
//   word per slot, so node i's bit is (word i / 32, bit i % 32).
// - Draws: step s, replica r: k = split(fold_in(fold_in(key, s), r)),
//   uniform(k[0], (N,)) for backoffs and uniform(k[1], (N,)) for coins, or
//   under AGG uniform(k[1], (N, K)), flat index i K + j (random.py::
//   bss_draws), in uint32 threefry2x32.  Every 32 steps lane l derives
//   step s + l's two keys (four hashes); each step shuffles them across the
//   warp.  A node's backoff uniform is needed in a step where it becomes
//   head of line without an immediate grant, loses an immediate grant to
//   another sender, or wins; all three are known once the first reduction
//   has given the step's instant, so the draw is made then, with a winner's
//   coin (legacy), as one straight-line hash pass (a lane's lowest such
//   slot; a second pass only if a lane has two) that runs under the
//   winners' power sums, not after the PSR rate.  Under AGG a gated frame's
//   k coins are spread over the warp: lane j hashes subframes j and j + 32,
//   and two ballots count the decoded ones.
// - The PHY of a gated frame: SINR = sig / ((at_dst - sig) + noise) and
//   the NIST chain in xla_math.cuh's arithmetic, then the coins.  A frame
//   with no interference (a lone sender: at_dst - sig == 0) has the SINR
//   sig / noise of its own link, so the chain's SNR part (the success rate
//   itself in the legacy arm, log1p(-pe) under AGG) is one of 2N per
//   program: each lane computes its slots' uplink values, and the AP's
//   downlinks go to the row's slice of shared memory with the AP's links
//   (rx power, detectability), once before the loop; the chain runs in the
//   loop only for frames that overlap others, one per lane at a time.
//   Under AGG the k-dependent tail (the A-MPDU's airtime, nbits, two
//   products, a division and exp) runs for every gated frame.
// - MOB (a mobile program): every `stride` steps (step % stride == 0) the
//   warp computes every node's position at the replica's next event into
//   the row's shared slice (the model dispatched by its id: const_velocity
//   and static, the random walk folded into its box, waypoints), a
//   __syncwarp, then each STA's link to the AP: the rx power and
//   detectability (the link is symmetric bit for bit, so it is the AP's
//   link to the node too) and the chain's values with no interference, the
//   STAs 1..N-1 a pass of the 32 lanes at a time (N = 65: two passes, not
//   three; the AP's own slot is its self-link, the same at every position,
//   computed once); each lane reads its slots' values back.  On the card
//   one node a lane per pass, inline, beat two side by side and beat an
//   out-of-line call (the call spilled the slots' state).  No (N, N) table
//   is kept: in a step where the AP sends data (the one frame that reads
//   the destination's sum) the AP's link to its destination is in the
//   slice and any other winner computes its own.  The refresh time rides
//   in the state (geom_t): a launch's first step rebuilds the geometry it
//   starts from.
// - TRF (a traffic program): an arriving node computes its next gap from
//   its own model's branch (cbr interval, mmpp exponential at the epoch's
//   rate with its three threefry hashes, onoff burst spacing or jump, trace
//   lookup), its rows of the operand tables read from global memory; the
//   replica's traffic key fold_in(fold_in(key, 0x7A), r) is derived once
//   per launch.  A workload sweep's points each read their own operand set.
// - PROF (a probe, never on the main path): lane 0 reads clock64() at the
//   stage edges and writes each stage's cycles summed over the row's steps
//   (BSS_PROF_STAGES: the first reduction, the MOB refresh, the eager
//   draws with the winners' sums, the remaining draws and the arrivals'
//   gaps, the PHY, the outcome reduction and the update).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "xla_math.cuh"

#define BSS_MAX_N 1024
// the last step a launch may reach: step + 31 (a lane's lookahead) stays
// below 2^31
#define BSS_MAX_STEP 2147483000
// horizons one launch holds (its points)
#define BSS_MAX_POINTS 64
// the A-MPDU cap: two coins per lane
#define BSS_MAX_MPDUS 64
// slots a lane holds in registers (N <= 32 x this); past it, local memory
#define BSS_REG_SLOTS 4
// rows (warps) a block
#define BSS_ROWS_PER_BLOCK 4
// the probe's stages, and the slot count it is built for (the bench's)
#define BSS_PROF_STAGES 6
#define BSS_PROF_SLOTS 3

namespace bss_kernel {

using xla_math::Psr;

constexpr int kSlot = 9;
constexpr int kSifs = 16;
constexpr int kCwMin = 15;
constexpr int kCwMax = 1023;
constexpr int kRetryLimit = 7;
constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Consts {
  const float* rx_w;     // (N, N) tx -> rx power, W
  const uint8_t* det;    // (N, N) detectable
  const int* interval;   // (N,)
  const int* stop;       // (N,)
  int N, aifs, data_dur, resp_dur, exch_beacon;
  float nbits, noise_w;
  Psr psr;
  // AGG: the A-MPDU cap, the data preamble (us), 8 * subframe bytes,
  // 1 / ndbps and the rate in Mbit/s, each as ops/wifi_error.py::
  // ampdu_params rounds it
  int K, preamble;
  float sub8, inv_ndbps, rate;
};

// the points of a horizon sweep: each one's horizon and first step
struct Points {
  int sim_end[BSS_MAX_POINTS];
  int step0[BSS_MAX_POINTS];
};

// a mobile program's position math and link physics (ops/mobility.py's
// operands, replicated.py::geom_tables's constants)
struct Mob {
  int model, stride;       // MOB_MODEL_IDS; refresh every stride steps
  const float* base;       // (N, 3)
  const float* vel;        // (N, 3) const_velocity
  const float* speed;      // (N, 2) walk speed band; [:, 1] > 0 moves
  const float* bounds;     // (4,) walk box
  const int* wp_t;         // (N, W) waypoint times
  const float* wp_p;       // (N, W, 3)
  const float* walk;       // (S, N, 2) walk segment velocities
  int W, n_seg;
  float seg_us;
  // f32 tx power, tx - 30, 10 n / ln 10, L0, rx sensitivity
  float tx, tx30, k_loss, ref_loss, sens;
};

// a traffic program's operands, a leading point axis of 1 or C
// (traffic/device.py::stack_traffic_operands)
struct Traffic {
  const int* id;           // (P, N)
  const int* start;        // (P, N)
  const int* interval;     // (P, N)
  const float* rate;       // (P, N)
  const float* epoch_rate; // (P, S)
  const int* on_start;     // (P, N, C)
  const int* on_len;       // (P, N, C)
  const float* peak;       // (P, N, C)
  const int* arr_t;        // (P, N, K)
  int S, C, K, epoch_us;
  int multi;               // 1: point p reads set p
};

// the OBS arm's state (replicated.py::obs_keys), updated in place: the
// failed exchanges per replica (C R,), the FlowMonitor columns of each node
// (C R, N), its delay histogram (C R, N, 16) and the ring (C R, 512, 5); a
// packet's bytes and the factor taking a delay (s) to its histogram bin
// (flowmon.py::bin_scale)
struct Obs {
  int *retx, *tx, *txb, *rx, *rxb, *lost;
  float *dsum, *jsum, *dlast, *t0, *t1;
  int *hist, *ring;
  int pkt;
  float scale;
};
constexpr int kObsBins = 16;
constexpr int kRingCap = 512;
constexpr int kRingCols = 5;

// the BSS_STATE layout (parallel/bss_cuda.py): per node (R, N), per replica
// (R,)
struct StateIn {
  const int *t, *next_arr, *queue, *ap_pend, *bcn_pend, *backoff, *hold;
  const uint8_t* immediate;
  const int *cw, *retries, *busy_until, *srv_rx, *cli_rx, *tx_data, *drops,
      *geom_t;
};

struct StateOut {
  int *t, *next_arr, *queue, *ap_pend, *bcn_pend, *backoff, *hold;
  uint8_t* immediate;
  int *cw, *retries, *busy_until, *srv_rx, *cli_rx, *tx_data, *drops,
      *geom_t;
};

// the launch's shape: rows = C R (point-major), R replicas a point, each
// row's slice of dynamic shared memory (bss_cuda.py::launch_geometry)
struct Grid {
  int rows, R, row_bytes, step1;
};

// x + y on int32 with the wrap the reference's int32 sums have
__device__ __forceinline__ int wrap_add(int x, int y) {
  return static_cast<int>(static_cast<unsigned>(x) + static_cast<unsigned>(y));
}

// the walk's triangle-wave fold of x into [lo, hi] (ops/mobility.py::
// fold_into_bounds): the floored mod, hi <= lo clamping to lo
__device__ __forceinline__ float fold_into(float x, float lo, float hi) {
  const float span = __fsub_rn(hi, lo);
  const float period = __fmul_rn(2.0f, span);
  float y = fmodf(__fsub_rn(x, lo), period);
  if (y != 0.0f && ((y < 0.0f) != (period < 0.0f))) y = __fadd_rn(y, period);
  const float folded =
      __fsub_rn(__fadd_rn(lo, span), fabsf(__fsub_rn(span, y)));
  return span > 0.0f ? folded : lo;
}

// node i's position at t us (ops/mobility.py::build_position_fn), written
// to p[0..2]
static __device__ void position(const Mob& m, int N, int i, int t,
                                float* p) {
  const float t_f = static_cast<float>(t);
  const float* b = m.base + 3 * i;
  if (m.model == 2) {  // random walk
    float x, y;
    const float* v = m.walk + 2 * i;
    auto dt = [&](int s) {
      const float since = __fsub_rn(t_f, __fmul_rn(static_cast<float>(s),
                                                   m.seg_us));
      return __fmul_rn(fminf(fmaxf(since, 0.0f), m.seg_us), 1e-6f);
    };
    if (m.n_seg == 1) {
      const float d0 = dt(0);
      x = xla_math::fma32(v[0], d0, b[0]);
      y = xla_math::fma32(v[1], d0, b[1]);
    } else {
      const float d0 = dt(0);
      float dx = __fmul_rn(v[0], d0), dy = __fmul_rn(v[1], d0);
      for (int s = 1; s < m.n_seg; ++s) {
        const float ds = dt(s);
        const float* vs = v + 2 * N * s;
        dx = xla_math::fma32(vs[0], ds, dx);
        dy = xla_math::fma32(vs[1], ds, dy);
      }
      x = __fadd_rn(b[0], dx);
      y = __fadd_rn(b[1], dy);
    }
    const bool moving = m.speed[2 * i + 1] > 0.0f;
    p[0] = moving ? fold_into(x, m.bounds[0], m.bounds[1]) : b[0];
    p[1] = moving ? fold_into(y, m.bounds[2], m.bounds[3]) : b[1];
    p[2] = b[2];
  } else if (m.model == 3) {  // waypoints, clamped at both ends
    const int* wt = m.wp_t + m.W * i;
    int hits = 0;
    for (int w = 0; w < m.W; ++w) hits += wt[w] <= t ? 1 : 0;
    const int k = min(max(hits - 1, 0), m.W - 2);
    const float span = fmaxf(static_cast<float>(wt[k + 1] - wt[k]), 1.0f);
    const float frac = fminf(
        fmaxf(__fdiv_rn(static_cast<float>(t - wt[k]), span), 0.0f), 1.0f);
    const float* p0 = m.wp_p + 3 * (m.W * i + k);
    for (int a = 0; a < 3; ++a)
      p[a] = xla_math::fma32(__fsub_rn(p0[3 + a], p0[a]), frac, p0[a]);
  } else {  // static, const_velocity: base + vel t
    const float t_s = __fmul_rn(t_f, 1e-6f);
    for (int a = 0; a < 3; ++a)
      p[a] = xla_math::fma32(m.vel[3 * i + a], t_s, b[a]);
  }
}

// the link between positions a and b (replicated.py::geom_tables's entry,
// ops/propagation.py's compiled arithmetic): its rx power in W (0 for a
// node to itself) and detectability
__device__ __forceinline__ float link(const Mob& m, const float* a,
                                      const float* b, bool self, bool* det) {
  const float dx = __fsub_rn(a[0], b[0]), dy = __fsub_rn(a[1], b[1]),
              dz = __fsub_rn(a[2], b[2]);
  const float ss =
      xla_math::fma32(dz, dz, xla_math::fma32(dy, dy, __fmul_rn(dx, dx)));
  const float loss = xla_math::fma32(
      xla_math::xla_log(fmaxf(__fsqrt_rn(ss), 1.0f)), m.k_loss, m.ref_loss);
  if (det) *det = __fsub_rn(m.tx, loss) >= m.sens;
  return self ? 0.0f
              : xla_math::xla_exp10(__fmul_rn(__fsub_rn(m.tx30, loss), 0.1f));
}

// clip(round(x), 1, GAP_INF) as int32, round half to even
__device__ __forceinline__ int round_gap(float x) {
  return static_cast<int>(fminf(fmaxf(rintf(x), 1.0f), 1073741824.0f));
}

// the next gap of entity i (point p) after an arrival at t
// (traffic/device.py::entry_gaps): its own model's branch only
static __device__ __forceinline__ int traffic_gap(const Traffic& tr, int N,
                                               int p, int i, int t,
                                               uint32_t k0, uint32_t k1) {
  const int row = p * N + i;
  const int id = tr.id[row];
  const int tau = max(t - tr.start[row], 0);
  if (id == 1) {  // mmpp: the exponential gap at the epoch's rate
    const int e = min(tau / tr.epoch_us, tr.S - 1);
    const float rate = __fmul_rn(tr.rate[row], tr.epoch_rate[p * tr.S + e]);
    threefry::fold_in(k0, k1, static_cast<uint32_t>(i));
    threefry::fold_in(k0, k1, static_cast<uint32_t>(t));
    const float u = threefry::uniform(k0, k1, 0u);
    const float g = __fdiv_rn(
        -xla_math::xla_log1p(-fminf(u, static_cast<float>(1.0 - 1e-7))),
        fmaxf(rate, 1e-9f));
    return rate > 1e-9f ? round_gap(__fmul_rn(g, 1e6f)) : kInf;
  }
  if (id == 2) {  // onoff: the peak spacing in the burst, else the next one
    const int* on_start = tr.on_start + row * tr.C;
    int hits = 0;
    for (int k = 0; k < tr.C; ++k) hits += on_start[k] <= tau ? 1 : 0;
    const int c = min(max(hits - 1, 0), tr.C - 1);
    const int on_s = on_start[c];
    const int end = wrap_add(on_s, tr.on_len[row * tr.C + c]);
    const float pk = tr.peak[row * tr.C + c];
    const int p_us = round_gap(__fdiv_rn(1e6f, fmaxf(pk, 1e-9f)));
    const int next_c = min(c + 1, tr.C - 1);
    const int jump = next_c == c ? kInf : max(on_start[next_c] - tau, 1);
    const bool stays = tau >= on_s && tau < end &&
                       wrap_add(tau, p_us) < end && pk > 1e-9f;
    return stays ? p_us : jump;
  }
  if (id == 3) {  // trace: the next live entry
    const int* arr = tr.arr_t + row * tr.K;
    int idx = 0;
    for (int k = 0; k < tr.K; ++k) idx += (arr[k] < kInf && arr[k] <= t);
    const int nxt = arr[min(idx, tr.K - 1)];
    return idx < tr.K && nxt < kInf ? max(nxt - t, 1) : kInf;
  }
  return tr.interval[row];  // cbr
}

// the chain's value for a link of rx power sig with no interference (lone
// = 0 + noise): its success rate (legacy) or log1p(-pe) (AGG)
template <bool AGG>
__device__ __forceinline__ float lone_value(float sig, float lone,
                                            const Consts& c) {
  const float snr = __fdiv_rn(sig, lone);
  return AGG ? xla_math::nist_lg(snr, c.psr)
             : xla_math::nist_psr(snr, c.psr, c.nbits);
}

// MOB's refresh: every node's position at t into the row's shared slice,
// then each STA's link to the AP (its rx power, the same both ways, and
// detectability) and its lone value there, beside it, the STAs 1..N-1 a
// pass of the warp's 32 lanes at a time (the AP's own slot, its
// self-link, is the same at every time)
template <bool AGG>
__device__ __forceinline__ void refresh_links(const Mob& mob, const Consts& c,
                                              int t, int lane, float* s_pos,
                                              float* s_rx0, uint8_t* s_det0,
                                              float* s_lone_down) {
  const int N = c.N;
  const float lone = __fadd_rn(0.0f, c.noise_w);
  __syncwarp();
  for (int i = lane; i < N; i += 32) position(mob, N, i, t, s_pos + 3 * i);
  __syncwarp();
  for (int b = 1; b < N; b += 32) {
    const int i = b + lane, v = min(i, N - 1);
    bool d;
    const float rx = link(mob, s_pos + 3 * v, s_pos, false, &d);
    const float lv = lone_value<AGG>(rx, lone, c);
    if (i < N) {
      s_rx0[i] = rx;
      s_det0[i] = d ? 1 : 0;
      s_lone_down[i] = lv;
    }
  }
  __syncwarp();
}

// a drawn backoff: uniform * (cw + 1) in f32, truncated
__device__ __forceinline__ int draw_backoff(float u, int cw) {
  return __float2int_rz(__fmul_rn(u, static_cast<float>(cw + 1)));
}

// slot s of a lane's per-slot array: with S > 0 slots in registers a
// select over them (s may differ between lanes, so no register index),
// else (local memory) the element
template <int S, class T, int SM>
__device__ __forceinline__ T pick(const T (&a)[SM], int s) {
  if constexpr (S > 0) {
    T v = a[0];
#pragma unroll
    for (int k = 1; k < S; ++k) v = k == s ? a[k] : v;
    return v;
  } else {
    return a[s];
  }
}

template <int S, class T, int SM>
__device__ __forceinline__ void put(T (&a)[SM], int s, T v) {
  if constexpr (S > 0) {
#pragma unroll
    for (int k = 0; k < S; ++k) a[k] = k == s ? v : a[k];
  } else {
    a[s] = v;
  }
}

// f(s) for each slot s whose bit is set in `jobs`: every lane takes its
// lowest slot left, and the warp repeats while any lane has one, so the
// lanes' jobs run side by side
template <class F>
__device__ __forceinline__ void each_job(unsigned jobs, F&& f) {
  while (__any_sync(kFull, jobs != 0u)) {
    if (jobs != 0u) {
      const int s = __ffs(jobs) - 1;
      jobs &= jobs - 1u;
      f(s);
    }
  }
}

// the pairwise tree over a lane's P slot sums (P a power of two, the
// slots past the row's zero): tree_sum's levels above the 32 lanes
template <int S, int P>
__device__ __forceinline__ float slot_tree(float (&v)[P], int ns) {
  int w = 1;
  while (w < ns) w <<= 1;
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (k >= ns) v[k] = 0.0f;
  if constexpr (S > 0) {
#pragma unroll
    for (int h = P / 2; h >= 1; h >>= 1) {
#pragma unroll
      for (int k = 0; k < h; ++k)
        v[k] = __fadd_rn(v[2 * k], v[2 * k + 1]);
    }
  } else {
    for (int h = w / 2; h >= 1; h >>= 1)
      for (int k = 0; k < h; ++k) v[k] = __fadd_rn(v[2 * k], v[2 * k + 1]);
  }
  return v[0];
}

template <int S, bool AGG, bool MOB, bool TRF, bool PROF, bool OBS = false>
__global__ void __launch_bounds__(BSS_ROWS_PER_BLOCK * 32, 4)
    bss_advance_kernel(Consts c, Points pts, Mob mob, Traffic tr, StateIn si,
                       StateOut so, const long long* __restrict__ key,
                       int* done, int* t_next, uint8_t* pending, Grid g,
                       long long* prof, Obs ob) {
  // SM: a lane's slot arrays; P: the slot tree's width (a power of two)
  constexpr int SM = S > 0 ? S : BSS_MAX_N / 32;
  constexpr int P = SM <= 1 ? 1 : SM <= 2 ? 2 : SM <= 4 ? 4 : 32;
  const int N = c.N;
  const int ns = S > 0 ? S : (N + 31) >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pr = blockIdx.x * BSS_ROWS_PER_BLOCK + warp;  // (point, replica)
  if (pr >= g.rows) return;  // a ragged last block: the whole warp leaves
  const int point = pr / g.R, r = pr - point * g.R;
  const int sim_end = pts.sim_end[point];
  const int step0 = pts.step0[point];
  const long long qb = static_cast<long long>(pr) * N;

  // the row's slice of shared memory: per node the AP's downlink with no
  // interference (its success rate, or under AGG its log1p(-pe)), the AP's
  // link to the node (rx power), under MOB the positions (3 N), then the
  // AP's detectability bytes
  extern __shared__ __align__(16) unsigned char s_dyn[];
  float* s_lone_down = reinterpret_cast<float*>(s_dyn + warp * g.row_bytes);
  float* s_rx0 = s_lone_down + N;
  float* s_pos = s_rx0 + N;
  uint8_t* s_det0 = reinterpret_cast<uint8_t*>(s_pos + (MOB ? 3 * N : 0));

  // the lane's slots: state, constants, the link to the AP
  int next_arr[SM], queue[SM], ap_pend[SM], backoff[SM], hold[SM], cw[SM],
      retries[SM], cli[SM], interval[SM], stop[SM];
  float rx_to_ap[SM], lone_up[SM];
  unsigned imm = 0u, det_ap = 0u;  // bit s: slot s's flag
#pragma unroll
  for (int s = 0; s < ns; ++s) {
    const int i = s * 32 + lane;
    const bool valid = i < N;
    const long long q = qb + (valid ? i : 0);
    next_arr[s] = valid ? si.next_arr[q] : kInf;
    queue[s] = valid ? si.queue[q] : 0;
    ap_pend[s] = valid ? si.ap_pend[q] : 0;
    backoff[s] = valid ? si.backoff[q] : 0;
    hold[s] = valid ? si.hold[q] : 0;
    imm |= valid && si.immediate[q] != 0 ? 1u << s : 0u;
    cw[s] = valid ? si.cw[q] : kCwMin;
    retries[s] = valid ? si.retries[q] : 0;
    cli[s] = valid ? si.cli_rx[q] : 0;
    interval[s] = valid ? c.interval[i] : kInf;
    stop[s] = valid ? c.stop[i] : kInf;
    rx_to_ap[s] = 0.0f;
    lone_up[s] = 0.0f;
  }
  // OBS: the lane's nodes' FlowMonitor columns in its slot arrays (the
  // histogram stays in global memory: a delivery adds to one bin), and the
  // replica's failed exchanges
  int f_tx[OBS ? SM : 1], f_txb[OBS ? SM : 1], f_rx[OBS ? SM : 1],
      f_rxb[OBS ? SM : 1], f_lost[OBS ? SM : 1];
  float f_dsum[OBS ? SM : 1], f_jsum[OBS ? SM : 1], f_dlast[OBS ? SM : 1],
      f_t0[OBS ? SM : 1], f_t1[OBS ? SM : 1];
  int retx = 0;
  if constexpr (OBS) {
    retx = ob.retx[pr];
#pragma unroll
    for (int s = 0; s < ns; ++s) {
      const int i = s * 32 + lane;
      const long long q = qb + (i < N ? i : 0);
      f_tx[s] = ob.tx[q];
      f_txb[s] = ob.txb[q];
      f_rx[s] = ob.rx[q];
      f_rxb[s] = ob.rxb[q];
      f_lost[s] = ob.lost[q];
      f_dsum[s] = ob.dsum[q];
      f_jsum[s] = ob.jsum[q];
      f_dlast[s] = ob.dlast[q];
      f_t0[s] = ob.t0[q];
      f_t1[s] = ob.t1[q];
    }
  }
  // the chain's value for a link with no interference
  const float lone = __fadd_rn(0.0f, c.noise_w);
  int geom_t = si.geom_t[pr];
  // MOB: each lane's slots read their links to the AP (symmetric, so the
  // AP's to them too) and lone values back from the row's slice
  auto reload = [&]() {
#pragma unroll
    for (int s = 0; s < ns; ++s) {
      const int i = s * 32 + lane;
      if (i < N) {
        rx_to_ap[s] = s_rx0[i];
        lone_up[s] = s_lone_down[i];
        det_ap = s_det0[i] != 0 ? det_ap | 1u << s : det_ap & ~(1u << s);
      }
    }
  };
  // MOB: the geometry is rebuilt in the first step (at geom_t, where the
  // state's was built, or at the step's event if the stride falls there)
  bool stale = MOB;
  if (MOB) {
    // the AP's own slot: its self-link, the same at every position
    if (lane == 0) {
      const float origin[3] = {0.0f, 0.0f, 0.0f};
      bool d;
      const float self = link(mob, origin, origin, true, &d);
      s_rx0[0] = self;
      s_det0[0] = d ? 1 : 0;
      s_lone_down[0] = lone_value<AGG>(self, lone, c);
    }
  } else {
#pragma unroll
    for (int s = 0; s < ns; ++s) {
      const int i = s * 32 + lane, iv = min(i, N - 1);
      const float up = c.rx_w[iv * N], down = c.rx_w[iv];
      const float lu = lone_value<AGG>(up, lone, c);
      const float ld = lone_value<AGG>(down, lone, c);
      if (i < N) {
        rx_to_ap[s] = up;
        lone_up[s] = lu;
        det_ap |= c.det[iv * N] != 0 ? 1u << s : 0u;
        s_rx0[i] = down;
        s_det0[i] = c.det[iv];
        s_lone_down[i] = ld;
      }
    }
    __syncwarp();
  }
  // TRF: this replica's traffic key and its point's operand set
  const int tr_p = TRF && tr.multi ? point : 0;
  uint32_t tk0 = static_cast<uint32_t>(key[0]);
  uint32_t tk1 = static_cast<uint32_t>(key[1]);
  if (TRF) {
    threefry::fold_in(tk0, tk1, 0x7Au);
    threefry::fold_in(tk0, tk1, static_cast<uint32_t>(r));
  }
  // the replica's scalars, a copy in every lane
  int t = si.t[pr], bcn = si.bcn_pend[pr], busy = si.busy_until[pr];
  int srv = si.srv_rx[pr], txd = si.tx_data[pr], drops = si.drops[pr];

  const uint32_t key0 = static_cast<uint32_t>(key[0]);
  const uint32_t key1 = static_cast<uint32_t>(key[1]);
  uint32_t kb0 = 0u, kb1 = 0u, kc0 = 0u, kc1 = 0u;  // step (step & ~31) + lane
  int step = step0, ta = kInf, tc = kInf;
  bool pend = false;
  long long acc[BSS_PROF_STAGES] = {};
  long long clk = 0;
  auto stage = [&](int k) {
    if (PROF) {
      const long long now = clock64();
      acc[k] += now - clk;
      clk = now;
    }
  };

  for (;;) {
    if (PROF) clk = clock64();
    // the step's keys, derived 32 steps at a time
    const int j = (step - step0) & 31;
    if (j == 0) {
      uint32_t a0 = key0, a1 = key1;
      threefry::fold_in(a0, a1, static_cast<uint32_t>(step + lane));
      threefry::fold_in(a0, a1, static_cast<uint32_t>(r));
      kb0 = kc0 = a0;
      kb1 = kc1 = a1;
      threefry::fold_in(kb0, kb1, 0u);
      threefry::fold_in(kc0, kc1, 1u);
    }
    const uint32_t b0 = __shfl_sync(kFull, kb0, j);
    const uint32_t b1 = __shfl_sync(kFull, kb1, j);
    const uint32_t c0 = __shfl_sync(kFull, kc0, j);
    const uint32_t c1 = __shfl_sync(kFull, kc1, j);

    // 1. transmit instants, the next arrival, the AP's echo destination
    //    (under AGG packed with min(its pending echoes, K) in 7 bits)
    int tx_if[SM];
    int m_tx = kInf, m_arr = kInf, m_ed = AGG ? N << 7 : N;
#pragma unroll
    for (int s = 0; s < ns; ++s) {
      const int i = s * 32 + lane;
      const int base = max(busy, hold[s]);
      tx_if[s] = max((imm >> s) & 1u ? max(t, base)
                                     : base + c.aifs + backoff[s] * kSlot,
                     t);
      if (i != 0 && queue[s] > 0) m_tx = min(m_tx, tx_if[s]);
      m_arr = min(m_arr, next_arr[s]);
      if (ap_pend[s] > 0)
        m_ed = min(m_ed, AGG ? (i << 7) | min(ap_pend[s], c.K) : i);
    }
    const int tc_sta = __reduce_min_sync(kFull, m_tx);
    ta = __reduce_min_sync(kFull, m_arr);
    int ed = __reduce_min_sync(kFull, m_ed);
    const int tx0 = __shfl_sync(kFull, tx_if[0], 0);
    const int arr0 = __shfl_sync(kFull, next_arr[0], 0);
    const int k_ap = AGG ? ed & 127 : 0;
    if (AGG) ed >>= 7;
    const bool any_ap = ed < N;
    if (!any_ap) ed = 0;
    const bool frame0 = bcn > 0 || any_ap;
    tc = min(tc_sta, frame0 ? tx0 : kInf);
    pend = t < sim_end && min(ta, tc) < sim_end;
    if (!pend || step >= g.step1) break;

    // here t < sim_end and the next event is before it
    const int next_t = min(ta, tc);
    const bool arrived = ta <= tc && ta < kInf;
    const bool transmit = tc < ta && tc < kInf;
    // node 0's arrival (a beacon), its new count, and whether the AP wins
    const int bcn1 = bcn + (arrived && arr0 == next_t ? 1 : 0);
    const bool ap_wins = transmit && frame0 && tx0 == next_t;
    const bool ap_beacon = ap_wins && bcn > 0;
    // the echo destination's sum is read only when the AP sends it data
    const bool ed_read = ap_wins && bcn == 0;
    stage(0);

    // the geometry at this replica's next event, every stride steps
    if (MOB && (stale || step % mob.stride == 0)) {
      const bool due = step % mob.stride == 0;
      refresh_links<AGG>(mob, c, due ? next_t : geom_t, lane, s_pos, s_rx0,
                         s_det0, s_lone_down);
      reload();
      if (due) geom_t = next_t;
      stale = false;
    }
    if (MOB) stage(1);

    // 2. each slot's part: an arrival, a head-of-line grant, a win, an
    //    interrupted grant; which of them need the backoff draw
    unsigned arr_m = 0u, win_m = 0u, back_m = 0u, data_m = 0u;
    unsigned imm1 = imm;
    int queue1[SM];
#pragma unroll
    for (int s = 0; s < ns; ++s) {
      const int i = s * 32 + lane;
      const bool is_ap = i == 0;
      const bool frame = is_ap ? frame0 : i < N && queue[s] > 0;
      const bool is_arr = arrived && next_arr[s] == next_t;
      queue1[s] = queue[s] + (is_arr && !is_ap ? 1 : 0);
      const bool frame_after =
          is_arr ? (is_ap ? (bcn1 > 0 || any_ap) : queue1[s] > 0) : frame;
      const bool hol = is_arr && !frame && frame_after;
      const bool imm_grant = hol && next_t >= busy + c.aifs;
      const bool winner = transmit && frame && tx_if[s] == next_t;
      const bool imm_s = (imm >> s) & 1u;
      const bool interrupted = frame && !winner && transmit && imm_s;
      const unsigned bit = 1u << s;
      arr_m |= is_arr ? bit : 0u;
      win_m |= winner ? bit : 0u;
      back_m |= (hol && !imm_grant) || interrupted || winner ? bit : 0u;
      data_m |= winner && !(is_ap && ap_beacon) ? bit : 0u;
      if (hol) imm1 = imm_grant ? imm1 | bit : imm1 & ~bit;
      if (interrupted || winner) imm1 &= ~bit;
    }
    // the winners: one ballot word per slot
    unsigned wb[SM];
    unsigned any_w = 0u;
#pragma unroll
    for (int s = 0; s < ns; ++s) {
      wb[s] = __ballot_sync(kFull, (win_m >> s) & 1u);
      any_w |= wb[s];
    }
    const bool any_win = any_w != 0u;
    const bool win0 = (wb[0] & 1u) != 0u;
    const bool win_ed = ((pick<S>(wb, ed >> 5) >> (ed & 31)) & 1u) != 0u;

    // the winners' links to the echo destination: the AP's (a winner in
    // every step that reads them) is its link to the destination, in the
    // row's slice; another winner's is loaded (issued now) or, under MOB,
    // computed below
    float to_ed[SM];
#pragma unroll
    for (int s = 0; s < ns; ++s) to_ed[s] = 0.0f;
    const unsigned sta_win = win_m & (lane == 0 ? ~1u : ~0u);
    if (ed_read) {
      if (lane == 0) to_ed[0] = s_rx0[ed];
      if (!MOB) {
#pragma unroll
        for (int s = 0; s < ns; ++s)
          if ((sta_win >> s) & 1u) to_ed[s] = c.rx_w[(s * 32 + lane) * N + ed];
      }
    }

    // the step's draws: each lane's first slot that needs one, hashed now
    // (its backoff uniform and, for a data frame in the legacy arm, its
    // coin), under the winners' sums
    float u_back[SM], u_coin[SM];
    unsigned todo = back_m;
    {
      const int s = todo != 0u ? __ffs(todo) - 1 : 0;
      const uint32_t node = static_cast<uint32_t>(s * 32 + lane);
      const float ub = threefry::uniform(b0, b1, node);
      put<S>(u_back, s, ub);
      if (!AGG) put<S>(u_coin, s, threefry::uniform(c0, c1, node));
      todo &= todo - 1u;
    }

    // the power the winners put at the AP and at the echo destination,
    // tree_sum's order: each slot's 32 lanes, then the slots
    float at_ap = 0.0f, at_ed = 0.0f;
    if (MOB && ed_read) {
      each_job(sta_win, [&](int s) {
        const int i = s * 32 + lane;
        put<S>(to_ed, s, link(mob, s_pos + 3 * i, s_pos + 3 * ed, i == ed,
                              nullptr));
      });
    }
    if (any_win) {
      float va[P], ve[P];
#pragma unroll
      for (int s = 0; s < ns; ++s) {
        va[s] = (win_m >> s) & 1u ? rx_to_ap[s] : 0.0f;
        ve[s] = to_ed[s];
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int s = 0; s < ns; ++s) {
          va[s] = __fadd_rn(va[s], __shfl_down_sync(kFull, va[s], off));
          ve[s] = __fadd_rn(ve[s], __shfl_down_sync(kFull, ve[s], off));
        }
      }
      at_ap = __shfl_sync(kFull, slot_tree<S>(va, ns), 0);
      at_ed = __shfl_sync(kFull, slot_tree<S>(ve, ns), 0);
    }
    stage(2);

    // the draws a lane has past its first (two slots in one step), then
    // the arrivals' next gaps (TRF: from each arriving node's workload)
    each_job(todo, [&](int s) {
      const uint32_t node = static_cast<uint32_t>(s * 32 + lane);
      put<S>(u_back, s, threefry::uniform(b0, b1, node));
      if (!AGG) put<S>(u_coin, s, threefry::uniform(c0, c1, node));
    });
    int gap[SM];
    if (TRF) {
      each_job(arr_m, [&](int s) {
        put<S>(gap, s, traffic_gap(tr, N, tr_p, s * 32 + lane,
                                   pick<S>(next_arr, s), tk0, tk1));
      });
    }
    stage(3);

    // 3. the PHY: beacons outrank echoes; a gated data frame's coins vs its
    //    success rate (under AGG an A-MPDU of the backlog, up to K, whose
    //    airtime and nbits grow with its size k)
    const bool det_ed = s_det0[ed] != 0;
    const float sig_ed = s_rx0[ed], lone_ed = s_lone_down[ed];
    unsigned gated_m = 0u;
    int k_agg[SM], dur[SM];
#pragma unroll
    for (int s = 0; s < ns; ++s) {
      const int i = s * 32 + lane;
      const bool is_ap = i == 0;
      const bool det = is_ap ? det_ed : ((det_ap >> s) & 1u) != 0u;
      const bool dst_idle = is_ap ? !win_ed : !win0;
      gated_m |= (data_m >> s) & 1u && det && dst_idle ? 1u << s : 0u;
      k_agg[s] = 1;
      dur[s] = c.data_dur;
      if (AGG) {
        k_agg[s] = max(is_ap ? k_ap : min(queue[s], c.K), 1);
        const float x = __fadd_rn(
            __fmul_rn(static_cast<float>(k_agg[s]), c.sub8), 22.0f);
        dur[s] = __float2int_rz(__fmul_rn(ceilf(__fmul_rn(x, c.inv_ndbps)),
                                          4.0f)) + c.preamble;
      }
    }
    // a gated frame's success rate (per subframe), one frame a lane at a
    // time: the chain only for a frame with another on the air
    float rate[SM];
    each_job(gated_m, [&](int s) {
      const bool is_ap = s == 0 && lane == 0;
      const float sig = is_ap ? sig_ed : pick<S>(rx_to_ap, s);
      const float interf = __fsub_rn(is_ap ? at_ed : at_ap, sig);
      const float lone_v = is_ap ? lone_ed : pick<S>(lone_up, s);
      float v;
      if (AGG) {
        const float lg =
            interf == 0.0f
                ? lone_v
                : xla_math::nist_lg(
                      __fdiv_rn(sig, __fadd_rn(interf, c.noise_w)), c.psr);
        v = xla_math::mpdu_rate(
            lg, __fmul_rn(c.rate, static_cast<float>(pick<S>(dur, s))),
            pick<S>(k_agg, s));
      } else {
        v = interf == 0.0f
                ? lone_v
                : xla_math::nist_psr(
                      __fdiv_rn(sig, __fadd_rn(interf, c.noise_w)), c.psr,
                      c.nbits);
      }
      put<S>(rate, s, v);
    });
    int n_ok[SM];
#pragma unroll
    for (int s = 0; s < ns; ++s) {
      n_ok[s] = 0;
      if (!AGG && (gated_m >> s) & 1u) n_ok[s] = u_coin[s] < rate[s] ? 1 : 0;
    }
    if (AGG) {
      // each gated frame of the row in turn, its k coins over the lanes
#pragma unroll
      for (int s = 0; s < ns; ++s) {
        unsigned frames = __ballot_sync(kFull, (gated_m >> s) & 1u);
        while (frames != 0u) {
          const int src = __ffs(frames) - 1;
          frames &= frames - 1u;
          const float p = __shfl_sync(kFull, rate[s], src);
          const int k = __shfl_sync(kFull, k_agg[s], src);
          const uint32_t first = static_cast<uint32_t>((s * 32 + src) * c.K);
          const bool ok_lo =
              lane < k &&
              threefry::uniform(c0, c1, first + static_cast<uint32_t>(lane)) <
                  p;
          const bool ok_hi =
              lane + 32 < k &&
              threefry::uniform(c0, c1,
                                first + static_cast<uint32_t>(lane + 32)) < p;
          const int count = __popc(__ballot_sync(kFull, ok_lo)) +
                            __popc(__ballot_sync(kFull, ok_hi));
          if (lane == src) n_ok[s] = count;
        }
      }
    }
    stage(4);

    // 4. the outcome: each slot's, then the row's counts, the medium's
    //    occupancy and node 0's outcome
    const int idle = next_t - busy - c.aifs;
    const int elapsed = idle < 0 ? 0 : idle / kSlot;
    int drop_n[SM];
    int w_ok = 0, w_drop = 0, w_data = 0, w_occ = 0;
    // OBS: the failed exchanges, the lane's best delivering node and first
    // winner (the ring row's argmax), the step's time in seconds
    int w_fail = 0, w_best = 0, w_first = kInf;
    const float obs_ts = OBS ? __fmul_rn(static_cast<float>(next_t), 1e-6f)
                             : 0.0f;
#pragma unroll
    for (int s = 0; s < ns; ++s) {
      const int i = s * 32 + lane;
      const bool is_ap = i == 0;
      const unsigned bit = 1u << s;
      const bool winner = (win_m & bit) != 0u;
      const bool data_tx = (data_m & bit) != 0u;
      const bool beacon_tx = winner && !data_tx;
      const bool is_arr = (arr_m & bit) != 0u;
      const bool frame = is_ap ? frame0 : i < N && queue[s] > 0;
      const bool success = data_tx && n_ok[s] > 0;
      const bool fail = data_tx && n_ok[s] == 0;
      const bool dropped = fail && retries[s] + 1 > kRetryLimit;
      drop_n[s] = dropped ? k_agg[s] : 0;
      if constexpr (OBS) {
        // the node's FlowMonitor columns (replicated.py::obs_step): an
        // exchange sends k_agg MPDUs, delivers n_ok, its delay dur us
        const int tx = data_tx ? k_agg[s] : 0, rx = n_ok[s];
        if (i < N && (tx > 0 || rx > 0 || drop_n[s] > 0)) {
          const float delay = __fmul_rn(static_cast<float>(dur[s]), 1e-6f);
          f_tx[s] += tx;
          f_txb[s] += tx * ob.pkt;
          f_rx[s] += rx;
          f_rxb[s] += rx * ob.pkt;
          f_lost[s] += drop_n[s];
          f_dsum[s] = __fadd_rn(f_dsum[s],
                                __fmul_rn(delay, static_cast<float>(rx)));
          f_jsum[s] = __fadd_rn(f_jsum[s],
                                rx > 0 && f_dlast[s] >= 0.0f
                                    ? fabsf(__fsub_rn(delay, f_dlast[s]))
                                    : 0.0f);
          if (rx > 0) {
            f_dlast[s] = delay;
            f_t1[s] = obs_ts;
            const int bin = min(
                max(__float2int_rz(__fmul_rn(delay, ob.scale)), 0),
                kObsBins - 1);
            ob.hist[(qb + i) * kObsBins + bin] += rx;
          }
          if (tx > 0 && f_t0[s] < 0.0f) f_t0[s] = obs_ts;
        }
        w_fail += fail ? 1 : 0;
        w_best = max(w_best, rx > 0 ? (rx << 16) | (0xFFFF - i) : 0);
        if (winner) w_first = min(w_first, i);
      }
      const bool reset = success || dropped || beacon_tx;
      const int retries1 = reset ? 0 : retries[s] + (fail ? 1 : 0);
      const int cw1 =
          reset ? kCwMin : (fail ? min(2 * (cw[s] + 1) - 1, kCwMax) : cw[s]);
      // the backoff: a head-of-line draw, the countdown credit or an
      // interrupted grant's redraw of the other contenders, a winner's
      // redraw
      // (a slot with no frame draws only as a head of line with no grant)
      const bool hol_draw = is_arr && !frame && (back_m & bit) != 0u;
      const bool contending = frame && !winner && transmit;
      const bool imm_s = (imm & bit) != 0u;
      int backoff1 = hol_draw ? draw_backoff(u_back[s], cw[s]) : backoff[s];
      if (contending && !imm_s) backoff1 = max(backoff1 - elapsed, 0);
      if (contending && imm_s) backoff1 = draw_backoff(u_back[s], cw[s]);
      if (winner) backoff1 = draw_backoff(u_back[s], cw1);
      const int exch = dur[s] + kSifs + c.resp_dur;
      const int occ = success ? exch : (beacon_tx ? c.exch_beacon : dur[s]);
      hold[s] = fail ? next_t + exch + kSlot + 4
                     : (winner ? next_t + occ : hold[s]);
      const int sta_ok = is_ap ? 0 : n_ok[s];
      w_ok += sta_ok;
      w_drop += drop_n[s];
      w_data += data_tx ? 1 : 0;
      w_occ = max(w_occ, winner ? occ : 0);
      backoff[s] = backoff1;
      cw[s] = cw1;
      retries[s] = retries1;
      queue[s] = max(queue1[s] - sta_ok - (is_ap ? 0 : drop_n[s]), 0);
      if (TRF) {
        int adv = is_arr ? wrap_add(next_arr[s], gap[s]) : kInf;
        if (adv >= stop[s]) adv = kInf;
        if (is_arr) next_arr[s] = adv;
      } else if (is_arr) {
        int adv = next_arr[s] >= kInf ? kInf : next_arr[s] + interval[s];
        next_arr[s] = adv >= stop[s] ? kInf : adv;
      }
    }
    if constexpr (OBS) {
      // the ring row of the step (replicated.py::obs_step): the first node
      // with the most deliveries, else the first winner
      retx += __reduce_add_sync(kFull, w_fail);
      const int best = __reduce_max_sync(kFull, w_best);
      const int first = __reduce_min_sync(kFull, w_first);
      if (lane == 0) {
        int* w = ob.ring +
                 (static_cast<long long>(pr) * kRingCap + step % kRingCap) *
                     kRingCols;
        w[0] = any_win ? step : -1;
        w[1] = next_t;
        w[2] = best > 0 ? 0xFFFF - (best & 0xFFFF) : (any_win ? first : 0);
        w[3] = ob.pkt;
        w[4] = best > 0 ? 1 : 0;
      }
    }
    const int n_sta_ok = __reduce_add_sync(kFull, w_ok);
    const int n_drop = __reduce_add_sync(kFull, w_drop);
    const int n_data = __reduce_add_sync(kFull, w_data);
    const int max_occ = __reduce_max_sync(kFull, w_occ);
    const int got_echo = __shfl_sync(kFull, n_ok[0], 0);
    const int drop_echo = __shfl_sync(kFull, drop_n[0], 0);
    bcn = max(bcn1 - (ap_beacon ? 1 : 0), 0);
    srv += n_sta_ok;
    drops += n_drop;
    txd += n_data;
    if (any_win) busy = next_t + max_occ;
    t = max(next_t, t);
#pragma unroll
    for (int s = 0; s < ns; ++s) {
      const int i = s * 32 + lane;
      const int at_me = i == ed ? 1 : 0;
      const int sta_ok = i == 0 ? 0 : n_ok[s];
      ap_pend[s] =
          max(ap_pend[s] + sta_ok - at_me * got_echo - at_me * drop_echo, 0);
      cli[s] += at_me * got_echo;
    }
    imm = imm1;
    ++step;
    stage(5);
  }

#pragma unroll
  for (int s = 0; s < ns; ++s) {
    const int i = s * 32 + lane;
    if (i < N) {
      const long long q = qb + i;
      so.next_arr[q] = next_arr[s];
      so.queue[q] = queue[s];
      so.ap_pend[q] = ap_pend[s];
      so.backoff[q] = backoff[s];
      so.hold[q] = hold[s];
      so.immediate[q] = (imm >> s) & 1u ? 1 : 0;
      so.cw[q] = cw[s];
      so.retries[q] = retries[s];
      so.cli_rx[q] = cli[s];
      if constexpr (OBS) {
        ob.tx[q] = f_tx[s];
        ob.txb[q] = f_txb[s];
        ob.rx[q] = f_rx[s];
        ob.rxb[q] = f_rxb[s];
        ob.lost[q] = f_lost[s];
        ob.dsum[q] = f_dsum[s];
        ob.jsum[q] = f_jsum[s];
        ob.dlast[q] = f_dlast[s];
        ob.t0[q] = f_t0[s];
        ob.t1[q] = f_t1[s];
      }
    }
  }
  if constexpr (OBS)
    if (lane == 0) ob.retx[pr] = retx;
  if (lane == 0) {
    so.t[pr] = t;
    so.bcn_pend[pr] = bcn;
    so.busy_until[pr] = busy;
    so.srv_rx[pr] = srv;
    so.tx_data[pr] = txd;
    so.drops[pr] = drops;
    so.geom_t[pr] = geom_t;
    done[pr] = step;
    pending[pr] = pend ? 1 : 0;
    t_next[pr] = t < sim_end ? max(t, min(ta, tc)) : t;
    if (PROF)
      for (int k = 0; k < BSS_PROF_STAGES; ++k)
        prof[static_cast<long long>(pr) * BSS_PROF_STAGES + k] = acc[k];
  }
}

// everything one launch takes
struct Launch {
  Consts c;
  Points pts;
  Mob mob;
  Traffic tr;
  StateIn si;
  StateOut so;
  const long long* key;
  int *done, *t_next;
  uint8_t* pending;
  Grid g;
  long long* prof;
  int blocks, shared;
  cudaStream_t st;
  Obs ob;  // the OBS arm's (its pointers null otherwise)
};

template <int S, bool AGG, bool MOB, bool TRF, bool PROF, bool OBS = false>
inline cudaError_t launch(const Launch& a) {
  if (a.shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bss_advance_kernel<S, AGG, MOB, TRF, PROF, OBS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, a.shared);
    if (e != cudaSuccess) return e;
  }
  Launch k = a;  // the kernel's arguments, by address
  void* args[] = {&k.c,    &k.pts,    &k.mob,     &k.tr, &k.si,
                  &k.so,   &k.key,    &k.done,    &k.t_next,
                  &k.pending, &k.g,   &k.prof,    &k.ob};
  const cudaError_t e = cudaLaunchKernel(
      bss_advance_kernel<S, AGG, MOB, TRF, PROF, OBS>, dim3(a.blocks),
      dim3(BSS_ROWS_PER_BLOCK * 32), args, a.shared, a.st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the arm (AGG, MOB, TRF) of slot count S; the probe only for the bench's
// slot count and one arm at a time; OBS (with the FlowMonitor columns) any
// arm but the probe
template <int S, bool PROF, bool OBS = false>
inline cudaError_t launch_arm(bool agg, bool mob, bool trf, const Launch& a) {
  if constexpr (OBS) {
    if (agg) {
      if (mob) return trf ? launch<S, true, true, true, false, true>(a)
                          : launch<S, true, true, false, false, true>(a);
      return trf ? launch<S, true, false, true, false, true>(a)
                 : launch<S, true, false, false, false, true>(a);
    }
    if (mob) return trf ? launch<S, false, true, true, false, true>(a)
                        : launch<S, false, true, false, false, true>(a);
    return trf ? launch<S, false, false, true, false, true>(a)
               : launch<S, false, false, false, false, true>(a);
  } else if constexpr (PROF) {
    if (agg + mob + trf > 1) return cudaErrorInvalidValue;
    if (agg) return launch<S, true, false, false, true>(a);
    if (mob) return launch<S, false, true, false, true>(a);
    if (trf) return launch<S, false, false, true, true>(a);
    return launch<S, false, false, false, true>(a);
  } else {
    if (agg) {
      if (mob) return trf ? launch<S, true, true, true, false>(a)
                          : launch<S, true, true, false, false>(a);
      return trf ? launch<S, true, false, true, false>(a)
                 : launch<S, true, false, false, false>(a);
    }
    if (mob) return trf ? launch<S, false, true, true, false>(a)
                        : launch<S, false, true, false, false>(a);
    return trf ? launch<S, false, false, true, false>(a)
               : launch<S, false, false, false, false>(a);
  }
}

// a row's slice of dynamic shared memory (bss_cuda.py::launch_geometry):
// two floats a node (under MOB five), a byte a node, rounded up to 16
inline int row_bytes(int N, bool mob) {
  const int b = (mob ? 5 : 2) * 4 * N + N;
  return (b + 15) / 16 * 16;
}

// each slot count's arms, one translation unit each (bss_advance_s*.cu;
// 0: past BSS_REG_SLOTS, the slots in local memory), and the probe
cudaError_t launch_slots1(bool agg, bool mob, bool trf, const Launch& a);
cudaError_t launch_slots2(bool agg, bool mob, bool trf, const Launch& a);
cudaError_t launch_slots3(bool agg, bool mob, bool trf, const Launch& a);
cudaError_t launch_slots4(bool agg, bool mob, bool trf, const Launch& a);
cudaError_t launch_slots0(bool agg, bool mob, bool trf, const Launch& a);
cudaError_t launch_probe(bool agg, bool mob, bool trf, const Launch& a);
// the OBS arm of each slot count, one translation unit each
// (bss_advance_obs_s*.cu)
cudaError_t launch_obs1(bool agg, bool mob, bool trf, const Launch& a);
cudaError_t launch_obs2(bool agg, bool mob, bool trf, const Launch& a);
cudaError_t launch_obs3(bool agg, bool mob, bool trf, const Launch& a);
cudaError_t launch_obs4(bool agg, bool mob, bool trf, const Launch& a);
cudaError_t launch_obs0(bool agg, bool mob, bool trf, const Launch& a);

}  // namespace bss_kernel

