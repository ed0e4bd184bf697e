// bss_advance.cu — the WiFi BSS replica engine's event loop, every step of
// a chunk for every replica, in one persistent launch.
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
// Design, for the H100:
// - One CTA per (replica, point), one thread per node (blockDim = N rounded
//   up to 32, N <= 1024); blockIdx.y is the point of a horizon sweep, with
//   its own horizon and first step (passed by value) and, in a workload
//   sweep, its own traffic operands; every point's replica r draws
//   replica r's streams.  A node's state (next_arr, queue,
//   ap_pend, backoff, hold, immediate, cw, retries, cli_rx) lives in
//   registers for the launch; the replica's scalars (t, bcn_pend,
//   busy_until, srv_rx, tx_data, drops) are held by every thread, which all
//   update them alike.  State is read from HBM once and written once.
// - The loop runs in the kernel.  Each CTA stops when its own replica is no
//   longer pending (no event before its horizon) or at the step bound: a
//   finished replica is a fixed point of step_fn but for t, so no CTA waits
//   for another.  On the way out it writes its stop step (`done`) and the t
//   one more step would give it (`t_next`); the wrapper
//   (parallel/bss_cuda.py) takes the largest stop of each point as that
//   point's step count and gives t_next to the replicas that stopped before
//   it, as the reference's loop would.
// - Draws: step s, replica r: k = split(fold_in(fold_in(key, s), r)),
//   uniform(k[0], (N,)) for backoffs and uniform(k[1], (N,)) for coins, or
//   under AGG uniform(k[1], (N, K)), flat index i K + j (random.py::
//   bss_draws), in uint32 threefry2x32.  Every 32 steps lane l of each warp
//   derives step s + l's two keys (four hashes); each step shuffles them
//   across the warp, and a thread hashes its own node's draw only when the
//   step needs it (a new head of line, an interrupted grant, a winner's
//   redraw; a gated frame's coin).  Under AGG a gated frame's k coins are
//   spread over its warp: lane j hashes subframes j and j + 32, and two
//   ballots count the decoded ones, so the frame waits for two hashes, not
//   k.
// - Three barriers a step, each one block reduction (warp shuffles, one
//   shared slot per warp, every thread folding the slots itself):
//   1. the earliest STA transmit instant, the earliest arrival, the lowest
//      node with an echo pending (the AP's destination; under AGG packed
//      with its pending count, the AP's A-MPDU size); thread 0 publishes
//      its own transmit instant, which counts once the reduction says
//      whether the AP has a frame;
//   2. the winners (one ballot word per warp) and the power each winner puts
//      at the AP and at the echo destination, summed as a pairwise tree
//      (within the warp, then over the warps' slots): replicated.py::
//      tree_sum's order, so the plain version rounds alike;
//   3. the outcome counts (MPDUs decoded at the AP, MPDUs dropped, data
//      frames), the longest occupancy, and node 0's outcome (its echoes
//      decoded or dropped, the new beacon count).
// - The PHY of a gated frame: SINR = sig / ((at_dst - sig) + noise) and
//   the NIST chain in xla_math.cuh's arithmetic, then the coins.  A frame
//   with no interference (a lone sender: at_dst - sig == 0) has the SINR
//   sig / noise of its own link, so the chain's SNR part (the success rate
//   itself in the legacy arm, log1p(-pe) under AGG) is one of 2N per
//   program: each thread computes its node's uplink and downlink values
//   once, before the loop (the downlinks in shared memory), and the chain
//   runs in the loop only for frames that overlap others.  Under AGG the
//   k-dependent tail (the A-MPDU's airtime, nbits, two products, a
//   division and exp) runs for every gated frame: about 30 operations, so
//   a (node, k) table of 2 N K rates would save little and cost 2 N K
//   exps before the loop.
//
// - MOB (a mobile program): every `stride` steps (step % stride == 0, the
//   same for the whole CTA, so the barrier under it is uniform) each thread
//   computes its node's position at the replica's next_t into shared memory
//   (the model dispatched by its id: const_velocity and static, the random
//   walk folded into its box, waypoints), then its own link to the AP: the
//   rx power and detectability (the link is symmetric bit for bit, so it is
//   the AP's link to the node too, kept in shared memory for the AP's
//   frames) and the chain's values with no interference.  No (N, N) table
//   is kept: a winner computes its link to the echo destination in a step
//   where the AP sends it data (the one frame that reads that sum).  The
//   refresh time rides in the state (geom_t), so a launch rebuilds the
//   positions it starts from.  The lone-sender values are recomputed at
//   every refresh (one chain a thread), not skipped: a refresh costs one
//   chain's latency, where skipping would put a chain on every gated
//   lone frame's path.
// - TRF (a traffic program): an arriving node computes its next gap from
//   its own model's branch (cbr interval, mmpp exponential at the epoch's
//   rate with its three threefry hashes, onoff burst spacing or jump, trace
//   lookup), its rows of the operand tables read from global memory; the
//   replica's traffic key fold_in(fold_in(key, 0x7A), r) is derived once
//   per launch.  A workload sweep's points (blockIdx.y) each read their own
//   operand set.
//
// Bound (bench: N = 65, R = 512, ~3,200 steps): the state is 0.2 MB each
// way, so the work bounds: per replica-step about 20 threefry hashes (the
// keys amortised, the draws a step needs), three block reductions and, for
// the frames on air, one PSR chain (~400 operations), under AGG k hashes a
// gated frame, under MOB per refresh a position, a link and a chain a node
// and a link per winner of the AP's data steps, under TRF three hashes an
// mmpp gap; the chip_smoke script counts them from the run.  With 512 CTAs
// of 3 warps the time is each step's chain of dependent stages, not
// throughput: under MOB a refresh puts a lone-sender chain on the path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"
#include "xla_math.cuh"

#define BSS_MAX_N 1024
// the last step a launch may reach: step + 31 (a lane's lookahead) stays
// below 2^31
#define BSS_MAX_STEP 2147483000
// horizons one launch holds (the grid's y extent)
#define BSS_MAX_POINTS 64
// the A-MPDU cap: two coins per lane
#define BSS_MAX_MPDUS 64

namespace {

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
  int multi;               // 1: point blockIdx.y reads set blockIdx.y
};

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
__device__ void position(const Mob& m, int N, int i, int t, float* p) {
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
__device__ int traffic_gap(const Traffic& tr, int N, int p, int i, int t,
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

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = min(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = max(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// the pairwise tree sum of the warp's 32 values (pairs of neighbours, then
// pairs of pairs, ...), valid in lane 0, broadcast to the warp
__device__ __forceinline__ float warp_tree_sum(float x) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    x = __fadd_rn(x, __shfl_down_sync(kFull, x, off));
  return __shfl_sync(kFull, x, 0);
}

// a drawn backoff: uniform * (cw + 1) in f32, truncated
__device__ __forceinline__ int draw_backoff(float u, int cw) {
  return __float2int_rz(__fmul_rn(u, static_cast<float>(cw + 1)));
}

template <bool AGG, bool MOB, bool TRF>
__global__ void __launch_bounds__(BSS_MAX_N)
    bss_advance_kernel(Consts c, Points pts, Mob mob, Traffic tr, StateIn si,
                       StateOut so, const long long* __restrict__ key,
                       int* done, int* t_next, uint8_t* pending, int step1) {
  __shared__ int s_tx[32], s_arr[32], s_ed[32], s_tx0;      // barrier 1
  __shared__ unsigned s_win[32];                            // barrier 2
  __shared__ float s_at_ap[32], s_at_ed[32];
  __shared__ int s_ok[32], s_drop[32], s_data[32], s_occ[32];  // barrier 3
  __shared__ int s_node0[3];
  // per node (dynamic, N each): AP -> node i alone on the air, its success
  // rate (legacy) or its log1p(-pe) (AGG); under MOB also the AP's link to
  // node i (rx power), the positions (3 N) and the AP's detectability
  extern __shared__ float s_dyn[];
  const int N = c.N;
  float* s_lone_down = s_dyn;
  float* s_rx0 = s_dyn + N;
  float* s_pos = s_dyn + 2 * N;
  uint8_t* s_det0 = reinterpret_cast<uint8_t*>(s_dyn + 5 * N);

  const int r = blockIdx.x, i = threadIdx.x;
  const int pr = blockIdx.y * gridDim.x + r;  // (point, replica) row
  const int sim_end = pts.sim_end[blockIdx.y];
  const int step0 = pts.step0[blockIdx.y];
  const int lane = i & 31, warp = i >> 5, nw = blockDim.x >> 5;
  const bool valid = i < N, is_ap = i == 0;
  const long long q = static_cast<long long>(pr) * N + (valid ? i : 0);

  // this node's state and constants
  int next_arr = valid ? si.next_arr[q] : kInf;
  int queue = valid ? si.queue[q] : 0;
  int ap_pend = valid ? si.ap_pend[q] : 0;
  int backoff = valid ? si.backoff[q] : 0;
  int hold = valid ? si.hold[q] : 0;
  bool imm = valid && si.immediate[q] != 0;
  int cw = valid ? si.cw[q] : kCwMin;
  int retries = valid ? si.retries[q] : 0;
  int cli = valid ? si.cli_rx[q] : 0;
  const int interval = valid ? c.interval[i] : kInf;
  const int stop = valid ? c.stop[i] : kInf;
  // the chain's values for this node's links with no interference
  const float lone = __fadd_rn(0.0f, c.noise_w);
  auto lone_value = [&](float sig) {
    const float snr = __fdiv_rn(sig, lone);
    return AGG ? xla_math::nist_lg(snr, c.psr)
               : xla_math::nist_psr(snr, c.psr, c.nbits);
  };
  float rx_to_ap = 0.0f, lone_up = 0.0f;
  bool det_to_ap = false;
  int geom_t = si.geom_t[pr];
  // MOB: the positions at t_ref, then this node's link to the AP (both
  // ways) and its lone values; every thread calls it (a barrier inside)
  auto refresh = [&](int t_ref) {
    if (valid) position(mob, N, i, t_ref, s_pos + 3 * i);
    __syncthreads();
    if (valid) {
      rx_to_ap = link(mob, s_pos + 3 * i, s_pos, is_ap, &det_to_ap);
      lone_up = lone_value(rx_to_ap);
      s_rx0[i] = rx_to_ap;
      s_det0[i] = det_to_ap ? 1 : 0;
      s_lone_down[i] = lone_up;
    }
  };
  if (MOB) {
    refresh(geom_t);
  } else if (valid) {
    rx_to_ap = c.rx_w[i * N];
    det_to_ap = c.det[i * N] != 0;
    lone_up = lone_value(rx_to_ap);
    s_lone_down[i] = lone_value(c.rx_w[i]);
  }
  // TRF: this replica's traffic key and its point's operand set
  const int tr_p = TRF && tr.multi ? blockIdx.y : 0;
  uint32_t tk0 = static_cast<uint32_t>(key[0]);
  uint32_t tk1 = static_cast<uint32_t>(key[1]);
  if (TRF) {
    threefry::fold_in(tk0, tk1, 0x7Au);
    threefry::fold_in(tk0, tk1, static_cast<uint32_t>(r));
  }
  // the replica's scalars, a copy in every thread
  int t = si.t[pr], bcn = si.bcn_pend[pr], busy = si.busy_until[pr];
  int srv = si.srv_rx[pr], txd = si.tx_data[pr], drops = si.drops[pr];

  const uint32_t key0 = static_cast<uint32_t>(key[0]);
  const uint32_t key1 = static_cast<uint32_t>(key[1]);
  uint32_t kb0 = 0u, kb1 = 0u, kc0 = 0u, kc1 = 0u;  // step (step & ~31) + lane
  int step = step0, ta = kInf, tc = kInf;
  bool pend = false;

  for (;;) {
    // 1. transmit instants, the next arrival, the AP's echo destination
    //    (under AGG packed with min(its pending echoes, K) in 7 bits)
    const int base = max(busy, hold);
    const int tx_if =
        max(imm ? max(t, base) : base + c.aifs + backoff * kSlot, t);
    const bool sta_frame = valid && !is_ap && queue > 0;
    const int m_tx = warp_min(sta_frame ? tx_if : kInf);
    const int m_arr = warp_min(next_arr);
    const int ed_key =
        AGG ? (valid && ap_pend > 0 ? (i << 7) | min(ap_pend, c.K) : N << 7)
            : (valid && ap_pend > 0 ? i : N);
    const int m_ed = warp_min(ed_key);
    if (lane == 0) {
      s_tx[warp] = m_tx;
      s_arr[warp] = m_arr;
      s_ed[warp] = m_ed;
    }
    if (is_ap) s_tx0 = tx_if;
    __syncthreads();
    int tc_sta = kInf, ed = AGG ? N << 7 : N;
    ta = kInf;
    for (int w = 0; w < nw; ++w) {
      tc_sta = min(tc_sta, s_tx[w]);
      ta = min(ta, s_arr[w]);
      ed = min(ed, s_ed[w]);
    }
    const int k_ap = AGG ? ed & 127 : 0;
    if (AGG) ed >>= 7;
    const bool any_ap = ed < N;
    if (!any_ap) ed = 0;
    const bool frame0 = bcn > 0 || any_ap;
    tc = min(tc_sta, frame0 ? s_tx0 : kInf);
    pend = t < sim_end && min(ta, tc) < sim_end;
    if (!pend || step >= step1) break;

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
    float u_back = -1.0f;  // drawn on first use
    auto back = [&]() {
      if (u_back < 0.0f)
        u_back = threefry::uniform(b0, b1, static_cast<uint32_t>(i));
      return u_back;
    };

    const bool frame = is_ap ? frame0 : sta_frame;
    const int tx_t = frame ? tx_if : kInf;
    const bool live = t < sim_end;
    const int next_t = live ? min(ta, tc) : sim_end;
    const bool past_end = next_t >= sim_end;
    const bool arrived = live && ta <= tc && ta < kInf && !past_end;
    const bool transmit = live && tc < ta && tc < kInf && !past_end;

    // the geometry at this replica's next event, every stride steps
    if (MOB && step % mob.stride == 0) {
      refresh(next_t);
      geom_t = next_t;
    }

    // arrivals (TRF: the arriving node's next gap from its workload)
    const bool is_arr = valid && arrived && next_arr == next_t;
    const int queue1 = queue + (is_arr && !is_ap ? 1 : 0);
    const int bcn1 = bcn + (is_arr && is_ap ? 1 : 0);  // thread 0's
    int adv;
    if (TRF)
      adv = is_arr ? wrap_add(next_arr, traffic_gap(tr, N, tr_p, i, next_arr,
                                                    tk0, tk1))
                   : kInf;
    else
      adv = next_arr >= kInf ? kInf : next_arr + interval;
    if (adv >= stop) adv = kInf;
    const int next_arr1 = is_arr ? adv : next_arr;
    const bool frame_after =
        is_arr ? (is_ap ? (bcn1 > 0 || any_ap) : queue1 > 0) : frame;
    const bool hol = is_arr && !frame && frame_after;
    const bool imm_grant = hol && next_t >= busy + c.aifs;
    int backoff1 = (hol && !imm_grant) ? draw_backoff(back(), cw) : backoff;
    bool imm1 = hol ? imm_grant : imm;
    const bool winner = transmit && frame && tx_t == next_t;
    const bool contending = frame && !winner && transmit;

    // 2. the winners and the power at the two destinations
    const unsigned bal = __ballot_sync(kFull, winner);
    float at_ap = 0.0f, at_ed = 0.0f;
    // MOB computes the winners' links to the echo destination only when
    // the AP sends it data (the one frame that reads at_ed): every thread
    // knows from barrier 1 whether the AP wins (its instant is s_tx0)
    const bool ed_read =
        !MOB || (transmit && frame0 && s_tx0 == next_t && bcn == 0);
    if (bal != 0u) {
      at_ap = warp_tree_sum(winner ? rx_to_ap : 0.0f);
      float to_ed = 0.0f;
      if (winner && ed_read)
        to_ed = MOB ? link(mob, s_pos + 3 * i, s_pos + 3 * ed, i == ed,
                           nullptr)
                    : c.rx_w[i * N + ed];
      at_ed = warp_tree_sum(to_ed);
    }
    if (lane == 0) {
      s_win[warp] = bal;
      s_at_ap[warp] = at_ap;
      s_at_ed[warp] = at_ed;
    }
    __syncthreads();
    bool any_win = false;
    for (int w = 0; w < nw; ++w) any_win = any_win || s_win[w] != 0u;
    at_ap = warp_tree_sum(lane < nw ? s_at_ap[lane] : 0.0f);
    at_ed = warp_tree_sum(lane < nw ? s_at_ed[lane] : 0.0f);
    const bool win0 = (s_win[0] & 1u) != 0u;
    const bool win_ed = ((s_win[ed >> 5] >> (ed & 31)) & 1u) != 0u;

    // countdown credit and interrupted grants of the other contenders
    const int idle = next_t - busy - c.aifs;
    const int elapsed = idle < 0 ? 0 : idle / kSlot;
    if (contending && !imm) backoff1 = max(backoff1 - elapsed, 0);
    if (contending && imm) {
      backoff1 = draw_backoff(back(), cw);
      imm1 = false;
    }

    // the PHY: beacons outrank echoes; a gated data frame's coins vs its
    // success rate (under AGG an A-MPDU of the backlog, up to K, whose
    // airtime and nbits grow with its size k)
    const bool ap_beacon = win0 && bcn > 0;
    const bool beacon_tx = winner && is_ap && ap_beacon;
    const bool data_tx = winner && !beacon_tx;
    const bool det =
        is_ap ? (MOB ? s_det0[ed] : c.det[ed]) != 0 : det_to_ap;
    const bool dst_idle = is_ap ? !win_ed : !win0;
    const bool gated = data_tx && det && dst_idle;
    int k_agg = 1, dur = c.data_dur, n_ok = 0;
    if (AGG) {
      k_agg = max(is_ap ? k_ap : min(queue, c.K), 1);
      const float x = __fadd_rn(
          __fmul_rn(static_cast<float>(k_agg), c.sub8), 22.0f);
      dur = __float2int_rz(__fmul_rn(ceilf(__fmul_rn(x, c.inv_ndbps)),
                                     4.0f)) + c.preamble;
    }
    float rate = 0.0f;  // a gated frame's success rate (per subframe)
    if (gated) {
      const float sig = is_ap ? (MOB ? s_rx0[ed] : c.rx_w[ed]) : rx_to_ap;
      const float interf = __fsub_rn(is_ap ? at_ed : at_ap, sig);
      const float lone_v = is_ap ? s_lone_down[ed] : lone_up;
      if (AGG) {
        const float lg =
            interf == 0.0f
                ? lone_v
                : xla_math::nist_lg(
                      __fdiv_rn(sig, __fadd_rn(interf, c.noise_w)), c.psr);
        rate = xla_math::mpdu_rate(
            lg, __fmul_rn(c.rate, static_cast<float>(dur)), k_agg);
      } else {
        rate = interf == 0.0f
                   ? lone_v
                   : xla_math::nist_psr(
                         __fdiv_rn(sig, __fadd_rn(interf, c.noise_w)), c.psr,
                         c.nbits);
        n_ok = threefry::uniform(c0, c1, static_cast<uint32_t>(i)) < rate;
      }
    }
    if (AGG) {
      // each gated frame of the warp in turn, its k coins over the lanes
      unsigned todo = __ballot_sync(kFull, gated);
      while (todo != 0u) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1u;
        const float p = __shfl_sync(kFull, rate, src);
        const int k = __shfl_sync(kFull, k_agg, src);
        const uint32_t first = static_cast<uint32_t>((warp * 32 + src) * c.K);
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
        if (lane == src) n_ok = count;
      }
    }
    const bool success = data_tx && n_ok > 0, fail = data_tx && n_ok == 0;
    const bool dropped = fail && retries + 1 > kRetryLimit;
    const int drop_n = dropped ? k_agg : 0;
    const bool reset = success || dropped || beacon_tx;
    const int retries1 = reset ? 0 : retries + (fail ? 1 : 0);
    const int cw1 = reset ? kCwMin : (fail ? min(2 * (cw + 1) - 1, kCwMax) : cw);
    if (winner) {
      backoff1 = draw_backoff(back(), cw1);
      imm1 = false;
    }
    const int exch = dur + kSifs + c.resp_dur;
    const int occ = success ? exch : (beacon_tx ? c.exch_beacon : dur);
    const int hold1 = fail ? next_t + exch + kSlot + 4
                           : (winner ? next_t + occ : hold);

    // 3. the outcome counts, the medium's occupancy, node 0's outcome
    const int sta_ok = is_ap ? 0 : n_ok;
    const int w_ok = warp_sum(sta_ok), w_drop = warp_sum(drop_n);
    const int w_data = warp_sum(data_tx ? 1 : 0);
    const int w_occ = warp_max(winner ? occ : 0);
    if (lane == 0) {
      s_ok[warp] = w_ok;
      s_drop[warp] = w_drop;
      s_data[warp] = w_data;
      s_occ[warp] = w_occ;
    }
    if (is_ap) {
      s_node0[0] = n_ok;
      s_node0[1] = drop_n;
      s_node0[2] = max(bcn1 - (ap_beacon ? 1 : 0), 0);
    }
    __syncthreads();
    int n_sta_ok = 0, n_drop = 0, n_data = 0, max_occ = 0;
    for (int w = 0; w < nw; ++w) {
      n_sta_ok += s_ok[w];
      n_drop += s_drop[w];
      n_data += s_data[w];
      max_occ = max(max_occ, s_occ[w]);
    }
    const int at_me = i == ed ? 1 : 0;
    const int got_echo = s_node0[0], drop_echo = s_node0[1];
    bcn = s_node0[2];
    srv += n_sta_ok;
    drops += n_drop;
    txd += n_data;
    if (any_win) busy = next_t + max_occ;
    t = max(next_t, t);
    queue = max(queue1 - sta_ok - (is_ap ? 0 : drop_n), 0);
    ap_pend = max(ap_pend + sta_ok - at_me * got_echo - at_me * drop_echo, 0);
    cli += at_me * got_echo;
    next_arr = next_arr1;
    backoff = backoff1;
    imm = imm1;
    cw = cw1;
    retries = retries1;
    hold = hold1;
    ++step;
  }

  if (valid) {
    so.next_arr[q] = next_arr;
    so.queue[q] = queue;
    so.ap_pend[q] = ap_pend;
    so.backoff[q] = backoff;
    so.hold[q] = hold;
    so.immediate[q] = imm ? 1 : 0;
    so.cw[q] = cw;
    so.retries[q] = retries;
    so.cli_rx[q] = cli;
  }
  if (is_ap) {
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
  }
}

template <bool AGG, bool MOB, bool TRF>
void launch(dim3 grid, int threads, cudaStream_t st, const Consts& c,
            const Points& pts, const Mob& mob, const Traffic& tr,
            const StateIn& si, const StateOut& so, const long long* key,
            int* done, int* t_next, uint8_t* pending, int step1) {
  // per node: the lone values, under MOB the AP's links, the positions and
  // the detectability bytes
  const size_t shared = (MOB ? 5 * sizeof(float) + 1 : sizeof(float)) * c.N;
  bss_advance_kernel<AGG, MOB, TRF><<<grid, threads, shared, st>>>(
      c, pts, mob, tr, si, so, key, done, t_next, pending, step1);
}

template <bool AGG>
void launch_arm(bool mob_on, bool tr_on, dim3 grid, int threads,
                cudaStream_t st, const Consts& c, const Points& pts,
                const Mob& mob, const Traffic& tr, const StateIn& si,
                const StateOut& so, const long long* key, int* done,
                int* t_next, uint8_t* pending, int step1) {
  if (mob_on && tr_on)
    launch<AGG, true, true>(grid, threads, st, c, pts, mob, tr, si, so, key,
                            done, t_next, pending, step1);
  else if (mob_on)
    launch<AGG, true, false>(grid, threads, st, c, pts, mob, tr, si, so, key,
                             done, t_next, pending, step1);
  else if (tr_on)
    launch<AGG, false, true>(grid, threads, st, c, pts, mob, tr, si, so, key,
                             done, t_next, pending, step1);
  else
    launch<AGG, false, false>(grid, threads, st, c, pts, mob, tr, si, so,
                              key, done, t_next, pending, step1);
}

}  // namespace

// mob and tr (host structs, parallel/bss_cuda.py's MobArgs / TrafficArgs)
// turn the MOB and TRF arms on; null leaves them off
extern "C" int bss_advance_launch(
    const float* rx_w, const uint8_t* det, const int* interval,
    const int* stop, const long long* key, const int* t,
    const int* next_arr, const int* queue, const int* ap_pend,
    const int* bcn_pend, const int* backoff, const int* hold,
    const uint8_t* immediate, const int* cw, const int* retries,
    const int* busy_until, const int* srv_rx, const int* cli_rx,
    const int* tx_data, const int* drops, const int* geom_t, int* o_t,
    int* o_next_arr, int* o_queue, int* o_ap_pend, int* o_bcn_pend,
    int* o_backoff, int* o_hold, uint8_t* o_immediate, int* o_cw,
    int* o_retries, int* o_busy_until, int* o_srv_rx, int* o_cli_rx,
    int* o_tx_data, int* o_drops, int* o_geom_t, int* done, int* t_next,
    uint8_t* pending, int R, int N, int aifs, int data_dur, int resp_dur,
    int exch_beacon, const int* sim_end, const int* step0, int C, int step1,
    float nbits, float noise_w, float scale, float factor, float lc0,
    float lc1, float lc2, float lc3, float lc4, float lc5, float lc6,
    float lc7, float lc8, float lc9, float e0, float e1, float e2, float e3,
    float e4, float e5, float e6, float e7, float e8, float e9, float b,
    int mask, int K, int preamble, float sub8, float inv_ndbps, float rate,
    const void* mob_args, const void* tr_args, void* stream) {
  const Mob* mob = static_cast<const Mob*>(mob_args);
  const Traffic* tr = static_cast<const Traffic*>(tr_args);
  if (R <= 0 || N <= 0 || N > BSS_MAX_N || C <= 0 || C > BSS_MAX_POINTS ||
      K <= 0 || K > BSS_MAX_MPDUS || step1 > BSS_MAX_STEP ||
      static_cast<long long>(C) * R * N >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (mob && (mob->stride <= 0 || mob->W < 2 || mob->n_seg <= 0))
    return cudaErrorInvalidValue;
  if (tr && (tr->S <= 0 || tr->C <= 0 || tr->K <= 0 || tr->epoch_us <= 0))
    return cudaErrorInvalidValue;
  Points pts{};
  for (int p = 0; p < C; ++p) {
    if (step0[p] < 0 || step1 < step0[p]) return cudaErrorInvalidValue;
    pts.sim_end[p] = sim_end[p];
    pts.step0[p] = step0[p];
  }
  const Psr psr{scale, factor,
                {lc0, lc1, lc2, lc3, lc4, lc5, lc6, lc7, lc8, lc9},
                {e0, e1, e2, e3, e4, e5, e6, e7, e8, e9}, b, mask};
  const Consts c{rx_w,     det,      interval,    stop,    N,
                 aifs,     data_dur, resp_dur,    exch_beacon,
                 nbits,    noise_w,  psr,         K,       preamble,
                 sub8,     inv_ndbps, rate};
  const StateIn si{t,          next_arr, queue,   ap_pend, bcn_pend,
                   backoff,    hold,     immediate, cw,    retries,
                   busy_until, srv_rx,   cli_rx,  tx_data, drops,
                   geom_t};
  const StateOut so{o_t,          o_next_arr, o_queue,   o_ap_pend,
                    o_bcn_pend,   o_backoff,  o_hold,    o_immediate,
                    o_cw,         o_retries,  o_busy_until, o_srv_rx,
                    o_cli_rx,     o_tx_data,  o_drops,   o_geom_t};
  const Mob m = mob ? *mob : Mob{};
  const Traffic tf = tr ? *tr : Traffic{};
  const int threads = ((N + 31) / 32) * 32;
  const dim3 grid(R, C);
  const auto st = static_cast<cudaStream_t>(stream);
  if (K > 1)
    launch_arm<true>(mob != nullptr, tr != nullptr, grid, threads, st, c,
                     pts, m, tf, si, so, key, done, t_next, pending, step1);
  else
    launch_arm<false>(mob != nullptr, tr != nullptr, grid, threads, st, c,
                      pts, m, tf, si, so, key, done, t_next, pending, step1);
  return static_cast<int>(cudaGetLastError());
}
