// wired_advance_obs.cu — wired_advance.cu's OBS arm and the union pass: the
// wired engine's slot loop with ns-3's FlowMonitor columns, one
// translation unit of the wired_advance library, built in parallel with
// wired_advance.cu, whose instantiations without the arm keep their code.
//
// Replaces the reference's obs arm of the windowed slot loop,
// tpudes/parallel/wired.py:635-689 and :735-836 (flow_accumulate and
// flow_ring_write of tpudes/obs/flowmon.py around _make_lane_step.step;
// XLA code, no pallas_call).  The plain version is
// tpudes_torch/parallel/wired.py's advance_math with the obs keys
// (_obs_step a union step, _obs_flush at the window's edge), which the two
// launches equal bit for bit in every state array, column and ring row, in
// the next event and in the union step count.
//
// The reference steps every row on one clock, the union U of all rows'
// next events (wired.py:779), from the window's first slot t0.  A row
// stepped before its own next event serves nothing, so its state and its
// deliveries do not depend on the clock, nor do the delivery columns; only
// the sends (tx, bytes, t0), the ring, the carried mark and the step count
// do, and all four follow from U after the rows have run:
//  1. The main kernel is wired_advance.cu's redesigned one (the link table
//     lo_at, four rows a CTA, the row's list and per-link FIFO queues in
//     shared memory, lookahead windows served a warp round), instantiated
//     with OBS.  The lane that pops a flow's last link applies its
//     deliveries to the delivery columns in device memory (a flow's
//     deliveries arrive in slot order, so the jitter sums in the
//     reference's order; a packet's birth is its flow's first birth,
//     held in shared memory, plus its index times the period, so a
//     delivery waits on one load latency); each window ORs its slot mask
//     into the row's visited slots (a bitmap word in a register, each
//     word stored once) and records, at slot % 512, each delivering slot
//     with its least delivering flow (a shared atomicMin over the
//     window's 32 slots).  It counts no sends.
//  2. The union pass: visits_or ORs the rows' bitmaps into U (a thread a
//     word over 32 rows, one atomicOr a word and chunk), then union_rows,
//     a warp a row: n_steps = popcount(U) (row 0's warp); each flow's sends
//     are the births in (mark, t_grant - 1], counted in closed form with
//     32-bit arithmetic, t0 the first step of U at or after the first new
//     birth (t_grant - 1 past the last, as the window's edge counts it);
//     the ring's row at each residue mod 512 is the reference's row of the
//     residue's last step u of U: the record's flow where the row
//     delivered at u, else the first flow with the most births in (prev u,
//     u] (prev u is the carried mark at U's first step), stamped -1 with
//     flow 0 where it neither delivered nor sent.  Those counts come from
//     walking each flow's births (a flow a lane) after the least such
//     prev u, each counted at its step, the first of U at or after it:
//     a few births a flow at bench width, not 512 counts a flow.
//
// Bound: the main kernel's, wired_advance.cu's (its services' operations at
// bench width), plus the columns, the ring and the births read and written
// once; the union pass is small (the bitmaps, F flows and 512 ring rows a
// row).
//
// The source also builds with g++ against csrc/mock/cuda_runtime.h, which
// runs it on the CPU (tests/test_torch_wired_mock.py).

#define WIRED_OBS_PART
#include "wired_advance.cu"

namespace wired_kernel {

// visits_or: a thread a word, OR_ROWS rows a CTA; union_rows: warps a CTA
constexpr int OR_THREADS = 128;
constexpr int OR_ROWS = 32;
constexpr int UNION_WARPS = 4;
// union_rows' shared memory: a warp's residues' last steps and most keys
constexpr int UNION_SMEM = UNION_WARPS * 3 * RING_CAP * sizeof(int);
// the ring's verdicts (flowmon.py)
constexpr int VERDICT_TX = 0;
constexpr int VERDICT_RX = 1;

struct UnionArgs {
  const int* f_first;   // (F,) each flow's first packet
  const int* f_period;  // (F,) its CBR period
  const int* f_npk;     // (F,) its packets
  const int* birth;     // (R, P) fm_birth
  const unsigned* visits;  // (R, n_words) each row's visited slots
  const unsigned* u;    // (n_words) the union clock's slots from t0
  const int* rec;       // (R, RING_CAP, 2) the main kernel's record
  int* firsts;          // (R, F) scratch: each flow's first birth
  int *tx, *txb;        // (R, F) in place
  float* t0;            // (R, F) fm_t0, in place
  int* ring;            // (R, RING_CAP, RING_COLS) in place
  int* n_steps;         // (1,) the union steps
  int R, P, F, t_start, t_grant, mark, n_words, pkt_bytes;
};

// U: the OR over each chunk of OR_ROWS rows of their words, into the zeroed
// union (blocks word-chunk-major: one dimension, as the mock runs a grid)
__global__ void __launch_bounds__(OR_THREADS)
    visits_or(const unsigned* visits, unsigned* u, int R, int n_words) {
  const int chunks = (n_words + OR_THREADS - 1) / OR_THREADS;
  const int w = (blockIdx.x % chunks) * OR_THREADS + threadIdx.x;
  const int r0 = (blockIdx.x / chunks) * OR_ROWS;
  if (w >= n_words) return;
  unsigned x = 0u;
  for (int r = r0; r < min(R, r0 + OR_ROWS); ++r)
    x |= visits[static_cast<long long>(r) * n_words + w];
  if (x != 0u) atomicOr(&u[w], x);
}

// the births b0 + k per (k < n) at or before slot x
__device__ __forceinline__ int born_by(int b0, int per, int n, int x) {
  return x < b0 ? 0 : min((x - b0) / per + 1, n);
}

__device__ __forceinline__ bool in_union(const unsigned* u, int i) {
  return (u[i / WARP] >> (i % WARP)) & 1u;
}

// the least step of U at or after bit i, or -1
__device__ __forceinline__ int next_step(const unsigned* u, int n_words,
                                         int i) {
  int j = i / WARP;
  if (j >= n_words) return -1;
  unsigned w = u[j] & (FULL << (i % WARP));
  while (w == 0u) {
    if (++j >= n_words) return -1;
    w = u[j];
  }
  return j * WARP + __ffs(w) - 1;
}

// the greatest step of U before bit i, or -1
__device__ __forceinline__ int prev_step(const unsigned* u, int i) {
  if (i <= 0) return -1;
  int j = (i - 1) / WARP;
  unsigned w = u[j] & (FULL >> (WARP - 1 - (i - 1) % WARP));
  while (w == 0u) {
    if (--j < 0) return -1;
    w = u[j];
  }
  return j * WARP + WARP - 1 - __clz(static_cast<int>(w));
}

// a residue's most births (high word) and ~its first flow with that many
// (low word): the largest key is the reference's argmax
__device__ __forceinline__ unsigned long long most_key(int count, int f) {
  return (static_cast<unsigned long long>(count) << 32) |
         (0xFFFFFFFFu - static_cast<unsigned>(f));
}

// a warp a row: the sends, t0 and the ring from U; row 0's warp also the
// step count.  The ring in three rounds: each lane finds its residues'
// last steps (writing the rows that delivered); each lane walks its flows'
// births after the earliest such step's previous one, each birth counted
// at its step (the first step of U at or after it) where that step is
// its residue's last, each flow's count a step into the residue's
// most_key by a shared atomicMax; each lane writes its residues' rows.
__global__ void __launch_bounds__(WARP* UNION_WARPS) union_rows(UnionArgs a) {
  const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  const int row = blockIdx.x * UNION_WARPS + warp;
  if (row >= a.R) return;
  const long long pb = static_cast<long long>(row) * a.P;
  const long long fb = static_cast<long long>(row) * a.F;
  const int hi = a.t_grant - 1;  // the window's last slot
  // the clock the sends and the ring follow: the union of the rows'
  const unsigned* send_clock = a.u;
  const unsigned* ring_clock = a.u;
  if (row == 0) {
    int c = 0;
    for (int i = lane; i < a.n_words; i += WARP) c += __popc(a.u[i]);
    c = __reduce_add_sync(FULL, c);
    if (lane == 0) *a.n_steps = c;
  }
  // each flow's sends: its births in (mark, hi]
  for (int f = lane; f < a.F; f += WARP) {
    const int b0 = a.birth[pb + a.f_first[f]], per = a.f_period[f];
    const int n = a.f_npk[f];
    a.firsts[fb + f] = b0;
    const int before = born_by(b0, per, n, a.mark);
    const int c = born_by(b0, per, n, hi) - before;
    if (c <= 0) continue;
    a.tx[fb + f] += c;
    a.txb[fb + f] += c * a.pkt_bytes;
    if (a.t0[fb + f] < 0.0f) {
      const int i = next_step(send_clock, a.n_words,
                              max(b0 + before * per - a.t_start, 0));
      a.t0[fb + f] = static_cast<float>(i >= 0 ? a.t_start + i : hi);
    }
  }
  if (hi < a.t_start) return;
  // each residue's last step u of U (-1: none, or its row written), and
  // lo, the least step before such a u (the carried mark before U's first)
  int* last = reinterpret_cast<int*>(dyn_smem) + warp * 3 * RING_CAP;
  unsigned long long* most =
      reinterpret_cast<unsigned long long*>(last + RING_CAP);
  int* ring = a.ring + static_cast<long long>(row) * RING_CAP * RING_COLS;
  int lo = INF_SLOT;
  for (int c = lane; c < RING_CAP; c += WARP) {
    int u = hi - ((hi - c) % RING_CAP + RING_CAP) % RING_CAP;
    while (u >= a.t_start && !in_union(ring_clock, u - a.t_start))
      u -= RING_CAP;
    last[c] = -1;
    most[c] = 0ull;
    if (u < a.t_start) continue;
    const int* r = a.rec + (static_cast<long long>(row) * RING_CAP + c) * 2;
    if (r[0] == u) {
      int* w = ring + c * RING_COLS;
      w[0] = u;
      w[1] = u;
      w[2] = r[1];
      w[3] = a.pkt_bytes;
      w[4] = VERDICT_RX;
      continue;
    }
    const int i = prev_step(ring_clock, u - a.t_start);
    last[c] = u;
    lo = min(lo, i >= 0 ? a.t_start + i : a.mark);
  }
  lo = __reduce_min_sync(FULL, lo);
  __syncwarp();
  for (int f = lane; f < a.F; f += WARP) {
    const int b0 = a.firsts[fb + f], per = a.f_period[f], n = a.f_npk[f];
    int at = -1, count = 0;  // the step counted at, its births so far
    for (int k = born_by(b0, per, n, lo); k < n; ++k) {
      const int b = b0 + k * per;
      if (b > hi) break;
      if (b > at) {
        if (at >= 0 && last[at % RING_CAP] == at)
          atomicMax(&most[at % RING_CAP], most_key(count, f));
        const int i = next_step(ring_clock, a.n_words,
                                max(b - a.t_start, 0));
        if (i < 0) break;
        at = a.t_start + i;
        count = 0;
      }
      ++count;
    }
    if (at >= 0 && last[at % RING_CAP] == at)
      atomicMax(&most[at % RING_CAP], most_key(count, f));
  }
  __syncwarp();
  // the rest: the first flow with the most births in (prev u, u], step -1
  // and flow 0 where none
  for (int c = lane; c < RING_CAP; c += WARP) {
    const int u = last[c];
    if (u < 0) continue;
    const unsigned long long m = most[c];
    int* w = ring + c * RING_COLS;
    w[0] = m != 0ull ? u : -1;
    w[1] = u;
    w[2] = m != 0ull ? static_cast<int>(0xFFFFFFFFu -
                                         static_cast<unsigned>(m))
                     : 0;
    w[3] = a.pkt_bytes;
    w[4] = VERDICT_TX;
  }
}

int union_launch(const UnionArgs& a, unsigned* u, cudaStream_t st) {
  if (a.n_words > 0) {
    cudaError_t e = cudaMemsetAsync(u, 0, sizeof(unsigned) * a.n_words, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long blocks =
        static_cast<long long>((a.n_words + OR_THREADS - 1) / OR_THREADS) *
        ((a.R + OR_ROWS - 1) / OR_ROWS);
    const unsigned* vis = a.visits;
    unsigned* un = u;
    int R = a.R, n_words = a.n_words;
    void* or_args[] = {&vis, &un, &R, &n_words};
    e = cudaLaunchKernel(visits_or, dim3(static_cast<unsigned>(blocks)),
                         dim3(OR_THREADS), or_args, 0, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  UnionArgs b = a;
  void* args[] = {&b};
  const cudaError_t e = cudaLaunchKernel(
      union_rows, dim3((a.R + UNION_WARPS - 1) / UNION_WARPS),
      dim3(WARP * UNION_WARPS), args, UNION_SMEM, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the OBS operands from the host array of their N_OBS_PTRS device pointers
constexpr int N_OBS_PTRS = 12;
inline bool obs_args(void* const* p, int n_words, int pkt_bytes, float scale,
                     ObsArgs& o) {
  for (int i = 0; i < N_OBS_PTRS; ++i)
    if (p[i] == nullptr && !(i == 10 && n_words == 0)) return false;
  int* const* q = reinterpret_cast<int* const*>(p);
  auto fp = [&](int i) { return reinterpret_cast<float*>(q[i]); };
  o = ObsArgs{q[0],  q[1],  q[2],  q[3],
              q[4],  fp(5), fp(6), fp(7),
              fp(8), q[9],  reinterpret_cast<unsigned*>(q[10]),
              q[11], n_words, pkt_bytes,
              scale};
  return true;
}

}  // namespace wired_kernel

// One advance of the R rows with the FlowMonitor columns:
// wired_advance_launch's arguments (K = 1, shared bytes table_bytes + rows
// row_bytes + obs_bytes), then the host array of the arm's 12 device
// pointers (fm_birth, the tables f_first and f_period (F,), fm_rx, fm_rxb,
// fm_dsum, fm_jsum, fm_dlast, fm_t1, fm_hist in place; the visits (R,
// n_words) and the record (R, 512, 2) out), the bitmap's words a row
// (ceil((t_grant - t) / 32), 0 where t >= t_grant), a packet's bytes, the
// bin factor, stream.  The sends, the ring and the step count are
// wired_advance_obs_union_launch's.
extern "C" int wired_advance_obs_launch(WIRED_PARAMS, void* const* obs,
                                        int n_words, int pkt_bytes,
                                        float scale, cudaStream_t st) {
  wired_kernel::ObsArgs o;
  if (!wired_kernel::obs_args(obs, n_words, pkt_bytes, scale, o))
    return static_cast<int>(cudaErrorInvalidValue);
  return wired_kernel::launch<false, true>(WIRED_ARGS, nullptr, st, &o);
}

// the stage probe of the arm: the PROF instantiation with OBS, which also
// writes each row's N_PROF words to prof
extern "C" int wired_advance_obs_profile(WIRED_PARAMS, void* const* obs,
                                         int n_words, int pkt_bytes,
                                         float scale, long long* prof,
                                         cudaStream_t st) {
  wired_kernel::ObsArgs o;
  if (!wired_kernel::obs_args(obs, n_words, pkt_bytes, scale, o))
    return static_cast<int>(cudaErrorInvalidValue);
  return wired_kernel::launch<true, true>(WIRED_ARGS, prof, st, &o);
}

// The union pass after wired_advance_obs_launch: ptrs, the host array of
// 13 device pointers (f_first, f_period, f_npk, fm_birth, the visits, the
// union (n_words, scratch), the record, the flows' first births ((R, F)
// scratch); fm_tx, fm_txb, fm_t0, fm_ring in place; the step count out);
// ints R, P, F, t (the window's first slot),
// t_grant, the carried mark, n_words, a packet's bytes; stream.
extern "C" int wired_advance_obs_union_launch(void* const* ptrs, int R, int P,
                                              int F, int t, int t_grant,
                                              int mark, int n_words,
                                              int pkt_bytes,
                                              cudaStream_t st) {
  using namespace wired_kernel;
  if (R < 1 || P < 0 || F < 1 || t < 0 || t_grant < 0 ||
      t_grant >= (1 << 24) || t > INF_SLOT || mark >= (1 << 24) ||
      n_words != (t_grant > t ? (t_grant - t + WARP - 1) / WARP : 0) ||
      static_cast<long long>(R) * P >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 13; ++i)
    if (ptrs[i] == nullptr && !((i == 4 || i == 5) && n_words == 0))
      return static_cast<int>(cudaErrorInvalidValue);
  int* const* q = reinterpret_cast<int* const*>(ptrs);
  const UnionArgs a{q[0],
                    q[1],
                    q[2],
                    q[3],
                    reinterpret_cast<const unsigned*>(q[4]),
                    reinterpret_cast<const unsigned*>(q[5]),
                    q[6],
                    q[7],
                    q[8],
                    q[9],
                    reinterpret_cast<float*>(q[10]),
                    q[11],
                    q[12],
                    R,
                    P,
                    F,
                    t,
                    t_grant,
                    mark,
                    n_words,
                    pkt_bytes};
  return union_launch(a, reinterpret_cast<unsigned*>(q[5]), st);
}
