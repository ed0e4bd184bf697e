// as_flows.cu — the AS flow engine's two kernels, and their C interface.
//
// Replaces the reference's routing stage and path walk,
// tpudes/parallel/as_flows.py:227-293 (device_spf: a lax.scan of
// Bellman-Ford rounds, each an edge-parallel scatter-min over the (D, N)
// distance table, then the next-hop scatter; _walk_paths), and its draws and
// fluid fixed point, :633-644 (_as_replica_draws) and :309-377 with the
// while_loop at :485-518 (the fluid rounds, the delay sum and the outputs);
// XLA code, no pallas_call.  The plain versions are parallel/as_flows.py's
// spf_math with walk_math, and random.as_replica_draws with fluid_math,
// which these kernels equal bit for bit.
//
// as_spf: one CTA of 32 warps a destination row d.  The directed edges (the
// E links as given, then reversed, with equal weights) come as a CSR grouped
// by source node u, each entry holding v, the weight w and the directed
// index e; a node's out-list is also its in-list.  Rounds are Jacobi rounds,
// new[u] = min(old[u], min over u->v of old[v] + w), taken over a frontier:
// round r relaxes only the edges of the nodes whose distance changed in
// round r - 1 (round 0's frontier is d's destination), pushing old[x] + w
// from a frontier node x into each neighbour's new entry with an atomicMin
// on the distance's order-preserving int key (exact in any order).  That is
// the full round: a node v that did not change has old[v] + w among the
// candidates its neighbour u already took (INF + w is no less than INF),
// so it cannot lower u.  The round writes one buffer from the other and
// never reads what it writes, so a run truncated at any round equals the
// reference's; the lane whose atomicMin first lowers a node appends it to
// the next frontier, and an empty frontier ends the rounds.  A warp takes 32 frontier nodes at a time and
// spreads their edges over its lanes (a prefix sum of the degrees, each
// lane finding its node by a binary search over the lanes), so a 363-edge
// hub costs 12 lane-steps, not 363, and every lane-step is full.  Then the
// next hops, a warp 32 nodes at a time with no barrier of the CTA: a node
// of at most 8 edges (most of a BA graph's) is its lane's, its edges'
// loads issued together, a heavier one (a hub) the whole warp's, its edges
// strided over the lanes; best = min(INF, min over u->v of w + dist[v]) (a
// warp reduction for a hub), then the smallest CSR position (within u, the
// smallest directed index e) among the edges whose score is at most best *
// f32(1 + 1e-6), then the node's row entries; unreachable nodes keep INF =
// 1e30 and still get a next hop (1e30 + w is 1e30 in f32), as in the
// reference.  Then each flow of the row walks its path
// from the next hops in shared memory: path (F, H), 2E past its end, hops
// and reached (dist[src] < INF and the walk arrived).  The two distance
// buffers and the two frontier lists (16 N bytes: 160 KB at 10,000 nodes)
// sit in shared memory while they fit, else in device memory (the GLOBAL
// instantiation, the same code).
//
// as_fluid: one CTA a replica r, which runs the C points of the C x R grid
// in turn.  The caller builds, once a run, the tables in one int32 blob
// (fluid_tables' "blob", each part padded to 16 bytes): each flow's
// flow-hops contiguous (fh_ptr, their compact links fh_link and flows
// fh_flow), each link's contributions as a CSR over flow-hop positions in
// (hop, flow) order (lptr, lslot), and the links' folded f32 constants c =
// 1 / cap, k = 8 pkt / cap and dly.  A CTA copies the blob into shared
// memory by cp.async while it draws its replica's jitter once for every
// point: z = normal(fold_in(key, r), (F,)) by threefry.cuh and the
// compiled erf_inv, then exp(z jitter - jitter^2 / 2); a point's rate is
// fm * scale * that.  Each round:
//   1. every flow-hop's contribution rate * exp(g), g the flow's lfrac
//      summed along its path before the hop, in hop order from 0 (the
//      reference's prefix, the same f32 adds), a flow-hop a lane;
//   2. each link sums its contributions in list order from 0.0f (the CPU
//      applies a scatter's duplicate updates in update order, hop after
//      hop), util = load * c, lfrac = log(min(1 / max(util, 1e-9), 1));
// with a barrier after each.  A round that leaves every lfrac as it found
// it has reached the fixed point: the rounds after it would repeat it bit
// for bit, so the point stops there (__syncthreads_or of the links' moves).
// Untouched links have util 0 and lfrac 0, so max_util is max(0, max over
// L).  Then each flow's delay, the sum in hop order of its links' fma(q, k,
// k) + dly with q = rho / (1 - rho), rho = min(util, 0.99) (fma(q, k, k +
// dly) where the caller says the constants fold), and its outputs.  No sum
// uses atomics: each is one thread's, in a fixed order.  exp(0) is 1 and
// log(1) is 0 in the compiled arithmetic, so a flow-hop whose g is 0 and a
// link whose argument is 1 (a link below its capacity) skip the function,
// and a round that starts with every lfrac 0 skips the prefix sums.
//
// Arithmetic.  exp, log, erf_inv and the multiply-adds are xla_math.cuh's
// (the reference's compiled functions over xla_math::fma32).  The WiFi
// window's f64-register route (F32d in wifi_window.cu) was tried here and
// not kept: no chain of this kernel is bound by the f32 <-> f64
// conversions, and the route ran slower (PERF.md).  Every other product,
// sum and division is rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn), which nvcc does not contract.
//
// Bound (chip_smoke.py's as_spf_bound, as_fluid_bound).  as_spf must write
// its three (D, N) tables (15 MB at bench_as's 10,000 nodes and 127
// destinations): bytes bound it.  Its time goes to latency: the first design
// (a thread a node, every round over the whole CSR from L2) spent 53,000
// cycles a round waiting on the warp with the most entries, nine rounds and
// a next-hop pass of 143,000; here each row reads a frontier node's edges
// once a round (a node's distance changes once under the hop metric) and
// the CSR once in the next-hop pass.  as_fluid is bound by operations, its
// exps and logs where links are loaded past capacity; the tables in shared
// memory, the flow-hops a lane, the fixed-point stop and the shortcuts
// above take it off the first design's serial chain of exps a flow.
//
// The stage probe (as_spf_profile, as_fluid_profile: the PROF
// instantiations) reads clock64() at each warp's stage edges (as_cuda.py::
// spf_stages, fluid_stages).  as_erf_inv_check runs the draw's erf_inv.
//
// The source also builds with g++ against csrc/mock/cuda_runtime.h, which
// runs it on the CPU (tests/test_torch_as_mock.py).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "threefry.cuh"
#include "xla_math.cuh"

extern __shared__ __align__(16) unsigned char dyn_smem[];

namespace as_kernel {

constexpr int SPF_THREADS = 1024;
// in the next-hop pass a node of at most LIGHT CSR entries is its lane's,
// a heavier one its warp's
constexpr int LIGHT = 8;
constexpr int FLUID_THREADS = 128;
constexpr int BIG = 1 << 30;
constexpr unsigned FULL = 0xFFFFFFFFu;
// the shared memory a CTA may opt in to
constexpr long long SMEM_LIMIT = 227 * 1024;

// the stage probe (the PROF instantiations): as_spf's words (sums over
// CTAs) are its set-up, then for each of SPF_PROF_ROUNDS rounds (later
// rounds in the last) the relaxation's cycles (the slowest warp's) and the
// wait at the round's barrier (the least and the most over warps), then the
// next-hop pass, the row writes, the walk and the rounds run; as_fluid's
// its set-up, each round's flow step and link step, and the delays
constexpr int SPF_PROF_ROUNDS = 16;
constexpr int SPF_PROF_WORDS = 5 + 3 * SPF_PROF_ROUNDS;
constexpr int FLUID_PROF_ROUNDS = 8;
constexpr int FLUID_PROF_WORDS = 2 + 2 * FLUID_PROF_ROUNDS;

// an f32's order-preserving int key, and back
__device__ __forceinline__ int fkey(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float fval(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

// a warp's clock at a stage edge (lane 0's, after the warp meets)
__device__ __forceinline__ long long warp_clock() {
  __syncwarp();
  return clock64();
}

struct SpfArgs {
  const int* row_ptr;   // (N + 1,)
  const int* col_v;     // (2E,) in CSR order
  const float* col_w;
  const int* col_e;
  const int* dsts;      // (D,)
  const int* flow_ptr;  // (D + 1,) each row's flows in flow_ids
  const int* flow_ids;  // (F,) by row, ascending within a row
  const int* src;       // (F,) the flows' sources
  int* scratch;         // (D, 4, N) words for GLOBAL, else null
  float* dist;          // (D, N)
  int* nh_edge;
  int* nh_node;
  int* path;            // (F, H)
  int* hops;            // (F,)
  uint8_t* reached;     // (F,)
  long long* prof;      // the probe's SPF_PROF_WORDS, or null
  int N, rounds, H, E2;
  float inf, slack;
};

// The CSR entries of the nodes the warp's lanes hold (x, or -1 for none),
// spread over the lanes 32 at a time: a prefix sum of the degrees, and
// each lane's entry k's owner found by a binary search over the lanes'
// sums.  Every lane builds it and calls each(), which calls fn(owner, j,
// v, w) for each entry; fn holds no warp collective.
struct Spread {
  int x, incl, base, total;
  __device__ __forceinline__ Spread(const int* row_ptr, int x_) : x(x_) {
    const int lane = threadIdx.x & 31;
    const int s = x >= 0 ? row_ptr[x] : 0;
    const int deg = x >= 0 ? row_ptr[x + 1] - s : 0;
    incl = deg;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    total = __shfl_sync(FULL, incl, 31);
    base = s - (incl - deg);  // j = base + k for the owner's k
  }
  // entry k's owner and CSR position
  __device__ __forceinline__ void at(int k, int& xo, int& j) const {
    int o = 0;
#pragma unroll
    for (int b = 16; b > 0; b >>= 1) {
      const int t = __shfl_sync(FULL, incl, o + b - 1);
      if (t <= k) o += b;
    }
    xo = __shfl_sync(FULL, x, o);
    j = __shfl_sync(FULL, base, o) + k;
  }
  // two lane-steps a turn, their loads in flight together
  template <class Fn>
  __device__ __forceinline__ void each(const int* col_v, const float* col_w,
                                       Fn fn) const {
    const int lane = threadIdx.x & 31;
    for (int k0 = 0; k0 < total; k0 += 64) {
      const int k1 = k0 + lane, k2 = k1 + 32;
      int x1, j1, x2, j2;
      at(k1, x1, j1);
      at(k2, x2, j2);
      const bool in1 = k1 < total, in2 = k2 < total;
      const int v1 = in1 ? col_v[j1] : 0, v2 = in2 ? col_v[j2] : 0;
      const float w1 = in1 ? col_w[j1] : 0.0f, w2 = in2 ? col_w[j2] : 0.0f;
      if (in1) fn(x1, j1, v1, w1);
      if (in2) fn(x2, j2, v2, w2);
    }
  }
};

// the probe's per-CTA words
__shared__ int spf_prof_words[SPF_PROF_WORDS];
// the frontier counters (GLOBAL keeps only these in shared memory)
__shared__ int spf_counts[2];

template <bool GLOBAL, bool PROF>
__global__ void __launch_bounds__(SPF_THREADS) as_spf(SpfArgs a) {
  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int N = a.N;
  // two distance buffers (keys) and two frontier lists, N words each
  int* base = GLOBAL ? a.scratch + static_cast<long long>(d) * 4 * N
                     : reinterpret_cast<int*>(dyn_smem);
  int* R = base;
  int* W = base + N;
  int* cur = base + 2 * N;
  int* nxt = base + 3 * N;
  int* cnt = spf_counts;
  int* pw = spf_prof_words;
  long long t_last = 0;
  if constexpr (PROF) {
    for (int i = tid; i < SPF_PROF_WORDS; i += SPF_THREADS)
      pw[i] = (i >= 1 && i < 1 + 3 * SPF_PROF_ROUNDS && (i - 1) % 3 == 1)
                  ? 0x7FFFFFFF
                  : 0;
    __syncthreads();
    t_last = warp_clock();
  }
  auto mark = [&](int s) {  // the slowest warp's cycles since the last mark
    if constexpr (PROF) {
      const long long t = warp_clock();
      if (lane == 0) atomicMax(&pw[s], static_cast<int>(t - t_last));
      t_last = t;
    }
  };
  const int dst = a.dsts[d];
  const int kinf = fkey(a.inf);
  for (int u = tid; u < N; u += SPF_THREADS) {
    const int k = u == dst ? fkey(0.0f) : kinf;
    R[u] = k;
    W[u] = k;
  }
  if (tid == 0) {
    cur[0] = dst;
    cnt[0] = 1;
    cnt[1] = 0;
  }
  mark(0);
  __syncthreads();
  if constexpr (PROF) t_last = warp_clock();

  int c = 0, rounds_run = 0;
  for (int r = 0; r < a.rounds; ++r) {
    const int n = cnt[c];
    if (n == 0) break;
    // W holds the table before the last round: bring in its changes
    for (int i = tid; i < n; i += SPF_THREADS) {
      const int x = cur[i];
      W[x] = R[x];
    }
    if (tid == 0) cnt[c ^ 1] = 0;
    __syncthreads();
    // push each frontier node's distance along its edges into W
    for (int c0 = warp * 32; c0 < n; c0 += SPF_THREADS) {
      const Spread sp(a.row_ptr, c0 + lane < n ? cur[c0 + lane] : -1);
      sp.each(a.col_v, a.col_w, [&](int xo, int, int y, float w) {
        const int k = fkey(__fadd_rn(fval(R[xo]), w));
        const int prev = atomicMin(&W[y], k);
        if (k < prev && prev == R[y]) nxt[atomicAdd(&cnt[c ^ 1], 1)] = y;
      });
    }
    long long t_arrive = 0;
    if constexpr (PROF) t_arrive = warp_clock();
    __syncthreads();
    if constexpr (PROF) {
      const long long t = warp_clock();
      if (lane == 0) {
        const int s = 1 + 3 * min(r, SPF_PROF_ROUNDS - 1);
        atomicMax(&pw[s], static_cast<int>(t_arrive - t_last));
        atomicMin(&pw[s + 1], static_cast<int>(t - t_arrive));
        atomicMax(&pw[s + 2], static_cast<int>(t - t_arrive));
      }
      t_last = t;
    }
    ++rounds_run;
    int* t = R;
    R = W;
    W = t;
    t = cur;
    cur = nxt;
    nxt = t;
    c ^= 1;
  }

  // the next hops, a warp 32 nodes at a time (no barrier of the CTA: each
  // node is its lane's or, a hub, its warp's alone): the best score, then
  // the smallest qualifying CSR position, kept in cur (and the next node
  // in nxt) for the walk; then the nodes' rows
  __syncthreads();
  const long long row = static_cast<long long>(d) * N;
  long long t_nh = 0, t_rows = 0;
  // each lane's node's CSR bounds, loaded a chunk ahead
  int s_next = 0, e_next = 0;
  if (warp * 32 + lane < N) {
    s_next = a.row_ptr[warp * 32 + lane];
    e_next = a.row_ptr[warp * 32 + lane + 1];
  }
  for (int c0 = warp * 32; c0 < N; c0 += SPF_THREADS) {
    const int u = c0 + lane < N ? c0 + lane : -1;
    int s = s_next, deg = e_next - s_next, jb = BIG;
    s_next = e_next = 0;
    if (c0 + SPF_THREADS + lane < N) {
      s_next = a.row_ptr[c0 + SPF_THREADS + lane];
      e_next = a.row_ptr[c0 + SPF_THREADS + lane + 1];
    }
    if (deg <= LIGHT) {
      float sc[LIGHT];
      int v[LIGHT];
#pragma unroll
      for (int i = 0; i < LIGHT; ++i)
        if (i < deg) {
          v[i] = a.col_v[s + i];
          sc[i] = a.col_w[s + i];
        }
      float best = a.inf;
#pragma unroll
      for (int i = 0; i < LIGHT; ++i)
        if (i < deg) {
          sc[i] = __fadd_rn(sc[i], fval(R[v[i]]));
          best = fminf(best, sc[i]);
        }
      const float thr = __fmul_rn(best, a.slack);
#pragma unroll
      for (int i = LIGHT - 1; i >= 0; --i)
        if (i < deg && sc[i] <= thr) jb = s + i;
    }
    for (unsigned heavy = __ballot_sync(FULL, deg > LIGHT); heavy;
         heavy &= heavy - 1) {
      const int l = __ffs(heavy) - 1;
      const int hs = __shfl_sync(FULL, s, l);
      const int hd = __shfl_sync(FULL, deg, l);
      int kb = kinf;
      for (int i = lane; i < hd; i += 32)
        kb = min(kb, fkey(__fadd_rn(a.col_w[hs + i],
                                    fval(R[a.col_v[hs + i]]))));
      const float thr = __fmul_rn(fval(__reduce_min_sync(FULL, kb)),
                                  a.slack);
      int jm = BIG;
      for (int i = lane; i < hd; i += 32)
        if (__fadd_rn(a.col_w[hs + i], fval(R[a.col_v[hs + i]])) <= thr) {
          jm = hs + i;
          break;
        }
      jm = __reduce_min_sync(FULL, jm);
      if (lane == l) jb = jm;
    }
    long long t = 0;
    if constexpr (PROF) {
      t = warp_clock();
      t_nh += t - t_last;
    }
    if (u >= 0) {
      const int v = jb < BIG ? a.col_v[jb] : -1;
      a.dist[row + u] = fval(R[u]);
      a.nh_edge[row + u] = jb < BIG ? a.col_e[jb] : BIG;
      a.nh_node[row + u] = v;
      cur[u] = jb;
      nxt[u] = v;
    }
    if constexpr (PROF) {
      t_last = warp_clock();
      t_rows += t_last - t;
    }
  }
  if constexpr (PROF) {
    if (lane == 0) {
      atomicMax(&pw[1 + 3 * SPF_PROF_ROUNDS], static_cast<int>(t_nh));
      atomicMax(&pw[2 + 3 * SPF_PROF_ROUNDS], static_cast<int>(t_rows));
    }
  }
  __syncthreads();
  if constexpr (PROF) t_last = warp_clock();

  // the walk of each flow of this row, from the next hops just found
  for (int i = a.flow_ptr[d] + tid; i < a.flow_ptr[d + 1];
       i += SPF_THREADS) {
    const int f = a.flow_ids[i];
    const int s = a.src[f];
    int* p = a.path + static_cast<long long>(f) * a.H;
    int at = s, nh = 0;
    for (int h = 0; h < a.H; ++h) {
      int e = a.E2;
      if (at == dst || at < 0) {
        at = -1;
      } else {
        const int j = cur[at];
        at = nxt[at];
        if (j < BIG) {
          e = a.col_e[j];
          ++nh;
        }
      }
      p[h] = e;
    }
    a.hops[f] = nh;
    a.reached[f] = fval(R[s]) < a.inf && (at == -1 || at == dst);
  }
  if constexpr (PROF) {
    mark(3 + 3 * SPF_PROF_ROUNDS);
    __syncthreads();
    if (tid == 0) pw[4 + 3 * SPF_PROF_ROUNDS] = rounds_run;
    __syncthreads();
    for (int i = tid; i < SPF_PROF_WORDS; i += SPF_THREADS)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.prof + i),
                static_cast<unsigned long long>(
                    pw[i] == 0x7FFFFFFF ? 0 : pw[i]));
  }
}

// the fluid tables' blob: part k starts at off[k] words (each part padded to
// 4 words), off[8] the blob's words (as_flows.py::fluid_tables builds it)
struct Blob {
  int off[9];
  __host__ __device__ Blob(int F, int L, int FH) {
    const int n[8] = {F + 1, FH, FH, L + 1, FH, L, L, L};
    off[0] = 0;
    for (int i = 0; i < 8; ++i) off[i + 1] = off[i] + ((n[i] + 3) & ~3);
  }
};

struct FluidArgs {
  const int* blob;         // the run's tables (Blob)
  const float* fm;         // (F,) nominal rate x the workload's multiplier
  const float* scale;      // (C,)
  const long long* key;    // (2,) the run's key
  const uint8_t* reached;  // (F,)
  const float* lfrac_in;   // (C, R, L) or null: zeros
  float* lfrac_out;        // (C, R, L) or null
  float* goodput;          // (C, R, F)
  float* delay;
  float* frac;
  float* max_util;         // (C, R)
  float* z_out;            // (R, F) the draws, or null
  long long* prof;         // the probe's FLUID_PROF_WORDS, or null
  int F, L, FH, C, R, rounds, fold;
  float jitter, neg_hj2, util_min, rho_max;
};

// a 16-byte copy from device memory into shared memory, complete after
// cp_wait()
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
#ifdef TPUDES_CUDA_MOCK
  memcpy(smem, gmem, 16);
#else
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
#endif
}
__device__ __forceinline__ void cp_wait() {
#ifndef TPUDES_CUDA_MOCK
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
#endif
}

template <bool PROF>
__global__ void __launch_bounds__(FLUID_THREADS) as_fluid(FluidArgs a) {
  const int r = blockIdx.x;  // the replica; its C points in turn
  const int tid = threadIdx.x;
  const int F = a.F, L = a.L, FH = a.FH, R = a.R;
  const Blob b(F, L, FH);
  int* tab = reinterpret_cast<int*>(dyn_smem);
  const int* fh_ptr = tab + b.off[0];
  const int* fh_link = tab + b.off[1];
  const int* fh_flow = tab + b.off[2];
  const int* lptr = tab + b.off[3];
  const int* lslot = tab + b.off[4];
  const float* lc = reinterpret_cast<const float*>(tab + b.off[5]);
  const float* lk = reinterpret_cast<const float*>(tab + b.off[6]);
  const float* ldly = reinterpret_cast<const float*>(tab + b.off[7]);
  float* lfrac = reinterpret_cast<float*>(tab + b.off[8]);
  float* util = lfrac + L;
  float* jit = util + L;
  float* rate = jit + F;
  float* lg = rate + F;
  float* contrib = lg + F;
  float* warp_max = contrib + FH;
  // the probe: thread 0's clock at each barrier; a stage's cycles run from
  // the barrier before it to the one after it
  long long t_last = 0;
  if constexpr (PROF) t_last = clock64();
  auto stage = [&](int s) {
    if constexpr (PROF) {
      if (tid == 0) {
        const long long t = clock64();
        atomicAdd(reinterpret_cast<unsigned long long*>(a.prof + s),
                  static_cast<unsigned long long>(t - t_last));
        t_last = t;
      }
    }
  };

  // the tables into shared memory, in flight while the replica draws its
  // rates' jitter factors exp(z jitter - jitter^2 / 2)
  for (int i = 4 * tid; i < b.off[8]; i += 4 * FLUID_THREADS)
    cp_async16(tab + i, a.blob + i);
  uint32_t k0 = static_cast<uint32_t>(a.key[0]);
  uint32_t k1 = static_cast<uint32_t>(a.key[1]);
  threefry::fold_in(k0, k1, static_cast<uint32_t>(r));
  const float lo = -0x1.fffffep-1f;  // nextafter(-1, 0)
  for (int f = tid; f < F; f += FLUID_THREADS) {
    const float unit = threefry::uniform(k0, k1, static_cast<uint32_t>(f));
    const float u = fmaxf(lo, __fadd_rn(__fmul_rn(unit, 2.0f), lo));
    const float z = __fmul_rn(xla_math::xla_erf_inv(u), 1.41421354f);
    if (a.z_out) a.z_out[static_cast<long long>(r) * F + f] = z;
    jit[f] = xla_math::xla_exp(xla_math::fma32(z, a.jitter, a.neg_hj2));
  }
  cp_wait();

  for (int c = 0; c < a.C; ++c) {
    const long long grow = static_cast<long long>(c) * R + r;
    const long long lrow = grow * L, frow = grow * F;
    for (int f = tid; f < F; f += FLUID_THREADS) {
      rate[f] = a.reached[f]
                    ? __fmul_rn(__fmul_rn(a.fm[f], a.scale[c]), jit[f])
                    : 0.0f;
      lg[f] = 0.0f;
    }
    int lost = 0;
    for (int l = tid; l < L; l += FLUID_THREADS) {
      lfrac[l] = a.lfrac_in ? a.lfrac_in[lrow + l] : 0.0f;
      lost |= lfrac[l] != 0.0f;
      util[l] = 0.0f;
    }
    // lost: some link delivers less than all (else every g below is 0)
    lost = __syncthreads_or(lost);
    stage(0);

    // a round that leaves every lfrac as it found it reached the fixed
    // point: the rounds after it would repeat it bit for bit
    for (int round = 0; round < a.rounds; ++round) {
      // 1. every flow-hop's contribution, its flow's prefix in hop order
      for (int p = tid; p < FH; p += FLUID_THREADS) {
        const int f = fh_flow[p];
        float g = 0.0f;
        if (lost)
          for (int q = fh_ptr[f]; q < p; ++q)
            g = __fadd_rn(g, lfrac[fh_link[q]]);
        contrib[p] = g == 0.0f ? rate[f] : __fmul_rn(rate[f], xla_math::xla_exp(g));
        if (p + 1 == fh_ptr[f + 1])
          lg[f] = lost ? __fadd_rn(g, lfrac[fh_link[p]]) : 0.0f;
      }
      __syncthreads();
      stage(1 + 2 * min(round, FLUID_PROF_ROUNDS - 1));
      // 2. each link's load, its contributions in (hop, flow) order
      int moved = 0;
      lost = 0;
      for (int l = tid; l < L; l += FLUID_THREADS) {
        float load = 0.0f;
        for (int j = lptr[l]; j < lptr[l + 1]; ++j)
          load = __fadd_rn(load, contrib[lslot[j]]);
        const float u = __fmul_rn(load, lc[l]);
        util[l] = u;
        const float x = fminf(__fdiv_rn(1.0f, fmaxf(u, a.util_min)), 1.0f);
        const float lf = x == 1.0f ? 0.0f : xla_math::xla_log(x);
        moved |= __float_as_int(lf) != __float_as_int(lfrac[l]);
        lost |= lf != 0.0f;
        lfrac[l] = lf;
      }
      const int any = __syncthreads_or(moved);
      lost = __syncthreads_or(lost);
      stage(2 + 2 * min(round, FLUID_PROF_ROUNDS - 1));
      if (!any) break;
    }

    // the largest utilisation, each flow's delay (a link's delay summed in
    // hop order) and its outputs
    float m = 0.0f;
    for (int l = tid; l < L; l += FLUID_THREADS) m = fmaxf(m, util[l]);
    for (int s = 16; s > 0; s >>= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, s));
    if ((tid & 31) == 0) warp_max[tid / 32] = m;
    for (int f = tid; f < F; f += FLUID_THREADS) {
      float dl = 0.0f;
      for (int p = fh_ptr[f]; p < fh_ptr[f + 1]; ++p) {
        const int l = fh_link[p];
        const float rho = fminf(util[l], a.rho_max);
        const float q = __fdiv_rn(rho, __fsub_rn(1.0f, rho));
        dl = __fadd_rn(
            dl, a.fold ? xla_math::fma32(q, lk[l], __fadd_rn(lk[l], ldly[l]))
                       : __fadd_rn(xla_math::fma32(q, lk[l], lk[l]),
                                   ldly[l]));
      }
      const bool reached = a.reached[f] != 0;
      const float g = lg[f];
      const float fr = reached ? (g == 0.0f ? 1.0f : xla_math::xla_exp(g)) : 0.0f;
      a.frac[frow + f] = fr;
      a.goodput[frow + f] = __fmul_rn(rate[f], fr);
      a.delay[frow + f] = reached ? dl : INFINITY;
    }
    if (a.lfrac_out)
      for (int l = tid; l < L; l += FLUID_THREADS)
        a.lfrac_out[lrow + l] = lfrac[l];
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < FLUID_THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
      a.max_util[grow] = m;
    }
    stage(FLUID_PROF_WORDS - 1);
  }
}

// the draw's erf_inv on n floats
__global__ void erf_inv_kernel(const float* x, float* out, long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = xla_math::xla_erf_inv(x[i]);
}

template <class K, class A>
int launch(K kernel, const A& a, int blocks, int threads, long long smem,
           cudaStream_t st) {
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // all of the SM's shared memory for its CTAs (as_fluid fits 8 of them)
  const cudaError_t e0 = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e0 != cudaSuccess) return static_cast<int>(e0);
  void* args[] = {const_cast<A*>(&a)};
  const cudaError_t e = cudaLaunchKernel(kernel, dim3(blocks), dim3(threads),
                                         args, static_cast<size_t>(smem), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace as_kernel

// The routing stage and the walk: the CSR row_ptr (N + 1) int32, col_v,
// col_w, col_e (2E) int32 / f32 / int32, the D destinations, each row's
// flows flow_ptr (D + 1) and flow_ids (F), the flows' sources (F); scratch
// (D, 4, N) int32 for the rows kept in device memory (null: shared memory,
// 16 N bytes a CTA); writes dist (D, N) f32, nh_edge and nh_node (D, N)
// int32, path (F, H) int32, hops (F) int32, reached (F) bool.  ints: N, D,
// F, H, 2E, rounds, the shared bytes; floats: INF and the next hop's slack;
// prof: the probe's words (null: the main instantiation).
extern "C" int as_spf_launch(const int* row_ptr, const int* col_v,
                             const float* col_w, const int* col_e,
                             const int* dsts, const int* flow_ptr,
                             const int* flow_ids, const int* src,
                             int* scratch, float* dist, int* nh_edge,
                             int* nh_node, int* path, int* hops,
                             uint8_t* reached, long long* prof, int N, int D,
                             int F, int H, int E2, int rounds, int smem,
                             float inf, float slack, cudaStream_t st) {
  using namespace as_kernel;
  const long long need = scratch ? 0 : 16LL * N;
  if (N <= 0 || D <= 0 || F < 0 || H < 0 || E2 < 0 || E2 >= BIG ||
      rounds < 0 || smem != need ||
      static_cast<long long>(D) * N * (scratch ? 4 : 1) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  SpfArgs a{row_ptr, col_v, col_w, col_e, dsts,   flow_ptr, flow_ids,
            src,     scratch, dist, nh_edge, nh_node, path, hops,
            reached, prof,  N,     rounds, H,      E2,      inf,
            slack};
  if (prof)
    return scratch ? launch(as_spf<true, true>, a, D, SPF_THREADS, 0, st)
                   : launch(as_spf<false, true>, a, D, SPF_THREADS, need, st);
  return scratch ? launch(as_spf<true, false>, a, D, SPF_THREADS, 0, st)
                 : launch(as_spf<false, false>, a, D, SPF_THREADS, need, st);
}

// The draws and the fluid stage over the C x R grid: the tables' blob
// (words ints, as_flows.py::fluid_tables), fm (F), scale (C), the run's key
// (2) int64, reached (F) bool, lfrac in and out (C, R, L) (null: zeros, not
// written); writes goodput, delay, frac (C, R, F), max_util (C, R) and, where
// z_out is not null, the draws (R, F).  ints: F, L, FH (the flow-hops),
// words, C, R, rounds, the shared bytes a CTA (as tpudes_torch/parallel/
// as_cuda.py::fluid_smem_bytes counts them), fold; floats: the jitter,
// -jitter^2 / 2, the utilisation floor and the utilisation cap of the
// delay; prof: the probe's words (null: the main instantiation).
extern "C" int as_fluid_launch(
    const int* blob, const float* fm, const float* scale,
    const long long* key, const uint8_t* reached, const float* lfrac_in,
    float* lfrac_out, float* goodput, float* delay, float* frac,
    float* max_util, float* z_out, long long* prof, int F, int L, int FH,
    int words, int C, int R, int rounds, int smem, int fold, float jitter,
    float neg_hj2, float util_min, float rho_max, cudaStream_t st) {
  using namespace as_kernel;
  const Blob b(F, L, FH);
  const long long need =
      4LL * (b.off[8] + 2LL * L + 3LL * F + FH + FLUID_THREADS / 32);
  if (F <= 0 || L < 0 || FH < 0 || C <= 0 || R <= 0 || rounds < 1 ||
      words != b.off[8] || smem != need ||
      static_cast<long long>(C) * R >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  FluidArgs a{blob,     fm,      scale,    key,     reached, lfrac_in,
              lfrac_out, goodput, delay,   frac,    max_util, z_out,
              prof,     F,       L,        FH,      C,       R,
              rounds,   fold,    jitter,   neg_hj2, util_min, rho_max};
  return prof ? launch(as_fluid<true>, a, R, FLUID_THREADS, need, st)
              : launch(as_fluid<false>, a, R, FLUID_THREADS, need, st);
}

// The draw's erf_inv (as_fluid's, xla_math::xla_erf_inv) of n floats: a
// check entry, not the main path.
extern "C" int as_erf_inv_check(const float* x, float* out, long long n,
                                cudaStream_t st) {
  using namespace as_kernel;
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long blocks = (n + 255) / 256;
  void* args[] = {&x, &out, &n};
  const cudaError_t e = cudaLaunchKernel(
      erf_inv_kernel,
      dim3(static_cast<unsigned>(blocks < 4096 ? blocks : 4096)), dim3(256),
      args, 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
