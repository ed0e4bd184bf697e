// as_flows.cu — the AS flow engine's two kernels, and their C interface.
//
// Replaces the reference's routing stage and fluid fixed point,
// tpudes/parallel/as_flows.py:227-267 (device_spf: a lax.scan of
// Bellman-Ford rounds, each an edge-parallel scatter-min over the (D, N)
// distance table, then the next-hop scatter) and :309-377 with the
// while_loop at :485-518 (the fluid rounds, the delay sum and the outputs);
// XLA code, no pallas_call.  The plain versions are
// parallel/as_flows.py's spf_math and fluid_math, which these kernels equal
// bit for bit.
//
// as_spf: one CTA a destination row d.  The directed edges (the E links as
// given, then reversed) come as a CSR grouped by source node u, each entry
// holding v, the weight w and the directed index e.  The row's two
// distance buffers sit in shared memory while 2 N floats fit (the bench's
// 10,000 nodes take 80 KB), else in device memory (the GLOBAL
// instantiation, the same code).  Each round is a Jacobi round, new[u] =
// min(old[u], min over u->v of old[v] + w), every candidate from the
// round's old buffer, as the reference's scatter-min reads the round's old
// table; a round that changed nothing ends the loop (the rest would change
// nothing either).  Then each node's next hop: best = min(INF, min over u->v
// of w + dist[v]), and the smallest directed index e among the edges whose
// score is at most best * f32(1 + 1e-6), its v the next node (-1 where no
// edge qualifies).  Unreachable nodes keep INF = 1e30 and still get a next
// hop (1e30 + w is 1e30 in f32), as in the reference.
//
// as_fluid: one CTA a (point, replica) of the C x R grid.  The caller
// builds, once a run, the touched directed links compacted to L, each
// flow-hop's compact link (F, H) (-1 past the path's end), each link's
// contributions as a CSR in (hop, flow) order (a slot is h F + f) and the
// links' folded f32 constants c = 1 / cap, k = 8 pkt / cap and dly.  In
// shared memory a CTA keeps lfrac and util of the L links, the F flows' lg
// and rates, and the H F contributions.  Each round:
//   1. each flow walks its hops: its contribution rate * exp(lg), then
//      lg += lfrac[link];
//   2. each link sums its contributions in list order from 0.0f (the CPU
//      applies a scatter's duplicate updates in update order, hop after
//      hop), util = load * c, lfrac = log(min(1 / max(util, 1e-9), 1));
// with a barrier after each.  Untouched links have util 0 and lfrac 0, so
// max_util is max(0, max over L).  Then each flow's delay, the sum in hop
// order of fma(q, k, k) + dly with q = rho / (1 - rho), rho = min(util,
// 0.99) (fma(q, k, k + dly) where the caller says the constants fold), and
// its outputs.  No sum uses atomics: each is one thread's, in a fixed order.
//
// The arithmetic is xla_math.cuh's (the reference's compiled exp, log and
// multiply-add); every other product, sum and division is rounded on its
// own (__fmul_rn, __fadd_rn, __fdiv_rn), which nvcc does not contract.
//
// Bound (chip_smoke.py's as_spf_bound, as_fluid_bound).  as_spf must write
// its three (D, N) tables (15 MB at bench_as's 10,000 nodes and 127
// destinations): bytes bound it, not its few additions a relaxation.  Its
// time goes to latency instead: each round a CTA walks the whole CSR, whose
// 480 KB are read from L2, node by node, with a barrier a round; the early
// exit keeps the rounds to those the graph needs plus one.  as_fluid is
// bound by operations, its exp and log chains over the f64 multiply-add
// (fma32); each of its 1,024 CTAs runs a few hundred flow-hops, every
// operand in shared memory.  Both are simple first: a faster design is a
// later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_math.cuh"

extern __shared__ __align__(16) unsigned char dyn_smem[];

namespace as_kernel {

constexpr int SPF_THREADS = 1024;
constexpr int FLUID_THREADS = 128;
constexpr int BIG = 1 << 30;
// the shared memory a CTA may opt in to
constexpr long long SMEM_LIMIT = 227 * 1024;

struct SpfArgs {
  const int* row_ptr;  // (N + 1,)
  const int* col_v;    // (2E,) in CSR order
  const float* col_w;
  const int* col_e;
  const int* dsts;     // (D,)
  float* scratch;      // (D, 2, N) for GLOBAL, else null
  float* dist;         // (D, N)
  int* nh_edge;
  int* nh_node;
  int N, rounds;
  float inf, slack;
};

template <bool GLOBAL>
__global__ void __launch_bounds__(SPF_THREADS) as_spf(SpfArgs a) {
  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = a.N;
  float* buf0;
  int* flags;
  if (GLOBAL) {
    buf0 = a.scratch + static_cast<long long>(d) * 2 * N;
    flags = reinterpret_cast<int*>(dyn_smem);
  } else {
    buf0 = reinterpret_cast<float*>(dyn_smem);
    flags = reinterpret_cast<int*>(dyn_smem + 8LL * N);
  }
  float* cur = buf0;
  float* nxt = buf0 + N;
  const int dst = a.dsts[d];
  for (int u = tid; u < N; u += SPF_THREADS) cur[u] = u == dst ? 0.0f : a.inf;
  if (tid < 3) flags[tid] = 0;
  __syncthreads();
  // round r raises flags[r % 3] and reads it after the barrier; thread 0
  // clears the flag of round r + 1, which its readers read two barriers ago
  for (int r = 0; r < a.rounds; ++r) {
    if (tid == 0) flags[(r + 1) % 3] = 0;
    int changed = 0;
    for (int u = tid; u < N; u += SPF_THREADS) {
      const float old = cur[u];
      float m = old;
      for (int j = a.row_ptr[u]; j < a.row_ptr[u + 1]; ++j)
        m = fminf(m, __fadd_rn(cur[a.col_v[j]], a.col_w[j]));
      nxt[u] = m;
      changed |= m != old;
    }
    if (changed) flags[r % 3] = 1;
    __syncthreads();
    const int any = flags[r % 3];
    float* t = cur;
    cur = nxt;
    nxt = t;
    if (!any) break;
  }
  const long long row = static_cast<long long>(d) * N;
  for (int u = tid; u < N; u += SPF_THREADS) {
    const int j0 = a.row_ptr[u], j1 = a.row_ptr[u + 1];
    float best = a.inf;
    for (int j = j0; j < j1; ++j)
      best = fminf(best, __fadd_rn(a.col_w[j], cur[a.col_v[j]]));
    const float thr = __fmul_rn(best, a.slack);
    int nh = BIG, nv = -1;
    for (int j = j0; j < j1; ++j) {
      const float s = __fadd_rn(a.col_w[j], cur[a.col_v[j]]);
      if (s <= thr && a.col_e[j] < nh) {
        nh = a.col_e[j];
        nv = a.col_v[j];
      }
    }
    a.dist[row + u] = cur[u];
    a.nh_edge[row + u] = nh;
    a.nh_node[row + u] = nv;
  }
}

struct FluidArgs {
  const int* hop_link;  // (F, H), -1 past the path's end
  const int* ptr;       // (L + 1,)
  const int* slot;      // contributions' slots h F + f, (hop, flow) order
  const float* c;       // (L,) 1 / cap
  const float* k;       // (L,) 8 pkt / cap
  const float* dly;     // (L,)
  const float* fm;      // (F,) nominal rate x the workload's multiplier
  const float* scale;   // (C,)
  const float* z;       // (R, F)
  const uint8_t* reached;  // (F,)
  const float* lfrac_in;   // (C, R, L) or null: zeros
  float* lfrac_out;        // (C, R, L) or null
  float* goodput;          // (C, R, F)
  float* delay;
  float* frac;
  float* max_util;         // (C, R)
  int F, H, L, R, rounds, fold;
  float jitter, neg_hj2, util_min, rho_max;
};

__global__ void __launch_bounds__(FLUID_THREADS) as_fluid(FluidArgs a) {
  const int row = blockIdx.x;  // c R + r
  const int c = row / a.R, r = row % a.R;
  const int tid = threadIdx.x;
  const int F = a.F, H = a.H, L = a.L;
  float* lfrac = reinterpret_cast<float*>(dyn_smem);
  float* util = lfrac + L;
  float* lg = util + L;
  float* rate = lg + F;
  float* contrib = rate + F;
  float* warp_max = contrib + static_cast<long long>(H) * F;
  const long long lrow = static_cast<long long>(row) * L;
  const long long frow = static_cast<long long>(row) * F;

  for (int l = tid; l < L; l += FLUID_THREADS) {
    lfrac[l] = a.lfrac_in ? a.lfrac_in[lrow + l] : 0.0f;
    util[l] = 0.0f;
  }
  for (int f = tid; f < F; f += FLUID_THREADS) {
    const float e = xla_math::xla_exp(
        xla_math::fma32(a.z[static_cast<long long>(r) * F + f], a.jitter,
                        a.neg_hj2));
    rate[f] = a.reached[f]
                  ? __fmul_rn(__fmul_rn(a.fm[f], a.scale[c]), e)
                  : 0.0f;
    lg[f] = 0.0f;
  }
  __syncthreads();

  for (int round = 0; round < a.rounds; ++round) {
    // 1. each flow's contributions along its path, in hop order
    for (int f = tid; f < F; f += FLUID_THREADS) {
      const int* hl = a.hop_link + static_cast<long long>(f) * H;
      float g = 0.0f;
      for (int h = 0; h < H; ++h) {
        const int l = hl[h];
        if (l < 0) break;
        contrib[h * F + f] = __fmul_rn(rate[f], xla_math::xla_exp(g));
        g = __fadd_rn(g, lfrac[l]);
      }
      lg[f] = g;
    }
    __syncthreads();
    // 2. each link's load, its contributions in (hop, flow) order
    for (int l = tid; l < L; l += FLUID_THREADS) {
      float load = 0.0f;
      for (int j = a.ptr[l]; j < a.ptr[l + 1]; ++j)
        load = __fadd_rn(load, contrib[a.slot[j]]);
      const float u = __fmul_rn(load, a.c[l]);
      util[l] = u;
      lfrac[l] = xla_math::xla_log(
          fminf(__fdiv_rn(1.0f, fmaxf(u, a.util_min)), 1.0f));
    }
    __syncthreads();
  }

  // the delays and the outputs
  for (int f = tid; f < F; f += FLUID_THREADS) {
    const int* hl = a.hop_link + static_cast<long long>(f) * H;
    float dl = 0.0f;
    for (int h = 0; h < H; ++h) {
      const int l = hl[h];
      if (l < 0) break;
      const float rho = fminf(util[l], a.rho_max);
      const float q = __fdiv_rn(rho, __fsub_rn(1.0f, rho));
      const float ld =
          a.fold ? xla_math::fma32(q, a.k[l], __fadd_rn(a.k[l], a.dly[l]))
                 : __fadd_rn(xla_math::fma32(q, a.k[l], a.k[l]), a.dly[l]);
      dl = __fadd_rn(dl, ld);
    }
    const bool reached = a.reached[f] != 0;
    const float fr = reached ? xla_math::xla_exp(lg[f]) : 0.0f;
    a.frac[frow + f] = fr;
    a.goodput[frow + f] = __fmul_rn(rate[f], fr);
    a.delay[frow + f] = reached ? dl : INFINITY;
  }
  float m = 0.0f;
  for (int l = tid; l < L; l += FLUID_THREADS) m = fmaxf(m, util[l]);
  for (int s = 16; s > 0; s >>= 1) m = fmaxf(m, __shfl_xor_sync(~0u, m, s));
  if ((tid & 31) == 0) warp_max[tid / 32] = m;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < FLUID_THREADS / 32; ++w) m = fmaxf(m, warp_max[w]);
    a.max_util[row] = m;
  }
  if (a.lfrac_out)
    for (int l = tid; l < L; l += FLUID_THREADS)
      a.lfrac_out[lrow + l] = lfrac[l];
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
  void* args[] = {const_cast<A*>(&a)};
  const cudaError_t e = cudaLaunchKernel(kernel, dim3(blocks), dim3(threads),
                                         args, static_cast<size_t>(smem), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace as_kernel

// The routing stage: the CSR row_ptr (N + 1) int32, col_v, col_w, col_e
// (2E) int32 / f32 / int32, the D destinations; scratch (D, 2, N) f32 for
// the rows kept in device memory (null: shared memory, 8 N + 16 bytes a
// CTA); writes dist (D, N) f32, nh_edge and nh_node (D, N) int32.
extern "C" int as_spf_launch(const int* row_ptr, const int* col_v,
                             const float* col_w, const int* col_e,
                             const int* dsts, float* scratch, float* dist,
                             int* nh_edge, int* nh_node, int N, int D,
                             int rounds, int smem, float inf, float slack,
                             cudaStream_t st) {
  using namespace as_kernel;
  const long long need = scratch ? 16 : 8LL * N + 16;
  if (N <= 0 || D <= 0 || rounds < 0 || smem != (scratch ? 0 : need) ||
      static_cast<long long>(D) * N >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  SpfArgs a{row_ptr, col_v, col_w, col_e, dsts, scratch, dist, nh_edge,
            nh_node, N, rounds, inf, slack};
  return scratch ? launch(as_spf<true>, a, D, SPF_THREADS, need, st)
                 : launch(as_spf<false>, a, D, SPF_THREADS, need, st);
}

// The fluid stage over the C x R grid: hop_link (F, H), ptr (L + 1), slot,
// c, k, dly (L), fm (F), scale (C), z (R, F), reached (F) bool, lfrac in and
// out (C, R, L) (null: zeros, not written); writes goodput, delay, frac (C,
// R, F) and max_util (C, R).  ints: F, H, L, C, R, rounds, the shared bytes
// a CTA (as tpudes_torch/parallel/as_cuda.py::fluid_smem_bytes counts
// them), fold; floats: the jitter, -jitter^2 / 2, the utilisation floor and
// the utilisation cap of the delay.
extern "C" int as_fluid_launch(
    const int* hop_link, const int* ptr, const int* slot, const float* c,
    const float* k, const float* dly, const float* fm, const float* scale,
    const float* z, const uint8_t* reached, const float* lfrac_in,
    float* lfrac_out, float* goodput, float* delay, float* frac,
    float* max_util, int F, int H, int L, int C, int R, int rounds, int smem,
    int fold, float jitter, float neg_hj2, float util_min, float rho_max,
    cudaStream_t st) {
  using namespace as_kernel;
  const long long need =
      4LL * (2LL * L + 2LL * F + static_cast<long long>(H) * F +
             FLUID_THREADS / 32);
  if (F <= 0 || H < 0 || L < 0 || C <= 0 || R <= 0 || rounds < 1 ||
      smem != need || static_cast<long long>(C) * R >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  FluidArgs a{hop_link, ptr,     slot,     c,        k,     dly,
              fm,       scale,   z,        reached,  lfrac_in,
              lfrac_out, goodput, delay,   frac,     max_util,
              F,        H,       L,        R,        rounds, fold,
              jitter,   neg_hj2, util_min, rho_max};
  return launch(as_fluid, a, C * R, FLUID_THREADS, need, st);
}
