// lte_sm_step.cu — one TTI of the full-buffer LTE SM engine, every replica.
//
// Replaces the TPU kernel built by build_sm_step_fn
// (tpudes/parallel/kernels_pallas.py:396, pl.pallas_call at :473), whose
// body is sm_step_math (:371).  It computes what that kernel computes —
// HARQ retx admission against each cell's RBG budget, the FF-MAC metric
// chosen by the scheduler id, the per-cell winner, TB bits, HARQ-IR MI,
// BLER, the decode coin and the HARQ/PF/rx-counter bookkeeping — but not
// block by block: the (U, U) f32 prefix matmul of the admission step is an
// exact integer same-cell prefix sum read from `serving` in shared memory,
// and the (E, U) one-hot reductions are per-cell loops.
//
// Layout: one CTA per replica lane, threads cover the UEs with a
// block-stride loop; per-UE and per-cell intermediates live in shared
// memory (SM_MAX_U / SM_MAX_E, checked by the Python wrapper).  State is
// read from the input buffers and written to separate output buffers, so
// no cross-UE read can see a write of the same launch.
//
// Arithmetic: bit-identical to the plain PyTorch core
// (tpudes_torch/parallel/kernels_cuda.py::sm_step_math) on the card; the
// metric, BLER and per-UE update are lte_sm_common.cuh's, shared with
// lte_sm_advance.cu, in f32 or (template flag BF16, precision="bf16") with
// the reference's bf16 roundings.  The static rows only: a geometry table
// or a traffic backlog runs through lte_sm_advance.cu.
//
// Bound: at E=7, U=210, R=64 one launch reads 14 state arrays + the coin
// (about 0.8 MB) and writes 14 (about 0.75 MB): about 1.5 MB, 0.45 us at
// 3.35 TB/s.  The work is a few hundred flops per UE, so the kernel is
// bound by launch latency at one launch per TTI.  run_lte_sm's main path
// is lte_sm_advance.cu (many TTIs per launch, coins drawn inside); this
// kernel is the single-step route (build_sm_step), where each TTI's coin
// comes from the caller.

#include <cuda_runtime.h>

#include "lte_sm_common.cuh"

#define SM_MAX_U 2048
#define SM_MAX_E 256

namespace {

using namespace lte_sm;

template <bool BF16>
__global__ void lte_sm_step_kernel(Consts c, StateIn si, StateOut so,
                                   const float* __restrict__ coin,
                                   Params p, int t) {
  __shared__ int s_serving[SM_MAX_U];
  __shared__ int s_req[SM_MAX_U];       // RBGs a due retx asks for, else 0
  __shared__ unsigned char s_fit[SM_MAX_U];  // due, then admitted
  __shared__ float s_metric[SM_MAX_U];  // candidate metric, else kNeg
  __shared__ int s_rem[SM_MAX_E];       // RBGs left for new data
  __shared__ int s_win[SM_MAX_E];       // winning UE, -1 for none

  const int U = p.U, E = p.E;
  const int ou = blockIdx.x * U;
  const int oe = blockIdx.x * E;

  // 1. due retransmissions and their RBG requests
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    s_serving[u] = c.serving[u];
    const bool due = si.pend[ou + u] != 0 && si.p_due[ou + u] <= t &&
                     c.eligible[u] != 0;
    s_req[u] = due ? si.p_nrbg[ou + u] : 0;
    s_fit[u] = due;
  }
  __syncthreads();

  // 2. admission: same-cell prefix sum of requests in UE-index order
  //    (thread u only writes s_fit[u], which no other thread reads here)
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    if (s_fit[u]) {
      const int cell = s_serving[u];
      int cum = 0;
      for (int v = 0; v <= u; ++v) cum += s_serving[v] == cell ? s_req[v] : 0;
      s_fit[u] = cum <= p.n_rbg;
    }
  }
  __syncthreads();

  // 3. RBGs each cell has left; each UE's scheduler metric
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int used = 0;
    for (int v = 0; v < U; ++v)
      used += (s_serving[v] == e && s_fit[v]) ? s_req[v] : 0;
    s_rem[e] = p.n_rbg - used;
  }
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    const bool cand = c.eligible[u] != 0 && si.pend[ou + u] == 0;
    const float m = metric<BF16>(p.sid, c.rate0[u], si.avg[ou + u],
                                 c.pos[u], si.rr_ptr[oe + s_serving[u]],
                                 c.count_u[u]);
    s_metric[u] = cand ? m : kNeg;
  }
  __syncthreads();

  // 4. per-cell winner: highest metric, lowest UE index among equals;
  //    it takes every RBG left and advances the RR pointer
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float best = kNeg;
    int win = -1;
    for (int v = 0; v < U; ++v) {
      if (s_serving[v] == e && s_metric[v] > best) {
        best = s_metric[v];
        win = v;
      }
    }
    const bool has_win = best > kNeg && s_rem[e] > 0;
    s_win[e] = has_win ? win : -1;
    so.rr_ptr[oe + e] =
        has_win ? (c.pos[win] + 1) % c.count_c[e] : si.rr_ptr[oe + e];
  }
  __syncthreads();

  // 5. TB bits, HARQ-IR decode and the state update
  for (int u = threadIdx.x; u < U; u += blockDim.x) {
    const int i = ou + u;
    const int e = s_serving[u];
    const bool winner = s_win[e] == u;
    Ue s = load_ue(si, i);
    decode_update<BF16>(s, s_fit[u], winner, winner ? s_rem[e] : 0,
                        coin[i], c.eff0[u], c.mi0[u], c.ecr0[u], t, p);
    store_ue(so, i, s);
  }
}

}  // namespace

extern "C" int lte_sm_step_launch(
    const float* mi0, const float* rate0, const float* eff0,
    const float* ecr0, const int* eligible, const int* pos,
    const int* count_u, const int* serving, const int* count_c,
    const float* coin,
    const float* avg, const int* pend, const float* p_mi, const float* p_tbb,
    const int* p_nrbg, const int* p_txc, const int* p_due, const int* rr_ptr,
    const int* rx_lo, const int* rx_hi, const int* new_tbs, const int* retx,
    const int* drops, const int* ok_cnt,
    float* o_avg, int* o_pend, float* o_p_mi, float* o_p_tbb, int* o_p_nrbg,
    int* o_p_txc, int* o_p_due, int* o_rr_ptr, int* o_rx_lo, int* o_rx_hi,
    int* o_new_tbs, int* o_retx, int* o_drops, int* o_ok_cnt,
    int R, int E, int U, int n_rbg, int rbg_size, int n_rb,
    float alpha, float one_minus_alpha, float inv_sqrt2, int t, int sid,
    int bf16, void* stream) {
  if (U > SM_MAX_U || E > SM_MAX_E || R <= 0) return cudaErrorInvalidValue;
  const Consts c{mi0,     rate0,   eff0,    ecr0,    eligible, pos,
                 count_u, serving, count_c, nullptr, nullptr};
  const StateIn si{avg, pend, p_mi, p_tbb, p_nrbg, p_txc, p_due, rr_ptr,
                   rx_lo, rx_hi, new_tbs, retx, drops, ok_cnt};
  const StateOut so{o_avg, o_pend, o_p_mi, o_p_tbb, o_p_nrbg, o_p_txc,
                    o_p_due, o_rr_ptr, o_rx_lo, o_rx_hi, o_new_tbs, o_retx,
                    o_drops, o_ok_cnt};
  const Params p{E, U, n_rbg, rbg_size, n_rb, sid,
                 alpha, one_minus_alpha, inv_sqrt2};
  const int threads = U >= 256 ? 256 : ((U + 31) / 32) * 32;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    lte_sm_step_kernel<true><<<R, threads, 0, st>>>(c, si, so, coin, p, t);
  else
    lte_sm_step_kernel<false><<<R, threads, 0, st>>>(c, si, so, coin, p, t);
  return static_cast<int>(cudaGetLastError());
}
