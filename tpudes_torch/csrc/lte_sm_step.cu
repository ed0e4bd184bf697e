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
// (tpudes_torch/parallel/kernels_cuda.py::sm_step_math) on the card.
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn/
// __fsub_rn, so nvcc cannot contract them into an FMA), divisions are
// IEEE (__fdiv_rn), sqrt is __fsqrt_rn, the tail is erfcf, and the order
// of evaluation is the plain core's.  Build without --use_fast_math.
//
// Bound: at E=7, U=210, R=64 one launch reads 14 state arrays + the coin
// (about 0.8 MB) and writes 14 (about 0.75 MB): about 1.5 MB, 0.45 us at
// 3.35 TB/s.  The work is a few hundred flops per UE, so the kernel is
// bound by launch latency at one launch per TTI.  The later fix is a TTI
// loop inside the kernel with the state kept in shared memory and an
// in-kernel threefry for the coins.

#include <cuda_runtime.h>

#define SM_MAX_U 2048
#define SM_MAX_E 256

namespace {

constexpr float kNeg = -1e30f;
constexpr int kHarqMaxTx = 4;   // tpudes/models/lte/scheduler.py:27
constexpr int kHarqRtt = 8;     // tpudes/models/lte/scheduler.py:26
constexpr float kRePerRb = 120.0f;
constexpr float kDispersion = 1.4f;
constexpr float kTargetQ = 1.281551f;
// scheduler family bounds (kernels_pallas.py:89-91)
constexpr int kPfMax = 2;
constexpr int kRrMax = 4;
constexpr int kMtMax = 6;

struct Consts {
  const float *mi0, *rate0, *eff0, *ecr0;
  const int *eligible, *pos, *count_u, *serving, *count_c;
};

struct StateIn {
  const float *avg;
  const int *pend;
  const float *p_mi, *p_tbb;
  const int *p_nrbg, *p_txc, *p_due, *rr_ptr, *rx_lo, *rx_hi;
  const int *new_tbs, *retx, *drops, *ok_cnt;
};

struct StateOut {
  float *avg;
  int *pend;
  float *p_mi, *p_tbb;
  int *p_nrbg, *p_txc, *p_due, *rr_ptr, *rx_lo, *rx_hi;
  int *new_tbs, *retx, *drops, *ok_cnt;
};

struct Scalars {
  int E, U, n_rbg, rbg_size, n_rb, t, sid;
  float alpha, one_minus_alpha, inv_sqrt2;
};

__device__ __forceinline__ float tb_bler(float mi, float ecr, float tbb,
                                         float inv_sqrt2) {
  const float sigma = __fdiv_rn(kDispersion, __fsqrt_rn(fmaxf(tbb, 24.0f)));
  const float margin = __fmul_rn(kTargetQ, sigma);
  const float z = __fdiv_rn(__fsub_rn(mi, __fsub_rn(ecr, margin)), sigma);
  const float b = __fmul_rn(0.5f, erfcf(__fmul_rn(z, inv_sqrt2)));
  return fminf(fmaxf(b, 0.0f), 1.0f);
}

__global__ void lte_sm_step_kernel(Consts c, StateIn si, StateOut so,
                                   const float* __restrict__ coin,
                                   Scalars p) {
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
    const bool due = si.pend[ou + u] != 0 && si.p_due[ou + u] <= p.t &&
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
    const float avg = si.avg[ou + u];
    float metric;
    if (p.sid <= kPfMax) {
      metric = __fdiv_rn(c.rate0[u], fmaxf(avg, 1.0f));
    } else if (p.sid <= kRrMax) {
      const int n = c.count_u[u];
      const int d = c.pos[u] - si.rr_ptr[oe + s_serving[u]];
      metric = -static_cast<float>(((d % n) + n) % n);
    } else if (p.sid <= kMtMax) {
      metric = c.rate0[u];
    } else {
      metric = -avg;
    }
    s_metric[u] = cand ? metric : kNeg;
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
    const bool fit = s_fit[u];
    const bool winner = s_win[e] == u;
    const int new_nrbg = winner ? s_rem[e] : 0;
    const int new_nrb = min(new_nrbg * p.rbg_size, p.n_rb);
    const float tb_new = floorf(__fmul_rn(
        __fmul_rn(c.eff0[u], static_cast<float>(new_nrb)), kRePerRb));
    const bool tx = fit || winner;
    const float p_tbb = si.p_tbb[i], p_mi = si.p_mi[i];
    const float tbb_tx = fit ? p_tbb : tb_new;
    const float mi_tx =
        fit ? fminf(__fadd_rn(p_mi, c.mi0[u]), 1.0f) : c.mi0[u];
    const float bler = tb_bler(mi_tx, c.ecr0[u], tbb_tx, p.inv_sqrt2);
    const bool ok = tx && coin[i] >= bler;

    const bool fail = tx && !ok;
    const int txc_after = fit ? si.p_txc[i] + 1 : 1;
    const bool dropped = fail && txc_after >= kHarqMaxTx;
    const bool repend = fail && !dropped;
    const bool keep = si.pend[i] != 0 && !fit;
    const float served = ok ? tbb_tx : 0.0f;
    const int lo = si.rx_lo[i] + static_cast<int>(served);

    so.avg[i] = __fadd_rn(__fmul_rn(p.one_minus_alpha, si.avg[i]),
                          __fmul_rn(__fmul_rn(p.alpha, served), 1000.0f));
    so.pend[i] = (keep || repend) ? 1 : 0;
    so.p_mi[i] = repend ? mi_tx : p_mi;
    so.p_tbb[i] = repend ? tbb_tx : p_tbb;
    so.p_nrbg[i] = (repend && !fit) ? new_nrbg : si.p_nrbg[i];
    so.p_txc[i] = repend ? txc_after : si.p_txc[i];
    so.p_due[i] = repend ? p.t + kHarqRtt : si.p_due[i];
    so.rx_lo[i] = lo & 0xFFFFF;
    so.rx_hi[i] = si.rx_hi[i] + (lo >> 20);
    so.new_tbs[i] = si.new_tbs[i] + (winner ? 1 : 0);
    so.retx[i] = si.retx[i] + (fit ? 1 : 0);
    so.drops[i] = si.drops[i] + (dropped ? 1 : 0);
    so.ok_cnt[i] = si.ok_cnt[i] + (ok ? 1 : 0);
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
    void* stream) {
  if (U > SM_MAX_U || E > SM_MAX_E || R <= 0) return cudaErrorInvalidValue;
  const Consts c{mi0, rate0, eff0, ecr0, eligible, pos, count_u, serving,
                 count_c};
  const StateIn si{avg, pend, p_mi, p_tbb, p_nrbg, p_txc, p_due, rr_ptr,
                   rx_lo, rx_hi, new_tbs, retx, drops, ok_cnt};
  const StateOut so{o_avg, o_pend, o_p_mi, o_p_tbb, o_p_nrbg, o_p_txc,
                    o_p_due, o_rr_ptr, o_rx_lo, o_rx_hi, o_new_tbs, o_retx,
                    o_drops, o_ok_cnt};
  const Scalars p{E, U, n_rbg, rbg_size, n_rb, t, sid,
                  alpha, one_minus_alpha, inv_sqrt2};
  const int threads = U >= 256 ? 256 : ((U + 31) / 32) * 32;
  lte_sm_step_kernel<<<R, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      c, si, so, coin, p);
  return static_cast<int>(cudaGetLastError());
}
