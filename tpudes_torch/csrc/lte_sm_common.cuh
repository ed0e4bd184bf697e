// lte_sm_common.cuh — what the two LTE SM kernels share: the constants, the
// argument structs, the scheduler metric, the BLER tail, and one UE's TB
// decode + HARQ update for one TTI.
//
// Both kernels (lte_sm_step.cu, one TTI per launch; lte_sm_advance.cu, many
// TTIs per launch) are bit-identical to the plain PyTorch core
// (tpudes_torch/parallel/kernels_cuda.py::sm_step_math) on the card, so the
// arithmetic here follows that core exactly: every product and sum is
// rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn, so nvcc cannot
// contract them into an FMA), divisions are IEEE (__fdiv_rn), sqrt is
// __fsqrt_rn, the tail is erfcf, and the order of evaluation is the plain
// core's.  Build without --use_fast_math.  The build digest
// (tpudes_torch/_build.py) covers this header.
//
// bf16 (the BF16 template flag, precision="bf16"): a value is rounded to
// bf16 with __float2bfloat16_rn and widened back exactly where the plain
// core calls round_bf16 (tpudes_torch/ops/lte.py), which is where the
// reference's jitted step rounds: the metric's rate and average, the BLER
// argument's operands and numerator, but not the quotients.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lte_sm {

constexpr float kNeg = -1e30f;  // the "no candidate" metric fill
constexpr int kHarqMaxTx = 4;   // tpudes/models/lte/scheduler.py:27
constexpr int kHarqRtt = 8;     // tpudes/models/lte/scheduler.py:26
constexpr float kRePerRb = 120.0f;
constexpr float kDispersion = 1.4f;
constexpr float kTargetQ = 1.281551f;
// scheduler family bounds (kernels_pallas.py:89-91)
constexpr int kPfMax = 2;
constexpr int kRrMax = 4;
constexpr int kMtMax = 6;

// per-program rows; cell_order / cell_start only the multi-TTI kernel reads
struct Consts {
  const float *mi0, *rate0, *eff0, *ecr0;
  const int *eligible, *pos, *count_u, *serving, *count_c;
  const int *cell_order, *cell_start;
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

struct Params {
  int E, U, n_rbg, rbg_size, n_rb, sid;
  float alpha, one_minus_alpha, inv_sqrt2;
};

// one UE's state in one replica (every SM_STATE field but rr_ptr)
struct Ue {
  float avg;
  int pend;
  float p_mi, p_tbb;
  int p_nrbg, p_txc, p_due, rx_lo, rx_hi, new_tbs, retx, drops, ok_cnt;
};

__device__ __forceinline__ Ue load_ue(const StateIn& si, int i) {
  return Ue{si.avg[i],    si.pend[i],    si.p_mi[i],    si.p_tbb[i],
            si.p_nrbg[i], si.p_txc[i],   si.p_due[i],   si.rx_lo[i],
            si.rx_hi[i],  si.new_tbs[i], si.retx[i],    si.drops[i],
            si.ok_cnt[i]};
}

__device__ __forceinline__ void store_ue(const StateOut& so, int i,
                                         const Ue& s) {
  so.avg[i] = s.avg;
  so.pend[i] = s.pend;
  so.p_mi[i] = s.p_mi;
  so.p_tbb[i] = s.p_tbb;
  so.p_nrbg[i] = s.p_nrbg;
  so.p_txc[i] = s.p_txc;
  so.p_due[i] = s.p_due;
  so.rx_lo[i] = s.rx_lo;
  so.rx_hi[i] = s.rx_hi;
  so.new_tbs[i] = s.new_tbs;
  so.retx[i] = s.retx;
  so.drops[i] = s.drops;
  so.ok_cnt[i] = s.ok_cnt;
}

// x rounded to the nearest bf16 (ties to even) and widened back when BF16
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// the FF-MAC family metric of a candidate (sm_dispatch): PF rate / avg, RR
// minus the UE's distance ahead of the cell's pointer, MT rate, BET -avg
template <bool BF16>
__device__ __forceinline__ float metric(int sid, float rate0, float avg,
                                        int pos, int rr_ptr, int count_u) {
  if (sid <= kPfMax) return __fdiv_rn(rnd<BF16>(rate0),
                                      fmaxf(rnd<BF16>(avg), 1.0f));
  if (sid <= kRrMax) {
    const int d = pos - rr_ptr;
    return -static_cast<float>(((d % count_u) + count_u) % count_u);
  }
  if (sid <= kMtMax) return rnd<BF16>(rate0);
  return -rnd<BF16>(avg);
}

template <bool BF16>
__device__ __forceinline__ float tb_bler(float mi, float ecr, float tbb,
                                         float inv_sqrt2) {
  const float sigma = __fdiv_rn(kDispersion, __fsqrt_rn(fmaxf(tbb, 24.0f)));
  const float margin = __fmul_rn(kTargetQ, sigma);
  const float num = rnd<BF16>(
      __fsub_rn(rnd<BF16>(mi), rnd<BF16>(__fsub_rn(ecr, margin))));
  const float z = __fdiv_rn(num, rnd<BF16>(sigma));
  const float b = __fmul_rn(0.5f, erfcf(__fmul_rn(z, inv_sqrt2)));
  return fminf(fmaxf(b, 0.0f), 1.0f);
}

// TB bits, HARQ-IR decode and the state update of one UE at TTI t
// (sm_decode + sm_update): `fit` = its due retx was admitted, `winner` = it
// won its cell's remaining `new_nrbg` RBGs.  Every new value is computed
// from the old state before any field is written.  Returns the bits the TTI
// delivered (0 unless the TB decoded), an integer below 2^24.
template <bool BF16>
__device__ __forceinline__ float decode_update(Ue& s, bool fit, bool winner,
                                               int new_nrbg, float coin,
                                               float eff0, float mi0,
                                               float ecr0, int t,
                                               const Params& p) {
  const int new_nrb = min(new_nrbg * p.rbg_size, p.n_rb);
  const float tb_new = floorf(
      __fmul_rn(__fmul_rn(eff0, static_cast<float>(new_nrb)), kRePerRb));
  const bool tx = fit || winner;
  const float tbb_tx = fit ? s.p_tbb : tb_new;
  const float mi_tx = fit ? fminf(__fadd_rn(s.p_mi, mi0), 1.0f) : mi0;
  const float bler = tb_bler<BF16>(mi_tx, ecr0, tbb_tx, p.inv_sqrt2);
  const bool ok = tx && coin >= bler;

  const bool fail = tx && !ok;
  const int txc_after = fit ? s.p_txc + 1 : 1;
  const bool dropped = fail && txc_after >= kHarqMaxTx;
  const bool repend = fail && !dropped;
  // a due TB that did not fit the RBG budget stays pending
  const bool keep = s.pend != 0 && !fit;
  const float served = ok ? tbb_tx : 0.0f;
  const int lo = s.rx_lo + static_cast<int>(served);

  s.avg = __fadd_rn(__fmul_rn(p.one_minus_alpha, s.avg),
                    __fmul_rn(__fmul_rn(p.alpha, served), 1000.0f));
  s.pend = (keep || repend) ? 1 : 0;
  if (repend) {
    s.p_mi = mi_tx;
    s.p_tbb = tbb_tx;
    if (!fit) s.p_nrbg = new_nrbg;
    s.p_txc = txc_after;
    s.p_due = t + kHarqRtt;
  }
  // rx_lo rolls into rx_hi at 2^20 (<= 1e5 bits/TTI)
  s.rx_lo = lo & 0xFFFFF;
  s.rx_hi += lo >> 20;
  s.new_tbs += winner ? 1 : 0;
  s.retx += fit ? 1 : 0;
  s.drops += dropped ? 1 : 0;
  s.ok_cnt += ok ? 1 : 0;
  return served;
}

}  // namespace lte_sm
