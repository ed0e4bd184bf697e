// lte_sm_advance_obs.cu — lte_sm_advance.cu's OBS arm: the kernel with the
// FlowMonitor columns, one translation unit of the library, built in
// parallel with lte_sm_advance.cu, so the arms without it keep their code.
//
// Replaces the reference's obs arm of the TTI loop,
// tpudes/parallel/lte_sm.py:650-757 (flow_accumulate and flow_ring_write of
// tpudes/obs/flowmon.py around K1's step, build_sm_step_fn,
// tpudes/parallel/kernels_pallas.py:396): each UE is a flow, its columns
// updated from the TTI's counter differences by the thread that holds it,
// in registers for the launch; each TTI's ring row is the argmax over the
// CTA's UEs of deliveries (else sends), one 64-bit shared atomicMax a UE
// with an event, written to global memory by thread 0 one TTI later.  The
// reference has the columns only in its static arm, so the OBS arm runs
// static rows and full buffers, at either precision and any point count.
// The plain version is kernels_cuda.sm_obs_tti inside sm_advance_math.

#define LTE_ADV_OBS_PART
#include "lte_sm_advance.cu"

namespace lte_adv {

template <int K>
int launch_obs_k(const Launch& a, bool bf16) {
  return bf16 ? launch_arm<K, false, false, true, true>(a)
              : launch_arm<K, false, false, false, true>(a);
}

int launch_obs(const Launch& a, int K, bool bf16) {
  switch (K) {
    case 1:
      return launch_obs_k<1>(a, bf16);
    case 2:
      return launch_obs_k<2>(a, bf16);
    case 3:
      return launch_obs_k<3>(a, bf16);
    default:
      return launch_obs_k<4>(a, bf16);
  }
}

}  // namespace lte_adv
