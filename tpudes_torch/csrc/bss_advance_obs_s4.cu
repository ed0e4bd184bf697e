// bss_advance_obs_s4.cu — bss_advance.cuh's OBS arm (the kernel with the
// FlowMonitor columns, tpudes/parallel/replicated.py:1025-1070) for 4 slots a
// lane (N 97..128), every arm: one translation unit of the library, built in
// parallel with the others, so the arms without the columns keep their code.

#include "bss_advance.cuh"

namespace bss_kernel {

cudaError_t launch_obs4(bool agg, bool mob, bool trf, const Launch& a) {
  return launch_arm<4, false, true>(agg, mob, trf, a);
}

}  // namespace bss_kernel
