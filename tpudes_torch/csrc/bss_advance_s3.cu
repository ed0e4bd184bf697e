// bss_advance_s3.cu — bss_advance.cuh's kernel for 3 slots a lane
// (N 65..96), every arm, and the stage probe: one translation unit
// of the library, built in parallel with the others.

#include "bss_advance.cuh"

namespace bss_kernel {

cudaError_t launch_slots3(bool agg, bool mob, bool trf, const Launch& a) {
  return launch_arm<3, false>(agg, mob, trf, a);
}

cudaError_t launch_probe(bool agg, bool mob, bool trf, const Launch& a) {
  return launch_arm<BSS_PROF_SLOTS, true>(agg, mob, trf, a);
}

}  // namespace bss_kernel
