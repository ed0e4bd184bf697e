// bss_advance_s2.cu — bss_advance.cuh's kernel for 2 slots a lane
// (N 33..64), every arm: one translation unit
// of the library, built in parallel with the others.

#include "bss_advance.cuh"

namespace bss_kernel {

cudaError_t launch_slots2(bool agg, bool mob, bool trf, const Launch& a) {
  return launch_arm<2, false>(agg, mob, trf, a);
}

}  // namespace bss_kernel
