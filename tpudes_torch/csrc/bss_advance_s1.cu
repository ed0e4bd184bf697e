// bss_advance_s1.cu — bss_advance.cuh's kernel for 1 slot a lane
// (N <= 32), every arm: one translation unit
// of the library, built in parallel with the others.

#include "bss_advance.cuh"

namespace bss_kernel {

cudaError_t launch_slots1(bool agg, bool mob, bool trf, const Launch& a) {
  return launch_arm<1, false>(agg, mob, trf, a);
}

}  // namespace bss_kernel
