// bss_advance_s4.cu — bss_advance.cuh's kernel for 4 slots a lane
// (N 97..128), every arm: one translation unit
// of the library, built in parallel with the others.

#include "bss_advance.cuh"

namespace bss_kernel {

cudaError_t launch_slots4(bool agg, bool mob, bool trf, const Launch& a) {
  return launch_arm<4, false>(agg, mob, trf, a);
}

}  // namespace bss_kernel
