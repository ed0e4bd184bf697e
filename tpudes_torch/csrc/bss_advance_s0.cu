// bss_advance_s0.cu — bss_advance.cuh's kernel for 5 to 32 slots a lane,
// held in local memory (N 129..1024), every arm: one translation unit of
// the library, built in parallel with the others.

#include "bss_advance.cuh"

namespace bss_kernel {

cudaError_t launch_slots0(bool agg, bool mob, bool trf, const Launch& a) {
  return launch_arm<0, false>(agg, mob, trf, a);
}

}  // namespace bss_kernel
