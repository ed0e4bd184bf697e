// tcp_advance_obs.cu — tcp_advance.cu's OBS arm: the slot loop with the
// obs accumulators and the FlowMonitor columns, one translation unit of
// the library, built in parallel with tcp_advance.cu, so the arms without
// it keep their code.
//
// Replaces the reference's obs arm of the dumbbell step,
// tpudes/parallel/tcp_dumbbell.py:749-784 and :1056-1124 (flow_accumulate
// and flow_ring_write of tpudes/obs/flowmon.py; XLA code): the rules warp
// counts each flow's window reductions; the queue warp keeps each flow's
// consumed losses, FlowMonitor columns and delay histogram in its lane's
// registers, the row's occupancy histogram a bin a lane, and lane 0 writes
// the slot's ring row (the delivery, else the first flow with the most
// drops, else with the most sends) to global memory.  The plain version is
// parallel/tcp_dumbbell.py::obs_slot inside step_math.

#define TCP_OBS_PART
#include "tcp_advance.cu"

namespace tcp_kernel {

int launch_obs(const Args& a, bool red, bool trf, int blocks, int shared,
               cudaStream_t st) {
  if (trf)
    return red ? launch_kernel<true, true, false, true>(a, blocks, shared, st)
               : launch_kernel<false, true, false, true>(a, blocks, shared,
                                                         st);
  return red ? launch_kernel<true, false, false, true>(a, blocks, shared, st)
             : launch_kernel<false, false, false, true>(a, blocks, shared,
                                                        st);
}

}  // namespace tcp_kernel

// tcp_advance_launch's arguments, then the OBS arm's: the N_OBS device
// pointers of the obs state (tcp_dumbbell.py::obs_keys's order, updated in
// place), half the base RTT in seconds, the factor taking a delay to its
// histogram bin (flowmon.py::bin_scale), a packet's bytes and a slot in
// whole microseconds
extern "C" int tcp_advance_obs_launch(TCP_LAUNCH_PARAMS, void* const* obs,
                                      float half, float scale, int pkt,
                                      int slot_us, void* stream) {
  const tcp_kernel::ObsIn o{obs, half, scale, pkt, slot_us};
  return tcp_kernel::launch<false>(TCP_LAUNCH_ARGS, nullptr, stream, &o);
}
