// bss_advance.cu — the C interface of the BSS event loop's persistent
// kernel (bss_advance.cuh: the design, the bound, the arms).  Each slot
// count's instantiations build in their own translation unit
// (bss_advance_s1.cu .. _s4.cu, _s0.cu past BSS_REG_SLOTS), in parallel.

#include "bss_advance.cuh"

// the launcher below has a case (and bss_advance_s*.cu a unit) for each
// slot count held in registers
static_assert(BSS_REG_SLOTS == 4, "one case per register slot count");

// mob and tr (host structs, parallel/bss_cuda.py's MobArgs / TrafficArgs)
// turn the MOB and TRF arms on; null leaves them off.  slots, blocks and
// shared are the launch's geometry as bss_cuda.py::launch_geometry gives
// it, checked here.  prof, if not null, takes the probe's (C R,
// BSS_PROF_STAGES) cycles and runs the probe in place of the main path.
extern "C" int bss_advance_launch(
    const float* rx_w, const uint8_t* det, const int* interval,
    const int* stop, const long long* key, const int* t,
    const int* next_arr, const int* queue, const int* ap_pend,
    const int* bcn_pend, const int* backoff, const int* hold,
    const uint8_t* immediate, const int* cw, const int* retries,
    const int* busy_until, const int* srv_rx, const int* cli_rx,
    const int* tx_data, const int* drops, const int* geom_t, int* o_t,
    int* o_next_arr, int* o_queue, int* o_ap_pend, int* o_bcn_pend,
    int* o_backoff, int* o_hold, uint8_t* o_immediate, int* o_cw,
    int* o_retries, int* o_busy_until, int* o_srv_rx, int* o_cli_rx,
    int* o_tx_data, int* o_drops, int* o_geom_t, int* done, int* t_next,
    uint8_t* pending, int R, int N, int aifs, int data_dur, int resp_dur,
    int exch_beacon, const int* sim_end, const int* step0, int C, int step1,
    float nbits, float noise_w, float scale, float factor, float lc0,
    float lc1, float lc2, float lc3, float lc4, float lc5, float lc6,
    float lc7, float lc8, float lc9, float e0, float e1, float e2, float e3,
    float e4, float e5, float e6, float e7, float e8, float e9, float b,
    int mask, int K, int preamble, float sub8, float inv_ndbps, float rate,
    const void* mob_args, const void* tr_args, int slots, int blocks,
    int shared, long long* prof, void* stream) {
  using namespace bss_kernel;
  const Mob* mob = static_cast<const Mob*>(mob_args);
  const Traffic* tr = static_cast<const Traffic*>(tr_args);
  if (R <= 0 || N <= 0 || N > BSS_MAX_N || C <= 0 || C > BSS_MAX_POINTS ||
      K <= 0 || K > BSS_MAX_MPDUS || step1 > BSS_MAX_STEP ||
      static_cast<long long>(C) * R * N >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (mob && (mob->stride <= 0 || mob->W < 2 || mob->n_seg <= 0))
    return cudaErrorInvalidValue;
  if (tr && (tr->S <= 0 || tr->C <= 0 || tr->K <= 0 || tr->epoch_us <= 0))
    return cudaErrorInvalidValue;
  // the geometry the wrapper computed must be this kernel's
  const int rows = C * R, rb = row_bytes(N, mob != nullptr);
  if (slots != (N + 31) / 32 ||
      blocks != (rows + BSS_ROWS_PER_BLOCK - 1) / BSS_ROWS_PER_BLOCK ||
      shared != BSS_ROWS_PER_BLOCK * rb)
    return cudaErrorInvalidValue;
  if (prof && slots != BSS_PROF_SLOTS) return cudaErrorInvalidValue;
  Launch a{};
  for (int p = 0; p < C; ++p) {
    if (step0[p] < 0 || step1 < step0[p]) return cudaErrorInvalidValue;
    a.pts.sim_end[p] = sim_end[p];
    a.pts.step0[p] = step0[p];
  }
  const Psr psr{scale, factor,
                {lc0, lc1, lc2, lc3, lc4, lc5, lc6, lc7, lc8, lc9},
                {e0, e1, e2, e3, e4, e5, e6, e7, e8, e9}, b, mask};
  a.c = Consts{rx_w,     det,      interval,    stop,    N,
               aifs,     data_dur, resp_dur,    exch_beacon,
               nbits,    noise_w,  psr,         K,       preamble,
               sub8,     inv_ndbps, rate};
  a.si = StateIn{t,          next_arr, queue,   ap_pend, bcn_pend,
                 backoff,    hold,     immediate, cw,    retries,
                 busy_until, srv_rx,   cli_rx,  tx_data, drops,
                 geom_t};
  a.so = StateOut{o_t,          o_next_arr, o_queue,   o_ap_pend,
                  o_bcn_pend,   o_backoff,  o_hold,    o_immediate,
                  o_cw,         o_retries,  o_busy_until, o_srv_rx,
                  o_cli_rx,     o_tx_data,  o_drops,   o_geom_t};
  a.mob = mob ? *mob : Mob{};
  a.tr = tr ? *tr : Traffic{};
  a.key = key;
  a.done = done;
  a.t_next = t_next;
  a.pending = pending;
  a.g = Grid{rows, R, rb, step1};
  a.prof = prof;
  a.blocks = blocks;
  a.shared = shared;
  a.st = static_cast<cudaStream_t>(stream);
  const bool agg = K > 1, m = mob != nullptr, f = tr != nullptr;
  cudaError_t e;
  if (prof) {
    e = launch_probe(agg, m, f, a);
  } else {
    switch (slots) {
      case 1: e = launch_slots1(agg, m, f, a); break;
      case 2: e = launch_slots2(agg, m, f, a); break;
      case 3: e = launch_slots3(agg, m, f, a); break;
      case 4: e = launch_slots4(agg, m, f, a); break;
      default: e = launch_slots0(agg, m, f, a); break;
    }
  }
  return static_cast<int>(e);
}
