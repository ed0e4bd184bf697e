// wired_advance_obs.cu — wired_advance.cu's OBS arm: the wired engine's
// slot loop with ns-3's FlowMonitor columns, one translation unit of the
// wired_advance library, built in parallel with wired_advance.cu, whose
// kernel and its arms keep their code.
//
// Replaces the reference's obs arm of the windowed slot loop,
// tpudes/parallel/wired.py:635-689 and :735-836 (flow_accumulate and
// flow_ring_write of tpudes/obs/flowmon.py around _make_lane_step.step;
// XLA code, no pallas_call).  The plain version is
// tpudes_torch/parallel/wired.py's advance_math with the obs keys
// (_obs_step a visit, _obs_flush at the window's edge), which this kernel
// equals bit for bit in every state array, column and ring row, in the
// next event and in the step count.
//
// The model is wired_advance.cu's, one lane (every link of the row's
// program served here or a peer's).  A row visits the window's first slot
// t0 (as the reference's clock does; nothing is served there before the
// row's next event), then each of its own next events below t_grant.  At a
// visit s it serves every free link's FIFO head, then:
//  - each packet delivered at s (served on its last hop) is its flow's one
//    delivery of the visit (a flow's last link serves one packet a slot):
//    rx, bytes, the delay deliver - birth (an integer below 2^24 slots, so
//    the reference's f32 mean of the flow's delay sum is that delay),
//    jitter against the flow's last delay, t1 and the histogram bin;
//  - each flow's births in (mark, s] are its sends (tx, bytes, t0): a
//    flow's packets are born at b0 + k period, k < n (b0 its first
//    packet's jittered birth), so each lane counts its flows' births in
//    closed form;
//  - lane 0 writes the visit's ring row at s % 512: the first delivering
//    flow, else the first flow with the most sends, step -1 where neither.
// At the edge the births in (mark, t_grant) are sends at t_grant - 1.
//
// Design: simple first.  One warp a row, one row a CTA; the row's link
// state (free, served), each link's FIFO head key (ready << 32 | packet)
// and, where they fit (``staged``), its packets' hop, ready and flow and
// the link table lo_at, in shared memory, read from and written back to
// global memory once a launch; three passes over the row's packets a visit
// (heads by atomicMin, the serves, the next event); the columns in global
// memory, each flow's read and written by the one lane that handles its
// event of the visit.  No lookahead windows and no packet lists:
// wired_advance.cu's redesign is for the path without the columns.  (One
// pass a visit, each link's least key over all its packets by a warp
// reduction a link, ran 1.44x slower on the card: PERF.md.)
//
// The source also builds with g++ against csrc/mock/cuda_runtime.h, which
// runs it on the CPU (tests/test_torch_wired_mock.py).

#include <cuda_runtime.h>
#include <stdint.h>

extern __shared__ __align__(16) unsigned char dyn_smem[];

namespace wired_obs {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int INF_SLOT = 1 << 30;
constexpr int BIG = 0x7FFFFFFF;
constexpr unsigned long long NO_HEAD = 0xFFFFFFFFFFFFFFFFull;
constexpr short DELIVERED = -1;
constexpr int BINS = 16;
constexpr int RING_CAP = 512;
constexpr int RING_COLS = 5;
constexpr long long SMEM_LIMIT = 227 * 1024;

struct Args {
  const short* lo_at;   // (F, H + 1) local link of each flow's hop
  const int* pkt_flow;  // (P,)
  const int* svc;       // (Lo,) service of each local link
  const int* svcdly;    // (Lo,) service + delay
  const int* f_first;   // (F,) each flow's first packet
  const int* f_period;  // (F,) its CBR period
  const int* f_npk;     // (F,) its packets
  int* hop;  // (R, P) state, in place
  int* ready;
  int* free_;  // (R, Lo)
  int* deliver;
  int* eg_hop;
  int* eg_ready;
  int* served;  // (R, Lo)
  int* next_out;   // (R,)
  int* steps_out;  // (R,)
  const int* birth;  // (R, P) fm_birth
  // the FlowMonitor columns, in place: (R, F), hist (R, F, 16), ring (R,
  // 512, 5)
  int *tx, *txb, *rx, *rxb, *lost;
  float *dsum, *jsum, *dlast, *t0, *t1;
  int *hist, *ring;
  int R, P, F, H, Lo, t_start, t_grant, mark, pkt_bytes;
  int staged;   // the row's packets and lo_at in shared memory
  float scale;  // a delay (slots) to its bin: flowmon.py::bin_scale
};

// the shared bytes a row's CTA takes: a head key, free and served a link,
// and where staged a packet's hop, ready and flow and the flows' lo_at
__host__ __device__ inline long long smem_bytes(int P, int F, int H, int Lo,
                                                bool staged) {
  const long long base = 16LL * Lo;
  return staged ? base + 12LL * P + ((2LL * F * (H + 1) + 15) & ~15LL)
                : base;
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// the births b0 + k per (k < n) in (lo, hi]
__device__ __forceinline__ int births_in(int b0, int per, int n, int lo,
                                         int hi) {
  if (hi <= lo || n <= 0) return 0;
  const long long k_hi =
      min(floor_div(static_cast<long long>(hi) - b0, per),
          static_cast<long long>(n) - 1);
  const long long k_lo =
      max(floor_div(static_cast<long long>(lo) - b0, per) + 1, 0LL);
  return k_hi >= k_lo ? static_cast<int>(k_hi - k_lo + 1) : 0;
}

// a packet's local link at hop h of flow f (a code below 0 where it waits
// at none here)
__device__ __forceinline__ int link_of(const short* lo_at, int H, int h,
                                       int f) {
  return lo_at[static_cast<long long>(f) * (H + 1) + h];
}

// each flow's sends among the births in (lo, hi], at time t_s; returns
// the lane's (most sends, its first flow) for the ring's argmax
__device__ __forceinline__ void sends(const Args& a, int row, int lane,
                                      int lo, int hi, float t_s, int& best,
                                      int& best_f) {
  best = 0;
  best_f = BIG;
  for (int f = lane; f < a.F; f += WARP) {
    const long long q = static_cast<long long>(row) * a.F + f;
    const int b0 = a.birth[static_cast<long long>(row) * a.P + a.f_first[f]];
    const int n = births_in(b0, a.f_period[f], a.f_npk[f], lo, hi);
    if (n > 0) {
      a.tx[q] += n;
      a.txb[q] += n * a.pkt_bytes;
      if (a.t0[q] < 0.0f) a.t0[q] = t_s;
      if (n > best) {
        best = n;
        best_f = f;
      }
    }
  }
}

// one warp a row, one row a CTA
__global__ void __launch_bounds__(WARP)
    wired_advance_obs_kernel(const Args a) {
  const int row = blockIdx.x, lane = threadIdx.x;
  const long long pb = static_cast<long long>(row) * a.P;
  const long long lb = static_cast<long long>(row) * a.Lo;
  unsigned long long* head = reinterpret_cast<unsigned long long*>(dyn_smem);
  int* fr = reinterpret_cast<int*>(head + a.Lo);
  int* sv = fr + a.Lo;
  int* hop = a.hop + pb;
  int* ready = a.ready + pb;
  const int* flow = a.pkt_flow;
  const short* lo_at = a.lo_at;
  const int H = a.H;
  if (a.staged) {
    int* st_hop = sv + a.Lo;
    int* st_ready = st_hop + a.P;
    int* st_flow = st_ready + a.P;
    short* st_lo = reinterpret_cast<short*>(st_flow + a.P);
    for (int p = lane; p < a.P; p += WARP) {
      st_hop[p] = hop[p];
      st_ready[p] = ready[p];
      st_flow[p] = flow[p];
    }
    for (int i = lane; i < a.F * (H + 1); i += WARP) st_lo[i] = lo_at[i];
    hop = st_hop;
    ready = st_ready;
    flow = st_flow;
    lo_at = st_lo;
  }
  for (int l = lane; l < a.Lo; l += WARP) {
    fr[l] = a.free_[lb + l];
    sv[l] = a.served[lb + l];
  }
  for (int p = lane; p < a.P; p += WARP) {
    a.eg_hop[pb + p] = -1;
    a.eg_ready[pb + p] = -1;
  }
  __syncwarp();

  // the least max(ready, free) over the row's packets at its links
  auto next_event = [&]() {
    int m = INF_SLOT;
    for (int p = lane; p < a.P; p += WARP) {
      const int lo = link_of(lo_at, H, hop[p], flow[p]);
      if (lo >= 0) m = min(m, max(ready[p], fr[lo]));
    }
    return __reduce_min_sync(FULL, m);
  };

  int mark = a.mark, steps = 0, nxt = INF_SLOT;
  for (int s = a.t_start; s < a.t_grant;) {
    // the heads of the free links, then their serves
    for (int l = lane; l < a.Lo; l += WARP) head[l] = NO_HEAD;
    __syncwarp();
    for (int p = lane; p < a.P; p += WARP) {
      const int lo = link_of(lo_at, H, hop[p], flow[p]);
      if (lo >= 0 && ready[p] <= s && fr[lo] <= s)
        atomicMin(&head[lo], (static_cast<unsigned long long>(ready[p]) << 32) |
                                 static_cast<unsigned>(p));
    }
    __syncwarp();
    int rx_f = BIG;  // the lane's first flow delivering at s
    for (int p = lane; p < a.P; p += WARP) {
      const int f = flow[p], h = hop[p];
      const int lo = link_of(lo_at, H, h, f);
      if (lo < 0 || ready[p] > s || fr[lo] > s ||
          head[lo] != ((static_cast<unsigned long long>(ready[p]) << 32) |
                       static_cast<unsigned>(p)))
        continue;
      const int arr = s + a.svcdly[lo];
      const int nlo = link_of(lo_at, H, h + 1, f);
      fr[lo] = s + a.svc[lo];
      sv[lo] += 1;
      hop[p] = h + 1;
      ready[p] = arr;
      if (nlo == DELIVERED) {
        a.deliver[pb + p] = arr;
        // the flow's one delivery of the visit, its delay the mean
        const long long q = static_cast<long long>(row) * a.F + f;
        const float d = static_cast<float>(arr - a.birth[pb + p]);
        a.rx[q] += 1;
        a.rxb[q] += a.pkt_bytes;
        a.dsum[q] = __fadd_rn(a.dsum[q], d);
        a.jsum[q] = __fadd_rn(a.jsum[q], a.dlast[q] >= 0.0f
                                             ? fabsf(__fsub_rn(d, a.dlast[q]))
                                             : 0.0f);
        a.dlast[q] = d;
        a.t1[q] = static_cast<float>(s);
        const int bin =
            min(max(__float2int_rz(__fmul_rn(d, a.scale)), 0), BINS - 1);
        a.hist[q * BINS + bin] += 1;
        rx_f = min(rx_f, f);
      } else if (nlo < 0) {
        // a peer's link next: the egress buffers
        a.eg_hop[pb + p] = h + 1;
        a.eg_ready[pb + p] = arr;
      }
    }
    __syncwarp();
    int best, best_f;
    sends(a, row, lane, mark, s, static_cast<float>(s), best, best_f);
    const int first_rx = __reduce_min_sync(FULL, rx_f);
    const int most = __reduce_max_sync(FULL, best);
    const int most_f = __reduce_min_sync(FULL, best == most ? best_f : BIG);
    if (lane == 0) {
      int* w = a.ring + (static_cast<long long>(row) * RING_CAP +
                         s % RING_CAP) * RING_COLS;
      const bool got = first_rx != BIG, sent = most > 0;
      w[0] = got || sent ? s : -1;
      w[1] = s;
      w[2] = got ? first_rx : sent ? most_f : 0;
      w[3] = a.pkt_bytes;
      w[4] = got ? 1 : 0;
    }
    mark = s;
    ++steps;
    __syncwarp();
    nxt = next_event();
    s = max(s + 1, nxt);
  }
  if (steps == 0) nxt = next_event();
  // the window's edge: the births no visit counted
  if (a.t_grant - 1 > mark) {
    int best, best_f;
    sends(a, row, lane, mark, a.t_grant - 1,
          static_cast<float>(a.t_grant - 1), best, best_f);
  }
  __syncwarp();
  for (int l = lane; l < a.Lo; l += WARP) {
    a.free_[lb + l] = fr[l];
    a.served[lb + l] = sv[l];
  }
  if (a.staged) {
    for (int p = lane; p < a.P; p += WARP) {
      a.hop[pb + p] = hop[p];
      a.ready[pb + p] = ready[p];
    }
  }
  if (lane == 0) {
    a.next_out[row] = nxt;
    a.steps_out[row] = steps;
  }
}

}  // namespace wired_obs

// the shared bytes a row's CTA takes: staged where that fits a CTA
extern "C" long long wired_advance_obs_smem(int P, int F, int H, int Lo) {
  using namespace wired_obs;
  const long long staged = smem_bytes(P, F, H, Lo, true);
  return staged <= SMEM_LIMIT ? staged : smem_bytes(P, F, H, Lo, false);
}

// ptrs: a host array of the 29 device pointers of struct Args, in its
// order (lo_at .. ring); ints R, P, F, H, Lo, t, t_grant, the carried mark
// and a packet's bytes; the bin factor; stage (0: the packets stay in
// global memory even where they fit in shared); stream
extern "C" int wired_advance_obs_launch(void* const* ptrs, int R, int P,
                                        int F, int H, int Lo, int t,
                                        int t_grant, int mark,
                                        int pkt_bytes, float scale,
                                        int stage, void* stream) {
  using namespace wired_obs;
  const long long smem = stage ? wired_advance_obs_smem(P, F, H, Lo)
                               : smem_bytes(P, F, H, Lo, false);
  if (R <= 0 || P <= 0 || F <= 0 || H <= 0 || Lo <= 0 || t < 0 ||
      t_grant < 0 || t > INF_SLOT || t_grant > INF_SLOT ||
      static_cast<long long>(R) * P >= (1LL << 31) || smem > SMEM_LIMIT ||
      !(scale > 0.0f))
    return cudaErrorInvalidValue;
  for (int i = 0; i < 29; ++i)
    if (ptrs[i] == nullptr) return cudaErrorInvalidValue;
  Args a{};
  a.lo_at = static_cast<const short*>(ptrs[0]);
  a.pkt_flow = static_cast<const int*>(ptrs[1]);
  a.svc = static_cast<const int*>(ptrs[2]);
  a.svcdly = static_cast<const int*>(ptrs[3]);
  a.f_first = static_cast<const int*>(ptrs[4]);
  a.f_period = static_cast<const int*>(ptrs[5]);
  a.f_npk = static_cast<const int*>(ptrs[6]);
  int* const* q = reinterpret_cast<int* const*>(ptrs);
  a.hop = q[7];
  a.ready = q[8];
  a.free_ = q[9];
  a.deliver = q[10];
  a.eg_hop = q[11];
  a.eg_ready = q[12];
  a.served = q[13];
  a.next_out = q[14];
  a.steps_out = q[15];
  a.birth = q[16];
  a.tx = q[17];
  a.txb = q[18];
  a.rx = q[19];
  a.rxb = q[20];
  a.lost = q[21];
  auto fp = [&](int i) { return reinterpret_cast<float*>(q[i]); };
  a.dsum = fp(22);
  a.jsum = fp(23);
  a.dlast = fp(24);
  a.t0 = fp(25);
  a.t1 = fp(26);
  a.hist = q[27];
  a.ring = q[28];
  a.R = R;
  a.P = P;
  a.F = F;
  a.H = H;
  a.Lo = Lo;
  a.t_start = t;
  a.t_grant = t_grant;
  a.mark = mark;
  a.pkt_bytes = pkt_bytes;
  a.staged = smem > smem_bytes(P, F, H, Lo, false) ? 1 : 0;
  a.scale = scale;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wired_advance_obs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  void* args[] = {&a};
  const cudaError_t e =
      cudaLaunchKernel(wired_advance_obs_kernel, dim3(R), dim3(WARP), args,
                       static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
