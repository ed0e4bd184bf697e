// wired_advance.cu — the wired engine's slot loop, and its C interface.
//
// Replaces the reference's windowed slot loop, tpudes/parallel/wired.py:578
// build_wired_advance (the lax.while_loop at :700-836 over
// _make_lane_step.step at :529) and :841 build_wired_space_advance (the same
// step vmapped over rank lanes); XLA code, no pallas_call.  The plain
// version is tpudes_torch/parallel/wired.py's advance_math, which this
// kernel equals bit for bit in every state array, in the next event and in
// the step count.
//
// The model.  Each (lane, replica) row holds P packets (hop, ready) and Lo
// local links (free, served).  A packet waits at the link paths[f][hop] of
// its flow f until it is served; it is the row's while hop < nhops[f] and
// that link is one the lane serves (g2l[link] >= 0).  At slot s every
// served link that is free (free <= s) serves its FIFO head, the least
// (ready, packet id) among its packets with ready <= s: free = s + service,
// served += 1, and the packet moves on at arr = s + service + delay,
// delivered (deliver = arr) past its last hop, parked in the egress buffers
// (eg_hop, eg_ready) where its next link is a peer's, else waiting there.
// A launch first clears the egress, then steps below t_grant, then writes
// the row's next event, the least max(ready, free[link]) over its packets.
// Ingress is not the kernel's: the caller writes a peer's packets into hop
// and ready before the launch (hybrid.py scatters its few entries there).
//
// A warp a row (a CTA of 32 threads), each row on its own clock.  A row's
// next event is the least max(ready, free) over its waiting packets, and a
// step at an earlier slot would serve nothing, so stepping each row from
// its own event to its next gives the reference's state, in which all rows
// share one union clock; only the count of steps differs (the port's is a
// row's own).  A step touches few packets (at the bench's width about ten
// are served a slot of 5,535), so a row keeps an active list and leaves the
// rest alone:
//   refresh at a lower bound b of its next event: one pass over its P
//     packets puts every live packet that arrives by hi = b + span into
//     the list (in packet order: an index in the list orders as the
//     packet id does) with its local link, arrival and hop, and takes pm,
//     the earliest arrival of the live packets left out;
//   step: each list entry atomicMins its key (arrival << 32 | index) into
//     its link's head in shared memory (a min on a 64-bit key is exact in
//     any order); then each lane takes its links: m = min over links of
//     max(free, the head's arrival).  Where m <= hi it is the row's next
//     event (a packet left out arrives after hi), the row steps to slot =
//     max(last + 1, m) and each free link serves its head at slot, which
//     updates the packet's state and its list entry;
//   where m > hi no listed packet acts by hi, and the next event is at
//     least min(m, pm): the row refreshes there.
// Served packets stay in the list; a packet that leaves the row's links
// keeps its entry with no link until the next refresh.  The span trades the
// list's length against the refreshes and does not change the result.
//
// Bound (chip_smoke.py's wired_bound).  The state, 5 P + 2 Lo words a row,
// must be read and written once; the work the data needs is the served
// packet-hops' integer operations.  The kernel is latency-bound: a step is
// a chain of dependent loads (the list entry, then the heads, the served
// packet's flow, its path and its next link) with two warp barriers, and
// a row runs its thousands of steps one after another.  Shared memory
// holds only the link tables (24 Lo + 4 L bytes), so many rows share an SM
// and hide each other's latency; the list lives in device memory (16 bytes
// a packet, L1-resident for the few hundred a row touches).
//
// The source also builds with g++ against csrc/mock/cuda_runtime.h, which
// runs it on the CPU (tests/test_torch_wired_mock.py).

#include <cuda_runtime.h>
#include <stdint.h>

extern __shared__ __align__(16) unsigned char dyn_smem[];

namespace wired_kernel {

constexpr int THREADS = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int INF_SLOT = 1 << 30;
constexpr unsigned long long NO_KEY = ~0ull;
constexpr int MAX_SPAN = 1 << 20;
// the shared memory a CTA may opt in to
constexpr long long SMEM_LIMIT = 227 * 1024;

// a list entry: the packet's row index, its local link (-1: it has left
// the row's links), its arrival there and its hop
struct __align__(16) Entry {
  int p;
  int lo;
  int ready;
  int hop;
};

struct Args {
  const int* paths;     // (K, F, H) global link ids, -1 padded
  const int* nhops;     // (K, F)
  const int* pkt_flow;  // (K, P)
  const int* g2l;       // (K, L) local link row, -1: a peer's
  const int* svc;       // (K, Lo) service of each local link
  const int* svcdly;    // (K, Lo) service + delay
  int* hop;  // (N, P) state, in place
  int* ready;
  int* free_;  // (N, Lo)
  int* deliver;
  int* eg_hop;
  int* eg_ready;
  int* served;  // (N, Lo)
  Entry* list;  // (N, P) scratch
  int* next_out;  // (N)
  int* steps_out;  // (N)
  int R, P, F, H, L, Lo, t0, t_grant, span;
};

// the FIFO order key of list entry i, which arrived at its link at ready:
// the arrival, then the index (the list is in packet order, so the index
// orders as the packet id); and the entry a key names
__device__ __forceinline__ unsigned long long order_key(int ready, int i) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(ready))
          << 32) |
         static_cast<unsigned>(i);
}
__device__ __forceinline__ int key_entry(unsigned long long key) {
  return static_cast<int>(key & 0xFFFFFFFFull);
}

// the local link of packet p at hop h (-1: delivered, or a peer's link)
__device__ __forceinline__ int locate(const int* __restrict__ paths,
                                      const int* __restrict__ nhops,
                                      const int* __restrict__ flow,
                                      const int* g2l, int H, int p, int h) {
  const int f = flow[p];
  if (h < 0 || h >= nhops[f]) return -1;
  return g2l[paths[f * H + h]];
}

__global__ void __launch_bounds__(THREADS) wired_advance(Args a) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const int k = row / a.R;
  const int P = a.P, Lo = a.Lo, L = a.L, H = a.H;
  const int* __restrict__ paths = a.paths + static_cast<long long>(k) * a.F * H;
  const int* __restrict__ nhops = a.nhops + static_cast<long long>(k) * a.F;
  const int* __restrict__ flow = a.pkt_flow + static_cast<long long>(k) * P;
  const long long base = static_cast<long long>(row) * P;
  int* hop = a.hop + base;
  int* ready = a.ready + base;
  int* deliver = a.deliver + base;
  int* eg_hop = a.eg_hop + base;
  int* eg_ready = a.eg_ready + base;
  Entry* list = a.list + base;
  int* row_free = a.free_ + static_cast<long long>(row) * Lo;
  int* row_served = a.served + static_cast<long long>(row) * Lo;

  unsigned long long* head = reinterpret_cast<unsigned long long*>(dyn_smem);
  int* free_ = reinterpret_cast<int*>(head + Lo);
  int* served = free_ + Lo;
  int* svc = served + Lo;
  int* svcdly = svc + Lo;
  int* g2l = svcdly + Lo;
  for (int l = lane; l < Lo; l += THREADS) {
    head[l] = NO_KEY;
    free_[l] = row_free[l];
    served[l] = row_served[l];
    svc[l] = a.svc[k * Lo + l];
    svcdly[l] = a.svcdly[k * Lo + l];
  }
  for (int g = lane; g < L; g += THREADS)
    g2l[g] = a.g2l[static_cast<long long>(k) * L + g];
  // the egress cleared
  for (int p = lane; p < P; p += THREADS) {
    eg_hop[p] = -1;
    eg_ready[p] = -1;
  }
  __syncwarp();

  int steps = 0;
  if (a.t0 < a.t_grant) {
    int b = a.t0;      // no event of the row lies before b
    int s = a.t0 - 1;  // the last step's slot
    while (b < a.t_grant) {
      // refresh: the live packets that arrive by hi join the list
      const int hi = b + a.span;
      int n = 0, pm = INF_SLOT;
      for (int p0 = 0; p0 < P; p0 += THREADS) {
        const int p = p0 + lane;
        int lo = -1, r = 0, h = 0;
        if (p < P) {
          h = hop[p];
          r = ready[p];
          lo = locate(paths, nhops, flow, g2l, H, p, h);
        }
        const bool take = lo >= 0 && r <= hi;
        if (lo >= 0 && r > hi) pm = min(pm, r);
        const unsigned m = __ballot_sync(FULL, take);
        if (take) list[n + __popc(m & ((1u << lane) - 1u))] = Entry{p, lo, r, h};
        n += __popc(m);
      }
      pm = __reduce_min_sync(FULL, pm);
      __syncwarp();
      for (;;) {
        // each link's FIFO head over the list: the least (arrival, index)
        for (int i = lane; i < n; i += THREADS) {
          const Entry e = list[i];
          if (e.lo >= 0) atomicMin(&head[e.lo], order_key(e.ready, i));
        }
        __syncwarp();
        int m = INF_SLOT;
        for (int l = lane; l < Lo; l += THREADS) {
          const unsigned long long hk = head[l];
          if (hk != NO_KEY) m = min(m, max(free_[l], static_cast<int>(hk >> 32)));
        }
        m = __reduce_min_sync(FULL, m);
        const int slot = max(s + 1, m);
        const bool go = m <= hi && slot < a.t_grant;
        for (int l = lane; l < Lo; l += THREADS) {
          const unsigned long long hk = head[l];
          head[l] = NO_KEY;
          if (!go || hk == NO_KEY || static_cast<int>(hk >> 32) > slot ||
              free_[l] > slot)
            continue;
          // serve the head at slot
          const int i = key_entry(hk);
          const Entry e = list[i];
          const int arr = slot + svcdly[l];
          free_[l] = slot + svc[l];
          served[l] += 1;
          const int f = flow[e.p];
          const int nh = e.hop + 1;
          int lo = -1;
          if (nh >= nhops[f]) {
            deliver[e.p] = arr;
          } else {
            lo = g2l[paths[f * H + nh]];
            if (lo < 0) {
              eg_hop[e.p] = nh;
              eg_ready[e.p] = arr;
            }
          }
          hop[e.p] = nh;
          ready[e.p] = arr;
          list[i] = Entry{e.p, lo, arr, nh};
        }
        __syncwarp();
        if (!go) {
          // past the grant, or no listed packet acts by hi
          b = m <= hi ? a.t_grant : min(m, pm);
          break;
        }
        s = slot;
        ++steps;
      }
    }
  }

  // the row's next event over all its packets
  int m = INF_SLOT;
  for (int p = lane; p < P; p += THREADS) {
    const int lo = locate(paths, nhops, flow, g2l, H, p, hop[p]);
    if (lo >= 0) m = min(m, max(ready[p], free_[lo]));
  }
  m = __reduce_min_sync(FULL, m);
  for (int l = lane; l < Lo; l += THREADS) {
    row_free[l] = free_[l];
    row_served[l] = served[l];
  }
  if (lane == 0) {
    a.next_out[row] = m;
    a.steps_out[row] = steps;
  }
}

}  // namespace wired_kernel

// One advance of the K R rows (lane-major): the tables paths (K, F, H),
// nhops (K, F), pkt_flow (K, P), g2l (K, L), svc and svcdly (K, Lo) int32;
// the state hop,
// ready, free (K R, Lo), deliver, eg_hop, eg_ready, served (K R, Lo),
// updated in place; list (K R, P, 4) int32 scratch; writes next_out and
// steps_out (K R).  ints: K, R, P, F, H, L, Lo, t (the carry's slot),
// t_grant, span (the refresh span), the shared bytes (24 Lo + 4 L).
extern "C" int wired_advance_launch(
    const int* paths, const int* nhops, const int* pkt_flow, const int* g2l,
    const int* svc, const int* svcdly, int* hop, int* ready, int* free_,
    int* deliver,
    int* eg_hop, int* eg_ready, int* served, void* list, int* next_out,
    int* steps_out, int K, int R, int P, int F, int H, int L, int Lo, int t0,
    int t_grant, int span, int smem, cudaStream_t st) {
  using namespace wired_kernel;
  const long long N = static_cast<long long>(K) * R;
  const long long need = 24LL * Lo + 4LL * L;
  if (K < 1 || R < 1 || P < 0 || F < 1 || H < 1 || L < 1 || Lo < 0 ||
      Lo > L || N * P >= (1LL << 31) || N >= (1LL << 31) ||
      static_cast<long long>(F) * H >= (1LL << 31) || smem != need ||
      need > SMEM_LIMIT || t0 < 0 || t_grant < 0 || t0 > INF_SLOT ||
      t_grant > INF_SLOT || span < 1 || span > MAX_SPAN)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{paths,    nhops,   pkt_flow, g2l,     svc,
         svcdly,   hop,     ready,    free_,   deliver,
         eg_hop,   eg_ready, served,  static_cast<Entry*>(list),
         next_out, steps_out, R,      P,       F,
         H,        L,       Lo,       t0,      t_grant,
         span};
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wired_advance, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  void* args[] = {&a};
  const cudaError_t e =
      cudaLaunchKernel(wired_advance, dim3(static_cast<unsigned>(N)),
                       dim3(THREADS), args, static_cast<size_t>(smem), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
