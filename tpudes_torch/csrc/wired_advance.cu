// wired_advance.cu — the wired engine's slot loop, and its C interface.
//
// Replaces the reference's windowed slot loop, tpudes/parallel/wired.py:578
// build_wired_advance (the lax.while_loop at :700-836 over
// _make_lane_step.step at :529) and :841 build_wired_space_advance (the same
// step vmapped over rank lanes); XLA code, no pallas_call.  The plain
// version is tpudes_torch/parallel/wired.py's advance_math, which this
// kernel equals bit for bit in every state array, in the next event and in
// the step count (the distinct slots at which a row served).
//
// The model.  Each (lane, replica) row holds P packets (hop, ready) and Lo
// local links (free, served).  A packet waits at the link paths[f][hop] of
// its flow f until it is served; it is the row's while hop < nhops[f] and
// that link is one the lane serves.  At slot s every served link that is
// free (free <= s) serves its FIFO head, the least (ready, packet id) among
// its packets with ready <= s: free = s + service, served += 1, and the
// packet moves on at arr = s + service + delay, delivered (deliver = arr)
// past its last hop, parked in the egress buffers (eg_hop, eg_ready) where
// its next link is a peer's, else waiting there.  A launch first clears
// the egress, then steps below t_grant, then writes the row's next event,
// the least max(ready, free[link]) over its packets.  Ingress is not the
// kernel's: the caller writes a peer's packets into hop and ready first.
//
// Bound (chip_smoke.py's wired_bound): the state read and written once
// (bytes, which bound a short window such as a hybrid rank's), against the
// served packet-hops' integer operations (which bound bench_wired's 20,000
// slot launch).  Neither binds: a row is a chain of dependent steps, one
// warp a row, and 1,024 rows fill 132 SMs with about eight warps each, too
// few to hide a step's latency.  So the design shortens the chain a step,
// takes fewer steps, and makes the passes over all P packets few and fast:
//  (a) lo_at[f][h], the local link of flow f's hop h (or DELIVERED, or
//      PEER), derived on the host (wired_tables) and held in shared memory:
//      one shared load in place of the flow -> nhops -> path -> g2l chain
//      of device-memory gathers, in the scans, every serve and the final
//      pass.
//  (b) Several rows a CTA, a warp a row, all of one lane, so the lane's
//      tables load once a CTA.
//  (c) A row's active list in shared memory: the live packets that arrive
//      by hi, in packet order (a list index orders as the packet id), each
//      entry its packet, arrival, flow-and-hop offset into lo_at and hop
//      in 16 bytes, and its link; no (N, P) scratch.  A refresh that would
//      hold more than the capacity C retries with half the span (exact:
//      the list need only hold every live packet that arrives by hi);
//      where the packets that arrive by b alone exceed C the row stops and
//      reports in the error word, and the wrapper raises.
//  (d) The passes over all P packets (the refresh scan, with the egress
//      clear fused into a launch's first; the final next-event pass) read
//      hop and ready 16 bytes a thread where alignment allows, four quads
//      a lane in flight, one vote a round where no packet joins; and the
//      scan that reaches the grant also keeps each link's least arrival
//      of the packets left off the list, so the next event needs no final
//      pass.
//  (e) Per-link queues in shared memory in place of the per-step rekeying:
//      each local link's listed packets linked in (arrival, list index)
//      order, built once a refresh (a count a link, a scan, and each
//      entry's rank in its link's run, counted in parallel: a hybrid
//      rank's first link may hold most of the list); a serve pops its
//      link's head, and a packet that moves on to a local link goes onto
//      that link's incoming list, which the link's lane queues by ordered
//      insertion in the next window (two lists by the window's parity, so
//      no push meets a drain).
//  (f) Lookahead windows: W is the least service + delay over the lane's
//      links (at most 32, the slot mask's bits).  A first service on link
//      l at x_l or later arrives no earlier than x_l + svcdly[l], so one
//      warp round serves every event of [s, min(max(reach, s + W),
//      s + 32, hi + 1, t_grant)), reach the least x_l + svcdly[l]: each
//      link (a lane) pops its queue's heads in order at max(arrival,
//      free, s).  s is the least x_l, a lower bound where packets moved
//      in the round before (each counts at its arrival), which only makes
//      a window shorter.  The step count is the popcount of the window's
//      slot mask, OR-ed over the lanes.
//
// The FlowMonitor columns (template flag OBS, obs=True; the reference's obs
// arm, tpudes/parallel/wired.py:635-689 and :735-836) are the same kernel's
// instantiation in its own unit, csrc/wired_advance_obs.cu, which includes
// this file with WIRED_OBS_PART defined and adds the union pass; every line
// of the arm here sits under if constexpr (OBS), so the instantiations
// without it keep their code.  The arm's deliveries update the delivery
// columns, and the row saves its visited slots (a bitmap over [t0,
// t_grant)) and, at slot % 512, each delivering slot's least delivering
// flow; the sends, the ring and the union step count are the union pass's.
//
// The source also builds with g++ against csrc/mock/cuda_runtime.h, which
// runs it on the CPU (tests/test_torch_wired_mock.py).

#include <cuda_runtime.h>
#include <stdint.h>

extern __shared__ __align__(16) unsigned char dyn_smem[];

namespace wired_kernel {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int INF_SLOT = 1 << 30;
constexpr int MAX_SPAN = 1 << 20;
// the most rows a CTA; the slot mask's bits (the longest window)
constexpr int MAX_ROWS = 4;
constexpr int MAX_WINDOW = 32;
// list indices and local links are int16
constexpr int MAX_CAP = 32767;
constexpr long long SMEM_LIMIT = 227 * 1024;
// lo_at's codes past the local links
constexpr short DELIVERED = -1;
constexpr short PEER = -2;
// the error word where no row overflowed (its four bytes 0x7F)
constexpr int NO_ERROR = 0x7F7F7F7F;

// the stage probe (PROF): clock64() at each warp's stage edges; per row
// the words clear (fused into the first scan here), scan, build, serve,
// insert, reduce, final, the total cycles, refreshes, windows, and the
// list lengths' sum and most
constexpr int N_STAGES = 7;
constexpr int N_PROF = 12;
enum Stage { S_CLEAR, S_SCAN, S_BUILD, S_SERVE, S_INSERT, S_REDUCE,
             S_FINAL };
template <bool PROF>
struct Clock {
  long long last = 0, t_start = 0, acc[N_STAGES] = {};
  __device__ __forceinline__ void start() {
    if constexpr (PROF) last = t_start = clock64();
  }
  __device__ __forceinline__ void mark(int stage) {
    if constexpr (PROF) {
      const long long now = clock64();
      acc[stage] += now - last;
      last = now;
    }
  }
};

// OBS: the ring's rows and columns, the histogram's bins, the least-flow
// sentinel
constexpr int RING_CAP = 512;
constexpr int RING_COLS = 5;
constexpr int BINS = 16;
constexpr int NO_FLOW = 0x7FFFFFFF;

// the OBS arm's operands (one lane, K = 1)
struct ObsArgs {
  const int* birth;     // (R, P) each packet's send slot (fm_birth)
  const int* f_first;   // (F,) each flow's first packet
  const int* f_period;  // (F,) its CBR period
  int *rx, *rxb;        // (R, F) FlowMonitor columns, in place
  float *dsum, *jsum, *dlast, *t1;
  int* hist;          // (R, F, BINS)
  unsigned* visits;   // (R, n_words) the row's visited slots from t0
  int* rec;           // (R, RING_CAP, 2) (slot, least delivering flow)
  int n_words, pkt_bytes;
  float scale;  // a delay (slots) to its bin: flowmon.py::bin_scale
};

struct Args {
  const short* lo_at;   // (K, F, H + 1) local link of each flow's hop
  const int* pkt_flow;  // (K, P)
  const int* svc;       // (K, Lo) service of each local link
  const int* svcdly;    // (K, Lo) service + delay
  int* hop;  // (N, P) state, in place
  int* ready;
  int* free_;  // (N, Lo)
  int* deliver;
  int* eg_hop;
  int* eg_ready;
  int* served;  // (N, Lo)
  int* next_out;   // (N)
  int* steps_out;  // (N)
  int* err;        // the least row whose list overflowed at one slot
  long long* prof;  // (N, N_PROF) under PROF
  int R, P, F, H, Lo, t0, t_grant, span, cap, rows, table_smem;
  ObsArgs obs;  // OBS only
};

__host__ __device__ constexpr long long round16(long long b) {
  return (b + 15) & ~15LL;
}
// shared bytes: the lane's svc and svcdly, lo_at (where table_smem), and
// a warp's row each (struct Row): seven ints and a queue head (int16) a
// link; four ints and four int16 a list entry
__host__ __device__ constexpr long long table_bytes(int F, int H, int Lo,
                                                    int table_smem) {
  return round16(8LL * Lo) +
         (table_smem ? round16(2LL * F * (H + 1)) : 0LL);
}
__host__ __device__ constexpr long long row_bytes(int Lo, int cap) {
  return round16(30LL * Lo + 24LL * cap);
}
// OBS: shared bytes a row (its least delivering flow at each slot of its
// window, its flows' first births), and for the CTA the lane's flows'
// first packets and periods
__host__ __device__ constexpr long long obs_row_bytes(int F) {
  return 4LL * MAX_WINDOW + round16(4LL * F);
}
__host__ __device__ constexpr long long obs_bytes(int F, int rows) {
  return rows * obs_row_bytes(F) + round16(8LL * F);
}

// a list entry: its packet, arrival, lo_at offset of its flow and hop,
// and hop (one 16-byte shared load or store)
struct __align__(16) Entry {
  int p, ready, fh, hop;
};

// a warp's row in shared memory
struct Row {
  Entry* ent;   // [cap] the list
  int* free_;   // [Lo]
  int* served;  // [Lo]
  int* pmin;    // [Lo] the least arrival left off the list (last scan)
  int* inq;     // [2 Lo] the packets moved onto the link, not yet queued
                //   (a list a window's parity: one fills while the
                //   other drains)
  int* beg;     // [Lo] the build's runs
  int* cur;     // [Lo]
  short* qhead;  // [Lo] the link's FIFO queue
  short* e_lo;   // [cap] an entry's link,
  short* e_nxt;  // the next entry in its queue (or in inq)
  short* run;    // [cap] the build's entries by link, and
  short* sorted;  // [cap] in queue order

  __device__ Row(unsigned char* base, int Lo, int cap) {
    ent = reinterpret_cast<Entry*>(base);
    int* w = reinterpret_cast<int*>(ent + cap);
    free_ = w;
    served = w + Lo;
    pmin = w + 2 * Lo;
    inq = w + 3 * Lo;
    beg = w + 5 * Lo;
    cur = w + 6 * Lo;
    short* s = reinterpret_cast<short*>(w + 7 * Lo);
    qhead = s;
    e_lo = s + Lo;
    e_nxt = e_lo + cap;
    run = e_nxt + cap;
    sorted = run + cap;
  }
};

// entry a sorts before entry b in a link's FIFO: the earlier arrival, then
// the lower list index (the list is in packet order, so the index orders
// as the packet id)
__device__ __forceinline__ bool before(int ra, int ia, int rb, int ib) {
  return ra < rb || (ra == rb && ia < ib);
}

// entry e into link lo's queue, in order (the owning lane only)
__device__ __forceinline__ void queue_insert(Row& w, int lo, int e) {
  const int r = w.ent[e].ready;
  int prev = -1, cur = w.qhead[lo];
  while (cur >= 0 && before(w.ent[cur].ready, cur, r, e)) {
    prev = cur;
    cur = w.e_nxt[cur];
  }
  w.e_nxt[e] = static_cast<short>(cur);
  if (prev < 0)
    w.qhead[lo] = static_cast<short>(e);
  else
    w.e_nxt[prev] = static_cast<short>(e);
}

// each link's packets moved onto it (both lists) join its queue; then m,
// the least first service slot max(head's arrival, free) over the links,
// and reach, the least arrival a first service makes, each reduced over
// the warp
__device__ __forceinline__ void queue_next(Row& w, int Lo, int lane,
                                           const int* svcdly, int& m,
                                           int& reach) {
  int x0 = INF_SLOT, r0 = INF_SLOT;
  for (int l = lane; l < Lo; l += WARP) {
    for (int q = l; q < 2 * Lo; q += Lo) {
      for (int h = w.inq[q]; h >= 0;) {
        const int nx = w.e_nxt[h];
        queue_insert(w, l, h);
        h = nx;
      }
      w.inq[q] = -1;
    }
    const int h = w.qhead[l];
    if (h >= 0) {
      const int x = max(w.ent[h].ready, w.free_[l]);
      x0 = min(x0, x);
      r0 = min(r0, x + svcdly[l]);
    }
  }
  __syncwarp();
  m = __reduce_min_sync(FULL, x0);
  reach = __reduce_min_sync(FULL, r0);
}

// the inclusive sum of v over lanes 0..lane
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < WARP; d *= 2) {
    const int u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// the queues of the n listed entries: a count a link, an exclusive scan
// of the counts, each entry scattered to its link's run; then each entry's
// place in its run's (arrival, list index) order is the count of the run's
// entries before it (a link may hold most of the list: a hybrid rank's
// first link holds its peers' packets in flight), and the runs in that
// order are the queues
static __device__ void build_queues(Row& w, int n, int Lo, int lane) {
  for (int l = lane; l < Lo; l += WARP) w.cur[l] = 0;
  __syncwarp();
  for (int i = lane; i < n; i += WARP) atomicAdd(&w.cur[w.e_lo[i]], 1);
  __syncwarp();
  int carry = 0;
  for (int c0 = 0; c0 < Lo; c0 += WARP) {
    const int l = c0 + lane;
    const int v = l < Lo ? w.cur[l] : 0;
    const int incl = warp_scan(v, lane);
    if (l < Lo) w.beg[l] = w.cur[l] = carry + incl - v;
    carry += __shfl_sync(FULL, incl, WARP - 1);
  }
  __syncwarp();
  for (int i = lane; i < n; i += WARP)
    w.run[atomicAdd(&w.cur[w.e_lo[i]], 1)] = static_cast<short>(i);
  __syncwarp();
  for (int i = lane; i < n; i += WARP) {
    const int l = w.e_lo[i], r = w.ent[i].ready, b0 = w.beg[l];
    const int b1 = w.cur[l];
    int rank = 0;
    for (int k = b0; k < b1; ++k) {
      const int j = w.run[k];
      rank += before(w.ent[j].ready, j, r, i);
    }
    w.sorted[b0 + rank] = static_cast<short>(i);
  }
  __syncwarp();
  for (int k = lane; k < n; k += WARP) {
    const int i = w.sorted[k];
    w.e_nxt[i] = static_cast<short>(k + 1 < w.cur[w.e_lo[i]] ? w.sorted[k + 1]
                                                              : -1);
  }
  for (int l = lane; l < Lo; l += WARP) {
    w.qhead[l] = static_cast<short>(w.cur[l] > w.beg[l] ? w.sorted[w.beg[l]]
                                                        : -1);
    w.inq[l] = w.inq[Lo + l] = -1;
  }
  __syncwarp();
}

// one pass over a row's P packets: hop, ready and the lane's flows in
// packet order.  REFRESH: the live packets that arrive by hi join the list
// (the first cap; n counts them all), pm is the least arrival of the live
// packets left off, and with LAST each link's least such arrival goes to
// pmin.  Else the next event: m, the least max(ready, free[link]).  CLEAR
// writes -1 to the egress.
struct Pass {
  const short* lo_at;
  const int* flow;
  int H1, hi, cap, lane;
  int n, pm, m;
  int pend_lo, pend_r;  // a pending per-link minimum (LAST)

  // this lane's packets p .. p + q - 1 (q of Q) in packet order: one
  // vote, and where some packet of the warp joins the list one ballot a
  // slot for their places
  template <bool REFRESH, bool LAST, int Q>
  __device__ __forceinline__ void group(Row& w, int p, int q, const int* h,
                                        const int* r, const int* f) {
    int lo[Q];
#pragma unroll
    for (int k = 0; k < Q; ++k)
      lo[k] = k < q && static_cast<unsigned>(h[k]) <
                           static_cast<unsigned>(H1)
                  ? lo_at[f[k] * H1 + h[k]]
                  : -1;
    if constexpr (!REFRESH) {
#pragma unroll
      for (int k = 0; k < Q; ++k)
        if (lo[k] >= 0) m = min(m, max(r[k], w.free_[lo[k]]));
      return;
    }
    bool take[Q], any = false;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      take[k] = lo[k] >= 0 && r[k] <= hi;
      any |= take[k];
      if (lo[k] >= 0 && r[k] > hi) {
        pm = min(pm, r[k]);
        if constexpr (LAST) {
          if (lo[k] != pend_lo) {
            if (pend_lo >= 0) atomicMin(&w.pmin[pend_lo], pend_r);
            pend_lo = lo[k];
            pend_r = r[k];
          } else {
            pend_r = min(pend_r, r[k]);
          }
        }
      }
    }
    // few packets join a list: one vote where none of the warp's does
    if (!__any_sync(FULL, any)) return;
    int before_me = 0, total = 0;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const unsigned b = __ballot_sync(FULL, take[k]);
      before_me += __popc(b & ((1u << lane) - 1u));
      total += __popc(b);
    }
    int pos = n + before_me;
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      if (take[k]) {
        if (pos < cap) {
          w.ent[pos] = Entry{p + k, r[k], f[k] * H1 + h[k], h[k]};
          w.e_lo[pos] = static_cast<short>(lo[k]);
        }
        ++pos;
      }
    }
    n += total;
  }

  // packets [from, to), one a lane a round
  template <bool REFRESH, bool LAST, bool CLEAR>
  __device__ __forceinline__ void scalar(Row& w, const int* hop,
                                         const int* ready, int* eg_hop,
                                         int* eg_ready, int from, int to) {
    for (int p0 = from; p0 < to; p0 += WARP) {
      const int p = p0 + lane;
      int h = 0, r = 0, f = 0;
      const bool in = p < to;
      if (in) {
        h = hop[p];
        r = ready[p];
        f = flow[p];
        if constexpr (CLEAR) {
          eg_hop[p] = -1;
          eg_ready[p] = -1;
        }
      }
      group<REFRESH, LAST, 1>(w, p, in ? 1 : 0, &h, &r, &f);
    }
  }

  // quad q's packets: 16 bytes of hop and ready, the egress cleared
  template <bool CLEAR>
  __device__ __forceinline__ void load_quad(const int* hop, const int* ready,
                                            int* eg_hop, int* eg_ready,
                                            int p, bool in, int* h, int* r,
                                            int* f) {
    if (!in) return;
    const int4 h4 = *reinterpret_cast<const int4*>(hop + p);
    const int4 r4 = *reinterpret_cast<const int4*>(ready + p);
    h[0] = h4.x, h[1] = h4.y, h[2] = h4.z, h[3] = h4.w;
    r[0] = r4.x, r[1] = r4.y, r[2] = r4.z, r[3] = r4.w;
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = flow[p + k];
    if constexpr (CLEAR) {
      const int4 none = make_int4(-1, -1, -1, -1);
      *reinterpret_cast<int4*>(eg_hop + p) = none;
      *reinterpret_cast<int4*>(eg_ready + p) = none;
    }
  }

  // nq quads of packets from p0, QUADS quads a lane a round, all loaded
  // before any is taken (the loads of a round in flight together)
  template <bool REFRESH, bool LAST, bool CLEAR>
  __device__ __forceinline__ void quads(Row& w, const int* hop,
                                        const int* ready, int* eg_hop,
                                        int* eg_ready, int p0, int nq) {
    constexpr int QUADS = 4;
    for (int q0 = 0; q0 < nq; q0 += QUADS * WARP) {
      int h[4 * QUADS] = {}, r[4 * QUADS] = {}, f[4 * QUADS] = {};
#pragma unroll
      for (int j = 0; j < QUADS; ++j) {
        const int q = q0 + j * WARP + lane;
        load_quad<CLEAR>(hop, ready, eg_hop, eg_ready, p0 + 4 * q, q < nq,
                         h + 4 * j, r + 4 * j, f + 4 * j);
      }
#pragma unroll
      for (int j = 0; j < QUADS; ++j) {
        const int q = q0 + j * WARP + lane;
        if (q0 + j * WARP < nq)
          group<REFRESH, LAST, 4>(w, p0 + 4 * q, q < nq ? 4 : 0, h + 4 * j,
                                  r + 4 * j, f + 4 * j);
      }
    }
  }

  template <bool REFRESH, bool LAST, bool CLEAR>
  __device__ void run(Row& w, const int* hop, const int* ready, int* eg_hop,
                      int* eg_ready, int P) {
    n = 0;
    pm = m = INF_SLOT;
    pend_lo = -1;
    pend_r = INF_SLOT;
    // the quads start where all four arrays are 16-byte aligned alike
    const uintptr_t a = reinterpret_cast<uintptr_t>(hop) & 15u;
    const bool vec = (reinterpret_cast<uintptr_t>(ready) & 15u) == a &&
                     (reinterpret_cast<uintptr_t>(eg_hop) & 15u) == a &&
                     (reinterpret_cast<uintptr_t>(eg_ready) & 15u) == a &&
                     (a & 3u) == 0;
    const int head = vec ? min(P, static_cast<int>(((16u - a) & 15u) >> 2))
                         : P;
    const int nq = vec ? (P - head) / 4 : 0;
    scalar<REFRESH, LAST, CLEAR>(w, hop, ready, eg_hop, eg_ready, 0, head);
    quads<REFRESH, LAST, CLEAR>(w, hop, ready, eg_hop, eg_ready, head, nq);
    scalar<REFRESH, LAST, CLEAR>(w, hop, ready, eg_hop, eg_ready,
                                 head + 4 * nq, P);
    if constexpr (LAST)
      if (pend_lo >= 0) atomicMin(&w.pmin[pend_lo], pend_r);
    pm = __reduce_min_sync(FULL, pm);
    m = __reduce_min_sync(FULL, m);
  }

  // a refresh's pass (the egress cleared where clear, each link's
  // left-off least arrival kept where last)
  __device__ void refresh(Row& w, const int* hop, const int* ready,
                          int* eg_hop, int* eg_ready, int P, bool last,
                          bool clear) {
    if (last) {
      if (clear)
        run<true, true, true>(w, hop, ready, eg_hop, eg_ready, P);
      else
        run<true, true, false>(w, hop, ready, eg_hop, eg_ready, P);
    } else if (clear) {
      run<true, false, true>(w, hop, ready, eg_hop, eg_ready, P);
    } else {
      run<true, false, false>(w, hop, ready, eg_hop, eg_ready, P);
    }
  }
};

// OBS: the row's visited slots, a 32-bit word of its bitmap over [t0,
// t_grant) at a time in a register, each word stored once (the windows'
// slots rise, so the words do)
struct Visits {
  unsigned* out;
  int t0, word, n_words;
  unsigned bits;

  // store the words before j (the held one, then empty ones)
  __device__ __forceinline__ void flush_to(int j, int lane) {
    if (j <= word) return;
    for (int i = word + lane; i < j; i += WARP) out[i] = i == word ? bits : 0u;
    word = j;
    bits = 0u;
  }
  // a window's slot mask, its bit 0 the slot s
  __device__ __forceinline__ void add(int s, unsigned mask, int lane) {
    const int o = s - t0, sh = o & (WARP - 1);
    flush_to(o / WARP, lane);
    bits |= mask << sh;
    if (sh != 0 && (mask >> (WARP - sh)) != 0u) {
      flush_to(o / WARP + 1, lane);
      bits |= mask >> (WARP - sh);
    }
  }
};

// OBS: a row's shared arrays: the window's least delivering flow a slot
// (dflow, from the window's first slot s), its flows' first births (b0),
// and the lane's flows' first packets and periods (a packet's birth is
// b0 + (p - first) period, so a delivery loads no birth)
struct ObsRow {
  int* dflow;
  int* b0;
  int* first;
  int* period;
};

// OBS: packet p of flow f, delivered at arr by its last link's serve at x
// (the lane that pops that link, so a flow's deliveries come in slot
// order): the delivery columns, every load first (one latency), and f into
// the least delivering flow of slot x
__device__ __forceinline__ void obs_deliver(const Args& a, const ObsRow& r,
                                            long long row, int p, int f,
                                            int x, int arr, int s) {
  const ObsArgs& o = a.obs;
  const long long q = row * a.F + f;
  const int rx = o.rx[q], rxb = o.rxb[q];
  const float dsum = o.dsum[q], jsum = o.jsum[q], dlast = o.dlast[q];
  const float d = static_cast<float>(
      arr - (r.b0[f] + (p - r.first[f]) * r.period[f]));
  o.rx[q] = rx + 1;
  o.rxb[q] = rxb + o.pkt_bytes;
  o.dsum[q] = __fadd_rn(dsum, d);
  o.jsum[q] =
      __fadd_rn(jsum, dlast >= 0.0f ? fabsf(__fsub_rn(d, dlast)) : 0.0f);
  o.dlast[q] = d;
  o.t1[q] = static_cast<float>(x);
  // XLA multiplies by the bin width's reciprocal; the histogram's add
  // waits on no load
  const int bin = min(max(__float2int_rz(__fmul_rn(d, o.scale)), 0),
                      BINS - 1);
  atomicAdd(&o.hist[q * BINS + bin], 1);
  atomicMin(&r.dflow[x - s], f);
}

template <bool PROF, bool OBS>
__global__ void __launch_bounds__(WARP* MAX_ROWS) wired_advance(Args a) {
  Clock<PROF> clk;
  clk.start();
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int chunks = (a.R + a.rows - 1) / a.rows;
  const int k = blockIdx.x / chunks;
  const int rep = (blockIdx.x % chunks) * a.rows + warp;
  const int P = a.P, Lo = a.Lo, H1 = a.H + 1, cap = a.cap;

  // the lane's tables, once a CTA
  int* svc = reinterpret_cast<int*>(dyn_smem);
  int* svcdly = svc + Lo;
  const short* lo_at = a.lo_at + static_cast<long long>(k) * a.F * H1;
  for (int l = threadIdx.x; l < Lo; l += blockDim.x) {
    svc[l] = a.svc[k * Lo + l];
    svcdly[l] = a.svcdly[k * Lo + l];
  }
  if (a.table_smem) {
    short* t = reinterpret_cast<short*>(dyn_smem + round16(8LL * Lo));
    for (int i = threadIdx.x; i < a.F * H1; i += blockDim.x) t[i] = lo_at[i];
    lo_at = t;
  }
  // OBS: past the rows, each warp's row arrays, then the lane's flows'
  // first packets and periods
  ObsRow orow{};
  if constexpr (OBS) {
    unsigned char* ob = dyn_smem + table_bytes(a.F, a.H, Lo, a.table_smem) +
                        a.rows * row_bytes(Lo, cap);
    orow.first =
        reinterpret_cast<int*>(ob + a.rows * obs_row_bytes(a.F));
    orow.period = orow.first + a.F;
    for (int f = threadIdx.x; f < a.F; f += blockDim.x) {
      orow.first[f] = a.obs.f_first[f];
      orow.period[f] = a.obs.f_period[f];
    }
    orow.dflow = reinterpret_cast<int*>(ob + warp * obs_row_bytes(a.F));
    orow.b0 = orow.dflow + MAX_WINDOW;
  }
  __syncthreads();
  if (rep >= a.R) return;

  const long long row = static_cast<long long>(k) * a.R + rep;
  const long long base = row * P;
  int* hop = a.hop + base;
  int* ready = a.ready + base;
  int* deliver = a.deliver + base;
  int* eg_hop = a.eg_hop + base;
  int* eg_ready = a.eg_ready + base;
  Row w(dyn_smem + table_bytes(a.F, a.H, Lo, a.table_smem) +
            warp * row_bytes(Lo, cap),
        Lo, cap);
  int win = MAX_WINDOW;
  for (int l = lane; l < Lo; l += WARP) {
    w.free_[l] = a.free_[row * Lo + l];
    w.served[l] = a.served[row * Lo + l];
    win = min(win, svcdly[l]);
  }
  // the lookahead: no serve feeds another within win slots
  win = __reduce_min_sync(FULL, win);
  __syncwarp();

  Pass pass{lo_at, a.pkt_flow + static_cast<long long>(k) * P, H1, 0, cap,
            lane, 0, 0, 0, 0, 0};
  // OBS: the row's flows' first births, no delivering flow yet, and the
  // row's visits (the window's first slot t0 is one, served or not)
  Visits vis{};
  if constexpr (OBS) {
    for (int f = lane; f < a.F; f += WARP)
      orow.b0[f] = a.obs.birth[base + orow.first[f]];
    orow.dflow[lane] = NO_FLOW;
    vis = Visits{a.obs.visits + row * a.obs.n_words, a.t0, 0, a.obs.n_words,
                 a.t0 < a.t_grant ? 1u : 0u};
    __syncwarp();
  }
  bool clear = true;  // no pass of this launch has cleared the egress
  long long n_refresh = 0, n_windows = 0, list_sum = 0, list_max = 0;
  int steps = 0, next = INF_SLOT;
  bool need_final = true;
  const int t0 = a.t0, tg = a.t_grant;
  int b = t0;  // no event of the row lies before b
  bool last = false;  // the last scan reached the grant
  while (b < tg) {
    // refresh: every live packet that arrives by hi joins the list
    int span = a.span, hi;
    for (;;) {
      hi = tg - 1 - b <= span ? tg - 1 : b + span;
      pass.hi = hi;
      last = hi == tg - 1;
      if (last)
        for (int l = lane; l < Lo; l += WARP) w.pmin[l] = INF_SLOT;
      __syncwarp();
      pass.refresh(w, hop, ready, eg_hop, eg_ready, P, last, clear);
      clear = false;
      __syncwarp();
      if (pass.n <= cap || hi == b) break;
      span = (hi - b) / 2;
    }
    clk.mark(S_SCAN);
    if (pass.n > cap) {
      // more than cap packets arrive by b alone: the row stops
      if (lane == 0 && a.err != nullptr)
        atomicMin(a.err, static_cast<int>(row));
      need_final = false;
      break;
    }
    const int n = pass.n, pm = pass.pm;
    ++n_refresh;
    list_sum += n;
    list_max = list_max > n ? list_max : n;
    build_queues(w, n, Lo, lane);
    clk.mark(S_BUILD);
    // m: the next event of the listed packets (exact where exact, else a
    // lower bound: a moved packet counts at its arrival); reach: the
    // earliest arrival a service from there can make (a lower bound)
    int m, reach;
    queue_next(w, Lo, lane, svcdly, m, reach);
    bool exact = true;
    int par = 0;  // the window's parity: its moved packets go to inq[par]
    clk.mark(S_INSERT);
    for (;;) {
      if (!exact && (m > hi || max(m, t0) >= tg)) {
        queue_next(w, Lo, lane, svcdly, m, reach);
        exact = true;
        clk.mark(S_INSERT);
      }
      if (m > hi) {
        // no listed packet acts by hi; a packet left off arrives at pm
        b = min(m, pm);
        if (b >= tg) {
          // the next event: the listed packets' m, and those left off
          // (pmin where this scan reached the grant)
          if (last) {
            int x = m;
            for (int l = lane; l < Lo; l += WARP)
              if (w.pmin[l] < INF_SLOT) x = min(x, max(w.pmin[l], w.free_[l]));
            next = __reduce_min_sync(FULL, x);
            need_final = false;
          } else if (pm == INF_SLOT) {
            next = m;
            need_final = false;
          }
        }
        break;
      }
      const int s = max(m, t0);
      if (s >= tg) {
        // a packet left off arrives after hi >= m
        next = m;
        need_final = false;
        b = tg;
        break;
      }
      // the window: a service at slot x >= s on link l feeds another link
      // no earlier than max(x_l, s) + svcdly[l] >= max(reach, s + win)
      const int e = min(min(max(reach, s + win), s + MAX_WINDOW),
                        min(hi + 1, tg));
      // each link queues the packets the last window moved onto it, pops
      // its heads that act before e, and bounds the next window (this
      // window's moved packets wait in the other list)
      unsigned mask = 0;
      int mn = INF_SLOT, rc = INF_SLOT;
      int* fill = w.inq + par * Lo;
      int* drain = w.inq + (par ^ 1) * Lo;
      for (int l = lane; l < Lo; l += WARP) {
        // the packets the last window moved onto l
        for (int h = drain[l]; h >= 0;) {
          const int nx = w.e_nxt[h];
          queue_insert(w, l, h);
          h = nx;
        }
        drain[l] = -1;
        int fr = w.free_[l], h = w.qhead[l], srv = 0;
        const int sv = svc[l], sd = svcdly[l];
        // the head's fields; each pop loads the next entry's before it
        // writes (the next entry is another entry of the queue)
        Entry en{0, 0, 0, 0};
        int nx = -1;
        if (h >= 0) en = w.ent[h], nx = w.e_nxt[h];
        while (h >= 0) {
          const int x = max(max(en.ready, fr), s);
          if (x >= e) break;
          Entry en2{0, 0, 0, 0};
          int nx2 = -1;
          if (nx >= 0) en2 = w.ent[nx], nx2 = w.e_nxt[nx];
          const int arr = x + sd, fh = en.fh + 1, nh = en.hop + 1, p = en.p;
          fr = x + sv;
          ++srv;
          const int nlo = lo_at[fh];
          hop[p] = nh;
          ready[p] = arr;
          if (nlo == DELIVERED) {
            deliver[p] = arr;
            if constexpr (OBS)
              obs_deliver(a, orow, row, p, pass.flow[p], x, arr, s);
          } else if (nlo == PEER) {
            eg_hop[p] = nh;
            eg_ready[p] = arr;
          }
          w.ent[h] = Entry{p, arr, fh, nh};
          if (nlo >= 0) {
            // onto link nlo's incoming list; it acts there no earlier
            // than arr
            w.e_nxt[h] = static_cast<short>(atomicExch(&fill[nlo], h));
            mn = min(mn, arr);
            rc = min(rc, arr + svcdly[nlo]);
          }
          mask |= 1u << (x - s);
          h = nx, en = en2, nx = nx2;
        }
        w.qhead[l] = static_cast<short>(h);
        w.free_[l] = fr;
        w.served[l] += srv;
        if (h >= 0) {
          const int x = max(en.ready, fr);
          mn = min(mn, x);
          rc = min(rc, x + sd);
        }
      }
      __syncwarp();
      clk.mark(S_SERVE);
      if constexpr (OBS) {
        // the window's record of its delivering slots, and its visits
        const int df = orow.dflow[lane];
        if (df != NO_FLOW) {
          int* r = a.obs.rec +
                   (row * RING_CAP + ((s + lane) & (RING_CAP - 1))) * 2;
          r[0] = s + lane;
          r[1] = df;
          orow.dflow[lane] = NO_FLOW;
        }
        vis.add(s, __reduce_or_sync(FULL, mask), lane);
        __syncwarp();
      }
      m = __reduce_min_sync(FULL, mn);
      reach = __reduce_min_sync(FULL, rc);
      steps += __popc(__reduce_or_sync(FULL, mask));
      exact = false;
      par ^= 1;
      ++n_windows;
      clk.mark(S_REDUCE);
    }
  }

  if (need_final) {
    // no scan reached the grant (or none ran): the next event over all
    // the row's packets, the egress cleared where no scan ran
    __syncwarp();
    if (clear)
      pass.run<false, false, true>(w, hop, ready, eg_hop, eg_ready, P);
    else
      pass.run<false, false, false>(w, hop, ready, eg_hop, eg_ready, P);
    next = pass.m;
    clk.mark(S_FINAL);
  }
  for (int l = lane; l < Lo; l += WARP) {
    a.free_[row * Lo + l] = w.free_[l];
    a.served[row * Lo + l] = w.served[l];
  }
  if constexpr (OBS) vis.flush_to(vis.n_words, lane);
  if (lane == 0) {
    a.next_out[row] = next;
    a.steps_out[row] = steps;
  }
  if constexpr (PROF) {
    if (lane == 0) {
      long long* o = a.prof + row * N_PROF;
      for (int i = 0; i < N_STAGES; ++i) o[i] = clk.acc[i];
      o[7] = clock64() - clk.t_start;
      o[8] = n_refresh;
      o[9] = n_windows;
      o[10] = list_sum;
      o[11] = list_max;
    }
  }
}

template <bool PROF, bool OBS>
int launch(const short* lo_at, const int* pkt_flow, const int* svc,
           const int* svcdly, int* hop, int* ready, int* free_, int* deliver,
           int* eg_hop, int* eg_ready, int* served, int* next_out,
           int* steps_out, int* err, int K, int R, int P, int F, int H,
           int Lo, int t0, int t_grant, int span, int cap, int rows,
           int table_smem, int smem, long long* prof, cudaStream_t st,
           const ObsArgs* obs = nullptr) {
  const long long N = static_cast<long long>(K) * R;
  long long need = table_bytes(F, H, Lo, table_smem) +
                   static_cast<long long>(rows) * row_bytes(Lo, cap);
  if constexpr (OBS) {
    need += obs_bytes(F, rows);
    if (obs == nullptr || K != 1 || t_grant >= (1 << 24) ||
        obs->n_words != (t_grant > t0 ? (t_grant - t0 + WARP - 1) / WARP
                                      : 0) ||
        (obs->n_words > 0 && obs->visits == nullptr) ||
        obs->birth == nullptr || obs->f_first == nullptr ||
        obs->f_period == nullptr || obs->rec == nullptr ||
        !(obs->scale > 0.0f))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (K < 1 || R < 1 || P < 0 || F < 1 || H < 1 || Lo < 0 || Lo > MAX_CAP ||
      N * P >= (1LL << 31) || static_cast<long long>(F) * (H + 1) >=
      (1LL << 31) || cap < 1 || cap > MAX_CAP || rows < 1 ||
      rows > MAX_ROWS || rows > R || smem != need || need > SMEM_LIMIT ||
      t0 < 0 || t_grant < 0 || t0 > INF_SLOT || t_grant > INF_SLOT ||
      span < 0 || span > MAX_SPAN || (PROF && prof == nullptr) ||
      (err == nullptr && P > cap))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{lo_at,   pkt_flow, svc,       svcdly,    hop,   ready, free_,
         deliver, eg_hop,   eg_ready,  served,    next_out, steps_out,
         err,     prof,     R,         P,         F,     H,     Lo,
         t0,      t_grant,  span,      cap,       rows,  table_smem};
  if constexpr (OBS) {
    a.obs = *obs;
    // the record's slots: -1 matches no slot
    const cudaError_t m = cudaMemsetAsync(
        obs->rec, 0xFF, sizeof(int) * 2 * RING_CAP * static_cast<size_t>(R),
        st);
    if (m != cudaSuccess) return static_cast<int>(m);
  }
  auto* kernel = wired_advance<PROF, OBS>;
  // the shared memory opted in to so far (an attribute call only to raise it)
  static int opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = smem;
  }
  const long long blocks = K * ((R + rows - 1LL) / rows);
  if (err != nullptr) {
    const cudaError_t m = cudaMemsetAsync(err, 0x7F, sizeof(int), st);
    if (m != cudaSuccess) return static_cast<int>(m);
  }
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchKernel(
      kernel, dim3(static_cast<unsigned>(blocks)),
      dim3(static_cast<unsigned>(WARP * rows)), args,
      static_cast<size_t>(smem), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wired_kernel

#define WIRED_PARAMS                                                        \
  const short *lo_at, const int *pkt_flow, const int *svc,                  \
      const int *svcdly, int *hop, int *ready, int *free_, int *deliver,    \
      int *eg_hop, int *eg_ready, int *served, int *next_out,               \
      int *steps_out, int *err, int K, int R, int P, int F, int H, int Lo,  \
      int t0, int t_grant, int span, int cap, int rows, int table_smem,     \
      int smem
#define WIRED_ARGS                                                          \
  lo_at, pkt_flow, svc, svcdly, hop, ready, free_, deliver, eg_hop,         \
      eg_ready, served, next_out, steps_out, err, K, R, P, F, H, Lo, t0,    \
      t_grant, span, cap, rows, table_smem, smem

#ifndef WIRED_OBS_PART
// One advance of the K R rows (lane-major): the tables lo_at (K, F, H + 1)
// int16, pkt_flow (K, P), svc and svcdly (K, Lo) int32; the state hop,
// ready, free (K R, Lo), deliver, eg_hop, eg_ready, served (K R, Lo),
// updated in place; writes next_out and steps_out (K R) and to err the
// least row whose list overflowed at one slot, else NO_ERROR (err may be
// null where P <= cap: no list of a row can then overflow).  ints: K, R,
// P, F, H, Lo, t (the carry's slot), t_grant, span (the refresh span),
// cap (the list's entries a row), rows (a CTA), table_smem (lo_at in
// shared memory), the shared bytes (table_bytes + rows row_bytes).
extern "C" int wired_advance_launch(WIRED_PARAMS, cudaStream_t st) {
  return wired_kernel::launch<false, false>(WIRED_ARGS, nullptr, st);
}

// the stage probe: the same launch by the PROF instantiation, which also
// writes each row's N_PROF words to prof
extern "C" int wired_advance_profile(WIRED_PARAMS, long long* prof,
                                     cudaStream_t st) {
  return wired_kernel::launch<true, false>(WIRED_ARGS, prof, st);
}
#endif  // WIRED_OBS_PART
