// mock/cuda_runtime.h — the CUDA runtime and device intrinsics that the
// port's persistent kernels use, in plain C++20, so that a kernel's source
// compiles with g++ and runs on the CPU:
//
//     g++ -x c++ -std=c++20 -O2 -ffp-contract=off -fPIC -shared -pthread
//         -I tpudes_torch/csrc/mock -I tpudes_torch/csrc
//         -o libtcp_advance_mock.so tpudes_torch/csrc/tcp_advance.cu
//
// (one command; tests/test_torch_tcp_mock.py builds it so).  cudaLaunchKernel
// runs the grid's blocks one after another, and each block's CUDA threads as
// fibers (ucontext) that the launching thread runs in turn, each until it
// waits at a barrier; the warp collectives (__shfl*_sync, __ballot_sync,
// __reduce_*_sync, __any_sync, __syncwarp) meet at a barrier of the warp's
// 32 threads, so every lane must reach each of them, as on the card with a
// full mask; a named barrier (bar.sync id, 64: the kernel's pair_sync) is a
// barrier of 64 threads, and __syncthreads (and __syncthreads_or) one of the
// block's threads.  A barrier that no thread will complete aborts.  One OS
// thread a launch keeps a run's cost and order the same however loaded the
// host is.  Dynamic shared memory is the one buffer tcp_smem (or
// dyn_smem), and a __shared__ variable at namespace scope a global (the
// blocks run one at a time).  The f32 and f64 intrinsics are the IEEE
// operations they name, rounded to nearest; -ffp-contract=off keeps g++
// from fusing a product into a sum.  clock64() counts nanoseconds.

#pragma once

// kernels take their CPU branches (inline PTX has none here) under this
#define TPUDES_CUDA_MOCK 1

#include <math.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <ucontext.h>

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <limits>
#include <memory>
#include <tuple>
#include <type_traits>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __shared__
#define __constant__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

// dynamic shared memory of the block that runs (extern __shared__ in the
// kernel's source): the most a block may opt in to on the card; a kernel
// may name it tcp_smem or dyn_smem
alignas(16) inline unsigned char tcp_smem[232448];
#define dyn_smem tcp_smem

// the 16-byte vector type
struct __align__(16) int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  constexpr dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};

template <class F>
inline cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int value, size_t n,
                                   cudaStream_t) {
  memset(p, value, n);
  return cudaSuccess;
}

namespace cuda_mock {

// The running block: its CUDA threads as fibers, each with its own stack,
// that the launching thread runs in turn.  A fiber runs until it waits at a
// barrier or ends; the barrier's last arrival puts its waiters back at the
// end of the ready queue, in the order they arrived, and runs on.  The
// kernels synchronise only through barriers and warp collectives (no lane
// spins on another's write), so this is one of the orders the card may
// take, and the same one on every run.
struct Block;
inline thread_local Block* block = nullptr;

struct Barrier {
  unsigned n, arrived = 0;
  std::vector<unsigned> waiting;  // fibers, in the order they arrived
  explicit Barrier(unsigned n_) : n(n_) {}
  void arrive_and_wait();
};

// one warp's meeting point: each lane posts its word, all meet, each reads
// the 32 words, all meet again before the next collective may post
struct Warp {
  Barrier bar{32};
  uint64_t word[32];
};
inline thread_local Warp* warp_of = nullptr;
// the block's named barriers (bar.sync id, n), n threads each
inline thread_local std::vector<std::unique_ptr<Barrier>>* named = nullptr;
// the block's __syncthreads barrier, all its threads
inline thread_local Barrier* block_barrier = nullptr;
// __syncthreads_or: call i posts to slot i % 3 and clears slot (i + 2) % 3,
// whose last readers met at call i's barrier and whose next writers meet at
// call i + 1's first
inline thread_local std::atomic<int>* or_slots = nullptr;
inline thread_local unsigned or_calls = 0;

// a fiber's stack: its pages are mapped when first touched, and the lowest
// is a guard, so that an overflow faults
constexpr size_t kStack = size_t{1} << 20;
struct Stack {
  void* base = nullptr;
  Stack() {
    base = mmap(nullptr, kStack, PROT_READ | PROT_WRITE,
                MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (base == MAP_FAILED) abort();
    mprotect(base, 4096, PROT_NONE);
  }
  Stack(const Stack&) = delete;
  ~Stack() { munmap(base, kStack); }
};
// the launching thread's stacks, kept for its next blocks
inline thread_local std::vector<std::unique_ptr<Stack>> stacks;

struct Block {
  std::vector<ucontext_t> ctx;
  std::vector<unsigned> calls;  // each fiber's or_calls
  std::vector<Warp>* warps;
  std::deque<unsigned> ready;
  ucontext_t main;
  unsigned cur = 0, live = 0;
  void (*run)(void*);
  void* arg;

  // switch from the running fiber (or the launching thread's context,
  // `from`) to fiber `next`, with its thread's variables
  void resume(unsigned next, ucontext_t* from) {
    if (from != &main) calls[cur] = or_calls;
    cur = next;
    threadIdx = dim3(next);
    warp_of = &(*warps)[next / 32];
    or_calls = calls[next];
    swapcontext(from, &ctx[next]);
  }
  // the running fiber waits: the next ready one runs
  void suspend() {
    if (ready.empty()) {
      fprintf(stderr, "cuda mock: every live thread of block %u waits at a "
              "barrier that no thread will reach\n", blockIdx.x);
      abort();
    }
    const unsigned next = ready.front();
    ready.pop_front();
    resume(next, &ctx[cur]);
  }
  static void entry() {
    Block& b = *block;
    b.run(b.arg);
    --b.live;
    if (b.live == 0) {
      swapcontext(&b.ctx[b.cur], &b.main);
    }
    b.suspend();
  }
};

inline void Barrier::arrive_and_wait() {
  if (++arrived == n) {
    arrived = 0;
    for (unsigned w : waiting) block->ready.push_back(w);
    waiting.clear();
    return;
  }
  waiting.push_back(block->cur);
  block->suspend();
}

inline void named_barrier_sync(int id, int n) {
  (*named)[id]->arrive_and_wait();
  (void)n;
}

inline int lane() { return static_cast<int>(threadIdx.x & 31u); }

template <class T>
inline uint64_t to_word(T v) {
  uint64_t w = 0;
  memcpy(&w, &v, sizeof(T));
  return w;
}
template <class T>
inline T from_word(uint64_t w) {
  T v;
  memcpy(&v, &w, sizeof(T));
  return v;
}

// every lane's value of v
template <class T>
inline void gather(T v, T (&out)[32]) {
  Warp& w = *warp_of;
  w.word[lane()] = to_word(v);
  w.bar.arrive_and_wait();
  for (int i = 0; i < 32; ++i) out[i] = from_word<T>(w.word[i]);
  w.bar.arrive_and_wait();
}

template <class... P, std::size_t... I>
inline void call(void (*f)(P...), void** args, std::index_sequence<I...>) {
  f(*static_cast<std::remove_cv_t<std::remove_reference_t<P>>*>(args[I])...);
}

}  // namespace cuda_mock

// the grid's blocks in turn, each block's threads as fibers
template <class... P>
inline cudaError_t cudaLaunchKernel(void (*f)(P...), dim3 grid, dim3 block,
                                    void** args, size_t, cudaStream_t) {
  const unsigned n = block.x;
  if (n == 0 || n % 32 != 0) return cudaErrorInvalidValue;
  auto& stacks = cuda_mock::stacks;
  while (stacks.size() < n)
    stacks.push_back(std::make_unique<cuda_mock::Stack>());
  struct Kernel {
    void (*f)(P...);
    void** args;
  } kernel{f, args};
  cuda_mock::Block* const outer = cuda_mock::block;
  for (unsigned b = 0; b < grid.x; ++b) {
    std::vector<cuda_mock::Warp> warps(n / 32);
    std::vector<std::unique_ptr<cuda_mock::Barrier>> named;
    for (int i = 0; i < 16; ++i)
      named.push_back(std::make_unique<cuda_mock::Barrier>(64));
    cuda_mock::Barrier block_bar(n);
    std::atomic<int> or_slots[3] = {0, 0, 0};
    cuda_mock::Block blk;
    blk.ctx.resize(n);
    blk.calls.assign(n, 0);
    blk.warps = &warps;
    blk.live = n;
    blk.run = [](void* k) {
      auto* kn = static_cast<Kernel*>(k);
      cuda_mock::call(kn->f, kn->args, std::index_sequence_for<P...>{});
    };
    blk.arg = &kernel;
    for (unsigned t = 0; t < n; ++t) {
      ucontext_t& c = blk.ctx[t];
      getcontext(&c);
      c.uc_stack.ss_sp = stacks[t]->base;
      c.uc_stack.ss_size = cuda_mock::kStack;
      c.uc_link = nullptr;
      makecontext(&c, &cuda_mock::Block::entry, 0);
      if (t > 0) blk.ready.push_back(t);
    }
    blockIdx = dim3(b);
    blockDim = block;
    gridDim = grid;
    cuda_mock::named = &named;
    cuda_mock::block_barrier = &block_bar;
    cuda_mock::or_slots = or_slots;
    cuda_mock::block = &blk;
    blk.resume(0, &blk.main);
  }
  cuda_mock::block = outer;
  return cudaSuccess;
}

// warp collectives (every lane of the warp takes part: a full mask)
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  T all[32];
  cuda_mock::gather(v, all);
  return all[src & 31];
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  T all[32];
  cuda_mock::gather(v, all);
  const int l = cuda_mock::lane();
  return l >= static_cast<int>(d) ? all[l - d] : v;
}
template <class T>
inline T __shfl_down_sync(unsigned, T v, unsigned d) {
  T all[32];
  cuda_mock::gather(v, all);
  const int l = cuda_mock::lane();
  return l + d < 32 ? all[l + d] : v;
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int m) {
  T all[32];
  cuda_mock::gather(v, all);
  return all[(cuda_mock::lane() ^ m) & 31];
}
inline unsigned __ballot_sync(unsigned, int pred) {
  int all[32];
  cuda_mock::gather(pred, all);
  unsigned bits = 0;
  for (int i = 0; i < 32; ++i) bits |= (all[i] != 0 ? 1u : 0u) << i;
  return bits;
}
inline int __any_sync(unsigned m, int pred) {
  return __ballot_sync(m, pred) != 0;
}
inline int __all_sync(unsigned m, int pred) {
  return __ballot_sync(m, pred) == 0xFFFFFFFFu;
}
inline int __reduce_add_sync(unsigned, int v) {
  int all[32];
  cuda_mock::gather(v, all);
  uint32_t sum = 0;
  for (int i = 0; i < 32; ++i) sum += static_cast<uint32_t>(all[i]);
  return static_cast<int>(sum);
}
inline unsigned __reduce_add_sync(unsigned m, unsigned v) {
  return static_cast<unsigned>(__reduce_add_sync(m, static_cast<int>(v)));
}
inline int __reduce_max_sync(unsigned, int v) {
  int all[32];
  cuda_mock::gather(v, all);
  int m = all[0];
  for (int i = 1; i < 32; ++i) m = all[i] > m ? all[i] : m;
  return m;
}
inline int __reduce_min_sync(unsigned, int v) {
  int all[32];
  cuda_mock::gather(v, all);
  int m = all[0];
  for (int i = 1; i < 32; ++i) m = all[i] < m ? all[i] : m;
  return m;
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  unsigned all[32];
  cuda_mock::gather(v, all);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= all[i];
  return m;
}
inline void __syncwarp(unsigned = 0xFFFFFFFFu) {
  cuda_mock::warp_of->bar.arrive_and_wait();
}

inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}

inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_or(v);
}
inline int atomicExch(int* p, int v) {
  return std::atomic_ref<int>(*p).exchange(v);
}
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> r(*p);
  int o = r.load();
  while (o < v && !r.compare_exchange_weak(o, v)) {
  }
  return o;
}
inline int atomicMin(int* p, int v) {
  std::atomic_ref<int> r(*p);
  int o = r.load();
  while (o > v && !r.compare_exchange_weak(o, v)) {
  }
  return o;
}
inline unsigned long long atomicMin(unsigned long long* p,
                                    unsigned long long v) {
  std::atomic_ref<unsigned long long> r(*p);
  unsigned long long o = r.load();
  while (o > v && !r.compare_exchange_weak(o, v)) {
  }
  return o;
}
inline unsigned long long atomicMax(unsigned long long* p,
                                    unsigned long long v) {
  std::atomic_ref<unsigned long long> r(*p);
  unsigned long long o = r.load();
  while (o < v && !r.compare_exchange_weak(o, v)) {
  }
  return o;
}
inline void __syncthreads() { cuda_mock::block_barrier->arrive_and_wait(); }
inline int __syncthreads_or(int pred) {
  const unsigned i = cuda_mock::or_calls++;
  if (pred) cuda_mock::or_slots[i % 3].store(1);
  cuda_mock::block_barrier->arrive_and_wait();
  const int any = cuda_mock::or_slots[i % 3].load();
  cuda_mock::or_slots[(i + 2) % 3].store(0);
  return any;
}
inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// integer and bit intrinsics
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz(x); }
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned s) {
  const uint64_t v = (static_cast<uint64_t>(hi) << 32) | lo;
  return static_cast<unsigned>((v << (s & 31u)) >> 32);
}
inline int max(int a, int b) { return a > b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }

// reinterpretations and conversions
inline float __int_as_float(int x) { return cuda_mock::from_word<float>(
    static_cast<uint32_t>(x)); }
inline float __uint_as_float(unsigned x) {
  return cuda_mock::from_word<float>(x);
}
inline int __float_as_int(float x) {
  return static_cast<int>(static_cast<uint32_t>(cuda_mock::to_word(x)));
}
inline unsigned __float_as_uint(float x) {
  return static_cast<uint32_t>(cuda_mock::to_word(x));
}
inline double __longlong_as_double(long long x) {
  return cuda_mock::from_word<double>(static_cast<uint64_t>(x));
}
inline long long __double_as_longlong(double x) {
  return static_cast<long long>(cuda_mock::to_word(x));
}
// f32 to int32 toward zero, as the card converts: NaN gives 0, and values
// past the range saturate
inline int __float2int_rz(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return std::numeric_limits<int>::max();
  if (x <= -2147483648.0f) return std::numeric_limits<int>::min();
  return static_cast<int>(x);
}
inline float __double2float_rn(double x) { return static_cast<float>(x); }
inline int __double2hiint(double x) {
  return static_cast<int>(static_cast<uint64_t>(__double_as_longlong(x)) >>
                          32);
}
inline int __double2loint(double x) {
  return static_cast<int>(
      static_cast<uint32_t>(static_cast<uint64_t>(__double_as_longlong(x))));
}
inline double __hiloint2double(int hi, int lo) {
  return __longlong_as_double(static_cast<long long>(
      (static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32) |
      static_cast<uint32_t>(lo)));
}

// IEEE arithmetic, each operation rounded to nearest on its own
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return sqrtf(a); }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __fma_rn(double a, double b, double c) { return fma(a, b, c); }
// a + b rounded toward -inf: the nearest sum, one step down where it lies
// above the exact sum (its error, exact by Knuth's two-sum, is negative)
inline double __dadd_rd(double a, double b) {
  const double s = a + b;
  if (!std::isfinite(s)) return s;
  const double bb = s - a;
  const double err = (a - (s - bb)) + (b - bb);
  return err < 0.0 ? std::nextafter(s, -INFINITY) : s;
}
