// mock/cuda_runtime.h — the CUDA runtime and device intrinsics that the
// port's persistent kernels use, in plain C++20, so that a kernel's source
// compiles with g++ and runs on the CPU:
//
//     g++ -x c++ -std=c++20 -O2 -ffp-contract=off -fPIC -shared -pthread
//         -I tpudes_torch/csrc/mock -I tpudes_torch/csrc
//         -o libtcp_advance_mock.so tpudes_torch/csrc/tcp_advance.cu
//
// (one command; tests/test_torch_tcp_mock.py builds it so).  cudaLaunchKernel
// runs the
// grid's blocks one after another, each block as one std::thread per CUDA
// thread; the warp collectives (__shfl*_sync, __ballot_sync,
// __reduce_*_sync, __any_sync, __syncwarp) meet at a std::barrier of the
// warp's 32 threads, so every lane must reach each of them, as on the card
// with a full mask; a named barrier (bar.sync id, 64: the kernel's
// pair_sync) is a std::barrier of 64 threads, and __syncthreads (and
// __syncthreads_or) one of the block's threads.  Dynamic shared memory is the one buffer tcp_smem (or
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

#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <limits>
#include <memory>
#include <thread>
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

// one warp's meeting point: each lane posts its word, all meet, each reads
// the 32 words, all meet again before the next collective may post
struct Warp {
  std::barrier<> bar{32};
  uint64_t word[32];
};
inline thread_local Warp* warp_of = nullptr;
// the block's named barriers (bar.sync id, n), n threads each
inline thread_local std::vector<std::unique_ptr<std::barrier<>>>* named =
    nullptr;
// the block's __syncthreads barrier, all its threads
inline thread_local std::barrier<>* block_barrier = nullptr;
// __syncthreads_or: call i posts to slot i % 3 and clears slot (i + 2) % 3,
// whose last readers met at call i's barrier and whose next writers meet at
// call i + 1's first
inline thread_local std::atomic<int>* or_slots = nullptr;
inline thread_local unsigned or_calls = 0;

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

// the grid's blocks in turn, each block's threads together
template <class... P>
inline cudaError_t cudaLaunchKernel(void (*f)(P...), dim3 grid, dim3 block,
                                    void** args, size_t, cudaStream_t) {
  const unsigned n = block.x;
  if (n == 0 || n % 32 != 0) return cudaErrorInvalidValue;
  for (unsigned b = 0; b < grid.x; ++b) {
    std::vector<cuda_mock::Warp> warps(n / 32);
    std::vector<std::unique_ptr<std::barrier<>>> named;
    for (int i = 0; i < 16; ++i)
      named.push_back(std::make_unique<std::barrier<>>(64));
    std::barrier<> block_bar(n);
    std::atomic<int> or_slots[3] = {0, 0, 0};
    std::vector<std::thread> threads;
    threads.reserve(n);
    for (unsigned t = 0; t < n; ++t)
      threads.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        blockDim = block;
        gridDim = grid;
        cuda_mock::warp_of = &warps[t / 32];
        cuda_mock::named = &named;
        cuda_mock::block_barrier = &block_bar;
        cuda_mock::or_slots = or_slots;
        cuda_mock::or_calls = 0;
        cuda_mock::call(f, args, std::index_sequence_for<P...>{});
      });
    for (auto& th : threads) th.join();
  }
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
