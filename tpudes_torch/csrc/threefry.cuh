// threefry.cuh — the 20-round Threefry-2x32 hash in uint32, bit-equal to
// tpudes_torch/random.py::threefry2x32 (and so to jax.random's threefry2x32
// under jax_threefry_partitionable=True).  fold_in(key, d) hashes the counter
// pair (0, d) under the key; split(key)[i] is fold_in(key, i); uniform(key,
// (n,))[j] takes the top 23 bits of x0 ^ x1 of the pair (0, j).

#pragma once

#include <stdint.h>

namespace threefry {

// threefry2x32's rotation for round j of group i
__device__ __forceinline__ constexpr int rot(int i, int j) {
  return (i % 2 == 0) ? (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6)
                      : (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24);
}

// the hash of counter (x0, x1) under key (k0, k1), in place
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rot(i, j)) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// fold_in(key, data): the new key's two words, in place of (k0, k1)
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// element j of uniform(key, (n,), f32) over [0, 1)
__device__ __forceinline__ float uniform(uint32_t k0, uint32_t k1,
                                         uint32_t j) {
  uint32_t x0 = 0u, x1 = j;
  threefry2x32(k0, k1, x0, x1);
  return __fsub_rn(__uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u), 1.0f);
}

}  // namespace threefry
