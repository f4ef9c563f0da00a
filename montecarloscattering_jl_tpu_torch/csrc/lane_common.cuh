// Device functions shared by K1 (mega_step.cu) and K5 (helix_step.cu):
// the Threefry-2x32-20 block function of jax.random, a 16-bit integer as
// a float32 uniform, the keyed per-warp sums that aggregate a warp's
// tally entries before their atomics, and the warp sums of the
// per-thread accumulators.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (the jax.random core PRF)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t* y0, uint32_t* y1) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int d = 0; d < 5; ++d) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 = x0 + x1;
      x1 = rotl32(x1, rot[d % 2][j]);
      x1 = x1 ^ x0;
    }
    x0 = x0 + ks[(d + 1) % 3];
    x1 = x1 + ks[(d + 2) % 3] + (uint32_t)(d + 1);
  }
  *y0 = x0;
  *y1 = x1;
}

// a 16-bit integer as a uniform in (0, 1)
__device__ __forceinline__ float unit16(uint32_t h) {
  return ((float)h + 0.5f) * (1.0f / 65536.0f);
}

// The sums of x[0..N) over each group of lanes of `mask` (the lanes
// converged at the call) that hold the same key, valid on the group's
// lowest lane, for which it returns true.  Each round a lane adds the
// values of its next higher peer still in, and the peers at odd
// positions drop out.
template <int N, typename T, typename KeyT>
__device__ __forceinline__ bool group_sums(unsigned mask, KeyT key,
                                           T (&x)[N]) {
  const int lane = threadIdx.x & 31;
  unsigned peers = __match_any_sync(mask, key);
  const bool leader = lane == __ffs(peers) - 1;
  int pos = __popc(peers & ((1u << lane) - 1u));     // peers below me
  peers &= 0xfffffffeu << lane;                      // peers above me
  while (__any_sync(mask, peers != 0u)) {
    const int next = __ffs(peers);                   // 0: none left
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T t = __shfl_sync(mask, x[j], src);
      if (next) x[j] += t;
    }
    peers &= __ballot_sync(mask, (pos & 1) == 0);
    pos >>= 1;
  }
  return leader;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
