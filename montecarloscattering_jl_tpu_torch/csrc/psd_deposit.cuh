// K2's warp-aggregated PSD deposit, shared by K2 (psd_hist.cu) and K5
// (helix_step.cu, which deposits every helix step's crossing records
// with it).  A record adds v at psd[a] and -v at psd[b] of the float32
// difference-array PSD; the lanes of a warp that hold the same flat
// index add once, through one atomicAdd of their sum.  Every function
// here is called by all 32 lanes of a warp (kFull masks); a lane with
// nothing to add passes an index < 0.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The sum of `x` over the lanes of `peers` (a __match_any_sync group of a
// converged warp), valid on the group's lowest lane: each round a lane
// adds the value of its next higher peer still in, and the peers at odd
// positions drop out.
__device__ __forceinline__ float group_sum(unsigned peers, float x) {
  const int lane = threadIdx.x & 31;
  int pos = __popc(peers & ((1u << lane) - 1u));     // peers below me
  peers &= 0xfffffffeu << lane;                      // peers above me
  while (__any_sync(kFull, peers != 0u)) {
    const int next = __ffs(peers);                   // 0: none left
    const float t = __shfl_sync(kFull, x, next ? next - 1 : lane);
    if (next) x += t;
    peers &= __ballot_sync(kFull, (pos & 1) == 0);
    pos >>= 1;
  }
  return x;
}

// One atomicAdd per distinct address of the warp's 32 entries (idx < 0:
// no entry on this lane).
__device__ __forceinline__ void warp_add(float* psd, int idx, float v) {
  unsigned peers = __match_any_sync(kFull, idx);
  if (idx < 0) peers = 1u << (threadIdx.x & 31);     // nothing to gather
  const float sum = group_sum(peers, v);
  if (idx >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(psd + idx, sum);
}

// v at psd[a] and -v at psd[b] (a or b < 0: none on this lane), one
// atomicAdd per distinct address of the warp a side; every lane of the
// warp calls it.  A row without an entry costs one ballot.
__device__ __forceinline__ void warp_deposit(float* psd, int a, int b,
                                             float v) {
  if (__ballot_sync(kFull, a >= 0 || b >= 0) == 0u) return;
  warp_add(psd, a, v);
  warp_add(psd, b, -v);
}

}  // namespace
