// PSD crossing histogram kernels K2 and K3 for NVIDIA Hopper (sm_90a).
//
// A crossing record (cell, lo, hi, w) adds the crossed boundary range
// [lo, hi] of one (momentum, kind, angle) cell to the difference-array
// phase-space histogram psd[n_cells, nzc]: psd[cell, lo] += w and
// psd[cell, hi + 1] -= w; a prefix sum over the boundary axis at the end
// of a run recovers the per-boundary totals (all_flux.jl:234-236).
//
// K2 `psd_scatter_kernel` replaces montecarloscattering_jl_tpu/ops/
// pallas_hist.py::_band_kernel (via psd_accumulate), whose exact fallback
// `scatter_branch` is its spec, and the probe kernel scripts/
// probe_hist.py::_scalar_kernel (P4, one record at a time).  On the TPU
// the scatter lowered to a serial loop, so the kernel turned it into a
// bf16 one-hot MXU contraction over a band of cells with stochastic or
// compensated rounding.  Hopper has native f32 atomics in L2, so K2 adds
// every record into the full array: no band, no bf16, nothing dropped.
// Bound: bytes (the records read once, the touched entries read and
// written once); what holds it above that bound is the launch itself at
// the path's 69,632 records and the atomics that land on one address in
// L2, which retire one after another: a step's records pile on the few
// shock-zone entries.  The design:
//   * a warp takes 32 consecutive records (coalesced 4- or 8-byte loads)
//     and groups equal flat
//     addresses with __match_any_sync; one lane of a group adds the
//     group's sum (a tree of shuffles over the match mask) with one
//     atomicAdd, first for the +w entries, then for the -w entries;
//   * flat indices are 32-bit after the range test (the launcher refuses
//     a PSD of 2^31 entries or more, and so does ops/hist.py);
//   * the step's own tensors are read as they are: lo / hi as int32 or
//     int64, w as float32 or float64 (rounded to float32 in the kernel,
//     to nearest even, as a tensor cast does), so the caller casts
//     nothing.
// Zero-weight records (lanes that crossed no boundary this step) are
// skipped before any atomic.  An index outside the flat array is dropped,
// as JAX's scatter drops it.
//
// K3 `psd_scatter_band_kernel` replaces scripts/probe_hist.py::
// _band_kernel (P3/P3c), K2's prototype: only records whose cell lies in
// the band [blo, blo + band) contribute, blo being the least cell of a
// nonzero record (read from device memory, so the host never waits for
// it).  The grid is (band tiles x record chunks): each block zeroes a
// shared-memory slab of `tile_rows` cells x nzc boundaries, adds its
// chunk's in-tile records there with shared-memory atomics, and adds the
// slab's nonzero entries into the global array.  It privatises the
// contended shock-zone cells in shared memory at the price of reading
// every record once per tile.
//
// Both kernels allocate nothing and launch on the caller's stream; the C
// entry points return cudaGetLastError() of the launch.

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

template <typename ZoneT, typename WeightT>
__global__ void psd_scatter_kernel(const int* __restrict__ cell,
                                   const ZoneT* __restrict__ lo,
                                   const ZoneT* __restrict__ hi,
                                   const WeightT* __restrict__ w,
                                   float* __restrict__ psd, int n_rec,
                                   int n_flat, int nzc) {
  // warp-uniform trip count: every lane reaches every shuffle
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (long long r0 = (long long)warp * 32; r0 < n_rec;
       r0 += (long long)n_warps * 32) {
    const long long i = r0 + lane;
    float v = 0.0f;
    int a = -1, b = -1;
    if (i < n_rec) {
      v = (float)w[i];
      // 64-bit until the range test: a wild index must not wrap
      const long long base = (long long)cell[i] * nzc;
      const long long fa = base + (long long)lo[i];
      const long long fb = base + (long long)hi[i] + 1;
      if (v != 0.0f && fa >= 0 && fa < n_flat) a = (int)fa;
      if (v != 0.0f && fb >= 0 && fb < n_flat) b = (int)fb;
    }
    // a row without a nonzero record costs one ballot
    if (__ballot_sync(kFull, a >= 0 || b >= 0) == 0u) continue;
    warp_add(psd, a, v);
    warp_add(psd, b, -v);
  }
}

__global__ void psd_scatter_band_kernel(const int* __restrict__ cell,
                                        const int* __restrict__ lo,
                                        const int* __restrict__ hi,
                                        const float* __restrict__ w,
                                        const int* __restrict__ blo_ptr,
                                        float* __restrict__ psd, int n_rec,
                                        int n_cells, int nzc, int band,
                                        int tile_rows, int chunk) {
  extern __shared__ float slab[];
  const int blo = *blo_ptr;
  // this tile's cells: [t_lo, t_hi) within the band and the array
  const long long t0 = (long long)blo + (long long)blockIdx.x * tile_rows;
  const long long t_end = min(min(t0 + tile_rows, (long long)blo + band),
                              (long long)n_cells);
  const int t_lo = (int)max(t0, 0LL);
  const int rows = (int)(t_end - t_lo);
  if (rows <= 0) return;                           // block-uniform
  const int n_slab = rows * nzc;
  for (int j = threadIdx.x; j < n_slab; j += blockDim.x) slab[j] = 0.0f;
  __syncthreads();

  const int r0 = blockIdx.y * chunk;
  const int r1 = min(r0 + chunk, n_rec);
  for (int i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    const float v = w[i];
    if (v == 0.0f) continue;
    const int local = cell[i] - t_lo;
    if (local < 0 || local >= rows) continue;
    const int za = lo[i];
    const int zb = hi[i] + 1;
    if (za >= 0 && za < nzc) atomicAdd(slab + local * nzc + za, v);
    if (zb >= 0 && zb < nzc) atomicAdd(slab + local * nzc + zb, -v);
  }
  __syncthreads();

  float* out = psd + (long long)t_lo * nzc;
  for (int j = threadIdx.x; j < n_slab; j += blockDim.x) {
    const float v = slab[j];
    if (v != 0.0f) atomicAdd(out + j, v);
  }
}

constexpr int kThreads = 256;
constexpr int kBandThreads = 512;

}  // namespace

template <typename ZoneT, typename WeightT>
static int launch_scatter(const int* cell, const void* lo, const void* hi,
                          const void* w, float* psd, int n_rec, int n_flat,
                          int nzc, cudaStream_t stream) {
  int blocks = (n_rec + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;        // grid-stride beyond
  psd_scatter_kernel<ZoneT, WeightT><<<blocks, kThreads, 0, stream>>>(
      cell, (const ZoneT*)lo, (const ZoneT*)hi, (const WeightT*)w, psd, n_rec,
      n_flat, nzc);
  return (int)cudaGetLastError();
}

// zone64: lo and hi are int64 (else int32); weight64: w is float64 (else
// float32).  cell is int32.
extern "C" int mcs_psd_scatter(const int* cell, const void* lo,
                               const void* hi, const void* w, float* psd,
                               int n_rec, int n_cells, int nzc, int zone64,
                               int weight64, void* stream) {
  if (n_rec <= 0) return 0;
  if ((long long)n_cells * nzc >= (1LL << 31))
    return (int)cudaErrorInvalidValue;             // int flat indices
  const int n_flat = n_cells * nzc;
  cudaStream_t s = (cudaStream_t)stream;
  if (zone64 && weight64)
    return launch_scatter<long long, double>(cell, lo, hi, w, psd, n_rec,
                                             n_flat, nzc, s);
  if (zone64)
    return launch_scatter<long long, float>(cell, lo, hi, w, psd, n_rec,
                                            n_flat, nzc, s);
  if (weight64)
    return launch_scatter<int, double>(cell, lo, hi, w, psd, n_rec, n_flat,
                                       nzc, s);
  return launch_scatter<int, float>(cell, lo, hi, w, psd, n_rec, n_flat,
                                    nzc, s);
}

extern "C" int mcs_psd_scatter_band(const int* cell, const int* lo,
                                    const int* hi, const float* w,
                                    const int* blo, float* psd, int n_rec,
                                    int n_cells, int nzc, int band,
                                    int tile_rows, int n_chunks,
                                    void* stream) {
  if (n_rec <= 0 || band <= 0) return 0;
  const int smem = tile_rows * nzc * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      psd_scatter_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (band + tile_rows - 1) / tile_rows;
  const int chunk = (n_rec + n_chunks - 1) / n_chunks;
  dim3 grid(n_tiles, n_chunks);
  psd_scatter_band_kernel<<<grid, kBandThreads, smem,
                            (cudaStream_t)stream>>>(
      cell, lo, hi, w, blo, psd, n_rec, n_cells, nzc, band, tile_rows,
      chunk);
  return (int)cudaGetLastError();
}
