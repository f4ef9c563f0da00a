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
// compensated rounding.  Hopper has native f32 atomics in L2, so K2 is one
// thread per record and two atomicAdds into the full array: no band, no
// bf16, nothing dropped.  Bound: L2 atomic throughput, and the contention
// of records on the shock-zone cells; the records themselves are 16 bytes
// each, read once, coalesced.  Zero-weight records (lanes that crossed no
// boundary this step) are skipped before any atomic.  An index outside
// the flat array is dropped, as JAX's scatter drops it.
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

__global__ void psd_scatter_kernel(const int* __restrict__ cell,
                                   const int* __restrict__ lo,
                                   const int* __restrict__ hi,
                                   const float* __restrict__ w,
                                   float* __restrict__ psd, int n_rec,
                                   long long n_flat, int nzc) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_rec;
       i += gridDim.x * blockDim.x) {
    const float v = w[i];
    if (v == 0.0f) continue;
    const long long base = (long long)cell[i] * nzc;
    const long long a = base + lo[i];
    const long long b = base + hi[i] + 1;
    if (a >= 0 && a < n_flat) atomicAdd(psd + a, v);
    if (b >= 0 && b < n_flat) atomicAdd(psd + b, -v);
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

extern "C" int mcs_psd_scatter(const int* cell, const int* lo, const int* hi,
                               const float* w, float* psd, int n_rec,
                               int n_cells, int nzc, void* stream) {
  if (n_rec <= 0) return 0;
  int blocks = (n_rec + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;        // grid-stride beyond
  psd_scatter_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      cell, lo, hi, w, psd, n_rec, (long long)n_cells * nzc, nzc);
  return (int)cudaGetLastError();
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
