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
// K3 replaces scripts/probe_hist.py::_band_kernel (P3/P3c), K2's
// prototype: only records whose cell lies in the band [blo, blo + band)
// contribute, blo being the least cell of a nonzero record (2^30 when
// there is none), and each boundary index outside [0, nzc) is dropped.
// On the TPU the band was a VMEM window for a one-hot MXU contraction;
// here it is only a filter on K2's deposit, and blo is found on the card
// with no host wait.  `psd_scatter_band_fused` is one cooperative launch
// of as many blocks as the card holds at once:
//   * each thread loads its first kHold records' cell and w into
//     registers (a warp's 32 lanes on 32 consecutive records), folds the
//     cells of its nonzero ones with __reduce_min_sync over the warp and
//     through shared memory over the block, and the block adds one
//     atomicMin to a device word (the same-address atomics are one per
//     block, not one per record);
//   * a grid barrier (cooperative_groups::this_grid().sync());
//   * every thread reads blo and deposits the band's records from the
//     same registers as K2 deposits (one atomicAdd per distinct address
//     of a warp), loading lo and hi only for records in the band; a
//     thread's records past the first kHold are read again (none at the
//     probe's 2^21 records on an H100).
// Bound: bytes, as K2: every record is read once.  The device word
// holds blo as the unsigned cell ^ 0x80000000 (unsigned order is then
// signed order), set to 0xffffffff by a memset before the launch:
// INT_MAX, "no nonzero record", which the deposit clamps to 2^30.
// A two-launch design (a min kernel, then K2's deposit with a
// compile-time band filter, reading cell and w again from L2) measured
// 2-9% slower on the probe's records and was dropped (PERF.md).
//
// Every kernel here allocates nothing and launches on the caller's
// stream; the C entry points return cudaGetLastError() of the launches.

#include <cuda_runtime.h>
#include <cooperative_groups.h>

#include "psd_deposit.cuh"

namespace {

constexpr int kNoBand = 1 << 30;                   // blo with no record

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
    warp_deposit(psd, a, b, v);
  }
}

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;               // grid-stride beyond
constexpr int kHold = 16;                          // records a thread holds

// K3's deposit of record i (its cell c and weight v held): the band
// [b_lo, b_hi) is already cut to the array, and each boundary index
// outside [0, nzc) is dropped.
__device__ __forceinline__ void band_deposit(float* psd, long long i,
                                             int n_rec, int c, float v,
                                             const int* lo, const int* hi,
                                             long long b_lo, long long b_hi,
                                             int nzc) {
  int a = -1, b = -1;
  if (i < n_rec && v != 0.0f && c >= b_lo && c < b_hi) {
    const long long za = lo[i], zb = (long long)hi[i] + 1;
    if (za >= 0 && za < nzc) a = (int)((long long)c * nzc + za);
    if (zb >= 0 && zb < nzc) b = (int)((long long)c * nzc + zb);
  }
  warp_deposit(psd, a, b, v);
}

// The least cell of a nonzero record is kept as the unsigned
// cell ^ 0x80000000, whose order is the cells' signed order.
__device__ __forceinline__ unsigned cell_key(int c) {
  return (unsigned)c ^ 0x80000000u;
}

// K3 in one cooperative launch: the min pass over records held in
// registers, a grid barrier, the deposit from the same registers.
__global__ void __launch_bounds__(kThreads)
psd_scatter_band_fused(const int* __restrict__ cell,
                       const int* __restrict__ lo,
                       const int* __restrict__ hi,
                       const float* __restrict__ w, unsigned* key,
                       float* __restrict__ psd, int n_rec, int n_cells,
                       int nzc, int band) {
  __shared__ unsigned warp_min[kThreads / 32];
  const long long T = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  int c[kHold];
  float v[kHold];
  unsigned m = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < kHold; ++k) {
    const long long i = k * T + t;
    c[k] = 0;
    v[k] = 0.0f;
    if (i < n_rec) {
      v[k] = w[i];
      c[k] = cell[i];
    }
    if (v[k] != 0.0f) m = min(m, cell_key(c[k]));
  }
  for (long long i = kHold * T + t; i < n_rec; i += T)
    if (w[i] != 0.0f) m = min(m, cell_key(cell[i]));
  m = __reduce_min_sync(kFull, m);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? warp_min[threadIdx.x] : 0xffffffffu;
    m = __reduce_min_sync(kFull, m);
    if (threadIdx.x == 0 && m != 0xffffffffu) atomicMin(key, m);
  }
  cooperative_groups::this_grid().sync();
  // the key through L2: this SM never cached it
  const int least = (int)(__ldcg(key) ^ 0x80000000u);
  if (least >= kNoBand) return;                    // grid-uniform
  const long long b_lo = max((long long)least, 0LL);
  const long long b_hi = min((long long)least + band, (long long)n_cells);
#pragma unroll
  for (int k = 0; k < kHold; ++k)
    band_deposit(psd, k * T + t, n_rec, c[k], v[k], lo, hi, b_lo, b_hi,
                 nzc);
  // warp-uniform trip count past the held records
  for (long long r0 = kHold * T + (t & ~31LL); r0 < n_rec; r0 += T) {
    const long long i = r0 + (threadIdx.x & 31);
    const float vi = i < n_rec ? w[i] : 0.0f;
    const int ci = i < n_rec ? cell[i] : 0;
    band_deposit(psd, i, n_rec, ci, vi, lo, hi, b_lo, b_hi, nzc);
  }
}

}  // namespace

template <typename ZoneT, typename WeightT>
static int launch_scatter(const int* cell, const void* lo, const void* hi,
                          const void* w, float* psd, int n_rec, int n_flat,
                          int nzc, cudaStream_t stream) {
  int blocks = (n_rec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;     // grid-stride beyond
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

// K3: the key (one unsigned of scratch on the device) set to 0xffffffff,
// then one cooperative launch of as many blocks as the card holds.
extern "C" int mcs_psd_scatter_band(const int* cell, const int* lo,
                                    const int* hi, const float* w,
                                    unsigned* key, float* psd, int n_rec,
                                    int n_cells, int nzc, int band,
                                    void* stream) {
  if (n_rec <= 0 || band <= 0) return 0;
  if ((long long)n_cells * nzc >= (1LL << 31))
    return (int)cudaErrorInvalidValue;             // int flat indices
  static int grid = 0;                             // one card a process
  if (grid == 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, psd_scatter_band_fused, kThreads, 0);
    grid = sms * per;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(key, 0xff, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&cell, (void*)&lo, (void*)&hi, (void*)&w,
                  (void*)&key, (void*)&psd, (void*)&n_rec, (void*)&n_cells,
                  (void*)&nzc, (void*)&band};
  err = cudaLaunchCooperativeKernel((const void*)psd_scatter_band_fused,
                                    dim3(grid), dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
