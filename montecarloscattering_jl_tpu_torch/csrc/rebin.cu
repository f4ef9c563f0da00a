// The dN/dp rebinning of the reductions for NVIDIA Hopper (sm_90a): every
// zone's plasma-frame and ISM-frame dN/dp of one or two PSDs in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves the rebinning to XLA
// (montecarloscattering_jl_tpu/ops/reduce.py _ion_reduce_prog, the
// per-zone corner transform and _rebin_matrix).  Its plain version is
// ops/reduce.py `_dn_frames_plain`: a host loop over the zones that builds
// each zone's corner grid (corner_logp) and its dense [cells, bins]
// fraction matrix (rebin_matrix) in small torch kernels and multiplies
// the zone's weights by it; thousands of launches an iteration, and a
// host wait a zone.  Here:
//   * block b < nb is zone b's plasma frame (its gamma_z; the weights
//     psd[..., b] / gamma_z), block nb + z the ISM frame of zone z
//     (gamma0; psd[..., z] / gamma0).  A block first writes its frame's
//     corner log-momenta, [n_mom+2, n_theta+2] float64, into its own slot
//     of device scratch (a corner table need not fit in shared memory:
//     the baseline's is 220 KB) and each corner row's least and greatest
//     value into shared memory;
//   * then a warp takes one momentum bin k at a time and walks the cell
//     rows whose corner span meets the bin, its lanes over the row's
//     cells.  Outside a cell's span [lo, hi] a bin's fraction is exactly
//     0 in every mode (both CDF values are 0, or both 1), so the dense
//     matrix is never built: the skipped terms are exact zeros of the
//     plain version's product.  The span test keeps a margin of
//     kMargin in log10 p for rounding, and with i_approx = 3 an eighth
//     of the span more: a subcell's linearised surface leaves the
//     bilinear one by at most |delta| / 16 <= (hi - lo) / 8.  A term
//     inside the margin adds its exact 0;
//   * the fractions are the plain version's arithmetic, operation for
//     operation (nvcc -fmad=false): i_approx 0 uniform, 1 isosceles, 3
//     the exact bilinear overlap on 4 x 4 subcells, any other value the
//     scalene triangle; the last bin reaches to 1e9, as rebin_matrix
//     has it;
//   * a lane adds its cells in a fixed order and the warp's sum is a
//     fixed shuffle tree: no atomics, so two launches on one input give
//     the same bits (on every rank of a mesh too).  The sums differ from
//     the plain version's matmul only in their order.
// Bound: bytes or float64 operations, each a few microseconds on the
// benchmark's shapes (the PSDs read once; each frame's corner table, and
// the fractions of the (frame, cell, bin) triples whose spans meet, a few
// a cell of the dense matrix's 12 M).  What the kernel removes is the
// plain version's launches and host waits.  It allocates nothing and
// launches on the caller's stream; the C entry point returns
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr double kMargin = 1.0e-9;     // log10 p, around a cell's span
constexpr double kTopEdge = 1.0e9;     // the last bin reaches to +inf
constexpr int kSubdiv = 4;             // i_approx = 3 subcells an axis

// torch.clamp(x, min=m): NaN stays NaN
__device__ __forceinline__ double clamp_min(double x, double m) {
  return x < m ? m : x;
}

__device__ __forceinline__ double clamp_max(double x, double m) {
  return x > m ? m : x;
}

// _uniform_cdf (i_approx = 0)
__device__ double uniform_cdf(double x, double lo, double hi) {
  const double width = hi - lo;
  if (width <= 1.0e-12) return x >= lo ? 1.0 : 0.0;
  const double v = (x - lo) / clamp_min(width, 1.0e-30);
  return v < 0.0 ? 0.0 : (v > 1.0 ? 1.0 : v);
}

// _triangle_cdf (i_approx = 1, 2)
__device__ double triangle_cdf(double x, double lo, double peak,
                               double hi) {
  const double width = hi - lo;
  if (width <= 1.0e-12) return x >= lo ? 1.0 : 0.0;
  if (x <= lo) return 0.0;
  if (x >= hi) return 1.0;
  if (x <= peak) {
    const double t = x - lo;
    return t * t / clamp_min((peak - lo) * width, 1.0e-30);
  }
  const double t = hi - x;
  return 1.0 - t * t / clamp_min((hi - peak) * width, 1.0e-30);
}

// _trapezoid_cdf
__device__ double trapezoid_cdf(double x, double lo, double b1,
                                double b2) {
  const double m = fmin(b1, b2);
  const double big = fmax(b1, b2);
  const double tot = m + big;
  const double s = x - lo;
  if (tot <= 1.0e-12) return s >= 0.0 ? 1.0 : 0.0;
  if (s <= 0.0) return 0.0;
  if (s >= tot) return 1.0;
  const double m_s = clamp_min(m, 1.0e-30);
  const double big_s = clamp_min(big, 1.0e-30);
  if (s <= m) return s * s / (2.0 * m_s * big_s);
  if (s <= big) return (2.0 * s - m) / (2.0 * big_s);
  const double t = tot - s;
  return 1.0 - t * t / (2.0 * m_s * big_s);
}

// _exact_cdf (i_approx = 3): the sum of the subcells' CDFs, over 16
__device__ double exact_cdf(double c00, double c10, double c01, double c11,
                            double e) {
  const double beta_full = c10 - c00;
  const double gamma_full = c01 - c00;
  const double delta = c11 - c10 - c01 + c00;
  double cdf = 0.0;
  for (int r = 0; r < kSubdiv; ++r) {
    for (int s = 0; s < kSubdiv; ++s) {
      const double u0 = (double)r / kSubdiv;
      const double v0 = (double)s / kSubdiv;
      const double alpha = c00 + beta_full * u0 + gamma_full * v0
                           + delta * u0 * v0;
      const double beta = (beta_full + delta * v0) / kSubdiv;
      const double gamma = (gamma_full + delta * u0) / kSubdiv;
      const double lo = alpha + clamp_max(beta, 0.0)
                        + clamp_max(gamma, 0.0);
      cdf = cdf + trapezoid_cdf(e, lo, fabs(beta), fabs(gamma));
    }
  }
  return cdf / (kSubdiv * kSubdiv);
}

// a cell's fraction in the bin [e_lo, e_hi] (rebin_matrix's column)
__device__ double cell_fraction(int mode, double c00, double c10,
                                double c01, double c11, double lo,
                                double hi, double e_lo, double e_hi) {
  if (mode == 3)
    return exact_cdf(c00, c10, c01, c11, e_hi)
           - exact_cdf(c00, c10, c01, c11, e_lo);
  if (mode == 0) return uniform_cdf(e_hi, lo, hi) - uniform_cdf(e_lo, lo, hi);
  const double peak = mode == 1 ? (lo + hi) / 2.0
                                : (c00 + c10 + c01 + c11 - lo - hi) / 2.0;
  return triangle_cdf(e_hi, lo, peak, hi) - triangle_cdf(e_lo, lo, peak, hi);
}

// whether the bin [e_lo, e_hi] may take a nonzero fraction of a span
// [lo, hi] of corners (a cell's, or a row of cells')
__device__ __forceinline__ bool meets(double e_lo, double e_hi, double lo,
                                      double hi, int mode) {
  const double pad = kMargin + (mode == 3 ? (hi - lo) * 0.125 : 0.0);
  return e_hi >= lo - pad && e_lo < hi + pad;
}

// corner_logp at one corner
__device__ __forceinline__ double corner(double pt, double ct, double g,
                                         double beta, double e0,
                                         double c_cgs) {
  const double px = pt * ct;
  const double etot = hypot(pt * c_cgs, e0);
  const double px_t = g * (px - beta * etot / c_cgs);
  const double arg = clamp_min(pt * pt + px_t * px_t - px * px, 1.0e-300);
  return log10(sqrt(arg));
}

struct RebinArgs {
  const double* mom_edges;    // [n_mom + 2]
  const double* cos_bounds;   // [n_theta + 2]
  const double* edges_log;    // [n_mom + 2] log10 lower edges
  const double* gammas;       // [nb + 1]: the zones' frames, then the ISM
  const double* betas;        // [nb + 1]
  const double* psd[2];       // [n_mom + 1, n_theta + 1, nb] each
  double* corners;            // [2 nb, (n_mom + 2) (n_theta + 2)] scratch
  double* out;                // [n_psd, 2, nb, n_mom + 1]
  int n_mom, n_theta, nb, n_psd, mode;
  double e0, c_cgs;
};

__global__ void __launch_bounds__(kThreads)
rebin_kernel(const RebinArgs a) {
  extern __shared__ double row_span[];     // [2][n_mom + 2]: min, max
  const int nmp2 = a.n_mom + 2, ntp2 = a.n_theta + 2;
  const int ntp1 = a.n_theta + 1, n_bins = a.n_mom + 1;
  const int kind = blockIdx.x / a.nb;      // 0 plasma, 1 ISM
  const int z = blockIdx.x % a.nb;
  const int f = kind ? a.nb : z;
  const double g = a.gammas[f], beta = a.betas[f];
  double* tab = a.corners + (long long)blockIdx.x * nmp2 * ntp2;
  double* rmin = row_span;
  double* rmax = row_span + nmp2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the frame's corner table, and each corner row's span
  for (int r = warp; r < nmp2; r += kWarps) {
    const double pt = a.mom_edges[r];
    double lo = INFINITY, hi = -INFINITY;
    for (int j = lane; j < ntp2; j += 32) {
      const double c = corner(pt, a.cos_bounds[j], g, beta, a.e0, a.c_cgs);
      tab[(long long)r * ntp2 + j] = c;
      lo = fmin(lo, c);
      hi = fmax(hi, c);
    }
    for (int off = 16; off > 0; off >>= 1) {
      lo = fmin(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = fmax(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) {
      rmin[r] = lo;
      rmax[r] = hi;
    }
  }
  __syncthreads();

  // a warp a bin: the cell rows that meet it, lanes over their cells
  const double* pa = a.psd[0];
  const double* pb = a.psd[1];
  for (int k = warp; k < n_bins; k += kWarps) {
    const double e_lo = a.edges_log[k];
    const double e_hi = k + 1 == n_bins ? kTopEdge : a.edges_log[k + 1];
    double acc0 = 0.0, acc1 = 0.0;
    for (int i = 0; i < n_bins; ++i) {
      const double lo_r = fmin(rmin[i], rmin[i + 1]);
      const double hi_r = fmax(rmax[i], rmax[i + 1]);
      if (!meets(e_lo, e_hi, lo_r, hi_r, a.mode)) continue;
      const double* row0 = tab + (long long)i * ntp2;
      const double* row1 = row0 + ntp2;
      for (int j = lane; j < ntp1; j += 32) {
        const double c00 = row0[j], c10 = row1[j];
        const double c01 = row0[j + 1], c11 = row1[j + 1];
        const double lo = fmin(fmin(c00, c10), fmin(c01, c11));
        const double hi = fmax(fmax(c00, c10), fmax(c01, c11));
        if (!meets(e_lo, e_hi, lo, hi, a.mode)) continue;
        const double frac = cell_fraction(a.mode, c00, c10, c01, c11, lo,
                                          hi, e_lo, e_hi);
        const long long at = ((long long)i * ntp1 + j) * a.nb + z;
        acc0 += pa[at] / g * frac;
        if (a.n_psd == 2) acc1 += pb[at] / g * frac;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc0 += __shfl_down_sync(0xffffffffu, acc0, off);
      acc1 += __shfl_down_sync(0xffffffffu, acc1, off);
    }
    if (lane == 0) {
      const long long plane = (long long)a.nb * n_bins;
      const long long at = (long long)kind * plane + (long long)z * n_bins
                           + k;
      a.out[at] = acc0;
      if (a.n_psd == 2) a.out[2 * plane + at] = acc1;
    }
  }
}

}  // namespace

// One launch of 2 nb blocks: `corners` is the caller's scratch of
// 2 nb (n_mom + 2) (n_theta + 2) doubles, `out` [n_psd, 2, nb, n_mom + 1]
// (plasma frame, then ISM frame).  psd_b is read only when n_psd is 2.
extern "C" int mcs_rebin_dndp(const double* mom_edges,
                              const double* cos_bounds,
                              const double* edges_log, const double* gammas,
                              const double* betas, const double* psd_a,
                              const double* psd_b, double* corners,
                              double* out, int n_mom, int n_theta, int nb,
                              int n_psd, int i_approx, double e0,
                              double c_cgs, void* stream) {
  if (nb <= 0) return 0;
  if (n_mom < 0 || n_theta < 0 || n_psd < 1 || n_psd > 2)
    return (int)cudaErrorInvalidValue;
  RebinArgs a;
  a.mom_edges = mom_edges;
  a.cos_bounds = cos_bounds;
  a.edges_log = edges_log;
  a.gammas = gammas;
  a.betas = betas;
  a.psd[0] = psd_a;
  a.psd[1] = n_psd == 2 ? psd_b : psd_a;
  a.corners = corners;
  a.out = out;
  a.n_mom = n_mom;
  a.n_theta = n_theta;
  a.nb = nb;
  a.n_psd = n_psd;
  a.mode = (i_approx == 0 || i_approx == 1 || i_approx == 3) ? i_approx
                                                                : 2;
  a.e0 = e0;
  a.c_cgs = c_cgs;
  const size_t shared = 2 * (size_t)(n_mom + 2) * sizeof(double);
  rebin_kernel<<<2 * nb, kThreads, shared, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
