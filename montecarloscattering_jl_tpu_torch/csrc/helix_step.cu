// K5: the XLA engine's helix step for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's XLA-compiled transport step,
// montecarloscattering_jl_tpu/ops/step.py::helix_step (with
// _downstream_logic and _retro_step), on every configuration the
// megakernel refuses: float64 momenta (the CLI's default) and x_spec
// detectors.  It is not the port of a Pallas kernel: the JAX package
// left this step to XLA.  The plain PyTorch version, which this file
// follows statement by statement, is ops/step.py::helix_step (one step,
// ~300 small kernels) driven by ops/step.py::_block (n steps).
//
// One launch runs n helix steps (the drain's 64-step block) for every
// lane of a window, one thread a lane, with the lane's state in registers
// across the steps.  It is a template over the momentum type T (double,
// the CLI's default; float, the XLA engine's float32 configs with x_spec
// detectors) and a compile-time flag word (kInstances; CT_RUNTIME reads
// the flags at run time and serves every configuration; the float64
// flagship's word has its own instance).  Only the
// parallel-field geometry (theta_B = 0, the only one the config admits)
// is here; ops/helix.py refuses the oblique step.
//
// Inside the launch:
//   * the step's eight float32 uniforms of the XLA stream
//     (rng.lane_uniforms_xla): the lane key folded with its own step count
//     by Threefry-2x32, then word j the xor of the two words of counter
//     block j, its low and high 16-bit halves u[j] and u[4 + j].  A lane
//     ACTIVE at step s of a block has made exactly s steps in it, so the
//     counter is the lane's nsteps.  Words 2 and 3 are drawn only where a
//     branch reads them (the PRP return, a refused reflection try);
//   * the step body with every static flag of the XLA engine, in the
//     plain step's order of operations;
//   * the deposits: the PSD's crossing records through K2's own
//     warp-aggregated deposit (psd_deposit.cuh); the four flux channels
//     into a block-local float64 difference array in shared memory,
//     flushed once a launch; the detector spectra, the ion pool and the
//     tcut tallies by float64 atomicAdd, each aggregated over the warp's
//     lanes that share an address (group_sums, lane_common.cuh); the
//     escape sums and the port's counters as per-thread sums reduced per
//     warp at the end.  Every lane of a warp reaches every deposit point
//     once a step (kFull masks), a lane with nothing to add passing an
//     empty entry, so the deposits sit at the end of the step, outside
//     its branches.
//
// What bounds it on this card: operations.  A push is a dependent chain
// of float64 arithmetic (some twenty divisions and square roots, cos,
// sin, acos, two log10, a binary zone search) and three to five
// Threefry blocks, with no reuse to stage and nothing for the tensor
// cores; the state is read and written once a launch.  The design keeps
// the chain on one thread and everything it touches in registers.
//
// Numerics: the same values as the plain step on the card, operation by
// operation.  Built with -fmad=false (ops/build.py; never fast math), so
// a product rounds once as a separate torch kernel rounds it; the same
// CUDA libm calls the torch kernels make (sqrt, cos/cosf, sin, acos,
// log10, pow, floor, fmod); a division where the plain step divides by a
// tensor, and a multiply by the reciprocal where it divides by a Python
// scalar (torch's CUDA division by a CPU scalar); hypot as jnp.hypot's
// formula (ops/transforms.py hyp); the plain step's Python constants
// rounded to T where it uses them.  Interface: plain C, loaded with
// ctypes; every launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_common.cuh"
#include "psd_deposit.cuh"

#define K5_BLOCK 128

enum { ACTIVE = 0, SAVED = 1, FINISHED = 2 };
enum { R_DOWNSTREAM = 1, R_UPSTREAM_PMAX = 2, R_AGE = 3, R_RADIATED = 4 };
enum { FL_DW = 1, FL_INJ = 2, FL_RETRO = 4, FL_JRET = 8 };
enum { C_RETRO = 0, C_RECV = 1, C_RAD = 2 };

// the float64 scalar vector kv (ops/helix.py KV_NAMES, the same order):
// StepTables.k, then the plain step's Python scalars
enum KV {
  KV_M, KV_MC, KV_E0, KV_TWO_M, KV_ABS_CHARGE, KV_QB2, KV_PCUT, KV_PCUT_PREV,
  KV_PMAX, KV_U2, KV_G0U0, KV_PE_CRIT, KV_GAMMA_E_CRIT, KV_INJ_FRAC,
  KV_B_CMBZ, KV_ONE, KV_THREE, KV_TEN, KV_C, KV_TWO_PI, KV_SPIKE, KV_TINY,
  KV_TINY30, KV_CMAX_COARSE, KV_CMAX_FINE, KV_XN_COARSE, KV_XN_FINE, KV_ETA,
  KV_TWELVE_PI, KV_FRG_RG0, KV_FRG_AM1, KV_FEB_UP, KV_FEB_DW, KV_X_STOP,
  KV_AGE_MAX, KV_UX_DW, KV_GSF_DW, KV_GEF_DW, KV_B_DW, KV_BCOS_DW, KV_BSIN_DW,
  KV_ETA3, KV_RAD, KV_E_REL, KV_PSD_MOM_MIN, KV_LOG_PMIN, KV_DCOS,
  KV_COS_FINE, KV_THETA_MIN, KV_LOG_TMIN, KV_EWF, KV_FTINY,
  N_KV
};
// the int vector ki (ops/helix.py KI_NAMES)
enum KI {
  KI_NB, KI_I_GRID_FEB, KI_I_SHOCK, KI_N_MOM, KI_N_THETA, KI_BPD_MOM,
  KI_BPD_THETA, KI_N_XSPEC, KI_NX, KI_N_SLOTS, KI_FLAGS,
  N_KI
};
// the launch's device pointers (ops/helix.py PTR_NAMES): the lane state,
// the segment's tables, kv and ki, the tallies
enum PTR {
  PTR_WEIGHT, PTR_PB, PTR_PPERP, PTR_PHI, PTR_UX_PREV, PTR_XN_PER,
  PTR_T_STEP, PTR_X, PTR_PRP_X, PTR_ACCTIME, PTR_IGRID, PTR_TCUT,
  PTR_STATUS, PTR_REASON, PTR_NSTEPS, PTR_FLAGS, PTR_KEY0, PTR_KEY1,
  PTR_X_GRID, PTR_UX, PTR_GAMMA_SF, PTR_GAMMA_EF, PTR_BTOT, PTR_EPS_TARGET,
  PTR_X_SPEC, PTR_TCUTS, PTR_RECV_PREFIX, PTR_KV, PTR_KI, PTR_PSD_DIFF,
  PTR_FLUX_DIFF, PTR_ESC, PTR_SPECTRA_SF, PTR_SPECTRA_PF, PTR_POOL_DIFF,
  PTR_WEIGHT_COUPLED, PTR_SPECTRA_COUPLED, PTR_COUNTS,
  N_PTR
};
// bits of ki[KI_FLAGS] and of an instance's word (ops/helix.py FLAG_*)
enum {
  FLAG_DONT_SCATTER = 1, FLAG_DONT_DSA = 2, FLAG_RAD_LOSSES = 4,
  FLAG_RETRO = 8, FLAG_TCUTS = 16, FLAG_ENERGY_TRANSFER = 32,
  FLAG_CUSTOM_EPS_B = 64, FLAG_CUSTOM_FRG = 128, FLAG_ELECTRON = 256,
  FLAG_REFLECT = 512, FLAG_AGE_CUT = 1024, FLAG_FEB_DW = 2048,
  FLAG_XSPEC = 4096
};
enum { CT_RUNTIME = -1 };

// ops/helix.py INSTANCES lists the same (float64, word) pairs in order:
// the run-time instance of each momentum type, and the float64
// flagship's word (x_spec detectors and no other flag: the CLI's default
// run of tests/data/dsa_nonrel.toml with detectors), whose instance
// carries none of the other branches' code and registers
struct Instance {
  int f64, word;
};
constexpr Instance kInstances[] = {
    {1, CT_RUNTIME}, {0, CT_RUNTIME}, {1, FLAG_XSPEC}};
constexpr int kNumInstances = sizeof(kInstances) / sizeof(Instance);

// ---- the torch CUDA kernels' libm calls, by type ------------------------
__device__ __forceinline__ double f_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float f_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double f_cos(double x) { return cos(x); }
__device__ __forceinline__ float f_cos(float x) { return cosf(x); }
__device__ __forceinline__ double f_sin(double x) { return sin(x); }
__device__ __forceinline__ float f_sin(float x) { return sinf(x); }
__device__ __forceinline__ double f_acos(double x) { return acos(x); }
__device__ __forceinline__ float f_acos(float x) { return acosf(x); }
__device__ __forceinline__ double f_log10(double x) { return log10(x); }
__device__ __forceinline__ float f_log10(float x) { return log10f(x); }
__device__ __forceinline__ double f_pow(double a, double b) {
  return pow(a, b);
}
__device__ __forceinline__ float f_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double f_floor(double x) { return floor(x); }
__device__ __forceinline__ float f_floor(float x) { return floorf(x); }
__device__ __forceinline__ double f_fmod(double a, double b) {
  return fmod(a, b);
}
__device__ __forceinline__ float f_fmod(float a, float b) {
  return fmodf(a, b);
}
__device__ __forceinline__ double f_abs(double x) { return fabs(x); }
__device__ __forceinline__ float f_abs(float x) { return fabsf(x); }

// torch.maximum / torch.minimum / torch.clamp: NaN propagates
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T tclamp(T v, T lo, T hi) {
  return tmin(tmax(v, lo), hi);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ops/transforms.py hyp: max * sqrt(1 + (min/max)^2), 0 at 0
template <typename T>
__device__ __forceinline__ T hyp(T a, T b) {
  a = f_abs(a);
  b = f_abs(b);
  const T hi = tmax(a, b);
  const T lo = tmin(a, b);
  if (hi == T(0)) return hi;
  const T r = lo / hi;
  return hi * f_sqrt(T(1) + r * r);
}

// ops/mega.py floor_mod (jnp.mod for floats)
template <typename T>
__device__ __forceinline__ T floor_mod(T a, T b) {
  T r = f_fmod(a, b);
  if (r != T(0) && ((r < T(0)) != (b < T(0)))) r = r + b;
  return r;
}

// radiation_loss (ops/scattering.py)
template <typename T>
__device__ __forceinline__ T rad_loss(T rad, T bsq, T p, T dt) {
  const T dlnp = rad * bsq * p * dt;
  return dlnp > T(1e-2) ? p / (dlnp + T(1)) : p * (T(1) - dlnp);
}

// the Blandford-McKee field decay beyond the grid end, in T
template <typename T>
__device__ __forceinline__ T eps_b_decay(double x, double x_stop) {
  return (T)sqrt(x_stop / tmax(x, x_stop));
}

// index of the last boundary <= x, -1 below the grid (searchsorted)
__device__ __forceinline__ int zone_of(const double* xg, int nb, double x) {
  int lo = 0, hi = nb;  // first index with xg[i] > x
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (xg[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo - 1;
}

// models/psd_bins.py psd_bin_momentum
template <typename T>
__device__ __forceinline__ int mom_bin(T p, T ftiny, T log_pmin, T bpd,
                                       T pmin, int n_mom) {
  const T logr = f_log10(tmax(p, ftiny)) - log_pmin;
  int b = (int)f_floor(logr * bpd) + 1;
  if (p < pmin) b = 0;
  return clampi(b, 0, n_mom);
}

// models/psd_bins.py psd_bin_angle; (p_cos + 1) / dcos is a multiply by
// the reciprocal, as torch divides by a Python scalar on the card
template <typename T>
__device__ __forceinline__ int angle_bin(T px, T pt, T ftiny, T cos_fine,
                                         T inv_dcos, T theta_min,
                                         T log_tmin, T bpd, int n_theta) {
  const T pc = tclamp(-px / tmax(pt, ftiny), T(-1), T(1));
  const int lin = n_theta - (int)f_floor((pc + T(1)) * inv_dcos);
  const T theta = f_acos(pc);
  int lg = (int)f_floor((f_log10(tmax(theta, ftiny)) - log_tmin) * bpd) + 1;
  if (theta < theta_min) lg = 0;
  int b = pc < cos_fine ? lin : lg;
  if (pt <= T(0)) b = 0;
  return clampi(b, 0, n_theta);
}

// word j of the XLA stream's step under the folded key (f0, f1)
__device__ __forceinline__ uint32_t xla_word(uint32_t f0, uint32_t f1,
                                             uint32_t j) {
  uint32_t y0, y1;
  threefry2x32(f0, f1, 0u, j, &y0, &y1);
  return y0 ^ y1;
}
__device__ __forceinline__ float lo16(uint32_t w) {
  return unit16(w & 0xFFFFu);
}
__device__ __forceinline__ float hi16(uint32_t w) { return unit16(w >> 16); }

constexpr float kPiF = 3.14159265358979323846f;   // math.pi as float32
constexpr double kPi32 = (double)kPiF;            // ops/scattering.py _PI32

template <typename T>
struct K5Args {
  T *w, *pb, *pperp, *phi, *uxp, *xnp, *tstep;
  double *x, *prp, *acct;
  int *igrid, *tcut, *status, *reason, *nsteps, *flags;
  const int *key0, *key1;
  const double* xg;
  const T *zux, *zgsf, *zgef, *zb, *eps;
  const double *xspec, *tc, *rp, *kv;
  const int* ki;
  float* psd;
  double *flux, *esc, *ssf, *spf, *pool, *wc, *sc, *cnt;
  int n, n_steps, max_helix;
};

template <typename T, int CT>
__global__ void __launch_bounds__(K5_BLOCK)
helix_step_kernel(const K5Args<T> a) {
  extern __shared__ double flux_s[];   // [4 * nz], this block's flux

  const int* __restrict__ ki = a.ki;
  const double* __restrict__ kv = a.kv;
  const int nb = ki[KI_NB], nz = nb + 1;
  const int i_grid_feb = ki[KI_I_GRID_FEB], i_shock = ki[KI_I_SHOCK];
  const int n_mom = ki[KI_N_MOM], n_theta = ki[KI_N_THETA];
  const int n_xspec = ki[KI_N_XSPEC], nx = ki[KI_NX];
  const int n_slots = ki[KI_N_SLOTS];
  const int fl = CT >= 0 ? CT : ki[KI_FLAGS];
  const bool dont_scatter = (fl & FLAG_DONT_SCATTER) != 0;
  const bool dont_dsa = (fl & FLAG_DONT_DSA) != 0;
  const bool is_el = (fl & FLAG_ELECTRON) != 0;
  const bool rad_on = (fl & FLAG_RAD_LOSSES) != 0 && is_el;
  const bool do_retro = (fl & FLAG_RETRO) != 0;
  const bool do_tcuts = (fl & FLAG_TCUTS) != 0;
  const bool xfer_on = (fl & FLAG_ENERGY_TRANSFER) != 0;
  const bool eps_b = (fl & FLAG_CUSTOM_EPS_B) != 0;
  const bool frg_on = (fl & FLAG_CUSTOM_FRG) != 0;
  const bool reflect = (fl & FLAG_REFLECT) != 0;
  const bool age_cut = (fl & FLAG_AGE_CUT) != 0;
  const bool feb_dw_on = (fl & FLAG_FEB_DW) != 0;
  const bool xspec_on = (fl & FLAG_XSPEC) != 0;

  for (int z = threadIdx.x; z < 4 * nz; z += blockDim.x) flux_s[z] = 0.0;
  __syncthreads();

  const T m = (T)kv[KV_M], mc = (T)kv[KV_MC], e0 = (T)kv[KV_E0];
  const T two_m = (T)kv[KV_TWO_M], abs_q = (T)kv[KV_ABS_CHARGE];
  const T qb2 = (T)kv[KV_QB2], pcut = (T)kv[KV_PCUT];
  const T pcut_prev = (T)kv[KV_PCUT_PREV], pmax = (T)kv[KV_PMAX];
  const T u2 = (T)kv[KV_U2], g0u0 = (T)kv[KV_G0U0];
  const T pe_crit = (T)kv[KV_PE_CRIT], gamma_e_crit = (T)kv[KV_GAMMA_E_CRIT];
  const T inj_frac = (T)kv[KV_INJ_FRAC], b_cmbz = (T)kv[KV_B_CMBZ];
  const T one = (T)kv[KV_ONE], three = (T)kv[KV_THREE], ten = (T)kv[KV_TEN];
  const T c = (T)kv[KV_C], two_pi = (T)kv[KV_TWO_PI];
  const T spike_c = (T)kv[KV_SPIKE], tiny = (T)kv[KV_TINY];
  const T tiny30 = (T)kv[KV_TINY30];
  const T cmax_coarse = (T)kv[KV_CMAX_COARSE];
  const T cmax_fine = (T)kv[KV_CMAX_FINE];
  const T xn_coarse = (T)kv[KV_XN_COARSE], xn_fine = (T)kv[KV_XN_FINE];
  const T eta = (T)kv[KV_ETA], twelve_pi = (T)kv[KV_TWELVE_PI];
  const T frg_rg0 = (T)kv[KV_FRG_RG0], frg_am1 = (T)kv[KV_FRG_AM1];
  const double feb_up = kv[KV_FEB_UP], feb_dw = kv[KV_FEB_DW];
  const double x_stop = kv[KV_X_STOP], age_max = kv[KV_AGE_MAX];
  const T ux_dw = (T)kv[KV_UX_DW], gsf_dw = (T)kv[KV_GSF_DW];
  const T gef_dw = (T)kv[KV_GEF_DW], b_dw = (T)kv[KV_B_DW];
  const T eta3 = (T)kv[KV_ETA3], rad = (T)kv[KV_RAD];
  const T e_rel = (T)kv[KV_E_REL], pmin = (T)kv[KV_PSD_MOM_MIN];
  const T log_pmin = (T)kv[KV_LOG_PMIN];
  const T inv_dcos = T(1) / (T)kv[KV_DCOS];
  const T cos_fine = (T)kv[KV_COS_FINE], theta_min = (T)kv[KV_THETA_MIN];
  const T log_tmin = (T)kv[KV_LOG_TMIN], ewf = (T)kv[KV_EWF];
  const T ftiny = (T)kv[KV_FTINY];
  const T bpd_mom = (T)ki[KI_BPD_MOM], bpd_theta = (T)ki[KI_BPD_THETA];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = i < a.n;
  T w = 0, pb = 0, pperp = 0, phi = 0, uxp = 0, xnp = 0, tstep = 0;
  double x = 0.0, prp = 0.0, acct = 0.0;
  int igrid = 0, tcut = 0, status = FINISHED, reason = 0, nsteps = 0;
  int flags = 0;
  uint32_t k0 = 0u, k1 = 0u;
  if (lane) {
    w = a.w[i], pb = a.pb[i], pperp = a.pperp[i], phi = a.phi[i];
    uxp = a.uxp[i], xnp = a.xnp[i], tstep = a.tstep[i];
    x = a.x[i], prp = a.prp[i], acct = a.acct[i];
    igrid = a.igrid[i], tcut = a.tcut[i], status = a.status[i];
    reason = a.reason[i], nsteps = a.nsteps[i], flags = a.flags[i];
    k0 = (uint32_t)a.key0[i], k1 = (uint32_t)a.key1[i];
  }
  double s_px = 0.0, s_en = 0.0, s_p = 0.0, s_ke = 0.0;
  double s_retro = 0.0, s_recv = 0.0, s_rad = 0.0;

  for (int s = 0; s < a.n_steps; ++s) {
    // a lane that is not ACTIVE does not step; the plain step only clears
    // its FL_JRET bit (warp-uniform exit once no lane of the warp is left)
    if (!__any_sync(kFull, status == ACTIVE)) {
      flags &= ~FL_JRET;
      break;
    }
    // the step's deposits, made below by the whole warp
    bool dep_flux = false, fire = false, donate = false, hit_ok = false;
    int lo_c = 0, hi_c = 0, cell = 0, fire_slot = 0, fire_ip = 0;
    int pool_a = 0, pool_b = 0, ip_sk = 0, ip_pf = 0;
    double fx[4] = {0.0, 0.0, 0.0, 0.0};
    double pool_v = 0.0, xs_sf = 0.0, xs_pf = 0.0;
    double x_hit_old = 0.0, x_hit_new = 0.0;
    float psd_v = 0.0f;

    if (status != ACTIVE) {
      flags &= ~FL_JRET;
    } else {
      const bool retro_old = (flags & FL_RETRO) != 0;
      const bool dw_old = (flags & FL_DW) != 0;
      const bool inj_old = (flags & FL_INJ) != 0;
      const bool norm = !retro_old;
      bool do_b3 = norm && (flags & FL_JRET) == 0;
      const double x_old = x;
      const int ig = igrid;

      // the XLA stream's uniforms: the key folded with the step count;
      // words 0 and 1 every step, 2 and 3 where a branch reads them
      uint32_t f0, f1;
      threefry2x32(k0, k1, 0u, (uint32_t)nsteps, &f0, &f1);
      const uint32_t w0 = xla_word(f0, f1, 0u), w1 = xla_word(f0, f1, 1u);

      // ---- zone fields ----------------------------------------------
      const T ux = a.zux[ig], gsf = a.zgsf[ig], gef = a.zgef[ig];
      T bmag = a.zb[ig];
      if (eps_b && x_old > x_stop) bmag = b_dw * eps_b_decay<T>(x_old, x_stop);
      const T gden = one / (abs_q * bmag);

      T ptot = hyp(pb, pperp);
      T gamma_pf = hyp(ptot / mc, one);

      // ---- Code Block 3: frame re-transform, escapes, scattering ------
      if (do_b3 && ux != uxp) {
        const T beta_old = uxp / c;
        const T gsf_old = one / f_sqrt(tmax(T(1) - beta_old * beta_old,
                                            tiny30));
        const T px_sk = gsf_old * (pb + gamma_pf * m * uxp);
        const T pt_sk = hyp(px_sk, pperp);
        const T g_sk = hyp(pt_sk / mc, one);
        pb = gsf * (px_sk - g_sk * m * ux);
      }
      ptot = hyp(pb, pperp);
      gamma_pf = hyp(ptot / mc, one);
      if (do_b3) uxp = ux;

      if (dont_scatter && do_b3 &&
          x_old > (double)(T(10) * (pperp * c * gden))) {
        status = FINISHED;
        reason = R_DOWNSTREAM;
        do_b3 = false;
      }
      bool esc_pmax = false;
      if (do_b3 && ptot > pmax) {
        const T px_sk0 = gsf * (pb + gamma_pf * m * ux);
        esc_pmax = hyp(px_sk0, pperp) > pmax;
      }
      const bool esc_feb = do_b3 && !esc_pmax && inj_old && x_old < feb_up;
      if (esc_pmax || esc_feb) {
        status = FINISHED;
        reason = R_UPSTREAM_PMAX;
        do_b3 = false;
      }
      if (age_cut && do_b3 && acct > age_max) {
        status = FINISHED;
        reason = R_AGE;
        do_b3 = false;
      }

      if (rad_on) {
        // synchrotron + inverse-Compton losses
        const T b_cmb = b_cmbz * gef;
        const T p_lost = rad_loss(rad, bmag * bmag + b_cmb * b_cmb, ptot,
                                  tstep);
        const bool dead = do_b3 && p_lost <= T(0);
        const T scale = do_b3 ? p_lost / tmax(ptot, tiny) : one;
        pb = pb * scale;
        pperp = pperp * scale;
        ptot = hyp(pb, pperp);
        const T gamma_in = gamma_pf;
        gamma_pf = hyp(ptot / mc, one);
        if (do_b3) s_rad += (double)((gamma_in - gamma_pf) * e0 * w);
        if (dead) {
          status = FINISHED;
          reason = R_RADIATED;
          do_b3 = false;
        }
      }

      // the gyro period (scattering.py gyro_period), then the scattering
      const T g_eff = (is_el && ptot < pe_crit) ? gamma_e_crit : gamma_pf;
      const T period = two_pi * g_eff * mc * gden;
      if (!dont_scatter && do_b3) {
        T cos_max = (xnp == xn_coarse) ? cmax_coarse : cmax_fine;
        if (frg_on) {
          // lambda = eta r_g (r_g / r_ref)^(alpha - 1): torch.pow
          const T p_scat = (is_el && ptot < pe_crit) ? pe_crit : ptot;
          const T f_frg = f_pow(p_scat * c * gden / frg_rg0, frg_am1);
          cos_max = f_cos(f_sqrt(twelve_pi /
                                 (xnp * eta * tmax(f_frg, tiny30))));
        }
        const T safe = tmax(ptot, tiny);
        const T cos_old = pb / safe;
        const T sin_old = pperp / safe;
        const T cos_dt = T(1) - (T)lo16(w0) * (T(1) - cos_max);
        const T sin_dt = f_sqrt(tmax(T(1) - cos_dt * cos_dt, T(0)));
        // the float32 phase, rounded once (ops/scattering.py)
        const float phi_sc =
            (float)((double)lo16(w1) * 2.0 * kPi32 - kPi32);
        const T cos_new = tclamp(
            cos_old * cos_dt + sin_old * sin_dt * (T)cosf(phi_sc), T(-1),
            T(1));
        const T sin_new = f_sqrt(tmax(T(1) - cos_new * cos_new, T(0)));
        pb = ptot * cos_new;
        pperp = ptot * sin_new;
      }

      // acceleration time, tcuts and the pcut save-out (downstream)
      const bool adding = do_b3 && dw_old;
      if (adding) acct = acct + (double)(tstep * gef);
      if (do_tcuts && adding && tcut < n_slots) {
        const int slot = clampi(tcut, 0, n_slots - 1);
        if (acct >= a.tc[slot]) {
          fire = true;
          fire_slot = slot;
          fire_ip = mom_bin(ptot, ftiny, log_pmin, bpd_mom, pmin, n_mom);
          tcut = tcut + 1;
        }
      }
      if (adding && ptot > pcut) {
        status = SAVED;
        if (x_old >= prp) prp = x_old * 1.1;
      }

      const T r_g_tot = ptot * c * gden;
      if (norm && status == ACTIVE)
        xnp = (x_old > (double)r_g_tot) ? xn_coarse : xn_fine;

      // ---- Code Block 2: movement -------------------------------------
      const bool moving = status == ACTIVE && norm;
      const T t_step = period / xnp;
      const T m_gpf = gamma_pf * m;
      const T dphi = two_pi / xnp;
      double x_new = x_old;
      if (moving) {
        T pb_m = pb, phi_m = phi, phi_fin = phi;
        bool done = false;
        if (reflect) {
          // reflection at the shock (no_DSA_loop): the injection draws
          // u[5] then u[6], the new phases u[7] then u[3]
          for (int kk = 0; kk < 2 && !done; ++kk) {
            const T phi_try = floor_mod(phi_m + dphi, two_pi);
            const double x_try =
                x_old + (double)(gsf * (pb_m * t_step / m_gpf + ux * t_step));
            const bool cross_up = x_try <= 0.0 && x_old > 0.0 && !inj_old;
            const uint32_t wi = kk == 0 ? w1 : xla_word(f0, f1, 2u);
            const bool fail =
                cross_up && (dont_dsa || (T)hi16(wi) > inj_frac);
            if (!fail) {
              x_new = x_try;
              phi_fin = phi_try;
              done = true;
            } else if (pb_m < T(0)) {
              pb_m = -pb_m;
            } else {
              const uint32_t w3 = xla_word(f0, f1, 3u);
              const float u = kk == 0 ? hi16(w3) : lo16(w3);
              phi_m = (T)(u * 2.0f * kPiF);
            }
          }
        }
        if (!done) {
          phi_fin = floor_mod(phi_m + dphi, two_pi);
          x_new = x_old + (double)(gsf * (pb_m * t_step / m_gpf + ux * t_step));
        }
        pb = pb_m;
        phi = phi_fin;
      }

      const bool first_dw = moving && x_old < 0.0 && x_new >= 0.0;
      const bool downstream = dw_old || first_dw;
      if (first_dw)
        prp = tmax(prp,
                   (double)(eta3 * r_g_tot * ptot / (m * gamma_pf * u2)));
      const bool inj = inj_old || (moving && downstream && x_new < 0.0);

      // ---- tallies and the new zone (all_flux.jl) ---------------------
      int ig_new = ig;
      if (moving) ig_new = clampi(zone_of(a.xg, nb, x_new), 0, nb - 2);

      const bool moved_down = x_new > x_old;
      int lo = moved_down ? ig + 1 : ig_new + 1;
      const int hi = moved_down ? ig_new : ig;
      if (!moved_down && inj && lo < i_grid_feb + 1) lo = i_grid_feb + 1;
      const bool crossed = moving && hi >= lo;
      lo_c = clampi(lo, 0, nb - 1);
      hi_c = clampi(hi, 0, nb - 1);
      const bool esc_cross = moving && inj && x_new < feb_up &&
                             x_old >= feb_up;
      if (moving) {
        // the shock-frame momentum (transform_p_ps_parallel)
        const T px_sk = gsf * (pb + gamma_pf * m * ux);
        const T pt_sk = hyp(px_sk, pperp);
        const T g_sk = hyp(pt_sk / mc, one);
        const bool spike = pt_sk > f_abs(px_sk) * spike_c;
        const T px_safe = px_sk == T(0) ? tiny : px_sk;
        const bool rel = (g_sk - T(1)) > e_rel;
        const T e_add = rel ? (g_sk - T(1)) * e0 * w
                            : pt_sk * pt_sk / two_m * w;
        ip_sk = mom_bin(pt_sk, ftiny, log_pmin, bpd_mom, pmin, n_mom);
        if (crossed) {
          const T pz_sk = -pperp * f_sin(phi);
          const T abs_inv_vx = spike ? f_abs(spike_c / ux)
                                     : f_abs(g_sk * m / px_safe);
          const T sign = moved_down ? one : -one;
          dep_flux = true;
          fx[0] = (double)(sign * px_sk * w * g0u0);
          fx[1] = (double)(f_abs(pz_sk) * w * g0u0);
          fx[2] = (double)(sign * e_add * g0u0);
          fx[3] = inj ? 0.0 : 1.0;
          const int jt = angle_bin(px_sk, pt_sk, ftiny, cos_fine, inv_dcos,
                                   theta_min, log_tmin, bpd_theta, n_theta);
          cell = (ip_sk * 2 + (inj ? 0 : 1)) * (n_theta + 1) + jt;
          psd_v = (float)(w * abs_inv_vx);
        }
        if (esc_cross) {
          s_px -= (double)(px_sk * w * g0u0);
          s_en += (double)(e_add * g0u0);
        }

        if (xfer_on) {
          // ion -> electron energy transfer on upstream pre-injection
          // crossings (particle_loop.jl:652-723)
          const int hi_t = hi_c < i_shock ? hi_c : i_shock;
          const bool xfer = crossed && !inj && x_old <= 0.0 && hi_t >= lo_c;
          const T gamma_now = hyp(hyp(pb, pperp) / mc, one);
          T g_f = gamma_now;
          if (xfer && !is_el) {
            const T eps_stop = a.eps[clampi(hi_t, 0, nb - 1)];
            const T eps_start = a.eps[ig];
            if (eps_stop > T(0)) {
              const T gf = T(1) + (gamma_now - T(1)) * (T(1) - eps_stop) /
                                      tmax(T(1) - eps_start, tiny30);
              g_f = tmax(gf, T(1));
              const T n_range = (T)(hi_t - lo_c + 1);
              donate = true;
              pool_v = (double)((gamma_now - g_f) * e0 * w /
                                tmax(n_range, T(1)));
              pool_a = clampi(lo_c, 0, nb);
              pool_b = clampi(hi_t + 1, 0, nb);
            }
          } else if (xfer) {
            const T gain = (T)(a.rp[clampi(hi_t + 1, 0, nb)] -
                               a.rp[clampi(lo_c, 0, nb)]) * ewf;
            if (gain > T(0)) {
              g_f = gamma_now + gain / e0;
              s_recv += (double)((g_f - gamma_now) * e0 * w);
            }
          }
          if (xfer && g_f != gamma_now) {
            const T scale =
                f_sqrt(tmax(g_f * g_f - T(1), T(0))) /
                tmax(f_sqrt(tmax(gamma_now * gamma_now - T(1), T(0))),
                     tiny30);
            pb = pb * scale;
            pperp = pperp * scale;
          }
        }

        if (xspec_on) {
          // the detector spectra's entries (calculate_x_spec_spectra!)
          hit_ok = true;
          x_hit_old = x_old;
          x_hit_new = x_new;
          ip_pf = mom_bin(ptot, ftiny, log_pmin, bpd_mom, pmin, n_mom);
          const T pt_o_px_sk = spike ? spike_c : pt_sk / px_safe;
          const T pt_o_px_pf =
              tmin(f_abs(ptot / (pb == T(0) ? tiny : pb)), spike_c);
          const T f_weight = f_abs(pb / px_safe) * g_sk / gamma_pf;
          xs_sf = (double)(w * pt_o_px_sk);
          xs_pf = (double)(w * pt_o_px_pf * f_weight);
        }
      }

      // ---- downstream escape / return (particle_loop.jl:453-495) -----
      bool retro = retro_old, jret = false;
      if (moving) {
        const T v_fac =
            (is_el && ptot < pe_crit)
                ? (pe_crit * c * gden) * pe_crit / (m * gamma_e_crit * u2)
                : (ptot * c * gden) * ptot / (m * gamma_pf * u2);
        const double l_diff = (double)(eta3 * v_fac);
        const bool esc_feb_dw = feb_dw_on && x_new > feb_dw;
        const bool esc_far = !esc_feb_dw && x_new > 1.1 * prp &&
                             x_new > 6.91 * l_diff;
        const bool do_ret = !esc_feb_dw && !esc_far;
        const bool past_end = do_ret && x_new >= x_stop;
        const bool just_end = past_end && x_old < x_stop;
        if (just_end) {
          // the PRP three diffusion lengths on, in the downstream field
          T r_g2 = ptot * c;
          if (eps_b) r_g2 = r_g2 * eps_b_decay<T>(x_new, x_stop);
          r_g2 = r_g2 / qb2;
          prp = x_new +
                3.0 * (double)(eta3 * r_g2 * ptot / (m * gamma_pf * u2));
        }
        const bool crossed_prp =
            past_end && !just_end && x_old < prp && x_new >= prp;
        if (crossed_prp) {
          const uint32_t w2 = xla_word(f0, f1, 2u);
          const T vt = ptot / m_gpf;
          const T q_ret = (vt - u2) / (vt + u2);
          if (vt < u2 || (T)lo16(w2) > q_ret * q_ret) {
            status = FINISHED;
            reason = R_DOWNSTREAM;
          } else {
            phi = (T)(hi16(w0) * 2.0f * kPiF);
            x_new = prp;
            if (do_retro) {
              // enter the backward walk at the PRP, from the next step
              retro = true;
              s_retro += 1.0;
            } else {
              // the analytic return, P(mu) ~ |v mu - u2|
              const uint32_t w3 = xla_word(f0, f1, 3u);
              const T vmu = u2 - (u2 + vt) * (T)sqrtf(lo16(w3));
              const T mu = tclamp(vmu / tmax(vt, tiny), T(-1), T(1));
              const T pb_ret = ptot * mu;
              pb = pb_ret;
              pperp = f_sqrt(tmax(ptot * ptot - pb_ret * pb_ret, T(0)));
              jret = true;
            }
          }
        }
        if (is_el && past_end && !just_end && !crossed_prp &&
            ptot < pcut_prev && nsteps % 1000 == 0) {
          // electron PRP shrink heuristics (prob_return.jl:142-164)
          const double l_d =
              (double)(eta3 * (ptot * c * gden) * ptot / (m * gamma_pf * u2));
          const T ratio = pcut_prev / tmax(ptot, tiny);
          const T r2 = ratio * ratio;
          prp = x_new > 2.0e3 * l_d
                    ? 0.8 * x_new
                    : tmin(prp, x_stop + l_d * (double)(ratio * (r2 * r2)));
        }
        if (esc_feb_dw || esc_far) {
          status = FINISHED;
          reason = R_DOWNSTREAM;
        }
        if (status == FINISHED && reason == R_DOWNSTREAM) {
          // downstream-escape pressure / KE sums
          T vel = ptot / m;
          if ((gamma_pf - T(1)) >= e_rel) vel = vel / gamma_pf;
          s_p += (double)(ptot / three * vel * w);
          s_ke += (double)((gamma_pf - T(1)) * e0 * w);
        }
      }

      if (do_retro && retro_old) {
        // one step of the backward walk (_retro_step): the reversed flow
        // of the last zone, large-angle scattering, radiative losses and
        // tcut tracking, until the lane is back at its PRP
        T b2 = b_dw;
        if (eps_b) b2 = b2 * eps_b_decay<T>(x_old, x_stop);
        const T gden_r = one / (abs_q * b2);
        const T ptot_r = hyp(pb, pperp);
        const T gamma_r = hyp(ptot_r / mc, one);
        const T t_fac = two_pi * m * c * gden_r / ten;
        const T t_step_r = t_fac * gamma_r;
        const T dx = gsf_dw * (pb * t_fac / m + (-ux_dw) * t_step_r);
        const double x_try = x_old + (double)dx;
        acct = acct + (double)(t_step_r * gef_dw);
        if (do_tcuts && tcut < n_slots) {
          const int slot = clampi(tcut, 0, n_slots - 1);
          if (acct >= a.tc[slot]) {
            fire = true;
            fire_slot = slot;
            fire_ip = mom_bin(ptot_r, ftiny, log_pmin, bpd_mom, pmin, n_mom);
            tcut = tcut + 1;
          }
        }
        const T phi_las = (T)((float)(2.0 * 3.14159265358979323846) *
                              lo16(w0));
        const float mu_las = 2.0f * lo16(w1) - 1.0f;
        T p_new = ptot_r;
        if (rad_on) {
          const T b_cmb = b_cmbz * gef_dw;
          p_new = rad_loss(rad, b2 * b2 + b_cmb * b_cmb, ptot_r, t_step_r);
          s_rad += (double)((gamma_r - hyp(p_new / mc, one)) * e0 * w);
        }
        const bool dead = p_new <= T(0);
        const T pb_new = p_new * (T)mu_las;
        const T pperp_new = f_sqrt(tmax(p_new * p_new - pb_new * pb_new,
                                        T(0)));
        const bool returned = !dead && x_try < prp;
        x_new = returned ? prp : x_try;
        pb = pb_new;
        pperp = pperp_new;
        phi = phi_las;
        if (dead) {
          status = FINISHED;
          reason = R_RADIATED;
        }
        if (returned || dead) retro = false;
        if (returned) jret = true;
      }

      // helix cap (particle_loop.jl:162-165)
      nsteps = nsteps + 1;
      if (status == ACTIVE && nsteps >= a.max_helix) {
        status = FINISHED;
        reason = R_DOWNSTREAM;
      }
      x = x_new;
      igrid = ig_new;
      if (moving) tstep = t_step;
      flags = (downstream ? FL_DW : 0) | (inj ? FL_INJ : 0) |
              (retro ? FL_RETRO : 0) | (jret ? FL_JRET : 0);
    }

    // ---- the step's deposits, by the whole warp ------------------------
    if (__any_sync(kFull, dep_flux)) {
      // the flux channels into this block's difference array
      double v[4] = {fx[0], fx[1], fx[2], fx[3]};
      if (group_sums(kFull, dep_flux ? lo_c * nz + hi_c : -1, v) &&
          dep_flux) {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          atomicAdd(&flux_s[ch * nz + lo_c], v[ch]);
          atomicAdd(&flux_s[ch * nz + hi_c + 1], -v[ch]);
        }
      }
      // the PSD record (cell, lo, hi + 1, w) through K2's deposit
      int pa = -1, pz = -1;
      if (dep_flux && psd_v != 0.0f) {
        const long long base = (long long)cell * nz;
        const long long n_flat = (long long)(n_mom + 1) * 2 * (n_theta + 1) *
                                 nz;
        const long long fa = base + lo_c, fz = base + hi_c + 1;
        if (fa >= 0 && fa < n_flat) pa = (int)fa;
        if (fz >= 0 && fz < n_flat) pz = (int)fz;
      }
      warp_deposit(a.psd, pa, pz, psd_v);
    }
    if (__any_sync(kFull, donate)) {
      double v[1] = {pool_v};
      if (group_sums(kFull, donate ? pool_a * (nz + 1) + pool_b : -1, v) &&
          donate) {
        atomicAdd(&a.pool[pool_a], v[0]);
        atomicAdd(&a.pool[pool_b], -v[0]);
      }
    }
    if (__any_sync(kFull, fire)) {
      double vw[1] = {(double)w}, vs[1] = {(double)w};
      if (group_sums(kFull, fire ? fire_slot : -1, vw) && fire)
        atomicAdd(&a.wc[fire_slot], vw[0]);
      const int key = fire_ip * n_slots + fire_slot;
      if (group_sums(kFull, fire ? key : -1, vs) && fire)
        atomicAdd(&a.sc[key], vs[0]);
    }
    if (xspec_on && __any_sync(kFull, hit_ok)) {
      for (int d = 0; d < n_xspec; ++d) {
        const double xs = a.xspec[d];
        const bool hit = hit_ok && ((x_hit_old < xs && x_hit_new >= xs) ||
                                    (x_hit_new <= xs && x_hit_old > xs));
        if (!__any_sync(kFull, hit)) continue;
        double vsf[1] = {xs_sf}, vpf[1] = {xs_pf};
        const int ksf = ip_sk * nx + d, kpf = ip_pf * nx + d;
        if (group_sums(kFull, hit ? ksf : -1, vsf) && hit)
          atomicAdd(&a.ssf[ksf], vsf[0]);
        if (group_sums(kFull, hit ? kpf : -1, vpf) && hit)
          atomicAdd(&a.spf[kpf], vpf[0]);
      }
    }
  }

  if (lane) {
    a.pb[i] = pb, a.pperp[i] = pperp, a.phi[i] = phi;
    a.uxp[i] = uxp, a.xnp[i] = xnp, a.tstep[i] = tstep;
    a.x[i] = x, a.prp[i] = prp, a.acct[i] = acct;
    a.igrid[i] = igrid, a.tcut[i] = tcut, a.status[i] = status;
    a.reason[i] = reason, a.nsteps[i] = nsteps, a.flags[i] = flags;
  }

  __syncthreads();
  for (int z = threadIdx.x; z < 4 * nz; z += blockDim.x) {
    const double v = flux_s[z];
    if (v != 0.0) atomicAdd(&a.flux[z], v);
  }
  s_px = warp_sum(s_px);
  s_en = warp_sum(s_en);
  s_p = warp_sum(s_p);
  s_ke = warp_sum(s_ke);
  s_retro = warp_sum(s_retro);
  s_recv = warp_sum(s_recv);
  s_rad = warp_sum(s_rad);
  if ((threadIdx.x & 31) == 0) {
    if (s_px != 0.0) atomicAdd(&a.esc[0], s_px);
    if (s_en != 0.0) atomicAdd(&a.esc[1], s_en);
    if (s_p != 0.0) atomicAdd(&a.esc[2], s_p);
    if (s_ke != 0.0) atomicAdd(&a.esc[3], s_ke);
    if (s_retro != 0.0) atomicAdd(&a.cnt[C_RETRO], s_retro);
    if (s_recv != 0.0) atomicAdd(&a.cnt[C_RECV], s_recv);
    if (s_rad != 0.0) atomicAdd(&a.cnt[C_RAD], s_rad);
  }
}

// the XLA stream's eight uniforms of each lane at its counter, [8, n]
__global__ void helix_uniforms_kernel(const int* __restrict__ key0,
                                      const int* __restrict__ key1,
                                      const int* __restrict__ nsteps,
                                      float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t f0, f1;
  threefry2x32((uint32_t)key0[i], (uint32_t)key1[i], 0u, (uint32_t)nsteps[i],
               &f0, &f1);
  for (int j = 0; j < 4; ++j) {
    const uint32_t wj = xla_word(f0, f1, (uint32_t)j);
    out[(long long)j * n + i] = lo16(wj);
    out[(long long)(4 + j) * n + i] = hi16(wj);
  }
}

template <typename T>
static K5Args<T> make_args(void* const* p, int n, int n_steps,
                           int max_helix) {
  K5Args<T> a;
  a.w = (T*)p[PTR_WEIGHT], a.pb = (T*)p[PTR_PB], a.pperp = (T*)p[PTR_PPERP];
  a.phi = (T*)p[PTR_PHI], a.uxp = (T*)p[PTR_UX_PREV];
  a.xnp = (T*)p[PTR_XN_PER], a.tstep = (T*)p[PTR_T_STEP];
  a.x = (double*)p[PTR_X], a.prp = (double*)p[PTR_PRP_X];
  a.acct = (double*)p[PTR_ACCTIME];
  a.igrid = (int*)p[PTR_IGRID], a.tcut = (int*)p[PTR_TCUT];
  a.status = (int*)p[PTR_STATUS], a.reason = (int*)p[PTR_REASON];
  a.nsteps = (int*)p[PTR_NSTEPS], a.flags = (int*)p[PTR_FLAGS];
  a.key0 = (const int*)p[PTR_KEY0], a.key1 = (const int*)p[PTR_KEY1];
  a.xg = (const double*)p[PTR_X_GRID];
  a.zux = (const T*)p[PTR_UX], a.zgsf = (const T*)p[PTR_GAMMA_SF];
  a.zgef = (const T*)p[PTR_GAMMA_EF], a.zb = (const T*)p[PTR_BTOT];
  a.eps = (const T*)p[PTR_EPS_TARGET];
  a.xspec = (const double*)p[PTR_X_SPEC], a.tc = (const double*)p[PTR_TCUTS];
  a.rp = (const double*)p[PTR_RECV_PREFIX], a.kv = (const double*)p[PTR_KV];
  a.ki = (const int*)p[PTR_KI];
  a.psd = (float*)p[PTR_PSD_DIFF], a.flux = (double*)p[PTR_FLUX_DIFF];
  a.esc = (double*)p[PTR_ESC], a.ssf = (double*)p[PTR_SPECTRA_SF];
  a.spf = (double*)p[PTR_SPECTRA_PF], a.pool = (double*)p[PTR_POOL_DIFF];
  a.wc = (double*)p[PTR_WEIGHT_COUPLED];
  a.sc = (double*)p[PTR_SPECTRA_COUPLED], a.cnt = (double*)p[PTR_COUNTS];
  a.n = n, a.n_steps = n_steps, a.max_helix = max_helix;
  return a;
}

template <int I>
static const void* instance_fn() {
  constexpr Instance in = kInstances[I];
  if (in.f64) return (const void*)helix_step_kernel<double, in.word>;
  return (const void*)helix_step_kernel<float, in.word>;
}

template <int I>
static int launch_instance(void* const* p, int n, int n_steps, int max_helix,
                           int nz, cudaStream_t stream) {
  constexpr Instance in = kInstances[I];
  const size_t shared = (size_t)4 * nz * sizeof(double);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        instance_fn<I>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (n + K5_BLOCK - 1) / K5_BLOCK;
  if (in.f64)
    helix_step_kernel<double, in.word><<<grid, K5_BLOCK, shared, stream>>>(
        make_args<double>(p, n, n_steps, max_helix));
  else
    helix_step_kernel<float, in.word><<<grid, K5_BLOCK, shared, stream>>>(
        make_args<float>(p, n, n_steps, max_helix));
  return (int)cudaGetLastError();
}

extern "C" int mcs_helix_num_instances() { return kNumInstances; }

// instance i's momentum type (1: float64) and word (CT_RUNTIME: the
// flags read at run time); -2 for no such instance
extern "C" int mcs_helix_instance(int i, int* f64, int* word) {
  if (i < 0 || i >= kNumInstances) return -2;
  *f64 = kInstances[i].f64;
  *word = kInstances[i].word;
  return 0;
}

// registers and bytes of local memory (stack and spills) a thread of
// instance i, from the CUDA runtime
extern "C" int mcs_helix_instance_attrs(int i, int* regs, int* local_bytes) {
  static_assert(kNumInstances == 3, "the switches list 3 instances");
  const void* fn = nullptr;
  switch (i) {
    case 0: fn = instance_fn<0>(); break;
    case 1: fn = instance_fn<1>(); break;
    case 2: fn = instance_fn<2>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(&at, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  return 0;
}

// One launch of instance `instance` on `stream`: `n_steps` helix steps of
// the `n` lanes whose arrays `ptrs` holds (N_PTR device pointers in the
// PTR order), the tallies added to in place.  `word` is the launch's flag
// word: a specialised instance runs only the word it was compiled for.
// `nz` sizes this block's shared flux array (4 nz doubles).
extern "C" int mcs_helix_launch(void* const* ptrs, int n, int n_steps,
                                int max_helix, int nz, int instance, int word,
                                void* stream) {
  if (instance < 0 || instance >= kNumInstances ||
      (kInstances[instance].word != CT_RUNTIME &&
       kInstances[instance].word != word))
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || n_steps <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (instance) {
    case 0: return launch_instance<0>(ptrs, n, n_steps, max_helix, nz, st);
    case 1: return launch_instance<1>(ptrs, n, n_steps, max_helix, nz, st);
    default: return launch_instance<2>(ptrs, n, n_steps, max_helix, nz, st);
  }
}

// out[8, n]: each lane's eight uniforms of the XLA stream at its nsteps
extern "C" int mcs_helix_uniforms(const int* key0, const int* key1,
                                  const int* nsteps, float* out, int n,
                                  void* stream) {
  if (n <= 0) return 0;
  helix_uniforms_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      key0, key1, nsteps, out, n);
  return (int)cudaGetLastError();
}
