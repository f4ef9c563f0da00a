// K5: the XLA engine's helix step for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's XLA-compiled transport step,
// montecarloscattering_jl_tpu/ops/step.py::helix_step (with
// _downstream_logic and _retro_step), on every configuration the
// megakernel refuses: float64 momenta (the CLI's default) and x_spec
// detectors.  It is not the port of a Pallas kernel: the JAX package
// left this step to XLA.  The plain PyTorch version, which this file
// follows statement by statement, is ops/step.py::helix_step (one step,
// ~300 small kernels) driven by ops/step.py::_block (n steps) and, for
// the drain, ops/helix.py::drain_plain.
//
// Two entries share one step body (step_lane), with the lane's state in
// registers across the steps:
//   * mcs_helix_drain, the engine's: one persistent launch a pcut
//     segment.  The grid is at most what the card holds at once; each
//     thread claims a lane (its own index first, then the next unclaimed
//     one from a device cursor, one atomicAdd a warp), skips it unless it
//     is ACTIVE, steps it until it leaves ACTIVE (the helix cap ends it),
//     stores it and claims another.  The host reads one integer a
//     segment, after it: the steps the 64-step block loop would have
//     taken.
//   * mcs_helix_launch: n steps (a 64-step window) for every lane of a
//     window, one thread a lane; the comparisons' and the block loop's.
// Both are templates over the momentum type T (double, the CLI's
// default; float, the XLA engine's float32 configs with x_spec
// detectors) and a compile-time flag word (kInstances; CT_RUNTIME reads
// the flags at run time and serves every configuration; the float64
// flagship's word has its own instance).  Only the parallel-field
// geometry (theta_B = 0, the only one the config admits) is here;
// ops/helix.py refuses the oblique step.
//
// Inside a step:
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
//     its branches.  So a warp of the drain leaves its lane loop only
//     when none of its threads holds a lane: a thread whose claims have
//     run out goes round with empty entries until then.
//
// The drain leaves every lane as the block loop does.  A lane's uniforms
// are keyed by its own key and step count, and no lane reads what
// another deposits, so its state does not depend on which thread steps
// it or when.  One bit is the block loop's own: it clears FL_JRET of a
// lane that is not ACTIVE at every step it runs, so a lane keeps the bit
// only if it stepped to the loop's last step.  The drain takes its
// steps from the segment's longest lane (a device max, S), sets
// taken = sync_every * ceil(S / sync_every) (capped as the loop's
// max_helix // sync_every + 2 blocks), and its last block to finish
// clears FL_JRET of every lane that ended with it after fewer than
// `taken` steps (a list the threads append to; lanes skipped with the
// bit took 0 steps).
//
// What bounds it on this card: operations.  A push is a dependent chain
// of float64 arithmetic (some twenty divisions and square roots, cos,
// sin, acos, two log10, a binary zone search) and three to five
// Threefry blocks, with no reuse to stage and nothing for the tensor
// cores; the state is read and written once a lane.  The design keeps
// the chain on one thread and everything it touches in registers, and
// the drain keeps every resident thread on a lane until none is left:
// no host round trip and no thread idle while a lane waits.
//
// Numerics: the same values as the plain step on the card, operation by
// operation.  Built with -fmad=false (ops/build.py; never fast math), so
// a product rounds once as a separate torch kernel rounds it; the same
// CUDA libm calls the torch kernels make (sqrt, cos/cosf, sin, acos,
// log10, pow, floor, fmod), pow from a unit built as torch builds its
// kernels (helix_pow.cu: under -fmad=false libm's pow differs from
// torch's on 1 to 4 inputs in a million); a division where the plain
// step divides by a tensor, and a multiply by the reciprocal where it
// divides by a Python scalar (torch's CUDA division by a CPU scalar);
// hypot as jnp.hypot's formula (ops/transforms.py hyp); the plain step's
// Python constants rounded to T where it uses them.  Interface: plain C,
// loaded with ctypes; every launcher returns cudaGetLastError().
//
// Compile-time knobs (-D, ops/build.py target defines; the defaults are
// the engine's): K5_BLOCK threads a block, K5_MIN_BLOCKS the blocks an
// SM must hold (__launch_bounds__; 0 leaves the registers to the
// compiler), K5_FRG the custom f(r_g) law.  The engine
// builds K5 twice: without the law, whole-program, and with it, as
// relocatable device code linked with helix_pow.cu (ops/helix.py
// FRG_BUILD), whose pow must be torch's; the relocatable build costs
// registers and spills, so only the configurations with the law pay.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_common.cuh"
#include "psd_deposit.cuh"

#ifndef K5_BLOCK
#define K5_BLOCK 128
#endif
#ifndef K5_MIN_BLOCKS
#define K5_MIN_BLOCKS 0
#endif
#ifndef K5_FRG
#define K5_FRG 0
#endif
#if K5_MIN_BLOCKS > 0
#define K5_BOUNDS __launch_bounds__(K5_BLOCK, K5_MIN_BLOCKS)
#else
#define K5_BOUNDS __launch_bounds__(K5_BLOCK)
#endif

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
#if K5_FRG
// pow and powf as torch's kernels compute them (helix_pow.cu, a unit
// built with FMA contraction on and linked in)
__device__ double helix_pow(double a, double b);
__device__ float helix_powf(float a, float b);
__device__ __forceinline__ double f_pow(double a, double b) {
  return helix_pow(a, b);
}
__device__ __forceinline__ float f_pow(float a, float b) {
  return helix_powf(a, b);
}
#endif
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
  // the drain's: the block loop's steps a block and its cap in steps,
  // and its workspace (WS_* header, then the FL_JRET list)
  int sync_every, cap_steps;
  int* ws;
};

// the drain's workspace: int32 words, zeroed by the launcher
enum {
  WS_CURSOR = 0,     // the next unclaimed lane, past the grid's own
  WS_MAX_STEPS = 1,  // the most steps a lane took in the segment
  WS_DONE = 2,       // blocks that have finished
  WS_NJRET = 3,      // entries of the FL_JRET list
  WS_TAKEN = 4,      // the block loop's steps, written by the last block
  WS_PUSHES = 6,     // [6, 8): the segment's steps of all lanes, uint64
  WS_HEADER = 8      // then (lane, steps) pairs, at most n
};

// one lane's state, in registers
template <typename T>
struct Lane {
  T w, pb, pperp, phi, uxp, xnp, tstep;
  double x, prp, acct;
  int igrid, tcut, status, reason, nsteps, flags;
  uint32_t k0, k1;
};

// a step's deposits, made by the whole warp at the end of the step
struct Dep {
  bool dep_flux, fire, donate, hit_ok;
  int lo_c, hi_c, cell, fire_slot, fire_ip, pool_a, pool_b, ip_sk, ip_pf;
  double fx[4];
  double pool_v, xs_sf, xs_pf, x_hit_old, x_hit_new;
  float psd_v;
};

// the per-thread sums, reduced per warp at the end of a launch
struct Sums {
  double s_px, s_en, s_p, s_ke, s_retro, s_recv, s_rad;
};

// the launch's constants: the packed tables' scalars and the flags
template <typename T>
struct Consts {
  int nb, nz, i_grid_feb, i_shock, n_mom, n_theta, n_xspec, nx, n_slots;
  bool dont_scatter, dont_dsa, is_el, rad_on, do_retro, do_tcuts, xfer_on,
      eps_b, frg_on, reflect, age_cut, feb_dw_on, xspec_on;
  T m, mc, e0, two_m, abs_q, qb2, pcut, pcut_prev, pmax, u2, g0u0;
  T pe_crit, gamma_e_crit, inj_frac, b_cmbz, one, three, ten, c, two_pi;
  T spike_c, tiny, tiny30, cmax_coarse, cmax_fine, xn_coarse, xn_fine;
  T eta, twelve_pi, frg_rg0, frg_am1;
  double feb_up, feb_dw, x_stop, age_max;
  T ux_dw, gsf_dw, gef_dw, b_dw, eta3, rad, e_rel, pmin, log_pmin;
  T inv_dcos, cos_fine, theta_min, log_tmin, ewf, ftiny, bpd_mom, bpd_theta;
};

template <typename T, int CT>
__device__ __forceinline__ Consts<T> load_consts(const K5Args<T>& a) {
  const int* __restrict__ ki = a.ki;
  const double* __restrict__ kv = a.kv;
  Consts<T> k;
  k.nb = ki[KI_NB], k.nz = k.nb + 1;
  k.i_grid_feb = ki[KI_I_GRID_FEB], k.i_shock = ki[KI_I_SHOCK];
  k.n_mom = ki[KI_N_MOM], k.n_theta = ki[KI_N_THETA];
  k.n_xspec = ki[KI_N_XSPEC], k.nx = ki[KI_NX];
  k.n_slots = ki[KI_N_SLOTS];
  const int fl = CT >= 0 ? CT : ki[KI_FLAGS];
  k.dont_scatter = (fl & FLAG_DONT_SCATTER) != 0;
  k.dont_dsa = (fl & FLAG_DONT_DSA) != 0;
  k.is_el = (fl & FLAG_ELECTRON) != 0;
  k.rad_on = (fl & FLAG_RAD_LOSSES) != 0 && k.is_el;
  k.do_retro = (fl & FLAG_RETRO) != 0;
  k.do_tcuts = (fl & FLAG_TCUTS) != 0;
  k.xfer_on = (fl & FLAG_ENERGY_TRANSFER) != 0;
  k.eps_b = (fl & FLAG_CUSTOM_EPS_B) != 0;
  k.frg_on = K5_FRG && (fl & FLAG_CUSTOM_FRG) != 0;
  k.reflect = (fl & FLAG_REFLECT) != 0;
  k.age_cut = (fl & FLAG_AGE_CUT) != 0;
  k.feb_dw_on = (fl & FLAG_FEB_DW) != 0;
  k.xspec_on = (fl & FLAG_XSPEC) != 0;

  k.m = (T)kv[KV_M], k.mc = (T)kv[KV_MC], k.e0 = (T)kv[KV_E0];
  k.two_m = (T)kv[KV_TWO_M], k.abs_q = (T)kv[KV_ABS_CHARGE];
  k.qb2 = (T)kv[KV_QB2], k.pcut = (T)kv[KV_PCUT];
  k.pcut_prev = (T)kv[KV_PCUT_PREV], k.pmax = (T)kv[KV_PMAX];
  k.u2 = (T)kv[KV_U2], k.g0u0 = (T)kv[KV_G0U0];
  k.pe_crit = (T)kv[KV_PE_CRIT], k.gamma_e_crit = (T)kv[KV_GAMMA_E_CRIT];
  k.inj_frac = (T)kv[KV_INJ_FRAC], k.b_cmbz = (T)kv[KV_B_CMBZ];
  k.one = (T)kv[KV_ONE], k.three = (T)kv[KV_THREE], k.ten = (T)kv[KV_TEN];
  k.c = (T)kv[KV_C], k.two_pi = (T)kv[KV_TWO_PI];
  k.spike_c = (T)kv[KV_SPIKE], k.tiny = (T)kv[KV_TINY];
  k.tiny30 = (T)kv[KV_TINY30];
  k.cmax_coarse = (T)kv[KV_CMAX_COARSE];
  k.cmax_fine = (T)kv[KV_CMAX_FINE];
  k.xn_coarse = (T)kv[KV_XN_COARSE], k.xn_fine = (T)kv[KV_XN_FINE];
  k.eta = (T)kv[KV_ETA], k.twelve_pi = (T)kv[KV_TWELVE_PI];
  k.frg_rg0 = (T)kv[KV_FRG_RG0], k.frg_am1 = (T)kv[KV_FRG_AM1];
  k.feb_up = kv[KV_FEB_UP], k.feb_dw = kv[KV_FEB_DW];
  k.x_stop = kv[KV_X_STOP], k.age_max = kv[KV_AGE_MAX];
  k.ux_dw = (T)kv[KV_UX_DW], k.gsf_dw = (T)kv[KV_GSF_DW];
  k.gef_dw = (T)kv[KV_GEF_DW], k.b_dw = (T)kv[KV_B_DW];
  k.eta3 = (T)kv[KV_ETA3], k.rad = (T)kv[KV_RAD];
  k.e_rel = (T)kv[KV_E_REL], k.pmin = (T)kv[KV_PSD_MOM_MIN];
  k.log_pmin = (T)kv[KV_LOG_PMIN];
  k.inv_dcos = T(1) / (T)kv[KV_DCOS];
  k.cos_fine = (T)kv[KV_COS_FINE], k.theta_min = (T)kv[KV_THETA_MIN];
  k.log_tmin = (T)kv[KV_LOG_TMIN], k.ewf = (T)kv[KV_EWF];
  k.ftiny = (T)kv[KV_FTINY];
  k.bpd_mom = (T)ki[KI_BPD_MOM], k.bpd_theta = (T)ki[KI_BPD_THETA];
  return k;
}

template <typename T>
__device__ __forceinline__ void load_lane(const K5Args<T>& a, int i,
                                          Lane<T>& l) {
  l.w = a.w[i], l.pb = a.pb[i], l.pperp = a.pperp[i], l.phi = a.phi[i];
  l.uxp = a.uxp[i], l.xnp = a.xnp[i], l.tstep = a.tstep[i];
  l.x = a.x[i], l.prp = a.prp[i], l.acct = a.acct[i];
  l.igrid = a.igrid[i], l.tcut = a.tcut[i], l.status = a.status[i];
  l.reason = a.reason[i], l.nsteps = a.nsteps[i], l.flags = a.flags[i];
  l.k0 = (uint32_t)a.key0[i], l.k1 = (uint32_t)a.key1[i];
}

template <typename T>
__device__ __forceinline__ void store_lane(const K5Args<T>& a, int i,
                                           const Lane<T>& l) {
  a.pb[i] = l.pb, a.pperp[i] = l.pperp, a.phi[i] = l.phi;
  a.uxp[i] = l.uxp, a.xnp[i] = l.xnp, a.tstep[i] = l.tstep;
  a.x[i] = l.x, a.prp[i] = l.prp, a.acct[i] = l.acct;
  a.igrid[i] = l.igrid, a.tcut[i] = l.tcut, a.status[i] = l.status;
  a.reason[i] = l.reason, a.nsteps[i] = l.nsteps, a.flags[i] = l.flags;
}

// One helix step of an ACTIVE lane: its new state in `l`, its deposits
// in `d`, its escape sums and counters added to `s`.
template <typename T>
__device__ __forceinline__ void step_lane(const K5Args<T>& a,
                                          const Consts<T>& k, Lane<T>& l,
                                          Dep& d, Sums& s) {
  // the lane, the step's pending deposits and the sums, by the names
  // of the plain step
  const T& w = l.w;
  T &pb = l.pb, &pperp = l.pperp, &phi = l.phi, &uxp = l.uxp;
  T &xnp = l.xnp, &tstep = l.tstep;
  double &x = l.x, &prp = l.prp, &acct = l.acct;
  int &igrid = l.igrid, &tcut = l.tcut, &status = l.status;
  int &reason = l.reason, &nsteps = l.nsteps, &flags = l.flags;
  const uint32_t k0 = l.k0, k1 = l.k1;
  bool &dep_flux = d.dep_flux, &fire = d.fire, &donate = d.donate;
  bool &hit_ok = d.hit_ok;
  int &lo_c = d.lo_c, &hi_c = d.hi_c, &cell = d.cell;
  int &fire_slot = d.fire_slot, &fire_ip = d.fire_ip;
  int &pool_a = d.pool_a, &pool_b = d.pool_b, &ip_sk = d.ip_sk;
  int &ip_pf = d.ip_pf;
  double(&fx)[4] = d.fx;
  double &pool_v = d.pool_v, &xs_sf = d.xs_sf, &xs_pf = d.xs_pf;
  double &x_hit_old = d.x_hit_old, &x_hit_new = d.x_hit_new;
  float& psd_v = d.psd_v;
  double &s_px = s.s_px, &s_en = s.s_en, &s_p = s.s_p, &s_ke = s.s_ke;
  double &s_retro = s.s_retro, &s_recv = s.s_recv, &s_rad = s.s_rad;
  // the constants
  const int nb = k.nb, i_grid_feb = k.i_grid_feb, i_shock = k.i_shock;
  const int n_mom = k.n_mom, n_theta = k.n_theta, n_slots = k.n_slots;
  const bool dont_scatter = k.dont_scatter, dont_dsa = k.dont_dsa;
  const bool is_el = k.is_el, rad_on = k.rad_on, do_retro = k.do_retro;
  const bool do_tcuts = k.do_tcuts, xfer_on = k.xfer_on, eps_b = k.eps_b;
  const bool frg_on = k.frg_on, reflect = k.reflect, age_cut = k.age_cut;
  const bool feb_dw_on = k.feb_dw_on, xspec_on = k.xspec_on;
  const T m = k.m, mc = k.mc, e0 = k.e0, two_m = k.two_m, abs_q = k.abs_q;
  const T qb2 = k.qb2, pcut = k.pcut, pcut_prev = k.pcut_prev;
  const T pmax = k.pmax, u2 = k.u2, g0u0 = k.g0u0, pe_crit = k.pe_crit;
  const T gamma_e_crit = k.gamma_e_crit, inj_frac = k.inj_frac;
  const T b_cmbz = k.b_cmbz, one = k.one, three = k.three, ten = k.ten;
  const T c = k.c, two_pi = k.two_pi, spike_c = k.spike_c, tiny = k.tiny;
  const T tiny30 = k.tiny30, cmax_coarse = k.cmax_coarse;
  const T cmax_fine = k.cmax_fine, xn_coarse = k.xn_coarse;
  const T xn_fine = k.xn_fine, eta = k.eta, twelve_pi = k.twelve_pi;
  const T frg_rg0 = k.frg_rg0, frg_am1 = k.frg_am1;
  const double feb_up = k.feb_up, feb_dw = k.feb_dw;
  const double x_stop = k.x_stop, age_max = k.age_max;
  const T ux_dw = k.ux_dw, gsf_dw = k.gsf_dw, gef_dw = k.gef_dw;
  const T b_dw = k.b_dw, eta3 = k.eta3, rad = k.rad, e_rel = k.e_rel;
  const T pmin = k.pmin, log_pmin = k.log_pmin, inv_dcos = k.inv_dcos;
  const T cos_fine = k.cos_fine, theta_min = k.theta_min;
  const T log_tmin = k.log_tmin, ewf = k.ewf, ftiny = k.ftiny;
  const T bpd_mom = k.bpd_mom, bpd_theta = k.bpd_theta;

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
#if K5_FRG
    if (frg_on) {
      // lambda = eta r_g (r_g / r_ref)^(alpha - 1): torch.pow
      const T p_scat = (is_el && ptot < pe_crit) ? pe_crit : ptot;
      const T f_frg = f_pow(p_scat * c * gden / frg_rg0, frg_am1);
      cos_max = f_cos(f_sqrt(twelve_pi /
                             (xnp * eta * tmax(f_frg, tiny30))));
    }
#endif
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

// The step's deposits, by the whole warp (every lane calls it once a
// step; a lane without an entry passes d as zero-initialised).  `w` is
// the lane's weight, the tcut tallies' value.
template <typename T>
__device__ __forceinline__ void deposit_step(const K5Args<T>& a,
                                             const Consts<T>& k,
                                             const Dep& d, T w,
                                             double* flux_s) {
  const int nz = k.nz, n_mom = k.n_mom, n_theta = k.n_theta;
  const int n_slots = k.n_slots, n_xspec = k.n_xspec, nx = k.nx;
  const bool xspec_on = k.xspec_on;
  const bool dep_flux = d.dep_flux, fire = d.fire, donate = d.donate;
  const bool hit_ok = d.hit_ok;
  const int lo_c = d.lo_c, hi_c = d.hi_c, cell = d.cell;
  const int fire_slot = d.fire_slot, fire_ip = d.fire_ip;
  const int pool_a = d.pool_a, pool_b = d.pool_b, ip_sk = d.ip_sk;
  const int ip_pf = d.ip_pf;
  const double(&fx)[4] = d.fx;
  const double pool_v = d.pool_v, xs_sf = d.xs_sf, xs_pf = d.xs_pf;
  const double x_hit_old = d.x_hit_old, x_hit_new = d.x_hit_new;
  const float psd_v = d.psd_v;

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

// A launch's end: this block's flux array into the tallies, once; the
// escape sums and counters, once a warp.
__device__ __forceinline__ void flush_block(double* flux_g, double* esc,
                                            double* cnt, int nz,
                                            const double* flux_s, Sums s) {
  __syncthreads();
  for (int z = threadIdx.x; z < 4 * nz; z += blockDim.x) {
    const double v = flux_s[z];
    if (v != 0.0) atomicAdd(&flux_g[z], v);
  }
  s.s_px = warp_sum(s.s_px);
  s.s_en = warp_sum(s.s_en);
  s.s_p = warp_sum(s.s_p);
  s.s_ke = warp_sum(s.s_ke);
  s.s_retro = warp_sum(s.s_retro);
  s.s_recv = warp_sum(s.s_recv);
  s.s_rad = warp_sum(s.s_rad);
  if ((threadIdx.x & 31) == 0) {
    if (s.s_px != 0.0) atomicAdd(&esc[0], s.s_px);
    if (s.s_en != 0.0) atomicAdd(&esc[1], s.s_en);
    if (s.s_p != 0.0) atomicAdd(&esc[2], s.s_p);
    if (s.s_ke != 0.0) atomicAdd(&esc[3], s.s_ke);
    if (s.s_retro != 0.0) atomicAdd(&cnt[C_RETRO], s.s_retro);
    if (s.s_recv != 0.0) atomicAdd(&cnt[C_RECV], s.s_recv);
    if (s.s_rad != 0.0) atomicAdd(&cnt[C_RAD], s.s_rad);
  }
}

template <typename T>
__device__ __forceinline__ void empty_lane(Lane<T>& l) {
  l.w = l.pb = l.pperp = l.phi = l.uxp = l.xnp = l.tstep = T(0);
  l.x = l.prp = l.acct = 0.0;
  l.igrid = l.tcut = l.reason = l.nsteps = l.flags = 0;
  l.status = FINISHED;
  l.k0 = l.k1 = 0u;
}

// n_steps helix steps of every lane of a window, one thread a lane
template <typename T, int CT>
__global__ void K5_BOUNDS helix_step_kernel(const K5Args<T> a) {
  extern __shared__ double flux_s[];   // [4 * nz], this block's flux
  const Consts<T> k = load_consts<T, CT>(a);
  for (int z = threadIdx.x; z < 4 * k.nz; z += blockDim.x) flux_s[z] = 0.0;
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = i < a.n;
  Lane<T> l;
  empty_lane(l);
  if (lane) load_lane(a, i, l);
  Sums s = {};

  for (int st = 0; st < a.n_steps; ++st) {
    // a lane that is not ACTIVE does not step; the plain step only clears
    // its FL_JRET bit (warp-uniform exit once no lane of the warp is left)
    if (!__any_sync(kFull, l.status == ACTIVE)) {
      l.flags &= ~FL_JRET;
      break;
    }
    Dep d = {};
    if (l.status != ACTIVE) {
      l.flags &= ~FL_JRET;
    } else {
      step_lane(a, k, l, d, s);
    }
    deposit_step(a, k, d, l.w, flux_s);
  }

  if (lane) store_lane(a, i, l);
  flush_block(a.flux, a.esc, a.cnt, k.nz, flux_s, s);
}

// The next unclaimed index of a device cursor, one atomicAdd for the
// lanes converged at the call (K1's claim, mega_step.cu)
__device__ __forceinline__ int claim(int* cursor) {
  const unsigned mask = __activemask();
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cursor, __popc(mask));
  base = __shfl_sync(mask, base, leader);
  return base + __popc(mask & ((1u << lane) - 1u));
}

// a lane that ends the drain with FL_JRET after `steps` steps
__device__ __forceinline__ void note_jret(int* ws, int lane, int steps) {
  const int at = atomicAdd(&ws[WS_NJRET], 1);
  ws[WS_HEADER + 2 * at] = lane;
  ws[WS_HEADER + 2 * at + 1] = steps;
}

__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ unsigned long long warp_sum_u64(
    unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// One pcut segment: every ACTIVE lane stepped until it leaves ACTIVE,
// by the resident threads claiming lanes; the last block to finish
// writes the block loop's steps and applies its FL_JRET rule.
template <typename T, int CT>
__global__ void K5_BOUNDS helix_drain_kernel(const K5Args<T> a) {
  extern __shared__ double flux_s[];   // [4 * nz], this block's flux
  __shared__ bool last_block;
  const Consts<T> k = load_consts<T, CT>(a);
  for (int z = threadIdx.x; z < 4 * k.nz; z += blockDim.x) flux_s[z] = 0.0;
  __syncthreads();

  int* const ws = a.ws;
  const int n = a.n;
  const int n_threads = gridDim.x * blockDim.x;
  // the persistent lane loop: `next` is the index this thread tries to
  // claim (its own first, then from the cursor), `i` the lane it holds
  int next = blockIdx.x * blockDim.x + threadIdx.x;
  int i = -1, steps0 = 0, max_steps = 0;
  unsigned long long pushes = 0ull;
  Lane<T> l;
  empty_lane(l);
  Sums s = {};
  for (;;) {
    if (i < 0 && next < n) {
      while (next < n && a.status[next] != ACTIVE) {
        // skipped: 0 steps, so the block loop clears its FL_JRET
        if (a.flags[next] & FL_JRET) note_jret(ws, next, 0);
        next = n_threads + claim(&ws[WS_CURSOR]);
      }
      if (next < n) {
        i = next;
        load_lane(a, i, l);
        steps0 = l.nsteps;
      }
    }
    // warp-uniform: the deposits below take every lane of the warp
    if (!__any_sync(kFull, i >= 0)) break;
    Dep d = {};
    if (i >= 0) step_lane(a, k, l, d, s);
    deposit_step(a, k, d, l.w, flux_s);
    if (i >= 0 && l.status != ACTIVE) {
      // the lane ended: store it, take another
      store_lane(a, i, l);
      const int steps = l.nsteps - steps0;
      max_steps = max(max_steps, steps);
      pushes += (unsigned long long)steps;
      if (l.flags & FL_JRET) note_jret(ws, i, steps);
      i = -1;
      l.status = FINISHED;
      next = n_threads + claim(&ws[WS_CURSOR]);
    }
  }

  flush_block(a.flux, a.esc, a.cnt, k.nz, flux_s, s);
  max_steps = warp_max_i(max_steps);
  pushes = warp_sum_u64(pushes);
  if ((threadIdx.x & 31) == 0) {
    if (max_steps > 0) atomicMax(&ws[WS_MAX_STEPS], max_steps);
    if (pushes) atomicAdd((unsigned long long*)&ws[WS_PUSHES], pushes);
  }
  // the last block to finish sees every lane stored (the fence orders
  // this block's stores before its count)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd((unsigned*)&ws[WS_DONE], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const int s_max = __ldcg(&ws[WS_MAX_STEPS]);
  int taken = 0;
  if (s_max > 0) {
    taken = (s_max + a.sync_every - 1) / a.sync_every * a.sync_every;
    if (taken > a.cap_steps) taken = a.cap_steps;
  }
  const int n_jret = __ldcg(&ws[WS_NJRET]);
  for (int e = threadIdx.x; e < n_jret; e += blockDim.x) {
    const int lane = __ldcg(&ws[WS_HEADER + 2 * e]);
    if (__ldcg(&ws[WS_HEADER + 2 * e + 1]) < taken)
      a.flags[lane] = __ldcg(&a.flags[lane]) & ~FL_JRET;
  }
  if (threadIdx.x == 0) ws[WS_TAKEN] = taken;
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
  a.sync_every = 0, a.cap_steps = 0, a.ws = nullptr;
  return a;
}

template <int I>
static const void* instance_fn() {
  constexpr Instance in = kInstances[I];
  if (in.f64) return (const void*)helix_step_kernel<double, in.word>;
  return (const void*)helix_step_kernel<float, in.word>;
}

template <int I>
static const void* drain_fn() {
  constexpr Instance in = kInstances[I];
  if (in.f64) return (const void*)helix_drain_kernel<double, in.word>;
  return (const void*)helix_drain_kernel<float, in.word>;
}

static const void* kernel_fn(int i, bool drain) {
  static_assert(kNumInstances == 3, "the switches list 3 instances");
  switch (i) {
    case 0: return drain ? drain_fn<0>() : instance_fn<0>();
    case 1: return drain ? drain_fn<1>() : instance_fn<1>();
    case 2: return drain ? drain_fn<2>() : instance_fn<2>();
    default: return nullptr;
  }
}

// `fn`'s dynamic shared memory raised to `shared` bytes where that is
// above the default 48 KB
static cudaError_t allow_shared(const void* fn, size_t shared) {
  if (shared <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)shared);
}

template <int I>
static int launch_instance(void* const* p, int n, int n_steps, int max_helix,
                           int nz, cudaStream_t stream) {
  constexpr Instance in = kInstances[I];
  const size_t shared = (size_t)4 * nz * sizeof(double);
  const cudaError_t err = allow_shared(instance_fn<I>(), shared);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + K5_BLOCK - 1) / K5_BLOCK;
  if (in.f64)
    helix_step_kernel<double, in.word><<<grid, K5_BLOCK, shared, stream>>>(
        make_args<double>(p, n, n_steps, max_helix));
  else
    helix_step_kernel<float, in.word><<<grid, K5_BLOCK, shared, stream>>>(
        make_args<float>(p, n, n_steps, max_helix));
  return (int)cudaGetLastError();
}

// blocks of instance i's drain that one SM holds at once with `shared`
// bytes of dynamic shared memory, and the card's SMs
static cudaError_t drain_residency(int i, size_t shared, int* per_sm,
                                   int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = allow_shared(kernel_fn(i, true), shared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel_fn(i, true), K5_BLOCK, shared);
  return err;
}

template <int I>
static int launch_drain(void* const* p, int n, int max_helix, int sync_every,
                        int cap_steps, int nz, int* ws, cudaStream_t stream) {
  constexpr Instance in = kInstances[I];
  // the grid: what the card holds at once, asked once per shared size
  static size_t asked = 0;
  static int resident = 0;
  const size_t shared = (size_t)4 * nz * sizeof(double);
  if (asked != shared) {
    int per_sm = 0, sms = 0;
    const cudaError_t err = drain_residency(I, shared, &per_sm, &sms);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms <= 0) return (int)cudaErrorLaunchOutOfResources;
    resident = per_sm * sms;
    asked = shared;
  }
  int grid = (n + K5_BLOCK - 1) / K5_BLOCK;
  if (grid > resident) grid = resident;
  cudaError_t err = cudaMemsetAsync(ws, 0, WS_HEADER * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (in.f64) {
    K5Args<double> a = make_args<double>(p, n, 0, max_helix);
    a.sync_every = sync_every, a.cap_steps = cap_steps, a.ws = ws;
    helix_drain_kernel<double, in.word><<<grid, K5_BLOCK, shared, stream>>>(a);
  } else {
    K5Args<float> a = make_args<float>(p, n, 0, max_helix);
    a.sync_every = sync_every, a.cap_steps = cap_steps, a.ws = ws;
    helix_drain_kernel<float, in.word><<<grid, K5_BLOCK, shared, stream>>>(a);
  }
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

// the compile-time knobs this library was built with
extern "C" int mcs_helix_build(int* block, int* min_blocks, int* frg) {
  *block = K5_BLOCK;
  *min_blocks = K5_MIN_BLOCKS;
  *frg = K5_FRG;
  return 0;
}

// registers and bytes of local memory (stack and spills) a thread of
// instance i's window kernel (drain = 0) or drain kernel (drain = 1),
// from the CUDA runtime
extern "C" int mcs_helix_instance_attrs(int i, int drain, int* regs,
                                        int* local_bytes) {
  const void* fn = kernel_fn(i, drain != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(&at, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  return 0;
}

// the blocks of instance i's drain one SM holds at once, with nz zone
// boundaries' flux array, and the card's SMs
extern "C" int mcs_helix_drain_residency(int i, int nz, int* per_sm,
                                         int* sms) {
  if (i < 0 || i >= kNumInstances) return (int)cudaErrorInvalidValue;
  return (int)drain_residency(i, (size_t)4 * nz * sizeof(double), per_sm,
                              sms);
}

// a word with the f(r_g) law runs only in the K5_FRG build
static bool runs_word(int instance, int word) {
  return instance >= 0 && instance < kNumInstances &&
         (kInstances[instance].word == CT_RUNTIME ||
          kInstances[instance].word == word) &&
         (K5_FRG || (word & FLAG_CUSTOM_FRG) == 0);
}

// One launch of instance `instance` on `stream`: `n_steps` helix steps of
// the `n` lanes whose arrays `ptrs` holds (N_PTR device pointers in the
// PTR order), the tallies added to in place.  `word` is the launch's flag
// word: a specialised instance runs only the word it was compiled for.
// `nz` sizes this block's shared flux array (4 nz doubles).
extern "C" int mcs_helix_launch(void* const* ptrs, int n, int n_steps,
                                int max_helix, int nz, int instance, int word,
                                void* stream) {
  if (!runs_word(instance, word)) return (int)cudaErrorInvalidValue;
  if (n <= 0 || n_steps <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (instance) {
    case 0: return launch_instance<0>(ptrs, n, n_steps, max_helix, nz, st);
    case 1: return launch_instance<1>(ptrs, n, n_steps, max_helix, nz, st);
    default: return launch_instance<2>(ptrs, n, n_steps, max_helix, nz, st);
  }
}

// One pcut segment of the `n` lanes of `ptrs` as one persistent launch of
// instance `instance` on `stream`, the tallies added to in place.  `ws`
// is the int32 workspace of WS_HEADER + 2 n words (its header zeroed
// here): afterwards ws[WS_TAKEN] holds the steps the block loop of
// `sync_every`-step blocks would have taken (at most `cap_steps`) and
// ws[WS_PUSHES] (uint64) the steps of all lanes.
extern "C" int mcs_helix_drain(void* const* ptrs, int n, int max_helix,
                               int sync_every, int cap_steps, int nz,
                               int instance, int word, int* ws,
                               void* stream) {
  if (!runs_word(instance, word) || sync_every <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0)
    return (int)cudaMemsetAsync(ws, 0, WS_HEADER * sizeof(int), st);
  switch (instance) {
    case 0: return launch_drain<0>(ptrs, n, max_helix, sync_every, cap_steps,
                                   nz, ws, st);
    case 1: return launch_drain<1>(ptrs, n, max_helix, sync_every, cap_steps,
                                   nz, ws, st);
    default: return launch_drain<2>(ptrs, n, max_helix, sync_every,
                                    cap_steps, nz, ws, st);
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
