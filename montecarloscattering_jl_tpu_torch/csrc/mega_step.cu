// K1: the helix-transport kernel for NVIDIA Hopper (sm_90a).
//
// Replaces montecarloscattering_jl_tpu/ops/pallas_step.py::_mega_kernel
// (with its body _mega_body): S helix steps per launch for every ACTIVE
// particle lane, with the lane's state resident on chip.  The plain
// PyTorch version of one launch, which this file mirrors statement by
// statement, is montecarloscattering_jl_tpu_torch/ops/mega.py::step_twin.
//
// What bounds it on this card: the f32/f64 ALU work of one push (two
// Threefry-2x32-20 blocks, ~10 hypot/sqrt, cos, sin, acos, two log, a
// zone lookup), a dependent chain that one thread walks alone.  There is
// no reuse to stage and no matrix to feed the tensor cores.  What holds it
// above that bound, and what the design does about each:
//   * Same-address atomics.  Lanes injected together cross the same zone
//     boundaries in the same momentum and angle bin, and atomics on one
//     address retire one after another (in L2 for the PSD, as a
//     compare-and-swap loop in shared memory for the f64 flux).  The
//     lanes of a warp that reach a tally together group equal addresses
//     with __match_any_sync, and one lane of each group adds the group's
//     sum (agg_add): the flux channels on (lo, hi), the PSD on (cell, lo,
//     hi), the pool and tcut tallies on their own keys.
//   * Dead threads and host round trips.  A launch is persistent: the
//     grid is at most what the card holds at once, each thread claims a
//     lane (its own index first, then the next unclaimed one from a
//     device cursor), runs it for up to n_steps steps or to its end,
//     stores it and claims another, until no lane is left.  A thread
//     never idles while a lane waits, a lane that is not ACTIVE costs one
//     4-byte read, and with n_steps at the helix cap one launch is a
//     whole drain: the host waits for nothing in between.
//   * The length of one step.  A drain ends with its longest lanes, a
//     few threads that each walk the step's dependent chain alone, so
//     the chain's length is the drain's time.  What only a rare branch
//     reads is computed inside that branch: the frame re-transform where
//     the zone's flow speed changed, the shock-frame momenta where a
//     boundary was crossed, the diffusion length beyond 1.1 PRP, a second
//     reflection try after a first was refused, and the step's second
//     Threefry block (u[4..7]) at a reflection or a PRP return.  The same
//     operations give the same bits; the common step drops eight of its
//     ten hypots and half its RNG.  The zone lookup tries the lane's last
//     zone and its neighbours before the binary search; the kernel is a
//     template over the static flag word, so the flagship's instance
//     carries none of the retro walk's, the energy transfer's or the
//     f(r_g) law's code (kInstances; every other combination runs the
//     instance that reads the flags at run time).
// Everything a lane touches stays in registers; the zone table and the
// four flux channels of the block live in shared memory, flushed once a
// launch; the escape and pressure sums are per-thread registers reduced
// per warp.  Per-lane results do not depend on which thread runs a lane
// or when: the RNG counter is the lane's own step count.
//
// The static flags of the megakernel's cfg (no-scatter, no-DSA,
// radiative losses, the retro walk, tcuts, energy transfer, custom
// eps_B, the custom f(r_g) mean-free-path law) are bits of si[SI_FLAGS],
// uniform across a launch, compile-time constants in the specialised
// instances.
// Their tallies go to global memory by f64 atomicAdd: the ion pool as a
// (lo, hi+1) difference pair into pool_diff, the tcut crossings into
// weight_coupled / spectra_coupled at the lane's final momentum bin.
// The tcut times and the received-energy prefix are read by index in
// f64, eps_target in f32; the acceleration time stays f64.  The port's
// own counters (retro entries, received and radiated energy) are
// per-thread f64 sums reduced per warp, like the escape sums.
//
// Numerics: momenta and fields f32, positions / PRP / acceleration time
// f64.  Build with -fmad=false (and never --use_fast_math) so every
// a*b+c rounds twice, as the twin's separate torch ops do; hypot is
// jnp.hypot's formula, written out.  Interface: plain C, loaded with
// ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_common.cuh"

#define ZMAX 128
// threads a block, and the blocks an SM must hold (the register cap:
// 65,536 / (K1_BLOCK * K1_MIN_BLOCKS) a thread)
#define K1_BLOCK 128
#define K1_MIN_BLOCKS 4

enum { ACTIVE = 0, SAVED = 1, FINISHED = 2 };
enum { R_DOWNSTREAM = 1, R_UPSTREAM_PMAX = 2, R_AGE = 3, R_RADIATED = 4 };
enum { FL_DW = 1, FL_INJ = 2, FL_RETRO = 4, FL_JRET = 8 };

// f32 scalar vector (ops/mega.py SF_*)
enum {
  SF_M, SF_MC, SF_E0, SF_INV_Q, SF_PCUT, SF_PCUT_PREV, SF_PMAX, SF_U2,
  SF_BMAG2, SF_G0U0, SF_PE_CRIT, SF_GAMMA_E_CRIT, SF_INJ_FRAC, SF_C,
  SF_ETA3, SF_XN_COARSE, SF_XN_FINE, SF_CMAX_COARSE, SF_CMAX_FINE,
  SF_TWO_PI, SF_PI, SF_PSD_MOM_MIN, SF_LOG_PMIN, SF_THETA_MIN,
  SF_LOG_TMIN, SF_COS_FINE, SF_DCOS, SF_INV_LN10, SF_SPIKE, SF_THREE,
  SF_ONE, SF_TINY30, SF_TINY37, SF_E_REL, SF_B_CMBZ, SF_EWF, SF_RAD,
  SF_B_DW, SF_GSF_DW, SF_GEF_DW, SF_UX_DW, SF_TEN, SF_FRG_RG0, SF_FRG_AM1,
  SF_ETA, SF_TWELVE_PI, N_SF
};
// f64 scalar vector (SD_*)
enum { SD_FEB_UP, SD_FEB_DW, SD_X_STOP, SD_AGE_MAX, N_SD };
// int vector (SI_*)
enum {
  SI_NB, SI_I_GRID_FEB, SI_N_MOM, SI_N_THETA, SI_BPD_MOM, SI_BPD_THETA,
  SI_IS_ELECTRON, SI_I_SHOCK, SI_N_TCUT, SI_FLAGS, N_SI
};
// bits of si[SI_FLAGS] (ops/mega.py FLAG_*)
enum {
  FLAG_DONT_SCATTER = 1, FLAG_DONT_DSA = 2, FLAG_RAD_LOSSES = 4,
  FLAG_RETRO = 8, FLAG_TCUTS = 16, FLAG_ENERGY_TRANSFER = 32,
  FLAG_CUSTOM_EPS_B = 64, FLAG_CUSTOM_FRG = 128
};
// An instance's compile-time word: the flag bits, CT_ELECTRON for an
// electron species; CT_RUNTIME reads both from si at run time.  A proton
// word never carries FLAG_RAD_LOSSES (the loss acts on electrons only).
enum { CT_ELECTRON = 256, CT_RUNTIME = -1 };
enum {
  CT_SCIENCE = FLAG_RETRO | FLAG_TCUTS | FLAG_ENERGY_TRANSFER |
               FLAG_CUSTOM_EPS_B
};
// ops/mega.py INSTANCES lists the same words in the same order
constexpr int kInstances[] = {
    0,
    CT_ELECTRON | FLAG_RAD_LOSSES,
    CT_SCIENCE,
    CT_ELECTRON | FLAG_RAD_LOSSES | CT_SCIENCE,
    FLAG_CUSTOM_FRG,
    CT_SCIENCE | FLAG_CUSTOM_FRG,
    CT_ELECTRON | FLAG_RAD_LOSSES | CT_SCIENCE | FLAG_CUSTOM_FRG,
    CT_RUNTIME};
constexpr int kNumInstances = sizeof(kInstances) / sizeof(int);

// u[4 + j] of a step (j in 0..3): the j-th 16-bit half of the step's
// second Threefry block
__device__ __forceinline__ float u_hi(uint32_t k0, uint32_t k1, int nsteps,
                                      int j) {
  uint32_t w2, w3;
  threefry2x32(k0, k1, (uint32_t)nsteps, 1u, &w2, &w3);
  const uint32_t w = j < 2 ? w2 : w3;
  return unit16((j & 1) ? w >> 16 : w & 0xFFFFu);
}

// jnp.hypot: max * sqrt(1 + (min/max)^2), 0 at 0
__device__ __forceinline__ float hyp(float a, float b) {
  a = fabsf(a);
  b = fabsf(b);
  float hi = a > b ? a : b;
  float lo = a > b ? b : a;
  if (hi == 0.0f) return hi;
  float r = lo / hi;
  return hi * sqrtf(1.0f + r * r);
}

// jnp.mod for floats
__device__ __forceinline__ float floor_mod(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((r < 0.0f) != (b < 0.0f))) r = r + b;
  return r;
}

__device__ __forceinline__ float fmaxp(float a, float b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// radiation_loss (ops/scattering.py): explicit step, implicit where it
// would overshoot
__device__ __forceinline__ float rad_loss(float rad, float bsq, float p,
                                          float dt) {
  const float dlnp = rad * bsq * p * dt;
  return dlnp > 1e-2f ? p / (1.0f + dlnp) : p * (1.0f - dlnp);
}

// the megakernel's momentum bin (get_psd_bins.jl:16-39)
__device__ __forceinline__ int mom_bin(float p, float tiny37, float inv_ln10,
                                       float log_pmin, float bpd_mom,
                                       float psd_mom_min, int n_mom) {
  const float lp = logf(fmaxp(p, tiny37)) * inv_ln10 - log_pmin;
  int ipb = (int)floorf(lp * bpd_mom) + 1;
  if (p < psd_mom_min) ipb = 0;
  return clampi(ipb, 0, n_mom);
}

// index of the last boundary <= x, -1 below the grid
__device__ __forceinline__ int zone_of(const double* xg, int nb, double x) {
  int lo = 0, hi = nb;  // first index with xg[i] > x
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (xg[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo - 1;
}

// zone_of(xg, nb, x), trying zone h (in [-1, nb - 1]) and its two
// neighbours first: the same index by construction
__device__ __forceinline__ int zone_near(const double* xg, int nb, double x,
                                         int h) {
  const bool ge = h < 0 || xg[h] <= x;
  const bool lt = h + 1 >= nb || x < xg[h + 1];
  if (ge && lt) return h;
  if (ge) {                       // at or beyond the next boundary
    if (x >= xg[h + 1] && (h + 2 >= nb || x < xg[h + 2])) return h + 1;
  } else if (h > 0 && xg[h - 1] <= x && x < xg[h]) {
    return h - 1;
  } else if (h == 0 && x < xg[0]) {
    return -1;
  }
  return zone_of(xg, nb, x);
}

// The next unclaimed index of a device cursor, one atomicAdd for the
// lanes converged at the call
__device__ __forceinline__ int claim(int* cursor) {
  const unsigned mask = __activemask();
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cursor, __popc(mask));
  base = __shfl_sync(mask, base, leader);
  return base + __popc(mask & ((1u << lane) - 1u));
}

// the launch's arrays: a lane's state (in place), the segment's tables,
// the tallies (added to in place), and scratch = {cursor, live lanes}
struct K1Args {
  float *w, *pb, *pperp, *phi, *uxp, *xnp, *tstep;
  double *x, *prp, *acct;
  int *status, *reason, *nsteps, *flags, *tcut;
  const int *key0, *key1;
  const double* xg;
  const float *zf, *sf;
  const double* sd;
  const int* si;
  const double* tc;
  const float* et;
  const double* rp;
  float* psd;
  double *flux, *esc, *pool, *wc, *sc, *cnt;
  int* scratch;
  int n, n_steps, max_helix;
};

template <int CT>
__global__ void __launch_bounds__(K1_BLOCK, K1_MIN_BLOCKS)
mega_step_kernel(const K1Args a) {
  float* __restrict__ const w_g = a.w;
  float* __restrict__ const pb_g = a.pb;
  float* __restrict__ const pperp_g = a.pperp;
  float* __restrict__ const phi_g = a.phi;
  float* __restrict__ const uxp_g = a.uxp;
  float* __restrict__ const xnp_g = a.xnp;
  float* __restrict__ const tstep_g = a.tstep;
  double* __restrict__ const x_g = a.x;
  double* __restrict__ const prp_g = a.prp;
  double* __restrict__ const acct_g = a.acct;
  int* __restrict__ const status_g = a.status;
  int* __restrict__ const reason_g = a.reason;
  int* __restrict__ const nsteps_g = a.nsteps;
  int* __restrict__ const flags_g = a.flags;
  int* __restrict__ const tcut_g = a.tcut;
  const int* __restrict__ const key0_g = a.key0;
  const int* __restrict__ const key1_g = a.key1;
  const double* __restrict__ const xg_g = a.xg;
  const float* __restrict__ const zf_g = a.zf;
  const float* __restrict__ const sf_g = a.sf;
  const double* __restrict__ const sd_g = a.sd;
  const int* __restrict__ const si_g = a.si;
  const double* __restrict__ const tc_g = a.tc;
  const float* __restrict__ const et_g = a.et;
  const double* __restrict__ const rp_g = a.rp;
  float* __restrict__ const psd_g = a.psd;
  double* __restrict__ const flux_g = a.flux;
  double* __restrict__ const esc_g = a.esc;
  double* __restrict__ const pool_g = a.pool;
  double* __restrict__ const wc_g = a.wc;
  double* __restrict__ const sc_g = a.sc;
  double* __restrict__ const cnt_g = a.cnt;
  int* const cursor_g = a.scratch;
  int* const n_active_g = a.scratch + 1;
  const int n = a.n, n_steps = a.n_steps, max_helix = a.max_helix;

  __shared__ double xg[ZMAX];
  __shared__ float zux[ZMAX], zgsf[ZMAX], zgef[ZMAX], zb[ZMAX];
  __shared__ double flux_s[4 * ZMAX];

  const int nb = si_g[SI_NB];
  const int nz = nb + 1;
  const int i_grid_feb = si_g[SI_I_GRID_FEB];
  const int n_mom = si_g[SI_N_MOM];
  const int n_theta = si_g[SI_N_THETA];
  const float bpd_mom = (float)si_g[SI_BPD_MOM];
  const float bpd_theta = (float)si_g[SI_BPD_THETA];
  const bool is_el =
      CT >= 0 ? (CT & CT_ELECTRON) != 0 : si_g[SI_IS_ELECTRON] != 0;
  const int i_shock = si_g[SI_I_SHOCK];
  const int n_tc = si_g[SI_N_TCUT];
  const int fl = CT >= 0 ? (CT & 255) : si_g[SI_FLAGS];
  const bool dont_scatter = (fl & FLAG_DONT_SCATTER) != 0;
  const bool dont_dsa = (fl & FLAG_DONT_DSA) != 0;
  const bool rad_on = (fl & FLAG_RAD_LOSSES) != 0 && is_el;
  const bool do_retro = (fl & FLAG_RETRO) != 0;
  const bool do_tcuts = (fl & FLAG_TCUTS) != 0;
  const bool xfer_on = (fl & FLAG_ENERGY_TRANSFER) != 0;
  const bool eps_b = (fl & FLAG_CUSTOM_EPS_B) != 0;
  const bool frg_on = (fl & FLAG_CUSTOM_FRG) != 0;

  for (int z = threadIdx.x; z < nb; z += blockDim.x) {
    xg[z] = xg_g[z];
    zux[z] = zf_g[z];
    zgsf[z] = zf_g[nb + z];
    zgef[z] = zf_g[2 * nb + z];
    zb[z] = zf_g[3 * nb + z];
  }
  for (int z = threadIdx.x; z < 4 * nz; z += blockDim.x) flux_s[z] = 0.0;
  __syncthreads();

  const float m = sf_g[SF_M], mc = sf_g[SF_MC], e0 = sf_g[SF_E0];
  const float inv_q = sf_g[SF_INV_Q], pcut = sf_g[SF_PCUT];
  const float pcut_prev = sf_g[SF_PCUT_PREV], pmax_cutoff = sf_g[SF_PMAX];
  const float u2 = sf_g[SF_U2], bmag2 = sf_g[SF_BMAG2];
  const float g0u0 = sf_g[SF_G0U0], pe_crit = sf_g[SF_PE_CRIT];
  const float gamma_e_crit = sf_g[SF_GAMMA_E_CRIT];
  const float inj_frac = sf_g[SF_INJ_FRAC], c = sf_g[SF_C];
  const float eta3 = sf_g[SF_ETA3];
  const float xn_coarse = sf_g[SF_XN_COARSE], xn_fine = sf_g[SF_XN_FINE];
  const float cmax_coarse = sf_g[SF_CMAX_COARSE];
  const float cmax_fine = sf_g[SF_CMAX_FINE];
  const float two_pi = sf_g[SF_TWO_PI], pi = sf_g[SF_PI];
  const float psd_mom_min = sf_g[SF_PSD_MOM_MIN];
  const float log_pmin = sf_g[SF_LOG_PMIN];
  const float theta_min = sf_g[SF_THETA_MIN], log_tmin = sf_g[SF_LOG_TMIN];
  const float cos_fine = sf_g[SF_COS_FINE], dcos = sf_g[SF_DCOS];
  const float inv_ln10 = sf_g[SF_INV_LN10], spike_away = sf_g[SF_SPIKE];
  const float three = sf_g[SF_THREE], one = sf_g[SF_ONE];
  const float tiny30 = sf_g[SF_TINY30], tiny37 = sf_g[SF_TINY37];
  const float e_rel = sf_g[SF_E_REL];
  const float b_cmbz = sf_g[SF_B_CMBZ], ewf = sf_g[SF_EWF];
  const float rad = sf_g[SF_RAD], b_dw = sf_g[SF_B_DW];
  const float gsf_dw = sf_g[SF_GSF_DW], gef_dw = sf_g[SF_GEF_DW];
  const float ux_dw = sf_g[SF_UX_DW], ten = sf_g[SF_TEN];
  const float frg_rg0 = sf_g[SF_FRG_RG0], frg_am1 = sf_g[SF_FRG_AM1];
  const float eta = sf_g[SF_ETA], twelve_pi = sf_g[SF_TWELVE_PI];
  const double feb_up = sd_g[SD_FEB_UP], feb_dw = sd_g[SD_FEB_DW];
  const double x_stop = sd_g[SD_X_STOP], age_max = sd_g[SD_AGE_MAX];

  double s_px = 0.0, s_en = 0.0, s_p = 0.0, s_ke = 0.0;
  double s_retro = 0.0, s_recv = 0.0, s_rad = 0.0;
  int live = 0;

  // the persistent lane loop: `next` is the index this thread tries to
  // claim (its own first, then from the cursor), `i` the lane it holds
  const int n_threads = gridDim.x * blockDim.x;
  int next = blockIdx.x * blockDim.x + threadIdx.x;
  int i = -1, left = 0, zh = -1;
  float w_lane = 0.0f, pb = 0.0f, pperp = 0.0f, phi = 0.0f;
  float uxp = 0.0f, xnp = 0.0f, tstep = 0.0f;
  double x = 0.0, prp = 0.0, acct = 0.0;
  int status = FINISHED, reason = 0, nsteps = 0, flags = 0, tcut = 0;
  uint32_t k0 = 0u, k1 = 0u;
  for (;;) {
    if (i < 0) {
      while (next < n && status_g[next] != ACTIVE)
        next = n_threads + claim(cursor_g);
      if (next >= n) break;
      i = next;
      left = n_steps;
      w_lane = w_g[i];
      pb = pb_g[i], pperp = pperp_g[i], phi = phi_g[i];
      uxp = uxp_g[i], xnp = xnp_g[i], tstep = tstep_g[i];
      x = x_g[i], prp = prp_g[i], acct = acct_g[i];
      status = ACTIVE, reason = reason_g[i], nsteps = nsteps_g[i];
      flags = flags_g[i];
      tcut = tcut_g[i];
      k0 = (uint32_t)key0_g[i], k1 = (uint32_t)key1_g[i];
      zh = zone_of(xg, nb, x);
    }
    {
      bool retro = (flags & FL_RETRO) != 0;
      const bool jret = (flags & FL_JRET) != 0;
      bool dwf = (flags & FL_DW) != 0;
      bool injf = (flags & FL_INJ) != 0;
      const bool norm = !retro;
      bool do_b3 = norm && !jret;

      // the step's eight uniforms are 16-bit halves of two Threefry
      // blocks: u[0..3] of block 0, drawn every step; u[4..7] of block 1,
      // which only the reflection at the shock and the PRP return read,
      // drawn where they do (u_hi)
      float u[4];
      {
        uint32_t w0, w1;
        threefry2x32(k0, k1, (uint32_t)nsteps, 0u, &w0, &w1);
        u[0] = unit16(w0 & 0xFFFFu);
        u[1] = unit16(w0 >> 16);
        u[2] = unit16(w1 & 0xFFFFu);
        u[3] = unit16(w1 >> 16);
      }

      // ---- zone fields from position --------------------------------
      const int ig = zone_near(xg, nb, x, zh);
      const int igc = ig < 0 ? 0 : ig;
      const float ux = zux[igc], gsf = zgsf[igc], gef = zgef[igc];
      float bmag = zb[igc];
      if (eps_b && x > x_stop)
        bmag = b_dw * sqrtf((float)(x_stop / fmax(x, x_stop)));
      const float gden = inv_q / bmag;

      float ptot = hyp(pb, pperp);
      float gamma_pf = hyp(ptot / mc, one);

      // ---- Code Block 3 ---------------------------------------------
      // (a value that only a rare branch reads is computed inside that
      // branch, here and below: the same bits, a shorter common step)
      if (do_b3 && (ux != uxp)) {
        const float beta_old = uxp / c;
        const float gsf_old =
            one / sqrtf(fmaxp(1.0f - beta_old * beta_old, tiny30));
        const float px_sk_t = gsf_old * (pb + gamma_pf * m * uxp);
        const float pt_sk_t = hyp(px_sk_t, pperp);
        const float g_sk_t = hyp(pt_sk_t / mc, one);
        pb = gsf * (px_sk_t - g_sk_t * m * ux);
        ptot = hyp(pb, pperp);
        gamma_pf = hyp(ptot / mc, one);
      }
      if (do_b3) uxp = ux;

      // downstream escape with scattering off
      if (dont_scatter && do_b3 && x > (double)(10.0f * (pperp * c * gden))) {
        status = FINISHED;
        reason = R_DOWNSTREAM;
        do_b3 = false;
      }

      // pmax escape (both frames)
      if (do_b3 && ptot > pmax_cutoff) {
        const float px_sk0 = gsf * (pb + gamma_pf * m * ux);
        const float pt_sk0 = hyp(px_sk0, pperp);
        if (pt_sk0 > pmax_cutoff) {
          status = FINISHED;
          reason = R_UPSTREAM_PMAX;
          do_b3 = false;
        }
      }
      // upstream FEB escape
      if (do_b3 && injf && x < feb_up) {
        status = FINISHED;
        reason = R_UPSTREAM_PMAX;
        do_b3 = false;
      }
      // age escape
      if (do_b3 && acct > age_max) {
        status = FINISHED;
        reason = R_AGE;
        do_b3 = false;
      }

      // synchrotron + inverse-Compton losses
      if (rad_on) {
        const float b_cmb = b_cmbz * gef;
        const float p_lost =
            rad_loss(rad, bmag * bmag + b_cmb * b_cmb, ptot, tstep);
        const bool dead = do_b3 && (p_lost <= 0.0f);
        if (do_b3) {
          const float scale = p_lost / fmaxp(ptot, tiny30);
          pb = pb * scale;
          pperp = pperp * scale;
        }
        ptot = hyp(pb, pperp);
        const float gamma_in = gamma_pf;
        gamma_pf = hyp(ptot / mc, one);
        if (do_b3) s_rad += (double)((gamma_in - gamma_pf) * e0 * w_lane);
        if (dead) {
          status = FINISHED;
          reason = R_RADIATED;
          do_b3 = false;
        }
      }

      // pitch-angle scattering (parallel: no phase adjustment)
      if (do_b3 && !dont_scatter) {
        float cos_max = (xnp == xn_coarse) ? cmax_coarse : cmax_fine;
        if (frg_on) {
          // custom MFP law lambda = eta*r_g*(r_g/r_ref)^(alpha-1): the
          // power as exp(log(.)*(alpha-1)), the twin's order, not powf
          const float p_scat = (is_el && ptot < pe_crit) ? pe_crit : ptot;
          const float lg = logf(fmaxp(p_scat * c * gden / frg_rg0, tiny30));
          const float f_frg = expf(lg * frg_am1);
          cos_max = cosf(sqrtf(twelve_pi / (xnp * eta) /
                               fmaxp(f_frg, tiny30)));
        }
        const float safe_pt = fmaxp(ptot, tiny30);
        const float cos_old = pb / safe_pt;
        const float sin_old = pperp / safe_pt;
        const float cos_dt = 1.0f - u[0] * (1.0f - cos_max);
        const float sin_dt = sqrtf(fmaxp(1.0f - cos_dt * cos_dt, 0.0f));
        const float phi_sc = u[1] * two_pi - pi;
        const float cos_new = clampf(
            cos_old * cos_dt + sin_old * sin_dt * cosf(phi_sc), -1.0f, 1.0f);
        const float sin_new = sqrtf(fmaxp(1.0f - cos_new * cos_new, 0.0f));
        pb = ptot * cos_new;
        pperp = ptot * sin_new;
      }

      // gyro period / t_step
      const float g_eff =
          (is_el && ptot < pe_crit) ? gamma_e_crit : gamma_pf;
      const float gyro_period = two_pi * g_eff * mc * gden;

      // acctime (downstream only), tcuts, pcut save-out
      const bool adding = do_b3 && dwf;
      if (adding) acct = acct + (double)(tstep * gef);
      bool fire = false;
      int fire_slot = 0;
      if (do_tcuts && adding && tcut < n_tc && acct >= tc_g[tcut]) {
        fire = true;
        fire_slot = clampi(tcut, 0, n_tc - 1);
        tcut = tcut + 1;
      }
      if (adding && ptot > pcut) {
        status = SAVED;
        if (x >= prp) prp = x * 1.1;
        do_b3 = false;
      }

      const float r_g_tot = ptot * c * gden;
      if (norm && status == ACTIVE)
        xnp = (x > (double)r_g_tot) ? xn_coarse : xn_fine;

      // ---- movement --------------------------------------------------
      const bool moving = (status == ACTIVE) && !retro;
      if (moving) tstep = gyro_period / xnp;

      const double x_old = x;
      float dx_acc = 0.0f;
      float phi_fin = phi;
      if (moving) {
        bool done = false;
        float pb_m = pb, phi_m = phi;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (done) break;
          const float phi_try = floor_mod(phi_m + two_pi / xnp, two_pi);
          const float dx =
              gsf * (pb_m * tstep / (gamma_pf * m) + ux * tstep);
          const double x_try = x_old + (double)dx;
          const bool cross_up = (x_try <= 0.0) && (x_old > 0.0) && !injf &&
                                (dont_dsa || inj_frac < 1.0f);
          // the injection draw: u[5], then u[6]
          const bool refl =
              cross_up &&
              (dont_dsa || u_hi(k0, k1, nsteps, 1 + kk) > inj_frac);
          if (!refl) {
            dx_acc = dx;
            phi_fin = phi_try;
            done = true;
          } else if (pb_m < 0.0f) {
            pb_m = -pb_m;
          } else {
            // the new phase: u[7], then u[3]
            phi_m = (kk == 0 ? u_hi(k0, k1, nsteps, 3) : u[3]) * two_pi;
          }
        }
        if (!done) {
          const float phi_try = floor_mod(phi_m + two_pi / xnp, two_pi);
          const float dx =
              gsf * (pb_m * tstep / (gamma_pf * m) + ux * tstep);
          dx_acc = dx;
          phi_fin = phi_try;
        }
        pb = pb_m;
        phi = phi_fin;
        x = x + (double)dx_acc;
      }

      const bool first_dw = moving && (x_old < 0.0) && (x >= 0.0);
      dwf = dwf || first_dw;
      if (first_dw) {
        const float l_diff0 = eta3 * r_g_tot * ptot / (m * gamma_pf * u2);
        prp = prp > (double)l_diff0 ? prp : (double)l_diff0;
      }
      injf = injf || (moving && dwf && (x < 0.0));

      // ---- tallies (all_flux) ----------------------------------------
      int ig_new = ig;
      zh = ig;
      if (moving) {
        zh = zone_near(xg, nb, x, ig);
        ig_new = clampi(zh, 0, nb - 2);
      }

      const bool moved_down = x > x_old;
      int lo_z = moved_down ? ig + 1 : ig_new + 1;
      const int hi_z = moved_down ? ig_new : ig;
      if (!moved_down && injf && lo_z < i_grid_feb + 1) lo_z = i_grid_feb + 1;
      const bool crossed = moving && (hi_z >= lo_z);
      // escaping flux at the upstream FEB
      const bool esc_cross = moving && injf && x < feb_up && x_old >= feb_up;
      float px_sk = 0.0f, pt_sk = 0.0f, g_sk = 0.0f, e_add = 0.0f;
      if (crossed || esc_cross) {
        px_sk = gsf * (pb + gamma_pf * m * ux);
        pt_sk = hyp(px_sk, pperp);
        g_sk = hyp(pt_sk / mc, one);
        const bool rel = (g_sk - 1.0f) > e_rel;
        e_add = rel ? (g_sk - 1.0f) * e0 * w_lane
                    : pt_sk * pt_sk / (2.0f * m) * w_lane;
      }
      if (crossed) {
        const float pz_sk = -pperp * sinf(phi);
        const bool spike = pt_sk > fabsf(px_sk) * spike_away;
        const float inv_vx =
            spike ? fabsf(spike_away / ux)
                  : fabsf(g_sk * m / (px_sk == 0.0f ? tiny30 : px_sk));
        const int lo_c = clampi(lo_z, 0, nb - 1);
        const int hi_c = clampi(hi_z, 0, nb - 1);
        const float sign = moved_down ? 1.0f : -1.0f;
        const float v_pxx = sign * px_sk * w_lane * g0u0 * 1.0f;
        const float v_pxz = fabsf(pz_sk) * w_lane * g0u0 * 1.0f;
        const float v_en = sign * e_add * g0u0 * 1.0f;
        const float v_n = injf ? 0.0f : 1.0f;
        // the lanes of the warp that crossed the same range add once
        const unsigned crossers = __activemask();
        double vals[4] = {(double)v_pxx, (double)v_pxz, (double)v_en,
                          (double)v_n};
        if (group_sums(crossers, lo_c * ZMAX + hi_c, vals)) {
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) {
            atomicAdd(&flux_s[ch * nz + lo_c], vals[ch]);
            atomicAdd(&flux_s[ch * nz + hi_c + 1], -vals[ch]);
          }
        }

        // psd bins (get_psd_bins.jl:16-39, 73-97)
        const int ipb = mom_bin(pt_sk, tiny37, inv_ln10, log_pmin, bpd_mom,
                                psd_mom_min, n_mom);
        const float p_cos = clampf(-px_sk / fmaxp(pt_sk, tiny37), -1.0f, 1.0f);
        const int jlin = n_theta - (int)floorf((p_cos + 1.0f) / dcos);
        const float theta = acosf(p_cos);
        const float lt = logf(fmaxp(theta, tiny37)) * inv_ln10 - log_tmin;
        int jlog = (int)floorf(lt * bpd_theta) + 1;
        if (theta < theta_min) jlog = 0;
        int jt = (p_cos < cos_fine) ? jlin : jlog;
        if (pt_sk <= 0.0f) jt = 0;
        jt = clampi(jt, 0, n_theta);
        const int kind = injf ? 0 : 1;
        const long cell = (long)((ipb * 2 + kind) * (n_theta + 1) + jt);
        float psd_w[1] = {w_lane * inv_vx * 1.0f};
        if (group_sums(crossers, (cell * ZMAX + lo_c) * ZMAX + hi_c,
                       psd_w)) {
          atomicAdd(&psd_g[cell * nz + lo_c], psd_w[0]);
          atomicAdd(&psd_g[cell * nz + hi_c + 1], -psd_w[0]);
        }
      }

      if (esc_cross) {
        s_en += (double)(e_add * g0u0);
        s_px += (double)(-px_sk * w_lane * g0u0);
      }

      // ion <-> electron energy transfer (particle_loop.jl:652-723)
      if (xfer_on) {
        const int lo_c = clampi(lo_z, 0, nb - 1);
        const int hi_t = min(clampi(hi_z, 0, nb - 1), i_shock);
        const bool xfer = crossed && !injf && (x_old <= 0.0) && (hi_t >= lo_c);
        float g_f = gamma_pf;
        if (xfer && is_el) {
          const float gain = (float)(rp_g[hi_t + 1] - rp_g[lo_c]) * ewf;
          if (gain > 0.0f) {
            g_f = gamma_pf + gain / e0;
            s_recv += (double)((g_f - gamma_pf) * e0 * w_lane);
          }
        } else if (xfer) {
          const float eps_stop = et_g[hi_t];
          const float eps_start = et_g[igc];
          if (eps_stop > 0.0f) {
            g_f = fmaxp(1.0f + (gamma_pf - 1.0f) * (1.0f - eps_stop) /
                                   fmaxp(1.0f - eps_start, tiny30),
                        1.0f);
            const float n_range = (float)(hi_t - lo_c + 1);
            double inc[1] = {(double)(
                (gamma_pf - g_f) * e0 * w_lane / fmaxp(n_range, 1.0f))};
            if (group_sums(__activemask(), lo_c * ZMAX + hi_t, inc)) {
              atomicAdd(&pool_g[lo_c], inc[0]);
              atomicAdd(&pool_g[hi_t + 1], -inc[0]);
            }
          }
        }
        float scale = 1.0f;
        if (xfer && g_f != gamma_pf)
          scale = sqrtf(fmaxp(g_f * g_f - 1.0f, 0.0f)) /
                  fmaxp(sqrtf(fmaxp(gamma_pf * gamma_pf - 1.0f, 0.0f)),
                        tiny30);
        pb = pb * scale;
        pperp = pperp * scale;
        ptot = hyp(pb, pperp);
        gamma_pf = hyp(ptot / mc, one);
      }

      // ---- downstream logic ------------------------------------------
      bool jret_new = false;
      const bool esc_feb_dw = moving && (feb_dw > 0.0) && (x > feb_dw);
      bool esc_far = false;
      if (moving && !esc_feb_dw && (x > 1.1 * prp)) {
        float v_fac;
        if (is_el && ptot < pe_crit)
          v_fac = (pe_crit * c * gden) * pe_crit / (m * gamma_e_crit * u2);
        else
          v_fac = (ptot * c * gden) * ptot / (m * gamma_pf * u2);
        const float l_diff = eta3 * v_fac;
        esc_far = x > (double)(6.91f * l_diff);
      }
      const bool do_ret = moving && !esc_feb_dw && !esc_far;

      const bool past_end = do_ret && (x >= x_stop);
      const bool just_end = past_end && (x_old < x_stop);
      if (just_end) {
        float r_g2 = ptot * c;
        if (eps_b) r_g2 = r_g2 * sqrtf((float)(x_stop / fmax(x, x_stop)));
        r_g2 = r_g2 * inv_q / bmag2;
        const float l_diff2 = eta3 * r_g2 * ptot / (m * gamma_pf * u2);
        prp = x + (double)(3.0f * l_diff2);
      }

      const bool crossed_prp =
          past_end && !just_end && (x_old < prp) && (x >= prp);
      if (crossed_prp) {
        const float vt = ptot / (gamma_pf * m);
        const float q_ret = (vt - u2) / (vt + u2);
        const float p_ret = q_ret * q_ret;
        const bool no_ret = (vt < u2) || (u[2] > p_ret);
        if (no_ret) {
          status = FINISHED;
          reason = R_DOWNSTREAM;
        } else if (do_retro) {
          // enter the backward walk at the PRP
          retro = true;
          s_retro += 1.0;
          phi = u_hi(k0, k1, nsteps, 0) * two_pi;
          x = prp;
        } else {
          // analytic return
          const float span = u2 + vt;
          const float vmu = u2 - span * sqrtf(u[3]);
          const float mu = clampf(vmu / fmaxp(vt, tiny30), -1.0f, 1.0f);
          const float pb_ret = ptot * mu;
          pb = pb_ret;
          pperp = sqrtf(fmaxp(ptot * ptot - pb_ret * pb_ret, 0.0f));
          phi = u_hi(k0, k1, nsteps, 0) * two_pi;
          x = prp;
          jret_new = true;
        }
      }

      if (is_el) {
        const bool idle = past_end && !just_end && !crossed_prp;
        if (idle && ptot < pcut_prev && (nsteps % 1000) == 0) {
          const float r_g = ptot * c * gden;
          const float l_d = eta3 * r_g * ptot / (m * gamma_pf * u2);
          if (x > (double)(2.0e3f * l_d)) {
            prp = 0.8 * x;
          } else {
            const float ratio = pcut_prev / fmaxp(ptot, tiny30);
            const float r2 = ratio * ratio;
            const float p5 = ratio * (r2 * r2);
            const double cand = x_stop + (double)(l_d * p5);
            prp = prp < cand ? prp : cand;
          }
        }
      }

      if (esc_feb_dw || esc_far) {
        status = FINISHED;
        reason = R_DOWNSTREAM;
      }

      // downstream-escape pressure / KE sums
      if (moving && status == FINISHED && reason == R_DOWNSTREAM) {
        float vel = ptot / m;
        if ((gamma_pf - 1.0f) >= e_rel) vel = vel / gamma_pf;
        s_p += (double)(ptot / three * vel * w_lane);
        s_ke += (double)((gamma_pf - 1.0f) * e0 * w_lane);
      }

      // ---- the retro walk (prob_return.jl:217-344), of every lane in
      // retro mode now, those that entered it this step included
      if (do_retro && retro) {
        float b2 = b_dw;
        if (eps_b) b2 = b2 * sqrtf((float)(x_stop / fmax(x, x_stop)));
        const float gden_r = inv_q / b2;
        const float ptot_r = hyp(pb, pperp);
        const float gamma_r = hyp(ptot_r / mc, one);
        const float t_fac = two_pi * mc * gden_r / ten;
        const float t_step_r = t_fac * gamma_r;
        const float dx_r = gsf_dw * (pb * t_fac / m + (-ux_dw) * t_step_r);
        const double x_try = x + (double)dx_r;
        acct = acct + (double)(t_step_r * gef_dw);
        if (do_tcuts && tcut < n_tc && acct >= tc_g[tcut]) {
          fire = true;
          fire_slot = clampi(tcut, 0, n_tc - 1);
          tcut = tcut + 1;
        }
        const float phi_las = two_pi * u[0];
        const float mu_las = 2.0f * u[1] - 1.0f;
        float p_new = ptot_r;
        if (rad_on) {
          const float b_cmb = b_cmbz * gef_dw;
          p_new = rad_loss(rad, b2 * b2 + b_cmb * b_cmb, ptot_r, t_step_r);
          s_rad += (double)((gamma_r - hyp(p_new / mc, one)) * e0 * w_lane);
        }
        const bool dead_r = p_new <= 0.0f;
        const float pb_n = p_new * mu_las;
        const float pperp_n = sqrtf(fmaxp(p_new * p_new - pb_n * pb_n, 0.0f));
        const bool returned = !dead_r && (x_try < prp);
        x = returned ? prp : x_try;
        pb = pb_n;
        pperp = pperp_n;
        phi = phi_las;
        if (dead_r) {
          status = FINISHED;
          reason = R_RADIATED;
        }
        if (returned || dead_r) retro = false;
        if (returned) jret_new = true;
      }

      // the coupled weight and spectrum of the step's tcut crossing,
      // binned at the lane's final momentum (tcut_track!, cuts.jl:149-162)
      if (fire) {
        const int ip_pf = mom_bin(hyp(pb, pperp), tiny37, inv_ln10, log_pmin,
                                  bpd_mom, psd_mom_min, n_mom);
        const unsigned firing = __activemask();
        double w_sc[1] = {(double)w_lane}, w_wc[1] = {(double)w_lane};
        if (group_sums(firing, ip_pf * n_tc + fire_slot, w_sc))
          atomicAdd(&sc_g[ip_pf * n_tc + fire_slot], w_sc[0]);
        if (group_sums(firing, fire_slot, w_wc))
          atomicAdd(&wc_g[fire_slot], w_wc[0]);
      }

      // helix cap
      nsteps = nsteps + 1;
      if (status == ACTIVE && nsteps >= max_helix) {
        status = FINISHED;
        reason = R_DOWNSTREAM;
      }

      flags = (dwf ? FL_DW : 0) | (injf ? FL_INJ : 0) |
              (retro ? FL_RETRO : 0) | (jret_new ? FL_JRET : 0);
    }

    // the lane ended or its n_steps are over: store it, take another
    if (status == ACTIVE && --left > 0) continue;
    pb_g[i] = pb;
    pperp_g[i] = pperp;
    phi_g[i] = phi;
    uxp_g[i] = uxp;
    xnp_g[i] = xnp;
    tstep_g[i] = tstep;
    x_g[i] = x;
    prp_g[i] = prp;
    acct_g[i] = acct;
    status_g[i] = status;
    reason_g[i] = reason;
    nsteps_g[i] = nsteps;
    flags_g[i] = flags;
    tcut_g[i] = tcut;
    live += status == ACTIVE ? 1 : 0;
    i = -1;
    next = n_threads + claim(cursor_g);
  }

  __syncthreads();
  for (int z = threadIdx.x; z < 4 * nz; z += blockDim.x) {
    const double v = flux_s[z];
    if (v != 0.0) atomicAdd(&flux_g[z], v);
  }
  s_px = warp_sum(s_px);
  s_en = warp_sum(s_en);
  s_p = warp_sum(s_p);
  s_ke = warp_sum(s_ke);
  s_retro = warp_sum(s_retro);
  s_recv = warp_sum(s_recv);
  s_rad = warp_sum(s_rad);
  live = warp_sum_i(live);
  if ((threadIdx.x & 31) == 0) {
    if (s_px != 0.0) atomicAdd(&esc_g[0], s_px);
    if (s_en != 0.0) atomicAdd(&esc_g[1], s_en);
    if (s_p != 0.0) atomicAdd(&esc_g[2], s_p);
    if (s_ke != 0.0) atomicAdd(&esc_g[3], s_ke);
    if (s_retro != 0.0) atomicAdd(&cnt_g[0], s_retro);
    if (s_recv != 0.0) atomicAdd(&cnt_g[1], s_recv);
    if (s_rad != 0.0) atomicAdd(&cnt_g[2], s_rad);
    if (live) atomicAdd(n_active_g, live);
  }
}

// blocks of one instance the card holds at once (0: not asked yet)
static int g_resident[kNumInstances];

template <int I>
static int launch_instance(const K1Args& a, cudaStream_t stream) {
  auto kernel = mega_step_kernel<kInstances[I]>;
  if (g_resident[I] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          K1_BLOCK, 0);
    if (err != cudaSuccess) return (int)err;
    if (sms * per_sm <= 0) return (int)cudaErrorLaunchOutOfResources;
    g_resident[I] = sms * per_sm;
  }
  int grid = (a.n + K1_BLOCK - 1) / K1_BLOCK;
  if (grid > g_resident[I]) grid = g_resident[I];
  kernel<<<grid, K1_BLOCK, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mcs_mega_num_instances() { return kNumInstances; }

// the compile-time word of instance i (CT_RUNTIME for the generic one)
extern "C" int mcs_mega_instance_word(int i) {
  return i >= 0 && i < kNumInstances ? kInstances[i] : -2;
}

// registers a thread and bytes of local memory (stack and spills) a
// thread of instance i, and the blocks of it the card holds at once
// (after its first launch, else 0)
extern "C" int mcs_mega_instance_attrs(int i, int* regs, int* local_bytes,
                                       int* resident) {
  const void* fn = nullptr;
  switch (i) {
    case 0: fn = (const void*)mega_step_kernel<kInstances[0]>; break;
    case 1: fn = (const void*)mega_step_kernel<kInstances[1]>; break;
    case 2: fn = (const void*)mega_step_kernel<kInstances[2]>; break;
    case 3: fn = (const void*)mega_step_kernel<kInstances[3]>; break;
    case 4: fn = (const void*)mega_step_kernel<kInstances[4]>; break;
    case 5: fn = (const void*)mega_step_kernel<kInstances[5]>; break;
    case 6: fn = (const void*)mega_step_kernel<kInstances[6]>; break;
    case 7: fn = (const void*)mega_step_kernel<kInstances[7]>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(&at, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  *resident = g_resident[i];
  return 0;
}

// Launch instance `instance` on `stream`.  `word` is the launch's flag
// word (flags, CT_ELECTRON for electrons, a proton's FLAG_RAD_LOSSES
// cleared): a specialised instance runs only the word it was compiled
// for.  scratch = {0, 0} on entry; scratch[1] is the ACTIVE count after.
extern "C" int mcs_mega_launch(
    float* w, float* pb, float* pperp, float* phi, float* uxp, float* xnp,
    float* tstep, double* x, double* prp, double* acct, int* status,
    int* reason, int* nsteps, int* flags, int* tcut, const int* key0,
    const int* key1, const double* xg, const float* zf, const float* sf,
    const double* sd, const int* si, const double* tc, const float* et,
    const double* rp, float* psd, double* flux, double* esc, double* pool,
    double* wc, double* sc, double* cnt, int* scratch, int n, int n_steps,
    int max_helix, int instance, int word, void* stream) {
  static_assert(kNumInstances == 8, "the switches list 8 instances");
  if (instance < 0 || instance >= kNumInstances ||
      (kInstances[instance] != CT_RUNTIME && kInstances[instance] != word))
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || n_steps <= 0) return (int)cudaSuccess;
  const K1Args a = {w,    pb,     pperp, phi,  uxp, xnp, tstep, x,  prp,
                    acct, status, reason, nsteps, flags, tcut, key0, key1,
                    xg,   zf,     sf,    sd,   si,  tc,  et,    rp, psd,
                    flux, esc,    pool,  wc,   sc,  cnt, scratch, n,
                    n_steps, max_helix};
  cudaStream_t st = (cudaStream_t)stream;
  switch (instance) {
    case 0: return launch_instance<0>(a, st);
    case 1: return launch_instance<1>(a, st);
    case 2: return launch_instance<2>(a, st);
    case 3: return launch_instance<3>(a, st);
    case 4: return launch_instance<4>(a, st);
    case 5: return launch_instance<5>(a, st);
    case 6: return launch_instance<6>(a, st);
    default: return launch_instance<7>(a, st);
  }
}
