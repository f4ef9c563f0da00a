// K1: the helix-transport kernel for NVIDIA Hopper (sm_90a).
//
// Replaces montecarloscattering_jl_tpu/ops/pallas_step.py::_mega_kernel
// (with its body _mega_body): S helix steps per launch for every ACTIVE
// particle lane, with the lane's state resident on chip.  The plain
// PyTorch version of one launch, which this file mirrors statement by
// statement, is montecarloscattering_jl_tpu_torch/ops/mega.py::step_twin.
//
// What bounds it on this card: the f32/f64 ALU work of one push
// (two Threefry-2x32-20 blocks, ~10 hypot/sqrt, cos, sin, acos, two log,
// a binary search) plus atomic traffic on the tally cells of the zones
// around the shock, where most crossings land.  There is no reuse to
// stage and no matrix to feed the tensor cores, so the design keeps
// everything a lane touches in registers: one thread per lane, a
// register-resident S-step loop, the zone table in shared memory, the
// four flux channels in a per-block shared accumulator flushed once per
// launch, the escape and pressure sums in per-thread registers reduced
// per warp, and only the PSD difference array deposited straight into
// global memory by f32 atomicAdd.
//
// Numerics: momenta and fields f32, positions / PRP / acceleration time
// f64.  Build with -fmad=false (and never --use_fast_math) so every
// a*b+c rounds twice, as the twin's separate torch ops do; hypot is
// jnp.hypot's formula, written out.  Interface: plain C, loaded with
// ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define ZMAX 128
#define BLOCK 128

enum { ACTIVE = 0, SAVED = 1, FINISHED = 2 };
enum { R_DOWNSTREAM = 1, R_UPSTREAM_PMAX = 2, R_AGE = 3 };
enum { FL_DW = 1, FL_INJ = 2, FL_RETRO = 4, FL_JRET = 8 };

// f32 scalar vector (ops/mega.py SF_*)
enum {
  SF_M, SF_MC, SF_E0, SF_INV_Q, SF_PCUT, SF_PCUT_PREV, SF_PMAX, SF_U2,
  SF_BMAG2, SF_G0U0, SF_PE_CRIT, SF_GAMMA_E_CRIT, SF_INJ_FRAC, SF_C,
  SF_ETA3, SF_XN_COARSE, SF_XN_FINE, SF_CMAX_COARSE, SF_CMAX_FINE,
  SF_TWO_PI, SF_PI, SF_PSD_MOM_MIN, SF_LOG_PMIN, SF_THETA_MIN,
  SF_LOG_TMIN, SF_COS_FINE, SF_DCOS, SF_INV_LN10, SF_SPIKE, SF_THREE,
  SF_ONE, SF_TINY30, SF_TINY37, SF_E_REL, N_SF
};
// f64 scalar vector (SD_*)
enum { SD_FEB_UP, SD_FEB_DW, SD_X_STOP, SD_AGE_MAX, N_SD };
// int vector (SI_*)
enum {
  SI_NB, SI_I_GRID_FEB, SI_N_MOM, SI_N_THETA, SI_BPD_MOM, SI_BPD_THETA,
  SI_IS_ELECTRON, N_SI
};

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

__global__ void __launch_bounds__(BLOCK)
mega_step_kernel(float* __restrict__ w_g, float* __restrict__ pb_g,
                 float* __restrict__ pperp_g, float* __restrict__ phi_g,
                 float* __restrict__ uxp_g, float* __restrict__ xnp_g,
                 float* __restrict__ tstep_g, double* __restrict__ x_g,
                 double* __restrict__ prp_g, double* __restrict__ acct_g,
                 int* __restrict__ status_g, int* __restrict__ reason_g,
                 int* __restrict__ nsteps_g, int* __restrict__ flags_g,
                 const int* __restrict__ key0_g,
                 const int* __restrict__ key1_g,
                 const double* __restrict__ xg_g,
                 const float* __restrict__ zf_g,
                 const float* __restrict__ sf_g,
                 const double* __restrict__ sd_g,
                 const int* __restrict__ si_g, float* __restrict__ psd_g,
                 double* __restrict__ flux_g, double* __restrict__ esc_g,
                 int* __restrict__ n_active_g, int n, int n_steps,
                 int max_helix) {
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
  const bool is_el = si_g[SI_IS_ELECTRON] != 0;

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
  const double feb_up = sd_g[SD_FEB_UP], feb_dw = sd_g[SD_FEB_DW];
  const double x_stop = sd_g[SD_X_STOP], age_max = sd_g[SD_AGE_MAX];

  double s_px = 0.0, s_en = 0.0, s_p = 0.0, s_ke = 0.0;
  int live = 0;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && status_g[i] == ACTIVE) {
    const float w_lane = w_g[i];
    float pb = pb_g[i], pperp = pperp_g[i], phi = phi_g[i];
    float uxp = uxp_g[i], xnp = xnp_g[i], tstep = tstep_g[i];
    double x = x_g[i], prp = prp_g[i], acct = acct_g[i];
    int status = ACTIVE, reason = reason_g[i], nsteps = nsteps_g[i];
    int flags = flags_g[i];
    const uint32_t k0 = (uint32_t)key0_g[i], k1 = (uint32_t)key1_g[i];

    for (int s = 0; s < n_steps; ++s) {
      if (status != ACTIVE) break;
      const bool retro = (flags & FL_RETRO) != 0;
      const bool jret = (flags & FL_JRET) != 0;
      bool dwf = (flags & FL_DW) != 0;
      bool injf = (flags & FL_INJ) != 0;
      const bool norm = !retro;
      bool do_b3 = norm && !jret;

      float u[8];
      {
        uint32_t w0, w1, w2, w3;
        threefry2x32(k0, k1, (uint32_t)nsteps, 0u, &w0, &w1);
        threefry2x32(k0, k1, (uint32_t)nsteps, 1u, &w2, &w3);
        const uint32_t ws[4] = {w0, w1, w2, w3};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          u[2 * j] = ((float)(ws[j] & 0xFFFFu) + 0.5f) * (1.0f / 65536.0f);
          u[2 * j + 1] = ((float)(ws[j] >> 16) + 0.5f) * (1.0f / 65536.0f);
        }
      }

      // ---- zone fields from position --------------------------------
      const int ig = zone_of(xg, nb, x);
      const int igc = ig < 0 ? 0 : ig;
      const float ux = zux[igc], gsf = zgsf[igc], gef = zgef[igc];
      const float bmag = zb[igc];
      const float gden = inv_q / bmag;

      float ptot = hyp(pb, pperp);
      float gamma_pf = hyp(ptot / mc, one);

      // ---- Code Block 3 ---------------------------------------------
      const bool changed = do_b3 && (ux != uxp);
      {
        const float beta_old = uxp / c;
        const float gsf_old =
            one / sqrtf(fmaxp(1.0f - beta_old * beta_old, tiny30));
        const float px_sk_t = gsf_old * (pb + gamma_pf * m * uxp);
        const float pt_sk_t = hyp(px_sk_t, pperp);
        const float g_sk_t = hyp(pt_sk_t / mc, one);
        const float pb_tr = gsf * (px_sk_t - g_sk_t * m * ux);
        if (changed) pb = pb_tr;
      }
      ptot = hyp(pb, pperp);
      gamma_pf = hyp(ptot / mc, one);
      if (do_b3) uxp = ux;

      // pmax escape (both frames)
      {
        const float px_sk0 = gsf * (pb + gamma_pf * m * ux);
        const float pt_sk0 = hyp(px_sk0, pperp);
        if (do_b3 && ptot > pmax_cutoff && pt_sk0 > pmax_cutoff) {
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

      // pitch-angle scattering (parallel: no phase adjustment)
      if (do_b3) {
        const float cos_max = (xnp == xn_coarse) ? cmax_coarse : cmax_fine;
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

      // acctime (downstream only), pcut save-out
      const bool adding = do_b3 && dwf;
      if (adding) acct = acct + (double)(tstep * gef);
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
        const float u_inj[2] = {u[5], u[6]};
        const float u_phi[2] = {u[7], u[3]};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float phi_try = floor_mod(phi_m + two_pi / xnp, two_pi);
          const float dx =
              gsf * (pb_m * tstep / (gamma_pf * m) + ux * tstep);
          const double x_try = x_old + (double)dx;
          const bool cross_up = (x_try <= 0.0) && (x_old > 0.0) && !injf &&
                                (inj_frac < 1.0f);
          const bool fail = u_inj[kk] > inj_frac;
          const bool refl = !done && cross_up && fail;
          const bool accept = !done && !refl;
          if (accept) {
            dx_acc = dx;
            phi_fin = phi_try;
          }
          done = done || accept;
          const bool neg = pb_m < 0.0f;
          if (refl && neg) pb_m = -pb_m;
          if (refl && !neg) phi_m = u_phi[kk] * two_pi;
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
      if (moving) ig_new = clampi(zone_of(xg, nb, x), 0, nb - 2);

      const float px_sk = gsf * (pb + gamma_pf * m * ux);
      const float pt_sk = hyp(px_sk, pperp);
      const float g_sk = hyp(pt_sk / mc, one);
      const float pz_sk = -pperp * sinf(phi);
      const bool spike = pt_sk > fabsf(px_sk) * spike_away;
      const float inv_vx =
          spike ? fabsf(spike_away / ux)
                : fabsf(g_sk * m / (px_sk == 0.0f ? tiny30 : px_sk));
      const bool rel = (g_sk - 1.0f) > e_rel;
      const float e_add = rel ? (g_sk - 1.0f) * e0 * w_lane
                              : pt_sk * pt_sk / (2.0f * m) * w_lane;

      const bool moved_down = x > x_old;
      int lo_z = moved_down ? ig + 1 : ig_new + 1;
      const int hi_z = moved_down ? ig_new : ig;
      if (!moved_down && injf && lo_z < i_grid_feb + 1) lo_z = i_grid_feb + 1;
      const bool crossed = moving && (hi_z >= lo_z);
      if (crossed) {
        const int lo_c = clampi(lo_z, 0, nb - 1);
        const int hi_c = clampi(hi_z, 0, nb - 1);
        const float sign = moved_down ? 1.0f : -1.0f;
        const float v_pxx = sign * px_sk * w_lane * g0u0 * 1.0f;
        const float v_pxz = fabsf(pz_sk) * w_lane * g0u0 * 1.0f;
        const float v_en = sign * e_add * g0u0 * 1.0f;
        const float v_n = injf ? 0.0f : 1.0f;
        const float vals[4] = {v_pxx, v_pxz, v_en, v_n};
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          atomicAdd(&flux_s[ch * nz + lo_c], (double)vals[ch]);
          atomicAdd(&flux_s[ch * nz + hi_c + 1], -(double)vals[ch]);
        }

        // psd bins (get_psd_bins.jl:16-39, 73-97)
        const float lp = logf(fmaxp(pt_sk, tiny37)) * inv_ln10 - log_pmin;
        int ipb = (int)floorf(lp * bpd_mom) + 1;
        if (pt_sk < psd_mom_min) ipb = 0;
        ipb = clampi(ipb, 0, n_mom);
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
        const float psd_w = w_lane * inv_vx * 1.0f;
        atomicAdd(&psd_g[cell * nz + lo_c], psd_w);
        atomicAdd(&psd_g[cell * nz + hi_c + 1], -psd_w);
      }

      // escaping flux at the upstream FEB
      if (moving && injf && x < feb_up && x_old >= feb_up) {
        s_en += (double)(e_add * g0u0);
        s_px += (double)(-px_sk * w_lane * g0u0);
      }

      // ---- downstream logic ------------------------------------------
      bool jret_new = false;
      float v_fac;
      if (is_el && ptot < pe_crit)
        v_fac = (pe_crit * c * gden) * pe_crit / (m * gamma_e_crit * u2);
      else
        v_fac = (ptot * c * gden) * ptot / (m * gamma_pf * u2);
      const float l_diff = eta3 * v_fac;

      const bool esc_feb_dw = moving && (feb_dw > 0.0) && (x > feb_dw);
      const bool esc_far = moving && !esc_feb_dw && (x > 1.1 * prp) &&
                           (x > (double)(6.91f * l_diff));
      const bool do_ret = moving && !esc_feb_dw && !esc_far;

      const bool past_end = do_ret && (x >= x_stop);
      const bool just_end = past_end && (x_old < x_stop);
      if (just_end) {
        const float r_g2 = ptot * c * inv_q / bmag2;
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
        } else {
          // analytic return (the do_retro=false branch)
          const float span = u2 + vt;
          const float vmu = u2 - span * sqrtf(u[3]);
          const float mu = clampf(vmu / fmaxp(vt, tiny30), -1.0f, 1.0f);
          const float pb_ret = ptot * mu;
          pb = pb_ret;
          pperp = sqrtf(fmaxp(ptot * ptot - pb_ret * pb_ret, 0.0f));
          phi = u[4] * two_pi;
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

      // helix cap
      nsteps = nsteps + 1;
      if (status == ACTIVE && nsteps >= max_helix) {
        status = FINISHED;
        reason = R_DOWNSTREAM;
      }

      flags = (dwf ? FL_DW : 0) | (injf ? FL_INJ : 0) |
              (retro ? FL_RETRO : 0) | (jret_new ? FL_JRET : 0);
    }

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
    live = status == ACTIVE ? 1 : 0;
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
  live = warp_sum_i(live);
  if ((threadIdx.x & 31) == 0) {
    if (s_px != 0.0) atomicAdd(&esc_g[0], s_px);
    if (s_en != 0.0) atomicAdd(&esc_g[1], s_en);
    if (s_p != 0.0) atomicAdd(&esc_g[2], s_p);
    if (s_ke != 0.0) atomicAdd(&esc_g[3], s_ke);
    if (live) atomicAdd(n_active_g, live);
  }
}

extern "C" int mcs_mega_launch(
    float* w, float* pb, float* pperp, float* phi, float* uxp, float* xnp,
    float* tstep, double* x, double* prp, double* acct, int* status,
    int* reason, int* nsteps, int* flags, const int* key0, const int* key1,
    const double* xg, const float* zf, const float* sf, const double* sd,
    const int* si, float* psd, double* flux, double* esc, int* n_active,
    int n, int n_steps, int max_helix, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int grid = (n + BLOCK - 1) / BLOCK;
  mega_step_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      w, pb, pperp, phi, uxp, xnp, tstep, x, prp, acct, status, reason,
      nsteps, flags, key0, key1, xg, zf, sf, sd, si, psd, flux, esc,
      n_active, n, n_steps, max_helix);
  return (int)cudaGetLastError();
}
