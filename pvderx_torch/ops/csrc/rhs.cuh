// The PV-DER right-hand side on one thread, shared by the window kernels.
//
// A device restatement of pvderx_torch/physics/rhs_core.py's hoisted path,
// split as rhs_core splits it:
//   - pcc_voltage: the PCC voltage from the feeder (grid Thevenin source and
//     local load, `Feeder`) and the injected current;
//   - rhs_given_v: algebra_given_v + rhs_from_algebra of one DER (`Unit`)
//     at a given PCC voltage.
// The single-DER kernel (window.cu) calls the pair with the DER's own
// injection; the fleet kernel (fleet_window.cu) calls pcc_voltage with the
// mean injection of the units on the feeder, then rhs_given_v per unit.
//
// Arithmetic follows rhs_core operation by operation, in the same order.
// nvcc contracts a*b+c into FMAs, so results are not bitwise equal to the
// plain torch version; the Kahan steps contain no products, so contraction
// cannot break them. No fast-math: full-range sinf/cosf/expf/powf are
// required (the grid angle reaches ~100 rad in an episode).
#pragma once

#include <cuda_runtime.h>

namespace pvderx {

// DERParams fields, in pvderx_torch.ops.window.P_FIELDS order
enum PField {
  RF, LF, RG, XG, KV, W_BASE, S_RATED, V_BASE, I_BASE, VDC_BASE, TAU_DC,
  VDC_FLOOR, NP_PAR, ISC_REF, KI_T, IRS, GAMMA, W_F, KP_GCC, KI_GCC, KP_DC,
  KI_DC, KP_Q, KI_Q, KP_PLL, KI_PLL, M_MAX, I_MAX, CONST_VDC, N_PFIELDS
};
// Exog fields, in pvderx_torch.ops.window.U_FIELDS order
enum UField {
  S_IRR, T_CELL, V_G, PHI_G, DW_G, T_G, V_G2, PHI_G2, G_LOAD, B_LOAD,
  VDC_REF, Q_REF, CONN, CES, P_REF, N_UFIELDS
};

constexpr float TWO_PI_3 = static_cast<float>(2.0943951023931953);
constexpr float SAT_EXP = -1.0f / 16.0f;   // -1/SAT_K
constexpr float AW_KAPPA = 40.0f;
constexpr float VDC_PIN_RATE = 1000.0f;
constexpr float T_REF = 298.15f;

// Window invariants of a feeder: grid source, grid/load admittance and the
// negative-sequence source phasor (rhs_core.Prep's y_g, inv_y_tot, v2).
template <int N>
struct Feeder {
  float v_g, phi_g, wdw, t_g;
  float yg_re, yg_im, iyt_re, iyt_im;
  float v2_re[N], v2_im[N];
};

// Window invariants of one DER: its params, its exog and its part of Prep.
template <int N>
struct Unit {
  // params and products of params that every RHS evaluation uses
  float rf, wb, wb_lf, kv, vdc_floor, vdc_base, np_par, irs, tau_dc;
  float w_f, kp_gcc, kp_dc, ki_dc, kp_q, ki_q, kp_pll, ki_pll;
  float c, one_m_c, c_pin;
  // exog
  float vdc_ref, q_ref, conn, p_ref, dis;
  // Prep (rhs_core.prep_invariants)
  float en, ki_gcc_en, iph, inv_m_max, inv_i_max, g_over_t, inv_s;
  float ak_re[N], ak_im[N];   // phase rotators (3-phase only)
};

// P(field) / U(field) read one DER's params / exog.
template <int N, class PF, class UF>
__device__ __forceinline__ void load_unit(Unit<N>& w, PF P, UF U) {
  w.rf = P(RF);
  w.wb = P(W_BASE);
  w.wb_lf = w.wb / P(LF);
  w.kv = P(KV);
  w.vdc_floor = P(VDC_FLOOR);
  w.vdc_base = P(VDC_BASE);
  w.np_par = P(NP_PAR);
  w.irs = P(IRS);
  w.tau_dc = P(TAU_DC);
  w.w_f = P(W_F);
  w.kp_gcc = P(KP_GCC);
  w.kp_dc = P(KP_DC);
  w.ki_dc = P(KI_DC);
  w.kp_q = P(KP_Q);
  w.ki_q = P(KI_Q);
  w.kp_pll = P(KP_PLL);
  w.ki_pll = P(KI_PLL);
  w.c = P(CONST_VDC);
  w.one_m_c = 1.0f - w.c;
  w.c_pin = w.c * VDC_PIN_RATE;

  w.vdc_ref = U(VDC_REF);
  w.q_ref = U(Q_REF);
  w.conn = U(CONN);
  w.p_ref = U(P_REF);
  w.dis = -(1.0f - w.conn) * w.wb;

  w.en = w.conn * (1.0f - U(CES));
  w.ki_gcc_en = P(KI_GCC) * w.en;
  const float t_cell = U(T_CELL);
  w.iph = (P(ISC_REF) + P(KI_T) * (t_cell - T_REF)) * (U(S_IRR) / 1000.0f);
  w.inv_m_max = 1.0f / P(M_MAX);
  w.inv_i_max = 1.0f / P(I_MAX);
  w.g_over_t = P(GAMMA) / t_cell;
  w.inv_s = 1.0f / P(S_RATED);
  if (N == 3) {
    const float ang[3] = {0.0f, -TWO_PI_3, TWO_PI_3};
#pragma unroll
    for (int k = 0; k < N; ++k) sincosf(ang[k], &w.ak_im[k], &w.ak_re[k]);
  }
}

// P(field) / U(field) read the params / exog that carry the feeder's fields.
template <int N, class PF, class UF>
__device__ __forceinline__ void load_feeder(Feeder<N>& f, const float (&ak_re)[N],
                                            const float (&ak_im)[N], PF P, UF U) {
  f.v_g = U(V_G);
  f.phi_g = U(PHI_G);
  f.wdw = P(W_BASE) * U(DW_G);
  f.t_g = U(T_G);
  const float rg = P(RG), xg = P(XG);
  const float dg = rg * rg + xg * xg;
  f.yg_re = rg / dg;
  f.yg_im = -xg / dg;
  const float yt_re = f.yg_re + U(G_LOAD), yt_im = f.yg_im + U(B_LOAD);
  const float dt_ = yt_re * yt_re + yt_im * yt_im;
  f.iyt_re = yt_re / dt_;
  f.iyt_im = -yt_im / dt_;
  if (N == 3) {
    float e2_im, e2_re;
    sincosf(U(PHI_G2), &e2_im, &e2_re);
    const float v_g2 = U(V_G2);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      f.v2_re[k] = (e2_re * ak_re[k] - e2_im * (-ak_im[k])) * v_g2;
      f.v2_im[k] = (e2_re * (-ak_im[k]) + e2_im * ak_re[k]) * v_g2;
    }
  }
}

// rhs_core.soft_limit_scale with the hoisted reciprocal: r^16 by squaring
__device__ __forceinline__ float soft_limit_scale(float mag, float inv_lim) {
  float r = fminf(mag * inv_lim, 8.0f);
  float r2 = r * r;
  float r4 = r2 * r2;
  float r8 = r4 * r4;
  return powf(1.0f + r8 * r8, SAT_EXP);
}

// rhs_core.aw_gate with the hoisted reciprocal
__device__ __forceinline__ float aw_gate(float mag, float inv_lim) {
  float r = mag * inv_lim;
  float z = AW_KAPPA * (1.0f - r);
  return 1.0f / (1.0f + expf(-fminf(z, 40.0f)));
}

// rhs_core.grid_rot: e^{j(phi_g + w_base*dw_g*(t - t_g))}
template <int N>
__device__ __forceinline__ void grid_rot(float t, const Feeder<N>& f,
                                         float& re, float& im) {
  float phi = f.phi_g + f.wdw * (t - f.t_g);
  sincosf(phi, &im, &re);
}

// rhs_core.pcc_voltage(i_inj, ...) with the grid phasor `rot` given
template <int N>
__device__ __forceinline__ void pcc_voltage(
    const float (&ii_re)[N], const float (&ii_im)[N], float rot_re,
    float rot_im, const Feeder<N>& f, const float (&ak_re)[N],
    const float (&ak_im)[N], float (&v_re)[N], float (&v_im)[N]) {
  const float vgp_re = rot_re * f.v_g, vgp_im = rot_im * f.v_g;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float vg_re, vg_im;
    if (N == 1) {
      vg_re = vgp_re;
      vg_im = vgp_im;
    } else {
      float a_re = vgp_re * ak_re[k] - vgp_im * ak_im[k];
      float a_im = vgp_re * ak_im[k] + vgp_im * ak_re[k];
      float b_re = rot_re * f.v2_re[k] - rot_im * f.v2_im[k];
      float b_im = rot_re * f.v2_im[k] + rot_im * f.v2_re[k];
      vg_re = a_re + b_re;
      vg_im = a_im + b_im;
    }
    float s_re = (vg_re * f.yg_re - vg_im * f.yg_im) + ii_re[k];
    float s_im = (vg_re * f.yg_im + vg_im * f.yg_re) + ii_im[k];
    v_re[k] = s_re * f.iyt_re - s_im * f.iyt_im;
    v_im[k] = s_re * f.iyt_im + s_im * f.iyt_re;
  }
}

// rhs_core.rhs_given_v: algebra_given_v and rhs_from_algebra of one DER at
// the PCC voltage v.
template <int N>
__device__ __forceinline__ void rhs_given_v(const float (&y)[6 * N + 5],
                                            const float (&v_re)[N],
                                            const float (&v_im)[N],
                                            const Unit<N>& w,
                                            float (&dy)[6 * N + 5]) {
  const float vdc = y[6 * N + 0];
  const float xdc = y[6 * N + 1];
  const float xq = y[6 * N + 2];
  const float xpll = y[6 * N + 3];
  const float theta = y[6 * N + 4];

  float ii_re[N], ii_im[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    ii_re[k] = y[k] * w.conn;
    ii_im[k] = y[N + k] * w.conn;
  }

  float vpos_re, vpos_im;
  if (N == 1) {
    vpos_re = v_re[0];
    vpos_im = v_im[0];
  } else {
    float sr = 0.0f, si = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      sr += v_re[k] * w.ak_re[k] - v_im[k] * (-w.ak_im[k]);
      si += v_re[k] * (-w.ak_im[k]) + v_im[k] * w.ak_re[k];
    }
    vpos_re = sr / N;
    vpos_im = si / N;
  }

  const float vdc_pos = fmaxf(vdc, w.vdc_floor);
  const float kvv = w.kv * vdc_pos;
  float vt_re[N], vt_im[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float mr = y[4 * N + k] * w.kp_gcc + y[2 * N + k];
    float mi = y[5 * N + k] * w.kp_gcc + y[3 * N + k];
    float m_mag = sqrtf(mr * mr + mi * mi + 1e-30f);
    float s = soft_limit_scale(m_mag, w.inv_m_max);
    vt_re[k] = (mr * s) * kvv;
    vt_im[k] = (mi * s) * kvv;
  }

  float sth, cth;
  sincosf(theta, &sth, &cth);
  const float v_q = vpos_re * (-sth) + vpos_im * cth;

  float p_inv = 0.0f, p_pcc = 0.0f, q_pcc = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    p_inv += vt_re[k] * y[k] - vt_im[k] * (-y[N + k]);
    p_pcc += v_re[k] * ii_re[k] - v_im[k] * (-ii_im[k]);
    q_pcc += v_re[k] * (-ii_im[k]) + v_im[k] * ii_re[k];
  }
  if (N != 1) {
    p_inv /= N;
    p_pcc /= N;
    q_pcc /= N;
  }

  // pv_power with the hoisted iph, gamma/T and 1/S
  const float vdc_v = vdc * w.vdc_base;
  const float ex = w.g_over_t * vdc_v;
  float i_arr = w.np_par * (w.iph - w.irs * (expf(ex) - 1.0f));
  i_arr = fmaxf(i_arr, 0.0f);
  const float p_pv = (i_arr * vdc_v) * w.inv_s;

  const float e_dc = w.one_m_c * (vdc - w.vdc_ref) + w.c * (w.p_ref - p_pcc);
  const float id_raw = w.kp_dc * e_dc + xdc;
  const float e_q = w.q_ref - q_pcc;
  const float iq_raw = -(w.kp_q * e_q + xq);
  const float mag = sqrtf(id_raw * id_raw + iq_raw * iq_raw + 1e-30f);
  const float s_lim = soft_limit_scale(mag, w.inv_i_max);
  const float id_ref = id_raw * s_lim;
  const float iq_ref = iq_raw * s_lim;
  const float idq_re = id_ref * cth - iq_ref * sth;
  const float idq_im = id_ref * sth + iq_ref * cth;
  const float aw = w.en * aw_gate(mag, w.inv_i_max);

  // --- rhs_from_algebra ----------------------------------------------------
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float i_re = y[k], i_im = y[N + k];
    const float uf_re = y[4 * N + k], uf_im = y[5 * N + k];
    float iref_re, iref_im;
    if (N == 1) {
      iref_re = idq_re * w.en;
      iref_im = idq_im * w.en;
    } else {
      iref_re = (idq_re * w.ak_re[k] - idq_im * w.ak_im[k]) * w.en;
      iref_im = (idq_re * w.ak_im[k] + idq_im * w.ak_re[k]) * w.en;
    }
    float dc_re = ((vt_re[k] - v_re[k]) - i_re * w.rf) * w.wb_lf - (-i_im) * w.wb;
    float dc_im = ((vt_im[k] - v_im[k]) - i_im * w.rf) * w.wb_lf - i_re * w.wb;
    dy[k] = dc_re * w.conn + i_re * w.dis;
    dy[N + k] = dc_im * w.conn + i_im * w.dis;
    dy[2 * N + k] = uf_re * w.ki_gcc_en;
    dy[3 * N + k] = uf_im * w.ki_gcc_en;
    dy[4 * N + k] = ((iref_re - i_re) - uf_re) * w.w_f;
    dy[5 * N + k] = ((iref_im - i_im) - uf_im) * w.w_f;
  }
  dy[6 * N + 0] = (w.one_m_c * (p_pv - w.conn * p_inv)) / (w.tau_dc * vdc_pos)
                  + w.c_pin * (w.vdc_ref - vdc);
  dy[6 * N + 1] = (w.ki_dc * e_dc) * aw;
  dy[6 * N + 2] = (w.ki_q * e_q) * aw;
  dy[6 * N + 3] = w.ki_pll * v_q;
  dy[6 * N + 4] = w.wb * (w.kp_pll * v_q + xpll);
}

// One control window of n_sub Kahan-compensated RK4 substeps of
// rhs(ys, rot_re, rot_im, dy). The grid phasor is computed twice per substep
// (k2 and k3 share the half-point; k4's is the next substep's k1), as
// rhs_core.grid_rot is shared in the plain version. Substep times are
// t0 + f32(s)*h, with h, h/2 and h/6 rounded once on the host.
template <int N, class Rhs>
__device__ __forceinline__ void rk4_window(float (&y)[6 * N + 5], float t0,
                                           const Feeder<N>& f, int n_sub,
                                           float h, float hh, float h6,
                                           Rhs rhs) {
  constexpr int NS = 6 * N + 5;
  float c[NS], acc[NS], ys[NS], kv[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) c[j] = 0.0f;
  float r1_re, r1_im;
  grid_rot(t0, f, r1_re, r1_im);

  for (int s = 0; s < n_sub; ++s) {
    const float t = t0 + static_cast<float>(s) * h;
    float rh_re, rh_im, r4_re, r4_im;
    grid_rot(t + hh, f, rh_re, rh_im);
    grid_rot(t + h, f, r4_re, r4_im);
    rhs(y, r1_re, r1_im, kv);                            // k1
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      acc[j] = kv[j];
      ys[j] = y[j] + hh * kv[j];
    }
    rhs(ys, rh_re, rh_im, kv);                           // k2
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      acc[j] = acc[j] + 2.0f * kv[j];
      ys[j] = y[j] + hh * kv[j];
    }
    rhs(ys, rh_re, rh_im, kv);                           // k3
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      acc[j] = acc[j] + 2.0f * kv[j];
      ys[j] = y[j] + h * kv[j];
    }
    rhs(ys, r4_re, r4_im, kv);                           // k4
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      // Kahan step, order fixed: d = delta - c; s = y + d; c = (s - y) - d
      const float d = h6 * (acc[j] + kv[j]) - c[j];
      const float sj = y[j] + d;
      c[j] = (sj - y[j]) - d;
      y[j] = sj;
    }
    r1_re = r4_re;
    r1_im = r4_im;
  }
}

}  // namespace pvderx
