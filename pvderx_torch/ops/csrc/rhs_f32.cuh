// The float32 RHS of K1 and K2 (window.cu, fleet_window.cu) over
// window-folded invariants.
//
// rhs.cuh's pieces, run at T = float, redo in every RHS evaluation work
// that depends only on the window's constants: the three-phase rotators
// from a run-time sincos, their products by (1, 0) at phase 0, five IEEE
// divides by N for the phase means, the PCC voltage as three complex
// products a phase, and products of params inside the rates. nvcc may not
// hoist or reassociate float arithmetic without fast-math, so it stays.
// Here a prologue (`fold_window`, once a window) folds all of it into
// `Folded`, and the RHS (`pcc_voltage`, `rhs_given_v` over `Folded`)
// reads only folded constants:
//   - the rotators are constants (`ak_re`, `ak_im`), and phase 0 takes
//     none of their products;
//   - the 1/N of the positive sequence is in the PLL gains, of p_inv in
//     `kinv`, of p_pcc in `cn`; q_pcc's is a product by the constant 1/N;
//   - the PCC voltage is rot*cg_k + ii_k*iyt, cg_k = (v_g*a_k + v2_k) *
//     y_g / y_tot;
//   - a phase's current rate is ra*(vt - v) + rb*i + rx*(j i), its filter
//     rate iw_k - w_f*(i + uf) with en*w_f in the current reference's
//     scale, and the terminal voltage m*(s*kvv);
//   - the PV current, the anti-windup exponent, the loop integrators (en
//     in ki_dc and ki_q) and the DC link (one_m_c/tau_dc, np, vdc_base
//     and 1/S in `kpv` and `kinv`) carry no product of constants.
// The transcendentals, the divide by vdc_pos and the square roots are
// rhs.cuh's full-accuracy float functions; the RK4 stages and the Kahan
// combine are rhs.cuh's rk4_window. The fold reassociates float32
// arithmetic, which the f32 tier's tolerance allows and the df32 and
// float64 kernels' bitwise contracts do not: window_df.cu and native.cu
// keep rhs.cuh's pieces. K2 calls the same pieces with the mean injection
// in place of the DER's own, so at M = 1 it equals K1 bit for bit.
#pragma once

#include "rhs.cuh"

namespace pvderx {

// The three-phase rotators e^{j ang_k}, ang = (0, -2pi/3, 2pi/3): the bits
// the card's sincosf gives for lit<float>(-+TWO_PI_3), i.e. the values
// load_unit computes at T = float.
constexpr float AK_COS = -0x1.000002p-1f;   // -0.50000006
constexpr float AK_SIN = 0x1.bb67aep-1f;    // 0.8660254
__host__ __device__ constexpr float ak_re(int k) {
  return k == 0 ? 1.0f : AK_COS;
}
__host__ __device__ constexpr float ak_im(int k) {
  return k == 0 ? 0.0f : k == 1 ? -AK_SIN : AK_SIN;
}

// The window constants the folded RHS reads.
template <int N>
struct Folded {
  // the PCC voltage: v_k = rot * cg_k + ii_k * iyt
  float iyt_re, iyt_im, cg_re[N], cg_im[N];
  // the injection ii = conn * i, and a phase's current rate
  float conn, ra, rb, rx;
  // the GCC and the modulation
  float kp_gcc, ki_gcc_en, w_f, enwf, inv_m_max, kv, vdc_floor;
  // the current limiter and the anti-windup exponent's slope
  float inv_i_max, aw_k;
  // the PV array and the DC link
  float gvb, irs, a0, kpv, kinv, c_pin;
  // the DC-voltage and reactive loops
  float vdc_ref, one_m_c, cp, cn, kp_dc, ki_dc_en, q_ref, kp_q, ki_q_en;
  // the PLL
  float kp_pll, ki_pll, wb;
};

// The feeder's fields with the constant rotators (load_feeder).
template <int N, class PF, class UF>
__device__ __forceinline__ void load_feeder_f32(Feeder<float, N>& f, PF P,
                                                UF U) {
  float ar[N], ai[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    ar[k] = ak_re(k);
    ai[k] = ak_im(k);
  }
  load_feeder(f, ar, ai, P, U);
}

// The prologue: a DER's `Unit` and its feeder's `Feeder` (load_unit,
// load_feeder_f32) folded, once a window.
template <int N>
__device__ __forceinline__ void fold_window(Folded<N>& z,
                                            const Unit<float, N>& w,
                                            const Feeder<float, N>& f) {
  z.iyt_re = f.iyt_re;
  z.iyt_im = f.iyt_im;
  const float ygi_re = cmul(Re{}, f.yg_re, f.yg_im, f.iyt_re, f.iyt_im);
  const float ygi_im = cmul(Im{}, f.yg_re, f.yg_im, f.iyt_re, f.iyt_im);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float g_re = f.v_g, g_im = 0.0f;
    if (N != 1) {
      g_re = f.v_g * ak_re(k) + f.v2_re[k];
      g_im = f.v_g * ak_im(k) + f.v2_im[k];
    }
    z.cg_re[k] = cmul(Re{}, g_re, g_im, ygi_re, ygi_im);
    z.cg_im[k] = cmul(Im{}, g_re, g_im, ygi_re, ygi_im);
  }
  z.conn = w.conn;
  z.ra = w.conn * w.wb_lf;
  z.rb = w.dis - z.ra * w.rf;
  z.rx = w.conn * w.wb;
  z.kp_gcc = w.kp_gcc;
  z.ki_gcc_en = w.ki_gcc_en;
  z.w_f = w.w_f;
  z.enwf = w.en * w.w_f;
  z.inv_m_max = w.inv_m_max;
  z.kv = w.kv;
  z.vdc_floor = w.vdc_floor;
  z.inv_i_max = w.inv_i_max;
  z.aw_k = lit<float>(AW_KAPPA) * w.inv_i_max;
  z.gvb = w.g_over_t * w.vdc_base;
  z.irs = w.irs;
  z.a0 = w.iph + w.irs;
  const float k_dc = w.one_m_c / w.tau_dc;
  z.kpv = k_dc * ((w.np_par * w.vdc_base) * w.inv_s);
  z.kinv = k_dc * w.conn / lit<float>(N);
  z.c_pin = w.c_pin;
  z.vdc_ref = w.vdc_ref;
  z.one_m_c = w.one_m_c;
  z.cp = w.c * w.p_ref;
  z.cn = w.c / lit<float>(N);
  z.kp_dc = w.kp_dc;
  z.ki_dc_en = w.ki_dc * w.en;
  z.q_ref = w.q_ref;
  z.kp_q = w.kp_q;
  z.ki_q_en = w.ki_q * w.en;
  z.kp_pll = w.kp_pll / lit<float>(N);
  z.ki_pll = w.ki_pll / lit<float>(N);
  z.wb = w.wb;
}

// rhs_core.pcc_voltage(i_inj, ...) with the grid phasor `rot` given
template <int N>
__device__ __forceinline__ void pcc_voltage(const float (&ii_re)[N],
                                            const float (&ii_im)[N],
                                            float rot_re, float rot_im,
                                            const Folded<N>& z,
                                            float (&v_re)[N],
                                            float (&v_im)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v_re[k] = rot_re * z.cg_re[k] - rot_im * z.cg_im[k]
              + ii_re[k] * z.iyt_re - ii_im[k] * z.iyt_im;
    v_im[k] = rot_re * z.cg_im[k] + rot_im * z.cg_re[k]
              + ii_re[k] * z.iyt_im + ii_im[k] * z.iyt_re;
  }
}

// rhs_core.rhs_given_v: rhs.cuh's rhs_given_v over the folded constants
template <int N>
__device__ __forceinline__ void rhs_given_v(const float (&y)[6 * N + 5],
                                            const float (&v_re)[N],
                                            const float (&v_im)[N],
                                            const Folded<N>& z,
                                            float (&dy)[6 * N + 5]) {
  const float vdc = y[6 * N + 0];
  const float xdc = y[6 * N + 1];
  const float xq = y[6 * N + 2];
  const float xpll = y[6 * N + 3];
  const float theta = y[6 * N + 4];

  float ii_re[N], ii_im[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    ii_re[k] = y[k] * z.conn;
    ii_im[k] = y[N + k] * z.conn;
  }

  // N times the positive sequence (the PLL gains carry the 1/N)
  float vp_re = v_re[0], vp_im = v_im[0];
#pragma unroll
  for (int k = 1; k < N; ++k) {
    vp_re = vp_re + cmul(Re{}, v_re[k], v_im[k], ak_re(k), -ak_im(k));
    vp_im = vp_im + cmul(Im{}, v_re[k], v_im[k], ak_re(k), -ak_im(k));
  }

  const float vdc_pos = max_t(vdc, z.vdc_floor);
  const float kvv = z.kv * vdc_pos;
  float vt_re[N], vt_im[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float mr = y[4 * N + k] * z.kp_gcc + y[2 * N + k];
    const float mi = y[5 * N + k] * z.kp_gcc + y[3 * N + k];
    float m_mag;
    const float sk = limit(mr, mi, z.inv_m_max, m_mag) * kvv;
    vt_re[k] = mr * sk;
    vt_im[k] = mi * sk;
  }

  float sth, cth;
  sincos_t(theta, &sth, &cth);
  const float v_q = pll_error(vp_re, vp_im, sth, cth);

  // sums over phases (kinv and cn carry p_inv's and p_pcc's 1/N)
  float p_inv = 0.0f, p_pcc = 0.0f, q_pcc = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    p_inv = p_inv + power_term(Re{}, vt_re[k], vt_im[k], y[k], y[N + k]);
    p_pcc = p_pcc + power_term(Re{}, v_re[k], v_im[k], ii_re[k], ii_im[k]);
    q_pcc = q_pcc + power_term(Im{}, v_re[k], v_im[k], ii_re[k], ii_im[k]);
  }
  if (N != 1) q_pcc = q_pcc * (1.0f / N);

  // the PV array's current over np (np is in kpv)
  const float i_pv = max_t(z.a0 - z.irs * exp_t(z.gvb * vdc), 0.0f);

  const float e_dc = z.one_m_c * (vdc - z.vdc_ref) + (z.cp - z.cn * p_pcc);
  const float e_q = z.q_ref - q_pcc;
  const float id_raw = z.kp_dc * e_dc + xdc;
  const float iq_raw = -(z.kp_q * e_q + xq);
  float mag;
  const float sc = limit(id_raw, iq_raw, z.inv_i_max, mag) * z.enwf;
  // w_f * en * the dq current reference, rotated to the grid frame
  const float iw_re = cmul(Re{}, id_raw, iq_raw, cth, sth) * sc;
  const float iw_im = cmul(Im{}, id_raw, iq_raw, cth, sth) * sc;
  const float aw = lit<float>(1.0) / aw_denominator(exp_t(
      -min_t(lit<float>(AW_KAPPA) - z.aw_k * mag, lit<float>(40.0))));

  // --- rhs_from_algebra ----------------------------------------------------
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float i_re = y[k], i_im = y[N + k];
    const float uf_re = y[4 * N + k], uf_im = y[5 * N + k];
    float iref_re = iw_re, iref_im = iw_im;
    if (k != 0) {
      iref_re = cmul(Re{}, iw_re, iw_im, ak_re(k), ak_im(k));
      iref_im = cmul(Im{}, iw_re, iw_im, ak_re(k), ak_im(k));
    }
    dy[k] = z.ra * (vt_re[k] - v_re[k]) + (z.rb * i_re + z.rx * i_im);
    dy[N + k] = z.ra * (vt_im[k] - v_im[k]) + (z.rb * i_im - z.rx * i_re);
    dy[2 * N + k] = uf_re * z.ki_gcc_en;
    dy[3 * N + k] = uf_im * z.ki_gcc_en;
    dy[4 * N + k] = iref_re - z.w_f * (i_re + uf_re);
    dy[5 * N + k] = iref_im - z.w_f * (i_im + uf_im);
  }
  dy[6 * N + 0] = (z.kpv * (i_pv * vdc) - z.kinv * p_inv) / vdc_pos
                  + z.c_pin * (z.vdc_ref - vdc);
  dy[6 * N + 1] = (z.ki_dc_en * e_dc) * aw;
  dy[6 * N + 2] = (z.ki_q_en * e_q) * aw;
  dy[6 * N + 3] = z.ki_pll * v_q;
  dy[6 * N + 4] = z.wb * (z.kp_pll * v_q + xpll);
}

}  // namespace pvderx
