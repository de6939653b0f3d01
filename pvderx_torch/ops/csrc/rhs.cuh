// The PV-DER right-hand side on one thread, shared by the window kernels.
//
// A device restatement of pvderx_torch/physics/rhs_core.py's hoisted path,
// written once over the scalar type T: float for the float32 kernels
// (window.cu, fleet_window.cu), df (df.cuh, double-float32) for the df32
// kernel (window_df.cu), double for the float64 engine (native.cu) -- one
// set of equations, as rhs_core runs on one namespace per precision.
// Literals go through lit<T>(double); the transcendentals (sqrt_t, exp_t,
// sincos_t, pow_sat, max_t, min_t) are overloaded per type. Split as
// rhs_core splits it:
//   - pcc_voltage: the PCC voltage from the feeder (grid Thevenin source and
//     local load, `Feeder`) and the injected current;
//   - rhs_given_v: algebra_given_v + rhs_from_algebra of one DER (`Unit`)
//     at a given PCC voltage.
// The single-DER kernel (window.cu) calls the pair with the DER's own
// injection; the fleet kernel (fleet_window.cu) calls pcc_voltage with the
// mean injection of the units on the feeder, then rhs_given_v per unit.
// Both are written as calls to small pieces (one equation of rhs_core
// each), most of them one component of a complex quantity under a role
// (Re, Im, or a run-time Lane): the df32 kernel's two-lane team
// (window_df.cu) calls the same pieces, each lane for its own component.
//
// Arithmetic follows rhs_core operation by operation, in the same order.
// In float, nvcc contracts a*b+c into FMAs, so results are not bitwise equal
// to the plain torch version; the Kahan steps contain no products, so
// contraction cannot break them (df arithmetic uses rounded intrinsics and
// is never contracted). No fast-math: full-range sinf/cosf/expf/powf are
// required (the grid angle reaches ~100 rad in an episode).
#pragma once

#include <cuda_runtime.h>

#include "df.cuh"

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

constexpr double TWO_PI_3 = 2.0943951023931953;   // rhs_core.TWO_PI_3
constexpr double AW_KAPPA = 40.0;
constexpr double VDC_PIN_RATE = 1000.0;
constexpr double T_REF = 298.15;

// The float32 transcendentals; df's are in df.cuh.
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ void sincos_t(float x, float* s, float* c) {
  sincosf(x, s, c);
}
// x^(-1/16), x in [1, 1 + 8^16] (the soft limiter's 1 + r^16), as
// 2^(-log2(x)/16): the scaling by 1/16 is exact, log2f's 1 ulp is at most
// 2^-22 absolute after it (log2(x) <= 48), ~1.4 ulp of the result, and
// exp2f adds its 2 ulp: within ~3.4 ulp, inside powf's documented 4 ulp.
// Two special-function operations in series where powf had a ~50
// instruction sequence; K1's limiter chain is latency-bound (PERF.md).
__device__ __forceinline__ float pow_sat(float x) {
  return exp2f(log2f(x) * -0.0625f);
}
__device__ __forceinline__ float max_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float min_t(float a, float b) { return fminf(a, b); }

// The float64 transcendentals: the full-range double library functions.
// pow_sat is pow(x, -1/16) itself, as pvderx_native.cpp computes it (the
// exp2/log2 form above would cost the float64 engine its 1e-12 agreement).
template <>
__host__ __device__ constexpr double lit<double>(double x) { return x; }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ void sincos_t(double x, double* s, double* c) {
  sincos(x, s, c);
}
__device__ __forceinline__ double pow_sat(double x) { return pow(x, -0.0625); }
__device__ __forceinline__ double max_t(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ double min_t(double a, double b) { return fmin(a, b); }

// Window invariants of a feeder: grid source, grid/load admittance and the
// negative-sequence source phasor (rhs_core.Prep's y_g, inv_y_tot, v2).
template <class T, int N>
struct Feeder {
  T v_g, phi_g, wdw, t_g;
  T yg_re, yg_im, iyt_re, iyt_im;
  T v2_re[N], v2_im[N];
};

// Window invariants of one DER: its params, its exog and its part of Prep.
template <class T, int N>
struct Unit {
  // params and products of params that every RHS evaluation uses
  T rf, wb, wb_lf, kv, vdc_floor, vdc_base, np_par, irs, tau_dc;
  T w_f, kp_gcc, kp_dc, ki_dc, kp_q, ki_q, kp_pll, ki_pll;
  T c, one_m_c, c_pin;
  // exog
  T vdc_ref, q_ref, conn, p_ref, dis;
  // Prep (rhs_core.prep_invariants)
  T en, ki_gcc_en, iph, inv_m_max, inv_i_max, g_over_t, inv_s;
  T ak_re[N], ak_im[N];   // phase rotators (3-phase only)
};

// P(field) / U(field) read one DER's params / exog (float32, exact in T;
// double in the float64 engine).
template <class T, int N, class PF, class UF>
__device__ __forceinline__ void load_unit(Unit<T, N>& w, PF P, UF U) {
  w.rf = T(P(RF));
  w.wb = T(P(W_BASE));
  w.wb_lf = w.wb / T(P(LF));
  w.kv = T(P(KV));
  w.vdc_floor = T(P(VDC_FLOOR));
  w.vdc_base = T(P(VDC_BASE));
  w.np_par = T(P(NP_PAR));
  w.irs = T(P(IRS));
  w.tau_dc = T(P(TAU_DC));
  w.w_f = T(P(W_F));
  w.kp_gcc = T(P(KP_GCC));
  w.kp_dc = T(P(KP_DC));
  w.ki_dc = T(P(KI_DC));
  w.kp_q = T(P(KP_Q));
  w.ki_q = T(P(KI_Q));
  w.kp_pll = T(P(KP_PLL));
  w.ki_pll = T(P(KI_PLL));
  w.c = T(P(CONST_VDC));
  w.one_m_c = lit<T>(1.0) - w.c;
  w.c_pin = w.c * lit<T>(VDC_PIN_RATE);

  w.vdc_ref = T(U(VDC_REF));
  w.q_ref = T(U(Q_REF));
  w.conn = T(U(CONN));
  w.p_ref = T(U(P_REF));
  w.dis = -(lit<T>(1.0) - w.conn) * w.wb;

  w.en = w.conn * (lit<T>(1.0) - T(U(CES)));
  w.ki_gcc_en = T(P(KI_GCC)) * w.en;
  const T t_cell = T(U(T_CELL));
  w.iph = (T(P(ISC_REF)) + T(P(KI_T)) * (t_cell - lit<T>(T_REF)))
          * (T(U(S_IRR)) / lit<T>(1000.0));
  w.inv_m_max = lit<T>(1.0) / T(P(M_MAX));
  w.inv_i_max = lit<T>(1.0) / T(P(I_MAX));
  w.g_over_t = T(P(GAMMA)) / t_cell;
  w.inv_s = lit<T>(1.0) / T(P(S_RATED));
  if (N == 3) {
    const T ang[3] = {lit<T>(0.0), -lit<T>(TWO_PI_3), lit<T>(TWO_PI_3)};
#pragma unroll
    for (int k = 0; k < N; ++k) sincos_t(ang[k], &w.ak_im[k], &w.ak_re[k]);
  }
}

// P(field) / U(field) read the params / exog that carry the feeder's fields.
template <class T, int N, class PF, class UF>
__device__ __forceinline__ void load_feeder(Feeder<T, N>& f, const T (&ak_re)[N],
                                            const T (&ak_im)[N], PF P, UF U) {
  f.v_g = T(U(V_G));
  f.phi_g = T(U(PHI_G));
  f.wdw = T(P(W_BASE)) * T(U(DW_G));
  f.t_g = T(U(T_G));
  const T rg = T(P(RG)), xg = T(P(XG));
  const T dg = rg * rg + xg * xg;
  f.yg_re = rg / dg;
  f.yg_im = -xg / dg;
  const T yt_re = f.yg_re + T(U(G_LOAD)), yt_im = f.yg_im + T(U(B_LOAD));
  const T dt_ = yt_re * yt_re + yt_im * yt_im;
  f.iyt_re = yt_re / dt_;
  f.iyt_im = -yt_im / dt_;
  if (N == 3) {
    T e2_im, e2_re;
    sincos_t(T(U(PHI_G2)), &e2_im, &e2_re);
    const T v_g2 = T(U(V_G2));
#pragma unroll
    for (int k = 0; k < N; ++k) {
      f.v2_re[k] = (e2_re * ak_re[k] - e2_im * (-ak_im[k])) * v_g2;
      f.v2_im[k] = (e2_re * (-ak_im[k]) + e2_im * ak_re[k]) * v_g2;
    }
  }
}

// --- components ---------------------------------------------------------------
// The RHS is arithmetic on complex (re, im) pairs. A piece that computes one
// component takes a role: Re or Im, fixed at compile time (one thread computes
// both, as rhs_given_v does), or Lane, the role of a lane of a two-lane team
// known at run time (window_df.cu: lane 0 computes re, lane 1 im).
struct Re {};
struct Im {};
struct Lane {
  bool im;
};

template <class T>
__device__ __forceinline__ T pick(Re, T a, T) { return a; }
template <class T>
__device__ __forceinline__ T pick(Im, T, T b) { return b; }
template <class T>
__device__ __forceinline__ T pick(Lane r, T a, T b) { return r.im ? b : a; }

// component of a*b
template <class T>
__device__ __forceinline__ T cmul(Re, T ar, T ai, T br, T bi) {
  return ar * br - ai * bi;
}
template <class T>
__device__ __forceinline__ T cmul(Im, T ar, T ai, T br, T bi) {
  return ar * bi + ai * br;
}
// Im as Re of a*(bi - j br): ar*bi - ai*(-br) equals ar*bi + ai*br bit for
// bit in df (round-to-nearest is sign-symmetric, a - b is a + (-b)), so both
// lanes run the same instructions on their own operands.
template <class T>
__device__ __forceinline__ T cmul(Lane r, T ar, T ai, T br, T bi) {
  return cmul(Re{}, ar, ai, pick(r, br, bi), pick(r, bi, -br));
}

// rhs_core.soft_limit_scale with the hoisted reciprocal: r^16 by squaring
template <class T>
__device__ __forceinline__ T soft_limit_scale(T mag, T inv_lim) {
  T r = min_t(mag * inv_lim, lit<T>(8.0));
  T r2 = r * r;
  T r4 = r2 * r2;
  T r8 = r4 * r4;
  return pow_sat(lit<T>(1.0) + r8 * r8);
}

// rhs_core.aw_gate with the hoisted reciprocal, in its three steps
template <class T>
__device__ __forceinline__ T aw_exponent(T mag, T inv_lim) {
  T r = mag * inv_lim;
  T z = lit<T>(AW_KAPPA) * (lit<T>(1.0) - r);
  return -min_t(z, lit<T>(40.0));
}
template <class T>
__device__ __forceinline__ T aw_denominator(T e) { return lit<T>(1.0) + e; }
template <class T>
__device__ __forceinline__ T aw_gate(T mag, T inv_lim) {
  return lit<T>(1.0) / aw_denominator(exp_t(aw_exponent(mag, inv_lim)));
}

// rhs_core.grid_rot: e^{j(phi_g + w_base*dw_g*(t - t_g))}
template <class T, int N>
__device__ __forceinline__ void grid_rot(T t, const Feeder<T, N>& f, T& re,
                                         T& im) {
  T phi = f.phi_g + f.wdw * (t - f.t_g);
  sincos_t(phi, &im, &re);
}

// --- pieces of the PCC voltage (rhs_core.pcc_voltage) ------------------------
// component r of the grid source at phase k (three-phase): the rotated
// positive-sequence source vgp = rot * v_g on the phase's rotator, plus the
// negative-sequence source
template <class T, int N, class R>
__device__ __forceinline__ T grid_source(R r, int k, T vgp_re, T vgp_im,
                                         T rot_re, T rot_im,
                                         const Feeder<T, N>& f,
                                         const T (&ak_re)[N],
                                         const T (&ak_im)[N]) {
  return cmul(r, vgp_re, vgp_im, ak_re[k], ak_im[k])
         + cmul(r, rot_re, rot_im, f.v2_re[k], f.v2_im[k]);
}

// component r of the current into the PCC node: source through y_g plus ii
template <class T, int N, class R>
__device__ __forceinline__ T pcc_sum(R r, T vg_re, T vg_im, T ii,
                                     const Feeder<T, N>& f) {
  return cmul(r, vg_re, vg_im, f.yg_re, f.yg_im) + ii;
}

// component r of the PCC voltage: that current through 1/y_tot
template <class T, int N, class R>
__device__ __forceinline__ T pcc_node(R r, T s_re, T s_im,
                                      const Feeder<T, N>& f) {
  return cmul(r, s_re, s_im, f.iyt_re, f.iyt_im);
}

// rhs_core.pcc_voltage(i_inj, ...) with the grid phasor `rot` given
template <class T, int N>
__device__ __forceinline__ void pcc_voltage(
    const T (&ii_re)[N], const T (&ii_im)[N], T rot_re, T rot_im,
    const Feeder<T, N>& f, const T (&ak_re)[N], const T (&ak_im)[N],
    T (&v_re)[N], T (&v_im)[N]) {
  const T vgp_re = rot_re * f.v_g, vgp_im = rot_im * f.v_g;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    T vg_re = vgp_re, vg_im = vgp_im;
    if (N != 1) {
      vg_re = grid_source(Re{}, k, vgp_re, vgp_im, rot_re, rot_im, f, ak_re,
                          ak_im);
      vg_im = grid_source(Im{}, k, vgp_re, vgp_im, rot_re, rot_im, f, ak_re,
                          ak_im);
    }
    const T s_re = pcc_sum(Re{}, vg_re, vg_im, ii_re[k], f);
    const T s_im = pcc_sum(Im{}, vg_re, vg_im, ii_im[k], f);
    v_re[k] = pcc_node(Re{}, s_re, s_im, f);
    v_im[k] = pcc_node(Im{}, s_re, s_im, f);
  }
}

// --- pieces of rhs_given_v ------------------------------------------------------
// component r of phase k's term of the positive-sequence PCC voltage (the
// phase voltage rotated back; their sum over phases / N)
template <class T, int N, class R>
__device__ __forceinline__ T vpos_term(R r, int k, const T (&v_re)[N],
                                       const T (&v_im)[N],
                                       const Unit<T, N>& w) {
  return cmul(r, v_re[k], v_im[k], w.ak_re[k], -w.ak_im[k]);
}

// the floored DC-link voltage and the modulation gain kv * vdc_pos
template <class T, int N>
__device__ __forceinline__ T dc_gain(const Unit<T, N>& w, T vdc, T& vdc_pos) {
  vdc_pos = max_t(vdc, w.vdc_floor);
  return w.kv * vdc_pos;
}

// one component of the GCC's modulation command (filter state uf, integrator xg)
template <class T, int N>
__device__ __forceinline__ T modulation(const Unit<T, N>& w, T uf, T xg) {
  return uf * w.kp_gcc + xg;
}

// mag = |(a, b)| (floored by 1e-30 under the root) and its soft-limit scale
template <class T>
__device__ __forceinline__ T limit(T a, T b, T inv_lim, T& mag) {
  mag = sqrt_t(a * a + b * b + lit<T>(1e-30));
  return soft_limit_scale(mag, inv_lim);
}

// one component of the converter's terminal voltage
template <class T>
__device__ __forceinline__ T terminal(T m, T s, T kvv) { return (m * s) * kvv; }

// the PLL's q-axis voltage
template <class T>
__device__ __forceinline__ T pll_error(T vp_re, T vp_im, T sth, T cth) {
  return vp_re * (-sth) + vp_im * cth;
}

// component r of a conj(b): Re the real power, Im the reactive (summed over
// phases, then / N)
template <class T, class R>
__device__ __forceinline__ T power_term(R r, T a_re, T a_im, T b_re, T b_im) {
  return cmul(r, a_re, a_im, b_re, -b_im);
}

// pv_power with the hoisted iph, gamma/T and 1/S: the diode's exponent
// (vdc_v: vdc in volts), then the array's per-unit power from its exp
template <class T, int N>
__device__ __forceinline__ T pv_exponent(const Unit<T, N>& w, T vdc, T& vdc_v) {
  vdc_v = vdc * w.vdc_base;
  return w.g_over_t * vdc_v;
}
template <class T, int N>
__device__ __forceinline__ T pv_power(const Unit<T, N>& w, T e, T vdc_v) {
  T i_arr = w.np_par * (w.iph - w.irs * (e - lit<T>(1.0)));
  i_arr = max_t(i_arr, lit<T>(0.0));
  return (i_arr * vdc_v) * w.inv_s;
}

// the DC-voltage loop's error and the reactive loop's
template <class T, int N>
__device__ __forceinline__ T dc_error(const Unit<T, N>& w, T vdc, T p_pcc) {
  return w.one_m_c * (vdc - w.vdc_ref) + w.c * (w.p_ref - p_pcc);
}
template <class T, int N>
__device__ __forceinline__ T q_error(const Unit<T, N>& w, T q_pcc) {
  return w.q_ref - q_pcc;
}

// component r of the current command before the limiter: id (Re) from the DC
// loop's error and integrator, iq (Im) from the reactive loop's
template <class T, int N, class R>
__device__ __forceinline__ T current_raw(R r, const Unit<T, N>& w, T e, T x) {
  const T v = pick(r, w.kp_dc, w.kp_q) * e + x;
  return pick(r, v, -v);
}

// component r of phase k's current reference: the dq reference idq rotated
// to the phase, gated by en
template <class T, int N, class R>
__device__ __forceinline__ T current_ref(R r, int k, T idq_re, T idq_im,
                                         const Unit<T, N>& w) {
  if (N == 1) return pick(r, idq_re, idq_im) * w.en;
  return cmul(r, idq_re, idq_im, w.ak_re[k], w.ak_im[k]) * w.en;
}

// one component of a phase's rates: the filter current i's (dc: its
// voltage balance, i_x = -i_im for re, i_re for im: the w_base
// cross-coupling), the GCC integrator's and the filter state uf's
template <class T, int N>
__device__ __forceinline__ T phase_dc(T i, T i_x, T vt, T v,
                                      const Unit<T, N>& w) {
  return ((vt - v) - i * w.rf) * w.wb_lf - i_x * w.wb;
}
template <class T, int N>
__device__ __forceinline__ T current_rate(T dc, T i, const Unit<T, N>& w) {
  return dc * w.conn + i * w.dis;
}
template <class T, int N>
__device__ __forceinline__ T gcc_rate(T uf, const Unit<T, N>& w) {
  return uf * w.ki_gcc_en;
}
template <class T, int N>
__device__ __forceinline__ T filter_rate(T iref, T i, T uf,
                                         const Unit<T, N>& w) {
  return ((iref - i) - uf) * w.w_f;
}

// the DC link's rate: num / den + the const-Vdc pin
template <class T, int N>
__device__ __forceinline__ T dc_link_num(const Unit<T, N>& w, T p_pv, T p_inv) {
  return w.one_m_c * (p_pv - w.conn * p_inv);
}
template <class T, int N>
__device__ __forceinline__ T dc_link_den(const Unit<T, N>& w, T vdc_pos) {
  return w.tau_dc * vdc_pos;
}
template <class T, int N>
__device__ __forceinline__ T dc_link_rate(const Unit<T, N>& w, T q, T vdc) {
  return q + w.c_pin * (w.vdc_ref - vdc);
}

// the DC (Re) or reactive (Im) loop's integrator rate
template <class T, int N, class R>
__device__ __forceinline__ T loop_rate(R r, const Unit<T, N>& w, T e, T aw) {
  return (pick(r, w.ki_dc, w.ki_q) * e) * aw;
}

// the PLL's rates: its integrator and the angle
template <class T, int N>
__device__ __forceinline__ void pll_rates(const Unit<T, N>& w, T v_q, T xpll,
                                          T& d_x, T& d_theta) {
  d_x = w.ki_pll * v_q;
  d_theta = w.wb * (w.kp_pll * v_q + xpll);
}

// rhs_core.rhs_given_v: algebra_given_v and rhs_from_algebra of one DER at
// the PCC voltage v, both components of every piece on this thread.
template <class T, int N>
__device__ __forceinline__ void rhs_given_v(const T (&y)[6 * N + 5],
                                            const T (&v_re)[N],
                                            const T (&v_im)[N],
                                            const Unit<T, N>& w,
                                            T (&dy)[6 * N + 5]) {
  const T vdc = y[6 * N + 0];
  const T xdc = y[6 * N + 1];
  const T xq = y[6 * N + 2];
  const T xpll = y[6 * N + 3];
  const T theta = y[6 * N + 4];

  T ii_re[N], ii_im[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    ii_re[k] = y[k] * w.conn;
    ii_im[k] = y[N + k] * w.conn;
  }

  T vpos_re, vpos_im;
  if (N == 1) {
    vpos_re = v_re[0];
    vpos_im = v_im[0];
  } else {
    T sr = lit<T>(0.0), si = lit<T>(0.0);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      sr = sr + vpos_term(Re{}, k, v_re, v_im, w);
      si = si + vpos_term(Im{}, k, v_re, v_im, w);
    }
    vpos_re = sr / lit<T>(N);
    vpos_im = si / lit<T>(N);
  }

  T vdc_pos;
  const T kvv = dc_gain(w, vdc, vdc_pos);
  T vt_re[N], vt_im[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const T mr = modulation(w, y[4 * N + k], y[2 * N + k]);
    const T mi = modulation(w, y[5 * N + k], y[3 * N + k]);
    T m_mag;
    const T s = limit(mr, mi, w.inv_m_max, m_mag);
    vt_re[k] = terminal(mr, s, kvv);
    vt_im[k] = terminal(mi, s, kvv);
  }

  T sth, cth;
  sincos_t(theta, &sth, &cth);
  const T v_q = pll_error(vpos_re, vpos_im, sth, cth);

  T p_inv = lit<T>(0.0), p_pcc = lit<T>(0.0), q_pcc = lit<T>(0.0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    p_inv = p_inv + power_term(Re{}, vt_re[k], vt_im[k], y[k], y[N + k]);
    p_pcc = p_pcc + power_term(Re{}, v_re[k], v_im[k], ii_re[k], ii_im[k]);
    q_pcc = q_pcc + power_term(Im{}, v_re[k], v_im[k], ii_re[k], ii_im[k]);
  }
  if (N != 1) {
    p_inv = p_inv / lit<T>(N);
    p_pcc = p_pcc / lit<T>(N);
    q_pcc = q_pcc / lit<T>(N);
  }

  T vdc_v;
  const T ex = pv_exponent(w, vdc, vdc_v);
  const T p_pv = pv_power(w, exp_t(ex), vdc_v);

  const T e_dc = dc_error(w, vdc, p_pcc);
  const T id_raw = current_raw(Re{}, w, e_dc, xdc);
  const T e_q = q_error(w, q_pcc);
  const T iq_raw = current_raw(Im{}, w, e_q, xq);
  T mag;
  const T s_lim = limit(id_raw, iq_raw, w.inv_i_max, mag);
  const T id_ref = id_raw * s_lim;
  const T iq_ref = iq_raw * s_lim;
  const T idq_re = cmul(Re{}, id_ref, iq_ref, cth, sth);
  const T idq_im = cmul(Im{}, id_ref, iq_ref, cth, sth);
  const T aw = w.en * aw_gate(mag, w.inv_i_max);

  // --- rhs_from_algebra ----------------------------------------------------
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const T i_re = y[k], i_im = y[N + k];
    const T uf_re = y[4 * N + k], uf_im = y[5 * N + k];
    const T iref_re = current_ref(Re{}, k, idq_re, idq_im, w);
    const T iref_im = current_ref(Im{}, k, idq_re, idq_im, w);
    const T dc_re = phase_dc(i_re, -i_im, vt_re[k], v_re[k], w);
    const T dc_im = phase_dc(i_im, i_re, vt_im[k], v_im[k], w);
    dy[k] = current_rate(dc_re, i_re, w);
    dy[N + k] = current_rate(dc_im, i_im, w);
    dy[2 * N + k] = gcc_rate(uf_re, w);
    dy[3 * N + k] = gcc_rate(uf_im, w);
    dy[4 * N + k] = filter_rate(iref_re, i_re, uf_re, w);
    dy[5 * N + k] = filter_rate(iref_im, i_im, uf_im, w);
  }
  dy[6 * N + 0] = dc_link_rate(
      w, dc_link_num(w, p_pv, p_inv) / dc_link_den(w, vdc_pos), vdc);
  dy[6 * N + 1] = loop_rate(Re{}, w, e_dc, aw);
  dy[6 * N + 2] = loop_rate(Im{}, w, e_q, aw);
  pll_rates(w, v_q, xpll, dy[6 * N + 3], dy[6 * N + 4]);
}

// The times of substep s's stages: t + h/2 (k2 and k3) and t + h (k4), with
// t = t0 + T(s)*h. One expression wherever a phasor's time is computed, so
// that a phasor computed for substep s on another lane has the same bits.
template <class T>
__device__ __forceinline__ void stage_times(T t0, int s, T h, T hh, T& th,
                                            T& t4) {
  const T t = t0 + static_cast<T>(s) * h;
  th = t + hh;
  t4 = t + h;
}

// One control window (T = float, or double for native.cu) of n_sub
// Kahan-compensated RK4 substeps of
// rhs(ys, rot_re, rot_im, dy). phasors(s, rh_re, rh_im, r4_re, r4_im) gives
// substep s's grid phasors of k2/k3 and of k4; k4's is the next substep's k1
// (r1 on entry: t0's), as rhs_core.grid_rot is shared in the plain version.
// h, h/2 and h/6 are rounded once on the host.
//
// What bounds K1 and K2 (window.cu, fleet_window.cu) is instruction issue
// and latency: one substep is ~1700-2600 SASS instructions per env or
// unit, and a window moves ~268 bytes per env. The four stages are one
// loop in the source, as the df32 window's (window_df.cu), but nvcc
// unrolls it: the written-out substep (27-51 KB of code) fits the
// instruction cache, which the df32 one (~210 KB) did not, and rolled
// (`#pragma unroll 1`) it ran K1 8% slower at one phase: the compiler no
// longer schedules the phasors' sincosf and one stage's tail under the
// next stage's work, and with two warps per scheduler that latency shows
// (PERF.md).
template <class T, int NS, class Rhs, class Phasors>
__device__ __forceinline__ void rk4_window(T (&y)[NS], T r1_re, T r1_im,
                                           int n_sub, T h, T hh, T h6,
                                           Rhs rhs, Phasors phasors) {
  T c[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) c[j] = T(0);
  for (int s = 0; s < n_sub; ++s) {
    T rh_re, rh_im, r4_re, r4_im;
    phasors(s, rh_re, rh_im, r4_re, r4_im);
    T acc[NS], ys[NS], kv[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) ys[j] = y[j];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      const T rot_re = st == 0 ? r1_re : st == 3 ? r4_re : rh_re;
      const T rot_im = st == 0 ? r1_im : st == 3 ? r4_im : rh_im;
      rhs(ys, rot_re, rot_im, kv);                   // k1 .. k4
      if (st == 0) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          acc[j] = kv[j];
          ys[j] = y[j] + hh * kv[j];
        }
      } else if (st < 3) {
        const T cs = st == 1 ? hh : h;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          acc[j] = acc[j] + T(2) * kv[j];
          ys[j] = y[j] + cs * kv[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          // Kahan step, order fixed: d = delta - c; s = y + d; c = (s - y) - d
          const T d = h6 * (acc[j] + kv[j]) - c[j];
          const T sj = y[j] + d;
          c[j] = (sj - y[j]) - d;
          y[j] = sj;
        }
      }
    }
    r1_re = r4_re;
    r1_im = r4_im;
  }
}

}  // namespace pvderx
