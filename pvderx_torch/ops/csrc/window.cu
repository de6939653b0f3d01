// Fused RK4 control-window integrator for Hopper (sm_90a).
//
// Replaces the TPU kernel pvderx/ops/window.py::_window_kernel (called by
// pvderx.ops.window.rk4_window_batch). For every env it integrates one
// control window: n_sub classical RK4 substeps of the PV-DER right-hand side
// (pvderx_torch/physics/rhs_core.py), exog held constant over the window.
//
// What bounds it on this card: arithmetic. One substep is ~923 operations
// per env for the single-phase model (2371 for three-phase) -- 4 RHS
// evaluations with sin/cos/exp/pow, 2 grid rotations, the Kahan combine --
// while the whole window moves ~268 bytes per env (one read of t0, y,
// p_pack[29], u_pack[15] and one write of y1, all f32). At n_sub = 64 that
// is ~220 operations per byte, far above the card's float32 ridge point.
//
// What the design does about it: one thread per env holds its 11 (or 23)
// states, the Kahan carry, the RK4 accumulator and the window-invariant
// `Prep` in registers, and runs all n_sub substeps without touching device
// memory: one pass over device memory per window. The grid phasor is
// computed twice per substep (k2 and k3 share the half-point; k4's is the
// next substep's k1), as rhs_core.grid_rot is shared in the plain version.
// Occupancy, special-function pressure and sincosf sharing are left for a
// later change.
//
// Arithmetic follows rhs_core's hoisted path operation by operation, in the
// same order. nvcc contracts a*b+c into FMAs, so results are not bitwise
// equal to the plain torch version; the Kahan steps contain no products, so
// contraction cannot break them. No fast-math: full-range sinf/cosf/expf/
// powf are required (the grid angle reaches ~100 rad in an episode).
//
// Layout: y and y1 are [N, n_s] row-major; t0 is [N]; p and u are
// field-major [29, N] and [15, N] (neighbouring threads read neighbouring
// addresses). Any N >= 1: the last block masks the ragged edge.
#include <cuda_runtime.h>

namespace {

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

constexpr int BLOCK = 64;
constexpr float TWO_PI_3 = static_cast<float>(2.0943951023931953);
constexpr float SAT_EXP = -1.0f / 16.0f;   // -1/SAT_K
constexpr float AW_KAPPA = 40.0f;
constexpr float VDC_PIN_RATE = 1000.0f;
constexpr float T_REF = 298.15f;

// Window invariants of one env: its params, its exog, and rhs_core.Prep.
template <int N>
struct Win {
  // params and products of params that every RHS evaluation uses
  float rf, wb, wb_lf, kv, vdc_floor, vdc_base, np_par, irs, tau_dc;
  float w_f, kp_gcc, kp_dc, ki_dc, kp_q, ki_q, kp_pll, ki_pll;
  float c, one_m_c, c_pin;
  // exog
  float v_g, phi_g, wdw, t_g, vdc_ref, q_ref, conn, p_ref, dis;
  // Prep (rhs_core.prep_invariants)
  float yg_re, yg_im, iyt_re, iyt_im, en, ki_gcc_en, iph;
  float inv_m_max, inv_i_max, g_over_t, inv_s;
  float ak_re[N], ak_im[N], v2_re[N], v2_im[N];
};

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
__device__ __forceinline__ void grid_rot(float t, const Win<N>& w,
                                         float& re, float& im) {
  float phi = w.phi_g + w.wdw * (t - w.t_g);
  sincosf(phi, &im, &re);
}

// rhs_core.rhs(y, t, p, u, xp, prep, rot): pcc_voltage, algebra_given_v and
// rhs_from_algebra, for one env.
template <int N>
__device__ __forceinline__ void rhs(const float (&y)[6 * N + 5], float rot_re,
                                    float rot_im, const Win<N>& w,
                                    float (&dy)[6 * N + 5]) {
  const float vdc = y[6 * N + 0];
  const float xdc = y[6 * N + 1];
  const float xq = y[6 * N + 2];
  const float xpll = y[6 * N + 3];
  const float theta = y[6 * N + 4];

  // --- pcc_voltage -------------------------------------------------------
  const float vgp_re = rot_re * w.v_g, vgp_im = rot_im * w.v_g;
  float v_re[N], v_im[N], ii_re[N], ii_im[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float vg_re, vg_im;
    if (N == 1) {
      vg_re = vgp_re;
      vg_im = vgp_im;
    } else {
      float a_re = vgp_re * w.ak_re[k] - vgp_im * w.ak_im[k];
      float a_im = vgp_re * w.ak_im[k] + vgp_im * w.ak_re[k];
      float b_re = rot_re * w.v2_re[k] - rot_im * w.v2_im[k];
      float b_im = rot_re * w.v2_im[k] + rot_im * w.v2_re[k];
      vg_re = a_re + b_re;
      vg_im = a_im + b_im;
    }
    ii_re[k] = y[k] * w.conn;
    ii_im[k] = y[N + k] * w.conn;
    float s_re = (vg_re * w.yg_re - vg_im * w.yg_im) + ii_re[k];
    float s_im = (vg_re * w.yg_im + vg_im * w.yg_re) + ii_im[k];
    v_re[k] = s_re * w.iyt_re - s_im * w.iyt_im;
    v_im[k] = s_re * w.iyt_im + s_im * w.iyt_re;
  }

  // --- algebra_given_v -----------------------------------------------------
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

template <int N>
__global__ void __launch_bounds__(BLOCK)
window_kernel(const float* __restrict__ y_in, const float* __restrict__ t0_in,
              const float* __restrict__ p, const float* __restrict__ u,
              float* __restrict__ y_out, int n, int n_sub, float h, float hh,
              float h6) {
  constexpr int NS = 6 * N + 5;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  auto P = [&](int f) { return p[static_cast<size_t>(f) * n + e]; };
  auto U = [&](int f) { return u[static_cast<size_t>(f) * n + e]; };

  Win<N> w;
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

  w.v_g = U(V_G);
  w.phi_g = U(PHI_G);
  w.wdw = w.wb * U(DW_G);
  w.t_g = U(T_G);
  w.vdc_ref = U(VDC_REF);
  w.q_ref = U(Q_REF);
  w.conn = U(CONN);
  w.p_ref = U(P_REF);
  w.dis = -(1.0f - w.conn) * w.wb;

  // Prep: grid admittance, total admittance and its inverse
  const float rg = P(RG), xg = P(XG);
  const float dg = rg * rg + xg * xg;
  w.yg_re = rg / dg;
  w.yg_im = -xg / dg;
  const float yt_re = w.yg_re + U(G_LOAD), yt_im = w.yg_im + U(B_LOAD);
  const float dt_ = yt_re * yt_re + yt_im * yt_im;
  w.iyt_re = yt_re / dt_;
  w.iyt_im = -yt_im / dt_;
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
    float e2_im, e2_re;
    sincosf(U(PHI_G2), &e2_im, &e2_re);
    const float v_g2 = U(V_G2);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float sa, ca;
      sincosf(ang[k], &sa, &ca);
      w.ak_re[k] = ca;
      w.ak_im[k] = sa;
      w.v2_re[k] = (e2_re * w.ak_re[k] - e2_im * (-w.ak_im[k])) * v_g2;
      w.v2_im[k] = (e2_re * (-w.ak_im[k]) + e2_im * w.ak_re[k]) * v_g2;
    }
  }

  float y[NS], c[NS], acc[NS], ys[NS], kv[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    y[j] = y_in[static_cast<size_t>(e) * NS + j];
    c[j] = 0.0f;
  }
  const float t0 = t0_in[e];
  float r1_re, r1_im;
  grid_rot(t0, w, r1_re, r1_im);

  for (int s = 0; s < n_sub; ++s) {
    const float t = t0 + static_cast<float>(s) * h;
    float rh_re, rh_im, r4_re, r4_im;
    grid_rot(t + hh, w, rh_re, rh_im);
    grid_rot(t + h, w, r4_re, r4_im);
    rhs<N>(y, r1_re, r1_im, w, kv);                      // k1
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      acc[j] = kv[j];
      ys[j] = y[j] + hh * kv[j];
    }
    rhs<N>(ys, rh_re, rh_im, w, kv);                     // k2
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      acc[j] = acc[j] + 2.0f * kv[j];
      ys[j] = y[j] + hh * kv[j];
    }
    rhs<N>(ys, rh_re, rh_im, w, kv);                     // k3
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      acc[j] = acc[j] + 2.0f * kv[j];
      ys[j] = y[j] + h * kv[j];
    }
    rhs<N>(ys, r4_re, r4_im, w, kv);                     // k4
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

#pragma unroll
  for (int j = 0; j < NS; ++j) y_out[static_cast<size_t>(e) * NS + j] = y[j];
}

}  // namespace

extern "C" int pvderx_rk4_window(const void* y, const void* t0, const void* p,
                                 const void* u, void* out, int n, int n_ph,
                                 int n_sub, float h, float hh, float h6,
                                 void* stream) {
  if (n < 1 || n_sub < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto yf = static_cast<const float*>(y);
  auto tf = static_cast<const float*>(t0);
  auto pf = static_cast<const float*>(p);
  auto uf = static_cast<const float*>(u);
  auto of = static_cast<float*>(out);
  if (n_ph == 1) {
    window_kernel<1><<<grid, block, 0, s>>>(yf, tf, pf, uf, of, n, n_sub, h, hh, h6);
  } else if (n_ph == 3) {
    window_kernel<3><<<grid, block, 0, s>>>(yf, tf, pf, uf, of, n, n_sub, h, hh, h6);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pvderx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
