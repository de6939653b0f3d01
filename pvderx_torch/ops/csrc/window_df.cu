// Fused double-float32 RK4 control-window integrator for Hopper (sm_90a).
//
// Replaces the TPU kernel pvderx/ops/dualfloat.py::_window_kernel_df (called
// by pvderx.ops.dualfloat.rk4_window_batch_df). For every env it integrates
// one control window of n_sub classical RK4 substeps of the PV-DER
// right-hand side (rhs.cuh, instantiated over df) with the state, the RHS
// and time in double-float32 (df.cuh): y carried as (hi, lo) in and out,
// params, exog and t0 exact float32 inputs (lo = 0), h split exactly on the
// host from the float64 dt/n_sub. The update is
// y + (h*(1/6))*(k1 + 2k2 + 2k3 + k4) in df arithmetic, without Kahan (df
// accumulation is already compensated), as the reference's loop body.
//
// What bounds it on this card: instruction issue. One substep is 14746
// float32 operations per env for the single-phase model, 29830 three-phase
// (pvderx_torch.ops.dualfloat.OPS_PER_SUBSTEP_DF), against ~360 bytes per env
// per window. Most are adds that no FMA can absorb, so the floor is one
// operation per FP32 lane per clock (0.92 ms at 32768 single-phase envs,
// n_sub = 64, 1980 MHz), twice the 67 TFLOP/s FMA bound. With the four RK4
// stages written out, one substep was ~13.4k SASS instructions (~210 KB of
// code, more than the SM's instruction cache holds), and one thread per env
// gives ~8 warps per SM at 32768 envs. Rolling the stages (below) halved the
// time at the same occupancy: instruction fetch, not arithmetic, set the
// pace; the one-lane loop now issues at up to ~80% of the SMs' rate.
//
// What the design does about it:
// - The four stages run as a loop (`#pragma unroll 1`), so one copy of the
//   RHS is in the code and the substep loop fits the instruction cache.
//   This halves the single-phase time by itself.
// - The three-phase model runs on a team of two adjacent lanes per env.
//   Nearly all of the RHS is complex arithmetic on (re, im) pairs: lane 0
//   computes the re component of every piece, lane 1 the im one, with the
//   same instructions on their own operands (rhs.cuh's pieces under a
//   run-time `Lane` role), and the two exchange a df value (hi, lo: two
//   __shfl_xor_sync) where the next piece needs both. The scalar chains
//   come in pairs of one function and run side by side: the current
//   limiter's |(id, iq)| and soft-limit scale (lane 0) with phase 0's
//   modulation limiter (lane 1), then phases 1 and 2's; the anti-windup
//   gate's exp and divide (lane 0) with the PV diode's exp and the DC link's
//   divide (lane 1); sin(theta)'s polynomial (lane 0) with cos(theta)'s
//   (lane 1); the substep's two grid phasors, one per lane. A lane keeps only
//   its own states (3N + 3 slots: its component of the phase currents, GCC
//   integrators and filter states; lane 0 xdc, theta, xpll; lane 1 xq, vdc
//   and a pad) with their RK4 stage and accumulator, and updates only those,
//   so the three-phase kernel does not spill.
// - The single-phase model keeps one lane per env: a team of two ran ~20%
//   more instructions per env than one lane (the pieces both lanes need, the
//   selects and the exchanges) and at 32768 envs the extra warps did not pay
//   for them (PERF.md).
// Every df operation is the one-lane RHS's, in the same order, so the result
// equals the plain df32 version bit for bit.
//
// Layout: y_hi, y_lo and the outputs are [N, n_s] row-major; t0 is [N]; p and
// u are field-major [29, N] and [15, N]. Any N >= 1: lanes past the last env
// compute on the last env's inputs (every lane takes part in each shuffle;
// none returns early) and store nothing.
#include "rhs.cuh"

namespace {

using namespace pvderx;

constexpr int BLOCK = 64;

// the partner lane's value
__device__ __forceinline__ df xch(df x) {
  return df(__shfl_xor_sync(0xffffffffu, x.hi, 1),
            __shfl_xor_sync(0xffffffffu, x.lo, 1));
}

// (re, im) from this lane's component and its partner's
__device__ __forceinline__ void join(Lane r, df own, df other, df& re,
                                     df& im) {
  re = pick(r, own, other);
  im = pick(r, other, own);
}

// The state index of a team lane's slot j (-1 for the pad): component im of
// the phase currents (j < N), GCC integrators and filter states (j < 3N),
// then xdc, theta, xpll on lane 0 and xq, vdc, pad on lane 1.
template <int N>
__device__ __forceinline__ int state_index(bool im, int j) {
  if (j < 3 * N) return (j / N) * 2 * N + (im ? N : 0) + j % N;
  j -= 3 * N;
  if (im) return j == 0 ? 6 * N + 2 : j == 1 ? 6 * N : -1;
  return j == 0 ? 6 * N + 1 : j == 1 ? 6 * N + 4 : 6 * N + 3;
}

// n_sub RK4 substeps of rhs(ys, rot_re, rot_im, dy) over a lane's M slots,
// the four stages as a loop. phasors(t + h/2, t + h, rh, r4) gives the grid
// phasors of k2/k3 and of k4; k4's is the next substep's k1 (r1 on entry:
// t0's).
template <int M, class Rhs, class Phasors>
__device__ __forceinline__ void rk4_window_df(df (&y)[M], df t0, df h,
                                              df r1_re, df r1_im, int n_sub,
                                              Rhs rhs, Phasors phasors) {
  const df hh = h * lit<df>(0.5);
  const df h6 = h * lit<df>(1.0 / 6.0);
  for (int s = 0; s < n_sub; ++s) {
    const df t = t0 + h * df(static_cast<float>(s));
    df rh_re, rh_im, r4_re, r4_im;
    phasors(t + hh, t + h, rh_re, rh_im, r4_re, r4_im);
    df acc[M], ys[M], kv[M];
#pragma unroll
    for (int j = 0; j < M; ++j) ys[j] = y[j];
#pragma unroll 1
    for (int st = 0; st < 4; ++st) {
      const df rot_re = st == 0 ? r1_re : st == 3 ? r4_re : rh_re;
      const df rot_im = st == 0 ? r1_im : st == 3 ? r4_im : rh_im;
      rhs(ys, rot_re, rot_im, kv);                   // k1 .. k4
      if (st == 0) {
#pragma unroll
        for (int j = 0; j < M; ++j) {
          acc[j] = kv[j];
          ys[j] = y[j] + hh * kv[j];
        }
      } else if (st < 3) {
        const df c = st == 1 ? hh : h;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          acc[j] = acc[j] + lit<df>(2.0) * kv[j];
          ys[j] = y[j] + c * kv[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < M; ++j) y[j] = y[j] + h6 * (acc[j] + kv[j]);
      }
    }
    r1_re = r4_re;
    r1_im = r4_im;
  }
}

// Lanes per env: one for the single-phase model, a two-lane team for the
// three-phase one.
__host__ __device__ constexpr int team(int n_ph) { return n_ph == 1 ? 1 : 2; }

template <int N>
__global__ void __launch_bounds__(BLOCK)
window_df_kernel(const float* __restrict__ y_hi, const float* __restrict__ y_lo,
                 const float* __restrict__ t0_in, const float* __restrict__ p,
                 const float* __restrict__ u, float* __restrict__ out_hi,
                 float* __restrict__ out_lo, int n, int n_sub, float h_hi,
                 float h_lo) {
  constexpr int NS = 6 * N + 5;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) / team(N);
  const int ec = min(e, n - 1);
  auto P = [&](int f) { return p[static_cast<size_t>(f) * n + ec]; };
  auto U = [&](int f) { return u[static_cast<size_t>(f) * n + ec]; };

  Unit<df, N> w;
  load_unit(w, P, U);
  Feeder<df, N> fd;
  load_feeder(fd, w.ak_re, w.ak_im, P, U);
  const df t0(t0_in[ec]);
  const df h(h_hi, h_lo);
  df r1_re, r1_im;
  grid_rot(t0, fd, r1_re, r1_im);

  if constexpr (N == 1) {
    // rhs_core.rhs: the DER's own injection sets its PCC voltage
    auto rhs = [&](const df (&ys)[NS], df rot_re, df rot_im, df (&dy)[NS]) {
      df ii_re[N], ii_im[N], v_re[N], v_im[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        ii_re[k] = ys[k] * w.conn;
        ii_im[k] = ys[N + k] * w.conn;
      }
      pcc_voltage<df, N>(ii_re, ii_im, rot_re, rot_im, fd, w.ak_re, w.ak_im,
                         v_re, v_im);
      rhs_given_v<df, N>(ys, v_re, v_im, w, dy);
    };
    auto phasors = [&](df th, df t4, df& rh_re, df& rh_im, df& r4_re,
                       df& r4_im) {
      grid_rot(th, fd, rh_re, rh_im);
      grid_rot(t4, fd, r4_re, r4_im);
    };
    df y[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const size_t i = static_cast<size_t>(ec) * NS + j;
      y[j] = df(y_hi[i], y_lo[i]);
    }
    rk4_window_df(y, t0, h, r1_re, r1_im, n_sub, rhs, phasors);
    if (e < n) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const size_t i = static_cast<size_t>(e) * NS + j;
        out_hi[i] = y[j].hi;
        out_lo[i] = y[j].lo;
      }
    }
  } else {
    constexpr int M = 3 * N + 3;
    const Lane r{(threadIdx.x & 1) != 0};   // lane 0 re, lane 1 im
    // rhs_core.rhs on this lane's slots: each piece for this lane's role,
    // exchanged with the partner where the next piece needs both components
    auto rhs = [&](const df (&ys)[M], df rot_re, df rot_im, df (&dy)[M]) {
      const df sc = xch(ys[3 * N + 1]);           // theta <-> vdc
      const df vdc = pick(r, sc, ys[3 * N + 1]);
      const df theta = pick(r, ys[3 * N + 1], sc);
      df i_re[N], i_im[N], ii_re[N], ii_im[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        join(r, ys[k], xch(ys[k]), i_re[k], i_im[k]);
        ii_re[k] = i_re[k] * w.conn;
        ii_im[k] = i_im[k] * w.conn;
      }

      // the PCC voltage (pcc_voltage)
      const df vgp_re = rot_re * fd.v_g, vgp_im = rot_im * fd.v_g;
      df v_re[N], v_im[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const df c = grid_source(r, k, vgp_re, vgp_im, rot_re, rot_im, fd,
                                 w.ak_re, w.ak_im);
        df vg_re, vg_im;
        join(r, c, xch(c), vg_re, vg_im);
        const df s =
            pcc_sum(r, vg_re, vg_im, pick(r, ii_re[k], ii_im[k]), fd);
        df s_re, s_im;
        join(r, s, xch(s), s_re, s_im);
        const df v = pcc_node(r, s_re, s_im, fd);
        join(r, v, xch(v), v_re[k], v_im[k]);
      }
      df vp_re, vp_im;
      {
        df c = lit<df>(0.0);
#pragma unroll
        for (int k = 0; k < N; ++k) c = c + vpos_term(r, k, v_re, v_im, w);
        c = c / lit<df>(N);
        join(r, c, xch(c), vp_re, vp_im);
      }

      df vdc_pos;
      const df kvv = dc_gain(w, vdc, vdc_pos);
      df m[N];
#pragma unroll
      for (int k = 0; k < N; ++k)
        m[k] = modulation(w, ys[2 * N + k], ys[N + k]);

      // sin(theta)'s polynomial on lane 0, cos(theta)'s on lane 1
      df sth, cth;
      {
        const SinCosArg g = sincos_reduce(theta);
        const df c = sincos_half(g, r.im);
        df s_, c_;
        join(r, c, xch(c), s_, c_);
        sincos_finish(g.k, s_, c_, &sth, &cth);
      }
      const df v_q = pll_error(vp_re, vp_im, sth, cth);

      // p_pcc and the DC loop on lane 0, q_pcc and the reactive loop on lane 1
      df pq = lit<df>(0.0);
#pragma unroll
      for (int k = 0; k < N; ++k)
        pq = pq + power_term(r, v_re[k], v_im[k], ii_re[k], ii_im[k]);
      pq = pq / lit<df>(N);
      const df err = pick(r, dc_error(w, vdc, pq), q_error(w, pq));
      const df raw = current_raw(r, w, err, ys[3 * N]);

      // the limiters: lane 0 the current (id, iq), lane 1 phase 0's
      // modulation; then phase 1 on lane 0 and phase 2 on lane 1
      df s_lim, s_m[N], mag;
      {
        const df o = xch(pick(r, m[0], raw));
        const df s = limit(pick(r, raw, o), pick(r, o, m[0]),
                           pick(r, w.inv_i_max, w.inv_m_max), mag);
        join(r, s, xch(s), s_lim, s_m[0]);
        const df o2 = xch(pick(r, m[2], m[1]));
        df mag2;
        const df s2 = limit(pick(r, m[1], o2), pick(r, o2, m[2]), w.inv_m_max,
                            mag2);
        join(r, s2, xch(s2), s_m[1], s_m[2]);
      }
      df vt[N];
#pragma unroll
      for (int k = 0; k < N; ++k) vt[k] = terminal(m[k], s_m[k], kvv);
      const df ref = raw * s_lim;

      // exp: the anti-windup gate's on lane 0, the PV diode's on lane 1
      df vdc_v;
      const df ex = pv_exponent(w, vdc, vdc_v);
      const df ee = exp_t(pick(r, aw_exponent(mag, w.inv_i_max), ex));

      // divide: the gate on lane 0, the DC link's quotient on lane 1
      df vt_re[N], vt_im[N];
#pragma unroll
      for (int k = 0; k < N; ++k)
        join(r, vt[k], xch(vt[k]), vt_re[k], vt_im[k]);
      df p_inv = lit<df>(0.0);
#pragma unroll
      for (int k = 0; k < N; ++k)
        p_inv =
            p_inv + power_term(Re{}, vt_re[k], vt_im[k], i_re[k], i_im[k]);
      p_inv = p_inv / lit<df>(N);
      const df p_pv = pv_power(w, ee, vdc_v);
      const df q = pick(r, lit<df>(1.0), dc_link_num(w, p_pv, p_inv))
                   / pick(r, aw_denominator(ee), dc_link_den(w, vdc_pos));
      const df aw = w.en * pick(r, q, xch(q));

      // the dq current reference rotated by theta
      df id_ref, iq_ref;
      join(r, ref, xch(ref), id_ref, iq_ref);
      const df idq = cmul(r, id_ref, iq_ref, cth, sth);
      df idq_re, idq_im;
      join(r, idq, xch(idq), idq_re, idq_im);

      // rhs_from_algebra on this lane's slots
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const df i = ys[k], uf = ys[2 * N + k];
        const df dc = phase_dc(i, pick(r, -i_im[k], i_re[k]), vt[k],
                               pick(r, v_re[k], v_im[k]), w);
        dy[k] = current_rate(dc, i, w);
        dy[N + k] = gcc_rate(uf, w);
        dy[2 * N + k] =
            filter_rate(current_ref(r, k, idq_re, idq_im, w), i, uf, w);
      }
      dy[3 * N] = loop_rate(r, w, err, aw);
      df d_x, d_theta;
      pll_rates(w, v_q, ys[3 * N + 2], d_x, d_theta);
      dy[3 * N + 1] = pick(r, d_theta, dc_link_rate(w, q, vdc));
      dy[3 * N + 2] = pick(r, d_x, lit<df>(0.0));
    };
    // the half-step phasor (k2, k3) on lane 0, the end one (k4) on lane 1
    auto phasors = [&](df th, df t4, df& rh_re, df& rh_im, df& r4_re,
                       df& r4_im) {
      df g_re, g_im;
      grid_rot(pick(r, th, t4), fd, g_re, g_im);
      join(r, g_re, xch(g_re), rh_re, r4_re);
      join(r, g_im, xch(g_im), rh_im, r4_im);
    };
    df y[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int s = state_index<N>(r.im, j);
      const size_t i = static_cast<size_t>(ec) * NS + (s < 0 ? 0 : s);
      y[j] = s < 0 ? lit<df>(0.0) : df(y_hi[i], y_lo[i]);
    }
    rk4_window_df(y, t0, h, r1_re, r1_im, n_sub, rhs, phasors);
    if (e < n) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const int s = state_index<N>(r.im, j);
        if (s < 0) continue;
        const size_t i = static_cast<size_t>(e) * NS + s;
        out_hi[i] = y[j].hi;
        out_lo[i] = y[j].lo;
      }
    }
  }
}

template <int N>
void launch(int n, cudaStream_t s, const float* yh, const float* yl,
            const float* tf, const float* pf, const float* uf, float* oh,
            float* ol, int n_sub, float h_hi, float h_lo) {
  const long long threads = static_cast<long long>(n) * team(N);
  const dim3 grid(static_cast<unsigned>((threads + BLOCK - 1) / BLOCK));
  window_df_kernel<N><<<grid, BLOCK, 0, s>>>(yh, yl, tf, pf, uf, oh, ol, n,
                                             n_sub, h_hi, h_lo);
}

}  // namespace

extern "C" int pvderx_rk4_window_df(const void* y_hi, const void* y_lo,
                                    const void* t0, const void* p,
                                    const void* u, void* out_hi, void* out_lo,
                                    int n, int n_ph, int n_sub, float h_hi,
                                    float h_lo, void* stream) {
  if (n < 1 || n_sub < 1 || (n_ph != 1 && n_ph != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto yh = static_cast<const float*>(y_hi);
  auto yl = static_cast<const float*>(y_lo);
  auto tf = static_cast<const float*>(t0);
  auto pf = static_cast<const float*>(p);
  auto uf = static_cast<const float*>(u);
  auto oh = static_cast<float*>(out_hi);
  auto ol = static_cast<float*>(out_lo);
  (n_ph == 1 ? launch<1> : launch<3>)(
      n, s, yh, yl, tf, pf, uf, oh, ol, n_sub, h_hi, h_lo);
  return static_cast<int>(cudaGetLastError());
}
