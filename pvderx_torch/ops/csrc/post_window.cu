// The env step's post-window glue in one pass over the envs (sm_90a).
//
// Replaces no TPU kernel. The reference runs its step under jit, where XLA
// fuses the glue after the window (pvderx/env/core.py's step: the algebra
// at t + dt, the ride-through update, observation, reward and done) into a
// few loops. The port's eager version (pvderx_torch/env/core.py:
// `_post_window_plain`) is ~200 launches a step, each reading and writing
// whole [N] columns, several of them strided columns of y1.T. This kernel
// computes the same outputs in one launch, one thread per env.
//
// What bounds it on this card: bytes. An env reads y1 (n_s), 11 rows of
// the [29, N] params pack, 12 of the [15, N] exog pack (14 at three
// phases), t, t_step, its six zone timers and its trip latch (the flag and
// s0 with the anomaly reward), and writes obs (13), the reward, the timers,
// the trip latch, the cessation flag, the seven float info leaves, t_step
// and three one-byte flags: 295 B at one phase in float32
// (pvderx_torch/ops/post_window.py: post_window_bytes). Its ~120
// operations, 4 sin/cos, one exp and two hypot are far below what the SMs
// issue in the time those bytes take.
//
// What the design does about it: one thread per env, 128 envs a block. The
// row-major leaves (y1 [N, n_s] and the timers [N, 6] in, obs [N, 13] and
// the timers out) go through shared memory as one flat run per block,
// neighbouring threads on neighbouring words; the packs are field-major
// and the other leaves [N] columns, read and written directly, so every
// access is coalesced. Every output is a fresh tensor: no input is written.
// The soft limiters, the terminal voltage and the current references of
// the RHS feed no output of the step, so they are not computed.
//
// Bitwise equality with the eager version on the card:
// - this file is compiled without FMA contraction (-fmad=false:
//   pvderx_torch/ops/_build.py, SOURCE_FLAGS), so each + - * rounds once,
//   as in torch's one-operation kernels, in rhs_core's order; rhs.cuh's
//   feeder and PCC voltage pieces are reused as they round the same here,
//   and glue.cuh's one-operation helpers, shared with pre_window.cu;
// - the transcendentals are those torch's CUDA kernels call: sin, cos,
//   exp, hypot of T;
// - a Python scalar is rounded once to T, as torch casts it to the
//   operation's type (the constants array, lit<T>);
// - a division by a Python scalar (s_irr / 1000.0, t_next / horizon) is a
//   product with the reciprocal rounded in T: torch's CUDA true division by
//   a CPU scalar computes x * (1 / b);
// - a mean over the phases is their sum from +0 in phase order times 1/N
//   rounded in T, as torch's CUDA mean reduces; at three phases torch's
//   reduction picks its order of summation by the operand's layout, so the
//   check allows a tolerance there;
// - torch.clamp and torch.maximum pass a NaN through; so do these.
//
// Layout: every leaf has the env axis leading and is contiguous; the packs
// are [fields, N]; t_step is int32; done, terminated and truncated are one
// byte each; t_lim and enable are the config's [6] zone tables. Any N >= 1:
// the last block masks the ragged edge.
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

#include "glue.cuh"

namespace {

using pvderx::Feeder;
using pvderx::Im;
using pvderx::Re;
using pvderx::lit;

constexpr int BLOCK = 128;
constexpr int OBS = 13, ZONES = 6;

// The order of the pointer and constant arrays that the entry takes
// (pvderx_torch/ops/post_window.py: IN_LEAVES, OUT_LEAVES, step_constants).
enum In {
  kY, kT, kTStep, kP, kU, kTimers, kTripped, kTLim, kEnable, kFlag, kS0,
  kNumIn
};
enum Out {
  oObs, oReward, oDone, oTerminated, oTruncated, oTStep, oTimers, oTripped,
  oCes, oVMag, oFMeas, oVUnb, oPPcc, oQPcc, oPPv, oTripNow, kNumOut
};
enum Const {
  cDt, cVLv1, cVLv2, cVHv1, cVHv2, cFLf, cFHf, cRAlive, cWVdc, cWQ, cWVband,
  cRTrip, cRAnomTp, cRAnomFp, cRAnomFn, kNumConst
};

template <typename T>
struct Args {
  const T *y, *t;
  const int* t_step;
  const T *p, *u, *timers, *tripped, *t_lim, *enable, *flag, *s0;
  T *obs, *reward;
  unsigned char *done, *terminated, *truncated;
  int* t_step_o;
  T *timers_o, *tripped_o, *ces, *v_mag, *f_meas, *v_unb, *p_pcc, *q_pcc,
      *p_pv, *trip_now;
  T c[kNumConst];
  int horizon;
};

// `_post_window_plain` of env e: y its state after the window, tm its zone
// timers (updated in place); its observation goes to obs[0..12]
template <typename T, int NPH>
__device__ __forceinline__ void step_env(const Args<T>& a, size_t e,
                                         size_t n, const T (&y)[6 * NPH + 5],
                                         T (&tm)[ZONES], T* obs) {
  using namespace pvderx;
  using namespace pvderx::glue;
  const auto P = [&](int k) { return a.p[k * n + e]; };   // params row k
  const auto U = [&](int k) { return a.u[k * n + e]; };   // exog row k
  const T* c = a.c;
  const T zero = lit<T>(0.0), one = lit<T>(1.0);
  const T inv_1000 = one / lit<T>(1000.0);

  // --- rhs_core.algebra at t + dt (prep_invariants computed inline) -------
  T ak_re[NPH], ak_im[NPH];
  if (NPH == 3) {
    const T ang[3] = {zero, -lit<T>(TWO_PI_3), lit<T>(TWO_PI_3)};
#pragma unroll
    for (int k = 0; k < NPH; ++k) {
      ak_re[k] = cos_(ang[k]);
      ak_im[k] = sin_(ang[k]);
    }
  } else {
    ak_re[0] = one;   // a_k = 1: the single-phase pieces never read it
    ak_im[0] = zero;
  }
  Feeder<T, NPH> f;
  load_feeder(f, ak_re, ak_im, P, U);
  const T conn = U(CONN);
  const T t1 = a.t[e] + c[cDt];
  const T phi = f.phi_g + f.wdw * (t1 - f.t_g);   // grid_rot
  const T rot_re = cos_(phi), rot_im = sin_(phi);
  T ii_re[NPH], ii_im[NPH], v_re[NPH], v_im[NPH];
#pragma unroll
  for (int k = 0; k < NPH; ++k) {
    ii_re[k] = y[k] * conn;
    ii_im[k] = y[NPH + k] * conn;
  }
  pcc_voltage(ii_re, ii_im, rot_re, rot_im, f, ak_re, ak_im, v_re, v_im);

  // algebra_given_v: the positive sequence, the PLL, the PCC powers
  T vr[NPH], vi[NPH], ir[NPH], ij[NPH];
#pragma unroll
  for (int k = 0; k < NPH; ++k) {
    vr[k] = pos_term(Re{}, k, v_re, v_im, ak_re, ak_im);
    vi[k] = pos_term(Im{}, k, v_re, v_im, ak_re, ak_im);
    ir[k] = pos_term(Re{}, k, ii_re, ii_im, ak_re, ak_im);
    ij[k] = pos_term(Im{}, k, ii_re, ii_im, ak_re, ak_im);
  }
  const T vp_re = phase_mean(vr), vp_im = phase_mean(vi);
  const T ip_re = phase_mean(ir), ip_im = phase_mean(ij);
  const T vdc = y[6 * NPH + 0];
  const T xpll = y[6 * NPH + 3];
  const T theta = y[6 * NPH + 4];
  const T v_q = vp_re * (-sin_(theta)) + vp_im * cos_(theta);
  const T f_meas = (one + P(KP_PLL) * v_q) + xpll;
  T sp[NPH], sq[NPH];
#pragma unroll
  for (int k = 0; k < NPH; ++k) {
    sp[k] = cmul(Re{}, v_re[k], v_im[k], ii_re[k], -ii_im[k]);
    sq[k] = cmul(Im{}, v_re[k], v_im[k], ii_re[k], -ii_im[k]);
  }
  const T p_pcc = phase_mean(sp);
  const T q_pcc = phase_mean(sq);

  // pv_power with prep's iph, gamma / T_cell and one / S_rated
  const T one_en = one + zero * (conn * (one - U(CES)));
  const T t_cell = U(T_CELL), s_irr = U(S_IRR);
  const T iph = (P(ISC_REF) + P(KI_T) * (t_cell - lit<T>(T_REF)))
                * (s_irr * inv_1000);
  const T vdc_v = vdc * P(VDC_BASE);
  const T ex = (P(GAMMA) / t_cell) * vdc_v;
  const T i_arr = clamp_min(P(NP_PAR) * (iph - P(IRS) * (exp_t(ex) - one)),
                            zero);
  const T p_pv = (i_arr * vdc_v) * (one_en / P(S_RATED));

  // rhs_core.neg_seq of the PCC voltage
  T u2_re, u2_im;
  if (NPH == 1) {
    u2_re = v_re[0] * zero;
    u2_im = v_im[0] * zero;
  } else {
    T nr[NPH], ni[NPH];
#pragma unroll
    for (int k = 0; k < NPH; ++k) {
      nr[k] = cmul(Re{}, v_re[k], v_im[k], ak_re[k], ak_im[k]);
      ni[k] = cmul(Im{}, v_re[k], v_im[k], ak_re[k], ak_im[k]);
    }
    u2_re = phase_mean(nr);
    u2_im = phase_mean(ni);
  }

  // --- ride_through.rt_update ---------------------------------------------
  const T v_mag = hypot_(vp_re, vp_im);
  const bool in_zone[ZONES] = {v_mag < c[cVLv1], v_mag < c[cVLv2],
                               v_mag > c[cVHv1], v_mag > c[cVHv2],
                               f_meas < c[cFLf], f_meas > c[cFHf]};
  T trip = zero, ces = zero;
#pragma unroll
  for (int k = 0; k < ZONES; ++k) {
    const T z = (in_zone[k] ? one : zero) * a.enable[k];
    tm[k] = (tm[k] + c[cDt]) * z;
    trip = max_t(trip, tm[k] > a.t_lim[k] ? one : zero);
    if (k == 1) ces = z;
  }
  const T tripped0 = a.tripped[e];
  const T tripped = maximum(tripped0, trip);
  const T trip_now = tripped * (one - tripped0);

  // --- outputs -------------------------------------------------------------
  const int t_step = a.t_step[e] + 1;
  const T vdc_ref = U(VDC_REF), q_ref = U(Q_REF);
  obs[0] = ip_re;
  obs[1] = ip_im;
  obs[2] = vp_re;
  obs[3] = vp_im;
  obs[4] = vdc;
  obs[5] = p_pcc;
  obs[6] = q_pcc;
  obs[7] = vdc_ref;
  obs[8] = q_ref;
  obs[9] = s_irr * inv_1000;
  obs[10] = (f_meas - one) * lit<T>(10.0);
  obs[11] = static_cast<T>(t_step) * (one / static_cast<T>(a.horizon));
  obs[12] = one - tripped;

  // _reward, then the anomaly terms
  const T band = clamp_min(v_mag - lit<T>(1.05), zero)
                 + clamp_min(lit<T>(0.95) - v_mag, zero);
  T reward = c[cRAlive] - abs_(vdc - vdc_ref) * c[cWVdc];
  reward = reward - abs_(q_pcc - q_ref) * c[cWQ];
  reward = reward - band * c[cWVband];
  reward = reward - trip_now * c[cRTrip];
  if (a.flag != nullptr) {   // _anomaly_active
    const bool dev = abs_(U(V_G) - one) > lit<T>(1e-6)
                     || U(V_G2) > lit<T>(1e-9) || abs_(U(DW_G)) > lit<T>(1e-9)
                     || abs_(s_irr - a.s0[e]) > lit<T>(1e-3)
                     || U(G_LOAD) > lit<T>(1e-9)
                     || abs_(U(B_LOAD)) > lit<T>(1e-9);
    const T anom = dev ? one : zero;
    const T flag = a.flag[e];
    reward = reward + (flag * (anom * c[cRAnomTp] - (one - anom) * c[cRAnomFp])
                       - ((one - flag) * anom) * c[cRAnomFn]);
  }
  const bool terminated = tripped > lit<T>(0.5);
  const bool truncated = t_step >= a.horizon;

  a.reward[e] = reward;
  a.done[e] = terminated || truncated;
  a.terminated[e] = terminated;
  a.truncated[e] = truncated;
  a.t_step_o[e] = t_step;
  a.tripped_o[e] = tripped;
  a.ces[e] = ces;
  a.v_mag[e] = v_mag;
  a.f_meas[e] = f_meas;
  a.v_unb[e] = hypot_(u2_re, u2_im);
  a.p_pcc[e] = p_pcc;
  a.q_pcc[e] = q_pcc;
  a.p_pv[e] = p_pv;
  a.trip_now[e] = trip_now;
}

template <typename T, int NPH>
__global__ void __launch_bounds__(BLOCK) post_window_kernel(const Args<T> a,
                                                            int n) {
  constexpr int NS = 6 * NPH + 5;
  constexpr int W = NS > OBS ? NS : OBS;
  __shared__ T rows[BLOCK * W];       // y1 rows in, then obs rows out
  __shared__ T zones[BLOCK * ZONES];  // timers in and out
  const size_t e0 = static_cast<size_t>(blockIdx.x) * BLOCK;
  const int m = min(BLOCK, static_cast<int>(n - e0));
  const int i = threadIdx.x;
  for (int k = i; k < m * NS; k += BLOCK) rows[k] = a.y[e0 * NS + k];
  for (int k = i; k < m * ZONES; k += BLOCK) {
    zones[k] = a.timers[e0 * ZONES + k];
  }
  __syncthreads();
  T y[NS], tm[ZONES];
  if (i < m) {
#pragma unroll
    for (int j = 0; j < NS; ++j) y[j] = rows[i * NS + j];
#pragma unroll
    for (int j = 0; j < ZONES; ++j) tm[j] = zones[i * ZONES + j];
  }
  __syncthreads();
  if (i < m) {
    step_env<T, NPH>(a, e0 + i, static_cast<size_t>(n), y, tm, rows + i * OBS);
#pragma unroll
    for (int j = 0; j < ZONES; ++j) zones[i * ZONES + j] = tm[j];
  }
  __syncthreads();
  for (int k = i; k < m * OBS; k += BLOCK) a.obs[e0 * OBS + k] = rows[k];
  for (int k = i; k < m * ZONES; k += BLOCK) {
    a.timers_o[e0 * ZONES + k] = zones[k];
  }
}

template <typename T>
Args<T> make_args(const void* const* in, void* const* out, const double* c,
                  int horizon) {
  Args<T> a;
  auto I = [&](int k) { return static_cast<const T*>(in[k]); };
  auto O = [&](int k) { return static_cast<T*>(out[k]); };
  auto B = [&](int k) { return static_cast<unsigned char*>(out[k]); };
  a.y = I(kY); a.t = I(kT);
  a.t_step = static_cast<const int*>(in[kTStep]);
  a.p = I(kP); a.u = I(kU); a.timers = I(kTimers); a.tripped = I(kTripped);
  a.t_lim = I(kTLim); a.enable = I(kEnable); a.flag = I(kFlag);
  a.s0 = I(kS0);
  a.obs = O(oObs); a.reward = O(oReward);
  a.done = B(oDone); a.terminated = B(oTerminated);
  a.truncated = B(oTruncated);
  a.t_step_o = static_cast<int*>(out[oTStep]);
  a.timers_o = O(oTimers); a.tripped_o = O(oTripped); a.ces = O(oCes);
  a.v_mag = O(oVMag); a.f_meas = O(oFMeas); a.v_unb = O(oVUnb);
  a.p_pcc = O(oPPcc); a.q_pcc = O(oQPcc); a.p_pv = O(oPPv);
  a.trip_now = O(oTripNow);
  for (int k = 0; k < kNumConst; ++k) a.c[k] = static_cast<T>(c[k]);
  a.horizon = horizon;
  return a;
}

template <typename T>
int launch(const void* in, const void* out, const double* c, int n,
           int n_ph, int horizon, cudaStream_t s) {
  const auto a = make_args<T>(static_cast<const void* const*>(in),
                              static_cast<void* const*>(out), c, horizon);
  if ((a.flag == nullptr) != (a.s0 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + BLOCK - 1) / BLOCK), block(BLOCK);
  if (n_ph == 1) {
    post_window_kernel<T, 1><<<grid, block, 0, s>>>(a, n);
  } else if (n_ph == 3) {
    post_window_kernel<T, 3><<<grid, block, 0, s>>>(a, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: kNumIn pointers (flag and s0 both null without the anomaly reward,
// or both set), out: kNumOut pointers, consts: kNumConst doubles; horizon:
// the episode length in steps; dtype 0 float32, 1 float64
extern "C" int pvderx_post_window(const void* in, const void* out,
                                  const void* consts, int n, int n_ph,
                                  int horizon, int dtype, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto c = static_cast<const double*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, out, c, n, n_ph, horizon, s);
  if (dtype == 1) return launch<double>(in, out, c, n, n_ph, horizon, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
