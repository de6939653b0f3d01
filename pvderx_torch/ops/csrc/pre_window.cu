// The env step's pre-window glue in one pass over the envs (sm_90a).
//
// Replaces no TPU kernel. The reference runs its step under jit, where XLA
// fuses the glue before the window (pvderx/env/core.py's step: the action's
// setpoint nudges, the event-table lookups and the supervisory layer) into
// a few loops. The port's eager version (pvderx_torch/env/core.py:
// `_pre_window_plain`, then `pack_struct(exog, U_FIELDS)`) is ~45 launches
// a step, each reading and writing whole [N] or [N, K] columns. This kernel
// computes the same in one launch, one thread per env, and writes the exog
// straight into the [15, N] pack the window kernels read.
//
// What bounds it on this card: bytes. An env reads its three event tables
// ([4, 3], [4, 6] and [2, 3]: 42 values), t_step, q_ref, vdc_ref, the trip
// latch, the cessation flag and its action, and writes the 15 rows of the
// exog pack and t: 260 B in float32 with discrete actions
// (pvderx_torch/ops/pre_window.py: pre_window_bytes). Its ~60 compares,
// adds and products are far below what the SMs issue in that time. With
// Volt-VAR or MPPT it also reads y and 11 rows of the params pack, and
// computes the algebra at the window start (2-4 sin/cos, one exp).
//
// What the design does about it: one thread per env, 128 envs a block. The
// row-major leaves (the tables [N, K, D], and y [N, n_s] where the
// supervisory layer reads it) go through shared memory as one flat run per
// block, neighbouring threads on neighbouring words, each env's row at an
// odd stride so that the threads' reads meet no bank conflict; the packs
// are field-major and the other leaves [N] columns, read and written
// directly, so every access is coalesced. Every output is a fresh tensor:
// no input is written. With Volt-VAR and a counter slot (`active`, else
// null), each block counts its envs whose setpoint the curve moved off 0
// (`__syncthreads_count`) and adds them to the slot with one atomic; the
// kernels without the supervisory layer have no such code.
//
// Bitwise equality with the eager version on the card (glue.cuh):
// - this file is compiled without FMA contraction (-fmad=false), so each
//   + - * rounds once, in `_pre_window_plain`'s order;
// - a Python scalar is rounded once to T (the constants array, lit<T>);
// - `active_row`'s masked sum adds each row, or +0 where it is not the
//   active one, to +0 in row order, as torch's sum over K <= 4 rows does:
//   an active -0 reads +0, and a NaN or inf in another row does not leak;
// - p_ref is vdc_ref * 0, which passes a NaN through;
// - torch.clamp passes a NaN through; so does glue::clamp;
// - the algebra is post_window.cu's, over rhs.cuh's feeder and PCC
//   voltage pieces; at three phases torch orders the phase means by
//   layout, so the check allows a tolerance for the Volt-VAR setpoint
//   there.
//
// Layout: every leaf has the env axis leading and is contiguous; the packs
// are [fields, N]; t_step is int32; a discrete action is int64 [N], a
// continuous one T [N, 2]. Any table sizes K and any N >= 1: the last
// block masks the ragged edge.
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "glue.cuh"

namespace {

using pvderx::Feeder;
using pvderx::Im;
using pvderx::Re;
using pvderx::lit;

constexpr int BLOCK = 128;
constexpr int SOLAR = 3, GRID = 6, LOAD = 3;   // the tables' columns

// The order of the pointer and constant arrays that the entry takes, and
// the bits of its modes (pvderx_torch/ops/pre_window.py: IN_LEAVES,
// OUT_LEAVES, pre_window_constants, MODES).
enum In {
  kTStep, kQRef, kVdcRef, kTripped, kCes, kAction, kSolar, kGrid, kLoad, kY,
  kP, kPPrev, kDirection, kNumIn
};
enum Out { oU, oT, oFlag, oPPrev, oDirection, kNumOut };
enum Const {
  cDtCtrl, cDqAction, cDvAction, cQLo, cQHi, cVLo, cVHi, cQVv, cMpptDv,
  cMpptLo, cMpptHi, cMpptFloor, cVv0, cVv1, cVv2, cVv3, kNumConst
};
enum Mode { kContinuous = 1, kAnomaly = 2, kVoltvar = 4, kMppt = 8 };

template <typename T>
struct Args {
  const int* t_step;
  const T *q_ref, *vdc_ref, *tripped, *ces;
  const int64_t* action;   // discrete
  const T* action_c;       // continuous
  const T *solar, *grid, *load, *y, *p, *p_prev, *direction;
  T *u, *t, *flag, *p_prev_o, *direction_o;
  unsigned long long* active;   // Volt-VAR's count of moved setpoints
  T c[kNumConst];
  int ks, kg, kl, n_mppt, modes;
};

// Stage m rows of width w, contiguous from src, into shared memory at a
// row stride of w | 1 words (odd, so a warp reading one column of its rows
// meets no bank conflict); the block's threads copy neighbouring words.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int m,
                                           int w) {
  const int stride = w | 1;
  const int i = static_cast<int>(threadIdx.x);
  int row = i / w, col = i % w;
  const int drow = BLOCK / w, dcol = BLOCK % w;
  for (int k = i; k < m * w; k += BLOCK) {
    dst[row * stride + col] = src[k];
    row += drow;
    col += dcol;
    if (col >= w) {
      col -= w;
      ++row;
    }
  }
}

// active_row of one env's [k, D] table at t: the sum over its rows of the
// row where it is the last with t_k <= t, else +0
template <typename T, int D>
__device__ __forceinline__ void active_row(const T* tab, int k, T t,
                                           T (&row)[D]) {
  const T zero = lit<T>(0.0);
#pragma unroll
  for (int d = 0; d < D; ++d) row[d] = zero;
  bool le = k > 0 && tab[0] <= t;
  for (int r = 0; r < k; ++r) {
    const bool le_next = r + 1 < k && tab[(r + 1) * D] <= t;
    const bool last = le && !le_next;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      row[d] = row[d] + (last ? tab[r * D + d] : zero);
    }
    le = le_next;
  }
}

// scenario.mppt_voltvar.voltvar_qref: the droop curve through the knots
// c[cVv0..cVv3] and (q, 0, 0, -q), each segment in numpy.interp's formula
template <typename T>
__device__ __forceinline__ T voltvar_qref(T v, const T* c) {
  const T xp[4] = {c[cVv0], c[cVv1], c[cVv2], c[cVv3]};
  const T fp[4] = {c[cQVv], lit<T>(0.0), lit<T>(0.0), -c[cQVv]};
  T out = v < xp[0] ? fp[0] : fp[3];
#pragma unroll
  for (int i = 3; i >= 1; --i) {
    const T seg = fp[i - 1] + ((v - xp[i - 1]) / (xp[i] - xp[i - 1]))
                              * (fp[i] - fp[i - 1]);
    const bool hi_ok = i < 3 ? v < xp[i] : v <= xp[i];
    if (v >= xp[i - 1] && hi_ok) out = seg;
  }
  return out;
}

// What the supervisory layer reads of rhs_core.algebra at the window
// start t: |v_pos| of the PCC voltage (Volt-VAR) and the PV power (MPPT),
// in post_window.cu's order (prep_invariants computed inline); y is the
// env's state, P(field) / U(field) its params / exog
template <typename T, int N, class PF, class UF>
__device__ __forceinline__ void start_algebra(const T (&y)[6 * N + 5], T t,
                                              PF P, UF U, T& v_mag, T& p_pv) {
  using namespace pvderx;
  using namespace pvderx::glue;
  const T zero = lit<T>(0.0), one = lit<T>(1.0);
  T ak_re[N], ak_im[N];
  if (N == 3) {
    const T ang[3] = {zero, -lit<T>(TWO_PI_3), lit<T>(TWO_PI_3)};
#pragma unroll
    for (int k = 0; k < N; ++k) {
      ak_re[k] = cos_(ang[k]);
      ak_im[k] = sin_(ang[k]);
    }
  } else {
    ak_re[0] = one;   // a_k = 1: the single-phase pieces never read it
    ak_im[0] = zero;
  }
  Feeder<T, N> f;
  load_feeder(f, ak_re, ak_im, P, U);
  const T conn = U(CONN);
  const T phi = f.phi_g + f.wdw * (t - f.t_g);   // grid_rot
  const T rot_re = cos_(phi), rot_im = sin_(phi);
  T ii_re[N], ii_im[N], v_re[N], v_im[N], vr[N], vi[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    ii_re[k] = y[k] * conn;
    ii_im[k] = y[N + k] * conn;
  }
  pcc_voltage(ii_re, ii_im, rot_re, rot_im, f, ak_re, ak_im, v_re, v_im);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    vr[k] = pos_term(Re{}, k, v_re, v_im, ak_re, ak_im);
    vi[k] = pos_term(Im{}, k, v_re, v_im, ak_re, ak_im);
  }
  v_mag = hypot_(phase_mean(vr), phase_mean(vi));

  // pv_power with prep's iph, gamma / T_cell and one / S_rated
  const T one_en = one + zero * (conn * (one - U(CES)));
  const T t_cell = U(T_CELL), s_irr = U(S_IRR);
  const T iph = (P(ISC_REF) + P(KI_T) * (t_cell - lit<T>(T_REF)))
                * (s_irr * (one / lit<T>(1000.0)));
  const T vdc_v = y[6 * N] * P(VDC_BASE);
  const T ex = (P(GAMMA) / t_cell) * vdc_v;
  const T i_arr = clamp_min(P(NP_PAR) * (iph - P(IRS) * (exp_t(ex) - one)),
                            zero);
  p_pv = (i_arr * vdc_v) * (one_en / P(S_RATED));
}

// `_pre_window_plain` of env e: its tables' rows and (with SUP) its state
// y in shared memory. Returns whether Volt-VAR set a q_ref other than 0.
template <typename T, int NPH, bool SUP>
__device__ __forceinline__ bool step_env(const Args<T>& a, size_t e,
                                         size_t n, const T* solar,
                                         const T* grid, const T* load,
                                         const T* ys) {
  using namespace pvderx;
  using namespace pvderx::glue;
  const T* c = a.c;
  const T zero = lit<T>(0.0), one = lit<T>(1.0);
  const int t_step = a.t_step[e];
  const T t = static_cast<T>(t_step) * c[cDtCtrl];

  // 1. the agent's action -> setpoint nudges
  T q_ref = a.q_ref[e], vdc_ref = a.vdc_ref[e], dq, dv;
  if (a.modes & kContinuous) {
    dq = glue::clamp(a.action_c[2 * e], -one, one) * c[cDqAction];
    dv = glue::clamp(a.action_c[2 * e + 1], -one, one) * c[cDvAction];
  } else {
    const int64_t act = a.action[e];
    dq = ((act == 1 ? one : zero) - (act == 2 ? one : zero)) * c[cDqAction];
    dv = ((act == 3 ? one : zero) - (act == 4 ? one : zero)) * c[cDvAction];
    if (a.modes & kAnomaly) a.flag[e] = act == 5 ? one : zero;
  }
  if (!(a.modes & kVoltvar)) q_ref = glue::clamp(q_ref + dq, c[cQLo], c[cQHi]);
  if (!(a.modes & kMppt)) {
    vdc_ref = glue::clamp(vdc_ref + dv, c[cVLo], c[cVHi]);
  }

  // 2. make_exog at the window start, in U_FIELDS order
  T s[SOLAR], g[GRID], l[LOAD];
  active_row(solar, a.ks, t, s);
  active_row(grid, a.kg, t, g);
  active_row(load, a.kl, t, l);
  T u[N_UFIELDS] = {s[1], s[2], g[1], g[2], g[3], g[0], g[4], g[5], l[1],
                    l[2], vdc_ref, q_ref, one - a.tripped[e], a.ces[e],
                    vdc_ref * zero};

  // the supervisory layer on the algebra at the window start
  bool moved = false;
  if (SUP) {
    T y[6 * NPH + 5];
#pragma unroll
    for (int j = 0; j < 6 * NPH + 5; ++j) y[j] = ys[j];
    const auto P = [&](int k) { return a.p[k * n + e]; };   // params row k
    const auto U = [&](int k) { return u[k]; };
    T v_mag, p_pv;
    start_algebra<T, NPH>(y, t, P, U, v_mag, p_pv);
    if (a.modes & kVoltvar) {
      u[Q_REF] = voltvar_qref(v_mag, c);
      moved = u[Q_REF] != zero;
    }
    if (a.modes & kMppt) {   // mppt_update
      int r = t_step % a.n_mppt;   // torch's remainder: the divisor's sign
      if (r != 0 && ((r < 0) != (a.n_mppt < 0))) r += a.n_mppt;
      const T active = r == 0 ? one : zero;
      const T p_prev = a.p_prev[e], dir = a.direction[e];
      const T new_dir = p_pv - p_prev >= c[cMpptFloor] ? dir : -dir;
      const T vdc_new = glue::clamp(vdc_ref + c[cMpptDv] * new_dir,
                                    c[cMpptLo], c[cMpptHi]);
      a.p_prev_o[e] = p_prev + active * (p_pv - p_prev);
      a.direction_o[e] = dir + active * (new_dir - dir);
      u[VDC_REF] = vdc_ref + active * (vdc_new - vdc_ref);
    }
  }
#pragma unroll
  for (int k = 0; k < N_UFIELDS; ++k) a.u[k * n + e] = u[k];
  a.t[e] = t;
  return moved;
}

template <typename T, int NPH, bool SUP>
__global__ void __launch_bounds__(BLOCK) pre_window_kernel(const Args<T> a,
                                                           int n) {
  constexpr int NS = 6 * NPH + 5;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ws = SOLAR * a.ks, wg = GRID * a.kg, wl = LOAD * a.kl;
  T* const solar = reinterpret_cast<T*>(smem);
  T* const grid = solar + BLOCK * (ws | 1);
  T* const load = grid + BLOCK * (wg | 1);
  T* const ys = load + BLOCK * (wl | 1);   // with SUP: y's rows
  const size_t e0 = static_cast<size_t>(blockIdx.x) * BLOCK;
  const int m = min(BLOCK, static_cast<int>(n - e0));
  stage_rows(solar, a.solar + e0 * ws, m, ws);
  stage_rows(grid, a.grid + e0 * wg, m, wg);
  stage_rows(load, a.load + e0 * wl, m, wl);
  if (SUP) stage_rows(ys, a.y + e0 * NS, m, NS);
  __syncthreads();
  const int i = threadIdx.x;
  bool moved = false;
  if (i < m) {
    moved = step_env<T, NPH, SUP>(a, e0 + i, static_cast<size_t>(n),
                                  solar + i * (ws | 1), grid + i * (wg | 1),
                                  load + i * (wl | 1), ys + i * (NS | 1));
  }
  if constexpr (SUP) {   // every thread of the block reaches the count
    const int k = __syncthreads_count(moved);
    if (threadIdx.x == 0 && a.active != nullptr && k > 0) {
      atomicAdd(a.active, static_cast<unsigned long long>(k));
    }
  }
}

template <typename T, int NPH, bool SUP>
int launch_kernel(const Args<T>& a, int n, cudaStream_t s) {
  const int rows = (SOLAR * a.ks | 1) + (GRID * a.kg | 1) + (LOAD * a.kl | 1)
                   + (SUP ? (6 * NPH + 5) | 1 : 0);
  const size_t bytes = static_cast<size_t>(BLOCK) * rows * sizeof(T);
  if (bytes > 48 * 1024) {   // large tables: above the default block limit
    const cudaError_t err = cudaFuncSetAttribute(
        pre_window_kernel<T, NPH, SUP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + BLOCK - 1) / BLOCK), block(BLOCK);
  pre_window_kernel<T, NPH, SUP><<<grid, block, bytes, s>>>(a, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* const* in, void* const* out, const double* c,
           unsigned long long* active, int n, int n_ph, int ks, int kg,
           int kl, int n_mppt, int modes, cudaStream_t s) {
  Args<T> a;
  auto I = [&](int k) { return static_cast<const T*>(in[k]); };
  auto O = [&](int k) { return static_cast<T*>(out[k]); };
  a.t_step = static_cast<const int*>(in[kTStep]);
  a.q_ref = I(kQRef); a.vdc_ref = I(kVdcRef); a.tripped = I(kTripped);
  a.ces = I(kCes);
  a.action = static_cast<const int64_t*>(in[kAction]);
  a.action_c = I(kAction);
  a.solar = I(kSolar); a.grid = I(kGrid); a.load = I(kLoad); a.y = I(kY);
  a.p = I(kP); a.p_prev = I(kPPrev); a.direction = I(kDirection);
  a.u = O(oU); a.t = O(oT); a.flag = O(oFlag); a.p_prev_o = O(oPPrev);
  a.direction_o = O(oDirection);
  a.active = active;
  for (int k = 0; k < kNumConst; ++k) a.c[k] = static_cast<T>(c[k]);
  a.ks = ks; a.kg = kg; a.kl = kl;
  a.n_mppt = n_mppt;
  a.modes = modes;
  const bool sup = modes & (kVoltvar | kMppt);
  const bool mppt = modes & kMppt;
  if (a.ks < 1 || a.kg < 1 || a.kl < 1 || (mppt && n_mppt == 0)
      || ((modes & kContinuous) && (modes & kAnomaly))
      || ((a.flag == nullptr) == bool(modes & kAnomaly))
      || ((a.y == nullptr || a.p == nullptr) == sup)
      || (active != nullptr && !(modes & kVoltvar))
      || ((a.p_prev == nullptr || a.direction == nullptr
           || a.p_prev_o == nullptr || a.direction_o == nullptr) == mppt)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_ph == 1) {
    return sup ? launch_kernel<T, 1, true>(a, n, s)
               : launch_kernel<T, 1, false>(a, n, s);
  }
  if (n_ph == 3) {
    return sup ? launch_kernel<T, 3, true>(a, n, s)
               : launch_kernel<T, 3, false>(a, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// in: kNumIn pointers (y and p null without Volt-VAR or MPPT; p_prev and
// direction null without MPPT), out: kNumOut pointers (flag null without
// the anomaly flag; p_prev and direction null without MPPT), consts:
// kNumConst doubles; active: with Volt-VAR, a uint64 slot to which the
// kernel adds the envs whose q_ref it set off 0, or null; ks, kg, kl: the
// row counts of the solar, grid and load tables; n_mppt: the MPPT period
// in steps; modes: the bits of Mode; dtype 0 float32, 1 float64
extern "C" int pvderx_pre_window(const void* in, const void* out,
                                 const void* consts, void* active, int n,
                                 int n_ph, int ks, int kg, int kl,
                                 int n_mppt, int modes, int dtype,
                                 void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto i = static_cast<const void* const*>(in);
  auto o = static_cast<void* const*>(out);
  auto c = static_cast<const double*>(consts);
  auto v = static_cast<unsigned long long*>(active);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(i, o, c, v, n, n_ph, ks, kg, kl, n_mppt, modes, s);
  }
  if (dtype == 1) {
    return launch<double>(i, o, c, v, n, n_ph, ks, kg, kl, n_mppt, modes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
