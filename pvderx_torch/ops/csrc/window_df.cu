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
// What bounds it on this card: arithmetic, by far. One substep is ~28.8k
// operations per env for the single-phase model (52.7k three-phase) as the
// reference counts its program (Dekker two-products; the fmaf two-product
// used here does fewer), against ~360 bytes per env per window. At n_sub =
// 64 that is ~5000 operations per byte.
//
// What the design does about it: what K1 (window.cu) does, in df. One thread
// per env keeps its 2*n_s state halves, the RK4 stage and accumulator and the
// window-invariant Prep in registers (the 3-phase instantiation spills) and
// runs all n_sub substeps without touching device memory: one pass over
// device memory per window. The grid phasor is computed twice per substep
// (k2 and k3 share the half-point, k4's is the next substep's k1) and one
// reduction gives each phasor's sin and cos. Occupancy and register work
// are left for a later change.
//
// Layout: y_hi, y_lo and the outputs are [N, n_s] row-major; t0 is [N]; p and
// u are field-major [29, N] and [15, N]. Any N >= 1: the last block masks
// the ragged edge.
#include "rhs.cuh"

namespace {

using namespace pvderx;

constexpr int BLOCK = 64;

template <int N>
__global__ void __launch_bounds__(BLOCK)
window_df_kernel(const float* __restrict__ y_hi, const float* __restrict__ y_lo,
                 const float* __restrict__ t0_in, const float* __restrict__ p,
                 const float* __restrict__ u, float* __restrict__ out_hi,
                 float* __restrict__ out_lo, int n, int n_sub, float h_hi,
                 float h_lo) {
  constexpr int NS = 6 * N + 5;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  auto P = [&](int f) { return p[static_cast<size_t>(f) * n + e]; };
  auto U = [&](int f) { return u[static_cast<size_t>(f) * n + e]; };

  Unit<df, N> w;
  load_unit(w, P, U);
  Feeder<df, N> fd;
  load_feeder(fd, w.ak_re, w.ak_im, P, U);

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

  df y[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const size_t i = static_cast<size_t>(e) * NS + j;
    y[j] = df(y_hi[i], y_lo[i]);
  }
  const df t0(t0_in[e]);
  const df h(h_hi, h_lo);
  const df hh = h * lit<df>(0.5);
  const df h6 = h * lit<df>(1.0 / 6.0);
  df r1_re, r1_im;
  grid_rot(t0, fd, r1_re, r1_im);

  for (int s = 0; s < n_sub; ++s) {
    const df t = t0 + h * df(static_cast<float>(s));
    df rh_re, rh_im, r4_re, r4_im;
    grid_rot(t + hh, fd, rh_re, rh_im);
    grid_rot(t + h, fd, r4_re, r4_im);
    df acc[NS], ys[NS], kv[NS];
    rhs(y, r1_re, r1_im, kv);                            // k1
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      acc[j] = kv[j];
      ys[j] = y[j] + hh * kv[j];
    }
    rhs(ys, rh_re, rh_im, kv);                           // k2
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      acc[j] = acc[j] + lit<df>(2.0) * kv[j];
      ys[j] = y[j] + hh * kv[j];
    }
    rhs(ys, rh_re, rh_im, kv);                           // k3
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      acc[j] = acc[j] + lit<df>(2.0) * kv[j];
      ys[j] = y[j] + h * kv[j];
    }
    rhs(ys, r4_re, r4_im, kv);                           // k4
#pragma unroll
    for (int j = 0; j < NS; ++j) y[j] = y[j] + h6 * (acc[j] + kv[j]);
    r1_re = r4_re;
    r1_im = r4_im;
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const size_t i = static_cast<size_t>(e) * NS + j;
    out_hi[i] = y[j].hi;
    out_lo[i] = y[j].lo;
  }
}

}  // namespace

extern "C" int pvderx_rk4_window_df(const void* y_hi, const void* y_lo,
                                    const void* t0, const void* p,
                                    const void* u, void* out_hi, void* out_lo,
                                    int n, int n_ph, int n_sub, float h_hi,
                                    float h_lo, void* stream) {
  if (n < 1 || n_sub < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BLOCK - 1) / BLOCK), block(BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto yh = static_cast<const float*>(y_hi);
  auto yl = static_cast<const float*>(y_lo);
  auto tf = static_cast<const float*>(t0);
  auto pf = static_cast<const float*>(p);
  auto uf = static_cast<const float*>(u);
  auto oh = static_cast<float*>(out_hi);
  auto ol = static_cast<float*>(out_lo);
  if (n_ph == 1) {
    window_df_kernel<1><<<grid, block, 0, s>>>(yh, yl, tf, pf, uf, oh, ol, n,
                                               n_sub, h_hi, h_lo);
  } else if (n_ph == 3) {
    window_df_kernel<3><<<grid, block, 0, s>>>(yh, yl, tf, pf, uf, oh, ol, n,
                                               n_sub, h_hi, h_lo);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
