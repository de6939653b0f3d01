// Fused RK4 control-window integrator for Hopper (sm_90a).
//
// Replaces the TPU kernel pvderx/ops/window.py::_window_kernel (called by
// pvderx.ops.window.rk4_window_batch). For every env it integrates one
// control window: n_sub classical RK4 substeps of the PV-DER right-hand side
// (rhs_f32.cuh over rhs.cuh, restating pvderx_torch/physics/rhs_core.py),
// exog held constant over the window.
//
// What bounds it on this card: instruction issue, and at three phases the
// latency of its dependent chains as well. One substep is ~923 operations
// per env at one phase (2371 at three) -- 4 RHS evaluations with sin/cos/exp,
// the soft limiters' x^(-1/16), square roots and a divide, 2 grid rotations,
// the Kahan combine -- while the whole window moves ~268 bytes per env (one
// read of t0, y, p_pack[29], u_pack[15] and one write of y1, all f32). At
// 2097152 envs each of the 528 warp schedulers runs 124 of the grid's
// warps. At one phase (109 registers, 18 warps an SM) a warp-substep takes
// ~1480 cycles for its 1648 static SASS instructions: about one issued a
// cycle, the rest branches that do not run (sincosf's large-argument
// path). At three phases (160 registers, 12 warps an SM, 3 a scheduler) it
// takes ~2910 cycles for 2616, 1.11x: latency that three warps cannot hide
// (PERF.md).
//
// What the design does about it: one thread per env holds its 11 (or 23)
// states, the Kahan carry, the RK4 accumulator and the window's constants in
// registers, and runs all n_sub substeps without touching device memory.
// The substep issues only what changes in it: a prologue folds every
// window-invariant quantity once (rhs_f32.cuh's fold_window: constant
// three-phase rotators with no products at phase 0, the phase means' 1/N in
// the gains in place of five IEEE divides an RHS, the PCC voltage as
// rot*cg_k + ii*iyt, no product of constants in the rates), which cut a
// substep from 1712 SASS instructions to 1648 at one phase and from 3186 to
// 2616 at three, and K1's time by 3.4% and 21%. A shorter chain: the soft
// limiters' x^(-1/16) is exp2f and log2f, not powf's ~50-instruction
// sequence (rhs.cuh's pow_sat). The RK4 stages are unrolled (rhs.cuh's
// rk4_window). Two layouts were measured and dropped (PERF.md):
// the stages rolled into a loop, 8% slower at one phase; a two-lane team
// per env (lane 0 the re component of every piece, lane 1 the im one, as
// the df32 window's three-phase kernel), which runs 1.43x (one phase) and
// 1.33x (three) the instructions per env and was 7% and 40% slower.
//
// Layout: y and y1 are [N, n_s] row-major; t0 is [N]; p and u are
// field-major [29, N] and [15, N] (neighbouring threads read neighbouring
// addresses). Any N >= 1: the last block masks the ragged edge.
#include "rhs_f32.cuh"

namespace {

using namespace pvderx;

constexpr int BLOCK = 64;

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

  Unit<float, N> w;
  load_unit(w, P, U);
  Feeder<float, N> fd;
  load_feeder_f32(fd, P, U);
  Folded<N> z;
  fold_window(z, w, fd);

  // rhs_core.rhs: the DER's own injection sets its PCC voltage
  auto rhs = [&](const float (&ys)[NS], float rot_re, float rot_im,
                 float (&dy)[NS]) {
    float ii_re[N], ii_im[N], v_re[N], v_im[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      ii_re[k] = ys[k] * z.conn;
      ii_im[k] = ys[N + k] * z.conn;
    }
    pcc_voltage(ii_re, ii_im, rot_re, rot_im, z, v_re, v_im);
    rhs_given_v(ys, v_re, v_im, z, dy);
  };

  const float t0 = t0_in[e];
  auto phasors = [&](int s, float& rh_re, float& rh_im, float& r4_re,
                     float& r4_im) {
    float th, t4;
    stage_times(t0, s, h, hh, th, t4);
    grid_rot(th, fd, rh_re, rh_im);
    grid_rot(t4, fd, r4_re, r4_im);
  };
  float r1_re, r1_im;
  grid_rot(t0, fd, r1_re, r1_im);

  float y[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) y[j] = y_in[static_cast<size_t>(e) * NS + j];
  rk4_window(y, r1_re, r1_im, n_sub, h, hh, h6, rhs, phasors);
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
