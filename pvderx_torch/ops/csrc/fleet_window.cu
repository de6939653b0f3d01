// Fused RK4 control-window integrator for M DERs on a shared feeder, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel pvderx/ops/window.py::_fleet_window_kernel (called
// by pvderx.ops.window.rk4_fleet_window_batch). For every env it integrates
// one control window of its M units: n_sub classical RK4 substeps in which
// every RHS evaluation couples the units through the PCC voltage of their
// shared feeder, set by the mean over the M units of conn*i (rhs_core's
// pcc_voltage), after which each unit runs rhs_given_v (rhs.cuh).
//
// What bounds it on this card: instruction issue, as the single-DER window
// (window.cu): ~923 operations per unit per substep (1-phase) against
// 4*(1 + M*(2*n_s + 29 + 15)) bytes per env per window. At BASELINE config
// 5 (4096 envs x 16 units, 15.5 warps per SM) the stages written out with
// powf and two divides per RHS ran under the time the SMs need to issue
// their static substep loop (3014 SASS instructions; some of it, the
// M > 32 path and the slow paths, does not run), so only fewer
// instructions move it (PERF.md).
//
// What the design does about it: one thread per (env, unit), so a thread
// keeps the single-DER kernel's register footprint (one unit's state, Kahan
// carry, accumulator and Prep) and the window runs without touching device
// memory; and it issues fewer instructions per unit (2515 per substep, was
// 3014):
// - The grid phasors, the same for every unit of an env, are computed once
//   per env: the lanes of an env's group take the substeps in turns (below),
//   2 sincosf per lane per g substeps instead of 2 per substep.
// - The soft limiters' x^(-1/16) is exp2f and log2f, not powf (rhs.cuh's
//   pow_sat), and the mean injection multiplies the sum by a hoisted 1/M
//   (exact when M is a power of two) instead of two divides.
// - Each unit's RHS reads the window constants K1 folds once a window
//   (rhs_f32.cuh), the mean injection in place of the DER's own.
// The units of one env sit in adjacent lanes: a group of G lanes, G
// the next power of two >= M (G <= 32), so the M-sum of the 2*n_ph injected
// current components is a __shfl_xor_sync butterfly inside the warp. When
// M > 32 an env spans W = ceil(M/32) warps: each warp reduces by butterfly,
// lane 0 of each warp puts its partial in shared memory, and every thread
// adds the W partials in warp order. Padded lanes (unit >= M) and lanes past
// the last env compute on a clamped index, add 0 to the sums and store
// nothing; no thread returns early, because every lane of a warp takes part
// in each shuffle. The reduction order depends only on M, not on the block
// shape, and the xor butterfly gives every lane the same sum bit for bit.
//
// The phasors of an env spanning W warps are computed by each warp for
// itself (g = 32). A table of the window's 2*n_sub+1 phasors in shared
// memory, filled once by the env's W*32 threads, would save each thread at
// most ~2 sincosf per window (of ~64 substeps x 4 RHS evaluations), under
// the timing's spread, for a barrier and a cap on n_sub; it was not built.
//
// The feeder's fields (rg, xg, w_base, g_load, b_load, v_g, phi_g, dw_g, t_g,
// v_g2, phi_g2) are read from unit 0 of the env by every thread of its
// group; t0 is per env.
//
// Layout: y and y1 are [N, M, n_s] row-major; t0 is [N]; p and u are
// field-major [29, N, M] and [15, N, M] (neighbouring threads read
// neighbouring addresses). Any N >= 1; 1 <= M <= 1024 (one block per env at
// most).
#include "rhs_f32.cuh"

namespace {

using namespace pvderx;

constexpr int MAX_UNITS = 1024;

// Sum K values over the threads of one env: a butterfly over the g lanes of
// a group, then (w > 1 warps per env) the w warp partials through shared
// memory `part`, added in warp order. Every thread of the env gets the sum.
template <int K>
__device__ __forceinline__ void group_sum(float (&v)[K], int g, int w,
                                          float* part, int slot, int warp,
                                          int lane) {
  for (int off = g >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
  if (w > 1) {
    float* mine = part + static_cast<size_t>(slot) * w * K;
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) mine[warp * K + k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = mine[k];
      for (int j = 1; j < w; ++j) s += mine[j * K + k];
      v[k] = s;
    }
    __syncthreads();
  }
}

template <int N, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
fleet_window_kernel(const float* __restrict__ y_in,
                    const float* __restrict__ t0_in,
                    const float* __restrict__ p, const float* __restrict__ u,
                    float* __restrict__ y_out, int n, int m, int g, int w,
                    int n_sub, float h, float hh, float h6) {
  extern __shared__ float part[];   // [envs per block][w][2N], used if w > 1
  constexpr int NS = 6 * N + 5;
  const int tpe = g * w;                       // threads per env
  const int slot = threadIdx.x / tpe;          // env within the block
  const int unit = threadIdx.x - slot * tpe;
  const int e = blockIdx.x * (blockDim.x / tpe) + slot;
  const bool valid = unit < m && e < n;
  const int ec = min(e, n - 1), uc = min(unit, m - 1);
  const size_t nm = static_cast<size_t>(n) * m;
  const size_t cell = static_cast<size_t>(ec) * m + uc;
  const size_t cell0 = static_cast<size_t>(ec) * m;   // unit 0: the feeder
  auto P = [&](int f) { return p[f * nm + cell]; };
  auto U = [&](int f) { return u[f * nm + cell]; };
  auto P0 = [&](int f) { return p[f * nm + cell0]; };
  auto U0 = [&](int f) { return u[f * nm + cell0]; };

  Unit<float, N> wu;
  load_unit(wu, P, U);
  Feeder<float, N> fd;
  load_feeder_f32(fd, P0, U0);
  Folded<N> z;
  fold_window(z, wu, fd);
  const float share = valid ? z.conn : 0.0f;   // padded lanes add 0
  const float inv_m = 1.0f / static_cast<float>(m);   // exact for M = 2^k
  const int warp = unit >> 5, lane = threadIdx.x & 31;

  // the fleet RHS: PCC voltage from the M-mean injection, then this unit's
  // rhs_given_v
  auto rhs = [&](const float (&ys)[NS], float rot_re, float rot_im,
                 float (&dy)[NS]) {
    float s[2 * N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      s[k] = share * ys[k];
      s[N + k] = share * ys[N + k];
    }
    group_sum<2 * N>(s, g, w, part, slot, warp, lane);
    float ii_re[N], ii_im[N], v_re[N], v_im[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      ii_re[k] = s[k] * inv_m;
      ii_im[k] = s[N + k] * inv_m;
    }
    pcc_voltage(ii_re, ii_im, rot_re, rot_im, z, v_re, v_im);
    rhs_given_v(ys, v_re, v_im, z, dy);
  };

  // The grid phasors, once per env: the g lanes of a group (a warp's 32
  // when the env spans warps) take the substeps in turns. At each substep
  // s with s mod g = 0, lane j computes the pair of substep s + j (times by
  // rhs.cuh's stage_times, so the pair has the bits the lane that uses it
  // would compute); at substep s every lane takes the pair from lane
  // s mod g of its group. At M = 1 (g = 1) each lane computes its own.
  const float t0 = t0_in[ec];
  const int jl = threadIdx.x & (g - 1);
  float ph_re = 0.0f, ph_im = 0.0f, p4_re = 0.0f, p4_im = 0.0f;
  auto phasors = [&](int s, float& rh_re, float& rh_im, float& r4_re,
                     float& r4_im) {
    const int k = s & (g - 1);
    if (k == 0) {
      float th, t4;
      stage_times(t0, s + jl, h, hh, th, t4);
      grid_rot(th, fd, ph_re, ph_im);
      grid_rot(t4, fd, p4_re, p4_im);
    }
    rh_re = __shfl_sync(0xffffffffu, ph_re, k, g);
    rh_im = __shfl_sync(0xffffffffu, ph_im, k, g);
    r4_re = __shfl_sync(0xffffffffu, p4_re, k, g);
    r4_im = __shfl_sync(0xffffffffu, p4_im, k, g);
  };
  float r1_re, r1_im;
  grid_rot(t0, fd, r1_re, r1_im);

  float y[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) y[j] = y_in[cell * NS + j];
  rk4_window(y, r1_re, r1_im, n_sub, h, hh, h6, rhs, phasors);
  if (valid) {
#pragma unroll
    for (int j = 0; j < NS; ++j) y_out[cell * NS + j] = y[j];
  }
}

template <int N, int MAX_THREADS>
void launch(dim3 grid, dim3 block, size_t smem, cudaStream_t s,
            const float* y, const float* t0, const float* p, const float* u,
            float* out, int n, int m, int g, int w, int n_sub, float h,
            float hh, float h6) {
  fleet_window_kernel<N, MAX_THREADS><<<grid, block, smem, s>>>(
      y, t0, p, u, out, n, m, g, w, n_sub, h, hh, h6);
}

}  // namespace

extern "C" int pvderx_rk4_fleet_window(const void* y, const void* t0,
                                       const void* p, const void* u,
                                       void* out, int n, int m, int n_ph,
                                       int n_sub, float h, float hh, float h6,
                                       void* stream) {
  if (n < 1 || m < 1 || m > MAX_UNITS || n_sub < 1 || (n_ph != 1 && n_ph != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  int g = 1, w = 1;
  if (m <= 32) {
    while (g < m) g <<= 1;
  } else {
    g = 32;
    w = (m + 31) / 32;
  }
  const int tpe = g * w;
  const int envs_per_block = tpe >= 128 ? 1 : 128 / tpe;
  const int threads = tpe * envs_per_block;
  const dim3 grid((n + envs_per_block - 1) / envs_per_block), block(threads);
  const size_t smem = w > 1 ? sizeof(float) * envs_per_block * w * 2 * n_ph : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto yf = static_cast<const float*>(y);
  auto tf = static_cast<const float*>(t0);
  auto pf = static_cast<const float*>(p);
  auto uf = static_cast<const float*>(u);
  auto of = static_cast<float*>(out);
  const bool small = threads <= 256;
  if (n_ph == 1) {
    (small ? launch<1, 256> : launch<1, 1024>)(grid, block, smem, s, yf, tf, pf,
                                               uf, of, n, m, g, w, n_sub, h, hh, h6);
  } else {
    (small ? launch<3, 256> : launch<3, 1024>)(grid, block, smem, s, yf, tf, pf,
                                               uf, of, n, m, g, w, n_sub, h, hh, h6);
  }
  return static_cast<int>(cudaGetLastError());
}
