// Pieces shared by the env step's glue kernels (pre_window.cu,
// post_window.cu): torch's one-operation semantics on one thread.
//
// Both sources are compiled without FMA contraction (-fmad=false:
// pvderx_torch/ops/_build.py, SOURCE_FLAGS), so each + - * rounds once, as
// in torch's one-operation kernels; the transcendentals are those torch's
// CUDA kernels call (sin, cos, exp, hypot of T); a Python scalar is rounded
// once to T (lit<T>).
//
// Each kernel writes its algebra out inline: as one shared function
// returning a struct, post_window_kernel<float, 1> took 55 registers in
// place of 48 and 2.8% longer (H100, CUDA 12.8), though its bits were the
// same.
#pragma once

#include <cmath>
#include <cuda_runtime.h>

#include "rhs.cuh"

namespace pvderx {
namespace glue {

__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float hypot_(float a, float b) {
  return hypotf(a, b);
}
__device__ __forceinline__ double hypot_(double a, double b) {
  return hypot(a, b);
}
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }

// torch.clamp(x, min=lo), torch.clamp(x, lo, hi) and torch.maximum(a, b):
// a NaN passes through
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return isnan(x) ? x : max_t(x, lo);
}
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return isnan(x) ? x : min_t(max_t(x, lo), hi);
}
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  return isnan(a) ? a : isnan(b) ? b : max_t(a, b);
}

// torch's CUDA mean over the phase axis: the sum from +0 (so a -0 of one
// phase reads +0, as torch's reduction gives it), times 1/N rounded in T
template <typename T, int N>
__device__ __forceinline__ T phase_mean(const T (&x)[N]) {
  T s = lit<T>(0.0);
#pragma unroll
  for (int k = 0; k < N; ++k) s = s + x[k];
  return s * (lit<T>(1.0) / lit<T>(N));
}

// component r of phase k's term of a positive sequence: x * conj(a_k)
// (x itself at one phase, where a_k = 1 and rhs_core skips the rotation)
template <typename T, int N, class R>
__device__ __forceinline__ T pos_term(R r, int k, const T (&re)[N],
                                      const T (&im)[N], const T (&ak_re)[N],
                                      const T (&ak_im)[N]) {
  if (N == 1) return pick(r, re[k], im[k]);
  return cmul(r, re[k], im[k], ak_re[k], -ak_im[k]);
}

}  // namespace glue
}  // namespace pvderx
