// Double-float32 ("df") arithmetic on one thread: value = hi + lo with
// |lo| <= ulp(hi)/2, about 49 bits of mantissa from float32 operations.
//
// A device restatement of pvderx_torch/ops/dualfloat.py (the reference's
// pvderx/ops/dualfloat.py), operation by operation:
//   - Knuth two-sum and quick-two-sum; the two-product error as
//     fmaf(a, b, -a*b), exact for float32 (bit for bit Dekker's split form
//     wherever that is exact) at 2 operations instead of 17;
//   - + - * / in the reference's order; the divide refines q1 = a.hi/b.hi by
//     one DF remainder; sqrt takes one Newton step; x^(-1/16) is four sqrts
//     and a DF reciprocal;
//   - sin/cos by pi/2 reduction, Taylor to x^13 / x^12 and quadrant
//     recombination (one reduction serves both); exp by ln2 reduction,
//     Taylor to r^9 and an exact 2^k from the exponent field, the argument
//     clamped to +-80;
//   - max/min compare hi and select both halves.
//
// Every sum and product here is an explicitly rounded intrinsic
// (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn): nvcc contracts
// a*b + c into an FMA by default, which silently breaks the error-free
// transforms, and the intrinsics are never contracted. Library flags stay
// as they are for the float32 kernels.
//
// lit<T>(x) is a double constant in the working type: float rounds it once;
// df splits it exactly into hi = f32(x), lo = f32(x - hi), as the reference
// lifts its Python constants. A float literal in df code would drop lo.
#pragma once

#include <cuda_runtime.h>

namespace pvderx {

struct df {
  float hi, lo;
  df() = default;
  __host__ __device__ constexpr df(float h, float l) : hi(h), lo(l) {}
  // an exact float32 input (params, exog, t0): lo = 0
  __host__ __device__ constexpr explicit df(float h) : hi(h), lo(0.0f) {}
};

template <class T>
__host__ __device__ constexpr T lit(double x);

template <>
__host__ __device__ constexpr float lit<float>(double x) {
  return static_cast<float>(x);
}

template <>
__host__ __device__ constexpr df lit<df>(double x) {
  return df(static_cast<float>(x),
            static_cast<float>(x - static_cast<double>(static_cast<float>(x))));
}

// --- error-free transforms --------------------------------------------------
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// assumes |a| >= |b|
__device__ __forceinline__ df quick_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  return df(s, __fsub_rn(b, __fsub_rn(s, a)));
}

__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  e = fmaf(a, b, -p);
}

// --- arithmetic ---------------------------------------------------------------
__device__ __forceinline__ df operator+(df a, df b) {
  float s, e;
  two_sum(a.hi, b.hi, s, e);
  e = __fadd_rn(e, __fadd_rn(a.lo, b.lo));
  return quick_two_sum(s, e);
}

__device__ __forceinline__ df operator-(df a) { return df(-a.hi, -a.lo); }

__device__ __forceinline__ df operator-(df a, df b) { return a + (-b); }

__device__ __forceinline__ df operator*(df a, df b) {
  float p, e;
  two_prod(a.hi, b.hi, p, e);
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(a.hi, b.lo), __fmul_rn(a.lo, b.hi)));
  return quick_two_sum(p, e);
}

__device__ __forceinline__ df operator/(df a, df b) {
  const float q1 = __fdiv_rn(a.hi, b.hi);
  const df r = a - b * df(q1);
  const float q2 = __fdiv_rn(__fadd_rn(r.hi, r.lo), b.hi);
  return quick_two_sum(q1, q2);
}

__device__ __forceinline__ df sqrt_t(df a) {
  const float s = __fsqrt_rn(a.hi);
  // one Newton step in DF: e = (a - s^2) / (2 s)
  const df r = a - df(s) * df(s);
  const float e = __fdiv_rn(__fadd_rn(r.hi, r.lo), __fmul_rn(2.0f, s));
  return quick_two_sum(s, e);
}

// x^(-1/16) = 1 / sqrt(sqrt(sqrt(sqrt(x)))): the soft limiter's exponent
__device__ __forceinline__ df pow_sat(df x) {
  df r = x;
#pragma unroll
  for (int i = 0; i < 4; ++i) r = sqrt_t(r);
  return lit<df>(1.0) / r;
}

__device__ __forceinline__ df max_t(df a, df b) { return a.hi >= b.hi ? a : b; }
__device__ __forceinline__ df min_t(df a, df b) { return a.hi <= b.hi ? a : b; }

// --- transcendentals ----------------------------------------------------------
// a - k*c with c split exactly into (hi, lo), one DF product each
__device__ __forceinline__ df reduce(df a, float k, double c) {
  const df ch = lit<df>(c);
  const df r = a - df(ch.hi) * df(k);
  return r - df(ch.lo) * df(k);
}

// sum_i (-1)^(i+1) c_i r2^(i+1) by Horner over the 6 coefficients c_1..c_6
// of sin (1/3!, 1/5!, ...) or, if `use_cos`, of cos (1/2!, 1/4!, ...), highest
// term first. Where `use_cos` differs from lane to lane (window_df.cu) each
// coefficient is a select between two constants.
__device__ __forceinline__ df horner_even(df r2, bool use_cos) {
  constexpr double SIN_C[6] = {1.0 / 6.0, 1.0 / 120.0, 1.0 / 5040.0,
                               1.0 / 362880.0, 1.0 / 39916800.0,
                               1.0 / 6227020800.0};
  constexpr double COS_C[6] = {1.0 / 2.0, 1.0 / 24.0, 1.0 / 720.0,
                               1.0 / 40320.0, 1.0 / 3628800.0,
                               1.0 / 479001600.0};
  df acc = lit<df>(0.0);
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    const double sgn = i % 2 == 0 ? -1.0 : 1.0;
    const df ci = use_cos ? lit<df>(sgn * COS_C[i]) : lit<df>(sgn * SIN_C[i]);
    acc = (acc + ci) * r2;
  }
  return acc;
}

// sin and cos of a DF: pi/2 reduction (k half to even, as rintf), Taylor,
// quadrant q = k mod 4 (floor mod) swaps and negates. Valid for |a| up to
// ~2^11 rad. In three pieces, so that the two Taylor polynomials can run on
// two lanes (window_df.cu).
struct SinCosArg {
  float k;    // the multiple of pi/2
  df r, r2;   // the reduced argument and its square
};

__device__ __forceinline__ SinCosArg sincos_reduce(df a) {
  SinCosArg g;
  g.k = rintf(__fmul_rn(a.hi, lit<float>(2.0 / 3.141592653589793)));
  g.r = reduce(a, g.k, 1.5707963267948966);
  g.r2 = g.r * g.r;
  return g;
}

// the Taylor sin (use_cos = false) or cos of the reduced argument
__device__ __forceinline__ df sincos_half(const SinCosArg& g, bool use_cos) {
  const df x = horner_even(g.r2, use_cos) + lit<df>(1.0);
  const df s = g.r * x;
  return use_cos ? x : s;
}

__device__ __forceinline__ void sincos_finish(float k, df s, df c, df* s_out,
                                              df* c_out) {
  const float q = __fsub_rn(k, __fmul_rn(4.0f, floorf(__fmul_rn(k, 0.25f))));
  const bool swap = q == 1.0f || q == 3.0f;
  df sin_o = swap ? c : s;
  df cos_o = swap ? s : c;
  if (q == 2.0f || q == 3.0f) sin_o = -sin_o;
  if (q == 1.0f || q == 2.0f) cos_o = -cos_o;
  *s_out = sin_o;
  *c_out = cos_o;
}

__device__ __forceinline__ void sincos_t(df a, df* s_out, df* c_out) {
  const SinCosArg g = sincos_reduce(a);
  sincos_finish(g.k, sincos_half(g, false), sincos_half(g, true), s_out,
                c_out);
}

__device__ __forceinline__ df exp_t(df a) {
  const float hi = fminf(fmaxf(a.hi, -80.0f), 80.0f);
  const df x(hi, fabsf(a.hi) > 80.0f ? 0.0f : a.lo);
  const float k = rintf(__fmul_rn(hi, lit<float>(1.0 / 0.6931471805599453)));
  const df r = reduce(x, k, 0.6931471805599453);
  constexpr double C[9] = {1.0 / 40320.0, 1.0 / 5040.0, 1.0 / 720.0,
                           1.0 / 120.0, 1.0 / 24.0, 1.0 / 6.0, 0.5, 1.0, 1.0};
  df acc = lit<df>(1.0 / 362880.0);
#pragma unroll
  for (int i = 0; i < 9; ++i) acc = acc * r + lit<df>(C[i]);
  // 2^k exactly through the exponent field; k in [-116, 116]
  const float scale = __int_as_float((static_cast<int>(k) + 127) << 23);
  return df(__fmul_rn(acc.hi, scale), __fmul_rn(acc.lo, scale));
}

}  // namespace pvderx
