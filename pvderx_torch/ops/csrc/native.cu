// The float64 engine on Hopper (sm_90a): four kernels, one thread per env.
//
// Replaces pvderx/native/src/pvderx_native.cpp, the reference's C++ engine
// (its OpenMP loop over envs becomes the grid): the PV-DER right-hand side
// (N4, `rhs` :72-174), the Kahan-compensated RK4 window (N1, `rk4_window`
// :176-202 and `pvdx_rk4_window_batch` :352-366), the adaptive
// Dormand-Prince 5(4) window (N2, `dp54_window` :204-271) and the Newton
// steady state with a forward-difference Jacobian and a partial-pivot LU
// (N3, `newton_steady` / `lu_solve` :273-328). The equations are rhs.cuh's
// over double (pvderx_torch/physics/rhs_core.py's hoisted path, the same
// pieces the float32 and df32 windows run); the integrators and the solver
// follow pvderx_native.cpp statement by statement.
//
// What bounds them on this card: float64 operations. A right-hand side is
// ~190 (one phase) to ~450 (three) operations per env as
// diag/roofline.py's native_op_counts counts them, its sin, cos, exp and
// x^(-1/16) each one operation there but a double-library polynomial
// sequence here; N1 runs 4 x n_sub of them per env while moving ~0.5 KB,
// N2 6 per tried step, N3 n_s + 1 per iteration beside an n_s^3 LU.
// Against the card's 33.5 TFLOP/s of FP64, half its FP32 rate, one thread
// per env at 32768 envs keeps ~8 warps per SM in flight.
//
// What the design does about it, in this first version: nothing beyond
// the shape of K1 (window.cu). One thread per env holds its state, the
// window invariants (rhs.cuh's `Unit` and `Feeder`, Prep hoisted once per
// launch) and the integrator's vectors; N1 runs rhs.cuh's rk4_window over
// double, stages unrolled as K1's. N2 keeps nine vectors of n_s doubles and
// N3 the n_s x n_s Jacobian per thread: they live in local memory (ptxas
// reports the spills), and both call the right-hand side through one
// out-of-line copy (`rhs_at`) instead of inlining it 7 or n_s + 1 times.
// N2's envs take their own step sequences (18 to ~300 steps per window), so
// its warps diverge; that is recorded (PERF.md), not fixed.
//
// nvcc contracts a*b + c into FMAs in double; g++ -O3 for x86-64 does not.
// N4 and N1 agree with the plain version to ~1e-15 relative all the same;
// N2's error estimate can then land on the other side of 1.0 and take
// another step sequence, so N2 is held to the LSODA truth, not bit for bit.
// No fast-math: grid angles reach ~100 rad.
//
// Layout: y and outputs [N, n_s] row-major; t, t0 [N]; p [29, N] and u
// [15, N] field-major (shared params are expanded on the host). All float64;
// steps / iterations int32 [N].
#include "rhs.cuh"

namespace {

using namespace pvderx;

constexpr int BLOCK = 64;
constexpr int DP54_GUARD = 2000000;   // pvderx_native.cpp's loop guard

// One env's window invariants.
template <int N>
struct Env {
  Unit<double, N> w;
  Feeder<double, N> fd;
};

template <int N>
__device__ __forceinline__ void load_env(Env<N>& v, const double* p,
                                         const double* u, int n, int e) {
  auto P = [&](int f) { return p[static_cast<size_t>(f) * n + e]; };
  auto U = [&](int f) { return u[static_cast<size_t>(f) * n + e]; };
  load_unit(v.w, P, U);
  load_feeder(v.fd, v.w.ak_re, v.w.ak_im, P, U);
}

// rhs_core.rhs with the grid phasor given: the DER's own injection sets its
// PCC voltage
template <int N>
__device__ __forceinline__ void rhs_rot(const Env<N>& v,
                                        const double (&ys)[6 * N + 5],
                                        double rot_re, double rot_im,
                                        double (&dy)[6 * N + 5]) {
  double ii_re[N], ii_im[N], v_re[N], v_im[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    ii_re[k] = ys[k] * v.w.conn;
    ii_im[k] = ys[N + k] * v.w.conn;
  }
  pcc_voltage<double, N>(ii_re, ii_im, rot_re, rot_im, v.fd, v.w.ak_re,
                         v.w.ak_im, v_re, v_im);
  rhs_given_v<double, N>(ys, v_re, v_im, v.w, dy);
}

// rhs_core.rhs at time t: one out-of-line copy, which the integrators call
// many times per step (N2, N3)
template <int N>
__device__ __noinline__ void rhs_at(const Env<N>& v,
                                    const double (&ys)[6 * N + 5], double t,
                                    double (&dy)[6 * N + 5]) {
  double rot_re, rot_im;
  grid_rot(t, v.fd, rot_re, rot_im);
  rhs_rot(v, ys, rot_re, rot_im, dy);
}

// ---- N4: dy/dt at (y, t) ---------------------------------------------------
template <int N>
__global__ void __launch_bounds__(BLOCK)
native_rhs_kernel(const double* __restrict__ y, const double* __restrict__ t,
                  const double* __restrict__ p, const double* __restrict__ u,
                  double* __restrict__ dy, int n) {
  constexpr int NS = 6 * N + 5;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  Env<N> v;
  load_env(v, p, u, n, e);
  double ys[NS], d[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) ys[j] = y[static_cast<size_t>(e) * NS + j];
  rhs_at(v, ys, t[e], d);
#pragma unroll
  for (int j = 0; j < NS; ++j) dy[static_cast<size_t>(e) * NS + j] = d[j];
}

// ---- N1: n_sub Kahan RK4 substeps ------------------------------------------
template <int N>
__global__ void __launch_bounds__(BLOCK)
native_rk4_kernel(const double* __restrict__ y_in,
                  const double* __restrict__ t0_in,
                  const double* __restrict__ p, const double* __restrict__ u,
                  double* __restrict__ y_out, int n, int n_sub, double h,
                  double hh, double h6) {
  constexpr int NS = 6 * N + 5;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  Env<N> v;
  load_env(v, p, u, n, e);
  auto rhs = [&](const double (&ys)[NS], double rot_re, double rot_im,
                 double (&dy)[NS]) { rhs_rot(v, ys, rot_re, rot_im, dy); };
  const double t0 = t0_in[e];
  auto phasors = [&](int s, double& rh_re, double& rh_im, double& r4_re,
                     double& r4_im) {
    double th, t4;
    stage_times(t0, s, h, hh, th, t4);
    grid_rot(th, v.fd, rh_re, rh_im);
    grid_rot(t4, v.fd, r4_re, r4_im);
  };
  double r1_re, r1_im;
  grid_rot(t0, v.fd, r1_re, r1_im);
  double y[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) y[j] = y_in[static_cast<size_t>(e) * NS + j];
  rk4_window(y, r1_re, r1_im, n_sub, h, hh, h6, rhs, phasors);
#pragma unroll
  for (int j = 0; j < NS; ++j) y_out[static_cast<size_t>(e) * NS + j] = y[j];
}

// ---- N2: adaptive Dormand-Prince 5(4) over one window ----------------------
// Butcher tableau (Dormand & Prince 1980, RK5(4)7M), pvderx_native.cpp's
constexpr double C2 = 1.0 / 5, C3 = 3.0 / 10, C4 = 4.0 / 5, C5 = 8.0 / 9;
constexpr double A21 = 1.0 / 5;
constexpr double A31 = 3.0 / 40, A32 = 9.0 / 40;
constexpr double A41 = 44.0 / 45, A42 = -56.0 / 15, A43 = 32.0 / 9;
constexpr double A51 = 19372.0 / 6561, A52 = -25360.0 / 2187,
                 A53 = 64448.0 / 6561, A54 = -212.0 / 729;
constexpr double A61 = 9017.0 / 3168, A62 = -355.0 / 33,
                 A63 = 46732.0 / 5247, A64 = 49.0 / 176,
                 A65 = -5103.0 / 18656;
constexpr double B1 = 35.0 / 384, B3 = 500.0 / 1113, B4 = 125.0 / 192,
                 B5 = -2187.0 / 6784, B6 = 11.0 / 84;
constexpr double E1 = 71.0 / 57600, E3 = -71.0 / 16695, E4 = 71.0 / 1920,
                 E5 = -17253.0 / 339200, E6 = 22.0 / 525, E7 = -1.0 / 40;

// std::max / std::min as pvderx_native.cpp calls them (NaN handling included)
__device__ __forceinline__ double std_max(double a, double b) {
  return (a < b) ? b : a;
}
__device__ __forceinline__ double std_min(double a, double b) {
  return (b < a) ? b : a;
}

// steps[e]: accepted steps, or -1 on step-size underflow or an exhausted
// guard; tries[e]: steps tried (accepted and rejected), what the env's
// work was
template <int N>
__global__ void __launch_bounds__(BLOCK)
native_dp54_kernel(const double* __restrict__ y_in,
                   const double* __restrict__ t0_in,
                   const double* __restrict__ p, const double* __restrict__ u,
                   double* __restrict__ y_out, int* __restrict__ steps,
                   int* __restrict__ tries, int n, double dt, double rtol,
                   double atol) {
  constexpr int NS = 6 * N + 5;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  Env<N> v;
  load_env(v, p, u, n, e);
  double y[NS], k1[NS], k2[NS], k3[NS], k4[NS], k5[NS], k6[NS], k7[NS],
      yt[NS], y5[NS];
  for (int j = 0; j < NS; ++j) y[j] = y_in[static_cast<size_t>(e) * NS + j];
  double t = t0_in[e];
  const double tend = t + dt;
  double h = dt / 400.0;  // conservative start (stiff w_f mode)
  int accepted = 0, tried = 0;
  bool underflow = false;
  rhs_at(v, y, t, k1);  // FSAL seed
  for (int guard = 0; guard < DP54_GUARD && t < tend; ++guard) {
    ++tried;
    if (t + h > tend) h = tend - t;
    for (int j = 0; j < NS; ++j) yt[j] = y[j] + h * A21 * k1[j];
    rhs_at(v, yt, t + C2 * h, k2);
    for (int j = 0; j < NS; ++j) yt[j] = y[j] + h * (A31 * k1[j] + A32 * k2[j]);
    rhs_at(v, yt, t + C3 * h, k3);
    for (int j = 0; j < NS; ++j)
      yt[j] = y[j] + h * (A41 * k1[j] + A42 * k2[j] + A43 * k3[j]);
    rhs_at(v, yt, t + C4 * h, k4);
    for (int j = 0; j < NS; ++j)
      yt[j] = y[j] +
              h * (A51 * k1[j] + A52 * k2[j] + A53 * k3[j] + A54 * k4[j]);
    rhs_at(v, yt, t + C5 * h, k5);
    for (int j = 0; j < NS; ++j)
      yt[j] = y[j] + h * (A61 * k1[j] + A62 * k2[j] + A63 * k3[j] +
                          A64 * k4[j] + A65 * k5[j]);
    rhs_at(v, yt, t + h, k6);
    for (int j = 0; j < NS; ++j)
      y5[j] = y[j] + h * (B1 * k1[j] + B3 * k3[j] + B4 * k4[j] + B5 * k5[j] +
                          B6 * k6[j]);
    rhs_at(v, y5, t + h, k7);
    double err = 0.0;
    for (int j = 0; j < NS; ++j) {
      const double ej = h * (E1 * k1[j] + E3 * k3[j] + E4 * k4[j] +
                             E5 * k5[j] + E6 * k6[j] + E7 * k7[j]);
      const double sc = atol + rtol * std_max(fabs(y[j]), fabs(y5[j]));
      err = std_max(err, fabs(ej) / sc);
    }
    if (err <= 1.0) {
      t += h;
      for (int j = 0; j < NS; ++j) {
        y[j] = y5[j];
        k1[j] = k7[j];  // FSAL
      }
      ++accepted;
      if (t >= tend) break;  // done: no step-size update after the last step
    }
    const double fac = 0.9 * pow(std_max(err, 1e-16), -0.2);
    h *= std_min(5.0, std_max(0.2, fac));
    if (h < 1e-14) {  // step-size underflow mid-window
      underflow = true;
      break;
    }
  }
  for (int j = 0; j < NS; ++j) y_out[static_cast<size_t>(e) * NS + j] = y[j];
  steps[e] = (!underflow && t >= tend) ? accepted : -1;
  tries[e] = tried;
}

// ---- N3: Newton on rhs(y, 0) = 0 -------------------------------------------
// partial-pivot Gaussian elimination: solve A x = b in place (A row-major),
// pvderx_native.cpp's lu_solve
template <int NS>
__device__ int lu_solve(double (&A)[NS * NS], double (&b)[NS]) {
  for (int col = 0; col < NS; ++col) {
    int piv = col;
    for (int r = col + 1; r < NS; ++r)
      if (fabs(A[r * NS + col]) > fabs(A[piv * NS + col])) piv = r;
    if (fabs(A[piv * NS + col]) < 1e-300) return -1;
    if (piv != col) {
      for (int j = 0; j < NS; ++j) {
        const double s = A[col * NS + j];
        A[col * NS + j] = A[piv * NS + j];
        A[piv * NS + j] = s;
      }
      const double s = b[col];
      b[col] = b[piv];
      b[piv] = s;
    }
    const double d = A[col * NS + col];
    for (int r = col + 1; r < NS; ++r) {
      const double f = A[r * NS + col] / d;
      if (f == 0.0) continue;
      for (int j = col; j < NS; ++j) A[r * NS + j] -= f * A[col * NS + j];
      b[r] -= f * b[col];
    }
  }
  for (int r = NS - 1; r >= 0; --r) {
    double s = b[r];
    for (int j = r + 1; j < NS; ++j) s -= A[r * NS + j] * b[j];
    b[r] = s / A[r * NS + r];
  }
  return 0;
}

template <int NS>
__device__ __forceinline__ double max_abs(const double (&f)[NS]) {
  double r = 0.0;
  for (int j = 0; j < NS; ++j) r = std_max(r, fabs(f[j]));
  return r;
}

// iters[e]: iterations used (0..max_iters) on convergence, -1 otherwise
template <int N>
__global__ void __launch_bounds__(BLOCK)
native_newton_kernel(const double* __restrict__ y_in,
                     const double* __restrict__ p,
                     const double* __restrict__ u, double* __restrict__ y_out,
                     int* __restrict__ iters, int n, int max_iters,
                     double tol) {
  constexpr int NS = 6 * N + 5;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  Env<N> v;
  load_env(v, p, u, n, e);
  double y[NS], f0[NS], f1[NS], J[NS * NS], step[NS], yp[NS];
  for (int j = 0; j < NS; ++j) y[j] = y_in[static_cast<size_t>(e) * NS + j];
  int result = -2;   // -2: the loop ran out; decided after it
  for (int it = 0; it < max_iters && result == -2; ++it) {
    rhs_at(v, y, 0.0, f0);
    if (max_abs(f0) < tol) {
      result = it;
      break;
    }
    // forward-difference Jacobian
    for (int j = 0; j < NS; ++j) {
      for (int i = 0; i < NS; ++i) yp[i] = y[i];
      const double d = 1e-8 * std_max(1.0, fabs(y[j]));
      yp[j] += d;
      rhs_at(v, yp, 0.0, f1);
      for (int r = 0; r < NS; ++r) J[r * NS + j] = (f1[r] - f0[r]) / d;
    }
    for (int j = 0; j < NS; ++j) step[j] = -f0[j];
    if (lu_solve<NS>(J, step) != 0) {
      result = -1;
      break;
    }
    for (int j = 0; j < NS; ++j) y[j] += step[j];
  }
  if (result == -2) {
    rhs_at(v, y, 0.0, f0);
    result = max_abs(f0) < tol ? max_iters : -1;
  }
  for (int j = 0; j < NS; ++j) y_out[static_cast<size_t>(e) * NS + j] = y[j];
  iters[e] = result;
}

dim3 grid_of(int n) { return dim3((n + BLOCK - 1) / BLOCK); }

}  // namespace

// Each entry launches on `stream` and returns the launch's cudaError_t (0 on
// success); n_ph other than 1 or 3, or a count below 1, is refused.
extern "C" int pvderx_native_rhs(const void* y, const void* t, const void* p,
                                 const void* u, void* dy, int n, int n_ph,
                                 void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto a = [](const void* x) { return static_cast<const double*>(x); };
  auto o = static_cast<double*>(dy);
  if (n_ph == 1) {
    native_rhs_kernel<1><<<grid_of(n), BLOCK, 0, s>>>(a(y), a(t), a(p), a(u), o, n);
  } else if (n_ph == 3) {
    native_rhs_kernel<3><<<grid_of(n), BLOCK, 0, s>>>(a(y), a(t), a(p), a(u), o, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pvderx_native_rk4_window(const void* y, const void* t0,
                                        const void* p, const void* u,
                                        void* out, int n, int n_ph, int n_sub,
                                        double h, double hh, double h6,
                                        void* stream) {
  if (n < 1 || n_sub < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto a = [](const void* x) { return static_cast<const double*>(x); };
  auto o = static_cast<double*>(out);
  if (n_ph == 1) {
    native_rk4_kernel<1><<<grid_of(n), BLOCK, 0, s>>>(
        a(y), a(t0), a(p), a(u), o, n, n_sub, h, hh, h6);
  } else if (n_ph == 3) {
    native_rk4_kernel<3><<<grid_of(n), BLOCK, 0, s>>>(
        a(y), a(t0), a(p), a(u), o, n, n_sub, h, hh, h6);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pvderx_native_dp54_window(const void* y, const void* t0,
                                         const void* p, const void* u,
                                         void* out, void* steps, void* tries,
                                         int n, int n_ph, double dt,
                                         double rtol, double atol,
                                         void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto a = [](const void* x) { return static_cast<const double*>(x); };
  auto o = static_cast<double*>(out);
  auto st = static_cast<int*>(steps);
  auto tr = static_cast<int*>(tries);
  if (n_ph == 1) {
    native_dp54_kernel<1><<<grid_of(n), BLOCK, 0, s>>>(
        a(y), a(t0), a(p), a(u), o, st, tr, n, dt, rtol, atol);
  } else if (n_ph == 3) {
    native_dp54_kernel<3><<<grid_of(n), BLOCK, 0, s>>>(
        a(y), a(t0), a(p), a(u), o, st, tr, n, dt, rtol, atol);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pvderx_native_newton_steady(const void* y, const void* p,
                                           const void* u, void* out,
                                           void* iters, int n, int n_ph,
                                           int max_iters, double tol,
                                           void* stream) {
  if (n < 1 || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto a = [](const void* x) { return static_cast<const double*>(x); };
  auto o = static_cast<double*>(out);
  auto it = static_cast<int*>(iters);
  if (n_ph == 1) {
    native_newton_kernel<1><<<grid_of(n), BLOCK, 0, s>>>(
        a(y), a(p), a(u), o, it, n, max_iters, tol);
  } else if (n_ph == 3) {
    native_newton_kernel<3><<<grid_of(n), BLOCK, 0, s>>>(
        a(y), a(p), a(u), o, it, n, max_iters, tol);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
