// The env step's autoreset in one pass over the envs (sm_90a).
//
// Replaces no TPU kernel. The reference restarts the done envs under jit,
// where XLA fuses the soft reset and the per-leaf select of
// pvderx/env/core.py's step_autoreset into the step. The port's eager
// version (pvderx_torch/env/core.py: `_soft_reset`, then `autoreset`'s
// torch.where per leaf) is ~82 launches that rebuild every env's soft
// reset -- the event tables of `_sample_events`, stacked on strided last
// axes -- and select over every changed leaf, while about one env in 600
// is done in a step. This kernel computes the same result, bit for bit:
// the soft reset of an env only where it is done, a copy of its stepped
// leaves where it is not.
//
// What bounds it on this card: bytes. A kept env costs one read and one
// write of the leaves that change (event tables 42, y n_s, obs 13, timers
// 6, seven scalars: 79 values at one phase, 316 B in float32) and one byte
// of `done`; a done env reads its 14 draws and its cached episode start
// instead of its stepped leaves. No arithmetic happens for the kept envs.
//
// What the design does about it: one thread per env, 256 envs per block.
// The block first marks its done envs in shared memory, then copies each
// row-major leaf of its envs as one flat, coalesced run (neighbouring
// threads on neighbouring words), skipping the rows of done envs; each
// done env's thread then writes its own rows. The outputs are fresh
// tensors: no input is written, so nothing the step returned changes.
//
// Bitwise equality with the eager version: every rounding op of
// `_sample_events` is one explicit round-to-nearest intrinsic in torch's
// order (so nvcc contracts nothing into an FMA), each scalar constant is
// rounded once from the double the Python expression gives (torch rounds a
// Python scalar to the tensor's type), and the remainder is torch's: fmod,
// then + b where the signs differ.
//
// While a profiler records, the kernel adds the envs it restarted, one
// atomic per block, into a device slot (`restarts`, else null).
//
// Layout: every leaf has the env axis leading and is contiguous; solar
// [N, 4, 3], grid [N, 4, 6], load [N, 2, 3], y and y_lo [N, n_s], obs
// [N, 13], timers [N, 6], uv [N, 14], t_step int32, done one byte per env.
// Any N >= 1: the last block masks the ragged edge.
#include <cmath>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int W_SOLAR = 4 * 3, W_GRID = 4 * 6, W_LOAD = 2 * 3;
constexpr int OBS = 13, ZONES = 6, DRAWS = 14;

// The order of the pointer and constant arrays that the entry takes
// (pvderx_torch/ops/autoreset.py: IN_LEAVES, OUT_LEAVES, CONSTANTS).
enum In {
  kDone, kUv, kS0, kTc0, kY0, kObs0, kPpv0, kWBase, kSolar, kGrid, kLoad, kY,
  kTStep, kVdcRef, kQRef, kTimers, kTripped, kCes, kPPrev, kDirection, kObs,
  kYLo, kNumIn
};
enum Out {
  oSolar, oGrid, oLoad, oY, oTStep, oVdcRef, oQRef, oTimers, oTripped, oCes,
  oPPrev, oDirection, oObs, oYLo, kNumOut
};
enum Const {
  cPCloud, cTLo, cTSpan, cCloudLo, cCloudSpan, cDurCLo, cDurCSpan, cPSag,
  cPSagFreq, cDepthLo, cDepthSpan, cDurGLo, cDurGSpan, cDwLo, cDwSpan, cTwoPi,
  cPUnb, cUnbFrac, cPhi2Lo, cPhi2Span, cPLoad, cGLo, cGSpan, kNumConst
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float fmod_(float a, float b) { return fmodf(a, b); }
__device__ __forceinline__ double fmod_(double a, double b) { return fmod(a, b); }

// torch.remainder of floats: fmod, then + b where the signs differ
template <typename T>
__device__ __forceinline__ T remainder(T a, T b) {
  T mod = fmod_(a, b);
  if (mod != T(0) && ((b < T(0)) != (mod < T(0)))) mod = add(mod, b);
  return mod;
}

template <typename T>
struct Args {
  const unsigned char* done;
  const T *uv, *s0, *tc0, *y0, *obs0, *ppv0, *w_base;
  const T *solar, *grid, *load, *y;
  const int* t_step;
  const T *vdc_ref, *q_ref, *timers, *tripped, *ces, *p_prev, *direction,
      *obs, *y_lo;
  T *solar_o, *grid_o, *load_o, *y_o;
  int* t_step_o;
  T *vdc_ref_o, *q_ref_o, *timers_o, *tripped_o, *ces_o, *p_prev_o,
      *direction_o, *obs_o, *y_lo_o;
  T c[kNumConst];
  unsigned long long* restarts;
};

// out = in over the block's rows of a [N, W] leaf, but for done rows: one
// flat run, neighbouring threads on neighbouring words
template <int W, typename T>
__device__ __forceinline__ void copy_kept(const T* __restrict__ in,
                                          T* __restrict__ out, size_t e0,
                                          int rows, const bool* done) {
  in += e0 * W;
  out += e0 * W;
  for (int k = threadIdx.x; k < rows * W; k += BLOCK) {
    if (!done[k / W]) out[k] = in[k];
  }
}

// `_soft_reset` of env e: `_sample_events` from its draws, in torch's order
// of rounding, then the cached episode start
template <typename T, int NPH>
__device__ void restart(const Args<T>& a, size_t e) {
  constexpr int NS = 6 * NPH + 5;
  const T* uv = a.uv + e * DRAWS;
  const T* c = a.c;
  const T inf = T(INFINITY), zero = T(0), one = T(1);
  // lo + (hi - lo) * uv[:, i]
  auto u = [&](int i, int lo, int span) { return add(mul(uv[i], c[span]), c[lo]); };
  const T s0 = a.s0[e], tc0 = a.tc0[e];

  // solar: baseline + optional cloud step + recovery
  const T t_c = uv[0] < c[cPCloud] ? u(1, cTLo, cTSpan) : inf;
  const T s_c = mul(s0, u(2, cCloudLo, cCloudSpan));
  const T dur_c = u(3, cDurCLo, cDurCSpan);
  const T solar[W_SOLAR] = {zero, s0, tc0, t_c, s_c, tc0,
                            add(t_c, dur_c), s0, tc0, inf, s0, tc0};

  // grid: baseline + (sag | freq excursion | none)
  const T r = uv[4];
  const bool is_sag = r < c[cPSag];
  const bool is_freq = (r >= c[cPSag]) && (r < c[cPSagFreq]);
  const T t_g = u(5, cTLo, cTSpan);
  const T depth = u(6, cDepthLo, cDepthSpan);
  const T dur_g = u(7, cDurGLo, cDurGSpan);
  const T dw = u(8, cDwLo, cDwSpan);
  const T t_evt = (is_sag || is_freq) ? t_g : inf;
  const T v_evt = is_sag ? depth : one;
  const T dw_evt = is_freq ? dw : zero;
  const T phi_rec = remainder(mul(mul(a.w_base[0], dw_evt), dur_g), c[cTwoPi]);
  const T is_unb = uv[12] < c[cPUnb] ? one : zero;
  const T v2_evt = mul(mul(mul(mul(is_sag ? one : zero, is_unb),
                               T(NPH == 3 ? 1 : 0)), c[cUnbFrac]),
                       sub(one, depth));
  const T phi2 = u(13, cPhi2Lo, cPhi2Span);
  const T grid[W_GRID] = {zero, one, zero, zero, zero, zero,
                          t_evt, v_evt, zero, dw_evt, v2_evt, phi2,
                          add(t_evt, dur_g), one, phi_rec, zero, zero, zero,
                          inf, one, zero, zero, zero, zero};

  // load: baseline + optional step
  const T t_l = uv[9] < c[cPLoad] ? u(10, cTLo, cTSpan) : inf;
  const T load[W_LOAD] = {zero, zero, zero, t_l, u(11, cGLo, cGSpan), zero};

#pragma unroll
  for (int k = 0; k < W_SOLAR; ++k) a.solar_o[e * W_SOLAR + k] = solar[k];
#pragma unroll
  for (int k = 0; k < W_GRID; ++k) a.grid_o[e * W_GRID + k] = grid[k];
#pragma unroll
  for (int k = 0; k < W_LOAD; ++k) a.load_o[e * W_LOAD + k] = load[k];
#pragma unroll
  for (int k = 0; k < NS; ++k) a.y_o[e * NS + k] = a.y0[e * NS + k];
#pragma unroll
  for (int k = 0; k < OBS; ++k) a.obs_o[e * OBS + k] = a.obs0[e * OBS + k];
#pragma unroll
  for (int k = 0; k < ZONES; ++k) a.timers_o[e * ZONES + k] = zero;
  if (a.y_lo_o != nullptr) {
#pragma unroll
    for (int k = 0; k < NS; ++k) a.y_lo_o[e * NS + k] = zero;
  }
}

template <typename T, int NPH>
__global__ void __launch_bounds__(BLOCK) autoreset_kernel(const Args<T> a,
                                                          int n) {
  constexpr int NS = 6 * NPH + 5;
  __shared__ bool done[BLOCK];
  const size_t e0 = static_cast<size_t>(blockIdx.x) * BLOCK;
  const size_t e = e0 + threadIdx.x;
  const bool d = e < static_cast<size_t>(n) && a.done[e] != 0;
  done[threadIdx.x] = d;
  const int restarted = __syncthreads_count(d);
  if (threadIdx.x == 0 && a.restarts != nullptr && restarted > 0) {
    atomicAdd(a.restarts, static_cast<unsigned long long>(restarted));
  }
  const int rows = min(BLOCK, static_cast<int>(n - e0));
  copy_kept<W_SOLAR>(a.solar, a.solar_o, e0, rows, done);
  copy_kept<W_GRID>(a.grid, a.grid_o, e0, rows, done);
  copy_kept<W_LOAD>(a.load, a.load_o, e0, rows, done);
  copy_kept<NS>(a.y, a.y_o, e0, rows, done);
  copy_kept<OBS>(a.obs, a.obs_o, e0, rows, done);
  copy_kept<ZONES>(a.timers, a.timers_o, e0, rows, done);
  if (a.y_lo_o != nullptr) copy_kept<NS>(a.y_lo, a.y_lo_o, e0, rows, done);
  if (e >= static_cast<size_t>(n)) return;
  const T zero = T(0), one = T(1);
  a.t_step_o[e] = d ? 0 : a.t_step[e];
  a.vdc_ref_o[e] = d ? one : a.vdc_ref[e];
  a.q_ref_o[e] = d ? zero : a.q_ref[e];
  a.tripped_o[e] = d ? zero : a.tripped[e];
  a.ces_o[e] = d ? zero : a.ces[e];
  a.p_prev_o[e] = d ? a.ppv0[e] : a.p_prev[e];
  a.direction_o[e] = d ? one : a.direction[e];
  if (d) restart<T, NPH>(a, e);
}

template <typename T>
Args<T> make_args(const void* const* in, void* const* out, const double* c,
                  void* restarts) {
  Args<T> a;
  a.done = static_cast<const unsigned char*>(in[kDone]);
  auto I = [&](int k) { return static_cast<const T*>(in[k]); };
  auto O = [&](int k) { return static_cast<T*>(out[k]); };
  a.uv = I(kUv); a.s0 = I(kS0); a.tc0 = I(kTc0); a.y0 = I(kY0);
  a.obs0 = I(kObs0); a.ppv0 = I(kPpv0); a.w_base = I(kWBase);
  a.solar = I(kSolar); a.grid = I(kGrid); a.load = I(kLoad); a.y = I(kY);
  a.t_step = static_cast<const int*>(in[kTStep]);
  a.vdc_ref = I(kVdcRef); a.q_ref = I(kQRef); a.timers = I(kTimers);
  a.tripped = I(kTripped); a.ces = I(kCes); a.p_prev = I(kPPrev);
  a.direction = I(kDirection); a.obs = I(kObs); a.y_lo = I(kYLo);
  a.solar_o = O(oSolar); a.grid_o = O(oGrid); a.load_o = O(oLoad);
  a.y_o = O(oY);
  a.t_step_o = static_cast<int*>(out[oTStep]);
  a.vdc_ref_o = O(oVdcRef); a.q_ref_o = O(oQRef); a.timers_o = O(oTimers);
  a.tripped_o = O(oTripped); a.ces_o = O(oCes); a.p_prev_o = O(oPPrev);
  a.direction_o = O(oDirection); a.obs_o = O(oObs); a.y_lo_o = O(oYLo);
  for (int k = 0; k < kNumConst; ++k) a.c[k] = static_cast<T>(c[k]);
  a.restarts = static_cast<unsigned long long*>(restarts);
  return a;
}

template <typename T>
int launch(const void* in, const void* out, const double* c, void* restarts,
           int n, int n_ph, cudaStream_t s) {
  const auto a = make_args<T>(static_cast<const void* const*>(in),
                              static_cast<void* const*>(out), c, restarts);
  if ((a.y_lo == nullptr) != (a.y_lo_o == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + BLOCK - 1) / BLOCK), block(BLOCK);
  if (n_ph == 1) {
    autoreset_kernel<T, 1><<<grid, block, 0, s>>>(a, n);
  } else if (n_ph == 3) {
    autoreset_kernel<T, 3><<<grid, block, 0, s>>>(a, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: kNumIn pointers, out: kNumOut pointers (y_lo and its output both
// null, or both set), consts: kNumConst doubles; restarts: a device
// uint64 slot or null; dtype 0 float32, 1 float64
extern "C" int pvderx_autoreset(const void* in, const void* out,
                                const void* consts, void* restarts, int n,
                                int n_ph, int dtype, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto c = static_cast<const double*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(in, out, c, restarts, n, n_ph, s);
  if (dtype == 1) return launch<double>(in, out, c, restarts, n, n_ph, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
