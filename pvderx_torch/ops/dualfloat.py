"""Double-float (two-float32) arithmetic and the df32 RK4 window.

The df32 precision tier carries the ODE state as an unevaluated (hi, lo) pair
of float32 (~49-bit mantissa) built from error-free transforms (Knuth
two-sum, Dekker two-product), so that the UNMODIFIED physics core
(`pvderx_torch.physics.rhs_core`) evaluates in double-float through the
namespace `DFXP`: one set of equations, three precisions (f32, df32, the f64
oracle). Transcendentals are DF-grade: range-reduced Taylor/Horner
polynomials evaluated in DF, a Newton-refined sqrt, and an exact 2^k by
exponent bit-cast.

Every operation is an eager elementwise float32 torch op in the reference's
order, so on the CPU the pairs equal the reference's bit for bit. The window
has two versions:

- `rk4_window_batch_df_ref`, plain torch: `rhs_core` through `DFXP` on
  [n_s, N] field-major pairs;
- `rk4_window_batch_df`, the wrapper: the plain version for tensors on the
  CPU, the CUDA kernel K3 (`csrc/window_df.cu`) for tensors on the card.

Parameters and exog are exact float32 inputs (lo = 0); h = dt/n_sub is split
exactly from the float64 quotient; y_lo is carried across windows by the
caller; the RK4 update is DF arithmetic without Kahan (DF accumulation is
already compensated).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from pvderx_torch.ops import _build
from pvderx_torch.ops.window import (
    P_FIELDS, U_FIELDS, _check_single, pad_envs, unpack_struct)
from pvderx_torch.params import DERParams, Exog
from pvderx_torch.physics import rhs_core

_SPLIT = 4097.0  # 2^12 + 1: Dekker split constant for float32 (24-bit mantissa)


def _two_sum(a, b):
    """Error-free a + b = s + e (Knuth, 6 flops, no branch)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a, b):
    """Error-free a + b = s + e assuming |a| >= |b| (3 flops)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Error-free a * b = p + e (Dekker, 17 flops without FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _f32(x: float) -> float:
    """The float32 nearest to the double x, as a Python float (exact in f32)."""
    return float(np.float32(x))


_CONSTS: dict = {}   # (value bits, device) -> DF of 0-d tensors


def _lift(x, device) -> "DF":
    """A DF from a DF, a tensor (lo = 0) or a Python number. A number is
    split on the host into the exact pair hi = f32(x), lo = f32(x - hi): an
    f32-rounded 1/6 alone costs ~6e-10 in the sin polynomial."""
    if isinstance(x, DF):
        return x
    if isinstance(x, (int, float)):
        key = (float(x).hex(), torch.device(device))
        c = _CONSTS.get(key)
        if c is None:
            hi = np.float32(x)
            lo = np.float32(float(x) - float(hi))
            c = DF(torch.tensor(hi, device=device), torch.tensor(lo, device=device))
            _CONSTS[key] = c
        return c
    return DF(x)


class DF:
    """A double-float32: value = hi + lo, |lo| <= ulp(hi)/2. Closed under the
    arithmetic the physics core uses; comparisons act on hi (lo is below any
    decision threshold in the RHS)."""

    __slots__ = ("hi", "lo")

    def __init__(self, hi: torch.Tensor, lo: torch.Tensor | None = None):
        self.hi = hi
        self.lo = torch.zeros_like(hi) if lo is None else lo

    @property
    def ndim(self):
        return self.hi.dim()

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype

    def __getitem__(self, idx):
        return DF(self.hi[idx], self.lo[idx])

    def reshape(self, *shape):
        return DF(self.hi.reshape(*shape), self.lo.reshape(*shape))

    def astype(self, dtype):
        # a DF is a float32 pair by construction: the identity
        return self

    def _l(self, other):
        return _lift(other, self.hi.device)

    # -- arithmetic (error-free transforms), in the reference's order --
    def __add__(self, other):
        o = self._l(other)
        s, e = _two_sum(self.hi, o.hi)
        e = e + (self.lo + o.lo)
        return DF(*_quick_two_sum(s, e))

    __radd__ = __add__

    def __neg__(self):
        return DF(-self.hi, -self.lo)

    def __sub__(self, other):
        return self + (-self._l(other))

    def __rsub__(self, other):
        return self._l(other) + (-self)

    def __mul__(self, other):
        o = self._l(other)
        p, e = _two_prod(self.hi, o.hi)
        e = e + (self.hi * o.lo + self.lo * o.hi)
        return DF(*_quick_two_sum(p, e))

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._l(other)
        q1 = self.hi / o.hi
        r = self - o * q1          # the remainder in DF
        q2 = (r.hi + r.lo) / o.hi
        return DF(*_quick_two_sum(q1, q2))

    def __rtruediv__(self, other):
        return self._l(other) / self

    def __pow__(self, c):
        if c == 2:
            return self * self
        if abs(c + 1.0 / 16.0) < 1e-12:
            # x^(-1/16) = 1 / sqrt(sqrt(sqrt(sqrt(x)))): the soft limiter's
            # exponent (rhs_core.soft_limit_scale)
            r = self
            for _ in range(4):
                r = _sqrt(r)
            return self._l(1.0) / r
        raise NotImplementedError(f"DF ** {c}")

    # -- comparisons on hi --
    def __lt__(self, o):
        return self.hi < (o.hi if isinstance(o, DF) else o)

    def __le__(self, o):
        return self.hi <= (o.hi if isinstance(o, DF) else o)

    def __gt__(self, o):
        return self.hi > (o.hi if isinstance(o, DF) else o)

    def __ge__(self, o):
        return self.hi >= (o.hi if isinstance(o, DF) else o)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 sqrt. torch's vectorized CPU sqrt is
    not (it is off by one ulp in ~0.7% of float32 inputs); the float64 sqrt
    rounded to float32 is, as its error is far below the distance of an
    exact sqrt from a float32 rounding boundary."""
    return torch.sqrt(x.double()).float()


def _sqrt(a: DF) -> DF:
    s = _sqrt_rn(a.hi)
    # one Newton step in DF: e = (a - s^2) / (2 s)
    r = a - DF(s) * s
    e = (r.hi + r.lo) / (2.0 * s)
    return DF(*_quick_two_sum(s, e))


def _select(w, x: DF, y: DF) -> DF:
    return DF(torch.where(w, x.hi, y.hi), torch.where(w, x.lo, y.lo))


# -- double-float transcendentals -------------------------------------------
# A hardware sin/cos/exp of hi is only f32-accurate (~6e-8 relative), which
# the w_f ~ 6.6e3 rad/s current-loop gain amplifies to ~1e-4 in the RHS; full
# DF accuracy needs range reduction and a polynomial evaluated in DF.
_PI2 = 1.5707963267948966
_LN2 = 0.6931471805599453
_TWO_OVER_PI = _f32(2.0 / math.pi)
_INV_LN2 = _f32(1.0 / _LN2)
# 1/k! for sin/cos Taylor through x^13 / x^12 (|r| <= pi/4 after reduction:
# truncation ~4e-13 relative, below the df32 mantissa)
_INV_FACT = [1.0 / 6.0, 1.0 / 120.0, 1.0 / 5040.0, 1.0 / 362880.0,
             1.0 / 39916800.0, 1.0 / 6227020800.0]
_INV_FACT_COS = [1.0 / 2.0, 1.0 / 24.0, 1.0 / 720.0, 1.0 / 40320.0,
                 1.0 / 3628800.0, 1.0 / 479001600.0]
_EXP_COEF = (1.0 / 40320.0, 1.0 / 5040.0, 1.0 / 720.0, 1.0 / 120.0,
             1.0 / 24.0, 1.0 / 6.0, 0.5, 1.0, 1.0)


def _horner_even(r2: DF, coefs) -> DF:
    """sum_i (-1)^(i+1) c_i r2^(i+1) by Horner, highest term first."""
    acc = _lift(0.0, r2.hi.device)
    for i, c in enumerate(reversed(coefs)):
        sign = -1.0 if (len(coefs) - i) % 2 == 1 else 1.0
        acc = (acc + sign * c) * r2
    return acc


def _reduce(a: DF, k, c: float) -> DF:
    """a - k*c with c split exactly into (hi, lo), one product each."""
    hi = _f32(c)
    lo = _f32(c - hi)
    r = a - DF(torch.full_like(k, hi), torch.zeros_like(k)) * k
    return r - DF(torch.full_like(k, lo), torch.zeros_like(k)) * k


def _sincos(a: DF):
    """(sin, cos) of a DF via pi/2 range reduction and quadrant
    recombination. Valid for |a| up to ~2^11 rad (the multiple k stays
    exactly representable; RHS phases are O(1-100) rad)."""
    k = torch.round(a.hi * _TWO_OVER_PI)      # half to even, as the reference
    r = _reduce(a, k, _PI2)
    r2 = r * r
    s = r * (1.0 + _horner_even(r2, _INV_FACT))
    c = 1.0 + _horner_even(r2, _INV_FACT_COS)
    q = torch.remainder(k, 4.0)               # floor mod: the quadrant
    swap = (q == 1.0) | (q == 3.0)
    sin_o = _select(swap, c, s)
    cos_o = _select(swap, s, c)
    sin_o = _select((q == 2.0) | (q == 3.0), -sin_o, sin_o)
    cos_o = _select((q == 1.0) | (q == 2.0), -cos_o, cos_o)
    return sin_o, cos_o


def _exp_df(a: DF) -> DF:
    """DF exp via ln2 reduction: exp(a) = 2^k exp(r), |r| <= ln2/2, Taylor
    through r^9 (truncation ~3e-13 relative). The argument is clamped to
    +-80 (e^80 ~ 5.5e34 is finite in f32) with lo zeroed past the clamp: an
    overflow would poison the DF division downstream with inf*0 = nan."""
    a = DF(torch.clamp(a.hi, -80.0, 80.0),
           torch.where(torch.abs(a.hi) > 80.0, torch.zeros_like(a.lo), a.lo))
    k = torch.round(a.hi * _INV_LN2)
    r = _reduce(a, k, _LN2)
    acc = _lift(1.0 / 362880.0, a.hi.device)
    for c in _EXP_COEF:
        acc = acc * r + c
    # 2^k exactly through the exponent field (never exp2: inexact on some
    # backends); k in [-116, 116] after the clamp, inside the normal range
    scale = ((k.to(torch.int32) + 127) << 23).view(torch.float32)
    return DF(acc.hi * scale, acc.lo * scale)


class DFXP:
    """The namespace `rhs_core` runs on in double-float, bound to a device
    (its constants are made there)."""

    __name__ = "pvderx_torch.dualfloat"

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def _l(self, a) -> DF:
        return _lift(a, self.device)

    def sqrt(self, a):
        return _sqrt(self._l(a))

    def exp(self, a):
        return _exp_df(self._l(a))

    def sin(self, a):
        return _sincos(self._l(a))[0]

    def cos(self, a):
        return _sincos(self._l(a))[1]

    def maximum(self, a, b):
        a, b = self._l(a), self._l(b)
        return _select(a.hi >= b.hi, a, b)

    def minimum(self, a, b):
        a, b = self._l(a), self._l(b)
        return _select(a.hi <= b.hi, a, b)

    def mean(self, a, axis=None):
        """Mean over the leading (phase) axis: a sequential sum in index
        order, then x(1/n) if n is a power of two, else /n."""
        if axis != 0:
            raise NotImplementedError("DF mean: axis=0 only (phase axis)")
        a = self._l(a)
        n = a.shape[0]
        s = a[0]
        for i in range(1, n):
            s = s + a[i]
        return s * (1.0 / n) if (n & (n - 1)) == 0 else s / float(n)

    def stack(self, xs):
        xs = [self._l(x) for x in xs]
        return DF(torch.stack([x.hi for x in xs]), torch.stack([x.lo for x in xs]))

    def concatenate(self, xs):
        xs = [self._l(x) for x in xs]
        return DF(torch.cat([x.hi for x in xs]), torch.cat([x.lo for x in xs]))

    def zeros(self, shape, dtype=None):
        z = torch.zeros(shape, dtype=torch.float32, device=self.device)
        return DF(z, z)

    def asarray(self, a, dtype=None):
        if isinstance(a, (list, tuple)):
            # constant tables (rhs_core._shift_angles): each Python float
            # split exactly into an (hi, lo) pair
            return self.stack(a)
        return self._l(a)


# ---------------------------------------------------------------------------
# the df32 window
# ---------------------------------------------------------------------------
# Operations per env per RK4 substep of the df32 window (4 DF RHS evaluations
# with hoisted Prep, 2 DF grid rotations, the DF update), counted on the
# reference program's jaxpr by the reference's op counter
# (pvderx/diag/roofline.py::_count_jaxpr, the hoisted Prep and first grid
# rotation subtracted), with the work the function needs and the CUDA kernel
# does: the two-product error as one FMA (p = a*b, then fma(a, b, -p): 3
# flops, not Dekker's 17), one sin/cos range reduction per phasor (the
# reference computes both polynomials for sin and again for cos), and no
# count for jit call wrappers. The reference program as written counts
# 28818 (1-phase) and 52718 (3-phase).
OPS_PER_SUBSTEP_DF = {1: 14746, 3: 29830}


def window_df_bytes(n: int, n_ph: int) -> int:
    """Device-memory bytes one df32 window must move: one f32 read of t0,
    (y_hi, y_lo), p_pack and u_pack and one f32 write of (hi, lo) per env."""
    n_s = 6 * n_ph + 5
    return 4 * n * (1 + 4 * n_s + len(P_FIELDS) + len(U_FIELDS))


def window_df_ops(n: int, n_ph: int, n_sub: int) -> int:
    """Arithmetic operations one df32 window of n envs performs."""
    return OPS_PER_SUBSTEP_DF[n_ph] * n_sub * n


def split_h(dt: float, n_sub: int) -> tuple[float, float]:
    """h = dt/n_sub in float64, split exactly into an f32 (hi, lo) pair."""
    h = float(dt) / n_sub
    hi = _f32(h)
    return hi, _f32(h - hi)


def _check_df(y_hi, y_lo, t0, p_pack, u_pack, n_ph):
    _check_single(y_hi, t0, p_pack, u_pack, n_ph)
    if y_hi.dtype != torch.float32:
        raise ValueError(f"the df32 window takes float32, got {y_hi.dtype}")
    if (y_lo.shape != y_hi.shape or y_lo.dtype != y_hi.dtype
            or y_lo.device != y_hi.device):
        raise ValueError(f"y_lo must match y_hi {tuple(y_hi.shape)} "
                         f"{y_hi.dtype} on {y_hi.device}, got "
                         f"{tuple(y_lo.shape)} {y_lo.dtype} on {y_lo.device}")


def rk4_window_batch_df_ref(y_hi, y_lo, t0, p_pack, u_pack, *, n_ph: int,
                            n_sub: int, dt: float):
    """Plain torch version of the df32 window: `rhs_core` through `DFXP` on
    [n_s, N] field-major pairs. y_hi, y_lo: [N, n_s]; t0: [N]; p_pack:
    [29, N]; u_pack: [15, N]; all float32. Returns (y1_hi, y1_lo). On the
    CPU the batch runs padded (`ops.window.pad_envs`)."""
    _check_df(y_hi, y_lo, t0, p_pack, u_pack, n_ph)
    n = y_hi.shape[0]
    y_hi, y_lo, t0, p_pack, u_pack = pad_envs(
        n, (y_hi, 0), (y_lo, 0), (t0, 0), (p_pack, 1), (u_pack, 1))
    xp = DFXP(y_hi.device)
    y = DF(y_hi.T, y_lo.T)
    p = unpack_struct(DERParams, DF(p_pack), P_FIELDS, n_ph=n_ph)
    u = unpack_struct(Exog, DF(u_pack), U_FIELDS)
    t0 = DF(t0)
    h_hi, h_lo = split_h(dt, n_sub)
    h = DF(torch.full_like(t0.hi, h_hi), torch.full_like(t0.hi, h_lo))
    prep = rhs_core.prep_invariants(p, u, xp, bdims=1)
    r1 = rhs_core.grid_rot(t0, p, u, xp)
    for k in range(n_sub):
        t = t0 + h * float(k)
        rh = rhs_core.grid_rot(t + 0.5 * h, p, u, xp)
        r4 = rhs_core.grid_rot(t + h, p, u, xp)
        k1 = rhs_core.rhs(y, t, p, u, xp, prep, r1)
        k2 = rhs_core.rhs(y + (0.5 * h) * k1, t + 0.5 * h, p, u, xp, prep, rh)
        k3 = rhs_core.rhs(y + (0.5 * h) * k2, t + 0.5 * h, p, u, xp, prep, rh)
        k4 = rhs_core.rhs(y + h * k3, t + h, p, u, xp, prep, r4)
        y = y + (h * (1.0 / 6.0)) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        r1 = r4
    return y.hi.T[:n].contiguous(), y.lo.T[:n].contiguous()


def rk4_window_batch_df(y_hi, y_lo, t0, p_pack, u_pack, *, n_ph: int,
                        n_sub: int, dt: float):
    """Integrate all N envs over one control window in double-float32.

    y_hi, y_lo: [N, n_s]; t0: [N]; p_pack: [29, N]; u_pack: [15, N]; all
    float32, contiguous and on one device. Returns (y1_hi, y1_lo), each
    [N, n_s]. Any N >= 1.

    On the CPU this is `rk4_window_batch_df_ref`. On a CUDA device the CUDA
    kernel runs on the current stream; each launch adds one to
    ``rk4_window_batch_df.launches``.
    """
    _check_df(y_hi, y_lo, t0, p_pack, u_pack, n_ph)
    if y_hi.device.type == "cpu":
        return rk4_window_batch_df_ref(y_hi, y_lo, t0, p_pack, u_pack,
                                       n_ph=n_ph, n_sub=n_sub, dt=dt)
    hi, lo = torch.empty_like(y_hi), torch.empty_like(y_lo)
    _build.launch("pvderx_rk4_window_df", "df32 window", y_hi, y_lo, t0,
                  p_pack, u_pack, hi, lo, y_hi.shape[0], n_ph, n_sub,
                  *split_h(dt, n_sub), check=(hi, lo))
    rk4_window_batch_df.launches += 1
    return hi, lo


rk4_window_batch_df.launches = 0
