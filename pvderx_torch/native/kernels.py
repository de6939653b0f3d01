"""The float64 engine's four CUDA kernels, each beside its plain torch version.

The counterpart of `pvderx/native/src/pvderx_native.cpp`, N envs per call
(`csrc/native.cu`, one thread per env):

- `rhs_batch` (N4): dy/dt at (y, t); plain version `_rhs_ref`
  (`physics.rhs_core.rhs` with the window invariants hoisted);
- `rk4_batch` (N1): n_sub Kahan-compensated RK4 substeps; plain version
  `ops.window.rk4_window_batch_ref` in float64;
- `dp54_batch` (N2): one adaptive Dormand-Prince 5(4) window, each env with
  its own step size; plain version `_dp54_window_ref`;
- `newton_batch` (N3): Newton on rhs(y, 0) = 0 with a forward-difference
  Jacobian; plain version `_newton_steady_ref`.

Every argument is float64: y [N, n_s], t / t0 [N], p_pack [29, N] and
u_pack [15, N] (field-major, `ops.window.P_FIELDS` / `U_FIELDS` order, which
is `pvderx_torch.native.P_ORDER` / `U_ORDER`). A launcher runs the plain
version on tensors that live on the CPU and launches its kernel on tensors
that live on the card (`ops._build.launch`), adding one to its
``launches``; any other device raises, and a failed build or launch raises.
There is no fallback. Under `diag.debug.debug_mode` a float output that
holds a NaN raises, as it does for every kernel of the port.

The plain versions run the batch padded to `ops.window.CPU_LANES` envs on
the CPU (`ops.window.pad_envs`), so an env's result does not depend on the
batch it came in: a batch equals its envs' one-env calls bit for bit.
"""
from __future__ import annotations

import torch

from pvderx_torch.ops import _build
from pvderx_torch.ops.window import (
    P_FIELDS, U_FIELDS, _check_single, _substep_constants, pad_envs,
    rk4_window_batch_ref, unpack_struct)
from pvderx_torch.params import DERParams, Exog
from pvderx_torch.physics import rhs_core
from pvderx_torch.physics.xp import like

DP54_GUARD = 2_000_000    # pvderx_native.cpp's loop guard (tried steps)
DP54_H0 = 1.0 / 400.0     # the first step, as a share of the window
# Dormand & Prince 1980, RK5(4)7M: pvderx_native.cpp's tableau
C2, C3, C4, C5 = 1.0 / 5, 3.0 / 10, 4.0 / 5, 8.0 / 9
A21 = 1.0 / 5
A31, A32 = 3.0 / 40, 9.0 / 40
A41, A42, A43 = 44.0 / 45, -56.0 / 15, 32.0 / 9
A51, A52, A53, A54 = (19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561,
                      -212.0 / 729)
A61, A62, A63, A64, A65 = (9017.0 / 3168, -355.0 / 33, 46732.0 / 5247,
                           49.0 / 176, -5103.0 / 18656)
B1, B3, B4, B5, B6 = (35.0 / 384, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784,
                      11.0 / 84)
E1, E3, E4, E5, E6, E7 = (71.0 / 57600, -71.0 / 16695, 71.0 / 1920,
                          -17253.0 / 339200, 22.0 / 525, -1.0 / 40)


def _check(y, t, p_pack, u_pack, n_ph):
    """float64 and the shapes of `ops.window`'s single-DER window."""
    if y.dtype != torch.float64:
        raise ValueError(f"the float64 engine takes float64, got {y.dtype}")
    _check_single(y, t, p_pack, u_pack, n_ph)


def _prepared(y, t, p_pack, u_pack, n_ph):
    """The batch padded on the CPU, field-major: (n, y [n_s, N'], t [N'],
    params, exog, Prep, the namespace)."""
    n = y.shape[0]
    y, t, p_pack, u_pack = pad_envs(n, (y, 0), (t, 0), (p_pack, 1),
                                    (u_pack, 1))
    xp = like(y)
    p = unpack_struct(DERParams, p_pack, P_FIELDS, n_ph=n_ph)
    u = unpack_struct(Exog, u_pack, U_FIELDS)
    return n, y.T, t, p, u, rhs_core.prep_invariants(p, u, xp, bdims=1), xp


# ---------------------------------------------------------------------------
# N4: the right-hand side
# ---------------------------------------------------------------------------
def _rhs_ref(y, t, p_pack, u_pack, *, n_ph: int):
    """Plain torch dy/dt of every env: y [N, n_s], t [N] -> [N, n_s]."""
    _check(y, t, p_pack, u_pack, n_ph)
    n, yt, t, p, u, prep, xp = _prepared(y, t, p_pack, u_pack, n_ph)
    return rhs_core.rhs(yt, t, p, u, xp, prep).T[:n].contiguous()


def rhs_batch(y, t, p_pack, u_pack, *, n_ph: int):
    """dy/dt of every env at its own time. On the card: N4, one launch
    (``rhs_batch.launches``); on the CPU: `_rhs_ref`."""
    _check(y, t, p_pack, u_pack, n_ph)
    if y.device.type == "cpu":
        return _rhs_ref(y, t, p_pack, u_pack, n_ph=n_ph)
    dy = torch.empty_like(y)
    _build.launch("pvderx_native_rhs", "native rhs", y, t, p_pack, u_pack, dy,
                  y.shape[0], n_ph, check=(dy,))
    rhs_batch.launches += 1
    return dy


rhs_batch.launches = 0


# ---------------------------------------------------------------------------
# N1: the Kahan RK4 window
# ---------------------------------------------------------------------------
def rk4_batch(y, t0, p_pack, u_pack, *, n_ph: int, n_sub: int, dt: float):
    """n_sub Kahan-compensated RK4 substeps of every env over [t0, t0 + dt]
    (pvderx_native.cpp's arithmetic order, which is `ops.window`'s). On the
    card: N1, one launch (``rk4_batch.launches``); on the CPU:
    `ops.window.rk4_window_batch_ref` in float64."""
    _check(y, t0, p_pack, u_pack, n_ph)
    if y.device.type == "cpu":
        return rk4_window_batch_ref(y, t0, p_pack, u_pack, n_ph=n_ph,
                                    n_sub=n_sub, dt=dt)
    if n_sub < 1:
        raise ValueError(f"n_sub must be >= 1, got {n_sub}")
    out = torch.empty_like(y)
    _build.launch("pvderx_native_rk4_window", "native RK4 window", y, t0,
                  p_pack, u_pack, out, y.shape[0], n_ph, n_sub,
                  *_substep_constants(dt, n_sub), check=(out,))
    rk4_batch.launches += 1
    return out


rk4_batch.launches = 0


# ---------------------------------------------------------------------------
# N2: the adaptive Dormand-Prince 5(4) window
# ---------------------------------------------------------------------------
def _dp54_step(f, y, k1, t, h, rtol: float, atol: float):
    """One tried DP5(4) step of every env from (t, y), k1 = f(y, t) carried
    (FSAL); y, k1 [n_s, N], t, h [N]. Returns (y5, k7, err): the fifth-order
    solution, f at it, and the max-norm of the error estimate over the
    mixed tolerance. pvderx_native.cpp's arithmetic, expression by
    expression."""
    k2 = f(y + h * A21 * k1, t + C2 * h)
    k3 = f(y + h * (A31 * k1 + A32 * k2), t + C3 * h)
    k4 = f(y + h * (A41 * k1 + A42 * k2 + A43 * k3), t + C4 * h)
    k5 = f(y + h * (A51 * k1 + A52 * k2 + A53 * k3 + A54 * k4), t + C5 * h)
    k6 = f(y + h * (A61 * k1 + A62 * k2 + A63 * k3 + A64 * k4 + A65 * k5),
           t + h)
    y5 = y + h * (B1 * k1 + B3 * k3 + B4 * k4 + B5 * k5 + B6 * k6)
    k7 = f(y5, t + h)
    e = h * (E1 * k1 + E3 * k3 + E4 * k4 + E5 * k5 + E6 * k6 + E7 * k7)
    sc = atol + rtol * torch.maximum(y.abs(), y5.abs())
    return y5, k7, torch.amax(e.abs() / sc, dim=0)


def _std_max(a, b):
    """std::max(a, b) as pvderx_native.cpp calls it: (a < b) ? b : a."""
    return torch.where(a < b, b, a)


def _dp54_factor(err):
    """The step-size factor min(5, max(0.2, 0.9 err^-0.2))."""
    fac = 0.9 * _std_max(err, torch.full_like(err, 1e-16)) ** -0.2
    fac = _std_max(torch.full_like(fac, 0.2), fac)
    return torch.where(fac < 5.0, fac, torch.full_like(fac, 5.0))


def _dp54_window_ref(y, t0, p_pack, u_pack, *, n_ph: int, dt: float,
                     rtol: float = 1e-10, atol: float = 1e-10):
    """Plain torch adaptive DP5(4) over [t0, t0 + dt] for every env, each
    with its own step size: pvderx_native.cpp's control (first step dt/400,
    FSAL, accept at err <= 1, the factor clipped to [0.2, 5], the last step
    cut to the window's end, -1 when the step falls below 1e-14 or the
    guard runs out). The batch steps until its slowest env is done; an env
    that is done keeps its state. Returns (y1 [N, n_s], steps [N] int32:
    accepted steps or -1, tries [N] int32: steps tried)."""
    _check(y, t0, p_pack, u_pack, n_ph)
    n, yt, t, p, u, prep, xp = _prepared(y, t0, p_pack, u_pack, n_ph)

    def f(yy, tt):
        return rhs_core.rhs(yy, tt, p, u, xp, prep)

    t_end = t + dt
    h = torch.full_like(t, dt * DP54_H0)
    k1 = f(yt, t)
    steps = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    tries = torch.zeros_like(steps)
    live = torch.ones(t.shape, dtype=torch.bool, device=t.device)
    while True:
        run = live & (t < t_end) & (tries < DP54_GUARD)
        if not bool(run.any()):
            break
        h = torch.where(run & (t + h > t_end), t_end - t, h)
        y5, k7, err = _dp54_step(f, yt, k1, t, h, rtol, atol)
        ok = run & (err <= 1.0)
        t = torch.where(ok, t + h, t)
        yt = torch.where(ok, y5, yt)
        k1 = torch.where(ok, k7, k1)
        steps += ok.int()
        tries += run.int()
        adapt = run & ~(ok & (t >= t_end))
        h = torch.where(adapt, h * _dp54_factor(err), h)
        live &= ~(adapt & (h < 1e-14))
    steps = torch.where(live & (t >= t_end), steps, torch.full_like(steps, -1))
    return yt.T[:n].contiguous(), steps[:n].contiguous(), tries[:n].contiguous()


def dp54_batch(y, t0, p_pack, u_pack, *, n_ph: int, dt: float,
               rtol: float = 1e-10, atol: float = 1e-10):
    """One adaptive DP5(4) window of every env: (y1, steps, tries) as
    `_dp54_window_ref` gives them. On the card: N2, one launch
    (``dp54_batch.launches``); on the CPU: `_dp54_window_ref`."""
    _check(y, t0, p_pack, u_pack, n_ph)
    if y.device.type == "cpu":
        return _dp54_window_ref(y, t0, p_pack, u_pack, n_ph=n_ph, dt=dt,
                                rtol=rtol, atol=atol)
    out = torch.empty_like(y)
    steps = torch.empty(y.shape[0], dtype=torch.int32, device=y.device)
    tries = torch.empty_like(steps)
    _build.launch("pvderx_native_dp54_window", "native DP54 window", y, t0,
                  p_pack, u_pack, out, steps, tries, y.shape[0], n_ph,
                  float(dt), float(rtol), float(atol), check=(out,))
    dp54_batch.launches += 1
    return out, steps, tries


dp54_batch.launches = 0


# ---------------------------------------------------------------------------
# N3: the Newton steady state
# ---------------------------------------------------------------------------
def _newton_steady_ref(y, p_pack, u_pack, *, n_ph: int, iters: int = 50,
                       tol: float = 1e-11):
    """Plain torch Newton on rhs(y, 0) = 0 for every env from y [N, n_s]:
    pvderx_native.cpp's iteration (stop at max-abs residual < tol; the
    Jacobian by forward differences, column j from y_j + 1e-8·max(1,
    |y_j|); a full step), the solve by `torch.linalg.solve_ex` (LU with
    partial pivoting). An env that has converged keeps its state. Returns
    (y [N, n_s], iterations [N] int32, -1 where it did not converge or the
    Jacobian was singular)."""
    t0 = torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
    _check(y, t0, p_pack, u_pack, n_ph)
    n, yt, t, p, u, prep, xp = _prepared(y, t0, p_pack, u_pack, n_ph)

    def f(yy):
        return rhs_core.rhs(yy, t, p, u, xp, prep)

    res = torch.full(t.shape, -1, dtype=torch.int32, device=t.device)
    live = torch.ones(t.shape, dtype=torch.bool, device=t.device)
    for it in range(iters):
        f0 = f(yt)
        done = live & (torch.amax(f0.abs(), dim=0) < tol)
        res = torch.where(done, torch.full_like(res, it), res)
        live &= ~done
        if not bool(live.any()):
            break
        d = 1e-8 * torch.clamp(yt.abs(), min=1.0)
        cols = []
        for j in range(yt.shape[0]):
            yp = yt.clone()
            yp[j] = yt[j] + d[j]
            cols.append((f(yp) - f0) / d[j])
        jac = torch.stack(cols, dim=-1).permute(1, 0, 2)   # [N, row, col]
        step, info = torch.linalg.solve_ex(jac, -f0.T)
        live &= info == 0
        yt = torch.where(live, yt + step.T, yt)
    else:
        done = live & (torch.amax(f(yt).abs(), dim=0) < tol)
        res = torch.where(done, torch.full_like(res, iters), res)
    return yt.T[:n].contiguous(), res[:n].contiguous()


def newton_batch(y, p_pack, u_pack, *, n_ph: int, iters: int = 50,
                 tol: float = 1e-11):
    """Newton steady state of every env from y: (y, iterations) as
    `_newton_steady_ref` gives them. On the card: N3, one launch
    (``newton_batch.launches``); on the CPU: `_newton_steady_ref`."""
    t0 = torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
    _check(y, t0, p_pack, u_pack, n_ph)
    if y.device.type == "cpu":
        return _newton_steady_ref(y, p_pack, u_pack, n_ph=n_ph, iters=iters,
                                  tol=tol)
    out = torch.empty_like(y)
    res = torch.empty(y.shape[0], dtype=torch.int32, device=y.device)
    _build.launch("pvderx_native_newton_steady", "native Newton", y, p_pack,
                  u_pack, out, res, y.shape[0], n_ph, int(iters), float(tol),
                  check=(out,))
    newton_batch.launches += 1
    return out, res


newton_batch.launches = 0

LAUNCHERS = (rhs_batch, rk4_batch, dp54_batch, newton_batch)
