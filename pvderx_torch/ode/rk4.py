"""Fixed-step RK4 over one control window, Kahan-compensated.

Substep times are ``t0 + k*h`` (not accumulated) so float32 rollouts don't
drift. The state update is Kahan-compensated (SPEC.md §6): the per-substep
increment is small relative to the state, so a plain ``y += delta`` loses
~ulp(|y|) per substep and random-walks over an episode; carrying the
rounding residue in ``c`` removes the walk. The arithmetic order is fixed and
shared with the numpy oracle (`pvderx_torch.oracle.rk4_window_np`), the plain
window (`pvderx_torch.ops.window.rk4_window_batch_ref`) and the CUDA kernel.
"""
from __future__ import annotations

import torch


def rk4_step(f, y, t, h):
    """One classical RK4 step (uncompensated; kept for single-step callers)."""
    return y + rk4_delta(f, y, t, h)


def rk4_delta(f, y, t, h):
    """The RK4 state increment (h/6)·(k1+2k2+2k3+k4) without applying it."""
    k1 = f(y, t)
    k2 = f(y + 0.5 * h * k1, t + 0.5 * h)
    k3 = f(y + 0.5 * h * k2, t + 0.5 * h)
    k4 = f(y + h * k3, t + h)
    return (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def kahan_add(y, c, delta):
    """One Kahan compensated accumulation step: returns (y', c') with
    y' ≈ y + delta and c' carrying the rounding residue. Arithmetic order is
    frozen (module docstring)."""
    d = delta - c
    s = y + d
    c = (s - y) - d
    return s, c


def rk4_window(f, y0, t0, dt, n_sub: int):
    """Integrate y' = f(y, t) from t0 to t0+dt with n_sub fixed RK4 steps,
    Kahan-compensated. A Python loop over the substeps."""
    h = dt / n_sub
    y, c = y0, torch.zeros_like(y0)
    for k in range(n_sub):
        y, c = kahan_add(y, c, rk4_delta(f, y, t0 + k * h, h))
    return y
