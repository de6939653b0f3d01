"""Implicit (A-stable) fixed-step integrators, batched: the trapezoidal rule
and backward Euler. The counterpart of `pvderx/ode/implicit.py:25-75`.

Explicit RK4 needs h·|λ|max < 2.785 (n_sub >= 40 per control step for the
shipped presets); the trapezoidal rule is A-stable and backward Euler
L-stable, so n_sub can drop well below that where throughput matters more
than per-step accuracy order.

Each substep solves its nonlinear system for every env of the batch with a
FIXED number of Newton iterations (3), seeded with the previous state (an
explicit-Euler predictor diverges in the stiff regime these integrators
exist for). A non-finite Newton step is dropped, as in the reference. The
per-env linear solves are one batched `torch.linalg.solve_ex`.

The Jacobian is exact forward-mode differentiation by the complex step: the
state of every env is copied K times (K = its number of unknowns), copy j
carrying the j-th tangent direction, scaled by 2^-100 (float64) or 2^-66
(float32), in its imaginary part; one evaluation of the RHS on that complex
batch gives f(y) in the real part and df/dy_j in the imaginary part of copy
j. For a RHS built from real-analytic operations and selections (the
physics core: `TorchXP.maximum`/`minimum` select by the real part) this is
forward-mode AD with the tangent's second-order terms (~2^-200 relative)
below the last bit. It replaces the reference's `jax.jacfwd`: torch's
`vmap(jacfwd)` computes the same numbers, but its forward-mode dispatch of
every operation that mixes a dual tensor with a plain one or a Python
number goes through Python reference decompositions (torch 2.13 on a CPU
host: 40.9 ms per Jacobian of one env's RHS, against 2.4 ms for the
complex batch), and the implicit step
runs 3 Jacobians per substep. The steady-state Newton of reset
(`ode.newton`) takes its Jacobian the same way.

These windows launch no custom kernel: on the card every product and the
batched LU are torch calls, as the reference runs them outside Pallas.
"""
from __future__ import annotations

import torch

# the complex step per dtype: powers of two, so dividing by them is exact
_STEP = {torch.float64: 2.0 ** -100, torch.float32: 2.0 ** -66}


def rhs_and_jacobian(f, y):
    """(f(y), df/dy) of every env of a batch.

    ``f`` maps a batch y [N, *shape] to a result of the same shape; it is
    called once, on a complex y [N, K, *shape] (K = the number of entries of
    *shape: K copies of each env), and must broadcast each env's inputs over
    the copies. Returns (f [N, *shape], J [N, K, K]) with J[n, i, j] =
    d f_i / d y_j over the row-major flattened state.
    """
    n, shape = y.shape[0], tuple(y.shape[1:])
    k = y[0].numel()
    step = _STEP[y.dtype]
    tangents = (step * torch.eye(k, dtype=y.dtype, device=y.device)).reshape(
        1, k, *shape)
    yc = torch.complex(y.unsqueeze(1).expand(n, k, *shape),
                       tangents.expand(n, k, *shape))
    out = f(yc)
    jac = (out.imag / step).reshape(n, k, k).transpose(1, 2)
    return out.real[:, 0], jac


def _newton_step(f, y, t1, c, f0, iters: int):
    """Solve y1 = y + c·(f0 + f(y1, t1)) (``f0`` None: y + c·f(y1, t1)) for
    every env by ``iters`` Newton iterations from y1 = y."""
    n, k = y.shape[0], y[0].numel()
    eye = torch.eye(k, dtype=y.dtype, device=y.device)
    y1 = y
    for _ in range(iters):
        f1, jf = rhs_and_jacobian(lambda yy: f(yy, t1), y1)
        g = y1 - y - c * (f1 if f0 is None else f0 + f1)
        dy = torch.linalg.solve_ex(eye - c * jf, g.reshape(n, k, 1))[0]
        dy = dy.reshape(y.shape)
        # guard: a non-finite solve keeps the iterate
        y1 = y1 - torch.where(torch.isfinite(dy), dy, torch.zeros_like(dy))
    return y1


def trapezoid_window(f, y0, t0, dt: float, n_sub: int, newton_iters: int = 3):
    """Integrate y' = f(y, t) over [t0, t0 + dt] with n_sub trapezoidal
    steps, every env of the batch at once: y0 [N, *shape], t0 [N].

    y1 solves y1 = y0 + h/2·(f(y0, t) + f(y1, t + h)), with t = t0 + k·h per
    env; second-order accurate, A-stable. ``f(y, t)`` maps y [N, *shape] and
    t [N] to dy/dt; for the Jacobian it is also called on complex copies of
    each env's state, y [N, K, *shape], as `rhs_and_jacobian` describes.
    """
    h = dt / n_sub
    y = y0
    for k in range(n_sub):
        t = t0 + k * h
        y = _newton_step(f, y, t + h, 0.5 * h, f(y, t), newton_iters)
    return y


def backward_euler_window(f, y0, t0, dt: float, n_sub: int,
                          newton_iters: int = 3):
    """L-stable first-order window: y1 = y0 + h·f(y1, t + h) per substep.
    Heavier damping than the trapezoidal rule (no ringing on very stiff
    transients). Arguments as in `trapezoid_window`."""
    h = dt / n_sub
    y = y0
    for k in range(n_sub):
        y = _newton_step(f, y, t0 + k * h + h, h, None, newton_iters)
    return y


# the implicit window schemes by `EnvConfig.integrator` name
WINDOWS = {"trapezoid": trapezoid_window,
           "backward_euler": backward_euler_window}
