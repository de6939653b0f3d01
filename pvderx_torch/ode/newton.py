"""Damped Newton solver for the steady-state initialization, batched.

The Jacobian of one env's residual is taken by `torch.func.jacfwd` and
vectorized over the env batch by `torch.func.vmap`; the steps are one batched
`torch.linalg.solve_ex`. Fixed iteration count, no data-dependent control
flow.

The step is globalized with a branchless backtracking line search (step
scales 1, 1/2, 1/4, 1/16, pick the candidate with the smallest residual
norm): plain full-step Newton diverges on some inits under aggressive
scenario randomization, because the diode exponential overshoots when the
warm start is far from the basin.
"""
from __future__ import annotations

import torch

_STEP_SCALES = (1.0, 0.5, 0.25, 0.0625)


def _res_norm(r):
    """Per-env max-abs residual; a non-finite residual ranks last."""
    n = torch.amax(torch.abs(r), dim=-1)
    return torch.where(torch.isfinite(n), n, torch.full_like(n, float("inf")))


def newton_solve(f, y0, *args, iters: int = 30, damping: float = 1.0):
    """Solve f(y, *args) = 0 for every env of a batch.

    ``f`` maps ONE env's state [n_s] (and its slices of ``args``) to its
    residual [n_s]; ``y0`` is [N, n_s] and every tensor of ``args`` has the
    env axis leading. Returns (y [N, n_s], max_abs_residual [N]).
    """
    fb = torch.func.vmap(f)
    jac = torch.func.vmap(torch.func.jacfwd(f, argnums=0))
    y = y0
    for _ in range(iters):
        r = fb(y, *args)
        # under vmap, forward-mode tangents through 0-d operands mixed with
        # Python floats come out as float64 (the floats lose their weak
        # type); the residual keeps the state's dtype, so cast the Jacobian
        # back to it
        j = jac(y, *args).to(y.dtype)
        dy = torch.linalg.solve_ex(j, r.unsqueeze(-1))[0].squeeze(-1)
        # guard: if the solve produced non-finite values, keep the iterate
        dy = torch.where(torch.isfinite(dy), dy, torch.zeros_like(dy))
        # backtracking as a select chain; ties keep the larger step, so at
        # convergence this reduces to full-step Newton
        best_y = y - damping * _STEP_SCALES[0] * dy
        best_n = _res_norm(fb(best_y, *args))
        for s in _STEP_SCALES[1:]:
            yc = y - damping * s * dy
            n = _res_norm(fb(yc, *args))
            better = n < best_n
            best_y = torch.where(better[:, None], yc, best_y)
            best_n = torch.where(better, n, best_n)
        y = best_y
    return y, torch.amax(torch.abs(fb(y, *args)), dim=-1)
