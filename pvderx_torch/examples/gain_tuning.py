"""Gradient-based controller-gain tuning through the simulated trajectory.

The DC-link PI gains are tuned by Adam against a tracking objective: the
Vdc excursion through a 0.6 pu voltage sag and its recovery. The gradient
flows through the eager RK4 windows (`pvderx_torch.ode.rk4_window`; the
window kernels have no backward), one `torch.utils.checkpoint` per window
so activation memory does not grow with the horizon. Each RHS evaluation
is ~250 small torch operations on one env, so a gradient is bound by the
host's dispatch, not by the card.

    python -m pvderx_torch.examples.gain_tuning --iters 40
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch


def make_loss(preset: str = "10", windows: int = 60, n_sub: int | None = None,
              dtype=torch.float32, device="cuda"):
    """(loss(gains) -> 0-d tensor, the preset's gains {"kp_dc", "ki_dc"} as
    0-d tensors): the mean squared Vdc error over ``windows`` 1/60 s
    windows from the steady state, with the grid at 0.6 pu over the middle
    third."""
    from torch.utils.checkpoint import checkpoint

    from pvderx_torch import make_params, nominal_exog
    from pvderx_torch._struct import tree_map
    from pvderx_torch.env.core import steady_state
    from pvderx_torch.ode import rk4_window
    from pvderx_torch.physics import rhs_core
    from pvderx_torch.physics.xp import TorchXP

    n_sub = n_sub or (72 if preset == "10" else 88)
    dt = 1.0 / 60.0
    p = make_params(preset).to(dtype, device)
    u0 = nominal_exog().to(dtype, device)
    u_sag = dataclasses.replace(u0, v_g=torch.tensor(0.6, dtype=dtype,
                                                     device=device))
    y0 = steady_state(tree_map(lambda a: a[None], p),
                      tree_map(lambda a: a[None], u0), iters=20)[0][0]
    i_vdc = 6 * p.n_ph
    sag_lo, sag_hi = windows // 3, 2 * windows // 3
    xp = TorchXP(dtype, device)

    def window(y, k, p2):
        u = u_sag if sag_lo <= k < sag_hi else u0
        return rk4_window(lambda yy, tt: rhs_core.rhs(yy, tt, p2, u, xp), y,
                          k * dt, dt, n_sub)

    def loss(gains):
        p2 = dataclasses.replace(p, kp_dc=gains["kp_dc"],
                                 ki_dc=gains["ki_dc"])
        y, errs = y0, []
        for k in range(windows):
            y = checkpoint(window, y, k, p2, use_reentrant=False)
            errs.append((y[i_vdc] - 1.0) ** 2)
        return torch.stack(errs).mean()

    return loss, {"kp_dc": p.kp_dc.clone(), "ki_dc": p.ki_dc.clone()}


def value_and_grad(loss, gains):
    """(loss, {name: d loss / d gain}) at ``gains``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in gains.items()}
    v = loss(leaves)
    grads = torch.autograd.grad(v, list(leaves.values()))
    return v.detach(), dict(zip(leaves, grads))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="10")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--windows", type=int, default=60, help="1/60 s windows")
    ap.add_argument("--n-sub", type=int, default=None,
                    help="RK4 substeps/window; default = the per-preset 1e-6 "
                         "knee (72 single-phase, 88 three-phase; SPEC §6)")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from pvderx_torch.utils import get_logger

    log = get_logger("examples.gain_tuning")
    loss, gains = make_loss(args.preset, args.windows, args.n_sub,
                            device="cpu" if args.cpu else "cuda")
    gains = {k: v.requires_grad_(True) for k, v in gains.items()}
    opt = torch.optim.Adam(list(gains.values()),
                           lr=args.lr * gains["kp_dc"].item())

    t0 = time.perf_counter()
    for i in range(args.iters):
        opt.zero_grad()
        v = loss(gains)
        v.backward()
        opt.step()
        if i % 10 == 0 or i == args.iters - 1:
            log.info("iter %d: loss=%.3e kp_dc=%.4f ki_dc=%.4f", i,
                     v.item(), gains["kp_dc"].item(), gains["ki_dc"].item())
    with torch.no_grad():
        final = float(loss(gains))
    log.info("done in %.1fs: Vdc sag-tracking loss improved to %.3e",
             time.perf_counter() - t0, final)
    return final


if __name__ == "__main__":
    main()
