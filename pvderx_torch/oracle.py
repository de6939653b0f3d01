"""Scipy reference implementation — the numerical truth oracle, in numpy.

Runs the port's own `rhs_core` on numpy float64 (``xp = numpy``). Per
SPEC.md §6, LSODA at rtol=atol=1e-10 window-stepped on the 1/60 s grid is
"truth"; the fixed-step RK4 paths are held against it. Parameters and exog
are `DERParams`/`Exog` with Python-float (or numpy) leaves; a fleet's have
float64 [M] leaves, and its state is [M, n_s].
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.integrate import solve_ivp
from scipy.optimize import fsolve

from pvderx_torch.params import DERParams, Exog, nominal_exog
from pvderx_torch.physics import fleet, rhs_core

RTOL = 1e-10
ATOL = 1e-10


def rhs_np(y, t, p: DERParams, u: Exog):
    return rhs_core.rhs(np.asarray(y, dtype=np.float64), t, p, u, np)


def steady_state(p: DERParams, u: Exog):
    """fsolve-based steady-state init."""
    y0 = rhs_core.steady_state_guess(p, u, np)
    sol, info, ier, msg = fsolve(
        lambda y: rhs_np(y, 0.0, p, u), y0, xtol=1e-13, full_output=True
    )
    res = np.max(np.abs(rhs_np(sol, 0.0, p, u)))
    if ier != 1 and res > 1e-8:
        raise RuntimeError(f"oracle steady-state solve failed: {msg} (res={res:.3e})")
    return sol


def integrate_window(y, t0, dt, p: DERParams, u: Exog, rtol=RTOL, atol=ATOL):
    """One control window with LSODA at truth tolerances (SPEC.md §6)."""
    sol = solve_ivp(
        lambda t, yy: rhs_np(yy, t, p, u),
        (t0, t0 + dt), np.asarray(y, dtype=np.float64),
        method="LSODA", rtol=rtol, atol=atol,
    )
    if not sol.success:
        raise RuntimeError(f"oracle LSODA failed at t0={t0}: {sol.message}")
    return sol.y[:, -1]


def rk4_window_np(y, t0, dt, n_sub: int, p: DERParams, u: Exog):
    """Numpy fixed-step RK4 window with the Kahan-compensated accumulation in
    the same arithmetic order as `pvderx_torch.ode.rk4.rk4_window`."""
    h = dt / n_sub
    y = np.asarray(y, dtype=np.float64)
    c = np.zeros_like(y)
    for k in range(n_sub):
        t = t0 + k * h
        k1 = rhs_np(y, t, p, u)
        k2 = rhs_np(y + 0.5 * h * k1, t + 0.5 * h, p, u)
        k3 = rhs_np(y + 0.5 * h * k2, t + 0.5 * h, p, u)
        k4 = rhs_np(y + h * k3, t + h, p, u)
        d = ((h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)) - c
        s = y + d
        c = (s - y) - d
        y = s
    return y


def run_trajectory(p: DERParams, exog_seq, y0=None, dt=1.0 / 60.0, rtol=RTOL,
                   atol=ATOL):
    """Window-stepped trajectory with per-window exogenous inputs (ZOH).

    exog_seq: list of Exog, one per control step. Returns [n_steps+1, n_states]
    states at window boundaries.
    """
    if y0 is None:
        y0 = steady_state(p, exog_seq[0])
    ys = [np.asarray(y0, dtype=np.float64)]
    for k, u in enumerate(exog_seq):
        ys.append(integrate_window(ys[-1], k * dt, dt, p, u, rtol, atol))
    return np.stack(ys)


def gate_scenario_exogs(n_steps: int = 120):
    """The fixed eventful gate scenario of the f32 accuracy gate (settle /
    cloud step to 400 W/m² / 0.55 pu deep sag / +0.5 Hz frequency
    excursion) as a ZOH exog list, one quarter each."""
    u = nominal_exog()
    dt = 1.0 / 60.0
    q = n_steps // 4
    exogs = []
    for k in range(n_steps):
        if k < q:
            exogs.append(u)                                    # settle
        elif k < 2 * q:
            exogs.append(dataclasses.replace(u, s_irr=400.0))  # cloud step
        elif k < 3 * q:
            exogs.append(dataclasses.replace(u, v_g=0.55))     # deep sag
        else:
            exogs.append(dataclasses.replace(u, dw_g=0.5 / 60.0,
                                             t_g=3 * q * dt))  # freq excursion
    return exogs


# ---------------------------------------------------------------------------
# the fleet: M DERs on a shared feeder (SPEC.md §11)
# ---------------------------------------------------------------------------
def fleetify_np(tree, m: int):
    """Broadcast every scalar leaf of a params/exog dataclass to a float64
    [M] array (array leaves are kept)."""
    return dataclasses.replace(tree, **{
        f.name: np.broadcast_to(np.asarray(getattr(tree, f.name), np.float64),
                                (m,)).copy()
        for f in dataclasses.fields(tree) if f.name != "n_ph"})


def fleet_rhs_np(Y, t, fp, fu):
    """dY/dt of one fleet; Y [M, n_s], fp/fu leaves [M]. All units at once:
    the state goes to rhs_core as [n_s, M] (the unit axis trailing)."""
    return fleet.fleet_rhs(np.asarray(Y, np.float64).T, t, fp, fu, np).T


def _unit(tree, k: int):
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name)[k] for f in dataclasses.fields(tree)
        if f.name != "n_ph"})


def fleet_steady_state(fp, fu):
    """fsolve-based coupled steady state [M, n_s] over all M·n_s unknowns,
    from the stacked single-DER guesses."""
    m = len(fu.conn)
    g = np.stack([rhs_core.steady_state_guess(_unit(fp, k), _unit(fu, k), np)
                  for k in range(m)])
    f = lambda yf: fleet_rhs_np(yf.reshape(g.shape), 0.0, fp, fu).reshape(-1)
    sol, info, ier, msg = fsolve(f, g.reshape(-1), xtol=1e-13,
                                 full_output=True)
    res = np.max(np.abs(f(sol)))
    if ier != 1 and res > 1e-8:
        raise RuntimeError(
            f"oracle fleet steady-state solve failed: {msg} (res={res:.3e})")
    return sol.reshape(g.shape)


def integrate_fleet_window(Y, t0, dt, fp, fu, rtol=RTOL, atol=ATOL):
    """One control window of the coupled [M·n_s] system with LSODA at truth
    tolerances."""
    shape = np.shape(Y)
    sol = solve_ivp(
        lambda t, yy: fleet_rhs_np(yy.reshape(shape), t, fp, fu).reshape(-1),
        (t0, t0 + dt), np.asarray(Y, np.float64).reshape(-1),
        method="LSODA", rtol=rtol, atol=atol)
    if not sol.success:
        raise RuntimeError(f"fleet oracle LSODA failed at t0={t0}: {sol.message}")
    return sol.y[:, -1].reshape(shape)


def run_fleet_trajectory(fp, fu_seq, y0=None, dt=1.0 / 60.0, rtol=RTOL,
                         atol=ATOL):
    """Window-stepped coupled trajectory, one fleet exog per control step
    (ZOH). Returns [n_steps+1, M, n_s] states at window boundaries."""
    if y0 is None:
        y0 = fleet_steady_state(fp, fu_seq[0])
    ys = [np.asarray(y0, np.float64)]
    for k, fu in enumerate(fu_seq):
        ys.append(integrate_fleet_window(ys[-1], k * dt, dt, fp, fu, rtol,
                                         atol))
    return np.stack(ys)


def fleet_gate_scenario(p: DERParams, m: int, n_steps: int = 36):
    """The fleet accuracy gate's scenario: per-unit partial clouding
    (insolation scaled by linspace(1, 0.75, M)), then thirds of nominal,
    a cloud step to 400 W/m² and a 0.6 pu sag. Returns (fp, [fu] * n_steps)
    with [M] leaves."""
    s_scale = np.linspace(1.0, 0.75, m)

    def fu_at(u):
        fu = fleetify_np(u, m)
        return dataclasses.replace(fu, s_irr=fu.s_irr * s_scale)

    u = nominal_exog()
    q = n_steps // 3
    fus = [fu_at(u)] * q
    fus += [fu_at(dataclasses.replace(u, s_irr=400.0))] * q
    fus += [fu_at(dataclasses.replace(u, v_g=0.6))] * (n_steps - 2 * q)
    return fleetify_np(p, m), fus
