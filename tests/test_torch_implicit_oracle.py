"""The port's implicit windows against the float64 LSODA truth: the twin of
tests/test_variants.py:84-107.

The steady state of preset 10, then 90 windows (30 nominal, 30 under a
0.5 pu sag, 30 nominal) through each implicit window of
`pvderx_torch.ode.implicit` at far-sub-RK4 substep counts, against the
port's LSODA oracle (`pvderx_torch.oracle.integrate_window`, rtol = atol =
1e-10) on the same exog, compared after the last window as the reference does:
trapezoid <= 5e-6 at n_sub 10 and <= 1e-6 at 20,
backward Euler <= 5e-5 at 40 (the reference's bounds, float64).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from pvderx_torch import make_params, nominal_exog, oracle
from pvderx_torch.env import core
from pvderx_torch.ode import backward_euler_window, trapezoid_window
from pvderx_torch.ops.window import P_FIELDS, U_FIELDS
from pvderx_torch.params import DERParams, Exog

DT = 1.0 / 60.0
N_WINDOWS = 90


def _exog(k):
    u = nominal_exog()
    return dataclasses.replace(u, v_g=0.5) if 30 <= k < 60 else u


@functools.cache
def _truth():
    p = make_params("10")
    return oracle.run_trajectory(p, [_exog(k) for k in range(N_WINDOWS)])


@pytest.mark.parametrize("window,n_sub,tol", [
    (trapezoid_window, 10, 5e-6),
    (trapezoid_window, 20, 1e-6),
    (backward_euler_window, 40, 5e-5),
], ids=["trapezoid-10", "trapezoid-20", "backward_euler-40"])
def test_torch_implicit_window_vs_lsoda(window, n_sub, tol):
    truth = _truth()
    p = make_params("10")
    f = lambda a: torch.tensor([float(a)], dtype=torch.float64)
    der = DERParams(n_ph=1, **{k: f(getattr(p, k)) for k in P_FIELDS})
    y = torch.from_numpy(truth[0])[None]
    for k in range(N_WINDOWS):
        u = _exog(k)
        exog = Exog(**{name: f(getattr(u, name)) for name in U_FIELDS})
        y = window(functools.partial(core._rhs, der=der, exog=exog), y,
                   f(k * DT), DT, n_sub)
    err = float(np.abs(y[0].numpy() - truth[-1]).max())
    assert np.isfinite(err) and err < tol, err
