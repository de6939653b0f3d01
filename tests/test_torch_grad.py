"""Gradients through the port's fixed-step windows, against `tests/test_grad.py`.

The reference differentiates its loss with `jax.grad` through the `lax.scan`
RK4 windows. The port's window kernels have no backward, so gradients go
through the eager window, `pvderx_torch.ode.rk4_window`, with a `DERParams`
gain that is a tensor requiring grad. In float64 on the CPU:

- the port's steady state (the oracle's fsolve) equals the reference's
  Newton solve to <= 1e-12;
- the gradient of test_grad.py's loss (Vdc tracking error over 6 windows of
  a sustained 0.7 pu sag, 40 substeps each) with respect to ``kp_dc``
  equals `jax.grad` of the reference's to <= 1e-9 relative, and a central
  finite difference of the port's loss to <= 1e-5 relative (the reference
  test's tolerance);
- five gradient steps on ``kp_dc`` lower the loss, as in the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx_torch import make_params, nominal_exog, oracle
from pvderx_torch.ode import rk4_window
from pvderx_torch.physics import rhs_core
from pvderx_torch.physics.xp import TorchXP

DT = 1.0 / 60.0
N_SUB = 40
N_WIN = 6


def _setup(dtype=torch.float64):
    p0, u0 = make_params("10"), nominal_exog()
    y0 = oracle.steady_state(p0, u0)
    p = p0.to(dtype, "cpu")
    u = dataclasses.replace(u0, v_g=0.7).to(dtype, "cpu")
    return p, u, torch.tensor(y0, dtype=dtype)


def _loss(kp_dc, p, u, y0):
    """Vdc tracking error over N_WIN windows of a sustained 0.7 pu sag."""
    p2 = dataclasses.replace(p, kp_dc=kp_dc)
    xp = TorchXP(y0.dtype, y0.device)
    y, total = y0, 0.0
    for k in range(N_WIN):
        y = rk4_window(lambda yy, tt: rhs_core.rhs(yy, tt, p2, u, xp), y,
                       k * DT, DT, N_SUB)
        total = total + (y[6] - u.vdc_ref) ** 2
    return total


def _grad(kp, p, u, y0):
    kp = kp.detach().requires_grad_(True)
    loss = _loss(kp, p, u, y0)
    (g,) = torch.autograd.grad(loss, kp)
    return loss.item(), g.item()


@pytest.fixture(scope="module")
def reference():
    """(kp_dc, y0, jax.grad of test_grad.py's loss) from the reference."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).with_name("test_grad.py")
    spec = importlib.util.spec_from_file_location("_ref_test_grad", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    p, u, y0 = ref._setup()
    kp = jnp.asarray(p.kp_dc, jnp.float64)
    g = jax.jit(jax.grad(ref._loss))(kp, p, u, y0)
    return float(kp), np.asarray(y0), float(g)


def test_torch_grad_matches_jax_and_finite_difference(reference):
    kp_ref, y0_ref, g_ref = reference
    p, u, y0 = _setup()
    np.testing.assert_allclose(y0.numpy(), y0_ref, rtol=0, atol=1e-12)
    kp = torch.tensor(kp_ref, dtype=torch.float64)
    _, g = _grad(kp, p, u, y0)
    assert np.isfinite(g) and g != 0.0
    np.testing.assert_allclose(g, g_ref, rtol=1e-9)
    eps = 1e-5 * max(abs(kp_ref), 1.0)
    with torch.no_grad():
        fd = (float(_loss(kp + eps, p, u, y0))
              - float(_loss(kp - eps, p, u, y0))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-5)


def test_torch_gradient_step_reduces_tracking_error():
    """test_grad.py's five steps on kp_dc, through the port's eager window."""
    p, u, y0 = _setup()
    kp = torch.tensor(p.kp_dc.item(), dtype=torch.float64)
    loss0, g = _grad(kp, p, u, y0)
    lr = 0.05 * abs(float(kp)) / max(abs(g), 1e-12)
    for _ in range(5):
        kp = kp - lr * _grad(kp, p, u, y0)[1]
    with torch.no_grad():
        assert float(_loss(kp, p, u, y0)) < loss0
