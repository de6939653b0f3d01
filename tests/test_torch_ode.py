"""The port's ODE layer (pvderx_torch/ode) and numpy oracle against the
reference.

- The torch float64 `rk4_window` equals the reference numpy oracle
  `pvderx.oracle.scipy_ref.rk4_window_np` (same Kahan order) to 1e-12.
- The port's own numpy oracle (`pvderx_torch.oracle`) equals the reference's.
- The batched Newton init reaches a residual <= 1e-9 in float64 (SPEC §7).
"""
import dataclasses
from functools import partial

import jax  # noqa: F401  (conftest pins JAX to the CPU in float64)
import numpy as np
import pytest
import torch

from pvderx.oracle import scipy_ref
from pvderx.params import make_params as jax_make_params
from pvderx.params import nominal_exog as jax_nominal_exog
from pvderx_torch import oracle
from pvderx_torch.env import core
from pvderx_torch.ode import kahan_add, newton_solve, rk4_window
from pvderx_torch.ops.window import P_FIELDS, U_FIELDS
from pvderx_torch.params import DERParams, Exog, make_params, nominal_exog
from pvderx_torch.physics import rhs_core
from pvderx_torch.physics.xp import TorchXP

DT = 1.0 / 60.0


def _port_pu(p, u):
    f = lambda v: torch.tensor(v, dtype=torch.float64)
    pt = DERParams(n_ph=p.n_ph, **{k: f(getattr(p, k)) for k in P_FIELDS})
    ut = Exog(**{k: f(getattr(u, k)) for k in U_FIELDS})
    return pt, ut


@pytest.mark.parametrize("preset,n_sub", [("10", 40), ("50", 48)])
def test_torch_rk4_window_matches_numpy_oracle(preset, n_sub):
    p = jax_make_params(preset)
    u = dataclasses.replace(jax_nominal_exog(), v_g=0.55, dw_g=0.004, t_g=0.1)
    rng = np.random.default_rng(int(preset))
    y0 = scipy_ref.steady_state(p, jax_nominal_exog())
    y0 = y0 + 1e-3 * rng.standard_normal(y0.shape)
    want = scipy_ref.rk4_window_np(y0, 0.25, DT, n_sub, p, u)
    pt, ut = _port_pu(p, u)
    xp = TorchXP()
    got = rk4_window(lambda y, t: rhs_core.rhs(y, t, pt, ut, xp),
                     torch.from_numpy(y0), 0.25, DT, n_sub)
    assert np.abs(got.numpy() - want).max() <= 1e-12 * max(1.0, np.abs(want).max())


def test_torch_kahan_add_order():
    """(y', c') of one compensated step, bitwise, against the reference's
    frozen order."""
    from pvderx.ode.rk4 import kahan_add as ref_kahan
    rng = np.random.default_rng(1)
    y, c, d = (rng.standard_normal(64) for _ in range(3))
    d *= 1e-9
    want = ref_kahan(y, c, d)
    got = kahan_add(*(torch.from_numpy(a) for a in (y, c, d)))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("preset", ["10", "50"])
def test_torch_oracle_matches_reference_oracle(preset):
    """The port's numpy oracle (its own rhs_core copy) equals the reference
    oracle: steady state, an LSODA window and an RK4 window."""
    p_ref = jax_make_params(preset)
    u_ref = dataclasses.replace(jax_nominal_exog(), v_g=0.7)
    p = make_params(preset)
    u = dataclasses.replace(nominal_exog(), v_g=0.7)
    y_ref = scipy_ref.steady_state(p_ref, jax_nominal_exog())
    y = oracle.steady_state(p, nominal_exog())
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        oracle.rk4_window_np(y, 0.0, DT, 40, p, u),
        scipy_ref.rk4_window_np(y_ref, 0.0, DT, 40, p_ref, u_ref),
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        oracle.integrate_window(y, 0.0, DT, p, u),
        scipy_ref.integrate_window(y_ref, 0.0, DT, p_ref, u_ref),
        rtol=0, atol=1e-10)


def test_torch_gate_scenario_matches_bench():
    """The port's copy of the gate scenario equals bench.gate_scenario_exogs."""
    import bench
    want = bench.gate_scenario_exogs(120)
    got = oracle.gate_scenario_exogs(120)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("preset", ["10", "50"])
def test_torch_newton_reaches_1e9(preset):
    """Batched Newton from the analytic guess, per-env heterogeneous params
    and exog (float64): every env's residual <= 1e-9."""
    n = 4
    rng = np.random.default_rng(5)
    p = make_params(preset)
    u = nominal_exog()
    pk = torch.tensor([[getattr(p, f)] * n for f in P_FIELDS], dtype=torch.float64)
    uk = torch.tensor([[getattr(u, f)] * n for f in U_FIELDS], dtype=torch.float64)
    pk[P_FIELDS.index("rg")] *= torch.from_numpy(1.0 + 0.3 * rng.uniform(-1, 1, n))
    uk[U_FIELDS.index("s_irr")] = torch.from_numpy(rng.uniform(600, 1000, n))
    kw = dict(n_ph=p.n_ph, xp=TorchXP(torch.float64))
    pk, uk = pk.T.contiguous(), uk.T.contiguous()
    guess = torch.func.vmap(partial(core._guess_one, **kw))(pk, uk)
    y, res = newton_solve(partial(core._rhs_one, **kw), guess, pk, uk, iters=20)
    assert y.shape == guess.shape and res.shape == (n,)
    assert float(res.max()) <= 1e-9, res
    # the fixed point is the oracle's steady state for env 0's inputs
    p0 = dataclasses.replace(p, rg=float(pk[0, P_FIELDS.index("rg")]))
    u0 = dataclasses.replace(u, s_irr=float(uk[0, U_FIELDS.index("s_irr")]))
    np.testing.assert_allclose(y[0].numpy(), oracle.steady_state(p0, u0),
                               rtol=0, atol=1e-8)
