"""The port's fleet physics (pvderx_torch/physics/fleet.py) and numpy fleet
oracle against `pvderx.physics.fleet`.

- `fleet_rhs` and `fleet_algebra` on torch float64 equal the JAX package's,
  both its JAX and its numpy backend, to 1e-12 relative to max |reference|,
  for presets 10 and 50 (unbalanced), M in {1, 3}, per-unit heterogeneous
  insolation, connection and setpoints, one fleet [n_s, M] and a batch of
  fleets [n_s, N, M].
- `oracle.fleet_rhs_np` (all units at once, no loop over M) equals the
  reference's numpy `fleet_rhs` (a loop over M) to 1e-12, and the
  coupled `oracle.fleet_steady_state` is a steady state of the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.params import DERParams as JaxDERParams
from pvderx.params import Exog as JaxExog
from pvderx.params import make_params as jax_make_params
from pvderx.params import nominal_exog as jax_nominal_exog
from pvderx.physics import fleet as jfl
from pvderx_torch import oracle
from pvderx_torch.params import DERParams, Exog, make_params
from pvderx_torch.physics import fleet
from pvderx_torch.physics.xp import TorchXP

REL_TOL = 1e-12
CASES = [("10", 1), ("10", 3), ("50", 1), ("50", 3)]


def _fleet_np(preset, m, seed):
    """Reference numpy fleet params/exog ([M] leaves) and a state [M, n_s]."""
    rng = np.random.default_rng(seed)
    p = jax_make_params(preset)
    u = dataclasses.replace(jax_nominal_exog(),
                            v_g2=0.1 if preset == "50" else 0.0, phi_g2=0.7,
                            v_g=0.9, dw_g=0.004, t_g=0.1, g_load=0.1)
    fp, fu = jfl.fleetify(p, m, np), jfl.fleetify(u, m, np)
    fu = dataclasses.replace(
        fu, s_irr=fu.s_irr * rng.uniform(0.7, 1.0, m),
        conn=(np.arange(m) != 1).astype(float),
        q_ref=rng.uniform(-0.1, 0.1, m), vdc_ref=rng.uniform(0.95, 1.05, m))
    guess = jfl.fleet_guess(fp, fu, np)
    return fp, fu, guess + 0.02 * rng.standard_normal(guess.shape)


def _torch(tree, cls):
    kw = {f.name: torch.as_tensor(np.array(getattr(tree, f.name), np.float64))
          for f in dataclasses.fields(cls) if f.name != "n_ph"}
    return cls(n_ph=tree.n_ph, **kw) if cls is DERParams else cls(**kw)


def _jnp(tree):
    return jax.tree.map(lambda l: jnp.asarray(l, jnp.float64), tree)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL_TOL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("preset,m", CASES)
def test_torch_fleet_rhs_matches_reference(preset, m):
    fp, fu, y = _fleet_np(preset, m, 1)
    want_np = jfl.fleet_rhs(y, 0.3, fp, fu, np)
    want_jx = jfl.fleet_rhs(jnp.asarray(y), jnp.float64(0.3), _jnp(fp),
                            _jnp(fu), jnp)
    got = fleet.fleet_rhs(torch.from_numpy(y.T.copy()),
                          torch.tensor(0.3, dtype=torch.float64),
                          _torch(fp, DERParams), _torch(fu, Exog), TorchXP())
    _close(got.numpy().T, want_np)
    _close(got.numpy().T, want_jx)


@pytest.mark.parametrize("preset,m", CASES)
def test_torch_fleet_batch_matches_reference_per_env(preset, m):
    """A batch [n_s, N, M] of fleets with per-env states and times equals
    the reference evaluated one fleet at a time."""
    fp, fu, _ = _fleet_np(preset, m, 2)
    ys = [_fleet_np(preset, m, 10 + k)[2] for k in range(3)]
    ts = [0.1, 0.25, 0.4]
    batch = lambda tree, cls: _torch(jax.tree.map(
        lambda l: np.broadcast_to(l, (3, m)), tree), cls)
    got = fleet.fleet_rhs(torch.from_numpy(np.stack(ys).transpose(2, 0, 1).copy()),
                          torch.tensor(ts, dtype=torch.float64)[:, None],
                          batch(fp, DERParams), batch(fu, Exog), TorchXP())
    for k in range(3):
        _close(got[:, k].numpy().T, jfl.fleet_rhs(ys[k], ts[k], fp, fu, np))


@pytest.mark.parametrize("preset,m", CASES)
def test_torch_fleet_algebra_matches_reference(preset, m):
    fp, fu, y = _fleet_np(preset, m, 3)
    want = jfl.fleet_algebra(y, 0.2, fp, fu, np)
    got = fleet.fleet_algebra(torch.from_numpy(y.T.copy()), 0.2,
                              _torch(fp, DERParams), _torch(fu, Exog),
                              TorchXP())
    for name in ("p_pv", "p_inv", "p_pcc", "q_pcc", "v_q", "f_meas", "id_ref",
                 "iq_ref", "e_dc", "e_q", "aw"):
        _close(getattr(got, name).numpy(), getattr(want, name))
    for name in ("v_pos", "i_pos"):                 # the PCC's: [1] vs [M]
        for part in ("re", "im"):
            g = getattr(getattr(got, name), part).numpy()
            _close(np.broadcast_to(g, (m,)), getattr(getattr(want, name), part))
    for part in ("re", "im"):                       # [n_ph, M] vs [M, n_ph]
        _close(getattr(got.vt, part).numpy().T, getattr(want.vt, part))


@pytest.mark.parametrize("preset,m", CASES)
def test_torch_fleet_guess_matches_reference(preset, m):
    fp, fu, _ = _fleet_np(preset, m, 4)
    got = fleet.fleet_guess(_torch(fp, DERParams), _torch(fu, Exog))
    _close(got.numpy().T, jfl.fleet_guess(fp, fu, np))


@pytest.mark.parametrize("preset,m", [("10", 3), ("50", 3), ("10", 16)])
def test_torch_fleet_oracle_rhs_matches_reference(preset, m):
    fp, fu, y = _fleet_np(preset, m, 5)
    _close(oracle.fleet_rhs_np(y, 0.3, fp, fu),
           jfl.fleet_rhs(y, 0.3, fp, fu, np))


def test_torch_fleet_oracle_steady_state_and_gate_scenario():
    """The oracle's coupled steady state zeroes the reference's fleet RHS;
    the gate scenario is bench.py's (linspace shading, thirds of nominal,
    400 W/m², 0.6 pu)."""
    fp, fus = oracle.fleet_gate_scenario(make_params("10"), 4, 36)
    assert len(fus) == 36 and all(len(f.conn) == 4 for f in fus)
    np.testing.assert_allclose(fus[0].s_irr, 1000.0 * np.linspace(1, 0.75, 4))
    np.testing.assert_allclose(fus[12].s_irr, 400.0 * np.linspace(1, 0.75, 4))
    assert np.all(fus[24].v_g == 0.6) and np.all(fus[11].v_g == 1.0)
    y0 = oracle.fleet_steady_state(fp, fus[0])
    as_ref = lambda tree, cls: cls(**{f.name: getattr(tree, f.name)
                                      for f in dataclasses.fields(cls)})
    r = jfl.fleet_rhs(y0, 0.0, as_ref(fp, JaxDERParams), as_ref(fus[0], JaxExog),
                      np)
    assert np.abs(r).max() <= 1e-9
