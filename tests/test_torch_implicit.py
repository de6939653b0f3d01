"""The port's implicit integrators (pvderx_torch/ode/implicit.py) and the
implicit env and fleet steps, against the JAX package.

- One trapezoidal and one backward-Euler window, float64, per-env jittered
  inputs made from a seed, against `pvderx.ode.implicit` at presets 10 and
  50: <= 1e-12.
- The complex-step Jacobian against `torch.func.jacfwd`: <= 1e-12 relative.
- A-stability at n_sub = 5 (twin of tests/test_variants.py:110-120): RK4
  blows up, the trapezoidal rule holds.
- `core.step` with each implicit scheme from a JAX state carried over, on
  the scripted schedules of tests/test_torch_env.py, against
  `jax.vmap(core.step)`: <= 1e-9; the fleet step at M = 4 against
  `jax.vmap(pvderx.env.fleet.step)`: <= 1e-9.
- The episode twin of tests/test_variants.py:154-183 (the env at n_sub 16
  against the LSODA episode oracle `pvderx.oracle.scipy_ref.run_episode`)
  at the reference's tolerances.
- float32 stays float32 through the implicit step.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx import make_params as jax_make_params
from pvderx import nominal_exog as jax_nominal_exog
from pvderx import physics
from pvderx.env import core as jcore
from pvderx.env import fleet as jfleet
from pvderx.ode import implicit as jimplicit
from pvderx.oracle import scipy_ref
from pvderx_torch._struct import replace
from pvderx_torch.convert import fleet_state_from_numpy, state_from_numpy
from pvderx_torch.env import core, fleet, make_env_config, make_fleet_config
from pvderx_torch.ode import (
    backward_euler_window, rhs_and_jacobian, rk4_window, trapezoid_window)
from pvderx_torch.ops.window import P_FIELDS, U_FIELDS
from pvderx_torch.params import DERParams, Exog, make_params, nominal_exog
from test_torch_env import N_ENVS, _pair, _schedules, _step_both

DT = 1.0 / 60.0
WINDOWS = {"trapezoid": (trapezoid_window, jimplicit.trapezoid_window),
           "backward_euler": (backward_euler_window,
                              jimplicit.backward_euler_window)}


def _inputs(preset, n, seed):
    """Seeded per-env inputs of one window under a 0.7 pu sag: states near
    the steady-state guess, jittered grid resistance and insolation, random
    t0. Returns the port's (y, t0, der, exog) and per-env numpy dicts."""
    rng = np.random.default_rng(seed)
    p, u = make_params(preset), dataclasses.replace(nominal_exog(), v_g=0.7)
    pp = {f: np.full(n, float(getattr(p, f))) for f in P_FIELDS}
    uu = {f: np.full(n, float(getattr(u, f))) for f in U_FIELDS}
    pp["rg"] *= 1.0 + 0.2 * rng.uniform(-1.0, 1.0, n)
    uu["s_irr"] *= 1.0 + 0.2 * rng.uniform(-1.0, 1.0, n)
    pj = jax_make_params(preset).astype(jnp.float64)
    uj = dataclasses.replace(jax_nominal_exog(), v_g=0.7).astype(jnp.float64)
    y0 = np.asarray(physics.steady_state_guess(pj, uj))
    y = y0 + 1e-3 * rng.standard_normal((n, p.n_states))
    t0 = rng.uniform(0.0, 1.0, n)
    f = lambda a: torch.tensor(a, dtype=torch.float64)
    der = DERParams(n_ph=p.n_ph, **{k: f(v) for k, v in pp.items()})
    exog = Exog(**{k: f(v) for k, v in uu.items()})
    return (f(y), f(t0), der, exog), (y, t0, pp, uu, pj, uj)


@pytest.mark.parametrize("scheme", list(WINDOWS))
@pytest.mark.parametrize("preset", ["10", "50"])
def test_torch_implicit_window_matches_jax(preset, scheme):
    n, n_sub = 3, 6
    (y, t0, der, exog), (y_np, t_np, pp, uu, pj, uj) = _inputs(preset, n, 7)
    win, jwin = WINDOWS[scheme]
    got = win(functools.partial(core._rhs, der=der, exog=exog), y, t0, DT,
              n_sub)
    # the reference, one env per vmap lane
    pb = dataclasses.replace(pj, **{k: jnp.asarray(v) for k, v in pp.items()})
    ub = dataclasses.replace(uj, **{k: jnp.asarray(v) for k, v in uu.items()})
    want = jax.jit(jax.vmap(lambda yy, tt, pe, ue: jwin(
        lambda y1, t1: physics.rhs(y1, t1, pe, ue), yy, tt, jnp.float64(DT),
        n_sub)))(jnp.asarray(y_np), jnp.asarray(t_np), pb, ub)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("preset", ["10", "50"])
def test_torch_complex_step_jacobian_matches_jacfwd(preset):
    """The complex-step Jacobian of the batched RHS equals torch's
    forward-mode `vmap(jacfwd)` of the one-env RHS to float64 roundoff."""
    from pvderx_torch.ops.window import pack_struct
    from pvderx_torch.physics.xp import TorchXP

    (y, _, der, exog), _ = _inputs(preset, 3, 11)
    t0 = torch.zeros(3, dtype=torch.float64)      # _rhs_one's time
    f, jac = rhs_and_jacobian(lambda yy: core._rhs(yy, t0, der, exog), y)
    one = functools.partial(core._rhs_one, n_ph=der.n_ph,
                            xp=TorchXP(torch.float64))
    want = torch.func.vmap(torch.func.jacfwd(one))(
        y, pack_struct(der, P_FIELDS).T, pack_struct(exog, U_FIELDS).T)
    assert jac.shape == want.shape == (3, y.shape[1], y.shape[1])
    scale = float(want.abs().max())
    assert float((jac - want).abs().max()) <= 1e-12 * scale
    np.testing.assert_allclose(f.numpy(), core._rhs(y, t0, der, exog).numpy(),
                               rtol=0, atol=1e-12)


def test_torch_trapezoid_stable_where_rk4_explodes():
    """A-stability: at n_sub=5 (h·|λ|max ≈ 21) RK4 diverges, the
    trapezoidal rule stays at the steady state it started near."""
    from pvderx_torch import oracle

    p, u = make_params("10"), nominal_exog()
    y0 = torch.tensor(oracle.steady_state(p, u))[None]
    f = lambda a: torch.tensor([float(a)], dtype=torch.float64)
    der = DERParams(n_ph=1, **{k: f(getattr(p, k)) for k in P_FIELDS})
    exog = Exog(**{k: f(getattr(u, k)) for k in U_FIELDS})
    rhs = functools.partial(core._rhs, der=der, exog=exog)
    t0 = torch.zeros(1, dtype=torch.float64)
    y_rk = rk4_window(rhs, y0 * 1.001, t0, DT, 5)
    y_tr = trapezoid_window(rhs, y0 * 1.001, t0, DT, 5)
    assert not bool(torch.all(torch.abs(y_rk) < 1e3))     # RK4 blew up
    assert bool(torch.all(torch.abs(y_tr - y0) < 1.0))    # trapezoid held


@functools.cache
def _env_pair():
    """A JAX float64 reset state on the scripted schedules, carried over."""
    return _pair(n_sub=8, integrator="trapezoid")


@pytest.mark.parametrize("scheme", list(WINDOWS))
def test_torch_implicit_env_step_matches_jax(scheme):
    """10 steps at n_sub=8 (below RK4's bound) from step 14, through the
    scripted sag, cessation, cloud, load and frequency events."""
    cfg_j, st_j, cfg, st = _env_pair()
    cfg_j = dataclasses.replace(cfg_j, integrator=scheme)
    cfg = replace(cfg, integrator=scheme)
    st_j = dataclasses.replace(st_j, t_step=jnp.full((N_ENVS,), 14,
                                                     jnp.int32))
    st = replace(st, t_step=torch.full((N_ENVS,), 14, dtype=torch.int32))
    acts = [((k + np.arange(N_ENVS)) % 5).astype(np.int32) for k in range(10)]
    seen = _step_both(cfg_j, st_j, cfg, st, acts)
    assert seen["ces"]


def _fleet_pair(m, per_unit, **cfg_kw):
    """A JAX float64 fleet reset state on the scripted schedules, carried
    into the port (as tests/test_torch_fleet_env.py does at M = 3)."""
    fcj = jfleet.make_fleet_config("10", m=m, per_unit=per_unit,
                                   dtype=jnp.float64, **cfg_kw)
    keys = jax.random.split(jax.random.PRNGKey(3), N_ENVS)
    st_j, _ = jax.jit(jax.vmap(lambda k: jfleet.reset(fcj, k)))(keys)
    st_j = dataclasses.replace(st_j, sched=jcore.EventSchedule(
        **{k: jnp.asarray(v) for k, v in _schedules().items()}))
    fc = make_fleet_config("10", m=m, per_unit=per_unit, dtype=torch.float64,
                           device="cpu", **cfg_kw)
    st = fleet_state_from_numpy(
        dataclasses.asdict(jax.tree.map(np.asarray, st_j)), fc)
    return fcj, st_j, fc, st


def test_torch_implicit_fleet_step_matches_jax():
    """The fleet's stacked [M·n_s] trapezoidal step (M = 4, n_sub = 4,
    per-unit actions), 3 steps from step 15 (the sag), against
    `jax.vmap(fleet.step)`."""
    m, per_unit = 4, True
    fcj, st_j, fc, st = _fleet_pair(m, per_unit, n_sub=4,
                                    integrator="trapezoid")
    st_j = dataclasses.replace(st_j, t_step=jnp.full((N_ENVS,), 15,
                                                     jnp.int32))
    st = replace(st, t_step=torch.full((N_ENVS,), 15, dtype=torch.int32))
    step_j = jax.jit(jax.vmap(lambda s, a: jfleet.step(fcj, s, a)))
    rng = np.random.default_rng(1)
    for k in range(3):
        a = rng.integers(0, 5, (N_ENVS, m) if per_unit else (N_ENVS,))
        a = a.astype(np.int32)
        st_j, obs_j, rew_j, done_j, _ = step_j(st_j, jnp.asarray(a))
        st, obs, rew, done, _ = fleet.step(fc, st, torch.from_numpy(a))
        np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), rtol=0,
                                   atol=1e-9, err_msg=f"obs at step {k}")
        np.testing.assert_allclose(rew.numpy(), np.asarray(rew_j), rtol=0,
                                   atol=1e-9)
        np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))
    np.testing.assert_allclose(st.y.numpy(), np.asarray(st_j.y), rtol=0,
                               atol=1e-9)


def _sag_cfgs(integ, n_sub, horizon=60):
    """The sag scenario of tests/test_variants.py:128-137, both packages."""
    kw = dict(p_sag=1.0, p_freq=0.0, sag_depth_lo=0.5, sag_depth_hi=0.5,
              sag_t_lo=0.3, sag_t_hi=0.3, sag_dur_lo=0.3, sag_dur_hi=0.3)
    cfg_j = jcore.make_env_config(
        "10", dtype=jnp.float64, n_sub=n_sub, horizon=horizon,
        integrator=integ, scen=jcore.ScenarioConfig(**kw))
    cfg = make_env_config(
        "10", dtype=torch.float64, n_sub=n_sub, horizon=horizon,
        integrator=integ, scen=core.ScenarioConfig(**kw), device="cpu")
    return cfg_j, cfg


@functools.cache
def _episode_oracle():
    """The JAX reset state of the reference test and its LSODA episode
    (`run_episode` replaces only the integrator, so one serves both
    schemes)."""
    cfg_j, _ = _sag_cfgs("trapezoid", 16)
    st_j, _ = jax.jit(lambda k: jcore.reset(cfg_j, k))(jax.random.PRNGKey(3))
    actions = np.asarray(jax.random.randint(jax.random.PRNGKey(4),
                                            (cfg_j.horizon,), 0, 5))
    return st_j, actions, scipy_ref.run_episode(cfg_j, st_j, actions)


@pytest.mark.parametrize("integ,n_sub,tol_obs,tol_rew", [
    ("trapezoid", 16, 2e-2, 5e-3),
    ("backward_euler", 16, 5e-2, 2e-2),
])
def test_torch_env_integrator_vs_oracle(integ, n_sub, tol_obs, tol_rew):
    """A whole episode of the port's env with an implicit scheme at n_sub
    well below RK4's bound, from the reference test's reset state, against
    the LSODA episode oracle at the reference's tolerances."""
    st_j, actions, (obs_o, rew_o, _) = _episode_oracle()
    _, cfg = _sag_cfgs(integ, n_sub)
    st = state_from_numpy(dataclasses.asdict(jax.tree.map(
        lambda x: np.asarray(x)[None], st_j)), cfg)
    obs_l, rew_l = [], []
    for a in actions[:len(rew_o)]:
        st, ob, r, d, _ = core.step(cfg, st, torch.tensor([int(a)]))
        obs_l.append(ob[0].numpy())
        rew_l.append(float(r[0]))
        if bool(d[0]):
            break
    assert len(obs_l) == len(obs_o)    # the oracle's episode length
    assert np.abs(np.stack(obs_l) - obs_o).max() < tol_obs
    assert np.abs(np.asarray(rew_l) - rew_o).max() < tol_rew


@pytest.mark.parametrize("scheme", list(WINDOWS))
def test_torch_implicit_float32_stays_float32(scheme):
    """The complex step of a float32 state is complex64, its Jacobian and
    the Newton solve float32: the step's outputs stay float32 and finite."""
    cfg = make_env_config("10", dtype=torch.float32, n_sub=4,
                          integrator=scheme, device="cpu")
    st, _ = core.reset(cfg, 3, torch.Generator().manual_seed(0))
    st1, obs, rew, _, _ = core.step(cfg, st, torch.zeros(3, dtype=torch.int64))
    for x in (st1.y, obs, rew):
        assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
    fc = make_fleet_config("10", m=2, dtype=torch.float32, n_sub=2,
                           integrator=scheme, device="cpu")
    fst, _ = fleet.reset(fc, 2, torch.Generator().manual_seed(0))
    fst1, fobs, _, _, _ = fleet.step(fc, fst, torch.zeros(2, dtype=torch.int64))
    assert fst1.y.dtype == fobs.dtype == torch.float32
    assert bool(torch.isfinite(fst1.y).all())
