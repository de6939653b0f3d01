"""The port's fleet env (pvderx_torch/env/fleet.py) against the JAX fleet env.

A JAX float64 fleet reset state is carried into the port with
`pvderx_torch.convert.fleet_state_from_numpy`; both packages then step the
same seeded actions for 60 steps and must give the same obs, reward and
done (<= 1e-9) as `jax.vmap(pvderx.env.fleet.step)`. The scripted schedules
of tests/test_torch_env.py put a sag with cessation, a cloud and load step,
a frequency excursion and a swell that trips a whole fleet inside the
steps run; one unit of env 0 starts tripped, so that fleet runs on a
partial trip. Reset draws of the port's own reset are checked against the
`ScenarioConfig` ranges (seeds cannot match across JAX and torch).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.env import core as jcore
from pvderx.env import fleet as jfleet
from pvderx_torch.convert import fleet_state_from_numpy
from pvderx_torch.env import (
    ScenarioConfig, fleet, fleet_obs_dim, fleet_rollout, make_fleet_batch_fns,
    make_fleet_config)
from test_torch_env import N_ENVS, _schedules

TOL = 1e-9
M = 3
N_STEPS = 60


def _pair(per_unit=False, **cfg_kw):
    scen = dict(fleet_s_jitter=0.2)
    fcj = jfleet.make_fleet_config("10", m=M, per_unit=per_unit,
                                   dtype=jnp.float64, n_sub=40,
                                   scen=jcore.ScenarioConfig(**scen), **cfg_kw)
    keys = jax.random.split(jax.random.PRNGKey(3), N_ENVS)
    st_j, _ = jax.vmap(lambda k: jfleet.reset(fcj, k))(keys)
    tripped = np.asarray(st_j.rt.tripped).copy()
    tripped[0, 0] = 1.0                      # a partial trip from the start
    st_j = dataclasses.replace(
        st_j, sched=jcore.EventSchedule(
            **{k: jnp.asarray(v) for k, v in _schedules().items()}),
        rt=dataclasses.replace(st_j.rt, tripped=jnp.asarray(tripped)))
    fc = make_fleet_config("10", m=M, per_unit=per_unit, dtype=torch.float64,
                           n_sub=40, device="cpu", scen=ScenarioConfig(**scen),
                           **cfg_kw)
    st = fleet_state_from_numpy(
        dataclasses.asdict(jax.tree.map(np.asarray, st_j)), fc)
    return fcj, st_j, fc, st


def step_both(per_unit=False, seed=0, **cfg_kw):
    """Step both packages N_STEPS times on the same actions; returns what
    was seen (trips, cessation) for the caller's coverage checks."""
    fcj, st_j, fc, st = _pair(per_unit, **cfg_kw)
    step_j = jax.jit(jax.vmap(lambda s, a: jfleet.step(fcj, s, a)))
    rng = np.random.default_rng(seed)
    shape = (N_ENVS, M) if per_unit else (N_ENVS,)
    seen = {"done": False, "ces": False, "partial": False}
    for k in range(N_STEPS):
        a = rng.integers(0, 5, shape).astype(np.int32)
        st_j, obs_j, rew_j, done_j, _ = step_j(st_j, jnp.asarray(a))
        st, obs, rew, done, info = fleet.step(fc, st, torch.from_numpy(a))
        np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), rtol=0,
                                   atol=TOL, err_msg=f"obs at step {k}")
        np.testing.assert_allclose(rew.numpy(), np.asarray(rew_j), rtol=0,
                                   atol=TOL, err_msg=f"reward at step {k}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))
        np.testing.assert_array_equal(st.rt.tripped.numpy(),
                                      np.asarray(st_j.rt.tripped))
        frac = info["tripped_frac"]
        seen["done"] |= bool(done.any())
        seen["ces"] |= bool(st.rt.ces.any())
        seen["partial"] |= bool(((frac > 0) & (frac < 1)).any())
    np.testing.assert_allclose(st.y.numpy(), np.asarray(st_j.y), rtol=0,
                               atol=TOL)
    assert obs.shape == (N_ENVS, fleet_obs_dim(fc))
    return seen


@pytest.mark.parametrize("per_unit", [False, True], ids=["aggregate", "per_unit"])
def test_torch_fleet_step_matches_jax(per_unit):
    """Aggregate ([N] actions, Box(13)) and per-unit ([N, M] actions,
    13 + 4M obs) through sag, cessation, swell trip and a partial trip."""
    seen = step_both(per_unit)
    assert seen["done"] and seen["ces"] and seen["partial"]


def test_torch_fleet_reset_draws_and_residual():
    scen = ScenarioConfig(zg_jitter=0.3, p_sag=0.6, p_freq=0.3, p_cloud=0.7,
                          p_load=0.5, fleet_s_jitter=0.3)
    m, n = 3, 6
    for preset in ("10", "50"):
        fc = make_fleet_config(preset, m=m, dtype=torch.float64, n_sub=40,
                               device="cpu", scen=scen)
        st, obs = fleet.reset(fc, n, torch.Generator().manual_seed(0))
        n_s = fc.base.der.n_states
        assert st.y.shape == (n, m, n_s) and obs.shape == (n, 13)
        assert float(st.init_res.max()) <= 1e-9
        assert torch.all((st.s_scale > 1.0 - scen.fleet_s_jitter)
                         & (st.s_scale <= 1.0)) and st.s_scale.std() > 0
        assert torch.all((st.s0 >= scen.s0_lo) & (st.s0 <= scen.s0_hi))
        assert torch.all((st.tc0 >= scen.tc_lo) & (st.tc0 <= scen.tc_hi))
        rel_rg = st.der.rg / fc.base.der.rg - 1.0
        assert torch.all(rel_rg.abs() <= scen.zg_jitter) and rel_rg.std() > 0
        assert torch.all(st.der.rg == st.der.rg[:, :1])      # one feeder
        assert torch.equal(obs, st.obs0) and torch.isfinite(obs).all()
        assert torch.all(obs[:, 12] == 1.0) and torch.all(st.t_step == 0)
        # the coupled steady state, checked by the port's numpy oracle
        from pvderx_torch import oracle
        from pvderx_torch.env.fleet import _fleet_exog
        t0 = torch.zeros(n, dtype=torch.float64)
        fu = _fleet_exog(st.sched, t0, m, st.vdc_ref, st.q_ref,
                         1.0 - st.rt.tripped, st.rt.ces, st.s_scale)
        to_np = lambda tree, k: dataclasses.replace(tree, **{
            f.name: getattr(tree, f.name)[k].numpy()
            for f in dataclasses.fields(tree) if f.name != "n_ph"})
        for k in range(n):
            r = oracle.fleet_rhs_np(st.y[k].numpy(), 0.0, to_np(st.der, k),
                                    to_np(fu, k))
            assert np.abs(r).max() <= 1e-9


def test_torch_fleet_rollout_autoreset_and_per_unit_obs():
    """With a 4-step horizon every fleet is done at step 4 and restarts from
    its cached steady state and initial observation; per-unit obs carry
    [M× Vdc | M× P | M× Q | M× conn]."""
    fc = make_fleet_config("10", m=2, per_unit=True, dtype=torch.float64,
                           n_sub=40, device="cpu", horizon=4)
    gen = torch.Generator().manual_seed(2)
    reset_batch, step_batch = make_fleet_batch_fns(fc)
    st0, obs0 = reset_batch(3, gen)
    assert obs0.shape == (3, 13 + 4 * 2)
    torch.testing.assert_close(obs0[:, 13:15], st0.y0[:, :, 6], rtol=0, atol=0)
    assert torch.all(obs0[:, 19:] == 1.0)
    acts = lambda o, g: torch.randint(0, 5, (o.shape[0], 2), generator=g)
    st, obs, rews, dones = fleet_rollout(fc, st0, obs0, acts, 4, gen)
    assert rews.shape == (4, 3) and not dones[:3].any() and dones[3].all()
    assert torch.equal(obs, obs0) and torch.equal(st.y, st0.y0)
    assert torch.all(st.t_step == 0) and torch.all(st.vdc_ref == 1.0)
    st1, _, _, done1, _ = step_batch(st, torch.zeros(3, 2, dtype=torch.int64),
                                     gen)
    assert not done1.any() and torch.all(st1.t_step == 1)


def test_torch_fleet_config_rejections():
    with pytest.raises(ValueError):
        make_fleet_config("10", m=0, device="cpu")
    with pytest.raises(NotImplementedError):
        make_fleet_config("10", m=2, integrator="trapezoid", n_sub=10,
                          device="cpu")
