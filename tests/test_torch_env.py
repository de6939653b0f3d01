"""The port's batched env (pvderx_torch/env) against the JAX env.

A JAX float64 reset state is carried into the port with
`pvderx_torch.convert.state_from_numpy`; both packages then step the same
fixed actions and must give the same obs, reward and done (<= 1e-9) as
`jax.vmap(core.step)`. Scripted schedules put a sag, a cessation, a trip, a
cloud step and a frequency excursion inside the steps run. Episode
randomization cannot match by seed (threefry vs torch Philox), so reset
draws are checked against the `ScenarioConfig` ranges.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.env import core as jcore
from pvderx.scenario import EventBuilder
from pvderx_torch.convert import state_from_numpy
from pvderx_torch.env import core, make_batch_fns, make_env_config, rollout

TOL = 1e-9
N_ENVS = 4


def _schedules():
    """One scripted schedule per env, all inside the first 0.7 s."""
    scripts = []
    b = EventBuilder()                     # sag to LV2: cessation, recovery
    b.add_grid_event(0.25, v=0.45)
    b.add_grid_event(0.6, v=1.0)
    scripts.append(b)
    b = EventBuilder()                     # cloud step and a load step
    b.add_solar_event(0.3, 400.0)
    b.add_load_event(0.5, g_load=0.2, b_load=0.05)
    scripts.append(b)
    b = EventBuilder()                     # frequency excursion, recovery
    b.add_grid_event(0.2, dw=0.01)
    b.add_grid_event(0.55, phi=0.4)
    scripts.append(b)
    b = EventBuilder()                     # HV2 swell: latched trip
    b.add_grid_event(0.3, v=1.25)
    scripts.append(b)
    tabs = [s.build(4, 4, 2, dtype=np.float64) for s in scripts]
    return {k: np.stack([getattr(t, k) for t in tabs])
            for k in ("solar", "grid", "load")}


def _pair(**cfg_kw):
    cfg_j = jcore.make_env_config("10", dtype=jnp.float64, **cfg_kw)
    keys = jax.random.split(jax.random.PRNGKey(3), N_ENVS)
    st_j, _ = jax.vmap(lambda k: jcore.reset(cfg_j, k))(keys)
    st_j = dataclasses.replace(st_j, sched=jcore.EventSchedule(
        **{k: jnp.asarray(v) for k, v in _schedules().items()}))
    cfg = make_env_config("10", dtype=torch.float64, device="cpu", **cfg_kw)
    st = state_from_numpy(dataclasses.asdict(jax.tree.map(np.asarray, st_j)),
                          cfg)
    return cfg_j, st_j, cfg, st


def _step_both(cfg_j, st_j, cfg, st, actions):
    step_j = jax.jit(jax.vmap(lambda s, a: jcore.step(cfg_j, s, a)))
    seen = {"trip": False, "ces": False}
    for k, a in enumerate(actions):
        st_j, obs_j, rew_j, done_j, _ = step_j(st_j, jnp.asarray(a))
        st, obs, rew, done, _ = core.step(cfg, st, torch.from_numpy(a))
        np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), rtol=0,
                                   atol=TOL, err_msg=f"obs at step {k}")
        np.testing.assert_allclose(rew.numpy(), np.asarray(rew_j), rtol=0,
                                   atol=TOL, err_msg=f"reward at step {k}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))
        np.testing.assert_array_equal(st.rt.tripped.numpy(),
                                      np.asarray(st_j.rt.tripped))
        seen["trip"] |= bool(done.any())
        seen["ces"] |= bool(st.rt.ces.any())
    np.testing.assert_allclose(st.y.numpy(), np.asarray(st_j.y), rtol=0,
                               atol=TOL)
    return seen


def test_torch_env_step_matches_jax():
    """45 discrete steps at n_sub=40 through sag, cessation, trip, cloud,
    load and frequency events."""
    cfg_j, st_j, cfg, st = _pair(n_sub=40)
    acts = [((k + np.arange(N_ENVS)) % 5).astype(np.int32) for k in range(45)]
    seen = _step_both(cfg_j, st_j, cfg, st, acts)
    assert seen["trip"] and seen["ces"]


def test_torch_reset_draws_within_scenario_ranges():
    scen = core.ScenarioConfig(zg_jitter=0.3, p_sag=0.6, p_freq=0.3,
                               p_cloud=0.7, p_load=0.5, p_unb=0.5)
    cfg = make_env_config("10", dtype=torch.float64, n_sub=40, device="cpu",
                          scen=scen)
    st, obs = core.reset(cfg, 32, torch.Generator().manual_seed(0))
    s = scen
    assert torch.all((st.s0 >= s.s0_lo) & (st.s0 <= s.s0_hi))
    assert torch.all((st.tc0 >= s.tc_lo) & (st.tc0 <= s.tc_hi))
    rel_rg = st.der.rg / cfg.der.rg - 1.0
    assert torch.all(rel_rg.abs() <= s.zg_jitter) and rel_rg.std() > 0
    assert float(st.init_res.max()) <= 1e-9
    assert torch.isfinite(obs).all() and torch.equal(obs, st.obs0)
    assert torch.all(st.t_step == 0) and torch.all(obs[:, 12] == 1.0)
    solar, grid, load = st.sched.solar, st.sched.grid, st.sched.load
    assert torch.all(solar[:, 0, 0] == 0) and torch.all(grid[:, 0, 0] == 0)
    t_evt = grid[:, 1, 0]
    fin = torch.isfinite(t_evt)
    assert fin.any() and (~fin).any()
    assert torch.all((t_evt[fin] >= s.sag_t_lo) & (t_evt[fin] <= s.sag_t_hi))
    dur = grid[fin, 2, 0] - t_evt[fin]
    assert torch.all((dur >= s.sag_dur_lo - 1e-12) & (dur <= s.sag_dur_hi + 1e-12))
    depth = grid[:, 1, 1]
    sag = depth < 1.0
    assert torch.all((depth[sag] >= s.sag_depth_lo) & (depth[sag] <= s.sag_depth_hi))
    assert torch.all(grid[:, 1, 3].abs() <= s.df_max)
    assert torch.all(grid[:, :, 4] == 0)          # 1-phase: no unbalance
    frac = solar[:, 1, 1] / st.s0
    cloud = torch.isfinite(solar[:, 1, 0])
    assert torch.all((frac[cloud] >= s.cloud_frac_lo) & (frac[cloud] <= s.cloud_frac_hi))
    g_l = load[:, 1, 1]
    assert torch.all((g_l >= 0.05) & (g_l <= s.load_g_hi))


@pytest.mark.parametrize("kw,exc", [
    (dict(n_sub=20), ValueError),
    (dict(integrator="euler"), ValueError),
    (dict(continuous=True, anomaly_detect=True), ValueError),
    (dict(scen="bad_prob"), ValueError),
    (dict(der="bad_rf"), ValueError),
    (dict(integrator="trapezoid", n_sub=10), NotImplementedError),
    (dict(integrator="backward_euler", n_sub=60), NotImplementedError),
])
def test_torch_make_env_config_rejections(kw, exc):
    """The port rejects what the JAX `make_env_config` rejects (ValueError);
    the implicit integrators, which the JAX one accepts, are not ported."""
    from pvderx.params import make_params as jax_make_params
    from pvderx_torch.params import make_params

    def build(mod, scen_cls, mp, dtype, **extra):
        k = dict(kw)
        if k.get("scen") == "bad_prob":
            k["scen"] = scen_cls(p_sag=1.5)
        if k.get("der") == "bad_rf":
            k["der"] = mp("10", validate=False, rf=-1.0)
        return mod.make_env_config("10", dtype=dtype, **k, **extra)

    if exc is ValueError:
        with pytest.raises(ValueError):
            build(jcore, jcore.ScenarioConfig, jax_make_params, jnp.float64)
    else:
        build(jcore, jcore.ScenarioConfig, jax_make_params, jnp.float64)
    with pytest.raises(exc):
        build(core, core.ScenarioConfig, make_params, torch.float64,
              device="cpu")


def test_torch_rollout_autoreset_restores_episode_start():
    """With a 5-step horizon every env is done at step 5 and restarts from
    its cached steady state and initial observation, with fresh events."""
    cfg = make_env_config("10", dtype=torch.float64, n_sub=40, device="cpu",
                          horizon=5)
    gen = torch.Generator().manual_seed(2)
    reset_batch, step_batch = make_batch_fns(cfg)
    st0, obs0 = reset_batch(3, gen)
    zero = lambda o, g: torch.zeros(o.shape[0], dtype=torch.int64)
    st, obs, rews, dones = rollout(cfg, st0, obs0, zero, 5, gen)
    assert rews.shape == (5, 3) and dones.shape == (5, 3)
    assert not dones[:4].any() and dones[4].all()
    assert torch.equal(obs, obs0) and torch.equal(st.y, st0.y0)
    assert torch.all(st.t_step == 0) and torch.equal(st.rt.tripped,
                                                     torch.zeros(3,
                                                                 dtype=torch.float64))
    assert torch.isfinite(rews).all()
    st1, obs1, _, done1, _ = step_batch(st, torch.zeros(3, dtype=torch.int64),
                                        gen)
    assert not done1.any() and torch.all(st1.t_step == 1)


@pytest.mark.parametrize("preset", ["10", "50"])
def test_torch_reset_float32_stays_float32(preset):
    """The f32 reset keeps every float leaf in float32 (the vmapped forward-
    mode Jacobian comes out in float64 and is cast back) and reports a
    finite residual inside the reference's f32 band (< 1e-3)."""
    cfg = make_env_config(preset, dtype=torch.float32, n_sub=40, device="cpu")
    st, obs = core.reset(cfg, 4, torch.Generator().manual_seed(1))
    assert st.y.dtype == torch.float32 and obs.dtype == torch.float32
    assert st.init_res.dtype == torch.float32
    assert torch.isfinite(st.init_res).all() and float(st.init_res.max()) < 1e-3
