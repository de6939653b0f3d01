"""SAC: `pvderx_torch.learn.sac` against `pvderx.learn.sac`.

- One `train_step` equals the reference's: from the same float32 actor and
  critic params and the same env state (carried over as in
  `test_torch_learn_ppo`), two train steps give the same actor, critic,
  target critic, ``log_alpha``, replay contents, obs and metrics. 8 envs,
  n_sub 40, rollout 4, 2 updates of batch 16, hidden (32, 32), float64 env
  and compute, the continuous env with the gate's high-authority deltas.
  Randomness out on both sides, in the test only: zero noise in the
  squashed Gaussian (`jax.random.normal` and the port's `_noise` give
  zeros, so every action is tanh(mu)), and a fixed index set in place of
  `pvderx.learn.sac.sample_rows` and the port's. Tolerances, each with what
  it reads: params <= 1e-6 of the leaf's largest magnitude (reads <= 6.5e-7,
  the critic: Adam's arithmetic rounds in another order, a few float32
  ulps); log_alpha <= 1e-9 (3.6e-13); the first step's replay rows <= 1e-12
  (2.2e-15); the second step's actions come from float32 params a few ulps
  apart (tanh(mu) moves by ~1e-8), so its rows and the obs after it
  <= 1e-7 (4.7e-9 and 2.1e-9); metrics <= 1e-6 relative (4.1e-7).
- `_squash` with noise: the port's log-prob equals the reference's formula
  on the same draws, far into softplus's tail (|pre| > 20, where
  `F.softplus` would cut off).
- Mechanics twins of tests/test_sac.py: the discrete and per-unit configs
  rejected, bitwise determinism under one generator seed with the buffer
  fill, the circular wrap of the replay through the runner; the actor's
  and the temperature's steps leave the critic's gradient as its own
  step set it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.learn import SACConfig as JSACConfig, make_sac as j_make_sac
from pvderx_torch.env import make_env_config, make_fleet_config
from pvderx_torch.learn import SACConfig, make_sac
from pvderx_torch.learn import sac as sac_mod
from test_torch_learn_dqn import fixed_rows
from test_torch_learn_ppo import (
    HIDDEN, N, assert_params_equal, carry_env, load, rel_err, single_cfgs)

HIGH_AUTHORITY = dict(continuous=True, dq_action=0.15, dv_action=0.06)


def test_torch_learn_sac_train_step_matches_reference(monkeypatch):
    import pvderx.learn.sac as j_sac_mod

    cfg_j, cfg_t = single_cfgs(**HIGH_AUTHORITY)
    kw = dict(lr=3e-3, init_alpha=0.05, rollout_len=4, n_updates=2,
              batch_size=16, capacity=64)
    init_j, ts_j, _ = j_make_sac(cfg_j, JSACConfig(**kw), hidden=HIDDEN,
                                 dtype=jnp.float64)
    init_t, ts_t, _ = make_sac(cfg_t, SACConfig(**kw), hidden=HIDDEN,
                               dtype=torch.float64)
    rj = jax.jit(init_j, static_argnums=1)(jax.random.PRNGKey(2), N)
    rt = init_t(N, torch.Generator().manual_seed(0))
    load(rt.actor, rj.actor)
    load(rt.critic, rj.critic)
    load(rt.critic_tgt, rj.critic_tgt)
    assert float(rt.log_alpha.detach()) == float(rj.log_alpha)
    rt = dataclasses.replace(rt, **carry_env(cfg_t, rj.env_state, rj.obs))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=float: jnp.zeros(shape,
                                                                     dtype))
    monkeypatch.setattr(sac_mod, "_noise",
                        lambda like, g: torch.zeros_like(like))
    fixed_rows(monkeypatch, j_sac_mod, sac_mod,
               np.random.default_rng(1).integers(0, 32, 16))

    ts_j = jax.jit(ts_j)
    for step in range(2):
        rj, mj = ts_j(rj)
        rt, mt = ts_t(rt)
        for k in ("critic_loss", "actor_loss", "entropy", "alpha",
                  "reward_mean"):
            assert rel_err(mt[k], mj[k]) <= 1e-6, (k, float(mt[k]), mj[k])
        assert mt["buffer_size"] == int(mj["buffer_size"]) == 32 * (step + 1)
    assert abs(float(rt.log_alpha.detach()) - float(rj.log_alpha)) <= 1e-9
    rows_t, rows_j = rt.replay.data.numpy(), np.asarray(rj.replay.data)
    np.testing.assert_allclose(rows_t[:32], rows_j[:32], rtol=0, atol=1e-12)
    np.testing.assert_allclose(rows_t[32:], rows_j[32:], rtol=0, atol=1e-7)
    np.testing.assert_allclose(rt.obs.numpy(), np.asarray(rj.obs), rtol=0,
                               atol=1e-7)
    assert_params_equal(rt.actor, rj.actor)
    assert_params_equal(rt.critic, rj.critic)
    assert_params_equal(rt.critic_tgt, rj.critic_tgt)


def test_torch_learn_sac_squash_matches_the_reference_formula(monkeypatch):
    from pvderx.learn.sac import _squash as j_squash

    rng = np.random.default_rng(3)
    mu = rng.normal(0.0, 12.0, (64, 2))           # pre reaches |x| > 20
    log_std = rng.uniform(-5.0, 2.0, (64, 2))
    eps = rng.standard_normal((64, 2))
    assert float(np.abs(mu + np.exp(log_std) * eps).max()) > 20
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(eps, dtype))
    monkeypatch.setattr(sac_mod, "_noise",
                        lambda like, g: torch.tensor(eps, dtype=like.dtype))
    act_j, logp_j = j_squash(jnp.asarray(mu), jnp.asarray(log_std),
                             jax.random.PRNGKey(0))
    act_t, logp_t = sac_mod._squash(torch.tensor(mu), torch.tensor(log_std),
                                    torch.Generator())
    np.testing.assert_allclose(act_t.numpy(), np.asarray(act_j), rtol=0,
                               atol=1e-15)
    np.testing.assert_allclose(logp_t.numpy(), np.asarray(logp_j), rtol=1e-13,
                               atol=1e-12)
    monkeypatch.undo()
    # the port's own draws: the generator's normals, shaped like mu
    a, lp = sac_mod._squash(torch.tensor(mu), torch.tensor(log_std),
                            torch.Generator().manual_seed(0))
    assert a.shape == (64, 2) and lp.shape == (64,)
    assert torch.isfinite(lp).all() and (a.abs() <= 1).all()


def test_torch_learn_sac_rejects_discrete_and_per_unit():
    with pytest.raises(ValueError, match="continuous"):
        make_sac(make_env_config("10", n_sub=40, device="cpu"), SACConfig())
    with pytest.raises(ValueError, match="PPO-only"):
        make_sac(make_fleet_config("10", m=4, per_unit=True, n_sub=40,
                                   device="cpu"), SACConfig())


def test_torch_learn_sac_deterministic_and_replay_wraps():
    cfg = make_env_config("10", horizon=20, n_sub=40, device="cpu",
                          continuous=True)
    sac = SACConfig(rollout_len=2, n_updates=1, batch_size=16, capacity=24)
    init, ts, _ = make_sac(cfg, sac, hidden=(16, 16))
    outs = []
    for _ in range(2):
        r = init(8, torch.Generator().manual_seed(1))
        for _ in range(2):                       # 2*2*8 = 32 rows > 24
            r, m = ts(r)
        outs.append((r.obs, m))
    (o1, m1), (o2, m2) = outs
    assert torch.equal(o1, o2)                   # bitwise reproducible
    assert torch.equal(m1["critic_loss"], m2["critic_loss"])
    assert m1["buffer_size"] == 24 and r.replay.ptr == 32 % 24
    assert torch.isfinite(m1["critic_loss"]) and torch.isfinite(m1["alpha"])


def test_torch_learn_sac_actor_step_leaves_the_critic_untouched():
    """The actor's loss runs through the critic; its step must move the
    actor alone (no gradient accumulates in the critic)."""
    cfg = make_env_config("10", horizon=20, n_sub=40, device="cpu",
                          continuous=True)
    init, ts, _ = make_sac(cfg, SACConfig(rollout_len=1, n_updates=1,
                                          batch_size=8, capacity=16),
                           hidden=(16, 16))
    r = init(8, torch.Generator().manual_seed(2))
    seen = []
    orig = r.opt_critic.step

    def step():
        seen.append([p.grad.clone() for p in r.critic.parameters()])
        return orig()
    r.opt_critic.step = step
    r, _ = ts(r)
    # the critic's grads when its optimizer stepped are those of its own
    # loss, and they stay the same after the actor's and alpha's steps
    assert len(seen) == 1
    assert all(torch.equal(g, p.grad)
               for g, p in zip(seen[0], r.critic.parameters()))
