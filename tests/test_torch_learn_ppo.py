"""PPO: `pvderx_torch.learn.ppo` against `pvderx.learn.ppo`.

- One `train_step` equals the reference's: from the same float32 params
  (Flax's init, carried over by `pvderx_torch.convert`) and the same env
  state (the JAX reset, carried over leaf by leaf), two train steps of each
  package give the same params, obs and metrics. 8 envs, n_sub 40, rollout
  4, hidden (32, 32), float64 env and compute. The single-DER anomaly task
  (6 actions, M = 1) and the per-unit fleet at M = 4 (the factored head).
  The randomness is taken out on both sides, in the test only: greedy
  actions (`jax.random.categorical` and the port's `_categorical` replaced
  by argmax), one minibatch per epoch (the shuffle then only reorders the
  terms of one mean), and a horizon no env reaches (no autoreset draw is
  used). Tolerances, each with what it reads: float32 params <= 1e-6 of
  the leaf's largest magnitude (reads 3.3e-7 single-DER, 2.9e-7 fleet: the
  global-norm sum and Adam's arithmetic round in another order); obs
  <= 1e-9 (the env step's contract; reads 2.2e-15); metrics <= 1e-6
  relative (reads 1.1e-7: each is a mean over both epochs, and the second
  runs on params a float32 ulp apart).
- GAE on a hand-made trajectory with dones, against a numpy loop.
- Mechanics: the optax clip rule, the continuous config rejected, head
  widths, and bitwise determinism under one generator seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.env import make_env_config as j_make_env_config
from pvderx.env.fleet import make_fleet_config as j_make_fleet_config
from pvderx.learn import PPOConfig as JPPOConfig, make_ppo as j_make_ppo
from pvderx_torch import convert
from pvderx_torch.env import ScenarioConfig, make_env_config, make_fleet_config
from pvderx_torch.env.fleet import FleetConfig
from pvderx_torch.learn import PPOConfig, make_ppo
from pvderx_torch.learn import ppo as ppo_mod
from pvderx_torch.learn.env_api import pack_params

N, N_SUB, HORIZON, HIDDEN = 8, 40, 50, (32, 32)
SCEN3 = dict(p_sag=0.9, p_freq=0.1, sag_depth_lo=0.2, sag_depth_hi=0.85)


def single_cfgs(**kw):
    """The same single-DER config in both packages (float64)."""
    return (j_make_env_config("10", dtype=jnp.float64, n_sub=N_SUB,
                              horizon=HORIZON, **kw),
            make_env_config("10", dtype=torch.float64, n_sub=N_SUB,
                            horizon=HORIZON, device="cpu", **kw))


def fleet_cfgs(m=4, **kw):
    return (j_make_fleet_config("10", m=m, dtype=jnp.float64, n_sub=N_SUB,
                                horizon=HORIZON, **kw),
            make_fleet_config("10", m=m, dtype=torch.float64, n_sub=N_SUB,
                              horizon=HORIZON, device="cpu", **kw))


def carry_env(cfg, j_state, j_obs):
    """The JAX runner's env state and obs as the port's (state, obs,
    p_pack)."""
    d = dataclasses.asdict(jax.tree.map(np.asarray, j_state))
    st = (convert.fleet_state_from_numpy(d, cfg) if isinstance(
        cfg, FleetConfig) else convert.state_from_numpy(d, cfg))
    return dict(env_state=st, obs=torch.tensor(np.asarray(j_obs)),
                p_pack=pack_params(st))


def load(net, params):
    """Flax params into a port net, in place (an optimizer built on the
    net's parameters keeps them)."""
    net.load_state_dict(
        convert.flax_state_dict(net, jax.tree.map(np.asarray, params)))


def rel_err(t: torch.Tensor, j) -> float:
    j = np.asarray(j, np.float64)
    return float(np.abs(t.detach().double().numpy() - j).max()
                 / max(np.abs(j).max(), 1e-30))


def assert_params_equal(net, params, tol=1e-6):
    """Every float32 leaf within ``tol`` of its largest magnitude."""
    want = convert.flax_state_dict(net, jax.tree.map(np.asarray, params))
    got = net.state_dict()
    assert set(got) == set(want)
    errs = {k: rel_err(got[k], want[k].numpy()) for k in want}
    assert max(errs.values()) <= tol, errs
    return errs


def greedy(monkeypatch):
    """PPO's action sampling replaced by argmax on both sides."""
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1: jnp.argmax(logits, axis))
    monkeypatch.setattr(ppo_mod, "_categorical",
                        lambda logits, g: torch.argmax(logits, dim=-1))


@pytest.mark.parametrize("kind", ["single_anomaly", "fleet_per_unit_m4"])
def test_torch_learn_ppo_train_step_matches_reference(kind, monkeypatch):
    if kind == "single_anomaly":
        cfg_j, cfg_t = single_cfgs(anomaly_detect=True)
    else:
        cfg_j, cfg_t = fleet_cfgs(m=4, per_unit=True)
    kw = dict(rollout_len=4, n_epochs=2, n_minibatch=1, lr=3e-3)
    init_j, ts_j, _ = j_make_ppo(cfg_j, JPPOConfig(**kw), hidden=HIDDEN,
                                 dtype=jnp.float64)
    init_t, ts_t, _ = make_ppo(cfg_t, PPOConfig(**kw), hidden=HIDDEN,
                               dtype=torch.float64)
    rj = jax.jit(init_j, static_argnums=1)(jax.random.PRNGKey(0), N)
    rt = init_t(N, torch.Generator().manual_seed(0))
    load(rt.net, rj.params)
    rt = dataclasses.replace(rt, **carry_env(cfg_t, rj.env_state, rj.obs))

    greedy(monkeypatch)
    ts_j = jax.jit(ts_j)
    for _ in range(2):
        rj, mj = ts_j(rj)
        rt, mt = ts_t(rt)
        for k in ("loss", "pg_loss", "v_loss", "entropy", "reward_mean"):
            assert rel_err(mt[k], mj[k]) <= 1e-6, (k, float(mt[k]), mj[k])
        assert float(mt["done_frac"]) == float(mj["done_frac"]) == 0.0
    np.testing.assert_allclose(rt.obs.numpy(), np.asarray(rj.obs), rtol=0,
                               atol=1e-9)
    assert_params_equal(rt.net, rj.params)
    assert rt.update_i == int(rj.update_i) == 2


def test_torch_learn_ppo_gae_on_a_trajectory_with_dones():
    rng = np.random.default_rng(5)
    t_len, n, gamma, lam = 7, 3, 0.97, 0.9
    r = rng.standard_normal((t_len, n))
    v = rng.standard_normal((t_len, n))
    done = np.zeros((t_len, n))
    done[2, 0] = done[5, 1] = done[6, 2] = 1.0
    last_v = rng.standard_normal(n)
    want = np.zeros((t_len, n))
    for e in range(n):
        g = 0.0
        for t in reversed(range(t_len)):
            nv = last_v[e] if t == t_len - 1 else v[t + 1, e]
            nonterm = 1.0 - done[t, e]
            g = r[t, e] + gamma * nv * nonterm - v[t, e] + (
                gamma * lam * nonterm * g)
            want[t, e] = g
    f = torch.from_numpy
    adv, ret = ppo_mod.gae(f(r), f(v), f(done), f(last_v), gamma, lam)
    np.testing.assert_allclose(adv.numpy(), want, rtol=0, atol=1e-14)
    np.testing.assert_allclose(ret.numpy(), want + v, rtol=0, atol=1e-14)
    # a done step does not bootstrap: its advantage is r - v
    assert adv[6, 2] == pytest.approx(r[6, 2] - v[6, 2], abs=1e-15)


def test_torch_learn_ppo_clip_by_global_norm_is_optaxs_rule():
    import optax

    rng = np.random.default_rng(1)
    grads = [rng.standard_normal((4, 3)), rng.standard_normal(5)]
    norm = np.sqrt(sum((g * g).sum() for g in grads))
    for max_norm in (norm * 0.5, norm * 2.0, norm):
        got = ppo_mod.clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                          max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15,
                                       atol=0)
    # below the norm: unchanged, bit for bit
    same = ppo_mod.clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                       norm * 2.0)
    assert all(np.array_equal(a.numpy(), g) for a, g in zip(same, grads))


def test_torch_learn_ppo_rejects_continuous_and_sizes_heads():
    with pytest.raises(ValueError, match="discrete"):
        make_ppo(make_env_config("10", n_sub=40, continuous=True,
                                 device="cpu"), PPOConfig())
    g = torch.Generator().manual_seed(0)
    *_, make_net = make_ppo(make_env_config("10", n_sub=40, device="cpu",
                                            anomaly_detect=True), PPOConfig())
    logits, v = make_net(generator=g)(torch.zeros(3, 13))
    assert logits.shape == (3, 6) and v.shape == (3,)
    fc = make_fleet_config("10", m=16, per_unit=True, n_sub=40, device="cpu")
    *_, make_net = make_ppo(fc, PPOConfig())
    logits, _ = make_net(generator=g)(torch.zeros(3, 13 + 64))
    assert logits.shape == (3, 16 * 5)
    with pytest.raises(ValueError, match="fleet"):
        make_ppo(make_fleet_config("10", m=2, n_sub=40, device="cpu",
                                   anomaly_detect=True), PPOConfig())


def test_torch_learn_ppo_is_bitwise_deterministic_per_seed():
    cfg = make_env_config("10", dtype=torch.float32, n_sub=40, horizon=3,
                          device="cpu", scen=ScenarioConfig(**SCEN3))
    init, ts, _ = make_ppo(cfg, PPOConfig(rollout_len=2, n_epochs=2,
                                          n_minibatch=2), hidden=(16, 16))
    outs = []
    for _ in range(2):
        r = init(4, torch.Generator().manual_seed(7))
        for _ in range(2):      # 4 steps over a horizon of 3: an autoreset
            r, m = ts(r)
        outs.append((r.obs, m, list(r.net.parameters())))
    (o1, m1, p1), (o2, m2, p2) = outs
    assert torch.equal(o1, o2)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert float(m1["done_frac"]) > 0.0
    assert all(torch.isfinite(m1[k]) for k in m1)


@pytest.mark.parametrize("kind, kw", [
    ("single", {}), ("single", dict(anomaly_detect=True)),
    ("single", dict(continuous=True)), ("fleet", dict(m=3)),
    ("fleet", dict(m=3, per_unit=True)),
], ids=["plain", "anomaly", "continuous", "fleet", "fleet_per_unit"])
def test_torch_learn_env_api_widths_match_reference(kind, kw):
    from pvderx.learn.env_api import make_env_api as j_make_env_api
    from pvderx_torch.learn.env_api import make_env_api

    cfg_j, cfg_t = single_cfgs(**kw) if kind == "single" else fleet_cfgs(**kw)
    j, t = j_make_env_api(cfg_j), make_env_api(cfg_t)
    assert (t.n_actions, t.act_dim, t.obs_dim, t.n_units) == (
        j.n_actions, j.act_dim, j.obs_dim, j.n_units)
    assert t.device == torch.device("cpu") and t.dtype == torch.float64
