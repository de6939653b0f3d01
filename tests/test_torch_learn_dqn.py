"""DQN and the packed replay: `pvderx_torch.learn.dqn` / `.replay` against
`pvderx.learn.dqn` / `.replay`.

- One `train_step` equals the reference's: from the same float32 params and
  the same env state (carried over as in `test_torch_learn_ppo`), two train
  steps give the same params, target params, replay contents, obs and
  metrics. 8 envs, n_sub 40, rollout 4, 2 updates of batch 16, target sync
  every 2 steps, hidden (32, 32), float64 env and compute, the anomaly task
  (6 actions). Randomness out on both sides, in the test only: epsilon 0
  (greedy collection), and a fixed index set in place of
  `pvderx.learn.dqn.sample_rows` and the port's. Tolerances, each with what
  it reads: params and target params <= 1e-6 of the leaf's largest
  magnitude (reads 1.6e-7: Adam's arithmetic rounds in another order);
  replay and obs <= 1e-9 (1.1e-15: greedy actions are integers, so the
  env sees the same ones); metrics <= 1e-6 relative (3.7e-8).
- Replay: packed rows come back bitwise, circular writes wrap, and an
  insert of more rows than the capacity raises (twin of
  tests/test_dqn.py::test_packed_replay_roundtrip_and_wrap).
- Mechanics twins of tests/test_dqn.py: the continuous and per-unit configs
  rejected, bitwise determinism under one generator seed with the epsilon
  schedule and buffer fill, the periodic hard target sync, the anomaly head
  width, params that move and stay finite.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.learn import DQNConfig as JDQNConfig, make_dqn as j_make_dqn
from pvderx_torch.env import make_env_config, make_fleet_config
from pvderx_torch.learn import DQNConfig, make_dqn
from pvderx_torch.learn import dqn as dqn_mod
from pvderx_torch.learn.replay import insert_rows, make_replay, sample_rows
from test_torch_learn_ppo import (
    HIDDEN, N, assert_params_equal, carry_env, load, rel_err, single_cfgs)


def fixed_rows(monkeypatch, module_j, module_t, idx):
    """``sample_rows`` of both learners replaced by a fixed index set."""
    monkeypatch.setattr(module_j, "sample_rows",
                        lambda rp, key, bs: rp.data[jnp.asarray(idx)])
    monkeypatch.setattr(module_t, "sample_rows",
                        lambda rp, g, bs: rp.data[torch.as_tensor(idx)])


def test_torch_learn_dqn_train_step_matches_reference(monkeypatch):
    import pvderx.learn.dqn as j_dqn_mod

    cfg_j, cfg_t = single_cfgs(anomaly_detect=True)
    kw = dict(lr=1e-3, eps_start=0.0, eps_end=0.0, rollout_len=4,
              n_updates=2, batch_size=16, capacity=64, target_every=2)
    init_j, ts_j, _ = j_make_dqn(cfg_j, JDQNConfig(**kw), hidden=HIDDEN,
                                 dtype=jnp.float64)
    init_t, ts_t, _ = make_dqn(cfg_t, DQNConfig(**kw), hidden=HIDDEN,
                               dtype=torch.float64)
    rj = jax.jit(init_j, static_argnums=1)(jax.random.PRNGKey(1), N)
    rt = init_t(N, torch.Generator().manual_seed(0))
    load(rt.net, rj.params)
    load(rt.net_tgt, rj.params_tgt)
    rt = dataclasses.replace(rt, **carry_env(cfg_t, rj.env_state, rj.obs))
    # rows of the first insert only (4 steps x 8 envs), repeats included
    fixed_rows(monkeypatch, j_dqn_mod, dqn_mod,
               np.random.default_rng(0).integers(0, 32, 16))

    ts_j = jax.jit(ts_j)
    for step in range(2):
        rj, mj = ts_j(rj)
        rt, mt = ts_t(rt)
        for k in ("loss", "q_mean", "reward_mean"):
            assert rel_err(mt[k], mj[k]) <= 1e-6, (k, float(mt[k]), mj[k])
        assert mt["epsilon"] == float(mj["epsilon"]) == 0.0
        assert mt["buffer_size"] == int(mj["buffer_size"]) == 32 * (step + 1)
        if step == 0:     # no sync yet: the target is the initial net
            assert_params_equal(rt.net_tgt, rj.params_tgt, tol=0.0)
    np.testing.assert_allclose(rt.replay.data.numpy(),
                               np.asarray(rj.replay.data), rtol=0, atol=1e-9)
    assert rt.replay.ptr == int(rj.replay.ptr)
    np.testing.assert_allclose(rt.obs.numpy(), np.asarray(rj.obs), rtol=0,
                               atol=1e-9)
    assert_params_equal(rt.net, rj.params)
    assert_params_equal(rt.net_tgt, rj.params_tgt)
    # the sync after step 2 copied the net bit for bit
    for a, b in zip(rt.net.parameters(), rt.net_tgt.parameters()):
        assert torch.equal(a, b)


def test_torch_learn_replay_roundtrip_wrap_and_capacity():
    rp = make_replay(8, 5, torch.float32, "cpu")
    rows1 = torch.arange(30, dtype=torch.float32).reshape(6, 5)
    rp = insert_rows(rp, rows1)
    assert rp.ptr == 6 and rp.size == 6
    got = sample_rows(rp, torch.Generator().manual_seed(0), 64)
    # every sampled row is an inserted row, bitwise; only filled slots
    assert all(any(torch.equal(g, r) for r in rows1) for g in got)
    assert len({tuple(g.tolist()) for g in got}) == 6
    rows2 = 100.0 + torch.arange(20, dtype=torch.float32).reshape(4, 5)
    rp = insert_rows(rp, rows2)       # overwrites slots 6, 7, 0, 1
    assert rp.ptr == 2 and rp.size == 8
    assert torch.equal(rp.data[6], rows2[0])
    assert torch.equal(rp.data[0], rows2[2])
    assert torch.equal(rp.data[2], rows1[2])      # untouched slot
    with pytest.raises(ValueError, match="capacity"):
        insert_rows(rp, torch.zeros(9, 5))
    # an empty buffer samples slot 0, as the reference's max(size, 1)
    empty = make_replay(4, 2, torch.float64, "cpu")
    assert torch.equal(sample_rows(empty, torch.Generator(), 3),
                       torch.zeros(3, 2, dtype=torch.float64))


def test_torch_learn_dqn_rejects_continuous_and_per_unit():
    with pytest.raises(ValueError, match="discrete"):
        make_dqn(make_env_config("10", n_sub=40, continuous=True,
                                 device="cpu"), DQNConfig())
    with pytest.raises(ValueError, match="PPO-only"):
        make_dqn(make_fleet_config("10", m=4, per_unit=True, n_sub=40,
                                   device="cpu"), DQNConfig())


def test_torch_learn_dqn_deterministic_sync_and_head_width():
    cfg = make_env_config("10", horizon=20, n_sub=40, device="cpu",
                          anomaly_detect=True)
    dqn = DQNConfig(rollout_len=2, n_updates=2, batch_size=16, capacity=256,
                    target_every=2, lr=1e-3)
    init, ts, make_net = make_dqn(cfg, dqn, hidden=(16, 16))
    q = make_net(generator=torch.Generator())(torch.zeros(4, 13))
    assert q.shape == (4, 6)
    outs = []
    for _ in range(2):
        r = init(4, torch.Generator().manual_seed(0))
        p0 = [p.clone() for p in r.net.parameters()]
        r, m1 = ts(r)       # update_i -> 1: no sync
        assert any(not torch.equal(a, b) for a, b in
                   zip(r.net.parameters(), r.net_tgt.parameters()))
        r, m2 = ts(r)       # update_i -> 2: hard sync
        assert all(torch.equal(a, b) for a, b in
                   zip(r.net.parameters(), r.net_tgt.parameters()))
        outs.append((r.obs, m2))
    (o1, ma), (o2, mb) = outs
    assert torch.equal(o1, o2)                            # bitwise
    assert torch.equal(ma["loss"], mb["loss"])
    assert ma["buffer_size"] == 2 * 2 * 4
    assert m1["epsilon"] == dqn.eps_start
    assert ma["epsilon"] == pytest.approx(
        dqn.eps_start + (1 / dqn.eps_decay_updates) * (
            dqn.eps_end - dqn.eps_start), abs=1e-12)
    assert all(not torch.equal(a, b) for a, b in zip(p0, r.net.parameters()))
    assert torch.isfinite(ma["loss"]) and torch.isfinite(ma["q_mean"])
