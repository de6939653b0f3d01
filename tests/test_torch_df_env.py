"""The port's df32 env tier (`pvderx_torch.env.make_batch_fns_df`).

- The contract of the reference's tests/test_env.py::test_df32_env_tier_contract
  on the port, at preset 10, f32, n_sub=48, horizon 4, N=128, against the
  port's own f32 step: equal reset obs; for 3 steps obs within 2e-4 (the
  f32 tier's own error against the df32 trajectory) and equal done; y_lo
  alive; on the 4th step every env is done, y_lo is exactly 0 and the
  episodes restarted.
- One step of the same state through the reference: JAX `core._pre_window`,
  the reference df32 kernel body run eagerly (see
  tests/test_torch_dualfloat_window.py), JAX `core._post_window`, against
  the port's `step_df` at N=4, n_sub=40: obs, reward and the (hi + lo) state
  within 1e-6 (the f32 glue on each side rounds differently: XLA fuses and
  contracts, torch does not).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.env import core as jcore
from pvderx.ops import window as jwin
from pvderx_torch.convert import state_from_numpy
from pvderx_torch.env import (
    make_batch_fns, make_batch_fns_df, make_env_config, rollout_df)
from pvderx_torch.ops.dualfloat import rk4_window_batch_df
from test_torch_dualfloat_window import reference_window_df


def test_torch_df_env_tier_contract():
    cfg = make_env_config("10", dtype=torch.float32, n_sub=48, horizon=4,
                          device="cpu")
    n = 128
    reset_df, step_df = make_batch_fns_df(cfg)
    reset_b, step_b = make_batch_fns(cfg)
    g_df, g_f = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    carry, obs0 = reset_df(n, g_df)
    st_f, obs_f = reset_b(n, g_f)
    assert torch.equal(obs0, obs_f)
    assert torch.equal(carry[1], torch.zeros_like(st_f.y))

    acts = torch.zeros(n, dtype=torch.int64)
    before = rk4_window_batch_df.launches
    for k in range(3):
        carry, obs, rew, done, info = step_df(carry, acts, g_df)
        st_f, obs_f, rew_f, done_f, _ = step_b(st_f, acts, g_f)
        np.testing.assert_allclose(obs.numpy(), obs_f.numpy(), rtol=0,
                                   atol=2e-4, err_msg=f"obs at step {k}")
        assert torch.equal(done, done_f)
        assert not bool(done.any())            # horizon 4: nobody done yet
    st2, y_lo = carry
    assert float(y_lo.abs().max()) > 0.0       # the lo residual is carried
    # the 4th step truncates every env: autoreset zeroes y_lo
    carry, obs, rew, done, info = step_df(carry, acts, g_df)
    assert bool(done.all())
    st3, y_lo3 = carry
    assert float(y_lo3.abs().max()) == 0.0
    assert int(st3.t_step.max()) == 0
    assert torch.equal(st3.y, st3.y0)
    assert rk4_window_batch_df.launches == before   # the CPU launches nothing


def test_torch_df_rollout_and_rejections():
    cfg = make_env_config("10", dtype=torch.float32, n_sub=40, horizon=2,
                          device="cpu")
    reset_df, _ = make_batch_fns_df(cfg)
    g = torch.Generator().manual_seed(1)
    carry, obs = reset_df(3, g)
    policy = lambda o, gen: torch.randint(0, 5, (o.shape[0],), generator=gen)
    carry, obs, rews, dones = rollout_df(cfg, carry, obs, policy, 2, g)
    assert tuple(rews.shape) == (2, 3) and tuple(obs.shape) == (3, 13)
    assert bool(dones[1].all()) and not bool(dones[0].any())
    assert bool(torch.isfinite(rews).all())
    assert float(carry[1].abs().max()) == 0.0   # all done: lo zeroed
    with pytest.raises(ValueError, match="integrator='rk4' only"):
        make_batch_fns_df(dataclasses.replace(cfg, integrator="trapezoid"))
    with pytest.raises(ValueError, match="float32"):
        make_batch_fns_df(make_env_config("10", dtype=torch.float64, n_sub=40,
                                          device="cpu"))


def test_torch_df_step_matches_reference_pre_body_post(monkeypatch):
    n, n_sub = 4, 40
    cfg_j = jcore.make_env_config("10", dtype=jnp.float32, n_sub=n_sub)
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    st_j, _ = jax.jit(jax.vmap(lambda k: jcore.reset(cfg_j, k)))(keys)
    cfg = make_env_config("10", dtype=torch.float32, n_sub=n_sub, device="cpu")
    st = state_from_numpy(dataclasses.asdict(jax.tree.map(np.asarray, st_j)),
                          cfg)
    rng = np.random.default_rng(0)
    y_hi = np.asarray(st_j.y)
    y_lo = (1e-9 * y_hi * rng.standard_normal(y_hi.shape)).astype(np.float32)
    acts = np.array([1, 2, 3, 4])

    t, exog, mppt, flag = jax.vmap(
        lambda s, a: jcore._pre_window(cfg_j, s, a))(st_j, jnp.asarray(acts))
    hi, lo = reference_window_df(
        monkeypatch, y_hi, y_lo, np.asarray(t),
        np.asarray(jwin.pack_struct(st_j.der, jwin.P_FIELDS)),
        np.asarray(jwin.pack_struct(exog, jwin.U_FIELDS)), n_ph=1,
        n_sub=n_sub, dt=cfg_j.dt_ctrl)
    _, obs_j, rew_j, done_j, _ = jax.vmap(
        lambda s, e, m, tt, yy, fl: jcore._post_window(cfg_j, s, e, m, tt, yy,
                                                       fl))(
        st_j, exog, mppt, t, jnp.asarray(hi), flag)

    _, step_df = make_batch_fns_df(cfg)
    (st1, lo1), obs, rew, done, _ = step_df(
        (st, torch.from_numpy(y_lo)), torch.from_numpy(acts),
        torch.Generator().manual_seed(0))
    assert not bool(done.any())
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rew.numpy(), np.asarray(rew_j), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))
    got = st1.y.numpy().astype(np.float64) + lo1.numpy()
    want = hi.astype(np.float64) + lo
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
