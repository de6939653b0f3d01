"""Batched environment: reset/step factories and the rollout loop.

All env state is a dataclass of [N, ...] tensors and one step advances all N
envs. The window integration runs through `ops.window.rk4_window_batch`
(the CUDA kernel on the card, its plain version on the CPU), or for the df32
precision tier through `ops.dualfloat.rk4_window_batch_df`. Auto-reset is a
`torch.where` select between the stepped state and a soft-reset state.
"""
from __future__ import annotations

import torch

from pvderx_torch._struct import tree_map
from pvderx_torch.env import core
from pvderx_torch.ops.dualfloat import rk4_window_batch_df
from pvderx_torch.ops.window import P_FIELDS, U_FIELDS, pack_struct


def _where_done(done, a, b):
    """torch.where with done [N] broadcast against [N, ...] leaves; a leaf
    that is the same tensor in both states is passed through."""
    if a is b:
        return a
    d = done.reshape(done.shape + (1,) * (a.dim() - 1))
    return torch.where(d, a, b)


def autoreset(done, restarted, stepped):
    """Select the soft-reset (state, obs) where done, else the stepped one."""
    (st_r, obs_r), (st1, obs) = restarted, stepped
    return (tree_map(lambda a, b: _where_done(done, a, b), st_r, st1),
            _where_done(done, obs_r, obs))


def _step_batch_impl(cfg: core.EnvConfig, state, actions, generator,
                     p_pack=None):
    """core.step of every env, then the autoreset select on done."""
    st1, obs, reward, done, info = core.step(cfg, state, actions, p_pack)
    uv = core.event_draws(cfg, state.y.shape[0], generator)
    st2, obs2 = autoreset(done, core._soft_reset(cfg, st1, uv), (st1, obs))
    return st2, obs2, reward, done, info


def make_batch_fns(cfg: core.EnvConfig):
    """Returns (reset_batch(n, generator) -> (state, obs),
                step_batch(state, actions, generator)
                    -> (state, obs, reward, done, info)).

    actions: [N] integer (discrete) or [N, 2] (continuous). step_batch
    auto-resets done envs, drawing their new events from ``generator`` (on
    ``cfg.device``); `core.step` is the step without autoreset. All outputs
    are batched on axis 0.
    """

    def reset_batch(n: int, generator: torch.Generator):
        return core.reset(cfg, n, generator)

    def step_batch(state, actions, generator: torch.Generator):
        return _step_batch_impl(cfg, state, actions, generator)

    return reset_batch, step_batch


def _step_df_impl(cfg: core.EnvConfig, carry, actions, generator,
                  p_pack=None):
    """The df32 step of every env: `core._pre_window`, the double-float
    window, `core._post_window` on hi, then the autoreset select, which
    zeroes y_lo where done (the cached y0 is an exact-f32 episode anchor)."""
    state, y_lo = carry
    t, exog, mppt, flag = core._pre_window(cfg, state, actions)
    if p_pack is None:
        p_pack = pack_struct(state.der, P_FIELDS)
    y1, y1_lo = rk4_window_batch_df(
        state.y, y_lo, t, p_pack, pack_struct(exog, U_FIELDS),
        n_ph=cfg.der.n_ph, n_sub=cfg.n_sub, dt=cfg.dt_ctrl)
    st1, obs, reward, done, info = core._post_window(cfg, state, exog, mppt,
                                                     t, y1, flag)
    uv = core.event_draws(cfg, state.y.shape[0], generator)
    st2, obs2 = autoreset(done, core._soft_reset(cfg, st1, uv), (st1, obs))
    y_lo2 = _where_done(done, torch.zeros_like(y1_lo), y1_lo)
    return (st2, y_lo2), obs2, reward, done, info


def make_batch_fns_df(cfg: core.EnvConfig):
    """The df32 precision tier at the env surface: the contract of
    `make_batch_fns`, with the ODE state carried as a two-float32 (hi, lo)
    pair through the double-float window (the <= 1e-6 trajectory tier).

    Returns (reset_df(n, generator) -> ((state, y_lo), obs),
             step_df((state, y_lo), actions, generator, p_pack=None)
                 -> ((state, y_lo), obs, reward, done, info)).

    The carry is the plain EnvState plus the [N, n_states] lo residual.
    Observations, rewards and termination evaluate on hi (f32 surfaces by
    contract); lo rides the integration and is zeroed on autoreset. The
    config must be float32 and ``integrator="rk4"``.
    """
    if cfg.integrator != "rk4":
        raise ValueError("the df32 tier implements integrator='rk4' only")
    if cfg.dtype != torch.float32:
        raise ValueError(f"the df32 tier runs on float32, got {cfg.dtype}")

    def reset_df(n: int, generator: torch.Generator):
        state, obs = core.reset(cfg, n, generator)
        return (state, torch.zeros_like(state.y)), obs

    def step_df(carry, actions, generator: torch.Generator, p_pack=None):
        return _step_df_impl(cfg, carry, actions, generator, p_pack)

    return reset_df, step_df


def rollout_df(cfg: core.EnvConfig, carry, obs, policy_fn, n_steps: int,
               generator: torch.Generator):
    """`rollout` for the df32 tier: carry is (state, y_lo). Returns (carry,
    obs, rewards [T, N], dones [T, N])."""
    return rollout_with(_step_df_impl, cfg, carry, obs, policy_fn, n_steps,
                        generator, pack_struct(carry[0].der, P_FIELDS))


def rollout(cfg: core.EnvConfig, state, obs, policy_fn, n_steps: int,
            generator: torch.Generator):
    """Run a policy for n_steps of a batched env with auto-reset.

    policy_fn(obs, generator) -> actions. Returns (state, obs, rewards [T, N],
    dones [T, N]).
    """
    return rollout_with(_step_batch_impl, cfg, state, obs, policy_fn, n_steps,
                        generator, pack_struct(state.der, P_FIELDS))


def rollout_with(step_impl, cfg, state, obs, policy_fn, n_steps: int,
                 generator: torch.Generator, p_pack):
    """The rollout loop over ``step_impl(cfg, state, actions, generator,
    p_pack)``, a batched step with autoreset. Per-env params never change
    across steps (soft reset keeps der), so the caller packs them once."""
    rews, dones = [], []
    for _ in range(n_steps):
        acts = policy_fn(obs, generator)
        state, obs, rew, done, _ = step_impl(cfg, state, acts, generator,
                                             p_pack)
        rews.append(rew)
        dones.append(done)
    return state, obs, torch.stack(rews), torch.stack(dones)
