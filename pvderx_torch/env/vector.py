"""Batched environment: reset/step factories and the rollout loop.

All env state is a dataclass of [N, ...] tensors and one step advances all N
envs. The window integration runs through `ops.window.rk4_window_batch`
(the CUDA kernel on the card, its plain version on the CPU). Auto-reset is a
`torch.where` select between the stepped state and a soft-reset state.
"""
from __future__ import annotations

import torch

from pvderx_torch._struct import tree_map
from pvderx_torch.env import core
from pvderx_torch.ops.window import P_FIELDS, pack_struct


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


def rollout(cfg: core.EnvConfig, state, obs, policy_fn, n_steps: int,
            generator: torch.Generator):
    """Run a policy for n_steps of a batched env with auto-reset.

    policy_fn(obs, generator) -> actions. Returns (state, obs, rewards [T, N],
    dones [T, N]).
    """
    return rollout_with(_step_batch_impl, cfg, state, obs, policy_fn, n_steps,
                        generator)


def rollout_with(step_impl, cfg, state, obs, policy_fn, n_steps: int,
                 generator: torch.Generator):
    """The rollout loop over ``step_impl(cfg, state, actions, generator,
    p_pack)``, a batched step with autoreset."""
    # per-env params never change across steps (soft reset keeps der), so the
    # kernel's params pack is loop-invariant: pack once outside the loop
    p_pack = pack_struct(state.der, P_FIELDS)
    rews, dones = [], []
    for _ in range(n_steps):
        acts = policy_fn(obs, generator)
        state, obs, rew, done, _ = step_impl(cfg, state, acts, generator,
                                             p_pack)
        rews.append(rew)
        dones.append(done)
    return state, obs, torch.stack(rews), torch.stack(dones)
