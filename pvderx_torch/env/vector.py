"""Batched environment: reset/step factories and the rollout loop.

All env state is a dataclass of [N, ...] tensors and one step advances all N
envs. The window integration runs through `ops.window.rk4_window_batch`
(the CUDA kernel on the card, its plain version on the CPU), or for the df32
precision tier through `ops.dualfloat.rk4_window_batch_df`. Auto-reset is a
`torch.where` select between the stepped state and a soft-reset state.

Under a ``mesh`` (`pvderx_torch.dist`), each rank holds its contiguous
N/W rows of the global batch and steps only those: one window-kernel
launch per step on the local batch. The envs never talk to each other, so
the only global thing in a step is its random draws, which every rank
makes at the global shape from the same generator state, keeping its rows
(`dist.mesh.draw_rows`); a W-rank run then steps bit for bit as the
one-rank run does. A global N that the env axis does not divide raises
``ValueError``. (The reference falls back to its scan path there with
``window="auto"``; the port has no window knob and no such fallback.)
"""
from __future__ import annotations

import torch

from functools import partial

from pvderx_torch.diag.profiler import span
from pvderx_torch.dist.mesh import local_count
from pvderx_torch.env import core
from pvderx_torch.ops.dualfloat import rk4_window_batch_df
from pvderx_torch.ops.window import P_FIELDS, U_FIELDS, pack_struct


def make_batch_fns(cfg: core.EnvConfig, mesh=None):
    """Returns (reset_batch(n, generator) -> (state, obs),
                step_batch(state, actions, generator)
                    -> (state, obs, reward, done, info)).

    actions: [N] integer (discrete) or [N, 2] (continuous). step_batch
    auto-resets done envs, drawing their new events from ``generator`` (on
    ``cfg.device``), as `core.step_autoreset`; `core.step` is the step
    without autoreset. All outputs are batched on axis 0.

    ``mesh``: ``n`` is the global env count, and the state, actions and
    outputs are this rank's rows (see the module docstring).
    """

    def reset_batch(n: int, generator: torch.Generator):
        return core.reset(cfg, local_count(mesh, n), generator, mesh)

    def step_batch(state, actions, generator: torch.Generator):
        return core.step_autoreset(cfg, state, actions, generator,
                                   mesh=mesh)

    return reset_batch, step_batch


def _step_df_impl(cfg: core.EnvConfig, carry, actions, generator,
                  p_pack=None, mesh=None):
    """The df32 step of every env: `core._pre_window`, the double-float
    window, `core._post_window` on hi, then the autoreset select, which
    zeroes y_lo where done (the cached y0 is an exact-f32 episode anchor)."""
    state, y_lo = carry
    with span("env.step"):
        t, exog, mppt, flag = core._pre_window(cfg, state, actions)
        with span("env.window"):
            if p_pack is None:
                p_pack = pack_struct(state.der, P_FIELDS)
            y1, y1_lo = rk4_window_batch_df(
                state.y, y_lo, t, p_pack, pack_struct(exog, U_FIELDS),
                n_ph=cfg.der.n_ph, n_sub=cfg.n_sub, dt=cfg.dt_ctrl)
        st1, obs, reward, done, info = core._post_window(
            cfg, state, exog, mppt, t, y1, flag)
        with span("env.autoreset"):
            uv = core.event_draws(cfg, state.y.shape[0], generator, mesh)
            st2, obs2 = core.autoreset(done, core._soft_reset(cfg, st1, uv),
                                       (st1, obs))
            y_lo2 = core._where_done(done, torch.zeros_like(y1_lo), y1_lo)
    return (st2, y_lo2), obs2, reward, done, info


def make_batch_fns_df(cfg: core.EnvConfig, mesh=None):
    """The df32 precision tier at the env surface: the contract of
    `make_batch_fns`, with the ODE state carried as a two-float32 (hi, lo)
    pair through the double-float window (the <= 1e-6 trajectory tier).

    Returns (reset_df(n, generator) -> ((state, y_lo), obs),
             step_df((state, y_lo), actions, generator, p_pack=None)
                 -> ((state, y_lo), obs, reward, done, info)).

    The carry is the plain EnvState plus the [N, n_states] lo residual.
    Observations, rewards and termination evaluate on hi (f32 surfaces by
    contract); lo rides the integration and is zeroed on autoreset. The
    config must be float32 and ``integrator="rk4"``. ``mesh``: as in
    `make_batch_fns` (each rank launches K3 on its rows).
    """
    if cfg.integrator != "rk4":
        raise ValueError("the df32 tier implements integrator='rk4' only")
    if cfg.dtype != torch.float32:
        raise ValueError(f"the df32 tier runs on float32, got {cfg.dtype}")

    def reset_df(n: int, generator: torch.Generator):
        state, obs = core.reset(cfg, local_count(mesh, n), generator, mesh)
        return (state, torch.zeros_like(state.y)), obs

    def step_df(carry, actions, generator: torch.Generator, p_pack=None):
        return _step_df_impl(cfg, carry, actions, generator, p_pack, mesh)

    return reset_df, step_df


def rollout_df(cfg: core.EnvConfig, carry, obs, policy_fn, n_steps: int,
               generator: torch.Generator, mesh=None):
    """`rollout` for the df32 tier: carry is (state, y_lo). Returns (carry,
    obs, rewards [T, N], dones [T, N])."""
    return rollout_with(partial(_step_df_impl, mesh=mesh), cfg, carry, obs,
                        policy_fn, n_steps, generator,
                        pack_struct(carry[0].der, P_FIELDS))


def rollout(cfg: core.EnvConfig, state, obs, policy_fn, n_steps: int,
            generator: torch.Generator, mesh=None):
    """Run a policy for n_steps of a batched env with auto-reset.

    policy_fn(obs, generator) -> actions. Returns (state, obs, rewards [T, N],
    dones [T, N]). ``mesh``: the state is this rank's rows and the
    autoreset draws are global (see the module docstring); a policy that
    draws does so itself (`dist.mesh.draw_rows`).
    """
    return rollout_with(partial(core.step_autoreset, mesh=mesh), cfg, state,
                        obs, policy_fn, n_steps, generator,
                        pack_struct(state.der, P_FIELDS))


def rollout_with(step_impl, cfg, state, obs, policy_fn, n_steps: int,
                 generator: torch.Generator, p_pack):
    """The rollout loop over ``step_impl(cfg, state, actions, generator,
    p_pack)``, a batched step with autoreset. Per-env params never change
    across steps (soft reset keeps der), so the caller packs them once."""
    with span("rollout"):
        rews, dones = [], []
        for _ in range(n_steps):
            with span("rollout.policy"):
                acts = policy_fn(obs, generator)
            state, obs, rew, done, _ = step_impl(cfg, state, acts, generator,
                                                 p_pack)
            rews.append(rew)
            dones.append(done)
        with span("rollout.stack"):
            rews, dones = torch.stack(rews), torch.stack(dones)
    return state, obs, rews, dones
