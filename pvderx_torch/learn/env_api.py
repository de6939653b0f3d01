"""One learner-facing interface over the single-DER and the fleet env.

The port of `pvderx.learn.env_api`. The learners (PPO, DQN, SAC) need a
batched reset, a batched step with autoreset, and the widths of the action
and observation spaces. This module gives them both backends:

- the single-DER env (`pvderx_torch.env.core` + `env.vector`), BASELINE
  configs 1-4, with the anomaly-detection action (config 3) and the
  continuous Box extension; its window runs through K1
  (`ops.window.rk4_window_batch`);
- the shared-feeder fleet (`pvderx_torch.env.fleet`), BASELINE config 5;
  its window runs through K2 (`ops.window.rk4_fleet_window_batch`).

Under a ``mesh`` (`pvderx_torch.dist`), ``reset_batch(n, ...)`` takes the
global env count and both functions work on this rank's rows of the batch:
each rank launches the window kernel on its own N/W envs, and every random
draw is made at the global shape (`dist.mesh.draw_rows`).

The reference's runners call ``unalias`` on a fresh reset: it breaks the
aliases that reset leaves between cached buffers, which only XLA's buffer
donation needs. A torch step never writes into its inputs, so the port's
runners do not (`env.core.unalias` is there for the reference's surface).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from pvderx_torch.dist.mesh import local_count
from pvderx_torch.env import core, fleet
from pvderx_torch.ops.window import P_FIELDS, pack_struct


class EnvAPI(NamedTuple):
    """What a learner needs from an env backend (see the module docstring).

    reset_batch(n, generator) -> (state, obs)
    step(state, actions, generator, p_pack=None) -> (state, obs, reward,
        done, info), autoreset on: a done env restarts, its new events
        drawn from ``generator``.
    ``p_pack`` is `pack_params` of the state (packed by the step when
    omitted): per-env params never change across steps (a soft reset keeps
    them), so a runner packs them once.
    """

    reset_batch: Callable
    step: Callable
    n_actions: int      # discrete action count (0 if continuous)
    act_dim: int        # continuous action width (0 if discrete)
    obs_dim: int
    n_units: int        # action channels per env: 1, or M in per-unit fleet
                        # mode (actions [N, M]; the policy factorizes)
    device: torch.device  # the config's
    dtype: torch.dtype


def pack_params(state) -> torch.Tensor:
    """The window's params pack of an env or fleet state: [29, N] or
    [29, N, M]."""
    return pack_struct(state.der, P_FIELDS)


def make_env_api(env_cfg, mesh=None) -> EnvAPI:
    """The learner-facing API of an `EnvConfig` or a `FleetConfig`. The
    device and dtype are the config's (``device="cpu"`` in
    `make_env_config` for the plain windows). ``mesh``: see the module
    docstring."""
    if isinstance(env_cfg, fleet.FleetConfig):
        base = env_cfg.base
        if base.anomaly_detect or base.continuous:
            raise ValueError(
                "the fleet env's action space is the fleet-level Discrete(5) "
                "only; anomaly_detect/continuous are single-DER env features "
                "(pvderx_torch/env/fleet.py ignores them: don't set them on "
                "the FleetConfig base)")

        def reset_batch(n: int, generator: torch.Generator):
            return fleet.reset(env_cfg, local_count(mesh, n), generator,
                               mesh)

        def step(state, actions, generator, p_pack=None):
            return fleet.step_autoreset(env_cfg, state, actions, generator,
                                        p_pack, mesh)

        return EnvAPI(reset_batch=reset_batch, step=step,
                      n_actions=core.N_ACTIONS, act_dim=0,
                      obs_dim=fleet.fleet_obs_dim(env_cfg),
                      n_units=env_cfg.m if env_cfg.per_unit else 1,
                      device=base.device, dtype=base.dtype)

    if env_cfg.continuous:
        n_actions, act_dim = 0, core.ACT_DIM_CONT
    elif env_cfg.anomaly_detect:
        n_actions, act_dim = core.N_ACTIONS_ANOM, 0
    else:
        n_actions, act_dim = core.N_ACTIONS, 0

    def reset_batch(n: int, generator: torch.Generator):
        return core.reset(env_cfg, local_count(mesh, n), generator, mesh)

    def step(state, actions, generator, p_pack=None):
        return core.step_autoreset(env_cfg, state, actions, generator,
                                   p_pack, mesh)

    return EnvAPI(reset_batch=reset_batch, step=step, n_actions=n_actions,
                  act_dim=act_dim, obs_dim=core.OBS_DIM, n_units=1,
                  device=env_cfg.device, dtype=env_cfg.dtype)


__all__ = ["EnvAPI", "make_env_api", "pack_params"]
