"""DQN learner for the discrete-action env.

The port of `pvderx.learn.dqn`. One `train_step` collects ``rollout_len``
epsilon-greedy batched env steps (each one K1 or K2 launch, the env's
window), writes them to the packed replay, and runs ``n_updates``
double-DQN TD steps: a Huber loss (delta 1, mean) and plain Adam, no clip.
Epsilon anneals linearly over ``eps_decay_updates`` train steps and is read
from ``update_i``. The target net syncs hard when ``update_i + 1`` is a
multiple of ``target_every``, after the step's updates.

Replay row layout: ``[obs (D) | act (as a float, exact for small ints) |
rew | done | nobs (D)]``, in the compute dtype. Every draw comes from the
runner's ``torch.Generator``.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, NamedTuple

import torch

from pvderx_torch.learn.env_api import make_env_api, pack_params
from pvderx_torch.learn.nets import QNetwork
from pvderx_torch.learn.replay import (
    Replay, insert_rows, make_replay, sample_rows)


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    lr: float = 3e-4
    gamma: float = 0.99
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_updates: int = 500   # train_steps over which epsilon anneals
    rollout_len: int = 8           # env steps collected per train_step
    n_updates: int = 8             # gradient steps per train_step
    batch_size: int = 256
    capacity: int = 65536          # replay slots
    target_every: int = 16         # hard target sync period (train_steps)
    double: bool = True            # double-DQN action selection


class Batch(NamedTuple):
    obs: torch.Tensor
    act: torch.Tensor
    rew: torch.Tensor
    nobs: torch.Tensor
    done: torch.Tensor


@dataclasses.dataclass
class DQNRunner:
    """``net``, ``net_tgt``, ``opt`` and the replay's data are updated in
    place by `train_step`; the rest is replaced."""

    net: QNetwork
    net_tgt: QNetwork
    opt: torch.optim.Adam
    replay: Replay
    env_state: Any
    obs: torch.Tensor
    p_pack: torch.Tensor
    generator: torch.Generator
    update_i: int = 0


def huber_loss(pred, target, delta: float = 1.0):
    """optax.huber_loss: 0.5 e² inside |e| <= delta, linear outside."""
    abs_err = torch.abs(pred - target)
    quadratic = torch.clamp(abs_err, max=delta)
    return 0.5 * quadratic ** 2 + delta * (abs_err - quadratic)


def make_dqn(env_cfg, dqn: DQNConfig, hidden=(128, 128), dtype=torch.float32):
    """Build (init_runner(n_envs, generator), train_step(runner), make_net).

    env_cfg must be discrete: a single-DER `EnvConfig` (the anomaly variant
    of BASELINE config 3 widens the head to N_ACTIONS_ANOM) or an aggregate
    `FleetConfig`. ``dtype`` is the compute dtype; parameters are float32.
    ``train_step(runner) -> (runner, metrics)`` is
    ``train_step.update(*train_step.collect(runner))``, as in `make_ppo`.
    """
    api = make_env_api(env_cfg)
    if api.n_units > 1:
        raise ValueError(
            "per-unit fleet control (FleetConfig(per_unit=True)) is "
            "PPO-only: DQN has no factored-action head; use "
            "pvderx_torch.learn.make_ppo, or the aggregate fleet mode")
    if api.n_actions == 0:
        raise ValueError("DQN requires a discrete env (continuous=False)")
    n_actions, d = api.n_actions, api.obs_dim
    make_net = functools.partial(QNetwork, d, n_actions, hidden, dtype)

    def init_runner(n_envs: int, generator: torch.Generator) -> DQNRunner:
        net = make_net(generator=generator)
        env_state, obs = api.reset_batch(n_envs, generator)
        net_tgt = copy.deepcopy(net).requires_grad_(False)
        return DQNRunner(
            net=net, net_tgt=net_tgt,
            opt=torch.optim.Adam(net.parameters(), lr=dqn.lr, eps=1e-8),
            replay=make_replay(dqn.capacity, 2 * d + 3, dtype, api.device),
            env_state=env_state, obs=obs, p_pack=pack_params(env_state),
            generator=generator)

    def _epsilon(update_i: int) -> float:
        frac = min(max(update_i / dqn.eps_decay_updates, 0.0), 1.0)
        return dqn.eps_start + frac * (dqn.eps_end - dqn.eps_start)

    @torch.no_grad()
    def collect(runner: DQNRunner):
        """``rollout_len`` epsilon-greedy env steps: (the runner at the new
        env state, (packed rows, rewards [T, N], epsilon))."""
        eps = _epsilon(runner.update_i)
        gen, st, ob = runner.generator, runner.env_state, runner.obs
        rows, rews = [], []
        for _ in range(dqn.rollout_len):
            greedy = torch.argmax(runner.net(ob), dim=-1)
            rand = torch.randint(0, n_actions, greedy.shape, generator=gen,
                                 device=greedy.device)
            explore = torch.rand(greedy.shape, generator=gen, dtype=dtype,
                                 device=greedy.device) < eps
            a = torch.where(explore, rand, greedy)
            st, ob2, r, done, _ = api.step(st, a, gen, runner.p_pack)
            r = r.to(dtype)
            rows.append(torch.cat([ob.to(dtype), a[:, None].to(dtype),
                                   r[:, None], done[:, None].to(dtype),
                                   ob2.to(dtype)], dim=1))
            rews.append(r)
            ob = ob2
        return dataclasses.replace(runner, env_state=st, obs=ob), (
            torch.cat(rows), torch.stack(rews), eps)

    def _unpack(mat) -> Batch:
        return Batch(obs=mat[:, :d], act=mat[:, d].long(), rew=mat[:, d + 1],
                     nobs=mat[:, d + 3:], done=mat[:, d + 2])

    def _update_once(runner: DQNRunner, rp: Replay):
        net, net_tgt = runner.net, runner.net_tgt
        b = _unpack(sample_rows(rp, runner.generator, dqn.batch_size))
        with torch.no_grad():
            q_next_tgt = net_tgt(b.nobs)
            a_next = torch.argmax(net(b.nobs) if dqn.double else q_next_tgt,
                                  dim=-1)
            q_next = q_next_tgt.gather(-1, a_next[:, None])[:, 0]
            target = b.rew + dqn.gamma * (1.0 - b.done) * q_next
        q_a = net(b.obs).gather(-1, b.act[:, None])[:, 0]
        loss = huber_loss(q_a, target).mean()
        params = list(net.parameters())
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        runner.opt.step()
        return torch.stack([loss, q_a.mean()]).detach()

    def update(runner: DQNRunner, rollout):
        """The replay insert, ``n_updates`` TD steps and the target sync."""
        rows, rews, eps = rollout
        rp = insert_rows(runner.replay, rows)
        loss, q_mean = torch.stack([_update_once(runner, rp)
                                    for _ in range(dqn.n_updates)]).mean(0)
        update_i = runner.update_i + 1
        if update_i % dqn.target_every == 0:
            runner.net_tgt.load_state_dict(runner.net.state_dict())
        metrics = {"loss": loss, "q_mean": q_mean, "epsilon": eps,
                   "reward_mean": rews.mean(), "buffer_size": rp.size}
        return dataclasses.replace(runner, replay=rp,
                                   update_i=update_i), metrics

    def train_step(runner: DQNRunner):
        return update(*collect(runner))

    train_step.collect, train_step.update = collect, update
    return init_runner, train_step, make_net


__all__ = ["DQNConfig", "DQNRunner", "make_dqn", "huber_loss"]
