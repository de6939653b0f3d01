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

Under a ``mesh`` (`pvderx_torch.dist`) each rank steps and stores its own
envs (a rank-local replay, `learn.replay`), draws at the global shape
(epsilon-greedy draws, the global sample's slots), computes the loss terms
of the samples it owns over the global batch size, and all-reduces the
gradients before Adam: the net, its target and the optimizer stay
replicated, bit for bit.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Any, NamedTuple

import torch

from pvderx_torch.dist.mesh import ENV_AXIS, draw_rows
from pvderx_torch.dist.sharding import replicate
from pvderx_torch.dist.tp import shard_nets_tp
from pvderx_torch.learn.env_api import make_env_api, pack_params
from pvderx_torch.learn.nets import QNetwork
from pvderx_torch.learn.replay import (
    Replay, check_shardable, insert_rows, make_replay, sample_owned,
    sample_rows)


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


def make_dqn(env_cfg, dqn: DQNConfig, hidden=(128, 128), dtype=torch.float32,
             mesh=None):
    """Build (init_runner(n_envs, generator), train_step(runner), make_net).

    env_cfg must be discrete: a single-DER `EnvConfig` (the anomaly variant
    of BASELINE config 3 widens the head to N_ACTIONS_ANOM) or an aggregate
    `FleetConfig`. ``dtype`` is the compute dtype; parameters are float32.
    ``train_step(runner) -> (runner, metrics)`` is
    ``train_step.update(*train_step.collect(runner))``, as in `make_ppo`.
    ``mesh``: see the module docstring; `init_runner` takes the global env
    count and, over W > 1 env ranks, needs a capacity that
    ``rollout_len · n_envs`` divides.
    """
    api = make_env_api(env_cfg, mesh)
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
        check_shardable(dqn.capacity, dqn.rollout_len * n_envs, mesh)
        if mesh is not None:
            replicate(generator, mesh)
        net = make_net(generator=generator)
        env_state, obs = api.reset_batch(n_envs, generator)
        net_tgt = copy.deepcopy(net).requires_grad_(False)
        shard_nets_tp(mesh, net, net_tgt)
        cap = dqn.capacity if mesh is None else (
            dqn.capacity // mesh.size(ENV_AXIS))
        return DQNRunner(
            net=net, net_tgt=net_tgt,
            opt=torch.optim.Adam(net.parameters(), lr=dqn.lr, eps=1e-8),
            replay=make_replay(cap, 2 * d + 3, dtype, api.device, n_envs),
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
            dev = greedy.device
            rand = draw_rows(mesh, lambda s: torch.randint(
                0, n_actions, s, generator=gen, device=dev), greedy.shape)
            explore = draw_rows(mesh, lambda s: torch.rand(
                s, generator=gen, dtype=dtype, device=dev),
                greedy.shape) < eps
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
        if mesh is None:
            b = _unpack(sample_rows(rp, runner.generator, dqn.batch_size))
            mean = torch.mean
        else:
            rows, _ = sample_owned(rp, runner.generator, dqn.batch_size, mesh)
            b = _unpack(rows)
            mean = lambda x: x.sum() / dqn.batch_size
        with torch.no_grad():
            q_next_tgt = net_tgt(b.nobs)
            a_next = torch.argmax(net(b.nobs) if dqn.double else q_next_tgt,
                                  dim=-1)
            q_next = q_next_tgt.gather(-1, a_next[:, None])[:, 0]
            target = b.rew + dqn.gamma * (1.0 - b.done) * q_next
        q_a = net(b.obs).gather(-1, b.act[:, None])[:, 0]
        loss = mean(huber_loss(q_a, target))
        params = list(net.parameters())
        grads = torch.autograd.grad(loss, params)
        stats = torch.stack([loss, mean(q_a)]).detach()
        if mesh is not None:
            *grads, stats = mesh.all_reduce_many([*grads, stats])
        for p, g in zip(params, grads):
            p.grad = g
        runner.opt.step()
        return stats

    def update(runner: DQNRunner, rollout):
        """The replay insert, ``n_updates`` TD steps and the target sync."""
        rows, rews, eps = rollout
        rp = insert_rows(runner.replay, rows)
        loss, q_mean = torch.stack([_update_once(runner, rp)
                                    for _ in range(dqn.n_updates)]).mean(0)
        update_i = runner.update_i + 1
        if update_i % dqn.target_every == 0:
            runner.net_tgt.load_state_dict(runner.net.state_dict())
        r_mean, size = rews.mean(), rp.size
        if mesh is not None:
            w = mesh.size(ENV_AXIS)
            r_mean = mesh.all_reduce(rews.sum()) / (rews.numel() * w)
            size = size * w
        metrics = {"loss": loss, "q_mean": q_mean, "epsilon": eps,
                   "reward_mean": r_mean, "buffer_size": size}
        return dataclasses.replace(runner, replay=rp,
                                   update_i=update_i), metrics

    def train_step(runner: DQNRunner):
        return update(*collect(runner))

    train_step.collect, train_step.update = collect, update
    return init_runner, train_step, make_net


__all__ = ["DQNConfig", "DQNRunner", "make_dqn", "huber_loss"]
