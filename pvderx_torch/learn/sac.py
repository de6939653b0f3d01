"""SAC learner for the continuous-action env.

The port of `pvderx.learn.sac`. One `train_step` collects ``rollout_len``
batched env steps under the squashed-Gaussian policy (each one K1 launch:
the continuous actions reach the env's window as setpoint nudges), writes
them to the packed replay, and runs ``n_updates`` updates, each in the
reference's order:

1. the critic step on the clipped double-Q target of the target critics;
2. the actor loss through the *updated* critic, its gradient taken for the
   actor's parameters only (the critic's are left untouched);
3. the temperature loss on the actor's log-prob, held fixed;
4. the Polyak update of the target critics.

Three Adam states: actor, critic and the scalar ``log_alpha`` (kept in the
compute dtype, as the reference keeps it). ``softplus`` is written as
``logaddexp(x, 0)``, as `jax.nn.softplus` is: `F.softplus` returns x for
x > 20. Replay row layout: ``[obs (D) | act (A) | rew | done | nobs (D)]``.
Every draw comes from the runner's ``torch.Generator``.

Under a ``mesh`` (`pvderx_torch.dist`), as in `learn.dqn`: each rank steps
and stores its own envs, draws every noise at the global shape (keeping
its envs' rows, or its samples' rows of the global batch), takes each loss
as a local sum over the global batch size, and all-reduces each of the
three gradients before its Adam step (the critic's with the critic loss,
the actor's with the actor loss and the entropy); the nets, the target
critics, ``log_alpha`` and the three optimizers stay replicated.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Any, NamedTuple

import torch

from pvderx_torch.dist.mesh import ENV_AXIS, draw_rows
from pvderx_torch.dist.sharding import replicate
from pvderx_torch.dist.tp import shard_nets_tp
from pvderx_torch.env.core import ACT_DIM_CONT
from pvderx_torch.learn.env_api import make_env_api, pack_params
from pvderx_torch.learn.nets import DoubleCritic, TanhGaussianActor
from pvderx_torch.learn.replay import (
    Replay, check_shardable, insert_rows, make_replay, sample_owned,
    sample_rows)


@dataclasses.dataclass(frozen=True)
class SACConfig:
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005          # Polyak rate of the target critics
    init_alpha: float = 0.1
    target_entropy: float = -float(ACT_DIM_CONT)
    rollout_len: int = 8        # env steps collected per train_step
    n_updates: int = 8          # gradient steps per train_step
    batch_size: int = 256
    capacity: int = 65536       # replay slots


class Batch(NamedTuple):
    obs: torch.Tensor
    act: torch.Tensor
    rew: torch.Tensor
    nobs: torch.Tensor
    done: torch.Tensor


@dataclasses.dataclass
class SACRunner:
    """The nets, their optimizers, ``log_alpha`` and the replay's data are
    updated in place by `train_step`; the rest is replaced."""

    actor: TanhGaussianActor
    critic: DoubleCritic
    critic_tgt: DoubleCritic
    log_alpha: torch.Tensor
    opt_actor: torch.optim.Adam
    opt_critic: torch.optim.Adam
    opt_alpha: torch.optim.Adam
    replay: Replay
    env_state: Any
    obs: torch.Tensor
    p_pack: torch.Tensor
    generator: torch.Generator
    update_i: int = 0


def _noise(like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Standard normal draws shaped like ``like``."""
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _squash(mu, log_std, generator, pick=None):
    """A tanh-squashed Gaussian action and its log-prob. ``pick(draw)``,
    under a mesh, returns this rank's rows of a global draw
    (``draw(shape)``) in place of `_noise`."""
    std = torch.exp(log_std)
    eps = _noise(mu, generator) if pick is None else pick(
        lambda s: torch.randn(s, generator=generator, dtype=mu.dtype,
                              device=mu.device))
    pre = mu + std * eps
    act = torch.tanh(pre)
    logp = (-0.5 * (eps ** 2) - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)
    softplus = torch.logaddexp(-2.0 * pre, torch.zeros_like(pre))
    logp = logp - (2.0 * (math.log(2.0) - pre - softplus)).sum(-1)
    return act, logp


def _adam_step(opt, params, loss, mesh=None, stats=()):
    """One Adam step on the gradient of ``loss`` for ``params`` alone;
    under a mesh the gradient is all-reduced first, in one collective with
    ``stats`` (returned all-reduced)."""
    grads = torch.autograd.grad(loss, params)
    if mesh is not None:
        out = mesh.all_reduce_many([*grads, *stats])
        grads, stats = out[:len(grads)], tuple(out[len(grads):])
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    return stats


def make_sac(env_cfg, sac: SACConfig, hidden=(128, 128), dtype=torch.float32,
             mesh=None):
    """Build (init_runner(n_envs, generator), train_step(runner),
    (make_actor, make_critic)). env_cfg must have continuous=True (the
    single-DER env; the fleet's action space is discrete).
    ``train_step(runner) -> (runner, metrics)`` is
    ``train_step.update(*train_step.collect(runner))``, as in `make_ppo`.
    ``mesh``: see the module docstring and `make_dqn`'s."""
    api = make_env_api(env_cfg, mesh)
    if api.n_units > 1:
        raise ValueError(
            "per-unit fleet control (FleetConfig(per_unit=True)) is "
            "PPO-only: SAC has no factored-action head; use "
            "pvderx_torch.learn.make_ppo, or the aggregate fleet mode")
    if api.act_dim == 0:
        raise ValueError("SAC requires make_env_config(..., continuous=True)")
    d, a_dim = api.obs_dim, api.act_dim
    make_actor = functools.partial(TanhGaussianActor, d, a_dim, hidden, dtype)
    make_critic = functools.partial(DoubleCritic, d, a_dim, hidden, dtype)
    adam = functools.partial(torch.optim.Adam, lr=sac.lr, eps=1e-8)

    def init_runner(n_envs: int, generator: torch.Generator) -> SACRunner:
        check_shardable(sac.capacity, sac.rollout_len * n_envs, mesh)
        if mesh is not None:
            replicate(generator, mesh)
        actor = make_actor(generator=generator)
        critic = make_critic(generator=generator)
        env_state, obs = api.reset_batch(n_envs, generator)
        log_alpha = torch.tensor(math.log(sac.init_alpha), dtype=dtype,
                                 device=api.device, requires_grad=True)
        critic_tgt = copy.deepcopy(critic).requires_grad_(False)
        shard_nets_tp(mesh, actor, critic, critic_tgt)
        return SACRunner(
            actor=actor, critic=critic, critic_tgt=critic_tgt,
            log_alpha=log_alpha, opt_actor=adam(actor.parameters()),
            opt_critic=adam(critic.parameters()), opt_alpha=adam([log_alpha]),
            replay=make_replay(
                sac.capacity if mesh is None
                else sac.capacity // mesh.size(ENV_AXIS),
                2 * d + a_dim + 2, dtype, api.device, n_envs),
            env_state=env_state, obs=obs, p_pack=pack_params(env_state),
            generator=generator)

    @torch.no_grad()
    def collect(runner: SACRunner):
        """``rollout_len`` env steps under the sampled policy: (the runner
        at the new env state, (packed rows, rewards [T, N]))."""
        gen, st, ob = runner.generator, runner.env_state, runner.obs
        rows, rews = [], []
        pick = None if mesh is None else (
            lambda draw: draw_rows(mesh, draw, (ob.shape[0], a_dim)))
        for _ in range(sac.rollout_len):
            a, _ = _squash(*runner.actor(ob), gen, pick)
            st, ob2, r, done, _ = api.step(st, a, gen, runner.p_pack)
            r = r.to(dtype)
            rows.append(torch.cat([ob.to(dtype), a, r[:, None],
                                   done[:, None].to(dtype), ob2.to(dtype)],
                                  dim=1))
            rews.append(r)
            ob = ob2
        return dataclasses.replace(runner, env_state=st, obs=ob), (
            torch.cat(rows), torch.stack(rews))

    def _unpack(mat) -> Batch:
        return Batch(obs=mat[:, :d], act=mat[:, d:d + a_dim],
                     rew=mat[:, d + a_dim], done=mat[:, d + a_dim + 1],
                     nobs=mat[:, d + a_dim + 2:])

    def _update_once(r: SACRunner, rp: Replay):
        gen, bs = r.generator, sac.batch_size
        if mesh is None:
            b = _unpack(sample_rows(rp, gen, bs))
            mean, pick = torch.mean, None
        else:
            rows, mask = sample_owned(rp, gen, bs, mesh)
            b = _unpack(rows)
            mean = lambda x: x.sum() / bs
            pick = lambda draw: draw((bs, a_dim))[mask]
        alpha = torch.exp(r.log_alpha.detach())
        with torch.no_grad():
            a_n, logp_n = _squash(*r.actor(b.nobs), gen, pick)
            q1_t, q2_t = r.critic_tgt(b.nobs, a_n)
            target = b.rew + sac.gamma * (1.0 - b.done) * (
                torch.minimum(q1_t, q2_t) - alpha * logp_n)

        q1, q2 = r.critic(b.obs, b.act)
        cl = mean((q1 - target) ** 2 + (q2 - target) ** 2)
        (cl,) = _adam_step(r.opt_critic, list(r.critic.parameters()), cl,
                           mesh, (cl.detach(),))

        a, logp = _squash(*r.actor(b.obs), gen, pick)
        q1, q2 = r.critic(b.obs, a)
        al = mean(alpha * logp - torch.minimum(q1, q2))
        al, ent = _adam_step(r.opt_actor, list(r.actor.parameters()), al,
                             mesh, (al.detach(), -mean(logp.detach())))

        alpha_loss = -mean(torch.exp(r.log_alpha)
                           * (logp.detach() + sac.target_entropy))
        _adam_step(r.opt_alpha, [r.log_alpha], alpha_loss, mesh)

        with torch.no_grad():
            for t, o in zip(r.critic_tgt.parameters(), r.critic.parameters()):
                t.copy_((1.0 - sac.tau) * t + sac.tau * o)
        return torch.stack([cl, al, ent]).detach()

    def update(runner: SACRunner, rollout):
        """The replay insert and ``n_updates`` updates."""
        rows, rews = rollout
        rp = insert_rows(runner.replay, rows)
        cl, al, ent = torch.stack([_update_once(runner, rp)
                                   for _ in range(sac.n_updates)]).mean(0)
        r_mean, size = rews.mean(), rp.size
        if mesh is not None:
            w = mesh.size(ENV_AXIS)
            r_mean = mesh.all_reduce(rews.sum()) / (rews.numel() * w)
            size = size * w
        metrics = {"critic_loss": cl, "actor_loss": al, "entropy": ent,
                   "alpha": torch.exp(runner.log_alpha.detach()),
                   "reward_mean": r_mean, "buffer_size": size}
        return dataclasses.replace(runner, replay=rp,
                                   update_i=runner.update_i + 1), metrics

    def train_step(runner: SACRunner):
        return update(*collect(runner))

    train_step.collect, train_step.update = collect, update
    return init_runner, train_step, (make_actor, make_critic)


__all__ = ["SACConfig", "SACRunner", "make_sac"]
