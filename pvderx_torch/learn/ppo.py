"""PPO learner: rollout collection, GAE and clipped-PPO epochs.

The port of `pvderx.learn.ppo`. One `train_step` collects ``rollout_len``
batched env steps under the current policy (each one K1 or K2 launch, the
env's window), computes GAE, and runs ``n_epochs`` of ``n_minibatch``
clipped-PPO gradient steps, each a global-norm clip and an Adam step.

What is kept from the reference, on purpose:

- the factored per-unit head of the fleet's per-unit mode: logits
  ``[N, M, A]``, one categorical per unit, the joint log-prob and the
  entropy summed over M (M = 1 keeps the single-head path);
- the packed minibatch shuffle: the per-row fields ride in one
  ``[T·N, obs_dim + M + 4]`` matrix (actions as floats, exact for small
  ints), so each epoch's shuffle is one row gather;
- optax's global-norm clip (unchanged below the norm, else ``g / ‖g‖ ·
  max_norm``; not `clip_grad_norm_`, which adds 1e-6 to the norm and always
  scales), then Adam with eps 1e-8;
- the population std in the advantage normalisation (``correction=0``).

Collection runs under ``torch.no_grad()``: the env's window kernels have no
backward, and nothing of the env step belongs in the graph. Every draw
(init, reset, actions, autoreset events, minibatch permutations) comes from
the runner's ``torch.Generator``, on the env config's device.

Under a ``mesh`` (`pvderx_torch.dist`) each rank collects its own N/W envs
and the update is the one-rank update, made global by hand where GSPMD
made the reference's global:

- every draw is made at the global shape from the replicated generator
  (this rank keeps its rows), and every rank builds the same permutation
  of the global ``T·N`` rows; of each minibatch a rank keeps the rows it
  owns (their number differs between ranks);
- the advantages are normalized over the global minibatch: its mean, then
  the population variance about it, each an all-reduced sum (two passes,
  as ``std`` takes them); every loss term is a local sum over the global
  row count;
- the gradients are all-reduced (SUM, one collective with the loss terms),
  then clipped by the global norm (`dist.tp.global_norm_sq` under tensor
  parallelism) and Adam steps: the same numbers on every rank, so the
  replicas stay bit for bit equal;
- ``reward_mean`` and ``done_frac`` are all-reduced means.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import torch

from pvderx_torch.dist.mesh import ENV_AXIS, draw_rows, owned_rows
from pvderx_torch.dist.sharding import replicate
from pvderx_torch.dist.tp import global_norm_sq, shard_nets_tp
from pvderx_torch.learn.env_api import make_env_api, pack_params
from pvderx_torch.learn.nets import ActorCritic


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    rollout_len: int = 16
    n_epochs: int = 4
    n_minibatch: int = 4


class Transition(NamedTuple):
    """One collected env step of every env (``[N, ...]`` each), or a
    rollout of them stacked on a leading time axis (``[T, N, ...]``)."""

    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


@dataclasses.dataclass
class PPORunner:
    """What the training loop carries. ``net`` and ``opt`` are updated in
    place by `train_step`; the env state, obs and count are replaced."""

    net: ActorCritic
    opt: torch.optim.Adam
    env_state: Any
    obs: torch.Tensor
    p_pack: torch.Tensor
    generator: torch.Generator
    update_i: int = 0


def _categorical(logits: torch.Tensor, generator: torch.Generator,
                 mesh=None):
    """One sample of the last axis's categorical (the Gumbel-max trick, in
    its exponential form: argmax of logits - log E, E ~ Exp(1)); under a
    ``mesh`` E is this rank's rows of the global draw."""
    e = draw_rows(mesh, lambda s: torch.empty(
        s, dtype=logits.dtype, device=logits.device).exponential_(
            generator=generator), logits.shape)
    return torch.argmax(logits - torch.log(e), dim=-1)


def clip_by_global_norm(grads, max_norm: float, norm_sq=None):
    """optax.clip_by_global_norm: the grads unchanged if their global norm is
    below ``max_norm``, else each ``g / norm * max_norm``. ``norm_sq``, the
    squared norm, is computed from ``grads`` when not given."""
    if norm_sq is None:
        norm_sq = sum(torch.sum(g * g) for g in grads)
    norm = torch.sqrt(norm_sq)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


@torch.no_grad()
def gae(reward, value, done, last_v, gamma: float, lam: float):
    """Generalized advantage estimation over a [T, ...] trajectory, a
    reverse loop over T: returns (advantages, returns = advantages +
    values). ``last_v`` is the value of the observation after the last
    step; a done step cuts the bootstrap."""
    g, next_v = torch.zeros_like(last_v), last_v
    adv = [None] * reward.shape[0]
    for t in reversed(range(reward.shape[0])):
        nonterm = 1.0 - done[t]
        delta = reward[t] + gamma * next_v * nonterm - value[t]
        g = delta + gamma * lam * nonterm * g
        adv[t], next_v = g, value[t]
    adv = torch.stack(adv)
    return adv, adv + value


def make_ppo(env_cfg, ppo: PPOConfig, hidden=(128, 128), dtype=torch.float32,
             mesh=None):
    """Build (init_runner(n_envs, generator), train_step(runner), make_net).

    env_cfg: a single-DER `EnvConfig` (BASELINE configs 1-4, the 6-action
    anomaly variant of config 3 included) or a `FleetConfig` (config 5,
    aggregate or per-unit), dispatched through `learn.env_api`. Discrete
    actions only: SAC takes the continuous extension. ``dtype`` is the
    net's compute dtype; its parameters are float32.

    ``make_net(generator=...)`` builds a fresh `ActorCritic` of this
    learner; `init_runner` draws the runner's own from its generator.
    ``train_step(runner) -> (runner, metrics)``, metrics 0-d tensors. Its
    two phases are ``train_step.collect(runner) -> (runner, rollout)`` and
    ``train_step.update(runner, rollout) -> (runner, metrics)``, for a
    caller that times them apart.

    ``mesh``: `init_runner` takes the global env count, replicates the
    generator from rank 0 before its first draw, and holds this rank's
    rows of the env batch; `train_step` is the global update of the module
    docstring. On a mesh with a ``"model"`` axis (`dist.make_mesh_2d`) the
    net is tensor-parallel: `init_runner` shards it, and a whole runner is
    placed by `pvderx_torch.dist.shard_runner_tp`.
    """
    api = make_env_api(env_cfg, mesh)
    if api.n_actions == 0:
        raise ValueError("PPO here is discrete-action; got a continuous env "
                         "config (use pvderx_torch.learn.sac for Box actions)")
    M, A = api.n_units, api.n_actions
    make_net = functools.partial(ActorCritic, api.obs_dim, A * M, hidden, dtype)

    def _draw(logits, generator):
        # un-meshed, `_categorical` is called as (logits, generator) only: a
        # caller may stand a two-argument sampler in for it (the reference
        # twin in tests/test_torch_learn_ppo.py takes out the randomness so)
        if mesh is None:
            return _categorical(logits, generator)
        return _categorical(logits, generator, mesh)

    def _sample(logits, generator):
        """Actions and their joint log-prob from the (factored) head."""
        if M == 1:
            a = _draw(logits, generator)
            logp = torch.log_softmax(logits, -1).gather(-1, a[:, None])[:, 0]
            return a, logp
        lg = logits.reshape(logits.shape[0], M, A)
        a = _draw(lg, generator)                              # [N, M]
        lp = torch.log_softmax(lg, -1)
        return a, lp.gather(-1, a[..., None])[..., 0].sum(-1)

    def _logp_entropy(logits, action):
        """Joint log-prob of ``action`` and the entropy (summed over units)."""
        if M == 1:
            lp = torch.log_softmax(logits, -1)
            logp = lp.gather(-1, action[:, None])[:, 0]
            return logp, -(torch.exp(lp) * lp).sum(-1)
        lp = torch.log_softmax(logits.reshape(logits.shape[0], M, A), -1)
        logp = lp.gather(-1, action[..., None])[..., 0]
        return logp.sum(-1), (-(torch.exp(lp) * lp).sum(-1)).sum(-1)

    def init_runner(n_envs: int, generator: torch.Generator) -> PPORunner:
        if mesh is not None:
            replicate(generator, mesh)
        net = make_net(generator=generator)
        shard_nets_tp(mesh, net)
        opt = torch.optim.Adam(net.parameters(), lr=ppo.lr, eps=1e-8)
        env_state, obs = api.reset_batch(n_envs, generator)
        return PPORunner(net=net, opt=opt, env_state=env_state, obs=obs,
                         p_pack=pack_params(env_state), generator=generator)

    @torch.no_grad()
    def collect(runner: PPORunner):
        """``rollout_len`` env steps under the current policy: (the runner
        at the new env state, (trajectory, value of the last obs)), the
        trajectory a `Transition` of [T, N, ...] tensors."""
        net, gen = runner.net, runner.generator
        st, ob = runner.env_state, runner.obs
        steps = []
        for _ in range(ppo.rollout_len):
            logits, v = net(ob)
            a, logp = _sample(logits, gen)
            st, ob2, r, d, _ = api.step(st, a, gen, runner.p_pack)
            steps.append(Transition(ob, a, logp, v, r.to(dtype), d.to(dtype)))
            ob = ob2
        _, last_v = net(ob)
        traj = Transition(*map(torch.stack, zip(*steps)))
        return dataclasses.replace(runner, env_state=st, obs=ob), (traj,
                                                                   last_v)

    def _loss(net, obs, action, old_logp, old_v, adv, ret, count=None):
        """The clipped-PPO loss terms. ``count``: the global minibatch size
        under a mesh (each mean a local sum over it, the advantages
        normalized over the global minibatch)."""
        logits, v = net(obs)
        logp, ent = _logp_entropy(logits, action)
        ratio = torch.exp(logp - old_logp)
        if count is None:
            mean = torch.mean
            adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        else:
            mean = lambda x: x.sum() / count
            mu = mesh.all_reduce(adv.sum()) / count
            sd = torch.sqrt(mesh.all_reduce(((adv - mu) ** 2).sum()) / count)
            adv_n = (adv - mu) / (sd + 1e-8)
        pg1 = ratio * adv_n
        pg2 = torch.clamp(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps) * adv_n
        pg_loss = -mean(torch.minimum(pg1, pg2))
        v_clip = old_v + torch.clamp(v - old_v, -ppo.clip_eps, ppo.clip_eps)
        v_loss = 0.5 * mean(torch.maximum((v - ret) ** 2, (v_clip - ret) ** 2))
        entropy = mean(ent)
        loss = pg_loss + ppo.vf_coef * v_loss - ppo.ent_coef * entropy
        return loss, pg_loss, v_loss, entropy

    def _pack(traj, adv, ret):
        """The six per-row fields as one [T·N, obs_dim + M + 4] matrix in
        the promoted dtype of obs and the compute dtype."""
        rows = traj.reward.numel()
        mdt = torch.promote_types(traj.obs.dtype, dtype)
        cols = (traj.obs.reshape(rows, -1),
                traj.action.reshape(rows, M).to(dtype),
                traj.logp.reshape(rows, 1), traj.value.reshape(rows, 1),
                adv.reshape(rows, 1), ret.reshape(rows, 1))
        return torch.cat([c.to(mdt) for c in cols], dim=1)

    def _minibatches(mat, gen, n_global):
        """An epoch's minibatches of (this rank's rows of) the packed
        rollout, with the global minibatch size (None without a mesh)."""
        rows = mat.shape[0] if mesh is None else (
            mat.shape[0] * mesh.size(ENV_AXIS))
        perm = torch.randperm(rows, generator=gen, device=mat.device)
        if mesh is None:
            for mb in mat[perm].reshape(ppo.n_minibatch, -1, mat.shape[1]):
                yield mb, None
            return
        for ids in perm.reshape(ppo.n_minibatch, -1):
            _, local = owned_rows(ids, n_global, mesh)
            yield mat[local], ids.shape[0]

    def _epochs(runner: PPORunner, mat, n_global):
        net, opt, gen = runner.net, runner.opt, runner.generator
        params = list(net.parameters())
        d = api.obs_dim
        out = []
        for _ in range(ppo.n_epochs):
            for mb, count in _minibatches(mat, gen, n_global):
                act = (mb[:, d] if M == 1 else mb[:, d:d + M]).long()
                terms = torch.stack(_loss(net, mb[:, :d], act,
                                          *mb[:, d + M:].unbind(1), count))
                grads = torch.autograd.grad(terms[0], params)
                norm_sq = None
                if mesh is not None:
                    *grads, terms = mesh.all_reduce_many(
                        [*grads, terms.detach()])
                    norm_sq = global_norm_sq(grads, params, mesh)
                for p, g in zip(params, clip_by_global_norm(
                        grads, ppo.max_grad_norm, norm_sq)):
                    p.grad = g
                opt.step()
                out.append(terms.detach())
        return torch.stack(out).mean(0)

    def update(runner: PPORunner, rollout):
        """GAE and the clipped-PPO epochs on one collected rollout."""
        traj, last_v = rollout
        adv, ret = gae(traj.reward, traj.value, traj.done, last_v,
                       ppo.gamma, ppo.lam)
        n = traj.reward.shape[1]
        n_global = n if mesh is None else n * mesh.size(ENV_AXIS)
        loss, pg, vl, ent = _epochs(runner, _pack(traj, adv, ret), n_global)
        if mesh is None:
            r_mean, d_frac = traj.reward.mean(), traj.done.mean()
        else:
            rows = traj.reward.shape[0] * n_global
            r_mean, d_frac = mesh.all_reduce(torch.stack(
                [traj.reward.sum(), traj.done.sum()])) / rows
        metrics = {
            "loss": loss, "pg_loss": pg, "v_loss": vl, "entropy": ent,
            "reward_mean": r_mean, "done_frac": d_frac,
        }
        return dataclasses.replace(runner,
                                   update_i=runner.update_i + 1), metrics

    def train_step(runner: PPORunner):
        return update(*collect(runner))

    train_step.collect, train_step.update = collect, update
    return init_runner, train_step, make_net


__all__ = ["PPOConfig", "PPORunner", "Transition", "make_ppo",
           "clip_by_global_norm", "gae"]
