"""The frozen plain reference of the PPO update: what the program's
`pvderx_torch/learn/ppo.py` computes on one collected rollout (GAE, the
packed minibatches, the clipped PPO loss, optax's global-norm clip, Adam),
restated in plain torch, single process, for the configuration's discrete
single-DER env and its tanh MLP actor-critic. The parameters are a dict of
tensors by the program's names; every tensor is in the dtype the caller
gives (float64 for the reference, bfloat16 for the control).
"""
from __future__ import annotations

import math

import torch

LAYERS = ("trunk.0", "trunk.1", "logits", "value")


def forward(params: dict, obs):
    """(logits [.., A], value [..]) of the tanh MLP."""
    h = obs.to(params["trunk.0.weight"].dtype)
    for name in LAYERS[:2]:
        h = torch.tanh(h @ params[f"{name}.weight"].T + params[f"{name}.bias"])
    logits = h @ params["logits.weight"].T + params["logits.bias"]
    value = (h @ params["value.weight"].T + params["value.bias"])[..., 0]
    return logits, value


def logp_entropy(logits, action):
    lp = torch.log_softmax(logits, -1)
    return (lp.gather(-1, action[..., None])[..., 0],
            -(torch.exp(lp) * lp).sum(-1))


def gae(reward, value, done, last_v, gamma: float, lam: float):
    """Advantages and returns over a [T, N] rollout (a reverse loop)."""
    g, next_v = torch.zeros_like(last_v), last_v
    adv = [None] * reward.shape[0]
    for t in reversed(range(reward.shape[0])):
        nonterm = 1.0 - done[t]
        delta = reward[t] + gamma * next_v * nonterm - value[t]
        g = delta + gamma * lam * nonterm * g
        adv[t], next_v = g, value[t]
    adv = torch.stack(adv)
    return adv, adv + value


def loss(params, hp: dict, obs, action, old_logp, old_v, adv, ret):
    """The clipped PPO loss of one minibatch."""
    logits, v = forward(params, obs)
    logp, ent = logp_entropy(logits, action)
    ratio = torch.exp(logp - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    eps = hp["clip_eps"]
    pg = -torch.minimum(ratio * adv_n,
                        torch.clamp(ratio, 1 - eps, 1 + eps) * adv_n).mean()
    v_clip = old_v + torch.clamp(v - old_v, -eps, eps)
    v_loss = 0.5 * torch.maximum((v - ret) ** 2, (v_clip - ret) ** 2).mean()
    return pg + hp["vf_coef"] * v_loss - hp["ent_coef"] * ent.mean()


class Adam:
    """torch's Adam (no weight decay, no amsgrad), written out. ``state``:
    (first moments, second moments, steps taken) to start from, each
    moment a dict of tensors by the parameters' names; a name it lacks
    starts at zero."""

    def __init__(self, params: dict, lr: float, eps: float = 1e-8,
                 betas=(0.9, 0.999), state=None):
        m, v, t = state if state is not None else ({}, {}, 0)
        self.lr, self.eps, self.betas, self.t = lr, eps, betas, int(t)
        self.m = {k: m[k].to(x) if k in m else torch.zeros_like(x)
                  for k, x in params.items()}
        self.v = {k: v[k].to(x) if k in v else torch.zeros_like(x)
                  for k, x in params.items()}

    def step(self, params: dict, grads: dict):
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k in params:
            self.m[k] = b1 * self.m[k] + (1 - b1) * grads[k]
            self.v[k] = b2 * self.v[k] + (1 - b2) * grads[k] * grads[k]
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            params[k] = params[k] - (self.lr / c1) * self.m[k] / denom


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = norm < max_norm
    return {k: torch.where(keep, g, g / norm * max_norm)
            for k, g in grads.items()}


def update(params: dict, opt: Adam, hp: dict, traj: dict, perms):
    """One PPO update on a collected rollout ``traj`` (obs [T, N, D],
    action [T, N], reward, done [T, N], last_obs [N, D]) with the epochs'
    row permutations ``perms``: returns (params, mean loss, the clipped
    gradients of the first minibatch). Old log-probs and values are this
    reference's own, at ``params`` as they come in."""
    with torch.no_grad():
        logits, value = forward(params, traj["obs"])
        old_logp, _ = logp_entropy(logits, traj["action"])
        _, last_v = forward(params, traj["last_obs"])
    dt = value.dtype
    adv, ret = gae(traj["reward"].to(dt), value, traj["done"].to(dt), last_v,
                   hp["gamma"], hp["lam"])
    rows = adv.numel()
    cols = {"obs": traj["obs"].reshape(rows, -1).to(dt),
            "action": traj["action"].reshape(rows),
            "old_logp": old_logp.reshape(rows), "old_v": value.reshape(rows),
            "adv": adv.reshape(rows), "ret": ret.reshape(rows)}
    losses, first = [], None
    for perm in perms:
        for ids in perm.reshape(hp["n_minibatch"], -1):
            mb = {k: v[ids] for k, v in cols.items()}
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            lv = loss(leaves, hp, **mb)
            g = torch.autograd.grad(lv, list(leaves.values()))
            grads = clip_by_global_norm(dict(zip(leaves, g)),
                                        hp["max_grad_norm"])
            if first is None:
                first = grads
            opt.step(params, grads)
            losses.append(lv.detach())
    return params, torch.stack(losses).mean(), first
