"""Policy and value networks of the learners, as `nn.Module`s over `nn.Linear`.

The port of `pvderx.learn.nets`: the same four MLPs with the same init.

- Weights are orthogonal, with gain √2 on the hidden layers and 0.01
  (logits, mu, log_std) or 1.0 (value, q) on the heads; biases are zero, as
  Flax's are (torch's default `Linear` init is neither).
- Parameters are float32, and the forward pass computes in ``dtype``: each
  layer casts its input, weight and bias to ``dtype``, as Flax's ``Dense``
  does with ``dtype`` (the compute type) beside ``param_dtype`` (float32).
  Gradients flow back through the casts as float32, so the optimizer
  updates float32 parameters whatever ``dtype`` is.
- The layers are `Linear` modules named in Flax's call order (the order of
  ``Dense_0..n``): `pvderx_torch.convert` carries Flax parameters over by
  that order, and `pvderx_torch.learn.export` exports by it.

A torch ``Linear.weight`` is ``[out, in]``; a Flax kernel is ``[in, out]``.
Every random draw of the init takes the caller's ``torch.Generator``, and
the parameters are made on that generator's device.

Tensor parallelism: `pvderx_torch.dist.tp.shard_params_tp` shards a net's
layers in place and gives each `Linear` a ``tp`` plan; a layer with one
runs its column- or row-parallel forward (`dist.tp.TPPlan.linear`). Each
net names, by `layer_inputs`, the layer that feeds each of its layers, from
which the plan knows whether a layer's input arrives sharded.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0
GAIN_HIDDEN = math.sqrt(2.0)


def orthogonal(out_f: int, in_f: int, gain: float,
               generator: torch.Generator) -> torch.Tensor:
    """A float32 ``[out_f, in_f]`` matrix with orthonormal rows or columns
    (whichever are fewer), times ``gain``: the QR of a Gaussian matrix, its
    columns' signs fixed by R's diagonal (the rule of Flax's and torch's
    orthogonal initializers)."""
    big, small = max(out_f, in_f), min(out_f, in_f)
    a = torch.randn(big, small, generator=generator, dtype=torch.float32,
                    device=generator.device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return gain * (q.T if out_f < in_f else q)


def dense(in_f: int, out_f: int, gain: float,
          generator: torch.Generator) -> nn.Linear:
    """A float32 `Linear` on ``generator``'s device, with orthogonal weight
    and zero bias (no default init runs: it would draw from torch's global
    generator)."""
    lin = nn.utils.skip_init(nn.Linear, in_f, out_f, device=generator.device)
    with torch.no_grad():
        lin.weight.copy_(orthogonal(out_f, in_f, gain, generator))
        lin.bias.zero_()
    return lin


def _apply(lin: nn.Linear, h: torch.Tensor, dtype) -> torch.Tensor:
    """``h @ W.T + b`` computed in ``dtype`` (the float32 parameters cast),
    through the layer's tensor-parallel plan when it has one."""
    w, b = lin.weight.to(dtype), lin.bias.to(dtype)
    tp = getattr(lin, "tp", None)
    return F.linear(h, w, b) if tp is None else tp.linear(h, w, b)


def _trunk(in_f, hidden, generator) -> nn.ModuleList:
    widths = (in_f,) + tuple(hidden)
    return nn.ModuleList(dense(a, b, GAIN_HIDDEN, generator)
                         for a, b in zip(widths[:-1], widths[1:]))


class _MLP(nn.Module):
    """A trunk of hidden layers with one activation, computing in ``dtype``."""

    activation = staticmethod(torch.relu)

    def __init__(self, in_f, hidden, dtype, generator):
        super().__init__()
        self.dtype = dtype
        self.trunk = _trunk(in_f, hidden, generator)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        for lin in self.trunk:
            h = self.activation(_apply(lin, h, self.dtype))
        return h

    def head(self, lin: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        return _apply(lin, h, self.dtype)

    def layer_inputs(self) -> list:
        """For each layer of `layers`, the index of the layer that feeds it
        (-1: the net's input): the trunk is a chain, every head reads the
        trunk's last layer."""
        k = len(self.trunk)
        return [i - 1 for i in range(k)] + [k - 1] * (len(self.layers()) - k)


class ActorCritic(_MLP):
    """PPO's tanh MLP: ``x -> (logits [.., n_actions], value [..])``."""

    activation = staticmethod(torch.tanh)

    def __init__(self, obs_dim: int, n_actions: int, hidden=(128, 128),
                 dtype=torch.float32, *, generator: torch.Generator):
        super().__init__(obs_dim, hidden, dtype, generator)
        self.logits = dense(hidden[-1], n_actions, 0.01, generator)
        self.value = dense(hidden[-1], 1, 1.0, generator)

    def layers(self):
        return [*self.trunk, self.logits, self.value]

    def forward(self, x):
        h = self.features(x)
        return self.head(self.logits, h), self.head(self.value, h)[..., 0]


class QNetwork(_MLP):
    """DQN's relu MLP: ``x -> q [.., n_actions]``."""

    def __init__(self, obs_dim: int, n_actions: int, hidden=(128, 128),
                 dtype=torch.float32, *, generator: torch.Generator):
        super().__init__(obs_dim, hidden, dtype, generator)
        self.q = dense(hidden[-1], n_actions, 1.0, generator)

    def layers(self):
        return [*self.trunk, self.q]

    def forward(self, x):
        return self.head(self.q, self.features(x))


class TanhGaussianActor(_MLP):
    """SAC's squashed-Gaussian policy: ``x -> (mu, log_std)``, log_std
    clipped to [LOG_STD_MIN, LOG_STD_MAX]."""

    def __init__(self, obs_dim: int, act_dim: int, hidden=(128, 128),
                 dtype=torch.float32, *, generator: torch.Generator):
        super().__init__(obs_dim, hidden, dtype, generator)
        self.mu = dense(hidden[-1], act_dim, 0.01, generator)
        self.log_std = dense(hidden[-1], act_dim, 0.01, generator)

    def layers(self):
        return [*self.trunk, self.mu, self.log_std]

    def forward(self, x):
        h = self.features(x)
        log_std = torch.clamp(self.head(self.log_std, h), LOG_STD_MIN,
                              LOG_STD_MAX)
        return self.head(self.mu, h), log_std


class DoubleCritic(nn.Module):
    """Twin relu Q networks on ``concat(obs, act)``: ``-> (q1, q2)``, each
    its own trunk and head (``q1`` then ``q2`` in Flax's call order)."""

    def __init__(self, obs_dim: int, act_dim: int, hidden=(128, 128),
                 dtype=torch.float32, *, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.q1 = self._twin(obs_dim + act_dim, hidden, generator)
        self.q2 = self._twin(obs_dim + act_dim, hidden, generator)

    @staticmethod
    def _twin(in_f, hidden, generator) -> nn.ModuleList:
        trunk = _trunk(in_f, hidden, generator)
        trunk.append(dense(hidden[-1], 1, 1.0, generator))
        return trunk

    def layers(self):
        return [*self.q1, *self.q2]

    def layer_inputs(self) -> list:
        """Each twin a chain of its own (see `_MLP.layer_inputs`)."""
        k = len(self.q1)
        return [i - 1 for i in range(k)] + [k + i - 1 if i else -1
                                            for i in range(k)]

    def _q(self, twin: nn.ModuleList, x):
        h = x
        for lin in twin[:-1]:
            h = torch.relu(_apply(lin, h, self.dtype))
        return _apply(twin[-1], h, self.dtype)[..., 0]

    def forward(self, obs, act):
        x = torch.cat([obs.to(self.dtype), act.to(self.dtype)], dim=-1)
        return self._q(self.q1, x), self._q(self.q2, x)


__all__ = ["ActorCritic", "QNetwork", "TanhGaussianActor", "DoubleCritic",
           "LOG_STD_MIN", "LOG_STD_MAX"]
