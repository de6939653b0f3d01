"""Trained-policy export for deployment: a numpy-only inference path.

The port of `pvderx.learn.export`, with its own copy of `NumpyMLPPolicy`
(the port imports nothing of `pvderx`). A controller trained here runs
inside an inverter controller or a SCADA/EMS host, where torch is not a
deployable dependency: the export flattens a net's `Linear` layers into
numpy arrays and evaluates the policy with numpy alone. The JSON artifact
has the reference's format, so either package's `NumpyMLPPolicy.from_json`
reads the other's.

A torch ``Linear.weight`` is ``[out, in]``; the exported kernel is the
reference's ``[in, out]``, its transpose. The numpy forward reproduces the
net's float32 forward to float32 roundoff.
"""
from __future__ import annotations

import json

import numpy as np

_ACTIVATIONS = {"tanh": np.tanh, "relu": lambda x: np.maximum(x, 0.0)}


class NumpyMLPPolicy:
    """Stacked Dense trunk + one or more linear heads, numpy-only."""

    def __init__(self, trunk, heads, activation: str):
        self.trunk = [(np.asarray(k, np.float32), np.asarray(b, np.float32))
                      for k, b in trunk]
        self.heads = {name: (np.asarray(k, np.float32),
                             np.asarray(b, np.float32))
                      for name, (k, b) in heads.items()}
        self.activation = activation
        self._act = _ACTIVATIONS[activation]

    def features(self, obs: np.ndarray) -> np.ndarray:
        h = np.asarray(obs, np.float32)
        for k, b in self.trunk:
            h = self._act(h @ k + b)
        return h

    def head(self, name: str, obs: np.ndarray) -> np.ndarray:
        k, b = self.heads[name]
        return self.features(obs) @ k + b

    def act(self, obs: np.ndarray) -> np.ndarray:
        """Deterministic action: argmax over the discrete head, or tanh(mu)
        for the continuous head."""
        if "logits" in self.heads:
            return np.argmax(self.head("logits", obs), axis=-1)
        if "q" in self.heads:
            return np.argmax(self.head("q", obs), axis=-1)
        return np.tanh(self.head("mu", obs))

    def to_json(self) -> str:
        return json.dumps({
            "activation": self.activation,
            "trunk": [[k.tolist(), b.tolist()] for k, b in self.trunk],
            "heads": {n: [k.tolist(), b.tolist()]
                      for n, (k, b) in self.heads.items()},
        })

    @classmethod
    def from_json(cls, s: str) -> "NumpyMLPPolicy":
        d = json.loads(s)
        return cls([(np.asarray(k), np.asarray(b)) for k, b in d["trunk"]],
                   {n: (np.asarray(kb[0]), np.asarray(kb[1]))
                    for n, kb in d["heads"].items()},
                   d["activation"])


def _kernel_bias(lin):
    """A `Linear` as the reference's (kernel [in, out], bias) in numpy."""
    return (lin.weight.detach().cpu().numpy().T,
            lin.bias.detach().cpu().numpy())


def export_actor_critic(net) -> NumpyMLPPolicy:
    """PPO `ActorCritic` -> numpy policy (heads: logits, value)."""
    return NumpyMLPPolicy([_kernel_bias(lin) for lin in net.trunk],
                          {"logits": _kernel_bias(net.logits),
                           "value": _kernel_bias(net.value)}, "tanh")


def export_qnetwork(net) -> NumpyMLPPolicy:
    """DQN `QNetwork` -> numpy policy (head: q)."""
    return NumpyMLPPolicy([_kernel_bias(lin) for lin in net.trunk],
                          {"q": _kernel_bias(net.q)}, "relu")


def export_tanh_gaussian(net) -> NumpyMLPPolicy:
    """SAC `TanhGaussianActor` -> numpy policy (heads: mu, log_std); act()
    returns the deterministic tanh(mu) action."""
    return NumpyMLPPolicy([_kernel_bias(lin) for lin in net.trunk],
                          {"mu": _kernel_bias(net.mu),
                           "log_std": _kernel_bias(net.log_std)}, "relu")


__all__ = ["NumpyMLPPolicy", "export_actor_critic", "export_qnetwork",
           "export_tanh_gaussian"]
