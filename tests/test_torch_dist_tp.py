"""Tensor parallelism (`pvderx_torch.dist.tp`) against the reference's
partition rules and against the port's DP-only step.

- `param_partition_specs` puts every layer of `ActorCritic`, `QNetwork`,
  `TanhGaussianActor` and `DoubleCritic` where
  `pvderx.dist.tp.param_partition_specs` puts the Flax tree that
  `pvderx_torch.convert` maps onto it (layer i <-> ``Dense_i``, a torch
  weight the transpose of a Flax kernel), at n_model 2 and 4; in this
  process, no ranks.
- On gloo ranks of the CPU (`tests/torch_dist_cases.py`), with
  `tests/test_tp.py`'s setup (PPO, rollout 4, one epoch of two
  minibatches, hidden 128², 16 envs): one train step on the (env=1,
  model=2) and (env=2, model=2) meshes from `shard_runner_tp` of a
  one-rank runner equals the one-rank DP-only step, the loss and every
  (gathered) parameter within rtol 1e-5 / atol 1e-6 (`test_tp.py:69-74`);
  ``Dense_0``'s weight and its Adam moment hold half their rows on each
  model rank.
- `shard_runner_tp` of a trained runner keeps the Adam moments: each rank
  holds its slice of each, the step counts unchanged (`test_tp.py:81-97`).
- The gradient through the TP forward (Megatron's f and g, the gathers)
  equals the unsharded gradient for each of the four nets, within float32
  rounding: a g that all-reduced in backward as well would double it.
- A DP checkpoint (env axis 2) restored onto the (2, 2) mesh continues:
  the loss and the params after a train step bitwise equal to those of
  `shard_runner_tp` of the saved runner; restoring it onto a 1-D mesh of
  4 env ranks raises, naming both sizes.
"""
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

import torch_dist_cases as cases  # noqa: E402
from test_torch_dist_env import run_ranks  # noqa: E402

from pvderx_torch.dist import param_partition_specs  # noqa: E402
from pvderx_torch.learn import (  # noqa: E402
    ActorCritic, DoubleCritic, QNetwork, TanhGaussianActor)


def _nets(hidden):
    from pvderx.learn import nets as jnets

    g = torch.Generator().manual_seed(0)
    x, a = jnp.zeros((1, 13)), jnp.zeros((1, 2))
    key = jax.random.PRNGKey(0)
    return [
        (ActorCritic(13, 5, hidden, generator=g),
         jnets.ActorCritic(5, hidden).init(key, x)),
        (ActorCritic(13, 80, hidden, generator=g),      # the per-unit head
         jnets.ActorCritic(80, hidden).init(key, x)),
        (QNetwork(13, 5, hidden, generator=g),
         jnets.QNetwork(5, hidden).init(key, x)),
        (TanhGaussianActor(13, 2, hidden, generator=g),
         jnets.TanhGaussianActor(2, hidden).init(key, x)),
        (DoubleCritic(13, 2, hidden, generator=g),
         jnets.DoubleCritic(hidden).init(key, x, a)),
    ]


@pytest.mark.parametrize("hidden", [(128, 128), (64, 64, 64)])
@pytest.mark.parametrize("n_model", [2, 4])
def test_torch_dist_tp_partition_specs_are_the_references(n_model, hidden):
    from pvderx.dist.tp import param_partition_specs as j_specs

    for net, params in _nets(hidden):
        want = j_specs(params, n_model)["params"]
        got = param_partition_specs(net, n_model)
        names = {id(m): n for n, m in net.named_modules()}
        assert len(want) == len(net.layers())
        for i, lin in enumerate(net.layers()):
            w = want[f"Dense_{i}"]
            name = names[id(lin)]
            assert got[f"{name}.weight"][::-1] == tuple(w["kernel"]), (
                type(net).__name__, i)
            assert got[f"{name}.bias"] == tuple(w["bias"]), (
                type(net).__name__, i)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("dist_tp")
    got = {4: run_ranks(workdir, 4, ["tp", "tp_moments", "tp_grad",
                                     "tp_checkpoint"]),
           2: run_ranks(workdir, 2, ["tp", "tp_grad"])}
    _, _, runner, ts = cases.tp_setup()
    runner, m = ts(runner)
    return got, {"loss": float(m["loss"]),
                 "params": [p.detach() for p in runner.net.parameters()]}


@pytest.mark.parametrize("w", [2, 4], ids=["env1_model2", "env2_model2"])
def test_torch_dist_tp_train_step_matches_dp_only(runs, w):
    got, want = runs
    for g in got[w]["tp"]:
        np.testing.assert_allclose(g["loss"], want["loss"], rtol=1e-5,
                                   atol=1e-6)
        for a, b in zip(g["params"], want["params"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6)
        # Dense_0 and its Adam moment really split: half the rows each
        assert g["shapes"] == {"dense0": (64, 13), "mu0": (64, 13)}


def test_torch_dist_tp_shard_runner_keeps_the_adam_moments(runs):
    for g in runs[0][4]["tp_moments"]:
        _, m = g["coords"]
        for k, whole in g["whole"].items():
            shard, local = g["shards"][k], g["local"][k]
            assert set(local) == set(whole)
            for name, v in whole.items():
                if not isinstance(v, torch.Tensor) or v.dim() == 0:
                    assert torch.equal(torch.as_tensor(local[name]),
                                       torch.as_tensor(v))
                    continue
                want = v if shard is None else v.narrow(*shard)
                assert torch.equal(local[name], want), (k, name)
        mu0 = g["local"][0]["exp_avg"]
        assert mu0.shape == (64, 13) and float(mu0.abs().max()) > 0.0
        assert g["shards"][0] == (0, 64 * m, 64)


@pytest.mark.parametrize("w", [2, 4])
def test_torch_dist_tp_gradient_equals_the_unsharded_gradient(runs, w):
    x = torch.randn(6, 13, generator=torch.Generator().manual_seed(3))
    act = torch.randn(6, 2, generator=torch.Generator().manual_seed(4))
    make = {"ActorCritic": (lambda g: ActorCritic(13, 80, generator=g),
                            lambda n: n(x)),
            "QNetwork": (lambda g: QNetwork(13, 5, generator=g),
                         lambda n: (n(x),)),
            "TanhGaussianActor": (lambda g: TanhGaussianActor(
                13, 2, generator=g), lambda n: n(x)),
            "DoubleCritic": (lambda g: DoubleCritic(13, 2, generator=g),
                             lambda n: n(x, act))}
    for name, (build, fwd) in make.items():
        net = build(torch.Generator().manual_seed(5))
        outs = fwd(net)
        loss = sum((o * torch.linspace(-1, 1, o.numel()).reshape(o.shape))
                   .sum() for o in outs)
        want = torch.autograd.grad(loss, list(net.parameters()))
        for g in runs[0][w]["tp_grad"]:
            assert g[name]["loss"] == pytest.approx(float(loss.detach()),
                                                    rel=1e-5)
            for a, b in zip(g[name]["grads"], want):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                           atol=1e-6, err_msg=name)


def test_torch_dist_tp_dp_checkpoint_restores_onto_a_tp_mesh(runs):
    for g in runs[0][4]["tp_checkpoint"]:
        assert g["files"] == ["rank0-of-2.pt", "rank1-of-2.pt",
                              "replicated.pt"]
        assert g["loss"][0] == g["loss"][1] and g["params"]
        msg = g["wrong_size"]
        assert msg is not None and "size 2" in msg and "is 4" in msg, msg
