"""The learners over `pvderx_torch.dist` on 2 gloo ranks of the CPU.

The ranks run `tests/torch_dist_cases.py` (see `test_torch_dist_env.py`):

- PPO (single-DER, and the per-unit fleet at M = 4), DQN and SAC: a
  one-rank runner of 16 envs placed by `shard_runner` and trained 2 steps
  on 2 ranks is within 1e-5 (abs) of the same runner trained on one rank,
  as the reference holds its sharded step (`tests/test_dist.py:73`);
  ``reward_mean`` within 1e-6, the env's obs bit for bit, and the replicas
  of every learned tensor bitwise equal across the ranks;
- a runner built under the mesh from a different seed on each rank trains
  as the one-rank runner of rank 0's seed (the generator is replicated
  before the first draw);
- a world-2 checkpoint (`diag.checkpoint` over the mesh: `replicated.pt`
  and one env shard per rank) restored into a runner of another seed
  trains on bitwise equal to the saved runner;
- one PPO train step at world 2 equals the reference's unsharded step:
  `tests/test_torch_learn_ppo.py`'s single-DER anomaly twin (8 envs,
  float64, hidden (32, 32), rollout 4, 2 epochs of one minibatch, greedy
  actions on both sides), the JAX init carried over; params within 1e-6 of
  the leaf's largest magnitude (the single-rank twin's tolerance),
  metrics within 1e-6 relative, obs within 1e-9.
"""
import dataclasses
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

LEARNERS = ("ppo", "fleet_ppo", "dqn", "sac")
TWIN_PPO = dict(rollout_len=4, n_epochs=2, n_minibatch=1, lr=3e-3)
TWIN_N = 8


def _reference_twin():
    """The reference's PPO twin: (input for the ranks, params and metrics
    after each of two train steps, obs)."""
    from pvderx.env import make_env_config as j_make_env_config
    from pvderx.learn import PPOConfig as JPPOConfig, make_ppo as j_make_ppo

    cfg_j = j_make_env_config("10", dtype=jnp.float64, n_sub=40, horizon=50,
                              anomaly_detect=True)
    init_j, ts_j, _ = j_make_ppo(cfg_j, JPPOConfig(**TWIN_PPO),
                                 hidden=(32, 32), dtype=jnp.float64)
    rj = jax.jit(init_j, static_argnums=1)(jax.random.PRNGKey(0), TWIN_N)
    inp = {"ppo": TWIN_PPO, "n": TWIN_N,
           "params": jax.tree.map(np.asarray, rj.params),
           "env_state": dataclasses.asdict(jax.tree.map(np.asarray,
                                                        rj.env_state)),
           "obs": np.asarray(rj.obs)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "categorical",
                   lambda key, logits, axis=-1: jnp.argmax(logits, axis))
        ts_j = jax.jit(ts_j)
        metrics = []
        for _ in range(2):
            rj, mj = ts_j(rj)
            metrics.append({k: float(v) for k, v in mj.items()})
    return inp, jax.tree.map(np.asarray, rj.params), metrics, np.asarray(
        rj.obs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("dist_learn")
    inp, twin_params, twin_metrics, twin_obs = _reference_twin()
    torch.save(inp, workdir / "ppo_twin-input.pt")
    got = run_ranks(workdir, 2, [*LEARNERS, "init", "checkpoint",
                                 "ppo_twin"])
    want = {}
    for name in (*LEARNERS, "init"):
        init, ts = cases.learner("ppo" if name == "init" else name)
        runner = init(cases.N, torch.Generator().manual_seed(0))
        for _ in range(1 if name == "init" else 2):
            runner, m = ts(runner)
        want[name] = {"params": cases.learner_params(runner), "obs":
                      runner.obs, "metrics": {k: float(v)
                                              for k, v in m.items()}}
    return got, want, (twin_params, twin_metrics, twin_obs)


@pytest.mark.parametrize("name", [*LEARNERS, "init"])
def test_torch_dist_learner_world2_matches_world1(runs, name):
    got, want, _ = runs
    w = want[name]
    for r, g in enumerate(got[name]):
        for a, b in zip(g["params"], w["params"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5)
        assert g["metrics"]["reward_mean"] == pytest.approx(
            w["metrics"]["reward_mean"], abs=1e-6)
        for k, v in w["metrics"].items():
            assert g["metrics"][k] == pytest.approx(v, rel=1e-4, abs=1e-5), k
        sl = slice(r * cases.N // 2, (r + 1) * cases.N // 2)
        assert torch.equal(g["obs"], w["obs"][sl])


@pytest.mark.parametrize("name", [*LEARNERS, "init"])
def test_torch_dist_learner_replicas_are_bitwise_equal(runs, name):
    ranks = runs[0][name]
    assert len(ranks[0]["params"]) > 0
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        assert torch.equal(a, b)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]


def test_torch_dist_checkpoint_resumes_bitwise(runs):
    for g in runs[0]["checkpoint"]:
        assert g["files"] == ["rank0-of-2.pt", "rank1-of-2.pt",
                              "replicated.pt"]
        assert g["same_before"] and g["same_after"]
        assert g["loss"][0] == g["loss"][1]


def test_torch_dist_ppo_world2_matches_the_reference_step(runs):
    from pvderx_torch import convert
    from pvderx_torch.learn import ActorCritic

    params, metrics, obs = runs[2]
    ranks = runs[0]["ppo_twin"]
    net = ActorCritic(13, 6, (32, 32), torch.float64,
                      generator=torch.Generator())
    want = convert.flax_state_dict(net, params)
    for g in ranks:
        assert g["update_i"] == 2
        for k, v in want.items():
            err = (g["state_dict"][k].double() - v.double()).abs().max()
            assert float(err) <= 1e-6 * float(v.abs().max()), k
        for got_m, want_m in zip(g["metrics"], metrics):
            for k in ("loss", "pg_loss", "v_loss", "entropy", "reward_mean"):
                assert abs(got_m[k] - want_m[k]) <= 1e-6 * max(
                    abs(want_m[k]), 1e-30), (k, got_m[k], want_m[k])
    np.testing.assert_allclose(
        torch.cat([g["obs"] for g in ranks]).numpy(), obs, rtol=0, atol=1e-9)
