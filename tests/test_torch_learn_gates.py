"""The seeded better-than-random learning gates, run with the port's
learners on the CPU (the twins of tests/test_learning.py; chip_smoke.py
runs the same gates on the card as its `learn_gates` phase). The gates
themselves are `pvderx_torch.learn.gates`.

Same tasks, budgets, widths and margins as the reference's gates. The seeds
cannot match JAX's (threefry vs torch's generators), so each gate is the
reference's task under another seed. The port's eager CPU step costs
~0.13 s at 64 envs, so these take minutes each: they are marked `slow`,
outside the tier-1 run, to be run by hand:

    python -m pytest tests/test_torch_learn_gates.py -m slow -n 4

Run as a script, this file trains the reference's gate (the JAX package,
on the CPU) at several training seeds, one JSON line per seed, for the
spread the port's readings (``python -m pvderx_torch.learn.gates``) are
held against:

    PYTHONPATH=. python tests/test_torch_learn_gates.py fleet_per_unit_ppo \
        --seeds 0 1 2
"""
import argparse
import json
import time

import pytest

from pvderx_torch.learn.gates import LEARN_GATES, check_learn_gate


@pytest.mark.slow
@pytest.mark.parametrize("gate", list(LEARN_GATES))
def test_torch_learn_gate_beats_random_on_cpu(gate):
    trained, random, margin = LEARN_GATES[gate]("cpu")
    print(f"{gate}: trained={trained:.5f} random={random:.5f} "
          f"margin={margin}")
    check_learn_gate(gate, trained, random, margin)


def reference_gate(name, seed):
    """The reference's gate ``name`` (tests/test_learning.py) with its
    learner initialised from ``jax.random.PRNGKey(seed)`` (the random
    baseline at the gate's own seed): (trained, random, margin). JAX is
    set up as tests/conftest.py sets it (CPU, x64 on), so seed 0 is the
    tier-1 gate's reading."""
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import test_learning as tl
    from pvderx.env import make_env_config
    from pvderx.env.fleet import make_fleet_config
    from pvderx.learn import (DQNConfig, PPOConfig, SACConfig, make_dqn,
                              make_ppo, make_sac)
    from pvderx.learn.env_api import make_env_api

    ppo = PPOConfig(rollout_len=16, n_epochs=2, n_minibatch=4, lr=3e-3,
                    ent_coef=0.005)
    if name == "ppo":
        cfg = tl._anomaly_cfg()
        rews = tl._train(make_ppo, cfg, ppo, 60, seed)
        return float(np.mean(rews[-10:])), tl._random_return(cfg, 0), 0.02
    if name == "dqn":
        cfg = tl._anomaly_cfg()
        rews = tl._train(make_dqn, cfg, DQNConfig(
            lr=1e-3, eps_decay_updates=80, eps_end=0.05), 200, seed)
        return float(np.mean(rews[-20:])), tl._random_return(cfg, 0), 0.012
    if name == "sac":
        cfg = make_env_config("10", n_sub=40, horizon=50, continuous=True,
                              dq_action=0.15, dv_action=0.06)
        rews = tl._train(make_sac, cfg, SACConfig(lr=3e-3, init_alpha=0.05),
                         300, seed)
        return (float(np.mean(rews[-20:])),
                tl._random_return(cfg, 7, continuous=True), 0.015)
    fc = make_fleet_config("10", m=4, n_sub=40, horizon=50, per_unit=True,
                           dq_action=0.1, dv_action=0.04, scen=tl.SCEN3)
    init_runner, train_step, _ = make_ppo(fc, ppo, hidden=(32, 32))
    runner = init_runner(jax.random.PRNGKey(seed), 32)
    ts = jax.jit(train_step, donate_argnums=(0,))
    rews = []
    for _ in range(100):
        runner, m = ts(runner)
        rews.append(float(m["reward_mean"]))
    api = make_env_api(fc)
    st, _ = api.reset_batch(jax.random.PRNGKey(0), 32)
    step = jax.jit(api.step)
    key, tot = jax.random.PRNGKey(999), []
    for _ in range(200):
        key, k = jax.random.split(key)
        st, _, r, _, _ = step(st, jax.random.randint(k, (32, fc.m), 0, 5))
        tot.append(float(r.mean()))
    return float(np.mean(rews[-10:])), float(np.mean(tot)), 0.008


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="the reference's learning "
                                 "gate at several training seeds")
    ap.add_argument("gate", choices=list(LEARN_GATES))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args()
    for seed in args.seeds:
        t = time.perf_counter()
        trained, random, margin = reference_gate(args.gate, seed)
        print(json.dumps({
            "gate": args.gate, "reference": True, "seed": seed,
            "trained": trained, "random": random, "gain": trained - random,
            "margin": margin, "passed": trained > random + margin,
            "seconds": time.perf_counter() - t}), flush=True)
