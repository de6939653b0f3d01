"""The seeded better-than-random learning gates, run with the port's learners.

The twins of the reference's gates (``tests/test_learning.py``): the same
tasks, budgets, widths (hidden (32, 32), float32, 64 envs; 32 for the
fleet) and margins. A gate trains a learner from ``seed`` and returns
(trained, random, margin): the mean ``reward_mean`` of the last train
steps, the mean per-step reward of a uniform-random policy (its own fixed
seeds, as the reference's), and the margin by which trained must beat
random. The seeds cannot match JAX's (threefry vs torch's generators), so
each gate is the reference's task under another seed.

`chip_smoke.py` runs the four gates on the card, and
``tests/test_torch_learn_gates.py`` on the CPU. Run one gate over several
training seeds (one JSON line per seed):

    python -m pvderx_torch.learn.gates fleet_per_unit_ppo --seeds 0 1 2 \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

GATE_ENVS = 64
SCEN3 = dict(p_sag=0.9, p_freq=0.1, sag_depth_lo=0.2, sag_depth_hi=0.85)


def random_return(cfg, seed, device, n_envs=GATE_ENVS, steps=320):
    """Mean per-step reward of a uniform-random policy (a gate's baseline):
    the env reset and stepped from ``seed``, the actions from
    ``seed + 999``."""
    from pvderx_torch.learn.env_api import make_env_api, pack_params

    api = make_env_api(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    act_gen = torch.Generator(device=device).manual_seed(seed + 999)
    st, _ = api.reset_batch(n_envs, gen)
    p_pack = pack_params(st)
    rews = []
    with torch.no_grad():
        for _ in range(steps):
            if api.act_dim:
                a = 2.0 * torch.rand(n_envs, api.act_dim, generator=act_gen,
                                     device=device, dtype=api.dtype) - 1.0
            else:
                shape = (n_envs,) if api.n_units == 1 else (n_envs,
                                                            api.n_units)
                a = torch.randint(0, api.n_actions, shape, generator=act_gen,
                                  device=device)
            st, _, r, _, _ = api.step(st, a, gen, p_pack)
            rews.append(r.mean())
    return float(torch.stack(rews).mean())


def train_rewards(make, cfg, lcfg, n_updates, device, n_envs=GATE_ENVS,
                  seed=0):
    """The per-train-step ``reward_mean`` of ``n_updates`` seeded train
    steps at hidden (32, 32)."""
    init_runner, ts, _ = make(cfg, lcfg, hidden=(32, 32))
    runner = init_runner(n_envs, torch.Generator(device=device).manual_seed(
        seed))
    rews = []
    for _ in range(n_updates):
        runner, m = ts(runner)
        rews.append(m["reward_mean"])
    return torch.stack(rews).tolist()


def gate_ppo(device, seed=0):
    """tests/test_learning.py::test_ppo_learns_better_than_random."""
    from pvderx_torch.env import ScenarioConfig, make_env_config
    from pvderx_torch.learn import PPOConfig, make_ppo

    cfg = make_env_config("10", n_sub=40, horizon=50, anomaly_detect=True,
                          scen=ScenarioConfig(**SCEN3), device=device)
    rews = train_rewards(make_ppo, cfg, PPOConfig(
        rollout_len=16, n_epochs=2, n_minibatch=4, lr=3e-3, ent_coef=0.005),
        60, device, seed=seed)
    return float(np.mean(rews[-10:])), random_return(cfg, 0, device), 0.02


def gate_dqn(device, seed=0):
    """tests/test_learning.py::test_dqn_learns_better_than_random."""
    from pvderx_torch.env import ScenarioConfig, make_env_config
    from pvderx_torch.learn import DQNConfig, make_dqn

    cfg = make_env_config("10", n_sub=40, horizon=50, anomaly_detect=True,
                          scen=ScenarioConfig(**SCEN3), device=device)
    rews = train_rewards(make_dqn, cfg, DQNConfig(
        lr=1e-3, eps_decay_updates=80, eps_end=0.05), 200, device, seed=seed)
    return float(np.mean(rews[-20:])), random_return(cfg, 0, device), 0.012


def gate_sac(device, seed=0):
    """tests/test_learning.py::test_sac_learns_better_than_random."""
    from pvderx_torch.env import make_env_config
    from pvderx_torch.learn import SACConfig, make_sac

    cfg = make_env_config("10", n_sub=40, horizon=50, continuous=True,
                          dq_action=0.15, dv_action=0.06, device=device)
    rews = train_rewards(make_sac, cfg, SACConfig(lr=3e-3, init_alpha=0.05),
                         300, device, seed=seed)
    return float(np.mean(rews[-20:])), random_return(cfg, 7, device), 0.015


def gate_fleet_per_unit(device, seed=0):
    """tests/test_learning.py::
    test_fleet_per_unit_ppo_learns_better_than_uniform (M = 4, 32 envs)."""
    from pvderx_torch.env import ScenarioConfig, make_fleet_config
    from pvderx_torch.learn import PPOConfig, make_ppo

    fc = make_fleet_config("10", m=4, n_sub=40, horizon=50, per_unit=True,
                           dq_action=0.1, dv_action=0.04,
                           scen=ScenarioConfig(**SCEN3), device=device)
    rews = train_rewards(make_ppo, fc, PPOConfig(
        rollout_len=16, n_epochs=2, n_minibatch=4, lr=3e-3, ent_coef=0.005),
        100, device, n_envs=32, seed=seed)
    return (float(np.mean(rews[-10:])),
            random_return(fc, 0, device, n_envs=32, steps=200), 0.008)


LEARN_GATES = {"ppo": gate_ppo, "dqn": gate_dqn, "sac": gate_sac,
               "fleet_per_unit_ppo": gate_fleet_per_unit}


def check_learn_gate(name, trained, random, margin):
    """Raise unless the trained policy beat the random one by the margin."""
    if not trained > random + margin:
        raise AssertionError(f"{name} did not learn: trained={trained:.5f} "
                             f"random={random:.5f} margin={margin}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("gate", choices=list(LEARN_GATES))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t = time.perf_counter()
        trained, random, margin = LEARN_GATES[args.gate](args.device, seed)
        print(json.dumps({
            "gate": args.gate, "device": args.device, "seed": seed,
            "trained": trained, "random": random, "gain": trained - random,
            "margin": margin, "passed": trained > random + margin,
            "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
