"""Single-env rollout: the reference's ``gym.make('PVDER-v0')`` flow.

Make the env, reset, step random actions. With gymnasium installed the env
comes from ``gym.make("pvderx_torch/PVDER-v0")``; without it `PVDEREnv` is
built directly (same reset/step, no spaces).

    python -m pvderx_torch.examples.gym_rollout [--steps 120] [--continuous]
"""
from __future__ import annotations

import argparse
import importlib.util

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    if importlib.util.find_spec("gymnasium") is not None:
        import gymnasium as gym

        import pvderx_torch  # noqa: F401  (registers pvderx_torch/PVDER-v0)

        env = gym.make("pvderx_torch/PVDER-v0", continuous=args.continuous,
                       device=device)
        sample = env.action_space.sample
    else:
        from pvderx_torch.env import core
        from pvderx_torch.env.gym_adapter import PVDEREnv

        print("gymnasium is not installed: PVDEREnv built directly")
        env = PVDEREnv(continuous=args.continuous, device=device)
        rng = np.random.default_rng(0)
        sample = ((lambda: rng.uniform(-1.0, 1.0, core.ACT_DIM_CONT)
                   .astype(np.float32)) if args.continuous
                  else (lambda: int(rng.integers(core.N_ACTIONS))))
    obs, info = env.reset(seed=0)
    total = 0.0
    for k in range(args.steps):
        obs, reward, terminated, truncated, info = env.step(sample())
        total += reward
        if k % 30 == 0:
            print(env.unwrapped.render() if hasattr(env, "unwrapped")
                  else env.render())
        if terminated or truncated:
            print(f"episode end at step {k} (terminated={terminated})")
            obs, info = env.reset()
    print(f"return over {args.steps} steps: {total:.2f}")
    return total


if __name__ == "__main__":
    main()
