"""SAC training on the continuous-action env, on one card or over several
ranks.

    python -m pvderx_torch.examples.train_sac --n-envs 256 --updates 50
    python -m pvderx_torch.dist.launch --nproc 2 -m \\
        pvderx_torch.examples.train_sac --n-envs 512

Started as ranks, as `train_dqn` is.
"""
from __future__ import annotations

import argparse

from pvderx_torch.examples._train import (
    add_common_flags, finish, start, train)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_flags(ap)
    ap.add_argument("--n-envs", type=int, default=256)
    args = ap.parse_args(argv)
    args.n_sub = args.n_sub or (72 if args.preset == "10" else 88)

    import torch

    from pvderx_torch.env import make_env_config
    from pvderx_torch.learn import SACConfig, make_sac

    device, mesh, is_rank0 = start(args.cpu)
    cfg = make_env_config(args.preset, n_sub=args.n_sub, continuous=True,
                          device=device)
    sac = SACConfig()
    init_runner, train_step, _ = make_sac(cfg, sac, mesh=mesh)
    runner = init_runner(args.n_envs,
                         torch.Generator(device=device).manual_seed(0))
    runner, metrics = train(
        "sac", runner, train_step, args, args.n_envs * sac.rollout_len,
        ("critic_loss", "reward_mean", "alpha"), mesh, is_rank0)
    finish(mesh)
    return metrics


if __name__ == "__main__":
    main()
