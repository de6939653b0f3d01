"""DQN training on the batched env, on one card or over several ranks.

    python -m pvderx_torch.examples.train_dqn --n-envs 1024 --updates 50
    python -m pvderx_torch.dist.launch --nproc 2 -m \\
        pvderx_torch.examples.train_dqn --n-envs 2048

Started as ranks, the env batch and the replay are split over them
(``--n-envs`` is the global count; the capacity must then be a multiple of
rollout_len · n_envs) and the learner's gradient all-reduced.
"""
from __future__ import annotations

import argparse

from pvderx_torch.examples._train import (
    add_common_flags, finish, start, train)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_flags(ap)
    ap.add_argument("--n-envs", type=int, default=1024)
    ap.add_argument("--anomaly", action="store_true", help="BASELINE config 3")
    ap.add_argument("--ckpt", default="", help="checkpoint path (optional)")
    args = ap.parse_args(argv)
    args.n_sub = args.n_sub or (72 if args.preset == "10" else 88)

    import torch

    from pvderx_torch.env import make_env_config
    from pvderx_torch.learn import DQNConfig, make_dqn

    device, mesh, is_rank0 = start(args.cpu)
    cfg = make_env_config(args.preset, n_sub=args.n_sub,
                          anomaly_detect=args.anomaly, device=device)
    dqn = DQNConfig()
    init_runner, train_step, _ = make_dqn(cfg, dqn, mesh=mesh)
    runner = init_runner(args.n_envs,
                         torch.Generator(device=device).manual_seed(0))
    runner, metrics = train(
        "dqn", runner, train_step, args, args.n_envs * dqn.rollout_len,
        ("loss", "epsilon", "reward_mean"), mesh, is_rank0, args.ckpt)
    finish(mesh)
    return metrics


if __name__ == "__main__":
    main()
