"""PPO training on the batched env, on one card or over several ranks.

    python -m pvderx_torch.examples.train_ppo --n-envs 1024 --updates 50
    python -m pvderx_torch.dist.launch --nproc 4 -m \\
        pvderx_torch.examples.train_ppo --n-envs 4096 --tp 2

Started as ranks, the env batch is split over them (``--n-envs`` is the
global count) and the learner's gradient all-reduced; ``--tp`` runs the
learner's MLP tensor-parallel over a 2-D ``(env, model)`` mesh.
"""
from __future__ import annotations

import argparse

from pvderx_torch.examples._train import (
    add_common_flags, finish, start, train)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_flags(ap)
    ap.add_argument("--n-envs", type=int, default=1024)
    ap.add_argument("--voltvar", action="store_true", help="BASELINE config 2")
    ap.add_argument("--fleet-m", type=int, default=0,
                    help="train on the M-DER shared-feeder fleet env "
                         "(BASELINE config 5); 0 = single-DER env")
    ap.add_argument("--per-unit", action="store_true",
                    help="fleet mode with per-unit control: MultiDiscrete "
                         "actions and the per-unit [Vdc|P|Q|conn] obs block; "
                         "PPO grows a factored per-unit head (needs "
                         "--fleet-m)")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis size for tensor parallelism (2-D "
                         "(env, model) mesh, pvderx_torch.dist.tp; the ranks "
                         "must divide by it). Default 1 = DP only.")
    ap.add_argument("--ckpt", default="", help="checkpoint path (optional)")
    args = ap.parse_args(argv)
    args.n_sub = args.n_sub or (72 if args.preset == "10" else 88)
    if args.per_unit and not args.fleet_m:
        raise SystemExit("--per-unit needs --fleet-m")

    import torch

    from pvderx_torch.env import make_env_config, make_fleet_config
    from pvderx_torch.learn import PPOConfig, make_ppo

    device, mesh, is_rank0 = start(args.cpu, args.tp)
    if args.fleet_m:
        cfg = make_fleet_config(args.preset, m=args.fleet_m, n_sub=args.n_sub,
                                per_unit=args.per_unit,
                                voltvar_enable=args.voltvar, device=device)
    else:
        cfg = make_env_config(args.preset, n_sub=args.n_sub,
                              voltvar_enable=args.voltvar, device=device)
    ppo = PPOConfig()
    init_runner, train_step, _ = make_ppo(cfg, ppo, mesh=mesh)
    runner = init_runner(args.n_envs,
                         torch.Generator(device=device).manual_seed(0))
    runner, metrics = train(
        "ppo", runner, train_step, args, args.n_envs * ppo.rollout_len,
        ("loss", "reward_mean"), mesh, is_rank0, args.ckpt)
    finish(mesh)
    return metrics


if __name__ == "__main__":
    main()
