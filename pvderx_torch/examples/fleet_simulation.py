"""Multi-DER fleet on a shared feeder: BASELINE config 5.

M inverters couple through one PCC feeder solve per RHS evaluation; the
fleet env batches over envs on top (SPEC.md §11).

    python -m pvderx_torch.examples.fleet_simulation --m 16 --n-envs 64 --steps 120
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="10")
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--n-envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--n-sub", type=int, default=None,
                    help="RK4 substeps/window; default = the per-preset 1e-6 "
                         "knee (72 single-phase, 88 three-phase; SPEC §6)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    args.n_sub = args.n_sub or (72 if args.preset == "10" else 88)

    import torch

    from pvderx_torch.env import make_fleet_batch_fns, make_fleet_config
    from pvderx_torch.utils import get_logger

    device = "cpu" if args.cpu else "cuda"
    log = get_logger("examples.fleet")
    fc = make_fleet_config(args.preset, m=args.m, n_sub=args.n_sub,
                           device=device)
    reset_batch, step_batch = make_fleet_batch_fns(fc)
    gen = torch.Generator(device=device).manual_seed(0)
    st, obs = reset_batch(args.n_envs, gen)
    log.info("fleet: %d envs x %d DERs = %d inverters",
             args.n_envs, args.m, args.n_envs * args.m)
    tot = torch.zeros(args.n_envs, device=device)
    for k in range(args.steps):
        acts = torch.randint(0, 5, (args.n_envs,), generator=gen,
                             device=device)
        st, obs, rew, done, info = step_batch(st, acts, gen)
        tot = tot + rew
        if k % 30 == 0:
            log.info("step %3d: mean reward %.3f  mean P_pcc %.3f  "
                     "tripped frac %.3f",
                     k, float(rew.mean()), float(info["p_pcc"].mean()),
                     float(info["tripped_frac"].mean()))
    log.info("mean return over %d steps: %.2f", args.steps, float(tot.mean()))
    return tot


if __name__ == "__main__":
    main()
