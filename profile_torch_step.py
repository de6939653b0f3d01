#!/usr/bin/env python3
"""Profile the port's batched env step on one CUDA card.

    python3 profile_torch_step.py            # the single-DER main path
    python3 profile_torch_step.py --fleet    # the fleet (BASELINE config 5)
    python3 profile_torch_step.py --df       # the df32 tier (make_batch_fns_df)

Runs the main path (preset 10, f32, n_sub=64, 32768 envs, zero-action policy,
autoreset), with ``--fleet`` the fleet path (preset 10, f32, n_sub=64,
4096 envs x 16 units, aggregate mode, zero-action policy), or with ``--df``
the main path's config through the df32 tier (state carried as (hi, lo)),
under `torch.profiler` for 20 steps after 10 warm-up steps, and prints one JSON
line: wall ms per step, device-busy ms per step (sum of
kernel times; one stream, so kernels do not overlap), the device's idle
share, kernel launches per step, and the kernels that take the most device
time.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


N_ENVS, N_SUB, STEPS, WARM = 32768, 64, 20, 10
FLEET_ENVS, FLEET_M = 4096, 16


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device is available", file=sys.stderr)
        return 1
    from pvderx_torch.env import (
        fleet_rollout, make_batch_fns, make_batch_fns_df, make_env_config,
        make_fleet_batch_fns, make_fleet_config, rollout, rollout_df)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    path = ("fleet" if "--fleet" in sys.argv[1:]
            else "df" if "--df" in sys.argv[1:] else "single")
    kw = dict(dtype=torch.float32, n_sub=N_SUB, device="cuda")
    if path == "fleet":
        n_envs, shape = FLEET_ENVS, {"n_envs": FLEET_ENVS, "m": FLEET_M}
        cfg = make_fleet_config("10", m=FLEET_M, **kw)
        reset_batch, _ = make_fleet_batch_fns(cfg)
        roll = fleet_rollout
    elif path == "df":
        n_envs, shape = N_ENVS, {"n_envs": N_ENVS}
        cfg = make_env_config("10", **kw)
        reset_batch, _ = make_batch_fns_df(cfg)
        roll = rollout_df
    else:
        n_envs, shape = N_ENVS, {"n_envs": N_ENVS}
        cfg = make_env_config("10", **kw)
        reset_batch, _ = make_batch_fns(cfg)
        roll = rollout
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, obs = reset_batch(n_envs, gen)
    policy = lambda o, g: torch.zeros(o.shape[0], dtype=torch.int64,
                                      device=o.device)
    state, obs, r, _ = roll(cfg, state, obs, policy, WARM, gen)
    float(r.sum())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, obs, r, _ = roll(cfg, state, obs, policy, STEPS, gen)
        float(r.sum())
        wall_s = time.perf_counter() - t

    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rec = by_name.setdefault(e.name, [0, 0.0])
            rec[0] += 1
            rec[1] += e.time_range.elapsed_us()
    launches = sum(c for c, _ in by_name.values())
    busy_us = sum(us for _, us in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    wall_ms = 1e3 * wall_s / STEPS
    busy_ms = 1e-3 * busy_us / STEPS
    print(json.dumps({
        "card": card, "path": path, **shape,
        "n_sub": N_SUB,
        "steps": STEPS, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches_per_step": launches / STEPS,
        "top_kernels": [
            {"name": name[:80], "per_step": c / STEPS,
             "ms_per_step": 1e-3 * us / STEPS}
            for name, (c, us) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
