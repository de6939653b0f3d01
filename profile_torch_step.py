#!/usr/bin/env python3
"""Profile the port's batched env step on one CUDA card.

    python3 profile_torch_step.py            # the single-DER main path
    python3 profile_torch_step.py --fleet    # the fleet (BASELINE config 5)
    python3 profile_torch_step.py --df       # the df32 tier (make_batch_fns_df)
    python3 profile_torch_step.py --sass     # registers, SASS and issue floor
    python3 profile_torch_step.py --kernels  # ms per launch of K1, K2, K3
    python3 profile_torch_step.py --outputs FILE [--against OTHER]
    python3 profile_torch_step.py --gate-window SEED [SEED ...]
    python3 profile_torch_step.py --jacobian cuda|cpu
    python3 profile_torch_step.py --trace-edges REPS

Runs the main path (preset 10, f32, n_sub=64, 32768 envs, zero-action policy,
autoreset), with ``--fleet`` the fleet path (preset 10, f32, n_sub=64,
4096 envs x 16 units, aggregate mode, zero-action policy), or with ``--df``
the main path's config through the df32 tier (state carried as (hi, lo)):
10 warm-up steps, 200 steps timed on the host clock without the profiler,
then 20 steps under `torch.profiler`. Prints one JSON line: untraced ms per
step and env-steps/s, the traced wall ms per step, device-busy ms per step
(sum of kernel times; one stream, so kernels do not overlap), the device's
idle share of the traced step, kernel launches per step, and the kernels
that take the most device time.

``--sass`` builds the kernel library if needed and prints one JSON line per
window kernel: registers and spill bytes (ptxas) and, from `cuobjdump -sass`
on the library, its instruction count, the static size of its substep loop
and of the stage loop inside it, and an estimate of the instructions one
substep runs. For each kernel that a `--kernels` shape launches, the line
also holds that shape, the warps of the launch (grid and block from a
`torch.profiler` trace of one call) and the SASS-issue floor: instructions
per substep x n_sub x warps / (132 SMs x 4 schedulers x max SM clock), one
warp instruction per scheduler per clock.

``--kernels`` times each window kernel with CUDA events on `chip_smoke.py`'s
seeded inputs at n_sub=64: K1 at presets 10 and 50 (32768 envs), K2 at
BASELINE config 5 (4096 envs x 16 units), K3 at presets 10 and 50 (32768
envs). One JSON line per shape: ms per launch and the lane-issue floor
(operations / (132 SMs x 128 FP32 lanes x max SM clock)). To compare two
checkouts, run this mode in each, in turns (A B B A).

``--outputs FILE`` runs each window kernel (K1, K2, K3) once on the seeded
inputs of `chip_smoke.py`'s kernel phases (K1 and K3 on its six window
cases, K2 on its seven fleet cases, at n_sub=64) and saves the outputs to
FILE (.npz). With ``--against OTHER`` (a file saved the same way, e.g. by
another checkout) it prints, per kernel and case, the max abs difference
and whether the two are equal bit for bit.

``--gate-window SEED ...`` trains the per-unit fleet learning gate
(`pvderx_torch.learn.gates`, M = 4, 32 envs, n_sub=40) on the card from
each SEED, and at every GATE_EVERY-th env step holds K2's output against
the plain fleet window run on a CPU copy of the same inputs (the window
the gate's CPU twin runs), both against that plain window in float64. One
JSON line per seed: the windows checked, the max abs K2 - plain (f32)
difference, each one's max abs error against float64, and the gate's
trained / random / gain.

``--trace-edges REPS`` traces three main-path steps REPS times with
`torch.profiler` alone and REPS times with `diag.profiler.trace` (idle
guards around the block), in turns, and counts per way the kernel launches
whose kernel event the trace dropped, and where in the block they were.

``--jacobian DEVICE`` times the two ways to take the Jacobian of the
single-DER RHS (preset 10, float32, a reset state on DEVICE, the sag's
0.5 pu grid): torch's forward mode, `vmap(jacfwd)` of the one-env
residual, and the complex step of `pvderx_torch.ode.implicit`
(`rhs_and_jacobian`, one evaluation of the RHS on complex copies), at
N = 1, 128 and 32768 envs, each the mean of 10 calls after one, synced;
and the plain batched RHS beside them. One JSON line per N: the ms of
each and the largest difference of the two Jacobians relative to the
largest entry. On "cpu" it measures the host, not a card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from pvderx_torch.diag.roofline import H100, at_clock, lane_issue_per_s


N_ENVS, N_SUB, STEPS, WARM, TIMED = 32768, 64, 20, 10, 200
FLEET_ENVS, FLEET_M = 4096, 16
SMS, SCHEDULERS = H100["sms"], 4       # warp schedulers per SM
GATE_EVERY = 25


def sass_loops(sass: str) -> dict:
    """Per kernel of a `cuobjdump -sass` listing: its instruction count, the
    static size of its outermost loop (the largest backward branch: the
    substep loop) and of the largest loop inside that one (the stage loop
    where the stages are looped; where they are written out, as in K1 and
    K2, a small loop of the sin/cos argument reduction, or 0), and an
    estimate of the instructions one substep runs: outer + 3 * inner (the
    stage body runs four times; this counts every update variant on each
    pass, so it is a little high)."""
    funcs, cur = {}, None
    for ln in sass.splitlines():
        hit = re.match(r"\s*Function : (\S+)", ln)
        if hit:
            cur = funcs.setdefault(hit.group(1), [])
            continue
        hit = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if hit and cur is not None and not hit.group(2).startswith("NOP"):
            cur.append((int(hit.group(1), 16), hit.group(2)))
    out = {}
    for name, ins in funcs.items():
        loops = []
        for addr, text in ins:
            hit = re.search(r"BRA\s+(?:\S+\s+)?0x([0-9a-f]+)", text)
            if hit and int(hit.group(1), 16) < addr:
                lo = int(hit.group(1), 16)
                loops.append((sum(lo <= a <= addr for a, _ in ins), lo, addr))
        outer = max(loops, default=(0, 0, 0))
        inner = max((lp for lp in loops if lp != outer and outer[1] <= lp[1]
                     and lp[2] <= outer[2]), default=(0, 0, 0))
        out[name] = dict(instructions=len(ins), substep_loop=outer[0],
                         stage_loop=inner[0],
                         per_substep_est=outer[0] + 3 * inner[0])
    return out


def sass_per_substep(loops: dict) -> tuple[bool, int]:
    """(stages looped, SASS instructions one substep runs) from a
    `sass_loops` entry. The stages count as looped where the inner loop
    holds at least half of the substep loop; then `per_substep_est`.
    Otherwise the inner loop is a small one inside written-out stages (the
    sin/cos argument reduction) and the substep loop's static size is what
    one substep runs."""
    looped = 2 * loops["stage_loop"] >= loops["substep_loop"] > 0
    return looped, (loops["per_substep_est"] if looped
                    else loops["substep_loop"])


def sass_issue_floor_ms(per_substep: int, n_sub: int, warps: int,
                        clock_mhz: float) -> float:
    """The least time the SMs take to issue a window's SASS: one warp
    instruction per scheduler per clock on every scheduler of the card."""
    return 1e3 * per_substep * n_sub * warps / (SMS * SCHEDULERS
                                                * clock_mhz * 1e6)


def trace_launch(trace: dict) -> dict | None:
    """The window kernel of a `torch.profiler` chrome trace: its short name
    and the warps it launched (grid blocks x warps per block)."""
    from chip_smoke import kernel_name

    for ev in trace.get("traceEvents", []):
        name = ev.get("name", "")
        if ev.get("cat") != "kernel" or "window" not in name:
            continue
        args = ev.get("args", {})
        grid, block = args.get("grid"), args.get("block")
        if not grid or not block:
            return None
        blocks = grid[0] * grid[1] * grid[2]
        threads = block[0] * block[1] * block[2]
        return dict(kernel=kernel_name(name), warps=blocks * -(-threads // 32))
    return None


def launch_of(fn) -> dict | None:
    """`trace_launch` of one call of ``fn`` under `diag.profiler.trace`."""
    from pvderx_torch.diag.profiler import trace, trace_events

    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            fn()
        return trace_launch({"traceEvents": trace_events(d)})


def kernel_shapes(device: str = "cuda") -> dict:
    """{shape: (call, operations, reps)}: each window kernel at the shapes
    `--kernels` times, on `chip_smoke.py`'s seeded inputs, n_sub=64."""
    import functools

    from chip_smoke import DT, df_inputs, fleet_inputs, window_inputs
    from pvderx_torch.ops.dualfloat import rk4_window_batch_df, window_df_ops
    from pvderx_torch.ops.window import (
        fleet_window_ops, rk4_fleet_window_batch, rk4_window_batch, window_ops)

    out = {}
    for preset, seed in (("10", 0), ("50", 50)):
        n_ph, *args = window_inputs(preset, N_ENVS, seed, device)
        out[f"k1_preset{preset}"] = (functools.partial(
            rk4_window_batch, *args, n_ph=n_ph, n_sub=N_SUB, dt=DT),
            window_ops(N_ENVS, n_ph, N_SUB), 50)
    n_ph, *args = fleet_inputs("10", FLEET_ENVS, FLEET_M, 100, device,
                               shade=0.25)
    out["k2_config5"] = (functools.partial(
        rk4_fleet_window_batch, *args, n_ph=n_ph, m=FLEET_M, n_sub=N_SUB,
        dt=DT), fleet_window_ops(FLEET_ENVS, FLEET_M, n_ph, N_SUB), 50)
    for preset, seed in (("10", 0), ("50", 50)):
        n_ph, *args = df_inputs(preset, N_ENVS, seed, device)
        out[f"k3_preset{preset}"] = (functools.partial(
            rk4_window_batch_df, *args, n_ph=n_ph, n_sub=N_SUB, dt=DT),
            window_df_ops(N_ENVS, n_ph, N_SUB), 10)
    return out


def max_clock_mhz() -> float:
    from chip_smoke import _smi

    return float(_smi("clocks.max.sm").split()[0])


def time_kernels(card: str) -> int:
    """The --kernels mode (see the module docstring)."""
    from chip_smoke import _time_ms

    issue_per_s = lane_issue_per_s(at_clock(max_clock_mhz()))
    for shape, (call, ops, reps) in kernel_shapes().items():
        ms = _time_ms(call, reps, "cuda")
        print(json.dumps({
            "card": card, "shape": shape, "n_sub": N_SUB, "reps": reps,
            "ms": ms, "lane_issue_floor_ms": 1e3 * ops / issue_per_s}),
            flush=True)
    return 0


def report_sass(card: str) -> int:
    """The --sass mode (see the module docstring)."""
    from chip_smoke import kernel_name, ptxas_summary
    from pvderx_torch.ops import _build

    so = _build.build()
    regs = ptxas_summary(_build.ptxas_report())
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    loops = {kernel_name(name): lp for name, lp in sass_loops(sass).items()}
    clock = max_clock_mhz()
    shown = set()
    for shape, (call, _, _) in kernel_shapes().items():
        launch = launch_of(call)
        if launch is None or launch["kernel"] not in loops:
            print(json.dumps({"card": card, "shape": shape,
                              "launch": launch}), flush=True)
            continue
        short = launch["kernel"]
        looped, per_substep = sass_per_substep(loops[short])
        shown.add(short)
        print(json.dumps({
            "card": card, "kernel": short, **regs.get(short, {}),
            **loops[short], "shape": shape, "warps": launch["warps"],
            "stages_looped": looped, "sass_per_substep": per_substep,
            "sass_issue_floor_ms": sass_issue_floor_ms(
                per_substep, N_SUB, launch["warps"], clock)}), flush=True)
    for short, lp in loops.items():
        if short not in shown:
            print(json.dumps({"card": card, "kernel": short,
                              **regs.get(short, {}), **lp}), flush=True)
    return 0


def kernel_outputs(path: str, against: str | None) -> int:
    """The --outputs mode (see the module docstring)."""
    import numpy as np
    from chip_smoke import (DT, FLEET_CASES, KERNEL_CASES, df_inputs,
                            fleet_inputs, window_inputs)
    from pvderx_torch.ops.dualfloat import rk4_window_batch_df
    from pvderx_torch.ops.window import rk4_fleet_window_batch, rk4_window_batch

    out = {}
    for i, (name, preset, n, kw) in enumerate(KERNEL_CASES):
        n_ph, y, t0, pp, uu = window_inputs(preset, n, i, "cuda", **kw)
        out[f"k1/{name}"] = rk4_window_batch(y, t0, pp, uu, n_ph=n_ph,
                                             n_sub=N_SUB, dt=DT)
        n_ph, *args = df_inputs(preset, n, i, "cuda", **kw)
        out[f"k3/{name}"] = torch.stack(rk4_window_batch_df(
            *args, n_ph=n_ph, n_sub=N_SUB, dt=DT))
    for i, (name, preset, n, m, kw) in enumerate(FLEET_CASES):
        n_ph, y, t0, pp, uu = fleet_inputs(preset, n, m, 100 + i, "cuda", **kw)
        out[f"k2/{name}"] = rk4_fleet_window_batch(y, t0, pp, uu, n_ph=n_ph,
                                                   m=m, n_sub=N_SUB, dt=DT)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    np.savez(path, **out)
    if against is not None:
        other = np.load(against)
        for key, a in out.items():
            b = other[key]
            print(json.dumps({"case": key, "bitwise_equal": bool(
                np.array_equal(a.view(np.uint32), b.view(np.uint32))),
                "max_abs_diff": float(np.abs(a.astype(np.float64) - b).max())}),
                flush=True)
    return 0


def gate_window(card: str, seeds: list[int]) -> int:
    """The --gate-window mode (see the module docstring)."""
    from pvderx_torch.env import fleet as fleet_env
    from pvderx_torch.learn import gates
    from pvderx_torch.ops.window import (rk4_fleet_window_batch,
                                         rk4_fleet_window_batch_ref)

    for seed in seeds:
        calls, diff, err_k2, err_plain = 0, [], [], []

        def checked(y, t0, p_pack, u_pack, **kw):
            nonlocal calls
            out = rk4_fleet_window_batch(y, t0, p_pack, u_pack, **kw)
            if calls % GATE_EVERY == 0:
                cpu = [a.cpu() for a in (y, t0, p_pack, u_pack)]
                plain = rk4_fleet_window_batch_ref(*cpu, **kw).double()
                f64 = rk4_fleet_window_batch_ref(
                    *(a.double() for a in cpu), **kw)
                k2 = out.cpu().double()
                diff.append(float((k2 - plain).abs().max()))
                err_k2.append(float((k2 - f64).abs().max()))
                err_plain.append(float((plain - f64).abs().max()))
            calls += 1
            return out

        fleet_env.rk4_fleet_window_batch = checked
        try:
            trained, random, margin = gates.gate_fleet_per_unit("cuda", seed)
        finally:
            fleet_env.rk4_fleet_window_batch = rk4_fleet_window_batch
        print(json.dumps({
            "mode": "gate_window", "card": card, "seed": seed,
            "windows": calls, "checked": len(diff),
            "k2_vs_plain_max_abs": max(diff), "k2_vs_f64_max_abs": max(err_k2),
            "plain_vs_f64_max_abs": max(err_plain),
            "k2_vs_f64_mean_of_max": sum(err_k2) / len(err_k2),
            "plain_vs_f64_mean_of_max": sum(err_plain) / len(err_plain),
            "trained": trained, "random": random, "gain": trained - random}),
            flush=True)
    return 0


def jacobian_times(device: str) -> int:
    """``--jacobian``: forward mode vs the complex step (module doc)."""
    import dataclasses
    from functools import partial

    from pvderx_torch.env import core, make_env_config
    from pvderx_torch.ode.implicit import rhs_and_jacobian
    from pvderx_torch.ops.window import P_FIELDS, U_FIELDS, pack_struct
    from pvderx_torch.physics.xp import TorchXP

    where = (torch.cuda.get_device_name(0) if device == "cuda" else
             f"cpu (host), torch {torch.__version__}")
    cfg = make_env_config("10", dtype=torch.float32, n_sub=N_SUB,
                          device=device)
    one = partial(core._rhs_one, n_ph=1, xp=TorchXP(torch.float32, device))
    jac_fwd = torch.func.vmap(torch.func.jacfwd(one))
    for n in (1, 128, N_ENVS):
        st, _ = core.reset(cfg, n, torch.Generator(device=device).manual_seed(0))
        t0 = torch.zeros(n, device=device)
        _, exog, _, _ = core._pre_window(
            cfg, st, torch.zeros(n, dtype=torch.int64, device=device))
        exog = dataclasses.replace(exog, v_g=exog.v_g * 0.5)
        pk = pack_struct(st.der, P_FIELDS).T
        uk = pack_struct(exog, U_FIELDS).T
        calls = {
            "jacfwd": lambda: jac_fwd(st.y, pk, uk),
            "complex_step": lambda: rhs_and_jacobian(
                lambda yy: core._rhs(yy, t0, st.der, exog), st.y)[1],
            "plain_rhs": lambda: core._rhs(st.y, t0, st.der, exog),
        }
        ms, out = {}, {}
        for name, fn in calls.items():
            out[name] = fn()
            if device == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(10):
                fn()
            if device == "cuda":
                torch.cuda.synchronize()
            ms[name] = 1e3 * (time.perf_counter() - t) / 10
        a, b = out["jacfwd"].double(), out["complex_step"].double()
        print(json.dumps({"jacobian": where, "n_envs": n, "ms": ms,
                          "max_rel_diff": float((a - b).abs().max()
                                                / b.abs().max()),
                          "jacfwd_dtype": str(out["jacfwd"].dtype)}),
              flush=True)
    return 0


def _launch_and_kernel_events(events):
    """(kernel-launch runtime events, kernel events) of a chrome trace, each
    by its correlation id."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime" and "Launch" in e.get(
                    "name", "") and "correlation" in e.get("args", {})}
    kernels = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "kernel" and "correlation" in e.get(
                   "args", {})}
    return launches, kernels


def trace_edges(card: str, reps: int) -> int:
    """``--trace-edges REPS``: whether a `torch.profiler` trace keeps every
    kernel of a block that starts right after the profiler does. Three
    main-path steps (32768 envs, n_sub=64) are traced ``reps`` times each
    way, in turns: "plain", `torch.profiler.profile` around the steps, and
    "guarded", `diag.profiler.trace` (the steps between idle guards). Per
    trace, a kernel launch (a runtime launch event) whose kernel event is
    missing is dropped; one JSON line per way: the traces with a drop, the
    drops, how late the latest dropped launch came after the first launch
    (ms), K1's traced count per trace (3 launched)."""
    from torch.profiler import tensorboard_trace_handler

    from pvderx_torch.diag.profiler import trace, trace_events
    from pvderx_torch.env import make_batch_fns, make_env_config

    cfg = make_env_config("10", dtype=torch.float32, n_sub=N_SUB,
                          device="cuda")
    reset_batch, step_batch = make_batch_fns(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, _ = reset_batch(N_ENVS, gen)
    a = torch.zeros(N_ENVS, dtype=torch.int64, device="cuda")

    def steps(st):
        for _ in range(3):
            st = step_batch(st, a, gen)[0]
        return st

    def plain(d):
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       on_trace_ready=tensorboard_trace_handler(
                           d, use_gzip=True))

    state = steps(state)
    torch.cuda.synchronize()
    out = {w: dict(traces=0, with_drops=0, drops=0, latest_drop_ms=0.0,
                   k1_traced=[]) for w in ("plain", "guarded")}
    for r in range(reps):
        for way in (("plain", "guarded") if r % 2 == 0
                    else ("guarded", "plain")):
            with tempfile.TemporaryDirectory() as d:
                with (plain(d) if way == "plain" else trace(d)):
                    state = steps(state)
                    torch.cuda.synchronize()
                launches, kernels = _launch_and_kernel_events(
                    trace_events(d))
            first = min(e["ts"] for e in launches.values())
            lost = [e for c, e in launches.items() if c not in kernels]
            o = out[way]
            o["traces"] += 1
            o["with_drops"] += bool(lost)
            o["drops"] += len(lost)
            if lost:
                o["latest_drop_ms"] = max(o["latest_drop_ms"], max(
                    (e["ts"] - first) / 1e3 for e in lost))
            o["k1_traced"].append(sum(
                1 for e in kernels.values() if "window_kernel" in e["name"]))
    for way, o in out.items():
        print(json.dumps({"card": card, "trace_edges": way,
                          "launches_per_trace": len(launches), **o}),
              flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--fleet", action="store_true")
    mode.add_argument("--df", action="store_true")
    mode.add_argument("--sass", action="store_true")
    mode.add_argument("--kernels", action="store_true")
    mode.add_argument("--outputs", metavar="FILE")
    mode.add_argument("--gate-window", metavar="SEED", type=int, nargs="+")
    mode.add_argument("--jacobian", choices=("cuda", "cpu"))
    mode.add_argument("--trace-edges", metavar="REPS", type=int)
    ap.add_argument("--against", metavar="OTHER")
    args = ap.parse_args()
    if args.against and not args.outputs:
        ap.error("--against needs --outputs")
    if args.jacobian == "cpu":
        return jacobian_times("cpu")
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device is available", file=sys.stderr)
        return 1
    from pvderx_torch.env import (
        fleet_rollout, make_batch_fns, make_batch_fns_df, make_env_config,
        make_fleet_batch_fns, make_fleet_config, rollout, rollout_df)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if args.sass:
        return report_sass(card)
    if args.kernels:
        return time_kernels(card)
    if args.outputs:
        return kernel_outputs(args.outputs, args.against)
    if args.gate_window:
        return gate_window(card, args.gate_window)
    if args.jacobian:
        return jacobian_times("cuda")
    if args.trace_edges:
        return trace_edges(card, args.trace_edges)
    path = "fleet" if args.fleet else "df" if args.df else "single"
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

    t = time.perf_counter()
    state, obs, r, _ = roll(cfg, state, obs, policy, TIMED, gen)
    float(r.sum())
    untraced_ms = 1e3 * (time.perf_counter() - t) / TIMED

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
        "untraced_steps": TIMED, "untraced_ms_per_step": untraced_ms,
        "env_steps_per_s": 1e3 * n_envs / untraced_ms,
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
