#!/usr/bin/env python3
"""Drive pvderx_torch's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, one line each (a failing phase raises, so the script exits non-zero):

1. device   — the card's name and power limit (nvidia-smi).
2. build    — nvcc builds the kernels (K1-K3, N1-N4, the autoreset, the
              pre- and post-window glue) from pvderx_torch/ops/csrc/ (one
              nvcc per source, in parallel) and reports each kernel's
              registers and spills.
3. kernel   — the CUDA window kernel (K1) against its plain torch version on the
              same seeded inputs (presets 10 and 50, const-Vdc, unbalanced
              3-phase, disconnect/cessation, a ragged N): max abs error
              <= 5e-6 per window.
4. gate     — the f32 accuracy gate: the gate scenario rolled through the
              kernel at preset 10, n_sub=64, against the float64 LSODA
              truth: max abs error <= 4e-6.
5. main     — the batched env at full width (preset 10, f32, n_sub=64,
              32768 envs, zero-action policy): reset, a warm-up chunk and two
              timed chunks of 600 steps (the best counts); the kernel's
              launch count must equal the steps taken, obs/reward finite,
              episodes done; K1 and its plain version ms per call at the
              main path's inputs, and K1 at preset 50 (three-phase), 32768
              envs, n_sub=64, on `window_inputs`.
6. linear   — two chained chunks take 1.5-2.7x one chunk (the timing syncs).
7. fleet_kernel — the CUDA fleet window kernel (K2) against its plain
              version: config 5's shape (N=4096, M=16, insolation spread),
              preset 50 unbalanced at M=4, per-unit disconnect/cessation, a
              ragged N=1000 at M=3, M=40 (more than a warp), M=300 (more
              than 256 threads per env) and M=1: max abs error <= 5e-6 per
              window, one launch each; at M=1 it must equal K1 bit for bit.
8. fleet_gate — the f32 fleet kernel vs the coupled float64 LSODA truth on
              the fleet gate scenario (M=16, n_sub=64, 36 windows): <= 4e-6.
9. fleet_main — BASELINE config 5 at full width (preset 10, f32, n_sub=64,
              4096 envs x 16 units, aggregate mode, random actions): reset,
              warm-up, best of two 600-step chunks, the linearity check, K2
              launches == steps; then 60 per-unit steps ([N, 13+4M] obs).
10. df_kernel — the CUDA df32 window kernel (K3) against its plain df32
              version on the six cases of phase 3 and two ragged ones, N=37
              at preset 10 and at preset 50 unbalanced (a partial warp; for
              the two-lane team of the three-phase kernel, a partial team
              block), each with a seeded nonzero y_lo (~1e-9 relative): the
              32768-env case at the main path's n_sub=64, the others at
              n_sub=8 with dt=DT*8/64 (the main path's h; the plain version
              is tens of thousands of tiny torch kernels per RHS
              evaluation): hi + lo equal bit for bit (max abs error 0.0),
              one launch each, every output |lo| <= ulp(hi)/2.
11. df_f64  — K3 against the float64 RK4 window (the oracle's
              `rk4_window_np`) on the six cases at 4 envs each, n_sub=64,
              the same f32-rounded inputs, lo = 0 on input: <= 1e-10. The f32
              kernel (K1) on the same inputs must miss that bound: this
              phase, not the gate, tells the tiers apart.
12. df_gate — K3 on the gate scenario at presets 10 and 50, n_sub=64, and
              at preset 50, n_sub=80 (the reference's setting, its figure
              printed beside), lo carried from 0, against the float64 LSODA
              truth: <= 1e-6 (the tier's contract; RK4's truncation error
              dominates it, so K1 reads about the same).
13. df_main — the df32 tier (`make_batch_fns_df`) at full width (preset 10,
              f32, n_sub=64, 32768 envs, zero-action policy): reset,
              warm-up, best of two 600-step chunks, the linearity check; K3
              launches == steps, obs/reward finite, episodes done, y_lo
              alive; K3 and K1 ms per call at the same inputs and n_sub, the
              plain df32 version's from df_kernel's 32768-env case (the same
              shapes and n_sub); K3 at preset 50 (three-phase), 32768 envs,
              n_sub=64, on `df_inputs`.
14. ppo_main — PPO (`pvderx_torch.learn`) on the single-DER env at the
              reference's learner benchmark config (preset 10, f32,
              n_sub=64, 16384 envs, rollout 16, 4 epochs x 4 minibatches,
              hidden (128, 128)): reset, one warm-up and 5 timed train
              steps; env-steps/s, the collect/update split (CUDA events),
              loss, entropy and reward_mean finite; K1 launches == env
              steps (16 per train step).
15. fleet_ppo — PPO on BASELINE config 5 (2048 envs x 16 units, aggregate),
              then in per-unit mode (obs 13 + 64, the factored 16 x 5
              head): warm-up + 5 timed train steps each; K2 launches ==
              env steps in each.
16. dqn_main — DQN at 4096 envs (rollout 4, 4 updates of batch 1024,
              capacity 262144): warm-up + 5 timed train steps through K1.
17. sac_main — SAC on the continuous env at the same widths through K1.
18. learn_gates — the four seeded gates of tests/test_learning.py with the
              port's learners (same tasks, budgets, hidden (32, 32) and
              margins): PPO on the config-3 anomaly task > random + 0.02,
              DQN > random + 0.012, SAC (dq 0.15 / dv 0.06) > random +
              0.015, per-unit fleet PPO at M = 4 > uniform + 0.008; a miss
              raises once all four have printed.
19. implicit — the implicit windows (`ode.implicit`; torch calls, no kernel)
              in float32 on the card, 128 envs of preset 10 through the
              90-window sag of tests/test_variants.py:84-107 against the
              float64 LSODA truth: trapezoid at n_sub 10 and 20, backward
              Euler at 40, each <= the reference test's bound (5e-6, 1e-6,
              5e-5) + GATE_TOL; then the env with each scheme at n_sub 16 on
              the sag scenario (32768 envs, one 60-step horizon through
              `rollout`): ms per step, env-steps/s, device operations per
              step (the profiler, one step), peak MiB; K1 never launches.
20. fleet_implicit — the trapezoidal fleet (M = 16, the stacked 176-unknown
              system per env, n_sub 16, 512 envs) from one float64 reset,
              20 steps through a shallow sag in float32 and in float64: the
              states within FLEET_IMPLICIT_TOL; ms per step, peak MiB; K2
              never launches; then one float32 step at 4096 envs (ms, peak
              MiB).
21. gym     — the Gymnasium adapters (with or without gymnasium installed;
              the line says which): `PVDERVectorEnv` at 32768 envs for a
              600-step horizon (SAME_STEP autoreset, final_obs checked on
              every step, K1 once per step, env-steps/s beside main's);
              `PVDEREnv` 60 steps; `PVDERFleetEnv` (M = 16) aggregate then
              per-unit, 60 steps each (K2 once per step).
22. sim     — `DynamicSimulation("10")` in float32 (n_sub 120) on the
              schedule of tests/test_sim_diag.py:14-22 (180 windows, K1 once
              each) against the float64 LSODA trajectory: <= GATE_TOL; the
              integrator knob (trapezoid@16 vs RK4@72 within 2e-2 on Vdc);
              float64 with RK4 on the card raises.
23. config  — every packaged `env_*.json` through `load_env_config` on the
              card: reset 1024 envs, 10 steps through K1.
24. diag_profiler — `diag.profiler.trace` of 3 main-path steps (32768
              envs), one config-5 fleet step and one df32 step;
              `device_op_summary` must count K1 = 3, K2 = 1, K3 = 1; the
              main step's env-steps/s by `Stopwatch` beside phase 5's.
25. diag_debug — `diag.debug.checked_step` passes a clean 32768-env state
              (one K1 launch) and names the env of an injected NaN;
              `debug_mode` passes a clean step and traps a NaN fed to K1,
              naming the kernel; the grad guard raises for K1, K2 and K3
              inputs that require grad, before any launch.
26. diag_checkpoint — `diag.checkpoint` save / restore of PPO (16384
              envs), DQN and SAC (4096): a runner restored into one built
              from another seed trains on bitwise equal to the original.
27. grad    — tests/test_grad.py's loss on the card through the eager
              window in float64: autograd within 1e-5 of a central finite
              difference, 5 gradient steps lower it; the float32 gradient;
              one value_and_grad of `examples.gain_tuning` at 12 windows,
              and at its default 60 where that scales to <= 120 s.
28. examples — the four `pvderx_torch.examples` as subprocesses, started
              together: each exits 0; K1 / K2 launches as their arguments
              give. Phase 34's examples run beside them, and the world-2
              and world-4 ranks of phases 29-33 start then, each job held
              at a gate until its inputs are written.

29-34. the distributed layer (`pvderx_torch.dist`, `run_dist`): world 1 in
              this process on NCCL, world 2 and world 4 as gloo ranks that
              share the card (`python -m pvderx_torch.dist.launch`, each rank
              `python -m chip_smoke --dist-worker`); every line names its
              backend and world size.
    dist_env — world 1: the single-DER env at full width (32768 envs, preset
              10, f32, n_sub 64, one 600-step horizon: truncation and
              autoreset fire) through `rollout(mesh=)` equals the un-meshed
              rollout from the same generator seed bit for bit, and the
              meshed reset the un-meshed one; world 2 (2 x 16384), started
              from slices of world 1's reset with its generator state: obs,
              reward, done and y bitwise equal to world 1's; each rank's own
              reset of its 16384 envs against world 1's within 1e-4 (the
              batched solve may change algorithm with the batch size); then
              the fleet (config 5, 2048 x 16, 60 steps, K2) and df32 (60
              steps, K3) alike. Launches per rank == steps.
    dist_ppo — PPO at the learner benchmark width (16384 envs, rollout 16,
              4 x 4, hidden 128²): one train step at world 2 from world 1's
              runner against world 1's step, params within 1e-5, reward_mean
              within 1e-6, the replicas bitwise equal across the ranks; 5
              timed train steps at each world size (env-steps/s), the
              all-reduces' share of one update; fleet PPO (2048 x 16,
              aggregate) for 3 timed steps at world 2.
    dist_offpolicy — DQN and SAC at 4096 envs (rollout 4, 4 updates of 1024,
              capacity 262144) alike: world 2 against world 1 within 1e-5,
              replicas bitwise, 3 timed train steps each.
    dist_tp — PPO on the (env=1, model=2) and (env=2, model=2) meshes from
              `shard_runner_tp` of world 1's runner against world 1's DP-only
              step: loss and params within rtol 1e-5 / atol 1e-6
              (tests/test_tp.py:69-74); Dense_0's weight and its Adam moment
              half on each model rank; the TP train step timed.
    dist_checkpoint — a world-2 PPO runner saved (`diag.checkpoint` over the
              mesh), restored into one built from another seed, both trained
              a step: bitwise equal; a DP checkpoint (env axis 2) restored
              onto (env=2, model=2) continues with the loss and params
              bitwise equal to `shard_runner_tp` of the saved runner, and
              onto a 1-D mesh of 4 env ranks raises.
    dist_examples — `train_ppo --tp 2`, `train_dqn` and `train_sac` as 2 ranks
              each, started together: each exits 0 and launches K1 as its
              arguments give on every rank.
              Then one line with the seconds of each part (a job's from
              its gate; the examples' from their start, beside phase 28).
35. notebooks — once phases 28-34 have ended and their ranks have stopped:
              the demo notebooks' compute cells
              (`python -m pvderx_torch.examples.notebooks.run_cells`, a
              subprocess) at the reference notebooks' sizes, the standalone
              simulation (preset 50, 12 s, 720 windows) and the training
              notebook (a 120-step gym rollout, DQN 60 updates, PPO 60 plus
              a 320-step random baseline, SAC 300 plus its baseline, the
              export): every cell's K1 launches == its env steps, each
              notebook's steps as its sizes give, the learners' metrics
              finite, the exported numpy policy's actions equal to the torch
              net's argmax on the same observations. The plot cells do not
              run.

36. native — the float64 engine (`pvderx_torch.native`, the port of
              pvderx_native.cpp; kernels N1-N4 of csrc/native.cu), on its
              own after phase 35: N4 (the RHS) against its plain version
              and the numpy oracle at presets 10, 50, 250 (eventful exog,
              25 states) and tripped / const-Vdc, <= 1e-12 (rtol and atol);
              N1 (the Kahan RK4 window) at preset 10, 32768 envs, n_sub 64
              against the plain float64 window, <= 1e-12; on phase 11's
              cases against `oracle.rk4_window_np`, <= 1e-10, K3's and K1's
              errors beside; ms per launch of N1, K1 and K3 at presets 10
              and 50 on the same inputs; the public batch bit for bit its
              one-env calls; N2 (adaptive DP5(4)) on the 12-window 0.6 pu
              sag at presets 10 and 50 against LSODA per window, <= 1e-8,
              its accepted steps beside the plain version's and ms per
              window, then one window at 32768 envs (ms, steps, the warps'
              efficiency); N3 (Newton) `steady_state` at presets 10 and 50
              against fsolve, <= 1e-9, residual < 1e-9, and 32768 envs
              against the plain version beside the reset's Newton
              (`env.core.steady_state`); then the public path with the
              counters at 0 (`steady_state`, `rhs`, `rk4_window`,
              `rk4_window_batch` at 32768 envs, `run_trajectory` over
              tests/test_native.py's 30 windows, < 5e-8 of LSODA): each
              kernel once per call.

37. autoreset — the env step's autoreset kernel (`ops.autoreset`,
              csrc/autoreset.cu, through `env.core.restart_done`) against
              the plain version (`_soft_reset`, then `autoreset`'s select)
              on a stepped batch: presets 10 and 50 (50 with unbalanced
              sags drawn), float32 (K1's step) and float64 (a trapezoid
              step), a ragged N = 37 and 32768 envs, no env done, one, a
              random 1% and all; every leaf of the state and the obs, and
              in float32 the df32 tier's y_lo, bit for bit equal, one
              launch each; no leaf of the input state and nothing the step
              returned (reward, done, info) changed. Then ms per launch at
              2097152 envs (one env in 600 done) beside its bytes bound and
              the plain version's ms. Phases 5, 13 and 21 require one
              autoreset launch per env step.

38. post_window — the env step's post-window kernel (`ops.post_window`,
              csrc/post_window.cu, through `env.core._post_window`) against
              the plain version (`_post_window_plain`) on one step's
              inputs forced across every threshold the step tests (each
              ride-through zone, trips, the horizon, the anomaly reward's
              events): presets 10 and 50, float32 and float64, the anomaly
              reward on and off, the ride-through enabled and disabled, a
              ragged N = 37 and 32768 envs; done, terminated, truncated,
              the trip latch, trip_now, the cessation flag, the timers and
              t_step equal, the floats bit for bit at preset 10 (one phase)
              and at preset 50 within 1e-6 of each leaf's largest
              magnitude (torch's reduction orders the three-phase means),
              the state's y, info["vdc"] and info["tripped"] the same
              tensors as the plain version's, one launch each, no input
              changed. Then ms per launch at 2097152 envs (device time:
              the calls queue behind a device sleep) beside its bytes
              bound, the plain version's ms and the kernel's registers and
              spills. Phases 5, 13 and 21 require one post-window launch
              per env step.

39. pre_window — the env step's pre-window kernel (`ops.pre_window`,
              csrc/pre_window.cu, through `env.core._pre_window`) against
              the plain version (`_pre_window_plain`) on states pushed
              across every branch it tests (the setpoints into both
              clamps, steps at exactly an event row's time, every Volt-VAR
              segment, both P&O directions, a -0 in an active table row
              and a NaN in an inactive one): presets 10 and 50, float32
              and float64, discrete actions, the anomaly flag, continuous
              actions, Volt-VAR, MPPT and both, a ragged N = 37 and 32768
              envs; t, the 15 exog rows, the MPPT state and the flag bit
              for bit, but the Volt-VAR setpoint at preset 50 within 1e-6
              of its largest magnitude (torch's reduction orders the
              three-phase mean it reads); the exog the kernel's pack's
              rows, one launch each, no input changed. Then ms per launch
              at 2097152 envs (device time: the calls queue behind a
              device sleep) beside its bytes bound, the plain version's ms
              (with the exog pack) and the kernel's registers and spills.
              Phases 5, 13 and 21 require one pre-window launch per env
              step.

Every line carries `at_s`, the seconds since the script started. The
float64 LSODA truths of phases 4, 8, 12, 19, 22 and 36 run in worker
processes from the start (`prefetch_truths`), beside the build and the
first phases.

A phase that fails ends the run: one line ``[failed] {"phase": ...,
"error": "<type>: <message>", "at_s": ...}`` names it (the phase begun last,
`begin`), the traceback goes to stderr, and the script exits 1. A
subprocess of phases 28-35 that outlives its timeout is stopped, and the
error names the phase, the job and the end of its stderr (`wait_for`).

Then `[total]`, the kernel table as one JSON line (K1-K3 each with its
bound and its lane-issue bound from `pvderx_torch.diag.roofline`:
operations / (132 SMs * 128 FP32 lanes * max SM clock), and the launches of
the learner phases and of phases 19-35; N1-N4 with their float64 bounds,
`roofline.native_bound_ms`, at 32768 envs), the card line, and the device
line.
Needs one CUDA card; imports torch, numpy, scipy and pvderx_torch only
(gymnasium if installed).
"""
from __future__ import annotations

import concurrent.futures
import functools
import json
import multiprocessing
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_TOL = 5e-6        # kernel vs plain, one window, f32
GATE_TOL = 4e-6          # f32 kernel vs float64 LSODA truth, gate scenario
# df32 kernel vs float64 RK4, one window: the df32 noise reads ~1e-13 and
# the f32 kernel's ~1e-7 at these inputs (CPU rehearsal of the plain versions)
DF_F64_TOL = 1e-10
DF_GATE_TOL = 1e-6       # df32 kernel vs float64 LSODA truth, gate scenario
DF_CHECK_SUB = 8         # substeps of the df32 comparisons, at the main h
N_ENVS = 32768
FLEET_ENVS, FLEET_M = 4096, 16   # BASELINE config 5
N_SUB = 64
# (preset, n_sub) of the df32 gate: both presets at the main path's n_sub,
# and preset 50 at n_sub=80, the setting of the reference's figure
# (benchmarks/DUALFLOAT.json df32_max_abs_err_preset50, measured by
# benchmarks/dualfloat_study.py at "preset 50 at its n_sub=80 knee")
DF_GATE_CASES = (("10", N_SUB), ("50", N_SUB), ("50", 80))
DF_GATE_REFERENCE = {("50", 80): 3.228964920998223e-07}
WARM_STEPS = 60
CHUNK_STEPS = 600        # = the episode horizon: truncation and autoreset fire
DT = 1.0 / 60.0


_T0 = time.perf_counter()
# the phase begun last (`begin`), which a failure names
_CURRENT = {"phase": "device"}


def begin(name: str) -> None:
    """Record that phase ``name`` starts: a failure from here on names it."""
    _CURRENT["phase"] = name


def phase(name: str, **kv):
    """One line ``[name] {json}``; ``at_s`` is the seconds since the script
    started, so consecutive lines give each phase's share of the run."""
    kv["at_s"] = time.perf_counter() - _T0
    print(f"[{name}] " + json.dumps(kv), flush=True)


def failed(exc: BaseException) -> None:
    """The one stdout line of a failed run, naming the phase begun last;
    the traceback goes to stderr."""
    import traceback

    traceback.print_exception(exc)
    sys.stderr.flush()
    print("[failed] " + json.dumps({
        "phase": _CURRENT["phase"],
        "error": f"{type(exc).__name__}: {exc}"[:4000],
        "at_s": time.perf_counter() - _T0}), flush=True)


def wait_for(proc, job: str, timeout: float):
    """``proc.communicate(timeout=...)``: (stdout, stderr). A process that
    outlives ``timeout`` is interrupted (a rank launcher then stops its
    ranks), killed if it lingers, and a `TimeoutError` names the current
    phase, the job and the end of its stderr."""
    import signal

    try:
        return proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGINT)
        try:
            _, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        raise TimeoutError(
            f"phase {_CURRENT['phase']}: {job} did not end within "
            f"{timeout:g} s; the end of its stderr:\n{(err or '')[-3000:]}"
        ) from None


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_ms(fn, reps: int, device, ahead: bool = False) -> float:
    """Device time per call by CUDA events around ``reps`` calls, each end
    synced by `diag.profiler.force_sync` of a call's output. With
    ``ahead``, the calls queue behind a ~50-ms device sleep, so that the
    host has enqueued them all before the first runs: the events then time
    the device even where a call's host work outlasts its kernel."""
    from pvderx_torch.diag.profiler import force_sync

    force_sync(fn())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if ahead:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    force_sync(out)
    return start.elapsed_time(end) / reps


def _timed(fn, device):
    """(fn(), its device ms by CUDA events around the one call; None off
    the card)."""
    if torch.device(device).type != "cuda":
        return fn(), None
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def window_inputs(preset, n, seed, device, p_over=None, u_over=None,
                  disconnect=False):
    """Seeded numpy inputs of one window: states near the steady state,
    per-env jitter of grid resistance and insolation, random t0."""
    import dataclasses

    from pvderx_torch import make_params, nominal_exog, oracle
    from pvderx_torch.ops.window import P_FIELDS, U_FIELDS

    rng = np.random.default_rng(seed)
    p = make_params(preset, **(p_over or {}))
    u = dataclasses.replace(nominal_exog(), **(u_over or {}))
    y0 = oracle.steady_state(p, u)
    y = y0[None, :] + 1e-3 * rng.standard_normal((n, p.n_states))
    t0 = rng.uniform(0.0, 1.0, n)
    pp = np.array([np.full(n, getattr(p, f)) for f in P_FIELDS])
    uu = np.array([np.full(n, getattr(u, f)) for f in U_FIELDS])
    pp[P_FIELDS.index("rg")] *= 1.0 + 0.2 * rng.uniform(-1.0, 1.0, n)
    uu[U_FIELDS.index("s_irr")] *= 1.0 + 0.2 * rng.uniform(-1.0, 1.0, n)
    if u.v_g2 > 0.0:
        uu[U_FIELDS.index("phi_g2")] = rng.uniform(0.0, 2.0 * np.pi, n)
    if disconnect:
        conn = (rng.uniform(size=n) < 0.5).astype(float)
        uu[U_FIELDS.index("conn")] = conn
        uu[U_FIELDS.index("ces")] = conn * (rng.uniform(size=n) < 0.5)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return p.n_ph, f(y), f(t0), f(pp), f(uu)


KERNEL_CASES = [
    # (name, preset, N, kwargs of window_inputs)
    ("preset10_main", "10", N_ENVS, {}),
    ("preset50", "50", 4096, {}),
    ("const_vdc", "50", 2048, dict(p_over=dict(const_vdc=1.0),
                                    u_over=dict(p_ref=0.6))),
    ("unbalanced_3ph", "50", 2048, dict(u_over=dict(v_g2=0.15))),
    ("disconnect_cessation", "10", 4096, dict(disconnect=True)),
    ("ragged_n1000", "10", 1000, {}),
]


def check_kernel(device, cases=KERNEL_CASES, n_sub=N_SUB):
    """Phase 3: kernel vs plain on every case. Returns the max error."""
    from pvderx_torch.ops.window import rk4_window_batch, rk4_window_batch_ref

    worst = 0.0
    for i, (name, preset, n, kw) in enumerate(cases):
        n_ph, y, t0, pp, uu = window_inputs(preset, n, i, device, **kw)
        before = rk4_window_batch.launches
        out = rk4_window_batch(y, t0, pp, uu, n_ph=n_ph, n_sub=n_sub, dt=DT)
        ref = rk4_window_batch_ref(y, t0, pp, uu, n_ph=n_ph, n_sub=n_sub, dt=DT)
        _sync(device)
        err = float((out - ref).abs().max())
        moved = rk4_window_batch.launches - before
        phase("kernel", case=name, n=n, n_ph=n_ph, max_abs_err=err,
              tol=KERNEL_TOL, launches=moved)
        if not (np.isfinite(err) and err <= KERNEL_TOL):
            raise AssertionError(f"kernel vs plain {name}: {err:.3e} > {KERNEL_TOL}")
        if torch.device(device).type == "cuda" and moved != 1:
            raise AssertionError(f"launch counter moved by {moved}, not 1")
        worst = max(worst, err)
    return worst


def require_bitwise(what: str, err: float) -> None:
    """Raise unless ``err`` reads exactly 0.0: a kernel held bit for bit to
    another (K2 at M=1 to K1, K3 to its plain df32 version)."""
    if err != 0.0:
        raise AssertionError(f"{what}: {err!r}, not bitwise equal (0.0)")


# The float64 LSODA truths of the gate, fleet gate, sag and sim phases run
# on the host alone. `prefetch_truths` starts them in worker processes
# while the kernels build; `_truth` takes a started one's result, or
# computes it here.
TRUTH_KEYS = (("gate", "10", 120), ("gate", "50", 120),
              ("fleet_gate", FLEET_M, 36), ("sag", 90), ("sim", 180),
              ("native_trajectory", 30))
_TRUTH_JOBS = {}


def _truth_job(key):
    """(float64 LSODA trajectory of ``key``'s scenario, seconds it took)."""
    from pvderx_torch import make_params, oracle

    kind, *args = key
    p = make_params(args[0] if kind == "gate" else "10")
    t = time.perf_counter()
    if kind == "gate":
        truth = oracle.run_trajectory(p, oracle.gate_scenario_exogs(args[1]))
    elif kind == "fleet_gate":
        truth = oracle.run_fleet_trajectory(
            *oracle.fleet_gate_scenario(p, *args))
    elif kind == "sag":
        truth = oracle.run_trajectory(p, [_sag_exog(k) for k in range(*args)])
    elif kind == "native_trajectory":
        truth = oracle.run_trajectory(p, _native_trajectory_exogs(*args))
    else:
        truth = oracle.run_trajectory(p, _sim_exogs(*args))
    return truth, time.perf_counter() - t


def prefetch_truths(pool, keys=TRUTH_KEYS):
    """Start each truth of ``keys`` on ``pool`` (a process pool)."""
    for key in keys:
        _TRUTH_JOBS[key] = pool.submit(_truth_job, key)


@functools.cache
def _truth(*key):
    job = _TRUTH_JOBS.pop(key, None)
    return job.result() if job is not None else _truth_job(key)


def check_gate(device, n_steps=120, n=128, n_sub=N_SUB):
    """Phase 4: the f32 kernel vs the float64 LSODA truth on the gate
    scenario (preset 10)."""
    from pvderx_torch import make_params, oracle
    from pvderx_torch.ops.window import P_FIELDS, U_FIELDS, rk4_window_batch

    p = make_params("10")
    exogs = oracle.gate_scenario_exogs(n_steps)
    truth, truth_s = _truth("gate", "10", n_steps)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    pp = f([np.full(n, getattr(p, k)) for k in P_FIELDS])
    y = f(np.broadcast_to(truth[0], (n, p.n_states)))
    err = 0.0
    for k, u in enumerate(exogs):
        uu = f([np.full(n, getattr(u, name)) for name in U_FIELDS])
        y = rk4_window_batch(y, f(np.full(n, k * DT)), pp, uu, n_ph=p.n_ph,
                             n_sub=n_sub, dt=DT)
        err = max(err, float((y.double().cpu() - torch.from_numpy(
            truth[k + 1])).abs().max()))
    phase("gate", preset="10", n_sub=n_sub, windows=n_steps,
          max_abs_err=err, bound=GATE_TOL, lsoda_truth_s=truth_s)
    if not err <= GATE_TOL:
        raise AssertionError(f"f32 gate {err:.3e} > {GATE_TOL}")
    return err


def _zero_counts():
    """Set every kernel's launch count to 0 (just before a path is driven)."""
    from pvderx_torch.ops.dualfloat import rk4_window_batch_df
    from pvderx_torch.ops.window import rk4_fleet_window_batch, rk4_window_batch

    from pvderx_torch.ops.autoreset import autoreset_batch
    from pvderx_torch.ops.post_window import post_window_batch
    from pvderx_torch.ops.pre_window import pre_window_batch

    rk4_window_batch.launches = 0
    rk4_fleet_window_batch.launches = 0
    rk4_window_batch_df.launches = 0
    autoreset_batch.launches = 0
    post_window_batch.launches = 0
    pre_window_batch.launches = 0


def _drive(roll, state, obs, warm, chunk):
    """A warm-up chunk, the best of two timed chunks, then the sync
    linearity check: two chained chunks under one scalar-fetch sync.
    ``roll(state, obs, n_steps) -> (state, obs, rewards, dones)``."""
    state, obs, rews, _ = roll(state, obs, warm)
    float(rews.sum())
    out = dict(steps=warm, chunk_s=float("inf"), dones=0, finite=True)
    for _ in range(2):                   # best of two timed chunks
        t = time.perf_counter()
        state, obs, rews, dones = roll(state, obs, chunk)
        out["rew_sum"] = float(rews.sum())   # scalar fetch: the sync
        out["chunk_s"] = min(out["chunk_s"], time.perf_counter() - t)
        out["steps"] += chunk
        out["dones"] += int(dones.sum())
        out["finite"] &= (bool(torch.isfinite(obs).all())
                          and bool(torch.isfinite(rews).all()))
    for _ in range(2):
        t = time.perf_counter()
        state, obs, r1, _ = roll(state, obs, chunk)
        state, obs, r2, _ = roll(state, obs, chunk)
        float(r1.sum() + r2.sum())
        out["steps"] += 2 * chunk
        out["ratio"] = (time.perf_counter() - t) / out["chunk_s"]
        if 1.5 <= out["ratio"] <= 2.7:
            break
    return state, obs, out


def _check_drive(name, out, launches, cuda, **glue):
    """A drive's checks; ``glue``: the launches of the env step's glue
    kernels by name (``autoreset``, ``post_window``, ``pre_window``), each
    of which must equal the steps as the window kernel's do."""
    if launches != out["steps"] and cuda:
        raise AssertionError(
            f"{name}: kernel launches {launches} != steps {out['steps']}")
    for kernel, n in glue.items():
        if n != out["steps"] and cuda:
            raise AssertionError(f"{name}: {kernel} launches {n} != steps "
                                 f"{out['steps']}")
    if not out["finite"]:
        raise AssertionError(f"{name}: non-finite obs or reward")
    if out["dones"] == 0:
        raise AssertionError(f"{name}: no episode finished in the timed chunks")
    if not 1.5 <= out["ratio"] <= 2.7:
        raise AssertionError(
            f"{name}: sync linearity {out['ratio']:.2f} outside 1.5-2.7")


def _reset_timed(reset_batch, n_envs, gen):
    t = time.perf_counter()
    state, obs = reset_batch(n_envs, gen)
    init_res_max = float(state.init_res.max())
    reset_s = time.perf_counter() - t
    if not np.isfinite(init_res_max):
        raise AssertionError(f"reset residual not finite: {init_res_max}")
    return state, obs, reset_s, init_res_max


def run_main(device, card, n_envs=N_ENVS, n_sub=N_SUB, warm=WARM_STEPS,
             chunk=CHUNK_STEPS):
    """Phases 5 and 6: the batched env at full width through the kernel."""
    from pvderx_torch.env import make_batch_fns, make_env_config, rollout
    from pvderx_torch.ops.autoreset import autoreset_batch
    from pvderx_torch.ops.post_window import post_window_batch
    from pvderx_torch.ops.pre_window import pre_window_batch
    from pvderx_torch.ops.window import (
        P_FIELDS, U_FIELDS, pack_struct, rk4_window_batch,
        rk4_window_batch_ref)
    from pvderx_torch.env import core

    cuda = torch.device(device).type == "cuda"
    cfg = make_env_config("10", dtype=torch.float32, n_sub=n_sub,
                          device=device)
    reset_batch, _ = make_batch_fns(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    policy = lambda obs, g: torch.zeros(obs.shape[0], dtype=torch.int64,
                                        device=obs.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    _zero_counts()
    state, obs, reset_s, init_res_max = _reset_timed(reset_batch, n_envs, gen)
    state, obs, out = _drive(
        lambda s, o, k: rollout(cfg, s, o, policy, k, gen), state, obs, warm,
        chunk)
    launches = rk4_window_batch.launches
    ar_launches = autoreset_batch.launches
    pw_launches = post_window_batch.launches
    pre_launches = pre_window_batch.launches
    peak_mib = (torch.cuda.max_memory_allocated(device) / 2 ** 20
                if cuda else None)

    # the kernel alone at the main path's shapes, beside its plain version
    t_win, exog, *_ = core._pre_window(
        cfg, state, torch.zeros(n_envs, dtype=torch.int64, device=device))
    args = (state.y, t_win, pack_struct(state.der, P_FIELDS),
            pack_struct(exog, U_FIELDS))
    kw = dict(n_ph=cfg.der.n_ph, n_sub=n_sub, dt=cfg.dt_ctrl)
    kernel_ms = plain_ms = k1_50_ms = None
    if cuda:
        kernel_ms = _time_ms(lambda: rk4_window_batch(*args, **kw), 20, device)
        plain_ms = _time_ms(lambda: rk4_window_batch_ref(*args, **kw), 2, device)
        # K1 three-phase at the same width and n_sub
        _, *args50 = window_inputs("50", n_envs, 50, device)
        k1_50_ms = _time_ms(lambda: rk4_window_batch(
            *args50, n_ph=3, n_sub=n_sub, dt=cfg.dt_ctrl), 20, device)
    step_ms = 1e3 * out["chunk_s"] / chunk
    phase("main", card=card, n_envs=n_envs, n_sub=n_sub, reset_s=reset_s,
          init_res_max=init_res_max, timed_steps=chunk,
          env_steps_per_s=n_envs * chunk / out["chunk_s"], step_ms=step_ms,
          kernel_ms_per_launch=kernel_ms,
          kernel_share_of_step=(kernel_ms / step_ms if kernel_ms else None),
          plain_window_ms=plain_ms, preset50_ms_per_launch=k1_50_ms,
          peak_mem_mib=peak_mib,
          launches=launches, autoreset_launches=ar_launches,
          post_window_launches=pw_launches, pre_window_launches=pre_launches,
          steps=out["steps"], dones=out["dones"],
          rew_sum=out["rew_sum"], finite=out["finite"])
    phase("linear", card=card, two_chunks_over_one=out["ratio"],
          band=[1.5, 2.7])
    _check_drive("main", out, launches, cuda, autoreset=ar_launches,
                 post_window=pw_launches, pre_window=pre_launches)
    return dict(launches=launches, autoreset_launches=ar_launches,
                post_window_launches=pw_launches,
                pre_window_launches=pre_launches, kernel_ms=kernel_ms,
                plain_ms=plain_ms, preset50_ms=k1_50_ms,
                env_steps_per_s=n_envs * chunk / out["chunk_s"])


def fleet_inputs(preset, n, m, seed, device, u_over=None, shade=0.0,
                 disconnect=False):
    """Seeded numpy inputs of one fleet window: unit states near the
    steady state, random t0, per-unit insolation shading up to ``shade``.
    The feeder fields (rg, dw_g, phi_g2) differ from unit to unit on
    purpose: both versions must read them from unit 0 alone."""
    import dataclasses

    from pvderx_torch import make_params, nominal_exog, oracle
    from pvderx_torch.ops.window import P_FIELDS, U_FIELDS

    rng = np.random.default_rng(seed)
    p = make_params(preset)
    u = dataclasses.replace(nominal_exog(), **(u_over or {}))
    y0 = oracle.steady_state(p, u)
    y = y0 + 1e-3 * rng.standard_normal((n, m, p.n_states))
    t0 = rng.uniform(0.0, 1.0, n)
    pp = np.array([np.full((n, m), getattr(p, f)) for f in P_FIELDS])
    uu = np.array([np.full((n, m), getattr(u, f)) for f in U_FIELDS])
    pp[P_FIELDS.index("rg")] *= 1.0 + 0.2 * rng.uniform(-1.0, 1.0, (n, m))
    uu[U_FIELDS.index("s_irr")] *= 1.0 - shade * rng.uniform(size=(n, m))
    uu[U_FIELDS.index("dw_g")] = rng.uniform(-0.01, 0.01, (n, m))
    if u.v_g2 > 0.0:
        uu[U_FIELDS.index("phi_g2")] = rng.uniform(0.0, 2.0 * np.pi, (n, m))
    if disconnect:
        conn = (rng.uniform(size=(n, m)) < 0.6).astype(float)
        uu[U_FIELDS.index("conn")] = conn
        uu[U_FIELDS.index("ces")] = conn * (rng.uniform(size=(n, m)) < 0.5)
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return p.n_ph, f(y), f(t0), f(pp), f(uu)


FLEET_CASES = [
    # (name, preset, N, M, kwargs of fleet_inputs)
    ("config5_shaded", "10", FLEET_ENVS, FLEET_M, dict(shade=0.25)),
    ("preset50_unbalanced_m4", "50", 1024, 4, dict(u_over=dict(v_g2=0.15))),
    ("disconnect_cessation_m8", "10", 2048, 8, dict(disconnect=True)),
    ("ragged_n1000_m3", "10", 1000, 3, {}),
    ("m40_two_warps", "10", 512, 40, dict(shade=0.25)),
    ("m300_ten_warps", "10", 8, 300, dict(shade=0.25)),
    ("m1_vs_k1", "10", 4096, 1, {}),
]


def check_fleet_kernel(device, cases=FLEET_CASES, n_sub=N_SUB):
    """Phase 7: the fleet kernel vs its plain version on every case (and at
    M=1 vs the single-DER kernel). Returns the max error."""
    from pvderx_torch.ops.window import (
        rk4_fleet_window_batch, rk4_fleet_window_batch_ref, rk4_window_batch)

    cuda = torch.device(device).type == "cuda"
    worst = 0.0
    for i, (name, preset, n, m, kw) in enumerate(cases):
        n_ph, y, t0, pp, uu = fleet_inputs(preset, n, m, 100 + i, device, **kw)
        before = rk4_fleet_window_batch.launches
        out = rk4_fleet_window_batch(y, t0, pp, uu, n_ph=n_ph, m=m,
                                     n_sub=n_sub, dt=DT)
        moved = rk4_fleet_window_batch.launches - before
        ref = rk4_fleet_window_batch_ref(y, t0, pp, uu, n_ph=n_ph, m=m,
                                         n_sub=n_sub, dt=DT)
        _sync(device)
        err = float((out - ref).abs().max())
        extra = {}
        if m == 1:
            k1 = rk4_window_batch(y[:, 0].contiguous(), t0,
                                  pp[:, :, 0].contiguous(),
                                  uu[:, :, 0].contiguous(), n_ph=n_ph,
                                  n_sub=n_sub, dt=DT)
            extra["vs_k1"] = float((out[:, 0] - k1).abs().max())
        phase("fleet_kernel", case=name, n=n, m=m, n_ph=n_ph,
              max_abs_err=err, tol=KERNEL_TOL, launches=moved, **extra)
        if not (np.isfinite(err) and err <= KERNEL_TOL):
            raise AssertionError(
                f"fleet kernel vs plain {name}: {err:.3e} > {KERNEL_TOL}")
        if "vs_k1" in extra:
            require_bitwise(f"fleet kernel at M=1 vs K1 {name}",
                            extra["vs_k1"])
        if cuda and moved != 1:
            raise AssertionError(f"fleet launch counter moved by {moved}, not 1")
        worst = max(worst, err)
    return worst


def check_fleet_gate(device, m=FLEET_M, n_steps=36, n=128, n_sub=N_SUB):
    """Phase 8: the f32 fleet kernel vs the coupled float64 LSODA truth on
    the fleet gate scenario (preset 10)."""
    from pvderx_torch import make_params, oracle
    from pvderx_torch.ops.window import (
        P_FIELDS, U_FIELDS, rk4_fleet_window_batch)

    p = make_params("10")
    fp, fus = oracle.fleet_gate_scenario(p, m, n_steps)
    truth, truth_s = _truth("fleet_gate", m, n_steps)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    per_env = lambda tree, names: f([np.broadcast_to(getattr(tree, k), (n, m))
                                     for k in names])
    pp = per_env(fp, P_FIELDS)
    y = f(np.broadcast_to(truth[0], (n, m, p.n_states)))
    err = 0.0
    for k, fu in enumerate(fus):
        y = rk4_fleet_window_batch(y, f(np.full(n, k * DT)), pp,
                                   per_env(fu, U_FIELDS), n_ph=p.n_ph, m=m,
                                   n_sub=n_sub, dt=DT)
        err = max(err, float((y.double().cpu() - torch.from_numpy(
            truth[k + 1])).abs().max()))
    phase("fleet_gate", preset="10", m=m, n_sub=n_sub, windows=n_steps,
          max_abs_err=err, bound=GATE_TOL, lsoda_truth_s=truth_s)
    if not err <= GATE_TOL:
        raise AssertionError(f"f32 fleet gate {err:.3e} > {GATE_TOL}")
    return err


def run_fleet_main(device, card, n_envs=FLEET_ENVS, m=FLEET_M, n_sub=N_SUB,
                   warm=WARM_STEPS, chunk=CHUNK_STEPS, per_unit_steps=60):
    """Phase 9: BASELINE config 5 at full width through the fleet kernel,
    then a short per-unit rollout."""
    from pvderx_torch.env import (
        fleet_obs_dim, fleet_rollout, make_fleet_batch_fns, make_fleet_config)
    from pvderx_torch.env import fleet
    from pvderx_torch.diag.roofline import window_bound_ms
    from pvderx_torch.ops.window import (
        P_FIELDS, U_FIELDS, pack_struct, rk4_fleet_window_batch,
        rk4_fleet_window_batch_ref)

    cuda = torch.device(device).type == "cuda"
    kw = dict(dtype=torch.float32, n_sub=n_sub, device=device)
    fc = make_fleet_config("10", m=m, **kw)
    reset_batch, _ = make_fleet_batch_fns(fc)
    gen = torch.Generator(device=device).manual_seed(0)
    policy = lambda obs, g: torch.randint(0, 5, (obs.shape[0],), generator=g,
                                          device=obs.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    _zero_counts()
    state, obs, reset_s, init_res_max = _reset_timed(reset_batch, n_envs, gen)
    state, obs, out = _drive(
        lambda s, o, k: fleet_rollout(fc, s, o, policy, k, gen), state, obs,
        warm, chunk)
    launches = rk4_fleet_window_batch.launches
    peak_mib = (torch.cuda.max_memory_allocated(device) / 2 ** 20
                if cuda else None)

    # the kernel alone at the main path's shapes, beside its plain version
    t_win, fu, _ = fleet._pre_window(
        fc, state, torch.zeros(n_envs, dtype=torch.int64, device=device))
    args = (state.y, t_win, pack_struct(state.der, P_FIELDS),
            pack_struct(fu, U_FIELDS))
    wkw = dict(n_ph=1, m=m, n_sub=n_sub, dt=fc.base.dt_ctrl)
    kernel_ms = plain_ms = None
    if cuda:
        kernel_ms = _time_ms(lambda: rk4_fleet_window_batch(*args, **wkw), 20,
                             device)
        plain_ms = _time_ms(lambda: rk4_fleet_window_batch_ref(*args, **wkw),
                            2, device)
    bound = window_bound_ms("fleet_window", n_envs, m=m, n_sub=n_sub)
    step_ms = 1e3 * out["chunk_s"] / chunk
    rate = n_envs * chunk / out["chunk_s"]
    phase("fleet_main", card=card, n_envs=n_envs, m=m, n_sub=n_sub,
          reset_s=reset_s, init_res_max=init_res_max, timed_steps=chunk,
          env_steps_per_s=rate, der_steps_per_s=rate * m, step_ms=step_ms,
          kernel_ms_per_launch=kernel_ms,
          kernel_share_of_step=(kernel_ms / step_ms if kernel_ms else None),
          plain_window_ms=plain_ms, bound_ms=bound["bound_ms"],
          peak_mem_mib=peak_mib, launches=launches, steps=out["steps"],
          dones=out["dones"], rew_sum=out["rew_sum"], finite=out["finite"])
    phase("fleet_linear", card=card, two_chunks_over_one=out["ratio"],
          band=[1.5, 2.7])
    _check_drive("fleet_main", out, launches, cuda)

    # per-unit mode: [N, M] actions, the 13 + 4M observation
    fc_pu = make_fleet_config("10", m=m, per_unit=True, **kw)
    reset_pu, _ = make_fleet_batch_fns(fc_pu)
    st, ob = reset_pu(n_envs, gen)
    before = rk4_fleet_window_batch.launches
    st, ob, rews, _ = fleet_rollout(
        fc_pu, st, ob, lambda o, g: torch.randint(
            0, 5, (o.shape[0], m), generator=g, device=o.device),
        per_unit_steps, gen)
    moved = rk4_fleet_window_batch.launches - before
    ok = (tuple(ob.shape) == (n_envs, fleet_obs_dim(fc_pu))
          and bool(torch.isfinite(ob).all()) and bool(torch.isfinite(rews).all()))
    phase("fleet_per_unit", n_envs=n_envs, m=m, steps=per_unit_steps,
          obs_shape=list(ob.shape), finite=ok, launches=moved)
    if not ok:
        raise AssertionError(f"per-unit obs {tuple(ob.shape)} wrong or not finite")
    if cuda and moved != per_unit_steps:
        raise AssertionError(f"per-unit launches {moved} != {per_unit_steps}")
    return dict(launches=launches, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])


def df_inputs(preset, n, seed, device, **kw):
    """`window_inputs` with a seeded y_lo of ~1e-9 relative (well inside
    ulp(y)/2, so (y, y_lo) is a normalized pair)."""
    n_ph, y, t0, pp, uu = window_inputs(preset, n, seed, device, **kw)
    rng = np.random.default_rng(1000 + seed)
    lo = y.double().cpu().numpy() * 1e-9 * rng.standard_normal(tuple(y.shape))
    y_lo = torch.tensor(lo, dtype=torch.float32, device=device)
    return n_ph, y, y_lo, t0, pp, uu


def _df_err(hi, lo, ref_hi, ref_lo) -> float:
    return float(((hi.double() + lo.double())
                  - (ref_hi.double() + ref_lo.double())).abs().max())


def _lo_normalized(hi, lo) -> bool:
    """|lo| <= ulp(hi)/2 everywhere."""
    a = hi.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return bool((lo.abs() <= 0.5 * ulp).all())


DF_CASES = KERNEL_CASES + [
    ("ragged_n37", "10", 37, {}),
    ("ragged_n37_unbalanced_3ph", "50", 37, dict(u_over=dict(v_g2=0.15))),
]


def check_df_kernel(device, cases=DF_CASES, n_sub=DF_CHECK_SUB,
                    main_sub=N_SUB):
    """Phase 10: the df32 kernel vs its plain version on every case, at
    n_sub substeps of the main path's h (the main path's case at main_sub).
    Returns (the max error, the plain version's ms on the main path's case
    by CUDA events, None off the card): that call is the plain df32
    window at the main path's shapes, tens of seconds, so df_main's
    `plain_window_ms` is this reading and not a second run."""
    from pvderx_torch.ops.dualfloat import (
        rk4_window_batch_df, rk4_window_batch_df_ref)

    cuda = torch.device(device).type == "cuda"
    worst, plain_ms = 0.0, None
    for i, (name, preset, n, kw) in enumerate(cases):
        n_ph, *args = df_inputs(preset, n, i, device, **kw)
        main = name == "preset10_main"
        sub = main_sub if main else n_sub
        wkw = dict(n_ph=n_ph, n_sub=sub, dt=DT * sub / N_SUB)
        before = rk4_window_batch_df.launches
        hi, lo = rk4_window_batch_df(*args, **wkw)
        moved = rk4_window_batch_df.launches - before
        (ref_hi, ref_lo), ms = _timed(
            lambda: rk4_window_batch_df_ref(*args, **wkw), device)
        plain_ms = ms if main else plain_ms
        _sync(device)
        err = _df_err(hi, lo, ref_hi, ref_lo)
        normal = _lo_normalized(hi, lo)
        phase("df_kernel", case=name, n=n, n_ph=n_ph, n_sub=sub,
              max_abs_err=err, tol=0.0, launches=moved,
              lo_normalized=normal, max_abs_lo=float(lo.abs().max()))
        require_bitwise(f"df32 kernel vs plain {name}", err)
        if not normal:
            raise AssertionError(f"df32 kernel {name}: |lo| > ulp(hi)/2")
        if cuda and moved != 1:
            raise AssertionError(f"df32 launch counter moved by {moved}, not 1")
        worst = max(worst, err)
    return worst, plain_ms


def rk4_window_truth(preset, kw, y, t0, pp, uu, n_sub):
    """`oracle.rk4_window_np` of every env of a `window_inputs` batch (the
    case's ``kw``), in float64 on the host: [n, n_s]."""
    import dataclasses

    from pvderx_torch import make_params, nominal_exog, oracle
    from pvderx_torch.ops.window import P_FIELDS, U_FIELDS

    y0, t, p_np, u_np = (a.double().cpu().numpy() for a in (y, t0, pp, uu))
    p0 = make_params(preset, **kw.get("p_over", {}))
    u0 = dataclasses.replace(nominal_exog(), **kw.get("u_over", {}))
    return np.stack([oracle.rk4_window_np(
        y0[e], float(t[e]), DT, n_sub,
        dataclasses.replace(p0, **{f: float(p_np[j, e])
                                   for j, f in enumerate(P_FIELDS)}),
        dataclasses.replace(u0, **{f: float(u_np[j, e])
                                   for j, f in enumerate(U_FIELDS)}))
        for e in range(len(y0))])


def check_df_f64(device, cases=KERNEL_CASES, n=4, n_sub=N_SUB):
    """Phase 11: the df32 kernel vs the float64 RK4 window at the same
    f32-rounded inputs (lo = 0), and the f32 kernel beside it, which must
    miss the bound. Returns (df32 error, f32 error)."""
    from pvderx_torch.ops.dualfloat import rk4_window_batch_df
    from pvderx_torch.ops.window import rk4_window_batch

    worst = worst32 = 0.0
    for i, (name, preset, _, kw) in enumerate(cases):
        n_ph, y, t0, pp, uu = window_inputs(preset, n, 200 + i, device, **kw)
        wkw = dict(n_ph=n_ph, n_sub=n_sub, dt=DT)
        hi, lo = rk4_window_batch_df(y, torch.zeros_like(y), t0, pp, uu, **wkw)
        y32 = rk4_window_batch(y, t0, pp, uu, **wkw)
        got = (hi.double() + lo.double()).cpu().numpy()
        got32 = y32.double().cpu().numpy()
        want = rk4_window_truth(preset, kw, y, t0, pp, uu, n_sub)
        err = float(np.abs(got - want).max())
        err32 = float(np.abs(got32 - want).max())
        phase("df_f64", case=name, n=n, n_ph=n_ph, n_sub=n_sub,
              max_abs_err=err, tol=DF_F64_TOL, f32_kernel_err=err32)
        if not (np.isfinite(err) and err <= DF_F64_TOL):
            raise AssertionError(
                f"df32 kernel vs float64 RK4 {name}: {err:.3e} > {DF_F64_TOL}")
        worst, worst32 = max(worst, err), max(worst32, err32)
    if not worst32 > DF_F64_TOL:
        raise AssertionError(
            f"the f32 kernel meets the df32 bound ({worst32:.3e}): the "
            "phase does not tell the tiers apart")
    return worst, worst32


def check_df_gate(device, cases=DF_GATE_CASES, n_steps=120, n=128):
    """Phase 12: the df32 kernel vs the float64 LSODA truth on the gate
    scenario, y_lo carried from 0 (y0 is an f32 input by contract), at each
    (preset, n_sub) of ``cases``; the reference's figure is printed beside
    the reading taken at its setting."""
    from pvderx_torch import make_params, oracle
    from pvderx_torch.ops.dualfloat import rk4_window_batch_df
    from pvderx_torch.ops.window import P_FIELDS, U_FIELDS

    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    errs = {}
    for preset, n_sub in cases:
        p = make_params(preset)
        truth, truth_s = _truth("gate", preset, n_steps)
        pp = f([np.full(n, getattr(p, k)) for k in P_FIELDS])
        y_hi = f(np.broadcast_to(truth[0], (n, p.n_states)))
        y_lo = torch.zeros_like(y_hi)
        err = 0.0
        for k, u in enumerate(oracle.gate_scenario_exogs(n_steps)):
            uu = f([np.full(n, getattr(u, name)) for name in U_FIELDS])
            y_hi, y_lo = rk4_window_batch_df(y_hi, y_lo, f(np.full(n, k * DT)),
                                             pp, uu, n_ph=p.n_ph, n_sub=n_sub,
                                             dt=DT)
            got = (y_hi.double() + y_lo.double()).cpu().numpy()
            err = max(err, float(np.abs(got - truth[k + 1]).max()))
        phase("df_gate", preset=preset, n_sub=n_sub, windows=n_steps,
              max_abs_err=err, bound=DF_GATE_TOL, lsoda_truth_s=truth_s,
              reference=DF_GATE_REFERENCE.get((preset, n_sub)))
        if not err <= DF_GATE_TOL:
            raise AssertionError(
                f"df32 gate preset {preset} n_sub {n_sub}: {err:.3e} > "
                f"{DF_GATE_TOL}")
        errs[(preset, n_sub)] = err
    return errs


def run_df_main(device, card, n_envs=N_ENVS, n_sub=N_SUB, warm=WARM_STEPS,
                chunk=CHUNK_STEPS, plain_ms=None):
    """Phase 13: the df32 tier at full width through the df32 kernel;
    ``plain_ms``: the plain df32 window's ms at these shapes (df_kernel's
    reading)."""
    from pvderx_torch.env import core, make_batch_fns_df, make_env_config
    from pvderx_torch.env import rollout_df
    from pvderx_torch.diag.roofline import window_bound_ms
    from pvderx_torch.ops.autoreset import autoreset_batch
    from pvderx_torch.ops.dualfloat import rk4_window_batch_df
    from pvderx_torch.ops.post_window import post_window_batch
    from pvderx_torch.ops.pre_window import pre_window_batch
    from pvderx_torch.ops.window import (
        P_FIELDS, U_FIELDS, pack_struct, rk4_window_batch)

    cuda = torch.device(device).type == "cuda"
    cfg = make_env_config("10", dtype=torch.float32, n_sub=n_sub,
                          device=device)
    reset_df, _ = make_batch_fns_df(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    policy = lambda obs, g: torch.zeros(obs.shape[0], dtype=torch.int64,
                                        device=obs.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    _zero_counts()
    t = time.perf_counter()
    carry, obs = reset_df(n_envs, gen)
    init_res_max = float(carry[0].init_res.max())
    reset_s = time.perf_counter() - t
    carry, obs, out = _drive(
        lambda c, o, k: rollout_df(cfg, c, o, policy, k, gen), carry, obs,
        warm, chunk)
    launches = rk4_window_batch_df.launches
    ar_launches = autoreset_batch.launches
    pw_launches = post_window_batch.launches
    pre_launches = pre_window_batch.launches
    peak_mib = (torch.cuda.max_memory_allocated(device) / 2 ** 20
                if cuda else None)
    state, y_lo = carry
    lo_max = float(y_lo.abs().max())

    # K3 and K1 on hi alone at the main path's shapes and n_sub
    t_win, exog, *_ = core._pre_window(
        cfg, state, torch.zeros(n_envs, dtype=torch.int64, device=device))
    pk, uk = pack_struct(state.der, P_FIELDS), pack_struct(exog, U_FIELDS)
    kw = dict(n_ph=cfg.der.n_ph, n_sub=n_sub, dt=cfg.dt_ctrl)
    kernel_ms = k1_ms = None
    if cuda:
        kernel_ms = _time_ms(
            lambda: rk4_window_batch_df(state.y, y_lo, t_win, pk, uk, **kw),
            10, device)
        k1_ms = _time_ms(lambda: rk4_window_batch(state.y, t_win, pk, uk, **kw),
                         20, device)
    # K3 three-phase at the same width and n_sub
    k3_50_ms = None
    if cuda:
        _, *args50 = df_inputs("50", n_envs, 50, device)
        k3_50_ms = _time_ms(lambda: rk4_window_batch_df(
            *args50, n_ph=3, n_sub=n_sub, dt=cfg.dt_ctrl), 10, device)
    bound = window_bound_ms("window_df", n_envs, n_sub=n_sub)
    bound50 = window_bound_ms("window_df", n_envs, n_ph=3, n_sub=n_sub)
    step_ms = 1e3 * out["chunk_s"] / chunk
    phase("df_main", card=card, n_envs=n_envs, n_sub=n_sub, reset_s=reset_s,
          init_res_max=init_res_max, timed_steps=chunk,
          env_steps_per_s=n_envs * chunk / out["chunk_s"], step_ms=step_ms,
          kernel_ms_per_launch=kernel_ms, k1_ms_per_launch=k1_ms,
          k3_over_k1=(kernel_ms / k1_ms if kernel_ms else None),
          kernel_share_of_step=(kernel_ms / step_ms if kernel_ms else None),
          bound_ms=bound["bound_ms"], plain_window_ms=plain_ms,
          plain_n_sub=n_sub, k3_preset50_ms_per_launch=k3_50_ms,
          k3_preset50_bound_ms=bound50["bound_ms"],
          peak_mem_mib=peak_mib,
          launches=launches, autoreset_launches=ar_launches,
          post_window_launches=pw_launches, pre_window_launches=pre_launches,
          steps=out["steps"], dones=out["dones"], rew_sum=out["rew_sum"],
          finite=out["finite"], max_abs_y_lo=lo_max)
    phase("df_linear", card=card, two_chunks_over_one=out["ratio"],
          band=[1.5, 2.7])
    _check_drive("df_main", out, launches, cuda, autoreset=ar_launches,
                 post_window=pw_launches, pre_window=pre_launches)
    if not lo_max > 0.0:
        raise AssertionError("df_main: y_lo is zero everywhere")
    return dict(launches=launches, kernel_ms=kernel_ms, plain_ms=plain_ms,
                plain_n_sub=n_sub, bound_ms=bound["bound_ms"],
                bound_by=bound["bound_by"], preset50_ms=k3_50_ms)


# The learners (pvderx_torch.learn) at the reference's learner-benchmark
# widths (benchmarks/learners.py): PPO at 16384 envs, DQN and SAC at 4096,
# fleet PPO at 2048 envs x 16 units; each train step's rollout is one K1 (K2
# on the fleet) launch per env step.
PPO_ENVS = 16384
OFFPOLICY_ENVS = 4096
FLEET_PPO_ENVS = 2048
LEARN_TIMED = 5          # timed train steps after one warm-up step


def _time_train(ts, runner, n_steps, device, metric):
    """``n_steps`` train steps, their two phases (``ts.collect``,
    ``ts.update``) between CUDA events (host clocks on the CPU). Returns
    (runner, metrics of the last step, host seconds, collect ms, update ms),
    the ms summed over the steps."""
    cuda = torch.device(device).type == "cuda"

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(a, b):
        return a.elapsed_time(b) if cuda else 1e3 * (b - a)

    marks = []
    t = time.perf_counter()
    for _ in range(n_steps):
        m0 = mark()
        runner, rollout = ts.collect(runner)
        m1 = mark()
        runner, m = ts.update(runner, rollout)
        marks.append((m0, m1, mark()))
    float(m[metric])                     # scalar fetch: the sync
    host_s = time.perf_counter() - t
    _sync(device)
    return (runner, m, host_s, sum(ms(a, b) for a, b, _ in marks),
            sum(ms(b, c) for _, b, c in marks))


def run_learner(name, card, device, make, cfg, lcfg, n_envs, kernel,
                metric="loss", timed=LEARN_TIMED):
    """One learner at full width: reset, a warm-up train step, then
    ``timed`` train steps; ``kernel``'s launches must equal the env steps
    taken and every metric be finite. Prints one line; returns it."""
    cuda = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(0)
    init_runner, ts, _ = make(cfg, lcfg, hidden=(128, 128))
    _zero_counts()
    t = time.perf_counter()
    runner = init_runner(n_envs, gen)
    runner, m = ts(runner)
    float(m[metric])
    warm_s = time.perf_counter() - t
    runner, m, host_s, collect_ms, update_ms = _time_train(
        ts, runner, timed, device, metric)
    launches = kernel.launches
    steps = (1 + timed) * lcfg.rollout_len
    metrics = {k: float(v) for k, v in m.items()}
    out = dict(card=card, n_envs=n_envs, rollout_len=lcfg.rollout_len,
               timed_train_steps=timed, reset_and_warm_s=warm_s,
               env_steps_per_s=n_envs * lcfg.rollout_len * timed / host_s,
               train_step_ms=1e3 * host_s / timed,
               collect_ms_per_train_step=collect_ms / timed,
               update_ms_per_train_step=update_ms / timed,
               launches=launches, env_steps=steps, metrics=metrics)
    phase(name, **out)
    if cuda and launches != steps:
        raise AssertionError(f"{name}: kernel launches {launches} != env "
                             f"steps {steps}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{name}: non-finite metrics {metrics}")
    return out


def run_ppo_main(device, card, n_envs=PPO_ENVS, n_sub=N_SUB,
                 timed=LEARN_TIMED):
    """Phase 14: PPO on the single-DER env at the reference's learner
    benchmark config (preset 10, f32, 16 steps x 4 epochs x 4 minibatches,
    hidden (128, 128)) through K1."""
    from pvderx_torch.env import make_env_config
    from pvderx_torch.learn import PPOConfig, make_ppo
    from pvderx_torch.ops.window import rk4_window_batch

    cfg = make_env_config("10", dtype=torch.float32, n_sub=n_sub,
                          device=device)
    return run_learner("ppo_main", card, device, make_ppo, cfg,
                       PPOConfig(rollout_len=16, n_epochs=4, n_minibatch=4),
                       n_envs, rk4_window_batch, timed=timed)


def run_fleet_ppo(device, card, n_envs=FLEET_PPO_ENVS, m=FLEET_M, n_sub=N_SUB,
                  timed=LEARN_TIMED):
    """Phase 15: PPO on BASELINE config 5 through K2, aggregate; then in
    per-unit mode (obs 13 + 4M, the factored head M x 5). Each a warm-up
    and ``timed`` train steps, as the other learner phases."""
    from pvderx_torch.env import make_fleet_config
    from pvderx_torch.learn import PPOConfig, make_ppo
    from pvderx_torch.ops.window import rk4_fleet_window_batch

    ppo = PPOConfig(rollout_len=16, n_epochs=4, n_minibatch=4)
    kw = dict(dtype=torch.float32, n_sub=n_sub, device=device)
    out = run_learner("fleet_ppo", card, device, make_ppo,
                      make_fleet_config("10", m=m, **kw), ppo, n_envs,
                      rk4_fleet_window_batch, timed=timed)
    pu = run_learner("fleet_ppo_per_unit", card, device, make_ppo,
                     make_fleet_config("10", m=m, per_unit=True, **kw), ppo,
                     n_envs, rk4_fleet_window_batch, timed=timed)
    return dict(out, per_unit=pu)


def run_dqn_main(device, card, n_envs=OFFPOLICY_ENVS, n_sub=N_SUB,
                 timed=LEARN_TIMED):
    """Phase 16: DQN at the reference's benchmark widths (rollout 4,
    4 updates of batch 1024, capacity 262144) through K1."""
    from pvderx_torch.env import make_env_config
    from pvderx_torch.learn import DQNConfig, make_dqn
    from pvderx_torch.ops.window import rk4_window_batch

    cfg = make_env_config("10", dtype=torch.float32, n_sub=n_sub,
                          device=device)
    dqn = DQNConfig(rollout_len=4, n_updates=4, batch_size=1024,
                    capacity=262144)
    return run_learner("dqn_main", card, device, make_dqn, cfg, dqn, n_envs,
                       rk4_window_batch, timed=timed)


def run_sac_main(device, card, n_envs=OFFPOLICY_ENVS, n_sub=N_SUB,
                 timed=LEARN_TIMED):
    """Phase 17: SAC on the continuous env at the reference's benchmark
    widths through K1."""
    from pvderx_torch.env import make_env_config
    from pvderx_torch.learn import SACConfig, make_sac
    from pvderx_torch.ops.window import rk4_window_batch

    cfg = make_env_config("10", dtype=torch.float32, n_sub=n_sub,
                          device=device, continuous=True)
    sac = SACConfig(rollout_len=4, n_updates=4, batch_size=1024,
                    capacity=262144)
    return run_learner("sac_main", card, device, make_sac, cfg, sac, n_envs,
                       rk4_window_batch, metric="critic_loss", timed=timed)


def run_learn_gates(device, card):
    """Phase 18: the four seeded learning gates on the port's learners.
    Each prints its reading; a miss raises once all four have run. The
    gates (tasks, budgets, margins) are `pvderx_torch.learn.gates`."""
    from pvderx_torch.learn.gates import LEARN_GATES, check_learn_gate

    readings = {}
    for name, gate in LEARN_GATES.items():
        t = time.perf_counter()
        trained, random, margin = readings[name] = gate(device)
        phase("learn_gate", card=card, gate=name, trained=trained,
              random=random, margin=margin, gain=trained - random,
              passed=trained > random + margin,
              seconds=time.perf_counter() - t)
    for name, reading in readings.items():
        check_learn_gate(name, *reading)
    return readings


# ---------------------------------------------------------------------------
# the implicit integrators, the Gymnasium adapters, the standalone sim and
# the config store: K1 and K2 on new paths, and the implicit windows, which
# launch no kernel of the port (their products and LU are torch calls)
# ---------------------------------------------------------------------------
# (scheme, n_sub, the reference test's bound against LSODA,
# tests/test_variants.py:84-107); the f32 window is held to that + GATE_TOL
IMPLICIT_WINDOW_CASES = (("trapezoid", 10, 5e-6), ("trapezoid", 20, 1e-6),
                         ("backward_euler", 40, 5e-5))
IMPLICIT_SUB = 16
# the sag scenario of tests/test_variants.py:128-137 (`_sag_cfg`)
SAG_SCEN = dict(p_sag=1.0, p_freq=0.0, sag_depth_lo=0.5, sag_depth_hi=0.5,
                sag_t_lo=0.3, sag_t_hi=0.3, sag_dur_lo=0.3, sag_dur_hi=0.3)
FLEET_IMPLICIT_ENVS = 512      # the f32-vs-f64 comparison's width (time)
FLEET_IMPLICIT_FIT_ENVS = 4096  # one f32 step at config 5's width (memory)
# float32 vs float64 trapezoidal fleet, 20 steps from one state: the largest
# state difference, the f32 Newton's roundoff (8.9e-7 on the CPU,
# `run_fleet_implicit("cpu", "cpu", n_envs=2)`), with a tenfold margin
FLEET_IMPLICIT_TOL = 1e-5
KNOB_TOL = 2e-2          # trapezoid@16 vs RK4@72 Vdc, tests/test_variants.py:206


def _batch(tree, n, device, dtype=torch.float32):
    """A params/exog dataclass of Python floats with [n] leaves on device."""
    import dataclasses

    return dataclasses.replace(tree, **{
        f.name: torch.full((n,), float(getattr(tree, f.name)), dtype=dtype,
                           device=device)
        for f in dataclasses.fields(tree) if f.name != "n_ph"})


def _sag_exog(k: int):
    """Window k of the 90-window sag of tests/test_variants.py:84-107."""
    import dataclasses

    from pvderx_torch import nominal_exog

    u = nominal_exog()
    return dataclasses.replace(u, v_g=0.5) if 30 <= k < 60 else u


def _device_ops(fn, device):
    """Device operations (kernels, copies, sets) of one call of ``fn``,
    counted by torch.profiler; None off the card."""
    if torch.device(device).type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def _peak_mib(device):
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 20


def _reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def check_implicit_window(device, cases=IMPLICIT_WINDOW_CASES, n=128,
                          n_windows=90):
    """Phase 19a: each implicit window in float32 on n envs of the same case
    against the float64 LSODA truth of the sag, after the last window as the
    reference test checks: <= its bound + GATE_TOL. K1 must not launch.
    Returns {(scheme, n_sub): error}."""
    from functools import partial

    from pvderx_torch import make_params
    from pvderx_torch.env import core
    from pvderx_torch.ode.implicit import WINDOWS
    from pvderx_torch.ops.window import rk4_window_batch

    truth, truth_s = _truth("sag", n_windows)
    der = _batch(make_params("10"), n, device)
    y0 = torch.tensor(np.broadcast_to(truth[0], (n, truth.shape[1])),
                      dtype=torch.float32, device=device)
    errs = {}
    for scheme, n_sub, ref_tol in cases:
        before = rk4_window_batch.launches
        t = time.perf_counter()
        y = y0
        for k in range(n_windows):
            f = partial(core._rhs, der=der, exog=_batch(_sag_exog(k), n, device))
            y = WINDOWS[scheme](f, y, torch.full((n,), k * DT, device=device),
                                DT, n_sub)
        err = float((y.double().cpu() - torch.from_numpy(truth[-1])).abs().max())
        seconds = time.perf_counter() - t
        moved = rk4_window_batch.launches - before
        bound = ref_tol + GATE_TOL
        phase("implicit", check="window", scheme=scheme, n_sub=n_sub, n=n,
              windows=n_windows, max_abs_err=err, reference_bound=ref_tol,
              bound=bound, seconds=seconds, lsoda_truth_s=truth_s,
              k1_launches=moved)
        if not (np.isfinite(err) and err <= bound):
            raise AssertionError(f"implicit window {scheme}@{n_sub}: "
                                 f"{err:.3e} > {bound:.3e}")
        if moved:
            raise AssertionError(f"implicit window {scheme}: K1 launched")
        errs[(scheme, n_sub)] = err
    return errs


def run_implicit_env(device, card, n_envs=N_ENVS, n_sub=IMPLICIT_SUB,
                     steps=WARM_STEPS):
    """Phase 19b: the env with each implicit scheme on the sag scenario, one
    horizon of ``steps`` steps at full width through `rollout`: ms per step,
    env-steps/s, device operations per step (one step under the profiler),
    peak MiB; every episode truncates, obs and reward finite, K1 never
    launches."""
    from pvderx_torch.env import core, make_batch_fns, make_env_config, rollout
    from pvderx_torch.ops.window import rk4_window_batch

    policy = lambda obs, g: torch.zeros(obs.shape[0], dtype=torch.int64,
                                        device=obs.device)
    out = {}
    for scheme in ("trapezoid", "backward_euler"):
        cfg = make_env_config("10", dtype=torch.float32, n_sub=n_sub,
                              horizon=steps, integrator=scheme,
                              scen=core.ScenarioConfig(**SAG_SCEN),
                              device=device)
        reset_batch, _ = make_batch_fns(cfg)
        gen = torch.Generator(device=device).manual_seed(0)
        _reset_peak(device)
        _zero_counts()
        state, obs, reset_s, init_res_max = _reset_timed(reset_batch, n_envs,
                                                         gen)
        t = time.perf_counter()
        state, obs, rews, dones = rollout(cfg, state, obs, policy, steps, gen)
        rew_sum = float(rews.sum())
        secs = time.perf_counter() - t
        ops = _device_ops(lambda: rollout(cfg, state, obs, policy, 1, gen),
                          device)
        launches = rk4_window_batch.launches
        finite = (bool(torch.isfinite(obs).all())
                  and bool(torch.isfinite(rews).all()))
        out[scheme] = dict(
            n_envs=n_envs, n_sub=n_sub, steps=steps, reset_s=reset_s,
            init_res_max=init_res_max, step_ms=1e3 * secs / steps,
            env_steps_per_s=n_envs * steps / secs,
            device_ops_per_step=ops, peak_mem_mib=_peak_mib(device),
            dones=int(dones.sum()), rew_sum=rew_sum, finite=finite,
            k1_launches=launches)
        phase("implicit", check="env", card=card, scheme=scheme,
              **out[scheme])
        if not finite:
            raise AssertionError(f"implicit env {scheme}: non-finite output")
        if not bool(dones[-1].all()):
            raise AssertionError(f"implicit env {scheme}: the horizon did "
                                 "not truncate every episode")
        if launches:
            raise AssertionError(f"implicit env {scheme}: K1 launched "
                                 f"{launches} times")
    return out


def run_fleet_implicit(device, card, n_envs=FLEET_IMPLICIT_ENVS, m=FLEET_M,
                       n_sub=IMPLICIT_SUB, steps=20,
                       fit_envs=FLEET_IMPLICIT_FIT_ENVS):
    """Phase 20: the trapezoidal fleet (the stacked [M·n_s] system of each
    env) from one float64 reset state, stepped in float32 and in float64 on
    the same actions through a shallow sag: the states agree within
    FLEET_IMPLICIT_TOL; ms per step, peak MiB; K2 never launches. Then one
    float32 step at ``fit_envs`` envs (config 5's width): its ms and peak
    MiB, finite."""
    from pvderx_torch._struct import tree_map
    from pvderx_torch.env import ScenarioConfig, fleet, make_fleet_config
    from pvderx_torch.ops.window import rk4_fleet_window_batch

    scen = ScenarioConfig(p_sag=1.0, p_freq=0.0, sag_depth_lo=0.8,
                          sag_depth_hi=0.9, sag_t_lo=0.1, sag_t_hi=0.2,
                          sag_dur_lo=0.1, sag_dur_hi=0.2, fleet_s_jitter=0.25)
    kw = dict(m=m, n_sub=n_sub, integrator="trapezoid", scen=scen,
              device=device)
    fc64 = make_fleet_config("10", dtype=torch.float64, **kw)
    fc32 = make_fleet_config("10", dtype=torch.float32, **kw)
    gen = torch.Generator(device=device).manual_seed(0)
    st64, _ = fleet.reset(fc64, n_envs, gen)
    st32 = tree_map(lambda x: x.float() if x.is_floating_point() else x, st64)
    acts = torch.randint(0, 5, (steps, n_envs), generator=gen, device=device)
    runs = {}
    for name, fc, st in (("float32", fc32, st32), ("float64", fc64, st64)):
        _reset_peak(device)
        _zero_counts()
        t = time.perf_counter()
        for k in range(steps):
            st, obs, rew, _, _ = fleet.step(fc, st, acts[k])
        finite = bool(torch.isfinite(st.y).all()) and bool(
            torch.isfinite(rew).all())
        secs = time.perf_counter() - t
        runs[name] = dict(st=st, step_ms=1e3 * secs / steps,
                          peak_mem_mib=_peak_mib(device), finite=finite,
                          k2_launches=rk4_fleet_window_batch.launches)
    diff = float((runs["float32"]["st"].y.double()
                  - runs["float64"]["st"].y).abs().max())
    del runs["float32"]["st"], runs["float64"]["st"], st, st32, st64
    _reset_peak(device)
    st, _ = fleet.reset(fc32, fit_envs, gen)
    t = time.perf_counter()
    st, _, rew, _, _ = fleet.step(fc32, st, torch.zeros(fit_envs,
                                                        dtype=torch.int64,
                                                        device=device))
    fit_finite = bool(torch.isfinite(st.y).all())
    fit = dict(fit_envs=fit_envs, fit_step_ms=1e3 * (time.perf_counter() - t),
               fit_peak_mem_mib=_peak_mib(device), fit_finite=fit_finite)
    out = dict(n_envs=n_envs, m=m, n_sub=n_sub, steps=steps,
               unknowns_per_env=m * fc32.base.der.n_states,
               max_abs_diff_f32_f64=diff, tol=FLEET_IMPLICIT_TOL,
               **{f"{name}_{k}": v for name, r in runs.items()
                  for k, v in r.items()}, **fit)
    phase("fleet_implicit", card=card, **out)
    if not fit_finite:
        raise AssertionError(f"fleet_implicit at {fit_envs} envs: non-finite")
    for name, r in runs.items():
        if not r["finite"]:
            raise AssertionError(f"fleet_implicit {name}: non-finite state")
        if r["k2_launches"]:
            raise AssertionError(f"fleet_implicit {name}: K2 launched")
    if not diff <= FLEET_IMPLICIT_TOL:
        raise AssertionError(f"fleet_implicit f32 vs f64 {diff:.3e} > "
                             f"{FLEET_IMPLICIT_TOL}")
    return out


def check_final_obs(info: dict, done: np.ndarray) -> None:
    """The SAME_STEP contract of one vector-env step: where an episode
    ended, ``info`` carries the finite pre-reset observation, marked by
    ``_final_obs`` on exactly the done rows; with no done row, neither."""
    if not done.any():
        if "final_obs" in info or "_final_obs" in info:
            raise AssertionError("final_obs with no episode done")
        return
    if "final_obs" not in info or "_final_obs" not in info:
        raise AssertionError(f"{int(done.sum())} done rows without final_obs")
    if not np.array_equal(info["_final_obs"], done):
        raise AssertionError("_final_obs does not mark the done rows")
    if not np.isfinite(info["final_obs"][done]).all():
        raise AssertionError("final_obs not finite on a done row")


def _drive_adapter(env, actions, kernel, cuda, what):
    """Reset a single-env adapter and step it through ``actions``: the
    kernel must launch once per step. Returns (ms per step, launches)."""
    env.reset(seed=0)
    _zero_counts()
    t = time.perf_counter()
    for a in actions:
        obs, rew, _, _, _ = env.step(a)
        if not (np.isfinite(obs).all() and np.isfinite(rew)):
            raise AssertionError(f"{what}: non-finite step")
    ms = 1e3 * (time.perf_counter() - t) / len(actions)
    if cuda and kernel.launches != len(actions):
        raise AssertionError(f"{what}: kernel launches {kernel.launches} != "
                             f"steps {len(actions)}")
    return ms, kernel.launches


def run_gym(device, card, main_rate=None, n_envs=N_ENVS, n_sub=N_SUB,
            vec_steps=CHUNK_STEPS, steps=WARM_STEPS, m=FLEET_M):
    """Phase 21: the Gymnasium adapters, with or without gymnasium
    installed: `PVDERVectorEnv` at full width for one horizon (truncation
    and SAME_STEP autoreset fire; final_obs checked on every step; K1 once
    per step; env-steps/s beside the main path's), `PVDEREnv` and
    `PVDERFleetEnv` (aggregate, then per-unit) for ``steps`` steps, K1 / K2
    once per step."""
    from pvderx_torch.env import gym_adapter as ga
    from pvderx_torch.ops.autoreset import autoreset_batch
    from pvderx_torch.ops.post_window import post_window_batch
    from pvderx_torch.ops.pre_window import pre_window_batch
    from pvderx_torch.ops.window import rk4_fleet_window_batch, rk4_window_batch

    cuda = torch.device(device).type == "cuda"
    venv = ga.PVDERVectorEnv(n_envs, "10", n_sub=n_sub, horizon=vec_steps,
                             device=device)
    t = time.perf_counter()
    obs, _ = venv.reset(seed=0)
    reset_s = time.perf_counter() - t
    acts = np.zeros(n_envs, np.int64)
    _zero_counts()
    dones = 0
    finite = True
    t = time.perf_counter()
    for _ in range(vec_steps):
        obs, rew, term, trunc, info = venv.step(acts)
        done = term | trunc
        check_final_obs(info, done)
        dones += int(done.sum())
        finite &= bool(np.isfinite(obs).all() and np.isfinite(rew).all())
    secs = time.perf_counter() - t
    launches = rk4_window_batch.launches
    ar_launches = autoreset_batch.launches
    pw_launches = post_window_batch.launches
    pre_launches = pre_window_batch.launches
    rate = n_envs * vec_steps / secs
    out = dict(gymnasium=ga._HAS_GYM, vector=dict(
        n_envs=n_envs, n_sub=n_sub, steps=vec_steps, reset_s=reset_s,
        step_ms=1e3 * secs / vec_steps, env_steps_per_s=rate,
        main_env_steps_per_s=main_rate, launches=launches,
        autoreset_launches=ar_launches, post_window_launches=pw_launches,
        pre_window_launches=pre_launches, dones=dones))
    phase("gym", card=card, adapter="PVDERVectorEnv", gymnasium=ga._HAS_GYM,
          **out["vector"])
    if not finite:
        raise AssertionError("gym vector: non-finite obs or reward")
    if dones == 0:
        raise AssertionError("gym vector: no episode ended")
    if cuda and launches != vec_steps:
        raise AssertionError(f"gym vector: K1 launches {launches} != steps "
                             f"{vec_steps}")
    if cuda and ar_launches != vec_steps:
        raise AssertionError(f"gym vector: autoreset launches {ar_launches} "
                             f"!= steps {vec_steps}")
    if cuda and pw_launches != vec_steps:
        raise AssertionError(f"gym vector: post-window launches "
                             f"{pw_launches} != steps {vec_steps}")
    if cuda and pre_launches != vec_steps:
        raise AssertionError(f"gym vector: pre-window launches "
                             f"{pre_launches} != steps {vec_steps}")

    single_acts = [k % 5 for k in range(steps)]
    ms, n = _drive_adapter(ga.PVDEREnv("10", n_sub=n_sub, device=device),
                           single_acts, rk4_window_batch, cuda, "gym single")
    out["single"] = dict(steps=steps, step_ms=ms, launches=n)
    phase("gym", card=card, adapter="PVDEREnv", **out["single"])
    rng = np.random.default_rng(0)
    for per_unit in (False, True):
        env = ga.PVDERFleetEnv("10", m=m, n_sub=n_sub, per_unit=per_unit,
                               device=device)
        fleet_acts = [rng.integers(0, 5, m) if per_unit else k % 5
                      for k in range(steps)]
        name = "fleet_per_unit" if per_unit else "fleet"
        ms, n = _drive_adapter(env, fleet_acts, rk4_fleet_window_batch, cuda,
                               f"gym {name}")
        out[name] = dict(m=m, steps=steps, step_ms=ms, launches=n)
        phase("gym", card=card, adapter="PVDERFleetEnv", per_unit=per_unit,
              **out[name])
    return out


def _sim_exogs(n_steps: int):
    """The ZOH exogs of the sim schedule of tests/test_sim_diag.py:14-22
    (cloud to 500 W/m² at 1 s, 0.7 pu sag from 2.0 to 2.4 s)."""
    import dataclasses

    from pvderx_torch import nominal_exog

    u, exogs = nominal_exog(), []
    for k in range(n_steps):
        t, uu = k * DT, u
        if t >= 1.0:
            uu = dataclasses.replace(uu, s_irr=500.0)
        if 2.0 <= t < 2.4:
            uu = dataclasses.replace(uu, v_g=0.7)
        exogs.append(uu)
    return exogs


def run_sim(device, card, t_stop=3.0, knob_stop=1.0):
    """Phase 22: `DynamicSimulation("10")` in float32 on the sim schedule
    of tests/test_sim_diag.py (tStop 3 s: 180 windows, K1 once each)
    against the float64 LSODA trajectory on the same exogs: <= GATE_TOL;
    then the integrator knob (tests/test_variants.py:186-206): trapezoid at
    n_sub 16 (no K1 launch) and RK4 at 72 over 1 s of a 0.6 pu sag, finite
    and within KNOB_TOL on Vdc; on the card, float64 with RK4 raises."""
    from pvderx_torch.ops.window import rk4_window_batch
    from pvderx_torch.scenario import EventBuilder
    from pvderx_torch.sim import DynamicSimulation

    cuda = torch.device(device).type == "cuda"
    ev = EventBuilder()
    ev.add_solar_event(1.0, 500.0)
    ev.add_grid_event(2.0, v=0.7)
    ev.add_grid_event(2.4)
    sim = DynamicSimulation("10", events=ev, tStop=t_stop, device=device)
    _zero_counts()
    t = time.perf_counter()
    series = sim.run_simulation()
    sim_s = time.perf_counter() - t
    launches = rk4_window_batch.launches
    truth, truth_s = _truth("sim", sim.n_steps)
    err = float(np.abs(series["y"] - truth[1:]).max())

    knob = EventBuilder()
    knob.add_grid_event(0.3, 0.6)
    knob.add_grid_event(0.6, 1.0)
    vdc, knob_launches = {}, {}
    for integ, n_sub in (("trapezoid", 16), ("rk4", 72)):
        _zero_counts()
        s = DynamicSimulation("10", events=knob, tStop=knob_stop, n_sub=n_sub,
                              integrator=integ, device=device)
        vdc[integ] = s.run_simulation()["vdc"]
        knob_launches[integ] = rk4_window_batch.launches
    knob_diff = float(np.abs(vdc["trapezoid"] - vdc["rk4"]).max())
    f64_raises = None
    if cuda:
        try:
            DynamicSimulation("10", tStop=0.05, dtype=torch.float64,
                              device=device).run_simulation()
            f64_raises = False
        except ValueError:
            f64_raises = True
    out = dict(windows=sim.n_steps, n_sub=sim.cfg.n_sub, sim_s=sim_s,
               launches=launches, max_abs_err=err, bound=GATE_TOL,
               lsoda_truth_s=truth_s, knob_max_abs_vdc_diff=knob_diff,
               knob_tol=KNOB_TOL, knob_launches=knob_launches,
               float64_rk4_raises=f64_raises)
    phase("sim", card=card, **out)
    if cuda and launches != sim.n_steps:
        raise AssertionError(f"sim: K1 launches {launches} != windows "
                             f"{sim.n_steps}")
    if not err <= GATE_TOL:
        raise AssertionError(f"sim vs LSODA {err:.3e} > {GATE_TOL}")
    if not (np.isfinite(vdc["trapezoid"]).all() and knob_diff <= KNOB_TOL):
        raise AssertionError(f"sim knob: trapezoid vs rk4 {knob_diff:.3e}")
    if knob_launches["trapezoid"] or (
            cuda and knob_launches["rk4"] != len(vdc["rk4"])):
        raise AssertionError(f"sim knob launches {knob_launches}")
    if cuda and not f64_raises:
        raise AssertionError("sim: float64 with rk4 on the card did not raise")
    return out


def run_config(device, card, n_envs=1024, steps=10):
    """Phase 23: every packaged env config (`load_env_config` of
    pvderx_torch/configs/env_*.json) on the device: reset n_envs, ``steps``
    steps through K1 (one launch each), obs and reward finite."""
    import os

    from pvderx_torch.config import CONFIG_DIR, load_env_config
    from pvderx_torch.env import make_batch_fns, rollout
    from pvderx_torch.ops.window import rk4_window_batch

    cuda = torch.device(device).type == "cuda"
    names = sorted(f[:-5] for f in os.listdir(CONFIG_DIR)
                   if f.startswith("env_") and f.endswith(".json"))
    policy = lambda obs, g: torch.zeros(obs.shape[0], dtype=torch.int64,
                                        device=obs.device)
    out = {}
    for name in names:
        cfg = load_env_config(name, device=device)
        reset_batch, _ = make_batch_fns(cfg)
        gen = torch.Generator(device=device).manual_seed(0)
        _zero_counts()
        state, obs, reset_s, init_res_max = _reset_timed(reset_batch, n_envs,
                                                         gen)
        t = time.perf_counter()
        state, obs, rews, _ = rollout(cfg, state, obs, policy, steps, gen)
        float(rews.sum())
        secs = time.perf_counter() - t
        finite = (bool(torch.isfinite(obs).all())
                  and bool(torch.isfinite(rews).all()))
        out[name] = dict(preset_n_ph=cfg.der.n_ph, n_sub=cfg.n_sub,
                         n_envs=n_envs, reset_s=reset_s,
                         init_res_max=init_res_max, steps=steps,
                         step_ms=1e3 * secs / steps,
                         launches=rk4_window_batch.launches, finite=finite)
        phase("config", card=card, config=name, **out[name])
        if not finite:
            raise AssertionError(f"config {name}: non-finite obs or reward")
        if cuda and out[name]["launches"] != steps:
            raise AssertionError(f"config {name}: K1 launches "
                                 f"{out[name]['launches']} != {steps}")
    return out


# ---------------------------------------------------------------------------
# the diagnostics (pvderx_torch.diag), gradients through the eager window and
# the examples: K1, K2 and K3 on new paths
# ---------------------------------------------------------------------------
DIAG_TRACE_STEPS = 3
GRAD_FD_TOL = 1e-5        # autograd vs central FD, float64 (tests/test_grad.py)
GRAD_WINDOWS, GRAD_SUB = 6, 40     # tests/test_grad.py's loss
# gain tuning's default value_and_grad (60 windows x 72 substeps) is timed
# when 12 windows scale to at most this many seconds
TUNE_LIMIT_S = 120.0
TUNE_WINDOWS, TUNE_PROBE_WINDOWS = 60, 12
# each example on the card at a small size: (module, arguments, the launches
# it must make of K1 and K2)
EXAMPLES = (
    ("standalone_simulation", ["--tstop", "0.5"], {"k1": 30, "k2": 0}),
    ("gym_rollout", ["--steps", "30"], {"k1": 30, "k2": 0}),
    ("fleet_simulation", ["--m", "16", "--n-envs", "64", "--steps", "30"],
     {"k1": 0, "k2": 30}),
    ("gain_tuning", ["--iters", "2", "--windows", "3", "--n-sub", "40"],
     {"k1": 0, "k2": 0}),
)
_KERNEL_SHORT = {"k1": "window_kernel", "k2": "fleet_window_kernel",
                 "k3": "window_df_kernel"}


def traced_kernel_launches(rows) -> dict:
    """K1, K2 and K3 launches in `device_op_summary` rows, by kernel name."""
    out = dict.fromkeys(_KERNEL_SHORT, 0)
    for name, _, n in rows:
        short = kernel_name(name).split("<")[0]
        for k, v in _KERNEL_SHORT.items():
            if short == v:
                out[k] += n
    return out


def run_diag_profiler(device, card, main_rate=None, n_envs=N_ENVS,
                      fleet_envs=FLEET_ENVS, m=FLEET_M, n_sub=N_SUB,
                      steps=DIAG_TRACE_STEPS, reps=60,
                      paths=("main", "fleet", "df32")):
    """Phase 24: `diag.profiler.trace` around ``steps`` main-path steps at
    full width, one config-5 fleet step and one df32 step (each after a
    warm-up step); `device_op_summary` of each trace must list the path's
    kernel once per step (K1, K2, K3), as its launch count does. Then the
    main step timed by `Stopwatch` (``reps`` chained steps) beside the main
    phase's env-steps/s."""
    import os
    import tempfile

    from pvderx_torch.diag.profiler import (
        Stopwatch, device_op_summary, force_sync, trace)
    from pvderx_torch.env import (
        make_batch_fns, make_batch_fns_df, make_env_config,
        make_fleet_batch_fns, make_fleet_config)
    from pvderx_torch.ops.dualfloat import rk4_window_batch_df
    from pvderx_torch.ops.window import rk4_fleet_window_batch, rk4_window_batch

    cuda = torch.device(device).type == "cuda"
    kw = dict(dtype=torch.float32, n_sub=n_sub, device=device)
    cfg = make_env_config("10", **kw)
    gen = torch.Generator(device=device).manual_seed(0)
    drives = (("main", make_batch_fns(cfg), n_envs, steps, rk4_window_batch,
               "k1"),
              ("fleet", make_fleet_batch_fns(make_fleet_config("10", m=m, **kw)),
               fleet_envs, 1, rk4_fleet_window_batch, "k2"),
              ("df32", make_batch_fns_df(cfg), n_envs, 1, rk4_window_batch_df,
               "k3"))
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for name, (reset_batch, step_batch), n, k, kernel, key in drives:
            if name not in paths:
                continue
            state, _ = reset_batch(n, gen)
            a = torch.zeros(n, dtype=torch.int64, device=device)
            state = step_batch(state, a, gen)[0]
            force_sync(state)
            _zero_counts()
            t = time.perf_counter()
            with trace(os.path.join(root, name)) as logdir:
                for _ in range(k):
                    state = step_batch(state, a, gen)[0]
            secs = time.perf_counter() - t
            launches = kernel.launches
            rows = device_op_summary(logdir, top=None)
            traced = traced_kernel_launches(rows)
            out[name] = dict(n_envs=n, steps=k, launches=launches,
                             traced=traced, traced_s=secs,
                             device_ms=sum(ms for _, ms, _ in rows),
                             top=[[nm[:60], ms, c] for nm, ms, c in rows[:4]])
            if name == "main":
                sw = Stopwatch(lambda s: step_batch(s, a, gen), state,
                               n_warmup=1)
                out[name].update(
                    stopwatch_env_steps_per_s=sw.rate(reps, n),
                    stopwatch_reps=reps, main_env_steps_per_s=main_rate)
            phase("diag_profiler", card=card, path=name, **out[name])
            if cuda and not traced[key] == launches == k:
                raise AssertionError(f"diag_profiler {name}: traced {traced}, "
                                     f"launches {launches}, steps {k}")
    return out


def run_diag_debug(device, card, n_envs=N_ENVS, n_sub=N_SUB, guard_n=64):
    """Phase 25: `diag.debug.checked_step` on a clean full-width state
    passes with one K1 launch, and names the env whose state holds a NaN;
    `debug_mode` lets a clean step through and traps a NaN fed to K1,
    naming the kernel; the grad guard raises, before any launch, for K1,
    K2 and K3 inputs that require grad."""
    import dataclasses

    from pvderx_torch.diag.debug import checked_step, debug_mode
    from pvderx_torch.env import core, make_batch_fns, make_env_config
    from pvderx_torch.ops.dualfloat import rk4_window_batch_df
    from pvderx_torch.ops.window import (
        P_FIELDS, U_FIELDS, pack_struct, rk4_fleet_window_batch,
        rk4_window_batch)

    cuda = torch.device(device).type == "cuda"
    cfg = make_env_config("10", dtype=torch.float32, n_sub=n_sub,
                          device=device)
    reset_batch, _ = make_batch_fns(cfg)
    state, _ = reset_batch(n_envs, torch.Generator(device=device).manual_seed(0))
    a = torch.zeros(n_envs, dtype=torch.int64, device=device)
    step = checked_step(cfg)
    _zero_counts()
    err, _ = step(state, a)
    clean = err.get()
    launches = rk4_window_batch.launches
    bad_env = n_envs // 3
    y = state.y.clone()
    y[bad_env, 0] = float("nan")
    caught = step(dataclasses.replace(state, y=y), a)[0].get()
    with debug_mode():
        core.step(cfg, state, a)                    # clean: no trap
    t_win, exog, *_ = core._pre_window(cfg, state, a)
    args = (y, t_win, pack_struct(state.der, P_FIELDS),
            pack_struct(exog, U_FIELDS))
    trapped = None
    try:
        with debug_mode():
            rk4_window_batch(*args, n_ph=1, n_sub=n_sub, dt=cfg.dt_ctrl)
    except FloatingPointError as e:
        trapped = str(e)

    def needs_grad(inputs):
        *rest, pp, uu = inputs
        return (*rest, pp.requires_grad_(True), uu)

    guards = {}
    for key, kernel, call in (
            ("k1", rk4_window_batch, lambda: rk4_window_batch(
                *needs_grad(window_inputs("10", guard_n, 0, device)[1:]),
                n_ph=1, n_sub=n_sub, dt=DT)),
            ("k2", rk4_fleet_window_batch, lambda: rk4_fleet_window_batch(
                *needs_grad(fleet_inputs("10", guard_n, 4, 0, device)[1:]),
                n_ph=1, m=4, n_sub=n_sub, dt=DT)),
            ("k3", rk4_window_batch_df, lambda: rk4_window_batch_df(
                *needs_grad(df_inputs("10", guard_n, 0, device)[1:]),
                n_ph=1, n_sub=n_sub, dt=DT))):
        before = kernel.launches
        try:
            out = call()
            guards[key] = dict(raised=None, grad_fn=out[0].grad_fn is not None)
        except RuntimeError as e:
            guards[key] = dict(raised=str(e)[:80])
        guards[key]["launches"] = kernel.launches - before
    out = dict(n_envs=n_envs, clean=clean, launches=launches, bad_env=bad_env,
               caught=caught, trapped=trapped, grad_guard=guards)
    phase("diag_debug", card=card, **out)
    if clean is not None:
        raise AssertionError(f"diag_debug: clean step failed its checks: {clean}")
    if not (caught or "").startswith(
            f"non-finite state after step: env {bad_env}"):
        raise AssertionError(f"diag_debug: NaN in env {bad_env} read {caught}")
    if trapped is None:
        raise AssertionError("diag_debug: debug_mode let a NaN through K1")
    if cuda and (launches != 1 or "CUDA window kernel" not in trapped
                 or any(g["raised"] is None or g["launches"]
                        for g in guards.values())):
        raise AssertionError(f"diag_debug: launches {launches}, trap "
                             f"{trapped!r}, grad guard {guards}")
    return out


def bitwise_differences(a, b, path="") -> list:
    """Paths where two trees differ (`diag.checkpoint.plain` trees, or
    dataclasses, dicts and tuples of tensors on any device); tensors are
    compared bit for bit."""
    import dataclasses

    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        same = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes())
        return [] if same else [path]
    if dataclasses.is_dataclass(a) and type(a) is type(b):
        a, b = ({f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
                for x in (a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [path]
        return [p for k in a
                for p in bitwise_differences(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [path]
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in bitwise_differences(x, y, f"{path}/{i}")]
    return [] if a == b else [path]


def _nondeterministic_ops(ts, runner, n_steps) -> list:
    """The warnings of `torch.use_deterministic_algorithms(warn_only=True)`
    over ``n_steps`` train steps: each names an op without a deterministic
    implementation."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            for _ in range(n_steps):
                runner, _ = ts(runner)
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message)[:160] for w in seen})


def run_diag_checkpoint(device, card, ppo_envs=PPO_ENVS,
                        off_envs=OFFPOLICY_ENVS, n_sub=N_SUB,
                        hidden=(128, 128), more=2):
    """Phase 26: `diag.checkpoint` on the learners at their phases' widths
    (PPO as ppo_main, DQN and SAC as dqn_main and sac_main): one train step,
    `save` (the file loads with ``weights_only=True``), `restore` into a
    runner built from another seed, ``more`` train steps on both; the two
    runners must be bitwise equal (every tensor, state_dict and generator
    state), and the metrics of the last step too. A difference is reported
    with the ops that `torch.use_deterministic_algorithms` names."""
    import os
    import tempfile

    from pvderx_torch.diag import checkpoint
    from pvderx_torch.env import make_env_config
    from pvderx_torch.learn import (
        DQNConfig, PPOConfig, SACConfig, make_dqn, make_ppo, make_sac)
    from pvderx_torch.ops.window import rk4_window_batch

    cuda = torch.device(device).type == "cuda"
    kw = dict(dtype=torch.float32, n_sub=n_sub, device=device)
    offpolicy = dict(rollout_len=4, n_updates=4, batch_size=1024,
                     capacity=262144)
    learners = (
        ("ppo", make_ppo, make_env_config("10", **kw),
         PPOConfig(rollout_len=16, n_epochs=4, n_minibatch=4), ppo_envs),
        ("dqn", make_dqn, make_env_config("10", **kw), DQNConfig(**offpolicy),
         off_envs),
        ("sac", make_sac, make_env_config("10", continuous=True, **kw),
         SACConfig(**offpolicy), off_envs))
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for name, make, cfg, lcfg, n in learners:
            init_runner, ts, _ = make(cfg, lcfg, hidden=hidden)
            runner = init_runner(n, torch.Generator(device=device).manual_seed(0))
            runner, _ = ts(runner)
            t = time.perf_counter()
            path = checkpoint.save(os.path.join(root, f"{name}.pt"), runner)
            save_s = time.perf_counter() - t
            torch.load(path, weights_only=True)
            fresh = init_runner(n, torch.Generator(device=device).manual_seed(1))
            t = time.perf_counter()
            restored = checkpoint.restore(path, fresh)
            restore_s = time.perf_counter() - t
            _zero_counts()
            for _ in range(more):
                runner, m1 = ts(runner)
                restored, m2 = ts(restored)
            diffs = bitwise_differences(checkpoint.plain(runner),
                                        checkpoint.plain(restored))
            diffs += bitwise_differences(
                *({k: torch.as_tensor(v).cpu() for k, v in m.items()}
                  for m in (m1, m2)), "metrics")
            out[name] = dict(
                n_envs=n, file_mib=os.path.getsize(path) / 2 ** 20,
                save_s=save_s, restore_s=restore_s, steps_after=more,
                launches=rk4_window_batch.launches, differences=diffs[:8])
            if diffs:
                out[name]["nondeterministic_ops"] = _nondeterministic_ops(
                    ts, checkpoint.restore(path, fresh), more)
            phase("diag_checkpoint", card=card, learner=name, **out[name])
            want = 2 * more * lcfg.rollout_len
            if diffs or (cuda and out[name]["launches"] != want):
                raise AssertionError(
                    f"diag_checkpoint {name}: differences {diffs[:8]}, K1 "
                    f"launches {out[name]['launches']} (want {want})")
    return out


def _grad_loss(kp_dc, p, u, y0, n_windows=GRAD_WINDOWS, n_sub=GRAD_SUB):
    """tests/test_grad.py's loss: the Vdc tracking error over ``n_windows``
    windows of a sustained 0.7 pu sag, through the eager RK4 window."""
    import dataclasses

    from pvderx_torch.ode import rk4_window
    from pvderx_torch.physics import rhs_core
    from pvderx_torch.physics.xp import TorchXP

    p2 = dataclasses.replace(p, kp_dc=kp_dc)
    xp = TorchXP(y0.dtype, y0.device)
    y, total = y0, 0.0
    for k in range(n_windows):
        y = rk4_window(lambda yy, tt: rhs_core.rhs(yy, tt, p2, u, xp), y,
                       k * DT, DT, n_sub)
        total = total + (y[6] - u.vdc_ref) ** 2
    return total


def _grad_of(kp, p, u, y0, n_windows=GRAD_WINDOWS):
    kp = kp.detach().requires_grad_(True)
    loss = _grad_loss(kp, p, u, y0, n_windows)
    (g,) = torch.autograd.grad(loss, kp)
    return loss.item(), g.item()


def run_grad(device, card, steps=5, windows=GRAD_WINDOWS,
             tune_windows=TUNE_WINDOWS, tune_probe=TUNE_PROBE_WINDOWS,
             tune_sub=None):
    """Phase 27: gradients through the eager window on the card.
    tests/test_grad.py's loss in float64: autograd within GRAD_FD_TOL
    (relative) of a central finite difference, and ``steps`` gradient steps
    on kp_dc lower the loss; the float32 gradient beside it. Then one
    `value_and_grad` of `examples.gain_tuning` (float32, 72 substeps) at
    ``tune_probe`` windows, and at its default ``tune_windows`` where the
    probe scales to at most TUNE_LIMIT_S."""
    import dataclasses

    from pvderx_torch import make_params, nominal_exog, oracle
    from pvderx_torch.diag.profiler import force_sync
    from pvderx_torch.examples import gain_tuning

    p0, u0 = make_params("10"), nominal_exog()
    y0 = oracle.steady_state(p0, u0)
    out = {}
    for dtype in (torch.float64, torch.float32):
        p = p0.to(dtype, device)
        u = dataclasses.replace(u0, v_g=0.7).to(dtype, device)
        y = torch.tensor(y0, dtype=dtype, device=device)
        kp = torch.tensor(p0.kp_dc, dtype=dtype, device=device)
        t = time.perf_counter()
        loss0, g = _grad_of(kp, p, u, y, windows)
        rec = dict(loss=loss0, grad=g, value_and_grad_s=time.perf_counter() - t,
                   windows=windows, rhs_evals=4 * windows * GRAD_SUB)
        if dtype == torch.float64:
            eps = 1e-5 * max(abs(p0.kp_dc), 1.0)
            with torch.no_grad():
                fd = (_grad_loss(kp + eps, p, u, y, windows).item()
                      - _grad_loss(kp - eps, p, u, y, windows).item()) / (2 * eps)
            lr = 0.05 * abs(p0.kp_dc) / max(abs(g), 1e-12)
            for _ in range(steps):
                kp = kp - lr * _grad_of(kp, p, u, y, windows)[1]
            with torch.no_grad():
                loss1 = _grad_loss(kp, p, u, y, windows).item()
            rec.update(fd=fd, fd_rel_err=abs(g - fd) / abs(fd), tol=GRAD_FD_TOL,
                       descent_steps=steps, loss_after=loss1)
        out[str(dtype).split(".")[-1]] = rec
    f64 = out["float64"]

    def tune(n_windows):
        loss, gains = gain_tuning.make_loss(windows=n_windows, n_sub=tune_sub,
                                            device=device)
        t = time.perf_counter()
        v, grads = gain_tuning.value_and_grad(loss, gains)
        force_sync((v, grads))
        return dict(windows=n_windows, seconds=time.perf_counter() - t,
                    loss=v.item(), grads={k: g.item() for k, g in grads.items()})

    runs = [tune(tune_probe)]
    estimate = runs[0]["seconds"] * tune_windows / tune_probe
    if tune_windows != tune_probe and estimate <= TUNE_LIMIT_S:
        runs.append(tune(tune_windows))
    out["gain_tuning"] = dict(runs=runs, default_windows=tune_windows,
                              default_estimate_s=estimate,
                              limit_s=TUNE_LIMIT_S)
    phase("grad", card=card, **out)
    if not (np.isfinite(f64["grad"]) and f64["fd_rel_err"] <= GRAD_FD_TOL):
        raise AssertionError(f"grad: autograd {f64['grad']} vs FD {f64['fd']}")
    if not f64["loss_after"] < f64["loss"]:
        raise AssertionError(f"grad: {steps} steps did not lower the loss")
    if not all(np.isfinite(g) for r in runs for g in r["grads"].values()):
        raise AssertionError(f"grad: gain tuning gradient not finite {runs}")
    return out


def run_examples(device, card, examples=EXAMPLES, timeout=600):
    """Phase 28: the four examples (`pvderx_torch.examples`) as
    subprocesses, all started together, on the card (``--cpu`` off it):
    each must exit 0, and the ones that step the env must launch K1 / K2
    as many times as their arguments give."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, runpy, sys\n"
            "mod, sys.argv = sys.argv[1], sys.argv[1:]\n"
            "runpy.run_module(mod, run_name='__main__', alter_sys=True)\n"
            "from pvderx_torch.ops.window import (rk4_fleet_window_batch,"
            " rk4_window_batch)\n"
            "print('LAUNCHES ' + json.dumps({'k1': rk4_window_batch.launches,"
            " 'k2': rk4_fleet_window_batch.launches}))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cuda = torch.device(device).type == "cuda"
    procs = {}
    t = time.perf_counter()
    try:
        for name, args, _ in examples:
            cmd = [sys.executable, "-c", code, f"pvderx_torch.examples.{name}",
                   *args] + ([] if cuda else ["--cpu"])
            procs[name] = subprocess.Popen(cmd, cwd=root, env=env,
                                           stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)
        results = {name: wait_for(p, f"example {name}", timeout)
                   for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for name, args, want in examples:
        stdout, stderr = results[name]
        line = [ln for ln in stdout.splitlines() if ln.startswith("LAUNCHES ")]
        launches = json.loads(line[-1][9:]) if line else None
        out[name] = dict(args=args, rc=procs[name].returncode,
                         launches=launches, want=want)
        phase("examples", card=card, example=name, **out[name])
        if procs[name].returncode != 0 or launches is None:
            raise AssertionError(f"example {name} failed "
                                 f"(rc {procs[name].returncode}):\n"
                                 f"{stderr[-2000:]}")
        if cuda and launches != want:
            raise AssertionError(f"example {name}: launches {launches}, "
                                 f"want {want}")
    phase("examples", card=card, seconds=time.perf_counter() - t)
    return out


# ---------------------------------------------------------------------------
# phases 29-34: the distributed layer (`pvderx_torch.dist`)
# ---------------------------------------------------------------------------
# The widths of the dist phases: the main path's, the learners' benchmark
# widths, config 5's fleet; examples at a small size.
DIST = dict(n_envs=N_ENVS, steps=CHUNK_STEPS, short=60, fleet_envs=2048,
            m=FLEET_M, n_sub=N_SUB, ppo_envs=PPO_ENVS, off_envs=OFFPOLICY_ENVS,
            hidden=[128, 128], ppo=[16, 4, 4], off=[4, 4, 1024, 262144],
            timed=5, off_timed=3, fleet_timed=3, tp_timed=1,
            examples=[["train_ppo", ["--tp", "2", "--n-envs", "1024",
                                     "--updates", "1"], 16],
                      ["train_dqn", ["--n-envs", "1024", "--updates", "1"],
                       8],
                      ["train_sac", ["--n-envs", "512", "--updates", "1"],
                       8]])
DIST_PARAM_TOL = 1e-5        # W ranks vs one rank, params (test_dist.py:73)
DIST_REWARD_TOL = 1e-6       # reward_mean (test_dist.py:74)
DIST_RESET_TOL = 1e-4        # a reset of N/W envs vs the slice of N's
DIST_TP_RTOL, DIST_TP_ATOL = 1e-5, 1e-6   # test_tp.py:69-74


def _dist_cfgs(device, s):
    """The env configs of the dist phases: (single-DER, fleet)."""
    from pvderx_torch.env import make_env_config, make_fleet_config

    kw = dict(dtype=torch.float32, n_sub=s["n_sub"], device=device)
    return (make_env_config("10", horizon=s["steps"], **kw),
            make_fleet_config("10", m=s["m"], **kw))


def _dist_learners(device, s, mesh=None):
    """{name: (init_runner, train_step, n_envs, metric)} of the dist phases'
    learners at their widths; ``mesh`` as `make_ppo`'s."""
    from pvderx_torch.env import make_env_config
    from pvderx_torch.learn import (
        DQNConfig, PPOConfig, SACConfig, make_dqn, make_ppo, make_sac)

    cfg, fc = _dist_cfgs(device, s)
    kw = dict(hidden=tuple(s["hidden"]), mesh=mesh)
    t, e, b = s["ppo"]
    ppo = PPOConfig(rollout_len=t, n_epochs=e, n_minibatch=b)
    rl, nu, bs, cap = s["off"]
    off = dict(rollout_len=rl, n_updates=nu, batch_size=bs, capacity=cap)
    cont = make_env_config("10", dtype=torch.float32, n_sub=s["n_sub"],
                           device=device, continuous=True)
    return {
        "ppo": (*make_ppo(cfg, ppo, **kw)[:2], s["ppo_envs"], "loss"),
        "fleet_ppo": (*make_ppo(fc, ppo, **kw)[:2], s["fleet_envs"], "loss"),
        "dqn": (*make_dqn(cfg, DQNConfig(**off), **kw)[:2], s["off_envs"],
                "loss"),
        "sac": (*make_sac(cont, SACConfig(**off), **kw)[:2], s["off_envs"],
                "critic_loss")}


def _dist_env_fns(kind, device, s, mesh=None):
    """(reset_batch, roll(state, obs, gen, n_steps), n_envs) of an env leg."""
    from pvderx_torch.dist.mesh import draw_rows
    from pvderx_torch.env import (
        fleet_rollout, make_batch_fns, make_batch_fns_df,
        make_fleet_batch_fns, rollout, rollout_df)

    cfg, fc = _dist_cfgs(device, s)
    zero = lambda o, g: torch.zeros(len(o), dtype=torch.int64,
                                    device=o.device)
    if kind == "fleet":
        rand = lambda o, g: draw_rows(mesh, lambda sh: torch.randint(
            0, 5, sh, generator=g, device=o.device), (len(o),))
        return (make_fleet_batch_fns(fc, mesh)[0],
                lambda st, ob, g, n: fleet_rollout(fc, st, ob, rand, n, g,
                                                   mesh), s["fleet_envs"])
    if kind == "df32":
        return (make_batch_fns_df(cfg, mesh)[0],
                lambda st, ob, g, n: rollout_df(cfg, st, ob, zero, n, g,
                                                mesh), s["n_envs"])
    return (make_batch_fns(cfg, mesh)[0],
            lambda st, ob, g, n: rollout(cfg, st, ob, zero, n, g, mesh),
            s["n_envs"])


def _dist_env_steps(kind, s):
    return s["steps"] if kind == "env" else s["short"]


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def _host(tree):
    """A state (or the df32 carry, a tuple) with every tensor on the CPU."""
    from pvderx_torch._struct import tree_map

    if isinstance(tree, tuple):
        return tuple(_host(v) for v in tree)
    return tree_map(lambda x: x.cpu(), tree)


def _kernel_of(kind):
    from pvderx_torch.ops.dualfloat import rk4_window_batch_df
    from pvderx_torch.ops.window import rk4_fleet_window_batch, rk4_window_batch

    return {"fleet": rk4_fleet_window_batch,
            "df32": rk4_window_batch_df}.get(kind, rk4_window_batch)


def _flat_params(runner):
    mods = [getattr(runner, k) for k in ("net", "actor", "critic")
            if hasattr(runner, k)]
    return [p.detach() for m in mods for p in m.parameters()]


def _max_err(a, b) -> float:
    return max(float((x.detach().cpu().float() - y.cpu().float()).abs().max())
               for x, y in zip(a, b))


def _replicas_equal(params, mesh) -> bool:
    """Every rank of the env axis holds the same bits of ``params``."""
    flat = torch.cat([p.reshape(-1) for p in params])[None]
    every = mesh.all_gather(flat)
    return all(torch.equal(every[0], every[i]) for i in range(len(every)))


def _dist_world1(device, card, s, workdir, backend):
    """World 1 in this process (the real backend's path: NCCL on the card):
    the env legs from one seeded reset each, bitwise against the un-meshed
    rollout; the learners' one-rank train step from their saved runners.
    Writes what the ranks compare with."""
    import os

    from pvderx_torch import dist
    from pvderx_torch.diag import checkpoint

    dist.init_multihost(f"file://{os.path.join(workdir, 'world1')}", 1, 0,
                        backend=backend)
    mesh = dist.make_mesh(device=device)
    out = {"backend": backend, "world": 1}
    for kind in ("env", "fleet", "df32"):
        reset, _, n = _dist_env_fns(kind, device, s)
        reset_m, roll_m, _ = _dist_env_fns(kind, device, s, mesh)
        _, roll, _ = _dist_env_fns(kind, device, s)
        steps = _dist_env_steps(kind, s)
        t = time.perf_counter()
        state, obs = reset(n, _gen(device, 11))
        _sync(device)
        reset_s = time.perf_counter() - t
        st_m, obs_m = reset_m(n, _gen(device, 11))
        y = lambda st: (st[0] if kind == "df32" else st).y
        reset_same = bool(torch.equal(y(st_m), y(state))
                          and torch.equal(obs_m, obs))
        torch.save({"state": _host(state), "obs": obs.cpu()},
                   os.path.join(workdir, f"{kind}-reset.pt"))
        ref = roll(state, obs, _gen(device, 12), steps)
        _zero_counts()
        t = time.perf_counter()
        got = roll_m(state, obs, _gen(device, 12), steps)
        float(got[2].sum())
        roll_s = time.perf_counter() - t
        launches = _kernel_of(kind).launches
        same = torch.equal(y(ref[0]), y(got[0])) and all(
            torch.equal(a, b) for a, b in zip(ref[1:], got[1:]))
        torch.save({"obs": ref[1].cpu(), "rews": ref[2].cpu(),
                    "dones": ref[3].cpu(), "y": y(ref[0]).cpu()},
                   os.path.join(workdir, f"{kind}-ref.pt"))
        out[kind] = dict(n_envs=n, steps=steps, launches=launches,
                         bitwise_vs_unmeshed=same,
                         reset_bitwise_vs_unmeshed=reset_same,
                         dones=int(ref[3].sum()), reset_s=reset_s,
                         env_steps_per_s=n * steps / roll_s)
        del state, obs, st_m, obs_m, ref, got
    learners = _dist_learners(device, s)
    meshed = _dist_learners(device, s, mesh)
    for name in ("ppo", "dqn", "sac"):
        init, _, n, metric = learners[name]
        runner = init(n, _gen(device, 0))
        checkpoint.save(os.path.join(workdir, f"{name}0.pt"), runner)
        _, ts_m, _, _ = meshed[name]
        _zero_counts()
        runner, m = ts_m(dist.shard_runner(runner, mesh))
        rec = {"params": [p.cpu().clone() for p in _flat_params(runner)],
               "metrics": {k: float(v) for k, v in m.items()}}
        torch.save(rec, os.path.join(workdir, f"{name}-w1.pt"))
        timed = s["timed"] if name == "ppo" else s["off_timed"]
        runner, m, host_s, collect_ms, update_ms = _time_train(
            ts_m, runner, timed, device, metric)
        rl = s["ppo"][0] if name == "ppo" else s["off"][0]
        out[name] = dict(n_envs=n, launches=_kernel_of("env").launches,
                         env_steps=(1 + timed) * rl,
                         env_steps_per_s=n * rl * timed / host_s,
                         train_step_ms=1e3 * host_s / timed,
                         update_ms_per_train_step=update_ms / timed,
                         metrics=rec["metrics"])
        del runner
    dist.shutdown()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


# -- the rank side (python -m chip_smoke --dist-worker WORKDIR LEG ...) -----
def _leg_env(kind, workdir, mesh, s):
    import os

    from pvderx_torch import dist

    dev = mesh.device
    reset_m, roll_m, n = _dist_env_fns(kind, dev, s, mesh)
    steps = _dist_env_steps(kind, s)
    saved = torch.load(os.path.join(workdir, f"{kind}-reset.pt"),
                       map_location=dev, weights_only=False)
    ref = torch.load(os.path.join(workdir, f"{kind}-ref.pt"),
                     map_location=dev, weights_only=False)
    sl = mesh.rows(n)
    state = dist.shard_batch(saved["state"], mesh)
    obs = dist.shard_batch(saved["obs"], mesh)
    y = lambda st: (st[0] if kind == "df32" else st).y
    _zero_counts()
    dist.sync_hosts()
    t = time.perf_counter()
    st, ob, rews, dones = roll_m(state, obs, _gen(dev, 12), steps)
    float(rews.sum())
    roll_s = time.perf_counter() - t
    launches = _kernel_of(kind).launches
    same = {"obs": torch.equal(ob, ref["obs"][sl]),
            "rews": torch.equal(rews, ref["rews"][:, sl]),
            "dones": torch.equal(dones, ref["dones"][:, sl]),
            "y": torch.equal(y(st), ref["y"][sl])}
    st_r, obs_r = reset_m(n, _gen(dev, 11))
    return dict(kind=kind, n_envs=n, local_envs=sl.stop - sl.start,
                steps=steps, launches=launches, bitwise=same,
                roll_s=roll_s, dones=int(dones.sum()),
                reset_err=float((y(st_r) - y(saved["state"])[sl]).abs().max()),
                reset_obs_err=float((obs_r - saved["obs"][sl]).abs().max()))


# `checkpoint.restore` replaces every tensor of its target (modules and
# optimizers loaded in place), so a runner of a few envs serves as the
# template of a full-width one, without a full-width reset
TEMPLATE_ENVS = 4


def _whole_runner(name, workdir, dev, s):
    """The runner world 1 saved, rebuilt whole on this rank."""
    import os

    from pvderx_torch.diag import checkpoint

    init = _dist_learners(dev, s)[name][0]
    return checkpoint.restore(os.path.join(workdir, f"{name}0.pt"),
                              init(TEMPLATE_ENVS, _gen(dev, 1)))


class _CollectiveClock:
    """Host seconds spent in ``torch.distributed.all_reduce`` while on (the
    device synced before and after each call)."""

    def __init__(self, device):
        import torch.distributed as tdist

        self.device, self.seconds, self.calls = device, 0.0, 0
        self._dist, self._orig = tdist, tdist.all_reduce

    def __enter__(self):
        def timed(*a, **kw):
            _sync(self.device)
            t = time.perf_counter()
            out = self._orig(*a, **kw)
            _sync(self.device)
            self.seconds += time.perf_counter() - t
            self.calls += 1
            return out
        self._dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self._dist.all_reduce = self._orig


def _leg_learner(name, workdir, mesh, s):
    import os

    from pvderx_torch import dist

    dev = mesh.device
    _, ts, n, metric = _dist_learners(dev, s, mesh)[name]
    rl = s["ppo"][0] if name in ("ppo", "fleet_ppo") else s["off"][0]
    timed = {"ppo": s["timed"], "fleet_ppo": s["fleet_timed"]}.get(
        name, s["off_timed"])
    out = dict(learner=name, n_envs=n, rollout_len=rl)
    _zero_counts()
    if name == "fleet_ppo":
        runner = _dist_learners(dev, s, mesh)[name][0](n, _gen(dev, 0))
    else:
        runner = dist.shard_runner(_whole_runner(name, workdir, dev, s), mesh)
        _zero_counts()
        runner, m = ts(runner)
        want = torch.load(os.path.join(workdir, f"{name}-w1.pt"),
                          weights_only=False)
        out.update(
            param_err=_max_err(_flat_params(runner), want["params"]),
            reward_mean_err=abs(float(m["reward_mean"])
                                - want["metrics"]["reward_mean"]),
            replicas_bitwise=_replicas_equal(_flat_params(runner), mesh))
    runner, m, host_s, collect_ms, update_ms = _time_train(
        ts, runner, timed, dev, metric)
    out.update(timed_train_steps=timed, host_s=host_s,
               collect_ms_per_train_step=collect_ms / timed,
               update_ms_per_train_step=update_ms / timed,
               launches=_kernel_of("fleet" if name == "fleet_ppo"
                                   else "env").launches,
               env_steps=(timed + (name != "fleet_ppo")) * rl,
               metrics={k: float(v) for k, v in m.items()})
    if name == "ppo":
        with _CollectiveClock(dev) as clock:
            t = time.perf_counter()
            runner, rollout = ts.collect(runner)
            _sync(dev)
            t = time.perf_counter()
            runner, m = ts.update(runner, rollout)
            _sync(dev)
            upd_s = time.perf_counter() - t
        out.update(all_reduce_s=clock.seconds, all_reduce_calls=clock.calls,
                   instrumented_update_s=upd_s,
                   all_reduce_share=clock.seconds / upd_s)
    return out, runner


def _leg_checkpoint(runner, workdir, mesh, s):
    """The PPO runner of the ppo leg saved over the mesh, restored into one
    built under the mesh from another seed, both trained one step."""
    import os

    from pvderx_torch.diag import checkpoint

    init, ts, n, _ = _dist_learners(mesh.device, s, mesh)["ppo"]
    path = checkpoint.save(os.path.join(workdir, "ckpt-w2"), runner, mesh)
    restored = checkpoint.restore(path, init(n, _gen(mesh.device, 7)), mesh)
    runner, m1 = ts(runner)
    restored, m2 = ts(restored)
    diffs = bitwise_differences(checkpoint.plain(runner),
                                checkpoint.plain(restored))
    return dict(files=sorted(os.listdir(path)), differences=diffs[:8],
                loss=[float(m1["loss"]), float(m2["loss"])])


def _leg_tp(workdir, mesh, s, n_env):
    """PPO on the (n_env, 2) mesh from world 1's runner against world 1's
    DP-only step; then the TP step timed."""
    import os

    from pvderx_torch import dist
    from pvderx_torch.dist.tp import gather_param, make_mesh_2d

    dev = mesh.device
    mesh2 = make_mesh_2d(n_env, 2, device=dev)
    _, ts, _, metric = _dist_learners(dev, s, mesh2)["ppo"]
    runner = dist.shard_runner_tp(_whole_runner("ppo", workdir, dev, s),
                                  mesh2)
    w0 = tuple(runner.net.trunk[0].weight.shape)
    _zero_counts()
    runner, m = ts(runner)
    full = [gather_param(p.detach(), p, mesh2).cpu().clone()
            for p in runner.net.parameters()]
    want = torch.load(os.path.join(workdir, "ppo-w1.pt"), weights_only=False)
    excess = max(float(((a - b).abs() - DIST_TP_ATOL
                        - DIST_TP_RTOL * b.abs()).max())
                 for a, b in zip(full, want["params"]))
    loss_w1 = want["metrics"]["loss"]
    mu0 = runner.opt.state[runner.net.trunk[0].weight]["exp_avg"]
    runner, m2, host_s, _, update_ms = _time_train(ts, runner, s["tp_timed"],
                                                   dev, metric)
    return dict(mesh=[n_env, 2], coords=list(mesh2.coords),
                loss=float(m["loss"]), loss_w1=loss_w1,
                loss_ok=abs(float(m["loss"]) - loss_w1)
                <= DIST_TP_ATOL + DIST_TP_RTOL * abs(loss_w1),
                param_excess_over_tol=excess,
                param_err=_max_err(full, want["params"]),
                dense0_local=list(w0), mu0_local=list(mu0.shape),
                launches=_kernel_of("env").launches,
                tp_train_step_ms=1e3 * host_s / s["tp_timed"],
                tp_update_ms=update_ms / s["tp_timed"])


def _leg_ckpt_tp(workdir, mesh, s):
    """A DP checkpoint (env axis 2, whole nets) restored onto the (2, 2)
    mesh continues bitwise as `shard_runner_tp` of the saved runner; onto
    this 1-D mesh of 4 env ranks it raises."""
    import os

    from pvderx_torch import dist
    from pvderx_torch.diag import checkpoint
    from pvderx_torch.dist.tp import make_mesh_2d

    dev = mesh.device
    mesh2 = make_mesh_2d(2, 2, device=dev)
    init, ts1, _, _ = _dist_learners(dev, s)["ppo"]
    _, ts2, _, _ = _dist_learners(dev, s, mesh2)["ppo"]
    original, _ = ts1(_whole_runner("ppo", workdir, dev, s))
    path = checkpoint.save(os.path.join(workdir, "ckpt-dp2"),
                           dist.shard_runner(original, mesh2), mesh2)
    template = lambda seed: init(TEMPLATE_ENVS, _gen(dev, seed))
    try:
        checkpoint.restore(path, dist.shard_runner(template(8), mesh), mesh)
        wrong = None
    except ValueError as e:
        wrong = str(e)
    direct = dist.shard_runner_tp(original, mesh2)
    restored = checkpoint.restore(
        path, dist.shard_runner_tp(template(9), mesh2), mesh2)
    direct, m1 = ts2(direct)
    restored, m2 = ts2(restored)
    same = all(torch.equal(a, b) for a, b in zip(direct.net.parameters(),
                                                 restored.net.parameters()))
    return dict(files=sorted(os.listdir(path)),
                loss=[float(m1["loss"]), float(m2["loss"])],
                params_bitwise=same, wrong_size_error=wrong)


def dist_worker(workdir: str, gate: str, legs) -> int:
    """One rank of the dist phases: joins the launcher's group, waits for
    the file ``WORKDIR/GATE`` (`run_dist` writes it once the inputs of the
    legs are there), runs the legs in order, writes each leg's JSON to
    ``WORKDIR/LEG-rank{r}.json``."""
    import os

    from pvderx_torch import dist

    with open(os.path.join(workdir, "sizes.json")) as fh:
        s = json.load(fh)
    device = s.pop("device")
    dist.init_multihost()
    mesh = dist.make_mesh(device=device)
    torch.zeros(1, device=mesh.device)         # the card's context, if any
    while not os.path.exists(os.path.join(workdir, gate)):
        time.sleep(0.05)
    rank = torch.distributed.get_rank()
    ppo_runner = None
    for leg in legs:
        t = time.perf_counter()
        if leg in ("env", "fleet", "df32"):
            out = _leg_env(leg, workdir, mesh, s)
        elif leg in ("ppo", "fleet_ppo", "dqn", "sac"):
            out, runner = _leg_learner(leg, workdir, mesh, s)
            ppo_runner = runner if leg == "ppo" else ppo_runner
        elif leg == "checkpoint":
            out = _leg_checkpoint(ppo_runner, workdir, mesh, s)
        elif leg in ("tp12", "tp22"):
            out = _leg_tp(workdir, mesh, s, 1 if leg == "tp12" else 2)
        else:
            out = _leg_ckpt_tp(workdir, mesh, s)
        out.update(leg_s=time.perf_counter() - t, backend=mesh.backend,
                   world=mesh.size())
        with open(os.path.join(workdir, f"{leg}-rank{rank}.json"),
                  "w") as fh:
            json.dump(out, fh)
    dist.sync_hosts("legs")
    dist.shutdown()
    return 0


def example_rank(module: str, args) -> int:
    """One rank of an example under the launcher: the example, then this
    rank's K1 launches on a line of its own."""
    import os
    import runpy

    sys.argv = [module, *args]
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    from pvderx_torch.ops.window import rk4_window_batch

    # one write of the whole line: the ranks share the launcher's stdout
    sys.stdout.write(f"LAUNCHES rank={os.environ.get('RANK')} "
                     f"k1={rk4_window_batch.launches}\n")
    sys.stdout.flush()
    return 0


def _launch_ranks(nproc, args, root, cpu, timeout):
    """`pvderx_torch.dist.launch` as a subprocess: (rc, stdout, stderr)."""
    import os

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "pvderx_torch.dist.launch", "--nproc",
           str(nproc), "--backend", "gloo", "--timeout", str(timeout)]
    return subprocess.Popen(cmd + (["--cpu"] if cpu else []) + args, cwd=root,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


# the legs of the two gloo jobs, by world size
DIST_LEGS = {2: ["env", "fleet", "df32", "ppo", "fleet_ppo", "dqn", "sac",
                 "checkpoint", "tp12"],
             4: ["tp22", "ckpt_tp"]}


def start_dist_ranks(device, s=DIST, timeout=900):
    """Start the world-2 and world-4 jobs of phases 29-33 (gloo ranks of
    `pvderx_torch.dist.launch`), each held at a gate after joining its
    group, so that their start-up (imports, the card's context, the
    rendezvous) overlaps what the caller runs next; `run_dist` opens each
    gate once the job's inputs are written. Returns the jobs; the caller
    ends them with `stop_dist_ranks`."""
    import os
    import tempfile

    cuda = torch.device(device).type == "cuda"
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dist_")
    with open(os.path.join(tmp.name, "sizes.json"), "w") as fh:
        json.dump(dict(s, device=device), fh)
    jobs = dict(tmp=tmp, workdir=tmp.name, procs={})
    try:
        for w, legs in DIST_LEGS.items():
            jobs["procs"][w] = _launch_ranks(
                w, ["-m", "chip_smoke", "--dist-worker", tmp.name,
                    f"gate-w{w}", *legs], root, not cuda, timeout)
    except BaseException:
        stop_dist_ranks(jobs)
        raise
    return jobs


def stop_dist_ranks(jobs) -> None:
    stop_launches(list(jobs["procs"].values()))
    jobs["tmp"].cleanup()


def _run_job(jobs, w, timeout):
    """Open world ``w``'s gate and wait for its job: (return code, stderr,
    seconds from the gate)."""
    import os

    t = time.perf_counter()
    open(os.path.join(jobs["workdir"], f"gate-w{w}"), "w").close()
    p = jobs["procs"][w]
    _, err = wait_for(p, f"dist world {w} ranks", timeout + 60)
    return p.returncode, err, time.perf_counter() - t


def start_dist_examples(device, s=DIST, timeout=900):
    """Start the three training examples, 2 gloo ranks each, all together
    (phase 34). They check exit codes and launch counts only, so they may
    run beside phase 28's examples. Returns (start time, [(name, want,
    launcher process)]) for `finish_dist_examples`."""
    import os

    cuda = torch.device(device).type == "cuda"
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    try:
        for name, args, want in s["examples"]:
            procs.append((name, want, _launch_ranks(
                2, ["-m", "chip_smoke", "--example-rank",
                    f"pvderx_torch.examples.{name}", *args, "--n-sub",
                    str(s["n_sub"])] + ([] if cuda else ["--cpu"]), root,
                not cuda, timeout)))
    except BaseException:
        stop_launches([p for _, _, p in procs])
        raise
    return time.perf_counter(), procs


def finish_dist_examples(started, timeout=900):
    """Wait for the examples `start_dist_examples` started: ({name: (want,
    return code, (stdout, stderr))}, seconds since their start)."""
    t, procs = started
    try:
        ex = {name: (want, wait_for(p, f"dist example {name}",
                                    timeout + 60))
              for name, want, p in procs}
    finally:
        stop_launches([p for _, _, p in procs])
    return {name: (want, p.returncode, ex[name][1])
            for name, want, p in procs}, time.perf_counter() - t


def stop_launches(procs) -> None:
    """Interrupt launchers still running (each then stops its ranks) and
    wait for them."""
    import signal

    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGINT)
    for p in procs:
        try:
            p.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()


def _print_partial(card, w1, workdir, legs, nproc):
    """What a failed run of ranks left: world 1's readings and the legs
    that finished, printed as they are."""
    import os

    phase("dist_partial", card=card, world=1, **w1)
    for leg in legs:
        for r in range(nproc):
            path = os.path.join(workdir, f"{leg}-rank{r}.json")
            if os.path.exists(path):
                with open(path) as fh:
                    phase("dist_partial", card=card, leg=leg, rank=r,
                          **json.load(fh))


def _read_legs(workdir, legs, nproc):
    import os

    out = {}
    for leg in legs:
        out[leg] = []
        for r in range(nproc):
            with open(os.path.join(workdir, f"{leg}-rank{r}.json")) as fh:
                out[leg].append(json.load(fh))
    return out


def dist_launches(out) -> dict:
    """The dist phases' launches per kernel for the kernels line: world 1's
    and every rank's, by leg."""
    w1, r2, r4 = out["w1"], out["r2"], out["r4"]
    per = lambda legs: [g["launches"] for g in legs]
    return {
        "k1": {"dist_env_w1": w1["env"]["launches"],
               "dist_env_w2": per(r2["env"]),
               "dist_ppo_w1": w1["ppo"]["launches"],
               "dist_ppo_w2": per(r2["ppo"]),
               "dist_dqn_w1": w1["dqn"]["launches"],
               "dist_dqn_w2": per(r2["dqn"]),
               "dist_sac_w1": w1["sac"]["launches"],
               "dist_sac_w2": per(r2["sac"]),
               "dist_tp_1x2": per(r2["tp12"]), "dist_tp_2x2": per(r4["tp22"]),
               "dist_examples": out["examples"]},
        "k2": {"dist_fleet_w1": w1["fleet"]["launches"],
               "dist_fleet_w2": per(r2["fleet"]),
               "dist_fleet_ppo_w2": per(r2["fleet_ppo"])},
        "k3": {"dist_df32_w1": w1["df32"]["launches"],
               "dist_df32_w2": per(r2["df32"])}}


def run_dist(device, card, s=DIST, timeout=900, ranks=None, examples=None):
    """Phases 29-34 (the module docstring): world 1 in this process on the
    card's backend (NCCL), then world 2 and world 4 as gloo ranks sharing
    the card (`pvderx_torch.dist.launch`): ``ranks``, what
    `start_dist_ranks` returned if the caller started them, else started
    here; then the three training examples as 2 ranks each, started
    together: ``examples``, what `finish_dist_examples` returned if the
    caller ran them, else here. Returns the readings; raises on the first
    failed check once every line has printed."""
    jobs = ranks or start_dist_ranks(device, s, timeout)
    try:
        return _run_dist(device, card, s, timeout, jobs, examples)
    finally:
        stop_dist_ranks(jobs)


def _run_dist(device, card, s, timeout, jobs, examples):
    import re

    cuda = torch.device(device).type == "cuda"
    workdir = jobs["workdir"]
    t_all = time.perf_counter()
    fails = []

    def check(ok, what):
        if not ok:
            fails.append(what)

    t = time.perf_counter()
    w1 = _dist_world1(device, card, s, workdir, "nccl" if cuda else "gloo")
    w1_s = time.perf_counter() - t
    secs = {}
    for w, legs in DIST_LEGS.items():
        rc, err, secs[w] = _run_job(jobs, w, timeout)
        if rc != 0:
            _print_partial(card, w1, workdir, legs, w)
            raise AssertionError(f"dist world {w} failed (rc {rc}):"
                                 f"\n{err[-3000:]}")
    r2, r4 = (_read_legs(workdir, DIST_LEGS[w], w) for w in (2, 4))
    w2_s, w4_s = secs[2], secs[4]
    ex, ex_s = examples or finish_dist_examples(
        start_dist_examples(device, s, timeout), timeout)

    # -- dist_env -------------------------------------------------------------
    for kind in ("env", "fleet", "df32"):
        a = w1[kind]
        phase("dist_env", card=card, backend="nccl" if cuda else "gloo",
              world=1, **a)
        check(a["bitwise_vs_unmeshed"] and a["reset_bitwise_vs_unmeshed"],
              f"dist_env world 1 {kind}: not bitwise the un-meshed path")
        check(not cuda or a["launches"] == a["steps"],
              f"dist_env world 1 {kind}: launches {a['launches']}")
        ranks = r2[kind]
        rate = a["n_envs"] * a["steps"] / max(g["roll_s"] for g in ranks)
        for g in ranks:
            phase("dist_env", card=card, world_env_steps_per_s=rate,
                  reset_tol=DIST_RESET_TOL, **g)
            check(all(g["bitwise"].values()),
                  f"dist_env world 2 {kind}: {g['bitwise']}")
            check(not cuda or g["launches"] == g["steps"],
                  f"dist_env world 2 {kind}: launches {g['launches']}")
            check(g["reset_err"] <= DIST_RESET_TOL
                  and g["reset_obs_err"] <= DIST_RESET_TOL,
                  f"dist_env world 2 {kind}: reset {g['reset_err']}")
        if kind == "env":
            check(a["dones"] > 0, "dist_env: the horizon did not end")
    # -- dist_ppo / dist_offpolicy --------------------------------------------
    for name in ("ppo", "fleet_ppo", "dqn", "sac"):
        ranks = r2[name]
        label = "dist_ppo" if "ppo" in name else "dist_offpolicy"
        n, rl = ranks[0]["n_envs"], ranks[0]["rollout_len"]
        rate = n * rl * ranks[0]["timed_train_steps"] / max(
            g["host_s"] for g in ranks)
        if name in w1:
            phase(label, card=card, backend="nccl" if cuda else "gloo",
                  world=1, learner=name, **w1[name])
        for g in ranks:
            phase(label, card=card, world_env_steps_per_s=rate, **g)
            check(all(np.isfinite(v) for v in g["metrics"].values()),
                  f"{label} {name}: metrics {g['metrics']}")
            check(not cuda or g["launches"] == g["env_steps"],
                  f"{label} {name}: launches {g['launches']}")
            if name != "fleet_ppo":
                check(g["param_err"] <= DIST_PARAM_TOL
                      and g["reward_mean_err"] <= DIST_REWARD_TOL
                      and g["replicas_bitwise"],
                      f"{label} {name}: world 2 vs 1 {g['param_err']}, "
                      f"{g['reward_mean_err']}, {g['replicas_bitwise']}")
    # -- dist_tp ----------------------------------------------------------------
    for leg, ranks in (("tp12", r2["tp12"]), ("tp22", r4["tp22"])):
        for g in ranks:
            phase("dist_tp", card=card, **g)
            check(g["loss_ok"] and g["param_excess_over_tol"] <= 0.0,
                  f"dist_tp {leg}: loss {g['loss']} vs {g['loss_w1']}, "
                  f"params {g['param_err']}")
            check(g["dense0_local"][0] * 2 == s["hidden"][0]
                  and g["mu0_local"] == g["dense0_local"],
                  f"dist_tp {leg}: Dense_0 not split {g['dense0_local']}")
    # -- dist_checkpoint --------------------------------------------------------
    for g in r2["checkpoint"]:
        phase("dist_checkpoint", card=card, case="world2_resume", **g)
        check(not g["differences"] and g["loss"][0] == g["loss"][1],
              f"dist_checkpoint world 2: {g['differences']}")
    for g in r4["ckpt_tp"]:
        phase("dist_checkpoint", card=card, case="dp_onto_tp_2x2", **g)
        check(g["params_bitwise"] and g["loss"][0] == g["loss"][1]
              and g["wrong_size_error"] is not None,
              f"dist_checkpoint onto (2, 2): {g}")
    # -- dist_examples -----------------------------------------------------------
    launches = {}
    for name, (want, rc, (stdout, stderr)) in ex.items():
        got = sorted(int(k) for k in re.findall(
            r"LAUNCHES rank=\d+ k1=(\d+)", stdout))
        launches[name] = got
        phase("dist_examples", card=card, backend="gloo", world=2,
              example=name, rc=rc, k1_launches_per_rank=got, want=want)
        check(rc == 0 and len(got) == 2,
              f"dist_examples {name}: rc {rc}\n{stderr[-2000:]}")
        check(not cuda or got == [want, want],
              f"dist_examples {name}: launches {got}, want {want}")
    seconds = dict(world1_s=w1_s, world2_s=w2_s, world4_s=w4_s,
                   examples_s=ex_s, total_s=time.perf_counter() - t_all)
    phase("dist", card=card, backends={"world1": "nccl" if cuda else "gloo",
                                       "world2": "gloo", "world4": "gloo"},
          **seconds)
    if fails:
        raise AssertionError("dist: " + "; ".join(fails))
    return dict(w1=w1, r2=r2, r4=r4, examples=launches, seconds=seconds)


def run_examples_and_dist(device, card):
    """Phases 28-34. Phase 34's examples run beside phase 28's (neither is
    timed), and the gloo jobs of phases 29-33 start then too, held at
    their gates until world 1 has run. Returns (phase 28's readings, the
    dist readings)."""
    ranks = start_dist_ranks(device)
    try:
        started = start_dist_examples(device)
        try:
            examples_out = run_examples(device, card)
        except BaseException:
            stop_launches([p for _, _, p in started[1]])
            raise
        begin("dist_examples")
        dist_ex = finish_dist_examples(started)
        begin("dist")
        return examples_out, run_dist(device, card, ranks=ranks,
                                      examples=dist_ex)
    finally:
        stop_dist_ranks(ranks)


def run_notebooks(device, card, tiny=False, timeout=600):
    """Phase 35: the demo notebooks' compute cells through
    `pvderx_torch.examples.notebooks.run_cells` as a subprocess (``--tiny``
    at `build_notebooks.TINY`'s sizes, for a CPU rehearsal). Every cell's
    K1 launches must equal its env steps on the card (the CPU's plain window
    launches none), each notebook take the steps its sizes give and pass its
    checks. Returns {notebook: its `[notebook]` line}."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cuda = torch.device(device).type == "cuda"
    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pvderx_torch.examples.notebooks.run_cells",
         "--device", device] + (["--tiny"] if tiny else []),
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    stdout, stderr = wait_for(proc, "run_cells", timeout)
    lines = lambda tag: [json.loads(ln[len(tag) + 3:])
                         for ln in stdout.splitlines()
                         if ln.startswith(f"[{tag}] ")]
    cells, books = lines("cell"), {b["notebook"]: b for b in lines("notebook")}
    fails = []
    for name in ("standalone_simulation", "train_rl"):
        b = books.get(name)
        if b is None:
            fails.append(f"{name}: no [notebook] line")
            continue
        mine = [c for c in cells if c["notebook"] == name]
        phase("notebooks", card=card, **b, cells=[
            {k: c[k] for k in ("cell", "seconds", "k1_launches",
                               "env_steps")} for c in mine])
        if not b["checks"]["ok"]:
            fails.append(f"{name}: checks {b['checks']}")
        if b["env_steps"] != b["want_env_steps"]:
            fails.append(f"{name}: {b['env_steps']} env steps, want "
                         f"{b['want_env_steps']}")
        for c in mine:
            if cuda and c["k1_launches"] != c["env_steps"]:
                fails.append(f"{name} cell {c['cell']}: K1 launches "
                             f"{c['k1_launches']} != env steps "
                             f"{c['env_steps']}")
    phase("notebooks", card=card, rc=proc.returncode,
          seconds=time.perf_counter() - t)
    if proc.returncode != 0 or fails:
        raise AssertionError(f"notebooks (rc {proc.returncode}): "
                             + "; ".join(fails) + f"\n{stderr[-3000:]}")
    return books


# ---------------------------------------------------------------------------
# phase 36: the float64 engine (`pvderx_torch.native`, kernels N1-N4)
# ---------------------------------------------------------------------------
# tests/test_native.py's bounds: the RHS and the RK4 window 1e-12 (:36, :45;
# here against the plain versions, as assert_allclose reads them: |a - b|
# <= tol + tol |b|), DP5(4) 1e-8 of LSODA per window (:75), the trajectory
# 5e-8 (:115), the steady state 1e-9 of fsolve with a residual < 1e-9
# (:84-85); N1 against the float64 RK4 window on phase 11's cases as K3
NATIVE_TOL = 1e-12
NATIVE_DP54_TOL = 1e-8
NATIVE_TRAJ_TOL = 5e-8
NATIVE_SS_TOL = 1e-9
NATIVE_EVENTFUL = dict(v_g=0.8, s_irr=700.0, q_ref=0.1, g_load=0.2,
                       b_load=-0.05, v_g2=0.05, phi_g2=0.7, dw_g=0.004,
                       t_g=0.5)               # tests/test_native.py:20-21
NATIVE_SAG_WINDOWS = 12                       # tests/test_native.py:64-76
NATIVE_RESET_ITERS = 20                       # env.core.reset's Newton


def _native_trajectory_exogs(n=30):
    """tests/test_native.py:104-115's schedule: 0.7 pu in windows 10-19."""
    import dataclasses

    from pvderx_torch import nominal_exog

    u = nominal_exog()
    return [dataclasses.replace(u, v_g=0.7) if 10 <= k < 20 else u
            for k in range(n)]


def _close_err(got, want, tol):
    """(max |got - want|, whether |got - want| <= tol + tol |want|
    everywhere), on float64 tensors or arrays."""
    got, want = (torch.as_tensor(a).double().cpu() for a in (got, want))
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= tol + tol * want.abs()).all())
    return float(diff.max()), ok


def _native_packs(p, u, n, device):
    """Shared params / exog expanded to n envs: float64 [29, n], [15, n]."""
    from pvderx_torch import native

    return (native.pack_params(p, device)[:, None].expand(-1, n).contiguous(),
            native.pack_exog(u, device)[:, None].expand(-1, n).contiguous())


def _f64_inputs(preset, n, seed, device, **kw):
    """`window_inputs` (float32, as the float32 kernels take them) and the
    same values in float64: (n_ph, f32 tuple, f64 tuple)."""
    n_ph, *f32 = window_inputs(preset, n, seed, device, **kw)
    return n_ph, f32, [a.double() for a in f32]


def check_native_rhs(device, n_states=25, n_timed=N_ENVS):
    """N4 against its plain version and the numpy oracle: presets 10, 50,
    250 at the eventful exog, 25 states each, and the tripped / const-Vdc
    case; then ms per launch at ``n_timed`` envs. Returns (max error,
    {ms, plain_ms, n})."""
    import dataclasses

    from pvderx_torch import make_params, nominal_exog, oracle
    from pvderx_torch.native import kernels

    cuda = torch.device(device).type == "cuda"
    cases = [(pr, make_params(pr),
              dataclasses.replace(nominal_exog(), **NATIVE_EVENTFUL), 0.123,
              make_params(pr)) for pr in ("10", "50", "250")]
    cases.append(("tripped_const_vdc", make_params("50", const_vdc=1.0),
                  dataclasses.replace(nominal_exog(p_ref=0.5), conn=0.0,
                                      ces=1.0), 0.0, make_params("50")))
    worst = 0.0
    for name, p, u, t, p_ss in cases:
        y_ss = oracle.steady_state(p_ss, nominal_exog())
        k = n_states if name != "tripped_const_vdc" else 1
        ys = y_ss + np.random.default_rng(42).normal(
            0.0, 0.05 if k > 1 else 0.0, (k, y_ss.size))
        y = torch.tensor(ys, dtype=torch.float64, device=device)
        tt = torch.full((k,), t, dtype=torch.float64, device=device)
        pk, uk = _native_packs(p, u, k, device)
        before = kernels.rhs_batch.launches
        got = kernels.rhs_batch(y, tt, pk, uk, n_ph=p.n_ph)
        moved = kernels.rhs_batch.launches - before
        plain = kernels._rhs_ref(y, tt, pk, uk, n_ph=p.n_ph)
        err, ok = _close_err(got, plain, NATIVE_TOL)
        err_np, ok_np = _close_err(
            got, np.stack([oracle.rhs_np(v, t, p, u) for v in ys]), NATIVE_TOL)
        phase("native", kernel="N4", case=name, n=k, max_abs_err=err,
              oracle_max_abs_err=err_np, tol=NATIVE_TOL, launches=moved)
        if not (ok and ok_np):
            raise AssertionError(f"N4 {name}: {err:.3e} / {err_np:.3e} > "
                                 f"{NATIVE_TOL} (rtol and atol)")
        if cuda and moved != 1:
            raise AssertionError(f"N4 launch counter moved by {moved}, not 1")
        worst = max(worst, err)
    n_ph, _, (y, t0, pp, uu) = _f64_inputs("10", n_timed, 40, device)
    timed = {"n": n_timed}
    if cuda:
        call = lambda: kernels.rhs_batch(y, t0, pp, uu, n_ph=n_ph)
        timed["ms"] = _time_ms(call, 20, device)
        timed["plain_ms"] = _timed(lambda: kernels._rhs_ref(
            y, t0, pp, uu, n_ph=n_ph), device)[1]
        phase("native", kernel="N4", case="ms_per_launch", **timed)
    return worst, timed


def check_native_rk4(device, n=N_ENVS, n_sub=N_SUB, cases=KERNEL_CASES,
                     f64_n=4, timed_n=N_ENVS):
    """N1 at full width (preset 10, n envs, n_sub) against the plain
    float64 window; on phase 11's cases (its seeds, f64_n envs each)
    against `oracle.rk4_window_np`, beside K3 and K1 on the same inputs;
    ms per launch of N1, K1 and K3 at presets 10 and 50 on the same
    inputs; the public batch against its one-env calls bit for bit.
    Returns (max error vs plain, {timings})."""
    import dataclasses

    from pvderx_torch import make_params, native, nominal_exog, oracle
    from pvderx_torch.native import kernels
    from pvderx_torch.ops.dualfloat import rk4_window_batch_df
    from pvderx_torch.ops.window import rk4_window_batch, rk4_window_batch_ref

    cuda = torch.device(device).type == "cuda"
    wkw = dict(n_sub=n_sub, dt=DT)
    n_ph, _, (y, t0, pp, uu) = _f64_inputs("10", n, 60, device)
    before = kernels.rk4_batch.launches
    got = kernels.rk4_batch(y, t0, pp, uu, n_ph=n_ph, **wkw)
    moved = kernels.rk4_batch.launches - before
    plain, plain_ms = _timed(lambda: rk4_window_batch_ref(
        y, t0, pp, uu, n_ph=n_ph, **wkw), device)
    err, ok = _close_err(got, plain, NATIVE_TOL)
    phase("native", kernel="N1", case="preset10_main", n=n, n_sub=n_sub,
          max_abs_err=err, tol=NATIVE_TOL, launches=moved, plain_ms=plain_ms)
    if not ok:
        raise AssertionError(f"N1 vs plain: {err:.3e} > {NATIVE_TOL}")
    if cuda and moved != 1:
        raise AssertionError(f"N1 launch counter moved by {moved}, not 1")

    worst_f64 = 0.0
    for i, (name, preset, _, kw) in enumerate(cases):
        n_ph_c, f32, f64 = _f64_inputs(preset, f64_n, 200 + i, device, **kw)
        ckw = dict(n_ph=n_ph_c, **wkw)
        n1 = kernels.rk4_batch(*f64, **ckw).cpu().numpy()
        hi, lo = rk4_window_batch_df(f32[0], torch.zeros_like(f32[0]),
                                     *f32[1:], **ckw)
        k3 = (hi.double() + lo.double()).cpu().numpy()
        k1 = rk4_window_batch(*f32, **ckw).double().cpu().numpy()
        want = rk4_window_truth(preset, kw, *f64, n_sub)
        errs = [float(np.abs(o - want).max()) for o in (n1, k3, k1)]
        phase("native", kernel="N1", case=f"f64_{name}", n=f64_n,
              n_sub=n_sub, max_abs_err=errs[0], tol=DF_F64_TOL,
              k3_max_abs_err=errs[1], k1_max_abs_err=errs[2])
        if not (np.isfinite(errs[0]) and errs[0] <= DF_F64_TOL):
            raise AssertionError(f"N1 vs float64 RK4 {name}: {errs[0]:.3e} "
                                 f"> {DF_F64_TOL}")
        worst_f64 = max(worst_f64, errs[0])

    # the public batch: shared params, per-env exog, a ragged N
    p, u0 = make_params("10"), nominal_exog()
    us = [u0, dataclasses.replace(u0, v_g=0.75, s_irr=600.0)]
    y_ss = oracle.steady_state(p, u0)
    ys = y_ss + np.random.default_rng(7).normal(0.0, 0.02, (5, y_ss.size))
    t0s = np.arange(5) / 60.0
    batch = native.rk4_window_batch(ys, t0s, DT, 36, p, [us[e % 2]
                                                         for e in range(5)],
                                    device=device)
    same = all(torch.equal(batch[e], native.rk4_window(
        ys[e], float(t0s[e]), DT, 36, p, us[e % 2], device=device))
        for e in range(5))
    phase("native", kernel="N1", case="batch_vs_one_env", n=5,
          bitwise_equal=same)
    if not same:
        raise AssertionError("N1: the batch differs from its one-env calls")

    timed = {"plain_ms": plain_ms, "f64_max_abs_err": worst_f64}
    if cuda:
        for preset, seed in (("10", 60), ("50", 61)):
            n_ph_c, f32, f64 = _f64_inputs(preset, timed_n, seed, device)
            ckw = dict(n_ph=n_ph_c, **wkw)
            lo = torch.zeros_like(f32[0])
            timed[f"preset{preset}"] = {
                "n1_ms": _time_ms(lambda: kernels.rk4_batch(*f64, **ckw), 5,
                                  device),
                "k1_ms": _time_ms(lambda: rk4_window_batch(*f32, **ckw), 20,
                                  device),
                "k3_ms": _time_ms(lambda: rk4_window_batch_df(
                    f32[0], lo, *f32[1:], **ckw), 10, device)}
        timed["ms"] = timed["preset10"]["n1_ms"]
        phase("native", kernel="N1", case="ms_per_launch", n=timed_n,
              n_sub=n_sub, **{k: timed[k] for k in ("preset10", "preset50")})
    return err, timed


def _warp_efficiency(tries: np.ndarray) -> float:
    """Σ tries / (32 · Σ over warps of the warp's most tries): the share of
    a DP5(4) kernel's issued lanes that did work, one thread per env."""
    pad = -len(tries) % 32
    w = np.concatenate([tries, np.zeros(pad, tries.dtype)]).reshape(-1, 32)
    return float(tries.sum() / (32.0 * w.max(1).sum()))


def check_native_dp54(device, presets=("10", "50"),
                      windows=NATIVE_SAG_WINDOWS, n=N_ENVS):
    """N2 on the sag of tests/test_native.py:64-76 at each preset, every
    window from the kernel's state against LSODA (<= 1e-8), its accepted
    steps beside the plain version's on the same inputs (the windows as one
    batch), ms per window; then one window at n envs (preset 10,
    `window_inputs`): ms, steps, the warps' efficiency, against the plain
    version. Returns (max error vs LSODA, {timings and the run's tries})."""
    import dataclasses

    from pvderx_torch import make_params, nominal_exog, oracle
    from pvderx_torch.native import kernels

    cuda = torch.device(device).type == "cuda"
    worst = 0.0
    for preset in presets:
        p = make_params(preset)
        u = nominal_exog()
        u_sag = dataclasses.replace(u, v_g=0.6)
        y = oracle.steady_state(p, u)
        ins, steps, ms, errs = [], [], [], []
        for k in range(windows):
            uu = u_sag if 4 <= k < 8 else u
            t = k * DT
            y_l = oracle.integrate_window(y, t, DT, p, uu)
            args = (torch.tensor(y[None], device=device),
                    torch.tensor([t], dtype=torch.float64, device=device),
                    *_native_packs(p, uu, 1, device))
            ins.append(args)
            (y1, st, _), t_ms = _timed(lambda: kernels.dp54_batch(
                *args, n_ph=p.n_ph, dt=DT), device)
            y = y1[0].cpu().numpy()
            steps.append(int(st[0]))
            ms.append(t_ms)
            errs.append(float(np.abs(y - y_l).max()))
        cat = [torch.cat([a[i] for a in ins], -1 if i > 1 else 0)
               for i in range(4)]
        _, plain_steps, _ = kernels._dp54_window_ref(*cat, n_ph=p.n_ph, dt=DT)
        plain_steps = plain_steps.cpu().tolist()
        err = max(errs)
        phase("native", kernel="N2", case=f"sag_preset{preset}",
              windows=windows, max_abs_err=err, tol=NATIVE_DP54_TOL,
              steps=steps, plain_steps=plain_steps,
              steps_equal=steps == plain_steps, ms_per_window=ms)
        if not (np.isfinite(err) and err <= NATIVE_DP54_TOL
                and min(steps) > 0):
            raise AssertionError(f"N2 sag preset {preset}: {err:.3e} > "
                                 f"{NATIVE_DP54_TOL} (steps {steps})")
        worst = max(worst, err)

    n_ph, _, (y, t0, pp, uu) = _f64_inputs("10", n, 80, device)
    (y1, st, tr), ms = _timed(lambda: kernels.dp54_batch(
        y, t0, pp, uu, n_ph=n_ph, dt=DT), device)
    (y1p, stp, _), plain_ms = _timed(lambda: kernels._dp54_window_ref(
        y, t0, pp, uu, n_ph=n_ph, dt=DT), device)
    st, tr, stp = (a.cpu().numpy() for a in (st, tr, stp))
    diff = float((y1 - y1p).abs().max())
    out = dict(n=n, ms=ms, plain_ms=plain_ms, tries=int(tr.sum()),
               steps_min=int(st.min()), steps_mean=float(st.mean()),
               steps_max=int(st.max()), max_abs_diff_plain=diff,
               steps_equal_share=float((st == stp).mean()),
               warp_efficiency=_warp_efficiency(tr))
    phase("native", kernel="N2", case="one_window_preset10", **out)
    if st.min() < 0 or not diff <= NATIVE_DP54_TOL:
        raise AssertionError(f"N2 at {n} envs: steps {st.min()}, "
                             f"{diff:.3e} from the plain version")
    return worst, out


def check_native_newton(device, n=N_ENVS, reset_iters=NATIVE_RESET_ITERS):
    """N3: `steady_state` at presets 10 and 50 against the oracle's fsolve
    (<= 1e-9, residual < 1e-9); then n envs of preset 10 with
    `window_inputs`' per-env params from the nominal guess: ms, iterations,
    against the plain version (<= 1e-9) and beside the reset's Newton
    (`env.core.steady_state`, the complex-step Newton of `ode/newton.py`)
    at the same N. Returns (max error vs fsolve, {timings and the run's
    iterations})."""
    from pvderx_torch import make_params, native, nominal_exog, oracle
    from pvderx_torch.env import core
    from pvderx_torch.native import kernels
    from pvderx_torch.ops.window import P_FIELDS, U_FIELDS, unpack_struct
    from pvderx_torch.params import DERParams, Exog
    from pvderx_torch.physics import rhs_core

    worst = 0.0
    for preset in ("10", "50"):
        p, u = make_params(preset), nominal_exog()
        got = native.steady_state(p, u, device=device).cpu().numpy()
        err = float(np.abs(got - oracle.steady_state(p, u)).max())
        res = float(np.abs(oracle.rhs_np(got, 0.0, p, u)).max())
        phase("native", kernel="N3", case=f"steady_state_preset{preset}",
              max_abs_err=err, tol=NATIVE_SS_TOL, residual=res)
        if not (err <= NATIVE_SS_TOL and res < NATIVE_SS_TOL):
            raise AssertionError(f"N3 preset {preset}: {err:.3e} from "
                                 f"fsolve, residual {res:.3e}")
        worst = max(worst, err)

    p = make_params("10")
    guess = rhs_core.steady_state_guess(p, nominal_exog(), np)
    n_ph, _, (_, _, pp, uu) = _f64_inputs("10", n, 90, device)
    y0 = torch.tensor(guess, device=device).expand(n, -1).contiguous()
    (y, it), ms = _timed(lambda: kernels.newton_batch(y0, pp, uu, n_ph=n_ph),
                         device)
    (yp, itp), plain_ms = _timed(lambda: kernels._newton_steady_ref(
        y0, pp, uu, n_ph=n_ph), device)
    der = unpack_struct(DERParams, pp, P_FIELDS, n_ph=n_ph)
    exog = unpack_struct(Exog, uu, U_FIELDS)
    (yr, rr), reset_ms = _timed(lambda: core.steady_state(
        der, exog, iters=reset_iters), device)
    t = torch.zeros(n, dtype=torch.float64, device=device)
    resid = float(kernels._rhs_ref(y, t, pp, uu, n_ph=n_ph).abs().max())
    it = it.cpu().numpy()
    out = dict(n=n, ms=ms, plain_ms=plain_ms, reset_newton_ms=reset_ms,
               reset_newton_iters=reset_iters,
               iterations=int(it[it >= 0].sum()), iters_min=int(it.min()),
               iters_max=int(it.max()), residual=resid,
               max_abs_diff_plain=float((y - yp).abs().max()),
               iters_equal_share=float((it == itp.cpu().numpy()).mean()),
               max_abs_diff_reset=float((y - yr).abs().max()),
               reset_residual=float(rr.max()))
    phase("native", kernel="N3", case="batch_preset10", **out)
    if it.min() < 0 or not (out["max_abs_diff_plain"] <= NATIVE_SS_TOL
                            and resid < NATIVE_SS_TOL):
        raise AssertionError(f"N3 at {n} envs: iterations {it.min()}, "
                             f"{out['max_abs_diff_plain']:.3e} from the "
                             f"plain version, residual {resid:.3e}")
    return worst, out


def drive_native(device, trajectory_windows=30, batch_n=N_ENVS):
    """The float64 engine's public path once, its launch counters set to 0
    just before: `steady_state`, `rhs`, `rk4_window`, `rk4_window_batch`
    at batch_n envs, `run_trajectory` over tests/test_native.py's 30
    windows against the LSODA trajectory (< 5e-8). Returns (launches per
    kernel, their wanted counts, the trajectory's error)."""
    import dataclasses

    from pvderx_torch import make_params, native, nominal_exog, oracle
    from pvderx_torch.native import kernels

    p, u = make_params("10"), nominal_exog()
    u_sag = dataclasses.replace(u, v_g=0.7)
    exogs = _native_trajectory_exogs(trajectory_windows)
    ys = oracle.steady_state(p, u) + 1e-3 * np.random.default_rng(
        5).standard_normal((batch_n, p.n_states))
    for f in kernels.LAUNCHERS:
        f.launches = 0
    y0 = native.steady_state(p, u, device=device)
    d = native.rhs(y0, 0.123, p, u_sag, device=device)
    y1 = native.rk4_window(y0, 0.0, DT, 72, p, u_sag, device=device)
    yb = native.rk4_window_batch(ys, 0.0, DT, N_SUB, p, u_sag, device=device)
    tr = native.run_trajectory(p, exogs, device=device)
    _sync(device)
    launches = {f.__name__: f.launches for f in kernels.LAUNCHERS}
    want = dict(rhs_batch=1, rk4_batch=2, dp54_batch=trajectory_windows,
                newton_batch=2)
    truth = (_truth("native_trajectory", trajectory_windows)[0]
             if trajectory_windows == 30 else
             oracle.run_trajectory(p, exogs))
    err = float(np.abs(tr.cpu().numpy() - truth).max())
    finite = all(bool(torch.isfinite(a).all()) for a in (d, y1, yb, tr))
    phase("native", kernel="path", launches=launches, want=want,
          trajectory_windows=trajectory_windows, trajectory_max_abs_err=err,
          tol=NATIVE_TRAJ_TOL, finite=finite,
          devices=sorted({a.device.type for a in (y0, d, y1, yb, tr)}))
    if not (finite and err < NATIVE_TRAJ_TOL):
        raise AssertionError(f"native trajectory vs LSODA: {err:.3e} >= "
                             f"{NATIVE_TRAJ_TOL} (finite {finite})")
    if torch.device(device).type == "cuda" and launches != want:
        raise AssertionError(f"native launches {launches}, want {want}")
    return launches, err


def run_native(device, card, sizes=None):
    """Phase 36: the float64 engine, checks first (the kernels against
    their plain versions and the oracle), then its public path with the
    counters set to 0. ``sizes``: smaller keyword arguments for a CPU
    rehearsal ({"rhs": {...}, "rk4": ..., "dp54": ..., "newton": ...,
    "drive": ...}). Returns {kernel: its numbers for the kernels line}."""
    sizes = sizes or {}
    t = time.perf_counter()
    rhs_err, rhs_t = check_native_rhs(device, **sizes.get("rhs", {}))
    rk4_err, rk4_t = check_native_rk4(device, **sizes.get("rk4", {}))
    dp54_err, dp54_t = check_native_dp54(device, **sizes.get("dp54", {}))
    ss_err, ss_t = check_native_newton(device, **sizes.get("newton", {}))
    launches, traj_err = drive_native(device, **sizes.get("drive", {}))
    phase("native", card=card, seconds=time.perf_counter() - t)
    return dict(
        rhs=dict(err=rhs_err, launches=launches["rhs_batch"], **rhs_t),
        rk4=dict(err=rk4_err, launches=launches["rk4_batch"], **rk4_t),
        dp54=dict(err=dp54_err, launches=launches["dp54_batch"],
                  trajectory_err=traj_err, **dp54_t),
        newton=dict(err=ss_err, launches=launches["newton_batch"], **ss_t))


# Phase 37: the autoreset kernel's cases, (preset, dtype, N) x the done
# patterns, and the batch at which it is timed (the benchmark cell's)
AUTORESET_PRESETS = ("10", "50")
AUTORESET_DTYPES = (torch.float32, torch.float64)
AUTORESET_SIZES = (37, N_ENVS)
AUTORESET_DONE = ("none", "one", "1pct", "all")
AUTORESET_TIMED_ENVS = 2097152


def _stepped_batch(preset, dtype, n, device, seed):
    """(cfg, input state, step outputs (state, obs, reward, done, info),
    generator): a reset of ``n`` envs and one step, K1's in float32, a
    trapezoid one in float64; at preset 50 a scenario that draws unbalanced
    sags. The stepped leaves that a step from a reset leaves uniform (step
    count, setpoints, timers, trip latch, cessation, obs, y) are then
    overwritten in place with seeded noise, so that a leaf copied from the
    wrong place shows, and their aliases (``info["vdc"]`` a view of y,
    ``info["tripped"]`` the trip latch) stay; the MPPT state (the input
    state's, with MPPT off, whose p_prev is its ppv0) is replaced by
    noise."""
    from pvderx_torch._struct import replace
    from pvderx_torch.env import core, make_env_config
    from pvderx_torch.scenario.mppt_voltvar import MPPTState

    scen = core.ScenarioConfig(p_unb=0.5) if preset == "50" else None
    kw = (dict(n_sub=N_SUB) if dtype == torch.float32 else
          dict(integrator="trapezoid", n_sub=4))
    cfg = make_env_config(preset, dtype=dtype, scen=scen, device=device, **kw)
    gen = torch.Generator(device=device).manual_seed(seed)
    st, _ = core.reset(cfg, n, gen)
    act = torch.randint(0, 5, (n,), generator=gen, device=device)
    st1, obs, rew, done, info = core.step(cfg, st, act)
    r = lambda *shape: torch.rand(shape, generator=gen, dtype=dtype,
                                  device=device)
    st1.y.add_(1e-3 * r(*st1.y.shape))
    st1.t_step.copy_(torch.randint(0, 600, (n,), generator=gen,
                                   device=device, dtype=torch.int32))
    for leaf in (st1.vdc_ref, st1.q_ref, st1.rt.timers, obs):
        leaf.copy_(r(*leaf.shape))
    for leaf in (st1.rt.tripped, st1.rt.ces):
        leaf.copy_((r(n) < 0.5).to(dtype))
    st1 = replace(st1, mppt=MPPTState(p_prev=r(n), direction=r(n)))
    return cfg, st, (st1, obs, rew, done, info), gen


def check_autoreset(device, presets=AUTORESET_PRESETS,
                    dtypes=AUTORESET_DTYPES, sizes=AUTORESET_SIZES,
                    patterns=AUTORESET_DONE, timed_n=AUTORESET_TIMED_ENVS):
    """Phase 37: `env.core.restart_done` (the autoreset kernel on the card)
    against the plain version on every case, bit for bit, inputs
    untouched; then ms per launch at ``timed_n`` envs (the last size's
    stepped batch repeated; None: not timed) beside the bytes bound.
    Returns the numbers of the kernels line."""
    import copy

    from pvderx_torch._struct import tree_map
    from pvderx_torch.diag.roofline import H100
    from pvderx_torch.env import core
    from pvderx_torch.ops.autoreset import autoreset_batch, autoreset_bytes

    cuda = torch.device(device).type == "cuda"
    cases = 0
    for i, (preset, dtype, n) in enumerate(
            (p, d, n) for p in presets for d in dtypes for n in sizes):
        cfg, st, stepped, gen = _stepped_batch(preset, dtype, n, device, i)
        st1, obs, rew, _, info = stepped
        line = dict(restarted={}, launches=0, calls=0)
        for kind in patterns:
            done = torch.zeros(n, dtype=torch.bool, device=device)
            if kind == "one":
                done[n // 2] = True
            elif kind == "1pct":
                done = torch.rand(n, generator=gen, device=device) < 0.01
            elif kind == "all":
                done[:] = True
            uv = core.event_draws(cfg, n, gen)
            los = [None] + ([torch.rand(st1.y.shape, generator=gen,
                                        dtype=dtype, device=device) * 1e-9]
                            if dtype == torch.float32 else [])
            for y_lo in los:
                inputs = (st, st1, obs, rew, done, info, uv, y_lo)
                before = copy.deepcopy(inputs)
                launches = autoreset_batch.launches
                got = core.restart_done(cfg, done, (st1, obs), uv, y_lo)
                moved = autoreset_batch.launches - launches
                want = core.autoreset(done, core._soft_reset(cfg, st1, uv),
                                      (st1, obs))
                if y_lo is not None:
                    want += (core._where_done(
                        done, torch.zeros_like(y_lo), y_lo),)
                diff = bitwise_differences(got[:len(want)], want)
                changed = bitwise_differences(before, inputs)
                line["restarted"][kind] = int(done.sum())
                line["launches"] += moved
                line["calls"] += 1
                what = (f"autoreset {preset} {dtype} N={n} {kind} lo="
                        f"{y_lo is not None}")
                if changed:
                    raise AssertionError(f"{what} wrote its inputs: "
                                         f"{changed}")
                require_bitwise(f"{what} vs plain {diff}", float(len(diff)))
                if cuda and moved != 1:
                    raise AssertionError(f"{what}: {moved} launches, not 1")
                cases += 1
        phase("autoreset", preset=preset, dtype=str(dtype)[6:], n=n,
              bitwise=True, inputs_unchanged=True, **line)

    kernel_ms = plain_ms = bytes_ms = None
    if timed_n:
        cfg, st, stepped, gen = _stepped_batch("10", torch.float32,
                                               sizes[-1], device, 99)
        rep = -(-timed_n // sizes[-1])
        big = lambda x: (x.repeat(rep, *[1] * (x.dim() - 1))[:timed_n]
                         if x.dim() else x)
        st1, obs = tree_map(big, stepped[0]), big(stepped[1])
        done = torch.rand(timed_n, generator=gen, device=device) < 1 / 600
        uv = core.event_draws(cfg, timed_n, gen)
        bytes_ms = 1e3 * autoreset_bytes(timed_n, 1) / H100["hbm_bytes_per_s"]
        if cuda:
            kernel_ms = _time_ms(lambda: core.restart_done(
                cfg, done, (st1, obs), uv), 20, device)
            plain_ms = _time_ms(lambda: core.autoreset(
                done, core._soft_reset(cfg, st1, uv), (st1, obs)), 5, device)
        phase("autoreset", n=timed_n, done_share=float(done.float().mean()),
              cases=cases, kernel_ms_per_launch=kernel_ms,
              bytes_bound_ms=bytes_ms, plain_ms=plain_ms,
              bytes=autoreset_bytes(timed_n, 1))
    return dict(cases=cases, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bytes_ms, n=timed_n)


# Phase 38: the post-window kernel's cases, (preset, dtype, N) x the anomaly
# reward x the ride-through, and the batch at which it is timed (the
# benchmark cell's)
POST_WINDOW_PRESETS = ("10", "50")
POST_WINDOW_DTYPES = (torch.float32, torch.float64)
POST_WINDOW_SIZES = (37, N_ENVS)
# Where a case is not held bit for bit (three phases), each float leaf
# within this share of its largest magnitude: torch's reduction, not the
# kernel, sets the order of the three-phase means' sums
POST_WINDOW_TOL = 1e-6
# the leaves that equal the plain version's exactly in every case
POST_WINDOW_EXACT = ("t_step", "timers", "tripped", "ces", "done",
                     "info.tripped", "info.trip_now", "info.terminated",
                     "info.truncated")
POST_WINDOW_TIMED_ENVS = 2097152


def _post_window_case(preset, dtype, n, device, seed):
    """(state, (exog, mppt, t, y1, flag), p_pack, u_pack): a reset of ``n``
    envs and one step's inputs to the post-window glue, forced across
    every threshold the step tests: a quarter of the envs one step from
    the horizon, the zone timers at 0.8-1.05 of their limits, a fifth
    tripped already, the grid voltage over 0.3-1.35 pu (every voltage
    zone), the PLL integrator over +-0.05 (the frequency zones); a share of
    the envs with a frequency deviation, a negative sequence, an
    insolation step or a load, so that the anomaly reward sees both
    answers; y1 the reset's y with noise."""
    from pvderx_torch._struct import replace
    from pvderx_torch.env import core, make_env_config
    from pvderx_torch.ops.window import P_FIELDS, U_FIELDS, pack_struct

    cfg = make_env_config(preset, dtype=dtype, device=device,
                          anomaly_detect=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *shape: torch.rand(shape, generator=gen, dtype=dtype,
                                  device=device)
    some = lambda share: r(n) < share
    zero = torch.zeros(n, dtype=dtype, device=device)
    st, _ = core.reset(cfg, n, gen)
    t_step = torch.randint(0, cfg.horizon - 1, (n,), generator=gen,
                           device=device, dtype=torch.int32)
    t_step = torch.where(some(0.25), cfg.horizon - 1, t_step).to(torch.int32)
    rt = replace(st.rt, timers=cfg.rt.t_lim * (0.8 + 0.25 * r(n, 6)),
                 tripped=some(0.2).to(dtype))
    st = replace(st, t_step=t_step, rt=rt)
    act = torch.randint(0, core.N_ACTIONS_ANOM, (n,), generator=gen,
                        device=device)
    t, exog, mppt, flag, _ = core._pre_window(cfg, st, act)
    exog = replace(
        exog, v_g=0.3 + 1.05 * r(n),
        dw_g=torch.where(some(0.25), 0.04 * r(n) - 0.02, zero),
        v_g2=torch.where(some(0.25), 0.2 * r(n), zero),
        phi_g2=2.0 * np.pi * r(n),
        s_irr=torch.where(some(0.5), st.s0 * (0.2 + 0.8 * r(n)), exog.s_irr),
        g_load=torch.where(some(0.2), 0.5 * r(n), zero),
        b_load=torch.where(some(0.2), 0.2 * r(n) - 0.1, zero))
    y1 = st.y + 1e-3 * r(*st.y.shape)
    y1[:, 6 * cfg.der.n_ph + 3] = 0.1 * r(n) - 0.05
    return (st, (exog, mppt, t, y1, flag), pack_struct(st.der, P_FIELDS),
            pack_struct(exog, U_FIELDS))


def _post_window_leaves(out) -> dict:
    """The leaves a post-window step computes, by name."""
    st, obs, reward, done, info = out
    return {"t_step": st.t_step, "timers": st.rt.timers,
            "tripped": st.rt.tripped, "ces": st.rt.ces, "obs": obs,
            "reward": reward, "done": done,
            **{f"info.{k}": v for k, v in info.items()}}


def _post_window_gaps(got, want) -> dict:
    """{leaf: its largest gap over the plain leaf's largest magnitude} of
    every computed leaf that is not bit for bit the plain version's (inf
    where dtype or shape differ, or a leaf is not floating)."""
    gaps, want = {}, _post_window_leaves(want)
    for k, a in _post_window_leaves(got).items():
        b = want[k]
        if not bitwise_differences(a, b):
            continue
        if (a.dtype != b.dtype or a.shape != b.shape
                or not a.is_floating_point()):
            gaps[k] = float("inf")
            continue
        scale = float(b.double().abs().max())
        gaps[k] = float((a.double() - b.double()).abs().max()) / max(
            scale, 1e-300)
    return gaps


def check_post_window(device, presets=POST_WINDOW_PRESETS,
                      dtypes=POST_WINDOW_DTYPES, sizes=POST_WINDOW_SIZES,
                      timed_n=POST_WINDOW_TIMED_ENVS):
    """Phase 38: `env.core._post_window` (the post-window kernel on the
    card) against the plain version `_post_window_plain` on every case:
    bit for bit at preset 10 (one phase), elsewhere the exact leaves
    (`POST_WINDOW_EXACT`) equal and the floats within `POST_WINDOW_TOL`;
    the rest of the state the same tensors, ``info["vdc"]`` a view of y1
    and ``info["tripped"]`` the state's latch, inputs untouched, one launch
    a call. Then ms per launch at ``timed_n`` envs (the last size's
    case repeated; None: not timed) beside the bytes bound, the plain
    version's ms and the kernel's registers and spills. At the larger
    sizes the ride-through, where enabled, enters every zone and trips
    envs, and envs end terminated and truncated. Returns the numbers of
    the kernels line."""
    import copy

    from pvderx_torch._struct import tree_map
    from pvderx_torch.diag.roofline import H100
    from pvderx_torch.env import core, make_env_config
    from pvderx_torch.ops.post_window import (
        post_window_batch, post_window_bytes)
    from pvderx_torch.ops.window import P_FIELDS, U_FIELDS, pack_struct

    cuda = torch.device(device).type == "cuda"
    cases = 0
    for i, (preset, dtype, n) in enumerate(
            (p, d, n) for p in presets for d in dtypes for n in sizes):
        st, args, pk, uk = _post_window_case(preset, dtype, n, device, i)
        y1 = args[3]
        held = "bitwise" if preset == "10" else "tol"
        line = dict(held=held, launches=0, calls=0, bitwise_calls=0,
                    max_gap=0.0, terminated=[], truncated=[], zones=[])
        for anomaly in (False, True):
            for rt_on in (True, False):
                cfg = make_env_config(preset, dtype=dtype, device=device,
                                      rt_enabled=rt_on, anomaly_detect=anomaly)
                what = (f"post_window {preset} {dtype} N={n} anomaly="
                        f"{anomaly} rt={rt_on}")
                inputs = (st, args, pk, uk)
                before = copy.deepcopy(inputs)
                launches = post_window_batch.launches
                got = core._post_window(cfg, st, *args, pk, uk)
                moved = post_window_batch.launches - launches
                want = core._post_window_plain(cfg, st, *args)
                changed = bitwise_differences(before, inputs)
                if changed:
                    raise AssertionError(f"{what} wrote its inputs: {changed}")
                kept = [p for p in bitwise_differences(got[0], want[0])
                        if p not in ("/t_step", "/rt/timers", "/rt/tripped",
                                     "/rt/ces")]
                alias = (got[0].y is y1 and got[4]["vdc"].untyped_storage()
                         .data_ptr() == y1.untyped_storage().data_ptr()
                         and got[4]["tripped"] is got[0].rt.tripped
                         and got[0].vdc_ref is want[0].vdc_ref)
                if kept or not alias:
                    raise AssertionError(f"{what}: state leaves {kept} differ "
                                         f"or aliases broken ({alias})")
                gaps = _post_window_gaps(got, want)
                exact = {k: v for k, v in gaps.items()
                         if k in POST_WINDOW_EXACT}
                if exact:
                    raise AssertionError(f"{what}: exact leaves differ {exact}")
                if held == "bitwise":
                    require_bitwise(f"{what} vs plain {sorted(gaps)}",
                                    float(len(gaps)))
                worst = max(gaps.values(), default=0.0)
                if not worst <= POST_WINDOW_TOL:
                    raise AssertionError(f"{what}: {gaps} > {POST_WINDOW_TOL}")
                if cuda and moved != 1:
                    raise AssertionError(f"{what}: {moved} launches, not 1")
                info = got[4]
                zones = (got[0].rt.timers > 0).any(0).tolist()
                if n >= 1000 and not (rt_on == all(zones)
                                      and rt_on == bool(info["trip_now"]
                                                        .any())
                                      and bool(info["terminated"].any())
                                      and bool(info["truncated"].any())):
                    raise AssertionError(f"{what}: zones {zones}, a threshold "
                                         f"not crossed")
                line["launches"] += moved
                line["calls"] += 1
                line["bitwise_calls"] += not gaps
                line["max_gap"] = max(line["max_gap"], worst)
                line["terminated"].append(int(info["terminated"].sum()))
                line["truncated"].append(int(info["truncated"].sum()))
                line["zones"].append(sum(zones))
                cases += 1
        phase("post_window", preset=preset, dtype=str(dtype)[6:], n=n,
              inputs_unchanged=True, tol=POST_WINDOW_TOL, **line)

    kernel_ms = plain_ms = bytes_ms = regs = None
    if timed_n:
        st, args, _, _ = _post_window_case("10", torch.float32, sizes[-1],
                                           device, 99)
        rep = -(-timed_n // sizes[-1])
        big = lambda x: (x.repeat(rep, *[1] * (x.dim() - 1))[:timed_n]
                         if x.dim() else x)
        st, args = tree_map(big, st), tuple(tree_map(big, a) for a in args)
        pk, uk = pack_struct(st.der, P_FIELDS), pack_struct(args[0], U_FIELDS)
        cfg = make_env_config("10", dtype=torch.float32, device=device)
        bytes_ms = (1e3 * post_window_bytes(timed_n, 1)
                    / H100["hbm_bytes_per_s"])
        if cuda:
            from pvderx_torch.ops import _build

            kernel_ms = _time_ms(lambda: core._post_window(
                cfg, st, *args, pk, uk), 20, device, ahead=True)
            plain_ms = _time_ms(lambda: core._post_window_plain(
                cfg, st, *args), 5, device)
            regs = {k: v for k, v in ptxas_summary(_build.ptxas_report())
                    .items() if k.startswith("post_window_kernel")}
        phase("post_window", n=timed_n, cases=cases,
              kernel_ms_per_launch=kernel_ms, bytes_bound_ms=bytes_ms,
              plain_ms=plain_ms, bytes=post_window_bytes(timed_n, 1),
              ptxas=regs)
    return dict(cases=cases, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bytes_ms, n=timed_n, ptxas=regs)


# Phase 39: the pre-window kernel's cases, (preset, dtype, N) x the config's
# switches, and the batch at which it is timed (the benchmark cell's)
PRE_WINDOW_PRESETS = ("10", "50")
PRE_WINDOW_DTYPES = (torch.float32, torch.float64)
PRE_WINDOW_SIZES = (37, N_ENVS)
PRE_WINDOW_MODES = (
    ("discrete", {}), ("anomaly", dict(anomaly_detect=True)),
    ("continuous", dict(continuous=True)),
    ("voltvar", dict(voltvar_enable=True)), ("mppt", dict(mppt_enable=True)),
    ("voltvar_mppt", dict(voltvar_enable=True, mppt_enable=True)))
# The Volt-VAR setpoint at three phases, within this share of its largest
# magnitude: torch's reduction, not the kernel, sets the order of the
# three-phase mean of the PCC voltage it reads
PRE_WINDOW_TOL = 1e-6
PRE_WINDOW_TIMED_ENVS = 2097152


def _pre_window_case(preset, dtype, n, device, seed):
    """(state, discrete actions 0..5, continuous actions [N, 2], p_pack): a
    reset of ``n`` envs pushed across every branch the pre-window tests:
    the setpoints over and past their bounds (so that the actions drive
    them into both clamps), a fifth tripped and a fifth in cessation, the
    step count over the whole horizon with a quarter of the envs each at
    exactly the time of a solar, grid or load event row, the grid voltage
    over 0.85-1.15 pu in the first three grid rows (every Volt-VAR
    segment), a -0 load in a fifth of the baseline rows and a NaN in a
    fifth of the solar tables' padding rows (neither may show), the MPPT
    state around the reset's PV power (both P&O directions), y the
    reset's with noise; continuous actions over +-1.5."""
    from pvderx_torch._struct import replace
    from pvderx_torch.env import core, make_env_config
    from pvderx_torch.ops.window import P_FIELDS, pack_struct
    from pvderx_torch.scenario.mppt_voltvar import MPPTState

    cfg = make_env_config(preset, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *shape: torch.rand(shape, generator=gen, dtype=dtype,
                                  device=device)
    some = lambda share: r(n) < share
    st, _ = core.reset(cfg, n, gen)
    t_step = torch.randint(0, cfg.horizon, (n,), generator=gen,
                           device=device, dtype=torch.int32)
    t = t_step.to(dtype) * cfg.dt_ctrl
    solar, grid, load = (x.clone() for x in (st.sched.solar, st.sched.grid,
                                             st.sched.load))
    which = torch.randint(0, 4, (n,), generator=gen, device=device)
    solar[:, 1, 0] = torch.where(which == 1, t, solar[:, 1, 0])
    solar[:, 2, 0] = torch.where(which == 1, t + 1.0, solar[:, 2, 0])
    grid[:, 1, 0] = torch.where(which == 2, t, grid[:, 1, 0])
    grid[:, 2, 0] = torch.where(which == 2, t + 0.5, grid[:, 2, 0])
    load[:, 1, 0] = torch.where(which == 3, t, load[:, 1, 0])
    grid[:, :3, 1] = 0.85 + 0.3 * r(n, 3)
    load[:, 0, 1] = torch.where(some(0.2), -0.0, load[:, 0, 1])
    solar[:, 3, 1] = torch.where(some(0.2), float("nan"), solar[:, 3, 1])
    rt = replace(st.rt, tripped=some(0.2).to(dtype),
                 ces=some(0.2).to(dtype))
    one = torch.ones(n, dtype=dtype, device=device)
    st = replace(
        st, y=st.y + 1e-3 * r(*st.y.shape), t_step=t_step,
        q_ref=1.04 * r(n) - 0.52, vdc_ref=0.68 + 0.54 * r(n), rt=rt,
        sched=replace(st.sched, solar=solar, grid=grid, load=load),
        mppt=MPPTState(p_prev=st.ppv0 * (0.995 + 0.01 * r(n)),
                       direction=torch.where(some(0.5), one, -one)))
    act = torch.randint(0, core.N_ACTIONS_ANOM, (n,), generator=gen,
                        device=device)
    return st, act, 3.0 * r(n, 2) - 1.5, pack_struct(st.der, P_FIELDS)


def _pre_window_leaves(t, exog, mppt, flag, anomaly) -> dict:
    """The leaves a pre-window computes, by name (the flag with the anomaly
    reward alone: without it the kernel's route makes none)."""
    import dataclasses

    out = {"t": t, **{f"exog.{f.name}": getattr(exog, f.name)
                      for f in dataclasses.fields(exog)},
           "mppt.p_prev": mppt.p_prev, "mppt.direction": mppt.direction}
    if anomaly:
        out["flag"] = flag
    return out


def check_pre_window(device, presets=PRE_WINDOW_PRESETS,
                     dtypes=PRE_WINDOW_DTYPES, sizes=PRE_WINDOW_SIZES,
                     timed_n=PRE_WINDOW_TIMED_ENVS):
    """Phase 39: `env.core._pre_window` (the pre-window kernel on the card)
    against the plain version `_pre_window_plain` on every case, each leaf
    bit for bit (t, the 15 exog rows, the MPPT state, the anomaly flag),
    but the Volt-VAR setpoint at three phases, within `PRE_WINDOW_TOL`;
    on the card the exog views of the kernel's [15, N] pack, inputs
    untouched, one launch a call. With Volt-VAR the call runs under a
    profiler, so that its ``env.pre_window`` span has a counter (the
    kernel's counting variant on the card), which must equal the plain
    version's setpoints off 0. Then ms per launch at ``timed_n`` envs
    (the last size's case repeated; None: not timed) beside the bytes
    bound, the plain version's ms (with the exog pack it fed the window)
    and the kernel's registers and spills. Returns the numbers of the
    kernels line."""
    import contextlib
    import copy

    from torch.profiler import ProfilerActivity, profile

    from pvderx_torch._struct import tree_map
    from pvderx_torch.diag import profiler
    from pvderx_torch.diag.roofline import H100
    from pvderx_torch.env import core, make_env_config
    from pvderx_torch.ops.pre_window import pre_window_batch, pre_window_bytes
    from pvderx_torch.ops.window import U_FIELDS, pack_struct

    cuda = torch.device(device).type == "cuda"
    cases = 0
    for i, (preset, dtype, n) in enumerate(
            (p, d, n) for p in presets for d in dtypes for n in sizes):
        st, act, act_c, pk = _pre_window_case(preset, dtype, n, device, i)
        line = dict(launches=0, calls=0, bitwise_calls=0, max_gap=0.0,
                    clamped=0, at_event=0, voltvar_active=0)
        for name, kw in PRE_WINDOW_MODES:
            cfg = make_env_config(preset, dtype=dtype, device=device, **kw)
            a = (act_c if cfg.continuous else act if cfg.anomaly_detect
                 else act % core.N_ACTIONS)
            what = f"pre_window {preset} {dtype} N={n} {name}"
            inputs = (st, a, pk)
            before = copy.deepcopy(inputs)
            launches = pre_window_batch.launches
            profiler.clear()
            with (profile(activities=[ProfilerActivity.CPU])
                  if cfg.voltvar_enable else contextlib.nullcontext()):
                t, exog, mppt, flag, u_pack = core._pre_window(cfg, st, a,
                                                               pk)
            moved = pre_window_batch.launches - launches
            counted = [r["count"] for r in profiler.records()]
            profiler.clear()
            want = _pre_window_leaves(*core._pre_window_plain(cfg, st, a),
                                      cfg.anomaly_detect)
            q = want["exog.q_ref"]
            if cfg.voltvar_enable:
                active = int((q != 0).sum())
                if counted != [active]:
                    raise AssertionError(f"{what}: counted {counted} "
                                         f"setpoints off 0, not {active}")
                line["voltvar_active"] += active
            got = _pre_window_leaves(t, exog, mppt, flag, cfg.anomaly_detect)
            changed = bitwise_differences(before, inputs)
            if changed:
                raise AssertionError(f"{what} wrote its inputs: {changed}")
            diff = bitwise_differences(got, want)
            loose = ("/exog.q_ref",) if (cfg.voltvar_enable
                                         and cfg.der.n_ph == 3) else ()
            strict = [p for p in diff if p not in loose]
            require_bitwise(f"{what} vs plain {strict}", float(len(strict)))
            gap = 0.0
            if diff:
                g, w = got["exog.q_ref"].double(), want["exog.q_ref"].double()
                gap = float((g - w).abs().max()) / max(
                    float(w.abs().max()), 1e-300)
                if not gap <= PRE_WINDOW_TOL:
                    raise AssertionError(f"{what}: q_ref {gap} > "
                                         f"{PRE_WINDOW_TOL}")
            if cuda and (moved != 1 or u_pack is None
                         or exog.q_ref.data_ptr() != u_pack[11].data_ptr()
                         or bitwise_differences(
                             u_pack, pack_struct(exog, U_FIELDS))):
                raise AssertionError(f"{what}: {moved} launches, not 1, or "
                                     f"the exog not the pack's rows")
            line["launches"] += moved
            line["calls"] += 1
            line["bitwise_calls"] += not diff
            line["max_gap"] = max(line["max_gap"], gap)
            line["clamped"] += int(((q == cfg.q_lo) | (q == cfg.q_hi)).sum())
            cases += 1
        t = st.t_step.to(dtype) * cfg.dt_ctrl
        hit = sum((tab[:, 1:, 0] == t[:, None]).any(1)
                  for tab in (st.sched.solar, st.sched.grid, st.sched.load))
        line["at_event"] = int((hit > 0).sum())
        if n >= 1000 and not (line["clamped"] and line["at_event"]):
            raise AssertionError(f"pre_window {preset} {dtype} N={n}: no "
                                 f"clamp or no event time hit {line}")
        phase("pre_window", preset=preset, dtype=str(dtype)[6:], n=n,
              inputs_unchanged=True, tol=PRE_WINDOW_TOL, **line)

    kernel_ms = plain_ms = bytes_ms = regs = None
    if timed_n:
        st, act, _, pk = _pre_window_case("10", torch.float32, sizes[-1],
                                          device, 99)
        rep = -(-timed_n // sizes[-1])
        big = lambda x: (x.repeat(rep, *[1] * (x.dim() - 1))[:timed_n]
                         if x.dim() else x)
        st, a = tree_map(big, st), big(act % 5)
        cfg = make_env_config("10", dtype=torch.float32, device=device)
        bytes_ms = 1e3 * pre_window_bytes(timed_n) / H100["hbm_bytes_per_s"]
        if cuda:
            from pvderx_torch.ops import _build

            kernel_ms = _time_ms(lambda: core._pre_window(cfg, st, a)[0], 20,
                                 device, ahead=True)
            plain_ms = _time_ms(lambda: pack_struct(
                core._pre_window_plain(cfg, st, a)[1], U_FIELDS), 5, device)
            regs = {k: v for k, v in ptxas_summary(_build.ptxas_report())
                    .items() if k.startswith("pre_window_kernel")}
        phase("pre_window", n=timed_n, cases=cases,
              kernel_ms_per_launch=kernel_ms, bytes_bound_ms=bytes_ms,
              plain_ms=plain_ms, bytes=pre_window_bytes(timed_n),
              ptxas=regs)
    return dict(cases=cases, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bytes_ms, n=timed_n, ptxas=regs)


def native_kernel_rows(nat, chip, n=N_ENVS):
    """The kernels line's rows of N1-N4 from `run_native`'s numbers: each
    with its float64 bound (`roofline.native_bound_ms`) at its timed shape
    (preset 10, ``n`` envs), the adaptive kernels' work as this run's envs
    took it. Prints the bounds as one line."""
    from pvderx_torch.diag import roofline

    nb = {"rhs": roofline.native_bound_ms("rhs", n, chip=chip),
          "rk4": roofline.native_bound_ms("rk4", n, n_sub=N_SUB, chip=chip),
          "dp54": roofline.native_bound_ms("dp54", n,
                                           tries=nat["dp54"]["tries"],
                                           chip=chip),
          "newton": roofline.native_bound_ms(
              "newton", n, iterations=nat["newton"]["iterations"],
              chip=chip)}
    phase("native_bound", **nb)
    return [{
        "name": name,
        "route": "cuda",
        "source": "pvderx_torch/ops/csrc/native.cu",
        "replaces": replaces,
        "launches": nat[key]["launches"],
        "max_abs_err": nat[key]["err"],
        "ms": nat[key].get("ms"),
        "plain_ms": nat[key].get("plain_ms"),
        "bound_ms": nb[key]["bound_ms"],
        "bound_by": nb[key]["bound_by"],
        "library_ms": None,
        "n_envs": n,
        **extra,
    } for name, key, replaces, extra in (
        ("native_rhs", "rhs", "pvderx/native/src/pvderx_native.cpp:72", {}),
        ("native_rk4_window", "rk4", "pvderx/native/src/pvderx_native.cpp:176",
         {k: nat["rk4"].get(k) for k in ("preset10", "preset50",
                                         "f64_max_abs_err")}),
        ("native_dp54_window", "dp54",
         "pvderx/native/src/pvderx_native.cpp:204",
         {"trajectory_max_abs_err": nat["dp54"]["trajectory_err"],
          "tries": nat["dp54"]["tries"],
          "warp_efficiency": nat["dp54"]["warp_efficiency"]}),
        ("native_newton_steady", "newton",
         "pvderx/native/src/pvderx_native.cpp:300",
         {"iterations": nat["newton"]["iterations"],
          "reset_newton_ms": nat["newton"]["reset_newton_ms"]}))]


def kernel_name(mangled: str) -> str:
    """`window_kernel<3>`, `native_dp54_kernel<1>`,
    `post_window_kernel<float,1>`, `pre_window_kernel<float,1,false>` and
    the like for a window, float64 engine or env glue kernel's mangled or
    demangled name; any other name as it is."""
    import re

    glue = r"(autoreset_kernel|post_window_kernel|pre_window_kernel)"
    k = re.search(glue + r"I([fd])((?:L[ib]\d+E)+)E", mangled)
    if k:
        args = [{"b0": "false", "b1": "true"}.get(a, a[1:])
                for a in re.findall(r"L([ib]\d+)E", k.group(3))]
        kind = {"f": "float", "d": "double"}[k.group(2)]
        return f"{k.group(1)}<{kind},{','.join(args)}>"
    k = re.search(glue + r"<(float|double), *([\w, ]+)>", mangled)
    if k:
        return f"{k.group(1)}<{k.group(2)},{k.group(3).replace(' ', '')}>"
    name = r"((?:fleet_)?window(?:_df)?_kernel|native_[a-z0-9]+_kernel)"
    k = re.search(name + r"I((?:Li\d+E)+)E", mangled)
    if k:
        args = re.findall(r"Li(\d+)E", k.group(2))
        return f"{k.group(1)}<{','.join(args)}>"
    k = re.search(name + r"<([\d, ]+)>", mangled)
    if k:
        return f"{k.group(1)}<{k.group(2).replace(' ', '')}>"
    return mangled


def ptxas_summary(report: str) -> dict:
    """Registers and spill bytes per kernel from `nvcc -Xptxas -v` output."""
    import re

    out, cur = {}, None
    for ln in report.splitlines():
        hit = re.search(r"(?:entry function|Function properties for) '?(\S+?)'?"
                        r"(?: for|$)", ln)
        if hit:
            cur = kernel_name(hit.group(1))
            out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if sp:
            out[cur].update(spill_stores=int(sp.group(1)),
                            spill_loads=int(sp.group(2)))
        rg = re.search(r"Used (\d+) registers", ln)
        if rg:
            out[cur]["registers"] = int(rg.group(1))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = "cuda"
    kind = torch.cuda.get_device_name(0)
    card = _smi("name,power.limit")
    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    phase("device", torch_device=kind, nvidia_smi=card,
          max_sm_clock_mhz=clock_mhz, torch=torch.__version__,
          cuda=torch.version.cuda)
    try:
        with concurrent.futures.ProcessPoolExecutor(
                len(TRUTH_KEYS),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            try:
                prefetch_truths(pool)
                return run_phases(device, kind, card, clock_mhz)
            finally:
                pool.shutdown(cancel_futures=True)
    except Exception as exc:       # the run's boundary: name the phase, stop
        failed(exc)
        return 1


def run_phases(device, kind, card, clock_mhz) -> int:
    """Phases 2-39, the kernels line, the card line and the last line."""
    from pvderx_torch.diag import roofline
    from pvderx_torch.ops import _build

    begin("build")
    t = time.perf_counter()
    _build.build()
    _build.load()
    phase("build", seconds=time.perf_counter() - t,
          ptxas=ptxas_summary(_build.ptxas_report()))

    begin("kernel")
    kernel_err = check_kernel(device)
    begin("gate")
    check_gate(device)
    begin("main")
    main_out = run_main(device, card)
    begin("fleet_kernel")
    fleet_err = check_fleet_kernel(device)
    begin("fleet_gate")
    check_fleet_gate(device)
    begin("fleet_main")
    fleet_out = run_fleet_main(device, card)
    begin("df_kernel")
    df_err, df_plain_ms = check_df_kernel(device)
    begin("df_f64")
    check_df_f64(device)
    begin("df_gate")
    check_df_gate(device)
    begin("df_main")
    df_out = run_df_main(device, card, plain_ms=df_plain_ms)
    begin("ppo_main")
    ppo_out = run_ppo_main(device, card)
    begin("fleet_ppo")
    fleet_ppo_out = run_fleet_ppo(device, card)
    begin("dqn_main")
    dqn_out = run_dqn_main(device, card)
    begin("sac_main")
    sac_out = run_sac_main(device, card)
    begin("learn_gates")
    run_learn_gates(device, card)
    begin("implicit")
    check_implicit_window(device)
    implicit_out = run_implicit_env(device, card)
    begin("fleet_implicit")
    fleet_implicit_out = run_fleet_implicit(device, card)
    begin("gym")
    gym_out = run_gym(device, card, main_rate=main_out["env_steps_per_s"])
    begin("sim")
    sim_out = run_sim(device, card)
    begin("config")
    config_out = run_config(device, card)
    begin("diag_profiler")
    prof_out = run_diag_profiler(device, card,
                                 main_rate=main_out["env_steps_per_s"])
    begin("diag_debug")
    debug_out = run_diag_debug(device, card)
    begin("diag_checkpoint")
    ckpt_out = run_diag_checkpoint(device, card)
    begin("grad")
    run_grad(device, card)
    begin("examples")
    examples_out, dist_out = run_examples_and_dist(device, card)
    dl = dist_launches(dist_out)
    begin("notebooks")
    notebooks_out = run_notebooks(device, card)
    begin("native")
    native_out = run_native(device, card)
    begin("autoreset")
    autoreset_out = check_autoreset(device)
    begin("post_window")
    post_window_out = check_post_window(device)
    begin("pre_window")
    pre_window_out = check_pre_window(device)
    begin("kernels_line")
    phase("total", seconds=time.perf_counter() - _T0)

    # the bounds at the main path's shapes (diag.roofline), the lane-issue
    # floor at the card's max SM clock
    chip = roofline.at_clock(clock_mhz)
    bound = lambda *a, **kw: roofline.window_bound_ms(*a, n_sub=N_SUB,
                                                      chip=chip, **kw)
    k1, k1_50 = bound("window", N_ENVS), bound("window", N_ENVS, n_ph=3)
    k2 = bound("fleet_window", FLEET_ENVS, m=FLEET_M)
    k3, k3_50 = bound("window_df", N_ENVS), bound("window_df", N_ENVS, n_ph=3)
    phase("bound", bytes=k1["bytes"], ops=k1["ops"], bytes_ms=k1["bytes_ms"],
          ops_ms_at_67tflops=k1["ops_ms"],
          ops_ms_at_lane_issue=k1["issue_bound_ms"])
    native_rows = native_kernel_rows(native_out, chip)
    ex = lambda key: {k: v["launches"][key] for k, v in examples_out.items()
                      if v["want"][key]}
    print(json.dumps({"kernels": [{
        "name": "rk4_window",
        "route": "cuda",
        "source": "pvderx_torch/ops/csrc/window.cu",
        "replaces": "pvderx/ops/window.py:56",
        "launches": main_out["launches"],
        "max_abs_err": kernel_err,
        "ms": main_out["kernel_ms"],
        "plain_ms": main_out["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "issue_bound_ms": k1["issue_bound_ms"],
        "preset50_ms": main_out["preset50_ms"],
        "preset50_issue_bound_ms": k1_50["issue_bound_ms"],
        "library_ms": None,
        "learner_launches": {"ppo_main": ppo_out["launches"],
                             "dqn_main": dqn_out["launches"],
                             "sac_main": sac_out["launches"]},
        "slice_launches": {
            "gym_vector": gym_out["vector"]["launches"],
            "gym_single": gym_out["single"]["launches"],
            "sim": sim_out["launches"],
            "sim_knob_rk4": sim_out["knob_launches"]["rk4"],
            "config": {k: v["launches"] for k, v in config_out.items()},
            "implicit_env": {k: v["k1_launches"]
                             for k, v in implicit_out.items()},
            "sim_knob_trapezoid": sim_out["knob_launches"]["trapezoid"],
            "diag_profiler_trace": prof_out["main"]["launches"],
            "diag_checked_step": debug_out["launches"],
            "diag_checkpoint": {k: v["launches"]
                                for k, v in ckpt_out.items()},
            "grad_guard": debug_out["grad_guard"]["k1"]["launches"],
            "examples": ex("k1"), **dl["k1"],
            "notebooks": {k: v["k1_launches"]
                          for k, v in notebooks_out.items()}},
    }, {
        "name": "rk4_fleet_window",
        "route": "cuda",
        "source": "pvderx_torch/ops/csrc/fleet_window.cu",
        "replaces": "pvderx/ops/window.py:103",
        "launches": fleet_out["launches"],
        "max_abs_err": fleet_err,
        "ms": fleet_out["kernel_ms"],
        "plain_ms": fleet_out["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "issue_bound_ms": k2["issue_bound_ms"],
        "library_ms": None,
        "learner_launches": {
            "fleet_ppo": fleet_ppo_out["launches"],
            "fleet_ppo_per_unit": fleet_ppo_out["per_unit"]["launches"]},
        "slice_launches": {
            "gym_fleet": gym_out["fleet"]["launches"],
            "gym_fleet_per_unit": gym_out["fleet_per_unit"]["launches"],
            "fleet_implicit": fleet_implicit_out["float32_k2_launches"],
            "diag_profiler_trace": prof_out["fleet"]["launches"],
            "grad_guard": debug_out["grad_guard"]["k2"]["launches"],
            "examples": ex("k2"), **dl["k2"]},
    }, {
        "name": "rk4_window_df",
        "route": "cuda",
        "source": "pvderx_torch/ops/csrc/window_df.cu",
        "replaces": "pvderx/ops/dualfloat.py:385",
        "launches": df_out["launches"],
        "max_abs_err": df_err,
        "ms": df_out["kernel_ms"],
        "plain_ms": df_out["plain_ms"],
        "plain_n_sub": df_out["plain_n_sub"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "issue_bound_ms": k3["issue_bound_ms"],
        "preset50_ms": df_out["preset50_ms"],
        "preset50_issue_bound_ms": k3_50["issue_bound_ms"],
        "library_ms": None,
        "slice_launches": {
            "diag_profiler_trace": prof_out["df32"]["launches"],
            "grad_guard": debug_out["grad_guard"]["k3"]["launches"],
            **dl["k3"]},
    }, *native_rows, {
        "name": "autoreset",
        "route": "cuda",
        "source": "pvderx_torch/ops/csrc/autoreset.cu",
        "replaces": None,
        "launches": main_out["autoreset_launches"],
        "cases_bitwise": autoreset_out["cases"],
        "n": autoreset_out["n"],
        "ms": autoreset_out["kernel_ms"],
        "plain_ms": autoreset_out["plain_ms"],
        "bound_ms": autoreset_out["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "post_window",
        "route": "cuda",
        "source": "pvderx_torch/ops/csrc/post_window.cu",
        "replaces": None,
        "launches": main_out["post_window_launches"],
        "cases": post_window_out["cases"],
        "n": post_window_out["n"],
        "ms": post_window_out["kernel_ms"],
        "plain_ms": post_window_out["plain_ms"],
        "bound_ms": post_window_out["bound_ms"],
        "bound_by": "bytes",
        "ptxas": post_window_out["ptxas"],
        "library_ms": None,
    }, {
        "name": "pre_window",
        "route": "cuda",
        "source": "pvderx_torch/ops/csrc/pre_window.cu",
        "replaces": None,
        "launches": main_out["pre_window_launches"],
        "cases": pre_window_out["cases"],
        "n": pre_window_out["n"],
        "ms": pre_window_out["kernel_ms"],
        "plain_ms": pre_window_out["plain_ms"],
        "bound_ms": pre_window_out["bound_ms"],
        "bound_by": "bytes",
        "ptxas": pre_window_out["ptxas"],
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(sys.argv[2], sys.argv[3], sys.argv[4:]))
    if sys.argv[1:2] == ["--example-rank"]:
        sys.exit(example_rank(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
