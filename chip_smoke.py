#!/usr/bin/env python3
"""Drive pvderx_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each (a failing phase raises, so the script exits non-zero):

1. device   — the card's name and power limit (nvidia-smi).
2. build    — nvcc builds the window kernels from pvderx_torch/ops/csrc/
              (one nvcc per source, in parallel) and reports each kernel's
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
              than 256 threads per env) and M=1 (also against K1): max abs
              error <= 5e-6 per window, one launch each.
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
              evaluation): max abs error on hi + lo <= 1e-9, one launch
              each, every output |lo| <= ulp(hi)/2.
11. df_f64  — K3 against the float64 RK4 window (the oracle's
              `rk4_window_np`) on the six cases at 4 envs each, n_sub=64,
              the same f32-rounded inputs, lo = 0 on input: <= 1e-10. The f32
              kernel (K1) on the same inputs must miss that bound: this
              phase, not the gate, tells the tiers apart.
12. df_gate — K3 on the gate scenario at presets 10 and 50, n_sub=64, lo
              carried from 0, against the float64 LSODA truth: <= 1e-6 (the
              tier's contract; RK4's truncation error dominates it, so K1
              reads about the same).
13. df_main — the df32 tier (`make_batch_fns_df`) at full width (preset 10,
              f32, n_sub=64, 32768 envs, zero-action policy): reset,
              warm-up, best of two 600-step chunks, the linearity check; K3
              launches == steps, obs/reward finite, episodes done, y_lo
              alive; K3, K1 and the plain df32 version ms per call at the
              same inputs and n_sub; K3 at preset 50 (three-phase), 32768
              envs, n_sub=64, on `df_inputs`.

Then the kernel table as one JSON line (each kernel with its bound and its
lane-issue bound: operations / (132 SMs * 128 FP32 lanes * max SM clock)),
the card line, and the device line.
Needs one CUDA card; imports torch, numpy, scipy and pvderx_torch only.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_TOL = 5e-6        # kernel vs plain, one window, f32
GATE_TOL = 4e-6          # f32 kernel vs float64 LSODA truth, gate scenario
DF_TOL = 1e-9            # df32 kernel vs plain df32, one window, hi + lo
# df32 kernel vs float64 RK4, one window: the df32 noise reads ~1e-13 and
# the f32 kernel's ~1e-7 at these inputs (CPU rehearsal of the plain versions)
DF_F64_TOL = 1e-10
DF_GATE_TOL = 1e-6       # df32 kernel vs float64 LSODA truth, gate scenario
DF_CHECK_SUB = 8         # substeps of the df32 comparisons, at the main h
N_ENVS = 32768
FLEET_ENVS, FLEET_M = 4096, 16   # BASELINE config 5
N_SUB = 64
WARM_STEPS = 60
CHUNK_STEPS = 600        # = the episode horizon: truncation and autoreset fire
DT = 1.0 / 60.0
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def phase(name: str, **kv):
    print(f"[{name}] " + json.dumps(kv), flush=True)


def _smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_ms(fn, reps: int, device) -> float:
    """Device time per call by CUDA events around ``reps`` calls."""
    fn()
    _sync(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


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


@functools.cache
def _gate_truth(preset: str, n_steps: int):
    """(float64 LSODA trajectory of the gate scenario, seconds it took)."""
    from pvderx_torch import make_params, oracle

    t = time.perf_counter()
    truth = oracle.run_trajectory(make_params(preset),
                                  oracle.gate_scenario_exogs(n_steps))
    return truth, time.perf_counter() - t


def check_gate(device, n_steps=120, n=128, n_sub=N_SUB):
    """Phase 4: the f32 kernel vs the float64 LSODA truth on the gate
    scenario (preset 10)."""
    from pvderx_torch import make_params, oracle
    from pvderx_torch.ops.window import P_FIELDS, U_FIELDS, rk4_window_batch

    p = make_params("10")
    exogs = oracle.gate_scenario_exogs(n_steps)
    truth, truth_s = _gate_truth("10", n_steps)
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

    rk4_window_batch.launches = 0
    rk4_fleet_window_batch.launches = 0
    rk4_window_batch_df.launches = 0


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


def _check_drive(name, out, launches, cuda):
    if launches != out["steps"] and cuda:
        raise AssertionError(
            f"{name}: kernel launches {launches} != steps {out['steps']}")
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
    peak_mib = (torch.cuda.max_memory_allocated(device) / 2 ** 20
                if cuda else None)

    # the kernel alone at the main path's shapes, beside its plain version
    t_win, exog, _, _ = core._pre_window(
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
          launches=launches, steps=out["steps"], dones=out["dones"],
          rew_sum=out["rew_sum"], finite=out["finite"])
    phase("linear", card=card, two_chunks_over_one=out["ratio"],
          band=[1.5, 2.7])
    _check_drive("main", out, launches, cuda)
    return dict(launches=launches, kernel_ms=kernel_ms, plain_ms=plain_ms,
                preset50_ms=k1_50_ms)


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
        for what, e in (("plain", err), *extra.items()):
            if not (np.isfinite(e) and e <= KERNEL_TOL):
                raise AssertionError(
                    f"fleet kernel vs {what} {name}: {e:.3e} > {KERNEL_TOL}")
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
    t = time.perf_counter()
    truth = oracle.run_fleet_trajectory(fp, fus)
    truth_s = time.perf_counter() - t
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
    from pvderx_torch.ops.window import (
        P_FIELDS, U_FIELDS, fleet_window_bytes, fleet_window_ops, pack_struct,
        rk4_fleet_window_batch, rk4_fleet_window_batch_ref)

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
    bytes_ms = 1e3 * fleet_window_bytes(n_envs, m, 1) / PEAK_BYTES_PER_S
    ops_ms = 1e3 * fleet_window_ops(n_envs, m, 1, n_sub) / PEAK_F32_PER_S
    step_ms = 1e3 * out["chunk_s"] / chunk
    rate = n_envs * chunk / out["chunk_s"]
    phase("fleet_main", card=card, n_envs=n_envs, m=m, n_sub=n_sub,
          reset_s=reset_s, init_res_max=init_res_max, timed_steps=chunk,
          env_steps_per_s=rate, der_steps_per_s=rate * m, step_ms=step_ms,
          kernel_ms_per_launch=kernel_ms,
          kernel_share_of_step=(kernel_ms / step_ms if kernel_ms else None),
          plain_window_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
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
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


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
    Returns the max error."""
    from pvderx_torch.ops.dualfloat import (
        rk4_window_batch_df, rk4_window_batch_df_ref)

    cuda = torch.device(device).type == "cuda"
    worst = 0.0
    for i, (name, preset, n, kw) in enumerate(cases):
        n_ph, *args = df_inputs(preset, n, i, device, **kw)
        sub = main_sub if name == "preset10_main" else n_sub
        wkw = dict(n_ph=n_ph, n_sub=sub, dt=DT * sub / N_SUB)
        before = rk4_window_batch_df.launches
        hi, lo = rk4_window_batch_df(*args, **wkw)
        moved = rk4_window_batch_df.launches - before
        ref_hi, ref_lo = rk4_window_batch_df_ref(*args, **wkw)
        _sync(device)
        err = _df_err(hi, lo, ref_hi, ref_lo)
        normal = _lo_normalized(hi, lo)
        phase("df_kernel", case=name, n=n, n_ph=n_ph, n_sub=sub,
              max_abs_err=err, tol=DF_TOL, launches=moved,
              lo_normalized=normal, max_abs_lo=float(lo.abs().max()))
        if not (np.isfinite(err) and err <= DF_TOL):
            raise AssertionError(f"df32 kernel vs plain {name}: {err:.3e} > {DF_TOL}")
        if not normal:
            raise AssertionError(f"df32 kernel {name}: |lo| > ulp(hi)/2")
        if cuda and moved != 1:
            raise AssertionError(f"df32 launch counter moved by {moved}, not 1")
        worst = max(worst, err)
    return worst


def check_df_f64(device, cases=KERNEL_CASES, n=4, n_sub=N_SUB):
    """Phase 11: the df32 kernel vs the float64 RK4 window at the same
    f32-rounded inputs (lo = 0), and the f32 kernel beside it, which must
    miss the bound. Returns (df32 error, f32 error)."""
    import dataclasses

    from pvderx_torch import make_params, nominal_exog, oracle
    from pvderx_torch.ops.dualfloat import rk4_window_batch_df
    from pvderx_torch.ops.window import P_FIELDS, U_FIELDS, rk4_window_batch

    worst = worst32 = 0.0
    for i, (name, preset, _, kw) in enumerate(cases):
        n_ph, y, t0, pp, uu = window_inputs(preset, n, 200 + i, device, **kw)
        wkw = dict(n_ph=n_ph, n_sub=n_sub, dt=DT)
        hi, lo = rk4_window_batch_df(y, torch.zeros_like(y), t0, pp, uu, **wkw)
        y32 = rk4_window_batch(y, t0, pp, uu, **wkw)
        got = (hi.double() + lo.double()).cpu().numpy()
        got32 = y32.double().cpu().numpy()
        y0, t, p_np, u_np = (a.double().cpu().numpy() for a in (y, t0, pp, uu))
        p0 = make_params(preset, **kw.get("p_over", {}))
        u0 = dataclasses.replace(nominal_exog(), **kw.get("u_over", {}))
        err = err32 = 0.0
        for e in range(n):
            pe = dataclasses.replace(
                p0, **{f: float(p_np[j, e]) for j, f in enumerate(P_FIELDS)})
            ue = dataclasses.replace(
                u0, **{f: float(u_np[j, e]) for j, f in enumerate(U_FIELDS)})
            want = oracle.rk4_window_np(y0[e], float(t[e]), DT, n_sub, pe, ue)
            err = max(err, float(np.abs(got[e] - want).max()))
            err32 = max(err32, float(np.abs(got32[e] - want).max()))
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


def check_df_gate(device, presets=("10", "50"), n_steps=120, n=128,
                  n_sub=N_SUB):
    """Phase 12: the df32 kernel vs the float64 LSODA truth on the gate
    scenario, y_lo carried from 0 (y0 is an f32 input by contract)."""
    from pvderx_torch import make_params, oracle
    from pvderx_torch.ops.dualfloat import rk4_window_batch_df
    from pvderx_torch.ops.window import P_FIELDS, U_FIELDS

    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    errs = {}
    for preset in presets:
        p = make_params(preset)
        truth, truth_s = _gate_truth(preset, n_steps)
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
              max_abs_err=err, bound=DF_GATE_TOL, lsoda_truth_s=truth_s)
        if not err <= DF_GATE_TOL:
            raise AssertionError(
                f"df32 gate preset {preset}: {err:.3e} > {DF_GATE_TOL}")
        errs[preset] = err
    return errs


def run_df_main(device, card, n_envs=N_ENVS, n_sub=N_SUB, warm=WARM_STEPS,
                chunk=CHUNK_STEPS):
    """Phase 13: the df32 tier at full width through the df32 kernel."""
    from pvderx_torch.env import core, make_batch_fns_df, make_env_config
    from pvderx_torch.env import rollout_df
    from pvderx_torch.ops.dualfloat import (
        rk4_window_batch_df, rk4_window_batch_df_ref, window_df_bytes,
        window_df_ops)
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
    peak_mib = (torch.cuda.max_memory_allocated(device) / 2 ** 20
                if cuda else None)
    state, y_lo = carry
    lo_max = float(y_lo.abs().max())

    # K3, K1 on hi and the plain df32 version alone at the main path's
    # shapes and n_sub
    t_win, exog, _, _ = core._pre_window(
        cfg, state, torch.zeros(n_envs, dtype=torch.int64, device=device))
    pk, uk = pack_struct(state.der, P_FIELDS), pack_struct(exog, U_FIELDS)
    kw = dict(n_ph=cfg.der.n_ph, n_sub=n_sub, dt=cfg.dt_ctrl)
    kernel_ms = k1_ms = plain_ms = None
    if cuda:
        kernel_ms = _time_ms(
            lambda: rk4_window_batch_df(state.y, y_lo, t_win, pk, uk, **kw),
            10, device)
        k1_ms = _time_ms(lambda: rk4_window_batch(state.y, t_win, pk, uk, **kw),
                         20, device)
        plain_ms = _time_ms(lambda: rk4_window_batch_df_ref(
            state.y, y_lo, t_win, pk, uk, **kw), 1, device)
    # K3 three-phase at the same width and n_sub
    k3_50_ms = None
    if cuda:
        _, *args50 = df_inputs("50", n_envs, 50, device)
        k3_50_ms = _time_ms(lambda: rk4_window_batch_df(
            *args50, n_ph=3, n_sub=n_sub, dt=cfg.dt_ctrl), 10, device)
    bytes_ms = 1e3 * window_df_bytes(n_envs, 1) / PEAK_BYTES_PER_S
    ops_ms = 1e3 * window_df_ops(n_envs, 1, n_sub) / PEAK_F32_PER_S
    bytes50_ms = 1e3 * window_df_bytes(n_envs, 3) / PEAK_BYTES_PER_S
    ops50_ms = 1e3 * window_df_ops(n_envs, 3, n_sub) / PEAK_F32_PER_S
    step_ms = 1e3 * out["chunk_s"] / chunk
    phase("df_main", card=card, n_envs=n_envs, n_sub=n_sub, reset_s=reset_s,
          init_res_max=init_res_max, timed_steps=chunk,
          env_steps_per_s=n_envs * chunk / out["chunk_s"], step_ms=step_ms,
          kernel_ms_per_launch=kernel_ms, k1_ms_per_launch=k1_ms,
          k3_over_k1=(kernel_ms / k1_ms if kernel_ms else None),
          kernel_share_of_step=(kernel_ms / step_ms if kernel_ms else None),
          bound_ms=max(bytes_ms, ops_ms), plain_window_ms=plain_ms,
          plain_n_sub=n_sub, k3_preset50_ms_per_launch=k3_50_ms,
          k3_preset50_bound_ms=max(bytes50_ms, ops50_ms),
          peak_mem_mib=peak_mib,
          launches=launches,
          steps=out["steps"], dones=out["dones"], rew_sum=out["rew_sum"],
          finite=out["finite"], max_abs_y_lo=lo_max)
    phase("df_linear", card=card, two_chunks_over_one=out["ratio"],
          band=[1.5, 2.7])
    _check_drive("df_main", out, launches, cuda)
    if not lo_max > 0.0:
        raise AssertionError("df_main: y_lo is zero everywhere")
    return dict(launches=launches, kernel_ms=kernel_ms, plain_ms=plain_ms,
                plain_n_sub=n_sub, bound_ms=max(bytes_ms, ops_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                preset50_ms=k3_50_ms)


def kernel_name(mangled: str) -> str:
    """`window_kernel<3>` and the like for a window kernel's mangled or
    demangled name; any other name as it is."""
    import re

    k = re.search(r"((?:fleet_)?window(?:_df)?_kernel)I((?:Li\d+E)+)E", mangled)
    if k:
        args = re.findall(r"Li(\d+)E", k.group(2))
        return f"{k.group(1)}<{','.join(args)}>"
    k = re.search(r"((?:fleet_)?window(?:_df)?_kernel)<([\d, ]+)>", mangled)
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
    from pvderx_torch.ops import _build
    from pvderx_torch.ops.dualfloat import window_df_ops
    from pvderx_torch.ops.window import (
        fleet_window_ops, window_bytes, window_ops)

    device = "cuda"
    kind = torch.cuda.get_device_name(0)
    card = _smi("name,power.limit")
    clock_mhz = float(_smi("clocks.max.sm").split()[0])
    phase("device", torch_device=kind, nvidia_smi=card,
          max_sm_clock_mhz=clock_mhz, torch=torch.__version__,
          cuda=torch.version.cuda)

    t = time.perf_counter()
    _build.build()
    _build.load()
    phase("build", seconds=time.perf_counter() - t,
          ptxas=ptxas_summary(_build.ptxas_report()))

    kernel_err = check_kernel(device)
    check_gate(device)
    main_out = run_main(device, card)
    fleet_err = check_fleet_kernel(device)
    check_fleet_gate(device)
    fleet_out = run_fleet_main(device, card)
    df_err = check_df_kernel(device)
    check_df_f64(device)
    check_df_gate(device)
    df_out = run_df_main(device, card)

    n_bytes = window_bytes(N_ENVS, 1)
    n_ops = window_ops(N_ENVS, 1, N_SUB)
    bytes_ms = 1e3 * n_bytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * n_ops / PEAK_F32_PER_S
    # one operation per FP32 lane per clock at the card's max SM clock
    issue = lambda ops: 1e3 * ops / (132 * 128 * clock_mhz * 1e6)
    issue_ms = issue(n_ops)
    phase("bound", bytes=n_bytes, ops=n_ops, bytes_ms=bytes_ms,
          ops_ms_at_67tflops=ops_ms, ops_ms_at_lane_issue=issue_ms)
    print(json.dumps({"kernels": [{
        "name": "rk4_window",
        "route": "cuda",
        "source": "pvderx_torch/ops/csrc/window.cu",
        "replaces": "pvderx/ops/window.py:56",
        "launches": main_out["launches"],
        "max_abs_err": kernel_err,
        "ms": main_out["kernel_ms"],
        "plain_ms": main_out["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "issue_bound_ms": issue_ms,
        "preset50_ms": main_out["preset50_ms"],
        "preset50_issue_bound_ms": issue(window_ops(N_ENVS, 3, N_SUB)),
        "library_ms": None,
    }, {
        "name": "rk4_fleet_window",
        "route": "cuda",
        "source": "pvderx_torch/ops/csrc/fleet_window.cu",
        "replaces": "pvderx/ops/window.py:103",
        "launches": fleet_out["launches"],
        "max_abs_err": fleet_err,
        "ms": fleet_out["kernel_ms"],
        "plain_ms": fleet_out["plain_ms"],
        "bound_ms": fleet_out["bound_ms"],
        "bound_by": fleet_out["bound_by"],
        "issue_bound_ms": issue(fleet_window_ops(FLEET_ENVS, FLEET_M, 1,
                                                 N_SUB)),
        "library_ms": None,
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
        "bound_ms": df_out["bound_ms"],
        "bound_by": df_out["bound_by"],
        "issue_bound_ms": issue(window_df_ops(N_ENVS, 1, N_SUB)),
        "preset50_ms": df_out["preset50_ms"],
        "preset50_issue_bound_ms": issue(window_df_ops(N_ENVS, 3, N_SUB)),
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
