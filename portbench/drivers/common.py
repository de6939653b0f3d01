"""What the drivers share: the program's env config from a configuration
file, rows of the program's env state as the reference's state, the
replay of the random streams the benchmark handed the program, and the
readings the checks compare."""
from __future__ import annotations

import math

import numpy as np

# scalars of a configuration's "env" block that the program takes as
# overrides of its env config
ENV_OVERRIDES = ("dq_action", "dv_action", "q_lo", "q_hi", "v_lo", "v_hi",
                 "r_alive", "w_vdc", "w_q", "w_vband", "r_trip", "k_solar",
                 "k_grid", "k_load")
# state leaves of the reference (portbench.reference.env) in float64; every
# other leaf keeps the configuration's dtype (the clock) or is an integer
CONTINUOUS = ("y", "vdc_ref", "q_ref", "y0", "obs0", "obs")


def sync(device: str):
    """Wait for the card, where the run has one."""
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def release(device: str):
    """Hand the freed program state's device memory back."""
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()


def program_config(config: dict, device: str):
    """The program's env config of a configuration file."""
    import torch
    from pvderx_torch.env import make_env_config
    from pvderx_torch.env.core import ScenarioConfig

    env = config["env"]
    kw = dict(dtype=getattr(torch, config["dtype"]), n_sub=config["n_sub"],
              horizon=config["horizon"], dt_ctrl=config["dt_ctrl"],
              mppt_enable=env["mppt_enable"],
              voltvar_enable=env["voltvar_enable"],
              continuous=env["continuous"],
              anomaly_detect=env["anomaly_detect"],
              scen=ScenarioConfig(**config["scenario"]), device=device,
              **{k: env[k] for k in ENV_OVERRIDES})
    return make_env_config(config["preset"], **kw)


def state_rows(st, idx, fields) -> dict:
    """Rows ``idx`` (a device index tensor) of the program's env state, by
    the reference's names (device tensors; `to_reference` converts)."""
    get = {
        "y": lambda: st.y, "t_step": lambda: st.t_step,
        "vdc_ref": lambda: st.vdc_ref, "q_ref": lambda: st.q_ref,
        "timers": lambda: st.rt.timers, "tripped": lambda: st.rt.tripped,
        "ces": lambda: st.rt.ces, "solar": lambda: st.sched.solar,
        "grid": lambda: st.sched.grid, "load": lambda: st.sched.load,
        "y0": lambda: st.y0, "obs0": lambda: st.obs0, "s0": lambda: st.s0,
        "tc0": lambda: st.tc0,
    }
    return {k: get[k]().index_select(0, idx) for k in fields}


def to_reference(rows: dict) -> dict:
    """Device rows as numpy: float64 for the continuous leaves, the
    configuration's dtype for the clock, int64 for the step count."""
    out = {}
    for k, v in rows.items():
        a = v.detach().cpu()
        if k in CONTINUOUS:
            out[k] = a.double().numpy()
        elif k == "t_step":
            out[k] = a.long().numpy()
        else:
            out[k] = a.numpy()
    return out


def cat_rows(dicts) -> dict:
    return {k: np.concatenate([d[k] for d in dicts]) for k in dicts[0]}


def generator_at(state, device: str):
    """A generator of ``device`` at a saved state."""
    import torch

    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def max_abs(a, b) -> float:
    """The largest |a - b| (inf where one is not finite and the other is,
    or where a NaN shows)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} and {b.shape}")
    fa, fb = np.isfinite(a), np.isfinite(b)
    if (fa != fb).any() or (~fa & (a != b)).any():
        return math.inf
    return float(np.max(np.abs(a[fa] - b[fa]), initial=0.0))


def horizon_unit(horizon: int, unit_steps: int, before: int) -> int:
    """The first unit of work of the window (0-based; a unit is
    ``unit_steps`` env steps, and ``before`` units ran between the reset
    and the window) in which an env that has neither tripped nor been
    reset since the reset reaches its horizon and is reset."""
    j = 0
    while ((before + j + 1) * unit_steps) // horizon == (
            (before + j) * unit_steps) // horizon:
        j += 1
    return j


def sample_ids(n: int, k: int, seed: int) -> list:
    """``k`` of ``range(n)`` drawn from ``seed``, the first and the last
    always among them, in order."""
    if n <= k:
        return list(range(n))
    rest = np.random.default_rng(seed).choice(np.arange(1, n - 1), k - 2,
                                              replace=False)
    return sorted({0, n - 1, *map(int, rest)})


def checks(limits: dict, readings: dict) -> list:
    """(name, reading, limit) of each reading, in the order read; a reading
    with no limit in the cell's limits file raises."""
    missing = set(readings) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    return [(k, float(v), float(limits[k])) for k, v in readings.items()]


def reset_draws(cell, gen_state, idx) -> dict:
    """The uniforms the program's reset drew from a generator at
    ``gen_state``, rows ``idx``: ``base``, ``jit``, ``ev``, in the
    program's order of draws."""
    import torch

    dev, n = cell.device, cell.n_envs
    gen = generator_at(gen_state, dev)
    dtype = getattr(torch, cell.config["dtype"])
    widths = {"base": 2, "jit": 2, "ev": 14}
    return {k: torch.rand((n, w), generator=gen, dtype=dtype,
                          device=dev).index_select(0, idx).cpu().numpy()
            for k, w in widths.items()}


def reset_readings(spec, draws: dict, got: dict, control: bool) -> dict:
    """The reset's readings: the program's steady state ``y0``, first
    observation ``obs0`` and event tables (``got``, reference names)
    against the reference's reset from ``draws``; with ``control`` the
    control's reset in the program's place: the reference's steady state
    held in bfloat16, its event tables and first observation computed in
    bfloat16."""
    import torch

    from portbench.reference import env as renv
    from portbench.reference.xp import TorchXP, to_numpy

    ref, ref_obs0, _ = renv.reset(spec, draws)
    if control:
        bf = TorchXP(torch.bfloat16)
        sc, s = spec.scen, bf.scalar
        base = bf.cast(draws["base"])
        s0 = s(sc["s0_lo"]) + s(sc["s0_hi"] - sc["s0_lo"]) * base[:, 0]
        tc0 = s(sc["tc_lo"]) + s(sc["tc_hi"] - sc["tc_lo"]) * base[:, 1]
        st = renv.sample_events(spec, bf, s0, tc0, bf.cast(draws["ev"]))
        st["y0"] = bf.cast(ref["y0"])
        st["obs0"] = renv.initial_obs(spec, bf, bf, st)
        got = {k: to_numpy(v) for k, v in st.items()}
    return {"reset_state": max_abs(got["y0"], ref["y0"]),
            "reset_obs": max_abs(got["obs0"], ref_obs0),
            "schedule": max(max_abs(got[k], ref[k])
                            for k in ("solar", "grid", "load"))}
