"""The PV-DER RL environment — batched functions on tensors.

A state machine of plain functions over a batch of N envs (SPEC.md §9):

    reset(cfg, n, generator)        -> (EnvState, obs [N, 13])
    step(cfg, state, actions)       -> (EnvState, obs, reward, done, info)
    step_autoreset(cfg, state, actions, generator)   (the same, autoreset)

Every leaf of `EnvState` has the env axis leading. The physics (`rhs_core`)
puts the env axis last (`[n_s, N]`), so the state is transposed at that
boundary. Scenario randomization, ride-through, MPPT and Volt-VAR are
branchless (SPEC.md §8). Auto-reset (`step_autoreset`) restores the cached
episode-initial state and re-draws only the mid-episode events, so no Newton
solve runs in the hot loop. Every random draw takes an explicit
`torch.Generator`.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any

import torch

from pvderx_torch._struct import replace, struct, tree_map
from pvderx_torch.checks import check_parameters, check_scenario
from pvderx_torch.diag.profiler import counter, span
from pvderx_torch.dist.mesh import draw_rows
from pvderx_torch.ode import newton_solve
from pvderx_torch.ode.implicit import WINDOWS as IMPLICIT_WINDOWS
from pvderx_torch.ops.autoreset import autoreset_batch, scenario_constants
from pvderx_torch.ops.post_window import post_window_batch, step_constants
from pvderx_torch.ops.pre_window import pre_window_batch, pre_window_constants
from pvderx_torch.ops.window import (
    P_FIELDS, U_FIELDS, pack_struct, pad_draws, pad_envs, pad_tree,
    rk4_window_batch, unpack_struct, unpad_reset)
from pvderx_torch.params import DERParams, Exog, make_params
from pvderx_torch.physics import rhs_core
from pvderx_torch.physics.xp import TorchXP, like
from pvderx_torch.scenario.events import EventSchedule, make_exog
from pvderx_torch.scenario.mppt_voltvar import (
    MPPTState, mppt_init, mppt_update, voltvar_qref)
from pvderx_torch.scenario.ride_through import (
    RideThroughParams, RideThroughState, default_rt_params, rt_init, rt_update)

OBS_DIM = 13
N_ACTIONS = 5       # discrete: hold / Q+ / Q- / Vdc+ / Vdc-
N_ACTIONS_ANOM = 6  # + action 5 = "flag anomaly"
ACT_DIM_CONT = 2    # continuous extension (SPEC.md §9): (dq, dv)
N_EVENT_DRAWS = 14  # uniforms per env per event schedule

# The window-integration schemes: "rk4" (explicit; the CUDA window kernel on
# the card) | "trapezoid" (A-stable, 2nd order) | "backward_euler" (L-stable,
# 1st order). The implicit schemes run `ode.implicit` (torch calls, no
# kernel) and allow n_sub below RK4's stability bound of 40.
INTEGRATORS = ("rk4", "trapezoid", "backward_euler")


@struct
class ScenarioConfig:
    """Episode randomization ranges (SPEC.md §9 reset)."""

    s0_lo: float = 600.0      # initial insolation range [W/m^2]
    s0_hi: float = 1000.0
    tc_lo: float = 293.15     # cell temperature range [K]
    tc_hi: float = 318.15
    p_sag: float = 0.5        # P(grid voltage sag event)
    sag_depth_lo: float = 0.3
    sag_depth_hi: float = 0.9
    sag_t_lo: float = 1.0
    sag_t_hi: float = 6.0
    sag_dur_lo: float = 0.1
    sag_dur_hi: float = 1.5
    p_freq: float = 0.15      # P(grid frequency excursion), exclusive with sag
    df_max: float = 0.025     # max |freq deviation| [pu]
    p_unb: float = 0.0        # P(sag is unbalanced | sag), 3-phase only
    unb_frac: float = 0.5     # neg-seq magnitude as fraction of the sag drop
    p_cloud: float = 0.5      # P(insolation step)
    cloud_frac_lo: float = 0.2
    cloud_frac_hi: float = 0.9
    p_load: float = 0.2       # P(local load step)
    load_g_hi: float = 0.5
    zg_jitter: float = 0.0    # +- relative jitter on grid R/X at reset
    fleet_s_jitter: float = 0.0  # per-unit insolation shading (fleet only)


@struct
class EnvConfig:
    der: DERParams           # 0-d tensor leaves in the working dtype/device
    rt: RideThroughParams
    scen: ScenarioConfig
    dt_ctrl: float
    # discrete action deltas + setpoint bounds (SPEC §9)
    dq_action: float
    dv_action: float
    q_lo: float
    q_hi: float
    v_lo: float
    v_hi: float
    # reward (SPEC §9)
    r_alive: float
    w_vdc: float
    w_q: float
    w_vband: float
    r_trip: float
    q_vv: float
    # anomaly-detection shaping: reward for flagging while an injected event
    # is active; penalties for false alarms and misses
    r_anom_tp: float
    r_anom_fp: float
    r_anom_fn: float
    n_sub: int
    horizon: int
    n_mppt: int
    mppt_enable: bool
    voltvar_enable: bool
    k_solar: int
    k_grid: int
    k_load: int
    continuous: bool
    anomaly_detect: bool
    integrator: str

    @property
    def dtype(self) -> torch.dtype:
        return self.der.rf.dtype

    @property
    def device(self) -> torch.device:
        return self.der.rf.device


@struct
class EnvState:
    der: DERParams           # per-env [N] leaves (possibly jittered at reset)
    sched: EventSchedule     # [N, K, D] tables
    y: torch.Tensor          # [N, n_states]
    t_step: torch.Tensor     # [N] int32
    vdc_ref: torch.Tensor    # [N]
    q_ref: torch.Tensor      # [N]
    rt: RideThroughState
    mppt: MPPTState
    init_res: torch.Tensor   # [N] max-abs Newton residual of the init
    # cached episode-initial quantities (auto-reset without Newton): the t=0
    # baseline (s0, tc0, nominal grid) is fixed per hard reset, so the
    # initial observation never changes across soft resets
    y0: torch.Tensor
    s0: torch.Tensor
    tc0: torch.Tensor
    obs0: torch.Tensor       # [N, OBS_DIM]
    ppv0: torch.Tensor


def make_env_config(
    preset: str = "10",
    dtype=torch.float32,
    n_sub: int = 120,
    horizon: int = 600,
    dt_ctrl: float = 1.0 / 60.0,
    mppt_enable: bool = False,
    voltvar_enable: bool = False,
    rt_enabled: bool = True,
    n_mppt: int = 12,
    scen: ScenarioConfig | None = None,
    der: DERParams | None = None,
    continuous: bool = False,
    anomaly_detect: bool = False,
    integrator: str = "rk4",
    device="cuda",
    **overrides: Any,
) -> EnvConfig:
    if integrator not in INTEGRATORS:
        raise ValueError(
            f"integrator={integrator!r}; choose from {sorted(INTEGRATORS)}")
    if integrator == "rk4" and n_sub < 40:
        raise ValueError(
            f"n_sub={n_sub} gives h*|lambda|max > 2.785 (RK4 stability bound) "
            "for the shipped presets; use n_sub >= 40, or an A-stable "
            "implicit integrator ('trapezoid'/'backward_euler') for "
            "stiffness margin at low n_sub (SPEC.md §6)")
    if n_sub < 1:
        raise ValueError(f"n_sub={n_sub} must be >= 1")
    if continuous and anomaly_detect:
        raise ValueError(
            "continuous=True is incompatible with anomaly_detect=True: the "
            "Box(2) action space has no flag channel, so the agent would be "
            "penalized for anomalies it cannot flag. Use the discrete "
            "6-action space for anomaly detection.")
    # voltvar_enable / mppt_enable OVERRIDE the agent's q_ref / vdc_ref
    # channel respectively (the supervisory loop takes the setpoint over).
    der = der if der is not None else make_params(preset)
    scen = scen or ScenarioConfig()
    check_parameters(der)
    check_scenario(scen)
    cfg = EnvConfig(
        der=der.to(dtype, device),
        rt=default_rt_params(rt_enabled, dtype, device),
        scen=scen,
        dt_ctrl=dt_ctrl,
        dq_action=0.01, dv_action=0.005,
        q_lo=-0.5, q_hi=0.5, v_lo=0.7, v_hi=1.2,
        r_alive=0.1, w_vdc=1.0, w_q=0.5, w_vband=0.1, r_trip=100.0,
        q_vv=0.44,
        r_anom_tp=0.5, r_anom_fp=0.2, r_anom_fn=0.1,
        n_sub=n_sub, horizon=horizon, n_mppt=n_mppt,
        mppt_enable=mppt_enable, voltvar_enable=voltvar_enable,
        k_solar=4, k_grid=4, k_load=2, continuous=continuous,
        anomaly_detect=anomaly_detect, integrator=integrator,
    )
    if overrides:
        cfg = replace(cfg, **overrides)
    return cfg


def _rand(cfg: EnvConfig, shape, generator, mesh=None):
    """Uniforms on [0, 1) of ``shape`` (env axis leading); under a mesh,
    this rank's rows of the global draw (`dist.mesh.draw_rows`)."""
    return draw_rows(mesh, lambda s: torch.rand(
        s, generator=generator, dtype=cfg.dtype, device=cfg.device), shape)


# ---------------------------------------------------------------------------
# scenario sampling (branchless; fixed table sizes)
# ---------------------------------------------------------------------------
def _sample_events(cfg: EnvConfig, s0, tc0, uv) -> EventSchedule:
    """Random mid-episode events on top of the fixed t=0 baseline (SPEC §9).

    ``uv`` is [N, N_EVENT_DRAWS] uniforms on [0, 1)."""
    sc = cfg.scen
    dtype = s0.dtype
    inf = torch.full_like(s0, math.inf)
    zero = torch.zeros_like(s0)
    one = torch.ones_like(s0)

    def u(i, lo, hi):
        return lo + (hi - lo) * uv[:, i]

    def rows(*rs):
        return torch.stack([torch.stack(r, -1) for r in rs], -2)

    # --- solar: baseline + optional cloud step + recovery ------------------
    has_cloud = uv[:, 0] < sc.p_cloud
    t_c = torch.where(has_cloud, u(1, sc.sag_t_lo, sc.sag_t_hi), inf)
    s_c = s0 * u(2, sc.cloud_frac_lo, sc.cloud_frac_hi)
    dur_c = u(3, 0.5, 3.0)
    solar = rows([zero, s0, tc0], [t_c, s_c, tc0], [t_c + dur_c, s0, tc0],
                 [inf, s0, tc0])

    # --- grid: baseline + (sag | freq excursion | none) --------------------
    r = uv[:, 4]
    is_sag = r < sc.p_sag
    is_freq = (r >= sc.p_sag) & (r < sc.p_sag + sc.p_freq)
    t_g = u(5, sc.sag_t_lo, sc.sag_t_hi)
    depth = u(6, sc.sag_depth_lo, sc.sag_depth_hi)
    dur_g = u(7, sc.sag_dur_lo, sc.sag_dur_hi)
    dw = u(8, -sc.df_max, sc.df_max)
    t_evt = torch.where(is_sag | is_freq, t_g, inf)
    v_evt = torch.where(is_sag, depth, one)
    dw_evt = torch.where(is_freq, dw, zero)
    # phase-continuous recovery: the recovery row carries the phase advanced
    # during the excursion as a static offset, so the step back to nominal
    # frequency is not a phase jump
    phi_rec = torch.remainder(cfg.der.w_base * dw_evt * dur_g, 2.0 * math.pi)
    # unbalanced sag (3-phase models; the 1-phase RHS ignores v2)
    n_ph3 = float(cfg.der.n_ph == 3)
    is_unb = (uv[:, 12] < sc.p_unb).to(dtype)
    v2_evt = is_sag.to(dtype) * is_unb * n_ph3 * sc.unb_frac * (one - depth)
    phi2 = u(13, 0.0, 2.0 * math.pi)
    grid = rows([zero, one, zero, zero, zero, zero],
                [t_evt, v_evt, zero, dw_evt, v2_evt, phi2],
                [t_evt + dur_g, one, phi_rec, zero, zero, zero],
                [inf, one, zero, zero, zero, zero])

    # --- load: baseline + optional step ------------------------------------
    has_load = uv[:, 9] < sc.p_load
    t_l = torch.where(has_load, u(10, sc.sag_t_lo, sc.sag_t_hi), inf)
    g_l = u(11, 0.05, sc.load_g_hi)
    load = rows([zero, zero, zero], [t_l, g_l, zero])
    return EventSchedule(solar=solar, grid=grid, load=load)


def _jitter_params(cfg: EnvConfig, n: int, uv) -> DERParams:
    """Per-env [N] params with grid-impedance jitter; ``uv`` is [N, 2] on
    [-1, 1)."""
    der = cfg.der
    kw = {f: getattr(der, f).expand(n) for f in P_FIELDS}
    j = cfg.scen.zg_jitter
    kw["rg"] = der.rg * (1.0 + j * uv[:, 0])
    kw["xg"] = der.xg * (1.0 + j * uv[:, 1])
    return DERParams(n_ph=der.n_ph, **kw)


# ---------------------------------------------------------------------------
# physics at the env boundary ([N, n_s] state <-> [n_s, N] physics)
# ---------------------------------------------------------------------------
def _algebra(y, t, der, exog) -> rhs_core.Algebra:
    return rhs_core.algebra(y.T, t, der, exog, like(y))


def _rhs(y, t, der, exog):
    """dy/dt of every env: y [N, n_s], t [N], der/exog [N] leaves. A complex
    y [N, K, n_s] (K copies of each env, as `ode.implicit` passes for the
    Jacobian) broadcasts each env's inputs over its copies."""
    bc = lambda x: x.reshape(x.shape + (1,) * (y.dim() - 2))
    return rhs_core.rhs(y.movedim(-1, 0), bc(t), tree_map(bc, der),
                        tree_map(bc, exog),
                        TorchXP(der.rf.dtype, y.device)).movedim(0, -1)


def _rhs_one(y, pk, uk, *, n_ph: int, xp: TorchXP):
    """Steady-state residual of ONE env: y [n_s], packed params/exog."""
    p = unpack_struct(DERParams, pk, P_FIELDS, n_ph=n_ph)
    u = unpack_struct(Exog, uk, U_FIELDS)
    return rhs_core.rhs(y, 0.0, p, u, xp)


def _guess_one(pk, uk, *, n_ph: int, xp: TorchXP):
    p = unpack_struct(DERParams, pk, P_FIELDS, n_ph=n_ph)
    u = unpack_struct(Exog, uk, U_FIELDS)
    return rhs_core.steady_state_guess(p, u, xp)


def steady_state(der, exog0, iters: int):
    """The Newton steady state at t = 0 of every env ([N] leaves), from the
    analytic guess: (y0 [N, n_s], max-abs residual [N])."""
    pk = pack_struct(der, P_FIELDS).T
    uk = pack_struct(exog0, U_FIELDS).T
    kw = dict(n_ph=der.n_ph, xp=TorchXP(der.rf.dtype, der.rf.device))
    y_guess = torch.func.vmap(partial(_guess_one, **kw))(pk, uk)
    return newton_solve(partial(_rhs_one, **kw), y_guess, pk, uk, iters=iters)


# ---------------------------------------------------------------------------
# observations / reward (SPEC.md §9)
# ---------------------------------------------------------------------------
def _obs(cfg: EnvConfig, y, g: rhs_core.Algebra, exog, t_next):
    return torch.stack([
        g.i_pos.re, g.i_pos.im, g.v_pos.re, g.v_pos.im,
        y[:, 6 * cfg.der.n_ph],
        g.p_pcc, g.q_pcc,
        exog.vdc_ref, exog.q_ref,
        exog.s_irr / 1000.0,
        10.0 * (g.f_meas - 1.0),
        t_next / cfg.horizon,
        exog.conn,
    ], -1)


def _reward(cfg: EnvConfig, vdc, vdc_ref, q_pcc, q_ref, v_mag, trip_now):
    band = (torch.clamp(v_mag - 1.05, min=0.0)
            + torch.clamp(0.95 - v_mag, min=0.0))
    return (cfg.r_alive
            - cfg.w_vdc * torch.abs(vdc - vdc_ref)
            - cfg.w_q * torch.abs(q_pcc - q_ref)
            - cfg.w_vband * band
            - cfg.r_trip * trip_now)


# ---------------------------------------------------------------------------
# reset / step
# ---------------------------------------------------------------------------
def reset(cfg: EnvConfig, n: int, generator: torch.Generator, mesh=None):
    """Full episode reset of n envs: sample scenarios, Newton steady-state
    init (SPEC §7/§9). ``generator`` lives on ``cfg.device``. Under a
    ``mesh`` the n envs are this rank's rows of the global batch, their
    scenarios drawn as the one-rank reset draws them."""
    dtype, dev = cfg.dtype, cfg.device
    sc = cfg.scen
    n_out = n
    (base, jit, ev), n = pad_draws(n, *(
        _rand(cfg, (n, k), generator, mesh) for k in (2, 2, N_EVENT_DRAWS)))
    s0 = sc.s0_lo + (sc.s0_hi - sc.s0_lo) * base[:, 0]
    tc0 = sc.tc_lo + (sc.tc_hi - sc.tc_lo) * base[:, 1]
    der = _jitter_params(cfg, n, 2.0 * jit - 1.0)
    sched = _sample_events(cfg, s0, tc0, ev)

    zeros = torch.zeros(n, dtype=dtype, device=dev)
    ones = torch.ones(n, dtype=dtype, device=dev)
    exog0 = make_exog(sched, zeros, ones, zeros, ones, zeros)
    y0, res = steady_state(der, exog0, iters=20)

    g = _algebra(y0, zeros, der, exog0)
    st = EnvState(
        der=der, sched=sched, y=y0,
        t_step=torch.zeros(n, dtype=torch.int32, device=dev),
        vdc_ref=ones, q_ref=zeros,
        rt=rt_init((n,), dtype, dev), mppt=mppt_init(g.p_pv),
        init_res=res, y0=y0, s0=s0, tc0=tc0,
        obs0=torch.zeros(n, OBS_DIM, dtype=dtype, device=dev), ppv0=g.p_pv,
    )
    obs = _obs(cfg, y0, g, exog0, zeros)
    return unpad_reset(replace(st, obs0=obs), obs, n_out, n)


def event_draws(cfg: EnvConfig, n: int, generator: torch.Generator,
                mesh=None):
    """The uniforms one soft reset of n envs consumes (this rank's rows of
    the global draw under a ``mesh``)."""
    return _rand(cfg, (n, N_EVENT_DRAWS), generator, mesh)


def unalias(st: EnvState) -> EnvState:
    """The state with its cached episode-initial buffers (``y0``, ``obs0``,
    ``ppv0``) copied, so that none shares its storage with a live leaf
    (`reset` leaves ``y0`` the same tensor as ``y``). The reference needs
    this before XLA donates a runner's buffers; a torch step never writes
    into its inputs, so the port's learners do not call it."""
    return replace(st, y0=st.y0.clone(), obs0=st.obs0.clone(),
                   ppv0=st.ppv0.clone())


def _soft_reset(cfg: EnvConfig, st: EnvState, uv):
    """Episode restart reusing the cached steady state + initial observation;
    fresh draws ``uv`` [N, N_EVENT_DRAWS] only for the mid-episode events."""
    sched = _sample_events(cfg, st.s0, st.tc0, uv)
    st2 = replace(
        st, sched=sched, y=st.y0, t_step=torch.zeros_like(st.t_step),
        vdc_ref=torch.ones_like(st.vdc_ref), q_ref=torch.zeros_like(st.q_ref),
        rt=rt_init(st.q_ref.shape, st.y.dtype, st.y.device),
        mppt=mppt_init(st.ppv0),
    )
    return st2, st.obs0


def _pre_window(cfg: EnvConfig, st: EnvState, action, p_pack=None):
    """Steps 1-2 of the control interval: action + supervisory layer.

    Returns (t, exog, mppt, flag, u_pack), the exog zero-order-held over
    the window. On the card this is one kernel launch
    (`ops.pre_window.pre_window_batch`): ``u_pack`` is its [15, N] exog
    pack, the exog views of the pack's rows, and ``flag`` None without
    ``cfg.anomaly_detect``; with Volt-VAR or MPPT it reads the params pack
    ``p_pack`` (packed here where it is None). On the CPU the plain
    version `_pre_window_plain`, which the tests and `chip_smoke.py` hold
    the kernel to, with ``u_pack`` None. No input is written. With
    Volt-VAR, inside a recorded ``env.pre_window`` span the envs whose
    setpoint the curve moved off 0 are counted (`diag.profiler.counter`)."""
    with span("env.pre_window"):
        slot = (counter("env.pre_window", st.y.shape[0], st.y.device)
                if cfg.voltvar_enable else None)
        if st.y.device.type == "cpu":
            t, exog, mppt, flag = _pre_window_plain(cfg, st, action)
            if slot is not None:
                slot += (exog.q_ref != 0).sum()
            return t, exog, mppt, flag, None
        sup = cfg.voltvar_enable or cfg.mppt_enable
        if sup and p_pack is None:
            p_pack = pack_struct(st.der, P_FIELDS)
        sched, mppt, mppt_on = st.sched, st.mppt, cfg.mppt_enable
        out = pre_window_batch(dict(
            t_step=st.t_step, q_ref=st.q_ref, vdc_ref=st.vdc_ref,
            tripped=st.rt.tripped, ces=st.rt.ces,
            action=action.to(st.y.dtype if cfg.continuous else torch.int64),
            solar=sched.solar, grid=sched.grid, load=sched.load,
            y=st.y if sup else None, p=p_pack if sup else None,
            p_prev=mppt.p_prev if mppt_on else None,
            direction=mppt.direction if mppt_on else None),
            pre_window_constants(cfg), count=slot, n_ph=cfg.der.n_ph,
            n_mppt=cfg.n_mppt, continuous=cfg.continuous,
            anomaly=cfg.anomaly_detect, voltvar=cfg.voltvar_enable,
            mppt=mppt_on)
        if mppt_on:
            mppt = MPPTState(p_prev=out["p_prev"],
                             direction=out["direction"])
        return (out["t"], unpack_struct(Exog, out["u"], U_FIELDS), mppt,
                out.get("flag"), out["u"])


def _pre_window_plain(cfg: EnvConfig, st: EnvState, action):
    """The plain version of `_pre_window`: torch operations on [N] columns.
    Returns (t, exog, mppt, flag)."""
    dtype = st.y.dtype
    t = st.t_step.to(dtype) * cfg.dt_ctrl

    # 1. agent action -> setpoint nudges (ignored for auto-controlled
    # fields)
    q_ref = st.q_ref
    vdc_ref = st.vdc_ref
    flag = torch.zeros_like(q_ref)
    if cfg.continuous:
        # continuous extension: action [N, 2] in [-1,1] scales the deltas
        a = torch.clamp(action.to(dtype), -1.0, 1.0)
        dq, dv = cfg.dq_action * a[:, 0], cfg.dv_action * a[:, 1]
    else:
        a = action
        dq = cfg.dq_action * ((a == 1).to(dtype) - (a == 2).to(dtype))
        dv = cfg.dv_action * ((a == 3).to(dtype) - (a == 4).to(dtype))
        if cfg.anomaly_detect:
            flag = (a == 5).to(dtype)   # "flag anomaly"
    if not cfg.voltvar_enable:
        q_ref = torch.clamp(q_ref + dq, cfg.q_lo, cfg.q_hi)
    if not cfg.mppt_enable:
        vdc_ref = torch.clamp(vdc_ref + dv, cfg.v_lo, cfg.v_hi)

    # 2. supervisory layer at window start (SPEC §8; ZOH over the window)
    conn = 1.0 - st.rt.tripped
    exog = make_exog(st.sched, t, vdc_ref, q_ref, conn, st.rt.ces)
    mppt = st.mppt
    if cfg.voltvar_enable or cfg.mppt_enable:
        g0 = _algebra(st.y, t, st.der, exog)
        if cfg.voltvar_enable:
            q_ref = voltvar_qref(torch.hypot(g0.v_pos.re, g0.v_pos.im),
                                 cfg.q_vv)
        if cfg.mppt_enable:
            mppt, vdc_ref = mppt_update(mppt, vdc_ref, g0.p_pv, st.t_step,
                                        cfg.n_mppt)
        exog = replace(exog, vdc_ref=vdc_ref, q_ref=q_ref)
    return t, exog, mppt, flag


def _anomaly_active(st: EnvState, exog):
    """Ground truth for the anomaly-detection reward: 1.0 while any injected
    event deviates from the episode's t=0 baseline (nominal grid, s0
    insolation, no load). No |phi_g| criterion: after a frequency excursion
    the recovery row carries the accumulated phase as a static offset."""
    dev = ((torch.abs(exog.v_g - 1.0) > 1e-6)
           | (exog.v_g2 > 1e-9)
           | (torch.abs(exog.dw_g) > 1e-9)
           | (torch.abs(exog.s_irr - st.s0) > 1e-3)
           | (exog.g_load > 1e-9) | (torch.abs(exog.b_load) > 1e-9))
    return dev.to(st.y.dtype)


def _post_window(cfg: EnvConfig, st: EnvState, exog, mppt, t, y1, flag,
                 p_pack=None, u_pack=None):
    """Steps 4-5: post-window measurements, ride-through, obs/reward/done.

    On the card this is one kernel launch
    (`ops.post_window.post_window_batch`, on the window's ``p_pack`` and
    ``u_pack``, packed here where they are None); on the CPU the plain
    version `_post_window_plain`, which the tests and `chip_smoke.py` hold
    the kernel to. Returns (state, obs, reward, done, info) (`_stepped`);
    no input is written."""
    with span("env.post_window"):
        if y1.device.type == "cpu":
            return _post_window_plain(cfg, st, exog, mppt, t, y1, flag)
        if p_pack is None:
            p_pack = pack_struct(st.der, P_FIELDS)
        if u_pack is None:
            u_pack = pack_struct(exog, U_FIELDS)
        anom = cfg.anomaly_detect
        leaves = post_window_batch(
            y1, t, st.t_step, p_pack, u_pack, st.rt.timers, st.rt.tripped,
            cfg.rt.t_lim, cfg.rt.enable, flag if anom else None,
            st.s0 if anom else None, step_constants(cfg),
            n_ph=cfg.der.n_ph, horizon=cfg.horizon)
        return _stepped(cfg, st, exog, mppt, y1, leaves)


def _stepped(cfg: EnvConfig, st: EnvState, exog, mppt, y1, leaves):
    """(state, obs, reward, done, info) of a step from the leaves its
    post-window glue computed (`ops.post_window.OUT_LEAVES`, by name): the
    state's y is the window's y1, ``info["vdc"]`` a view of it,
    ``info["tripped"]`` the state's new trip latch, the setpoints the
    exog's; every other leaf as computed."""
    rt1 = replace(st.rt, timers=leaves["timers"], tripped=leaves["tripped"],
                  ces=leaves["ces"])
    st1 = replace(st, y=y1, t_step=leaves["t_step"], vdc_ref=exog.vdc_ref,
                  q_ref=exog.q_ref, rt=rt1, mppt=mppt)
    info = {
        "vdc": y1[:, 6 * cfg.der.n_ph], "v_mag": leaves["v_mag"],
        "f_meas": leaves["f_meas"], "v_unb": leaves["v_unb"],
        "p_pcc": leaves["p_pcc"], "q_pcc": leaves["q_pcc"],
        "p_pv": leaves["p_pv"], "tripped": rt1.tripped,
        "trip_now": leaves["trip_now"], "terminated": leaves["terminated"],
        "truncated": leaves["truncated"],
    }
    return st1, leaves["obs"], leaves["reward"], leaves["done"], info


def _post_window_plain(cfg: EnvConfig, st: EnvState, exog, mppt, t, y1,
                       flag):
    """The plain version of `_post_window`: torch operations on [N]
    columns."""
    dt = cfg.dt_ctrl
    # 4. post-window measurements + ride-through update
    g1 = _algebra(y1, t + dt, st.der, exog)
    v_mag1 = torch.hypot(g1.v_pos.re, g1.v_pos.im)
    rt1 = rt_update(st.rt, cfg.rt, v_mag1, g1.f_meas, dt)
    trip_now = rt1.tripped * (1.0 - st.rt.tripped)

    # 5. outputs
    t_step = st.t_step + 1
    # obs reflects post-step connection status (a trip this step shows up)
    obs = _obs(cfg, y1, g1, replace(exog, conn=1.0 - rt1.tripped),
               t_step.to(y1.dtype))
    reward = _reward(cfg, y1[:, 6 * cfg.der.n_ph], exog.vdc_ref, g1.q_pcc,
                     exog.q_ref, v_mag1, trip_now)
    if cfg.anomaly_detect:
        anom = _anomaly_active(st, exog)
        reward = reward + (flag * (anom * cfg.r_anom_tp
                                   - (1.0 - anom) * cfg.r_anom_fp)
                           - (1.0 - flag) * anom * cfg.r_anom_fn)
    terminated = rt1.tripped > 0.5
    truncated = t_step >= cfg.horizon
    v2 = rhs_core.neg_seq(g1.v, cfg.der.n_ph, like(y1))
    return _stepped(cfg, st, exog, mppt, y1, dict(
        obs=obs, reward=reward, done=terminated | truncated,
        terminated=terminated, truncated=truncated, t_step=t_step,
        timers=rt1.timers, tripped=rt1.tripped, ces=rt1.ces, v_mag=v_mag1,
        f_meas=g1.f_meas,
        v_unb=torch.hypot(v2.re, v2.im),   # PCC neg-seq voltage magnitude
        p_pcc=g1.p_pcc, q_pcc=g1.q_pcc, p_pv=g1.p_pv, trip_now=trip_now))


def step(cfg: EnvConfig, st: EnvState, action, p_pack=None):
    """One control interval of every env (SPEC.md §9).

    With ``cfg.integrator == "rk4"`` the window runs through
    `ops.window.rk4_window_batch`: the CUDA kernel for tensors on the card,
    its plain version for tensors on the CPU. ``p_pack`` is the [29, N]
    params pack, hoisted by callers that step the same params many times (it
    is computed here when omitted); it and the exog pack (`_pre_window`'s on
    the card) go on to `_post_window`. The implicit schemes integrate
    `rhs_core.rhs` through `ode.implicit` (no kernel; no params pack is
    made), on the CPU over the batch padded as the plain windows pad theirs
    (`ops.window.pad_envs`), so that an env's step does not depend on the
    batch size."""
    if p_pack is None and cfg.integrator == "rk4":
        p_pack = pack_struct(st.der, P_FIELDS)
    t, exog, mppt, flag, u_pack = _pre_window(cfg, st, action, p_pack)
    with span("env.window"):
        if cfg.integrator != "rk4":
            n = st.y.shape[0]
            y, tp = pad_envs(n, (st.y, 0), (t, 0))
            y1 = IMPLICIT_WINDOWS[cfg.integrator](
                partial(_rhs, der=pad_tree(n, st.der),
                        exog=pad_tree(n, exog)),
                y, tp, cfg.dt_ctrl, cfg.n_sub)[:n]
        else:
            if u_pack is None:
                u_pack = pack_struct(exog, U_FIELDS)
            y1 = rk4_window_batch(st.y, t, p_pack, u_pack,
                                  n_ph=cfg.der.n_ph, n_sub=cfg.n_sub,
                                  dt=cfg.dt_ctrl)
    return _post_window(cfg, st, exog, mppt, t, y1, flag, p_pack, u_pack)


def _where_done(done, a, b):
    """torch.where with done [N] broadcast against [N, ...] leaves; a leaf
    that is the same tensor in both states is passed through."""
    if a is b:
        return a
    d = done.reshape(done.shape + (1,) * (a.dim() - 1))
    return torch.where(d, a, b)


def autoreset(done, restarted, stepped):
    """Select the soft-reset (state, obs) where done, else the stepped one."""
    (st_r, obs_r), (st1, obs) = restarted, stepped
    return (tree_map(lambda a, b: _where_done(done, a, b), st_r, st1),
            _where_done(done, obs_r, obs))


def restart_done(cfg: EnvConfig, done, stepped, uv, y_lo=None):
    """The autoreset of a stepped batch: `autoreset` of `_soft_reset` (the
    mid-episode events drawn from ``uv``) where ``done``, else ``stepped``
    = (state, obs); with ``y_lo``, the df32 tier's lo residual too, zeroed
    where done. Returns (state, obs, y_lo or None), all fresh where they
    change: no input is written.

    On the card this is one kernel launch (`ops.autoreset.autoreset_batch`)
    that does the restart arithmetic of the done envs only; on the CPU the
    plain version above, which the tests and `chip_smoke.py` hold the
    kernel to, bit for bit. Inside a recorded ``env.autoreset`` span the
    envs restarted are counted (`diag.profiler.counter`)."""
    st1, obs = stepped
    slot = counter("env.autoreset", done.shape[0], done.device)
    if done.device.type == "cpu":
        if slot is not None:
            slot += done.sum()
        st2, obs2 = autoreset(done, _soft_reset(cfg, st1, uv), stepped)
        if y_lo is not None:
            y_lo = _where_done(done, torch.zeros_like(y_lo), y_lo)
        return st2, obs2, y_lo
    sched, rt, mppt = st1.sched, st1.rt, st1.mppt
    out = autoreset_batch(dict(
        done=done, uv=uv, s0=st1.s0, tc0=st1.tc0, y0=st1.y0, obs0=st1.obs0,
        ppv0=st1.ppv0, w_base=cfg.der.w_base, solar=sched.solar,
        grid=sched.grid, load=sched.load, y=st1.y, t_step=st1.t_step,
        vdc_ref=st1.vdc_ref, q_ref=st1.q_ref, timers=rt.timers,
        tripped=rt.tripped, ces=rt.ces, p_prev=mppt.p_prev,
        direction=mppt.direction, obs=obs, y_lo=y_lo),
        scenario_constants(cfg.scen), slot, n_ph=cfg.der.n_ph)
    st2 = replace(
        st1, sched=replace(sched, solar=out["solar"], grid=out["grid"],
                           load=out["load"]),
        y=out["y"], t_step=out["t_step"], vdc_ref=out["vdc_ref"],
        q_ref=out["q_ref"],
        rt=replace(rt, timers=out["timers"], tripped=out["tripped"],
                   ces=out["ces"]),
        mppt=replace(mppt, p_prev=out["p_prev"], direction=out["direction"]))
    return st2, out["obs"], out.get("y_lo")


def step_autoreset(cfg: EnvConfig, st: EnvState, action,
                   generator: torch.Generator, p_pack=None, mesh=None):
    """`step`, then a branchless restart of the envs that are done
    (`restart_done`): the cached episode-initial state, with fresh
    mid-episode events drawn from ``generator`` (under a ``mesh``, this
    rank's rows of the global draw). The batched counterpart of the
    reference's per-env `step_autoreset`, which draws from the state's own
    key."""
    with span("env.step"):
        st1, obs, reward, done, info = step(cfg, st, action, p_pack)
        with span("env.autoreset"):
            uv = event_draws(cfg, st.y.shape[0], generator, mesh)
            st2, obs2, _ = restart_done(cfg, done, (st1, obs), uv)
    return st2, obs2, reward, done, info


__all__ = [
    "ScenarioConfig", "EnvConfig", "EnvState", "make_env_config", "reset",
    "step", "step_autoreset", "autoreset", "restart_done", "unalias",
    "event_draws",
    "OBS_DIM", "N_ACTIONS", "N_ACTIONS_ANOM", "ACT_DIM_CONT", "INTEGRATORS",
]
