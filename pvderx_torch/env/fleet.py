"""Fleet environment: M inverters per env on a shared feeder (BASELINE cfg 5).

Batched functions over N envs of M units each (SPEC.md §11), the same
contract as `env/core.py`:

    reset(fc, n, generator)       -> (FleetState, obs [N, obs_dim])
    step(fc, state, actions)      -> (FleetState, obs, reward, done, info)

Every per-unit leaf is ``[N, M, ...]`` (the unit axis second), the event
schedule is ``[N, K, D]`` and shared by the env's units. The physics puts
the unit axis last (``[n_s, N, M]``), so the state is permuted at that
boundary. With ``integrator="rk4"`` the window runs through
`ops.window.rk4_fleet_window_batch`: the CUDA fleet kernel for tensors on
the card, its plain version for tensors on the CPU. The implicit schemes
(`ode.implicit`) solve the stacked ``[M·n_s]`` system of each env.

Two control granularities:

- **aggregate** (``per_unit=False``, default): one Discrete(5) action per
  env, applied to every unit; Box(13) observation (the single-DER layout,
  fleet aggregates).
- **per-unit** (``per_unit=True``): ``[N, M]`` actions, one Discrete(5)
  channel per inverter (``MultiDiscrete([5]*M)``), and the observation
  appends ``[M× Vdc | M× P_pcc | M× Q_pcc | M× conn]`` (dim 13 + 4M).

Reward is the fleet mean; an episode terminates when every unit has
tripped. Voltage magnitude (ride-through, Volt-VAR) is that of the shared
PCC.
"""
from __future__ import annotations

from functools import partial

import torch

from pvderx_torch._struct import replace, struct, tree_map
from pvderx_torch.dist.mesh import local_count
from pvderx_torch.env import core
from pvderx_torch.env.core import N_ACTIONS, OBS_DIM, EnvConfig, autoreset
from pvderx_torch.env.vector import rollout_with
from pvderx_torch.ode import newton_solve
from pvderx_torch.ode.implicit import WINDOWS as IMPLICIT_WINDOWS
from pvderx_torch.ops.window import (
    P_FIELDS, U_FIELDS, pack_struct, pad_draws, pad_envs, pad_tree,
    rk4_fleet_window_batch, unpack_struct, unpad_reset)
from pvderx_torch.params import DERParams, Exog
from pvderx_torch.physics import fleet, rhs_core
from pvderx_torch.physics.xp import TorchXP, like
from pvderx_torch.scenario.events import EventSchedule, make_exog
from pvderx_torch.scenario.mppt_voltvar import (
    MPPTState, mppt_init, mppt_update, voltvar_qref)
from pvderx_torch.scenario.ride_through import (
    RideThroughState, rt_init, rt_update)

NEWTON_ITERS = 15


@struct
class FleetConfig:
    base: EnvConfig
    m: int
    per_unit: bool = False


def make_fleet_config(preset: str = "10", m: int = 16, per_unit: bool = False,
                      **kw) -> FleetConfig:
    """A fleet of ``m`` units per env; ``kw`` go to `make_env_config`
    (``device`` defaults to ``"cuda"`` there)."""
    if m < 1:
        raise ValueError(f"m={m} must be >= 1")
    return FleetConfig(base=core.make_env_config(preset, **kw), m=m,
                       per_unit=per_unit)


def fleet_obs_dim(fc: FleetConfig) -> int:
    """13 shared aggregates (+ the 4M per-unit block in per-unit mode)."""
    return OBS_DIM + (4 * fc.m if fc.per_unit else 0)


@struct
class FleetState:
    der: DERParams           # [N, M] leaves (one grid-impedance draw per env)
    sched: EventSchedule     # [N, K, D], shared by the env's units
    y: torch.Tensor          # [N, M, n_states]
    t_step: torch.Tensor     # [N] int32
    vdc_ref: torch.Tensor    # [N, M]
    q_ref: torch.Tensor      # [N, M]
    s_scale: torch.Tensor    # [N, M] per-unit insolation factor
    rt: RideThroughState     # [N, M, ...]
    mppt: MPPTState          # [N, M]
    init_res: torch.Tensor   # [N] max-abs Newton residual of the coupled init
    # cached episode-initial quantities (soft reset without Newton)
    y0: torch.Tensor         # [N, M, n_states]
    s0: torch.Tensor         # [N]
    tc0: torch.Tensor        # [N]
    obs0: torch.Tensor       # [N, obs_dim]
    ppv0: torch.Tensor       # [N, M]


def _fleet_exog(sched: EventSchedule, t, m: int, vdc_ref, q_ref, conn, ces,
                s_scale) -> Exog:
    """Per-unit exog ([N, M] leaves): the event fields are the env's, shared
    by its units, with the insolation scaled per unit by ``s_scale``."""
    zero = torch.zeros_like(t)
    sh = make_exog(sched, t, zero, zero, zero + 1.0, zero)
    bc = lambda x: x[:, None].expand(-1, m)
    return Exog(
        s_irr=sh.s_irr[:, None] * s_scale, t_cell=bc(sh.t_cell),
        v_g=bc(sh.v_g), phi_g=bc(sh.phi_g), dw_g=bc(sh.dw_g), t_g=bc(sh.t_g),
        v_g2=bc(sh.v_g2), phi_g2=bc(sh.phi_g2),
        g_load=bc(sh.g_load), b_load=bc(sh.b_load),
        vdc_ref=vdc_ref, q_ref=q_ref, conn=conn, ces=ces,
        p_ref=torch.zeros_like(vdc_ref),
    )


def _algebra(y, t, der, fu) -> rhs_core.Algebra:
    """Per-unit algebra at the shared PCC voltage: y [N, M, n_s], t [N].
    Per-unit leaves come out [N, M], the PCC's (v_pos) [N, 1]."""
    return fleet.fleet_algebra(y.permute(2, 0, 1), t[:, None], der, fu,
                               like(y))


def _rhs(y, t, der, fu):
    """dY/dt of every fleet env: y [N, M, n_s], t [N], der/fu [N, M]
    leaves. A complex y [N, K, M, n_s] (K copies of each env, as
    `ode.implicit` passes for the Jacobian of the stacked unit-major
    [M·n_s] system) broadcasts each env's inputs over its copies."""
    extra = (1,) * (y.dim() - 3)
    bc = lambda x: x.reshape(x.shape[:1] + extra + x.shape[1:])
    return fleet.fleet_rhs(y.movedim(-1, 0), t.reshape(-1, *extra, 1),
                           tree_map(bc, der), tree_map(bc, fu),
                           TorchXP(der.rf.dtype, y.device)).movedim(0, -1)


def _rhs_one(yf, pk, uk, *, n_ph: int, xp: TorchXP):
    """Steady-state residual of ONE fleet env: yf [M·n_s] (unit-major, as
    the JAX package flattens it), pk [29, M], uk [15, M]."""
    p = unpack_struct(DERParams, pk, P_FIELDS, n_ph=n_ph)
    u = unpack_struct(Exog, uk, U_FIELDS)
    m = pk.shape[-1]
    y = yf.reshape(m, -1).T
    return fleet.fleet_rhs(y, 0.0, p, u, xp).T.reshape(-1)


def _obs(fc: FleetConfig, st: FleetState, g: rhs_core.Algebra, fu: Exog,
         t_next):
    """13 shared aggregates (the single-DER layout); per-unit mode appends
    [M× Vdc | M× P_pcc | M× Q_pcc | M× conn]."""
    cfg = fc.base
    vdc = st.y[:, :, 6 * cfg.der.n_ph]
    obs = torch.stack([
        g.i_pos.re.mean(-1), g.i_pos.im.mean(-1),
        g.v_pos.re[:, 0], g.v_pos.im[:, 0],
        vdc.mean(-1),
        g.p_pcc.mean(-1), g.q_pcc.mean(-1),
        st.vdc_ref.mean(-1), st.q_ref.mean(-1),
        fu.s_irr.mean(-1) / 1000.0,
        10.0 * (g.f_meas.mean(-1) - 1.0),
        t_next / cfg.horizon,
        fu.conn.mean(-1),
    ], -1)
    if fc.per_unit:
        obs = torch.cat([obs, vdc, g.p_pcc, g.q_pcc, fu.conn], -1)
    return obs


def reset(fc: FleetConfig, n: int, generator: torch.Generator, mesh=None):
    """Full episode reset of n fleet envs: scenario draws, per-unit shading,
    coupled Newton steady-state init over M·n_s unknowns per env. Under a
    ``mesh`` the n envs are this rank's rows of the global batch."""
    cfg, m = fc.base, fc.m
    dtype, dev = cfg.dtype, cfg.device
    sc = cfg.scen
    rand = partial(core._rand, cfg, generator=generator, mesh=mesh)
    n_out = n
    (base, shade, jit, ev), n = pad_draws(n, *(
        rand((n, k)) for k in (2, m, 2, core.N_EVENT_DRAWS)))
    s0 = sc.s0_lo + (sc.s0_hi - sc.s0_lo) * base[:, 0]
    tc0 = sc.tc_lo + (sc.tc_hi - sc.tc_lo) * base[:, 1]
    # shading only, scale in (1 - jitter, 1]: a scale > 1 can push a unit
    # past its current-limited capability, where no steady state exists
    s_scale = 1.0 - sc.fleet_s_jitter * shade
    der1 = core._jitter_params(cfg, n, 2.0 * jit - 1.0)
    der = fleet.fleetify(der1, m)
    sched = core._sample_events(cfg, s0, tc0, ev)

    ones = torch.ones(n, m, dtype=dtype, device=dev)
    zeros = torch.zeros(n, m, dtype=dtype, device=dev)
    t0 = torch.zeros(n, dtype=dtype, device=dev)
    fu = _fleet_exog(sched, t0, m, ones, zeros, ones, zeros, s_scale)

    n_s = cfg.der.n_states
    guess = fleet.fleet_guess(der, fu).permute(1, 2, 0).reshape(n, m * n_s)
    pk = pack_struct(der, P_FIELDS).transpose(0, 1)
    uk = pack_struct(fu, U_FIELDS).transpose(0, 1)
    f = partial(_rhs_one, n_ph=cfg.der.n_ph, xp=TorchXP(dtype, dev))
    y0, res = newton_solve(f, guess, pk, uk, iters=NEWTON_ITERS)
    y0 = y0.reshape(n, m, n_s)

    g = _algebra(y0, t0, der, fu)
    st = FleetState(
        der=der, sched=sched, y=y0,
        t_step=torch.zeros(n, dtype=torch.int32, device=dev),
        vdc_ref=ones, q_ref=zeros, s_scale=s_scale,
        rt=rt_init((n, m), dtype, dev), mppt=mppt_init(g.p_pv),
        init_res=res, y0=y0, s0=s0, tc0=tc0,
        obs0=torch.zeros(n, fleet_obs_dim(fc), dtype=dtype, device=dev),
        ppv0=g.p_pv,
    )
    obs = _obs(fc, st, g, fu, t0)
    return unpad_reset(replace(st, obs0=obs), obs, n_out, n)


def _soft_reset(fc: FleetConfig, st: FleetState, uv):
    """Episode restart from the cached steady state and initial observation;
    fresh draws ``uv`` [N, N_EVENT_DRAWS] only for the mid-episode events."""
    sched = core._sample_events(fc.base, st.s0, st.tc0, uv)
    st2 = replace(
        st, sched=sched, y=st.y0, t_step=torch.zeros_like(st.t_step),
        vdc_ref=torch.ones_like(st.vdc_ref), q_ref=torch.zeros_like(st.q_ref),
        rt=rt_init(st.q_ref.shape, st.y.dtype, st.y.device),
        mppt=mppt_init(st.ppv0),
    )
    return st2, st.obs0


def _pre_window(fc: FleetConfig, st: FleetState, action):
    """Action + supervisory layer (steps 1-2); exog held over the window.

    ``action`` is [N] (aggregate: broadcast to the units) or [N, M]
    (per-unit). Volt-VAR takes the shared PCC voltage; MPPT runs per unit."""
    cfg, m = fc.base, fc.m
    dtype = st.y.dtype
    t = st.t_step.to(dtype) * cfg.dt_ctrl
    a = action if action.dim() == 2 else action[:, None]

    q_ref, vdc_ref = st.q_ref, st.vdc_ref
    if not cfg.voltvar_enable:
        dq = cfg.dq_action * ((a == 1).to(dtype) - (a == 2).to(dtype))
        q_ref = torch.clamp(q_ref + dq, cfg.q_lo, cfg.q_hi)
    if not cfg.mppt_enable:
        dv = cfg.dv_action * ((a == 3).to(dtype) - (a == 4).to(dtype))
        vdc_ref = torch.clamp(vdc_ref + dv, cfg.v_lo, cfg.v_hi)

    conn = 1.0 - st.rt.tripped
    fu = _fleet_exog(st.sched, t, m, vdc_ref, q_ref, conn, st.rt.ces,
                     st.s_scale)
    mppt = st.mppt
    if cfg.voltvar_enable or cfg.mppt_enable:
        g0 = _algebra(st.y, t, st.der, fu)
        if cfg.voltvar_enable:
            v_mag0 = torch.hypot(g0.v_pos.re[:, 0], g0.v_pos.im[:, 0])
            q_ref = voltvar_qref(v_mag0, cfg.q_vv)[:, None].expand(-1, m)
        if cfg.mppt_enable:
            mppt, vdc_ref = mppt_update(mppt, vdc_ref, g0.p_pv,
                                        st.t_step[:, None], cfg.n_mppt)
        fu = replace(fu, vdc_ref=vdc_ref, q_ref=q_ref)
    return t, fu, mppt


def _post_window(fc: FleetConfig, st: FleetState, fu, mppt, t, y1):
    """Post-window measurements, ride-through, obs/reward/done (steps 4-5)."""
    cfg = fc.base
    dtype = st.y.dtype
    dt = cfg.dt_ctrl
    vdc_ref, q_ref = fu.vdc_ref, fu.q_ref
    g1 = _algebra(y1, t + dt, st.der, fu)
    v_mag1 = torch.hypot(g1.v_pos.re[:, 0], g1.v_pos.im[:, 0])
    # every unit sees the shared PCC voltage, and its own frequency estimate
    rt1 = rt_update(st.rt, cfg.rt, v_mag1[:, None].expand_as(g1.f_meas),
                    g1.f_meas, dt)
    trip_now = (rt1.tripped * (1.0 - st.rt.tripped)).mean(-1)

    t_next = (st.t_step + 1).to(dtype)
    st1 = replace(st, y=y1, t_step=st.t_step + 1, vdc_ref=vdc_ref,
                  q_ref=q_ref, rt=rt1, mppt=mppt)
    obs = _obs(fc, st1, g1, replace(fu, conn=1.0 - rt1.tripped), t_next)
    vdc_m = y1[:, :, 6 * cfg.der.n_ph].mean(-1)
    reward = core._reward(cfg, vdc_m, vdc_ref.mean(-1), g1.q_pcc.mean(-1),
                          q_ref.mean(-1), v_mag1, trip_now)
    terminated = rt1.tripped.amin(-1) > 0.5      # the whole fleet offline
    truncated = st1.t_step >= cfg.horizon
    done = terminated | truncated
    info = {
        "vdc": vdc_m, "v_mag": v_mag1, "f_meas": g1.f_meas.mean(-1),
        "p_pcc": g1.p_pcc.mean(-1), "q_pcc": g1.q_pcc.mean(-1),
        "p_pv": g1.p_pv.mean(-1),
        "tripped_frac": rt1.tripped.mean(-1), "trip_now_frac": trip_now,
        "terminated": terminated, "truncated": truncated,
    }
    return st1, obs, reward, done, info


def step(fc: FleetConfig, st: FleetState, action, p_pack=None):
    """One control interval of every fleet env (SPEC.md §11). The window
    scheme follows ``fc.base.integrator``: "rk4" runs through
    `ops.window.rk4_fleet_window_batch`, with ``p_pack`` the [29, N, M]
    params pack, hoisted by callers that step the same params many times
    (computed here when omitted); the implicit schemes solve the stacked
    [M·n_s] system of each env (``p_pack`` unused; on the CPU over the
    batch padded as in `env.core.step`)."""
    cfg = fc.base
    t, fu, mppt = _pre_window(fc, st, action)
    if cfg.integrator != "rk4":
        n = st.y.shape[0]
        y, tp = pad_envs(n, (st.y, 0), (t, 0))
        y1 = IMPLICIT_WINDOWS[cfg.integrator](
            partial(_rhs, der=pad_tree(n, st.der), fu=pad_tree(n, fu)), y,
            tp, cfg.dt_ctrl, cfg.n_sub)[:n]
        return _post_window(fc, st, fu, mppt, t, y1)
    if p_pack is None:
        p_pack = pack_struct(st.der, P_FIELDS)
    y1 = rk4_fleet_window_batch(st.y, t, p_pack, pack_struct(fu, U_FIELDS),
                                n_ph=cfg.der.n_ph, m=fc.m, n_sub=cfg.n_sub,
                                dt=cfg.dt_ctrl)
    return _post_window(fc, st, fu, mppt, t, y1)


def step_autoreset(fc: FleetConfig, state, actions, generator,
                   p_pack=None, mesh=None):
    """`step` of every env, then a branchless restart of the done ones, their
    new events drawn from ``generator`` (`env.core.step_autoreset` for the
    fleet)."""
    st1, obs, reward, done, info = step(fc, state, actions, p_pack)
    uv = core.event_draws(fc.base, state.y.shape[0], generator, mesh)
    st2, obs2 = autoreset(done, _soft_reset(fc, st1, uv), (st1, obs))
    return st2, obs2, reward, done, info


def make_fleet_batch_fns(fc: FleetConfig, mesh=None):
    """Returns (reset_batch(n, generator) -> (state, obs),
                step_batch(state, actions, generator)
                    -> (state, obs, reward, done, info)).

    actions: [N] integers (aggregate) or [N, M] (per-unit). step_batch
    auto-resets done envs, drawing their new events from ``generator`` (on
    the config's device); `step` is the step without autoreset.

    ``mesh`` (`pvderx_torch.dist`): ``n`` is the global env count and the
    state this rank's rows of it (N/W envs of M units each; the unit axis
    rides along unsharded); each step launches K2 on those rows. A global
    N that the env axis does not divide raises ``ValueError``."""

    def reset_batch(n: int, generator: torch.Generator):
        return reset(fc, local_count(mesh, n), generator, mesh)

    def step_batch(state, actions, generator: torch.Generator):
        return step_autoreset(fc, state, actions, generator, mesh=mesh)

    return reset_batch, step_batch


def fleet_rollout(fc: FleetConfig, state, obs, policy_fn, n_steps: int,
                  generator: torch.Generator, mesh=None):
    """Run a policy for n_steps of a batched fleet env with auto-reset.

    policy_fn(obs, generator) -> actions. Returns (state, obs, rewards
    [T, N], dones [T, N]); under a ``mesh``, of this rank's envs."""
    return rollout_with(partial(step_autoreset, mesh=mesh), fc, state, obs,
                        policy_fn, n_steps, generator,
                        pack_struct(state.der, P_FIELDS))


__all__ = [
    "FleetConfig", "FleetState", "make_fleet_config", "fleet_obs_dim",
    "reset", "step", "step_autoreset", "make_fleet_batch_fns",
    "fleet_rollout", "N_ACTIONS",
]
