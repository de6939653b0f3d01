"""The frozen plain reference of the single-DER environment step.

A restatement, in plain array code over two namespaces, of what the
program's env step computes (`pvderx_torch/env/core.py`, with
`scenario/events.py` and `scenario/ride_through.py`, as they stood when
the benchmark was introduced): the event schedule drawn from uniforms, the
zero-order-held inputs, the Kahan RK4 window (`rk4_window`: a copy of the
plain window of `pvderx_torch/ops/window.py`), the ride-through
update, the observation, the reward, termination, truncation and the soft
reset; and the reset's steady state, by a batched Newton solve of its own.

Two namespaces (`portbench.reference.xp`):

- ``fx`` computes the continuous quantities: the ODE state, the physics,
  the setpoints, observations and rewards. The reference runs it in
  float64; the control in bfloat16.
- ``cx`` keeps the discrete clock in the configuration's dtype: the step
  time ``t_step * dt``, the ride-through zone timers and the event tables
  drawn from the uniforms. An env of the configuration's dtype decides
  when an event starts and when a zone's time is up in that dtype (60 sums
  of 1/60 pass 1.0 s at the 61st in float32 and at the 60th in float64), so
  these decisions follow the configuration, not the reference's precision.

Only the configuration options the benchmark's configurations use are
written here (discrete actions, no MPPT, no Volt-VAR, no anomaly flag, no
impedance jitter, one DER per env); `Spec` refuses others. A state is a
dict of arrays with the row axis leading.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from portbench.reference import rhs_core
from portbench.reference.params import DERParams, Exog, make_params
from portbench.reference.xp import NumpyXP

N_ZONES = 6


@dataclasses.dataclass(frozen=True)
class Spec:
    """What the reference needs of a configuration file."""

    der: DERParams
    dt: float
    n_sub: int
    horizon: int
    scen: dict
    rt: dict
    env: dict
    clock_dtype: str


def make_spec(config: dict) -> Spec:
    """The reference's view of a configuration file (a parsed JSON)."""
    env = config["env"]
    for flag in ("mppt_enable", "voltvar_enable", "anomaly_detect",
                 "continuous"):
        if env.get(flag, False):
            raise NotImplementedError(f"the reference has no {flag}")
    if config["scenario"].get("zg_jitter", 0.0) != 0.0:
        raise NotImplementedError("the reference has no impedance jitter")
    if int(config.get("units", 1)) != 1:
        raise NotImplementedError("the reference has no fleet")
    return Spec(der=make_params(config["der"]),
                dt=float(config["dt_ctrl"]), n_sub=int(config["n_sub"]),
                horizon=int(config["horizon"]), scen=config["scenario"],
                rt=config["ride_through"], env=env,
                clock_dtype=config["dtype"])


def clock_namespace(spec: Spec) -> NumpyXP:
    return NumpyXP(np.dtype(spec.clock_dtype))


# ---------------------------------------------------------------------------
# the event schedule and the held inputs (scenario/events.py, env/core.py)
# ---------------------------------------------------------------------------
def sample_events(spec: Spec, cx, s0, tc0, uv):
    """Event tables (solar [R, 4, 3], grid [R, 4, 6], load [R, 2, 3]) of
    each row from its uniforms ``uv`` [R, 14], in ``cx``'s dtype, by the
    formulas of the program's `_sample_events`, operation by operation."""
    sc = spec.scen
    s = cx.scalar
    inf = cx.full(s0.shape, math.inf)
    zero = cx.zeros(s0.shape)
    one = cx.full(s0.shape, 1.0)

    def u(i, lo, hi):
        return s(lo) + s(hi - lo) * uv[:, i]

    def rows(*rs):
        return cx.stack([cx.stack(r, -1) for r in rs], -2)

    has_cloud = uv[:, 0] < s(sc["p_cloud"])
    t_c = cx.where(has_cloud, u(1, sc["sag_t_lo"], sc["sag_t_hi"]), inf)
    s_c = s0 * u(2, sc["cloud_frac_lo"], sc["cloud_frac_hi"])
    dur_c = u(3, 0.5, 3.0)
    solar = rows([zero, s0, tc0], [t_c, s_c, tc0], [t_c + dur_c, s0, tc0],
                 [inf, s0, tc0])

    r = uv[:, 4]
    is_sag = r < s(sc["p_sag"])
    is_freq = (r >= s(sc["p_sag"])) & (r < s(sc["p_sag"] + sc["p_freq"]))
    t_g = u(5, sc["sag_t_lo"], sc["sag_t_hi"])
    depth = u(6, sc["sag_depth_lo"], sc["sag_depth_hi"])
    dur_g = u(7, sc["sag_dur_lo"], sc["sag_dur_hi"])
    dw = u(8, -sc["df_max"], sc["df_max"])
    t_evt = cx.where(is_sag | is_freq, t_g, inf)
    v_evt = cx.where(is_sag, depth, one)
    dw_evt = cx.where(is_freq, dw, zero)
    phi_rec = cx.remainder(s(spec.der.w_base) * dw_evt * dur_g, 2.0 * math.pi)
    n_ph3 = float(spec.der.n_ph == 3)
    is_unb = cx.cast(uv[:, 12] < s(sc["p_unb"]))
    v2_evt = (cx.cast(is_sag) * is_unb * s(n_ph3) * s(sc["unb_frac"])
              * (one - depth))
    phi2 = u(13, 0.0, 2.0 * math.pi)
    grid = rows([zero, one, zero, zero, zero, zero],
                [t_evt, v_evt, zero, dw_evt, v2_evt, phi2],
                [t_evt + dur_g, one, phi_rec, zero, zero, zero],
                [inf, one, zero, zero, zero, zero])

    has_load = uv[:, 9] < s(sc["p_load"])
    t_l = cx.where(has_load, u(10, sc["sag_t_lo"], sc["sag_t_hi"]), inf)
    g_l = u(11, 0.05, sc["load_g_hi"])
    load = rows([zero, zero, zero], [t_l, g_l, zero])
    return {"solar": solar, "grid": grid, "load": load}


def active_row(cx, table, t):
    """The last row of each [..., K, D] table whose time is <= t."""
    le = table[..., 0] <= t[..., None]
    last = le & ~cx.concatenate([le[..., 1:], le[..., :1] & False], -1)
    return cx.fsum(cx.where(last[..., None], table, 0.0), -2)


def held_inputs(fx, cx, st, t, vdc_ref, q_ref, conn, ces) -> Exog:
    """The window's inputs from the event tables at time ``t`` (``cx``),
    the values in ``fx``."""
    s = fx.cast(active_row(cx, st["solar"], t))
    g = fx.cast(active_row(cx, st["grid"], t))
    ld = fx.cast(active_row(cx, st["load"], t))
    return Exog(s_irr=s[..., 1], t_cell=s[..., 2], v_g=g[..., 1],
                phi_g=g[..., 2], dw_g=g[..., 3], t_g=g[..., 0],
                v_g2=g[..., 4], phi_g2=g[..., 5], g_load=ld[..., 1],
                b_load=ld[..., 2], vdc_ref=vdc_ref, q_ref=q_ref, conn=conn,
                ces=ces, p_ref=vdc_ref * 0.0)


# ---------------------------------------------------------------------------
# the window (a copy of ops/window.py's plain version)
# ---------------------------------------------------------------------------
def _rk4(fx, f, yt, t0, dt, n_sub, rot):
    """The Kahan-compensated RK4 window over ``f(y, t, rot)``: the grid
    rotation taken at the two new stage times of each substep."""
    h = dt / n_sub
    hh, h6 = 0.5 * h, h / 6.0
    c = yt * 0.0
    r1 = rot(t0)
    for k in range(n_sub):
        t = t0 + k * h
        rh, r4 = rot(t + hh), rot(t + h)
        k1 = f(yt, t, r1)
        k2 = f(yt + hh * k1, t + hh, rh)
        k3 = f(yt + hh * k2, t + hh, rh)
        k4 = f(yt + h * k3, t + h, r4)
        d = (h6 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)) - c
        s = yt + d
        c = (s - yt) - d
        yt, r1 = s, r4
    return yt


def rk4_window(spec: Spec, fx, y, t0, u: Exog):
    """One window of single-DER rows: y [R, n_s], t0 [R] -> y1."""
    p = spec.der
    prep = rhs_core.prep_invariants(p, u, fx, bdims=1)
    y1 = _rk4(fx, lambda yy, t, rot: rhs_core.rhs(yy, t, p, u, fx, prep, rot),
              y.T, t0, spec.dt, spec.n_sub,
              lambda t: rhs_core.grid_rot(t, p, u, fx))
    return y1.T


# ---------------------------------------------------------------------------
# ride-through, observation, reward (scenario/ride_through.py, env/core.py)
# ---------------------------------------------------------------------------
def rt_update(spec: Spec, cx, timers, tripped, v_mag, f_meas):
    """One ride-through update; zone tests and timers in ``cx``'s dtype."""
    rt, s = spec.rt, cx.scalar
    v, f = cx.cast(v_mag), cx.cast(f_meas)
    in_zone = cx.cast(cx.stack([v < s(rt["v_lv1"]), v < s(rt["v_lv2"]),
                                v > s(rt["v_hv1"]), v > s(rt["v_hv2"]),
                                f < s(rt["f_lf"]), f > s(rt["f_hf"])], -1))
    in_zone = in_zone * cx.asarray(rt["enable"])
    timers = (timers + s(spec.dt)) * in_zone
    trip_now = cx.amax(cx.cast(timers > cx.asarray(rt["t_lim"])), -1)
    return timers, cx.maximum(tripped, trip_now), in_zone[..., 1]


def reward(spec: Spec, fx, vdc, vdc_ref, q_pcc, q_ref, v_mag, trip_now):
    e = spec.env
    band = (fx.maximum(v_mag - 1.05, 0.0) + fx.maximum(0.95 - v_mag, 0.0))
    return (e["r_alive"] - e["w_vdc"] * fx.abs(vdc - vdc_ref)
            - e["w_q"] * fx.abs(q_pcc - q_ref) - e["w_vband"] * band
            - e["r_trip"] * trip_now)


def _obs_single(spec, fx, g, y, vdc_ref, q_ref, u, conn, t_next):
    return fx.stack([g.i_pos.re, g.i_pos.im, g.v_pos.re, g.v_pos.im,
                     y[:, 6 * spec.der.n_ph], g.p_pcc, g.q_pcc, vdc_ref,
                     q_ref, u.s_irr / 1000.0, 10.0 * (g.f_meas - 1.0),
                     t_next / spec.horizon, conn], -1)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def step(spec: Spec, fx, cx, st: dict, action, uv):
    """One control interval of every row, then the soft reset of the rows
    that are done, their new events drawn from ``uv`` [R, 14].

    ``action`` [R] integers in 0..4. Returns (state, obs, reward, done,
    info); ``info["final_obs"]`` is the observation before the reset."""
    e = spec.env
    n_ph = spec.der.n_ph
    t_clock = cx.cast(st["t_step"]) * cx.scalar(spec.dt)
    dq = e["dq_action"] * (fx.cast(action == 1) - fx.cast(action == 2))
    dv = e["dv_action"] * (fx.cast(action == 3) - fx.cast(action == 4))
    q_ref = fx.clip(st["q_ref"] + dq, e["q_lo"], e["q_hi"])
    vdc_ref = fx.clip(st["vdc_ref"] + dv, e["v_lo"], e["v_hi"])
    conn = 1.0 - fx.cast(st["tripped"])
    ces = fx.cast(st["ces"])
    t0 = fx.cast(t_clock)
    t1 = t0 + spec.dt
    u = held_inputs(fx, cx, st, t_clock, vdc_ref, q_ref, conn, ces)
    y1 = rk4_window(spec, fx, st["y"], t0, u)
    g = rhs_core.algebra(y1.T, t1, spec.der, u, fx)
    v_mag = fx.hypot(g.v_pos.re, g.v_pos.im)
    timers, tripped, ces1 = rt_update(spec, cx, st["timers"], st["tripped"],
                                      v_mag, g.f_meas)
    trip_new = fx.cast(tripped) * (1.0 - fx.cast(st["tripped"]))
    t_step = st["t_step"] + 1
    t_next = fx.cast(t_step)
    conn1 = 1.0 - fx.cast(tripped)
    vdc = y1[..., 6 * n_ph]
    trip_now = trip_new
    obs = _obs_single(spec, fx, g, y1, vdc_ref, q_ref, u, conn1, t_next)
    rew = reward(spec, fx, vdc, vdc_ref, g.q_pcc, q_ref, v_mag, trip_now)
    terminated = tripped > 0.5
    v2 = rhs_core.neg_seq(g.v, n_ph, fx)
    info = {"vdc": vdc, "v_mag": v_mag, "f_meas": g.f_meas,
            "v_unb": fx.hypot(v2.re, v2.im), "p_pcc": g.p_pcc,
            "q_pcc": g.q_pcc, "p_pv": g.p_pv,
            "tripped": fx.cast(tripped), "trip_now": trip_now}
    truncated = t_step >= spec.horizon
    done = terminated | truncated
    info.update(terminated=terminated, truncated=truncated, final_obs=obs)
    stepped = dict(st, y=y1, t_step=t_step, vdc_ref=vdc_ref, q_ref=q_ref,
                   timers=timers, tripped=tripped, ces=ces1)
    restarted = soft_reset(spec, fx, cx, st, uv)
    new = {k: _where_rows(fx, done, restarted[k], stepped[k])
           for k in stepped}
    obs2 = _where_rows(fx, done, st["obs0"], obs)
    return new, obs2, rew, done, info


def _where_rows(fx, done, a, b):
    """``a`` on the rows that are done, else ``b`` (a shared leaf passes)."""
    if a is b:
        return a
    return fx.where(done.reshape(done.shape + (1,) * (a.ndim - 1)), a, b)


def soft_reset(spec: Spec, fx, cx, st: dict, uv) -> dict:
    """The episode restart of every row from its cached steady state, with
    fresh mid-episode events from ``uv``."""
    shape = st["q_ref"].shape
    sched = sample_events(spec, cx, st["s0"], st["tc0"], uv)
    return dict(st, **sched, y=st["y0"], t_step=st["t_step"] * 0,
                vdc_ref=fx.full(shape, 1.0), q_ref=fx.zeros(shape),
                timers=cx.zeros(shape + (N_ZONES,)), tripped=cx.zeros(shape),
                ces=cx.zeros(shape))


# ---------------------------------------------------------------------------
# the reset: draws, events, the steady state (Newton), the first observation
# ---------------------------------------------------------------------------
def newton(res, y, iters: int = 40, tol: float = 1e-12):
    """Damped Newton for rows of independent systems ``res(y [R, K]) ->
    [R, K]`` (numpy float64), the Jacobian by central differences, steps
    scaled 1, 1/2, 1/4, 1/16 (the smallest residual wins). Returns (y, max
    abs residual per row)."""
    scales = (1.0, 0.5, 0.25, 0.0625)

    def norm(r):
        n = np.max(np.abs(r), -1)
        return np.where(np.isfinite(n), n, np.inf)

    r = res(y)
    for _ in range(iters):
        if np.all(norm(r) < tol):
            break
        rows, k = y.shape
        eps = 1e-6 * np.maximum(1.0, np.abs(y))
        pert = np.eye(k)[None] * eps[:, None, :]
        yp = (y[:, None, :] + pert).reshape(-1, k)
        ym = (y[:, None, :] - pert).reshape(-1, k)
        d = (res(yp) - res(ym)).reshape(rows, k, k) / (2.0 * eps[:, :, None])
        dy = np.linalg.solve(np.swapaxes(d, 1, 2), r[..., None])[..., 0]
        dy = np.where(np.isfinite(dy), dy, 0.0)
        best_y, best_n, best_r = None, None, None
        for s in scales:
            yc = y - s * dy
            rc = res(yc)
            nc = norm(rc)
            if best_y is None:
                best_y, best_n, best_r = yc, nc, rc
                continue
            better = nc < best_n
            best_y = np.where(better[:, None], yc, best_y)
            best_r = np.where(better[:, None], rc, best_r)
            best_n = np.where(better, nc, best_n)
        y, r = best_y, best_r
    return y, norm(r)


def reset(spec: Spec, draws: dict):
    """The reset of every row from its uniforms: ``draws`` has ``base``
    [R, 2], ``jit`` [R, 2], ``ev`` [R, 14], in the configuration's
    dtype. Returns (state, obs0, the Newton
    residual per row): continuous leaves in float64, the clock in the
    configuration's dtype."""
    fx, cx = NumpyXP(np.float64), clock_namespace(spec)
    sc, s = spec.scen, cx.scalar
    base, ev = draws["base"], draws["ev"]
    rows = base.shape[0]
    s0 = s(sc["s0_lo"]) + s(sc["s0_hi"] - sc["s0_lo"]) * base[:, 0]
    tc0 = s(sc["tc_lo"]) + s(sc["tc_hi"] - sc["tc_lo"]) * base[:, 1]
    st = sample_events(spec, cx, s0, tc0, ev)
    st.update(s0=s0, tc0=tc0)
    n_s = spec.der.n_states
    t0 = cx.zeros(rows)
    ones, zeros = fx.full(rows, 1.0), fx.zeros(rows)
    u = held_inputs(fx, cx, st, t0, ones, zeros, ones, zeros)
    guess = np.stack([rhs_core.steady_state_guess(
        spec.der, _unit(u, r), np) for r in range(rows)])

    def res(y):
        reps = y.shape[0] // rows
        return rhs_core.rhs(y.T, 0.0, spec.der, _repeat(u, reps), fx).T

    y0, r = newton(res, guess)
    st.update(y0=y0)
    obs0 = initial_obs(spec, fx, cx, st)
    shape = y0.shape[:-1]
    st.update(y=y0, obs0=obs0, t_step=np.zeros(rows, np.int64),
              vdc_ref=fx.full(shape, 1.0), q_ref=fx.zeros(shape),
              timers=cx.zeros(shape + (N_ZONES,)), tripped=cx.zeros(shape),
              ces=cx.zeros(shape))
    return st, obs0, r


def initial_obs(spec: Spec, fx, cx, st: dict):
    """The first observation of an episode at the state ``st["y0"]`` and
    the event tables of ``st``: setpoints 1 and 0, connected, t = 0."""
    y0 = st["y0"]
    rows = y0.shape[0]
    t0 = cx.zeros(rows)
    ones, zeros = fx.full(rows, 1.0), fx.zeros(rows)
    u = held_inputs(fx, cx, st, t0, ones, zeros, ones, zeros)
    g = rhs_core.algebra(y0.T, 0.0, spec.der, u, fx)
    return _obs_single(spec, fx, g, y0, ones, zeros, u, u.conn,
                       fx.zeros(rows))


def rollout(spec: Spec, fx, cx, st: dict, actions, uvs):
    """`step` over ``actions`` [T, R] with autoreset draws ``uvs``
    [T, R, 14]: (final state, final obs, rewards [T, R], dones [T, R])."""
    rews, dones, obs = [], [], None
    for a, uv in zip(actions, uvs):
        st, obs, r, d, _ = step(spec, fx, cx, st, a, uv)
        rews.append(r)
        dones.append(d)
    return st, obs, fx.stack(rews), fx.stack(dones)


def convert(st: dict, fx, cx) -> dict:
    """A reference state in the namespaces ``fx`` (continuous leaves) and
    ``cx`` (the clock; the step count stays an integer)."""
    out = {}
    for k, v in st.items():
        if k == "t_step":
            out[k] = v if fx.backend == "numpy" else _int_tensor(fx, v)
        elif k in ("y", "vdc_ref", "q_ref", "y0", "obs0", "obs"):
            out[k] = fx.cast(v)
        else:
            out[k] = cx.cast(v)
    return out


def _int_tensor(fx, v):
    import torch

    return torch.as_tensor(np.asarray(v), dtype=torch.int64,
                           device=fx.device)


def _unit(tree, r):
    """Row ``r`` of every array leaf, as Python floats."""
    def pick(x):
        x = np.asarray(x)
        return float(x) if x.ndim == 0 else float(x[r])
    return dataclasses.replace(tree, **{
        f.name: pick(getattr(tree, f.name)) for f in dataclasses.fields(tree)})


def _repeat(tree, reps):
    """Every row of every array leaf repeated ``reps`` times, row-major
    (rows of one system stay together, as the Newton perturbs them)."""
    if reps == 1:
        return tree
    def rep(x):
        x = np.asarray(x)
        return np.repeat(x, reps, axis=0) if x.ndim else x
    return dataclasses.replace(tree, **{
        f.name: rep(getattr(tree, f.name)) for f in dataclasses.fields(tree)})
