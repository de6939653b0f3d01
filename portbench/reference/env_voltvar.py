"""The plain reference of the single-DER environment step with Volt-VAR.

A module beside the frozen `portbench.reference.env`, which it leaves as
it is and calls: the frozen step with the supervisory Volt-VAR setpoint of
SPEC.md section 8 in front of it. Before each control window, ``q_ref`` is
the droop curve through the four knots of `VV_V`, with the reach
`Q_MAX`, evaluated on |V_pos|, the positive-sequence PCC voltage of the
algebra at the window's start; it is held over the window and overrides
the agent's ``q_ref``, whose Q actions are held. Everything else is the
frozen step: the event schedule, the window, ride-through, observation,
reward, termination and the soft reset; the reset too, since the curve
first acts on the first window (the first observation reads ``q_ref``
0). Plain array code over the frozen module's two namespaces, ``fx`` for
the continuous quantities (float64; bfloat16 in the control) and ``cx``
for the configuration's clock.

Departures from pvder's `SolarPV_DER_ThreePhase` with Volt-VAR on:

- pvder's Volt-VAR changes the reactive power reference inside its
  continuous-time model, on the voltage it measures at each solver step;
  here, as in the program, the setpoint is sampled once per 1/60-s control
  window and held (zero-order hold);
- the curve is the IEEE 1547-2018 Category B default (0.92, 0.98, 1.02,
  1.08 pu; +0.44 / -0.44 pu of the rating), straight lines between the
  knots and flat beyond them, with no response time constant, no
  reference-voltage adjustment and no active-power priority;
- the setpoint is per-unit of the rating on the positive sequence: under
  an unbalanced sag the curve reads |V_pos|, not each phase's voltage;
- the DER, its controllers and the grid are the frozen reference's (the
  port's per-unit model, SPEC.md sections 4 and 10), not pvder's
  physical-unit equations, and the window is RK4, not LSODA.
"""
from __future__ import annotations

import dataclasses

from portbench.reference import env, rhs_core
from portbench.reference.env import (  # noqa: F401  (the module's surface)
    Spec, clock_namespace, convert, reset)

# IEEE 1547-2018 Category B default Volt-VAR curve: the voltages V1..V4 of
# its knots in pu, and Q1 = -Q4, the reach in pu of the rating (44% of the
# nameplate apparent power, injecting below V2, absorbing above V3)
VV_V = (0.92, 0.98, 1.02, 1.08)
Q_MAX = 0.44


def make_spec(config: dict) -> Spec:
    """The reference's view of a configuration file with Volt-VAR on or
    off; it still refuses MPPT, the anomaly flag, continuous actions,
    impedance jitter and fleets. The curve's reach must lie inside the
    agent's q_ref bounds, through which the frozen step passes it."""
    env_block = dict(config["env"], voltvar_enable=False)
    spec = env.make_spec(dict(config, env=env_block))
    voltvar = bool(config["env"].get("voltvar_enable", False))
    if voltvar and not (env_block["q_lo"] <= -Q_MAX
                        and Q_MAX <= env_block["q_hi"]):
        raise ValueError(f"the Volt-VAR reach {Q_MAX} must lie inside the "
                         f"q_ref bounds [{env_block['q_lo']}, "
                         f"{env_block['q_hi']}]")
    return dataclasses.replace(spec, env=config["env"])


def voltvar_q(fx, v_mag):
    """The curve's q_ref at |V_pos| ``v_mag``: Q_MAX at and below V1, a line
    down to 0 at V2, 0 through the deadband to V3, a line down to -Q_MAX at
    V4, -Q_MAX above it."""
    v1, v2, v3, v4 = VV_V
    boost = fx.clip((v2 - v_mag) * (1.0 / (v2 - v1)), 0.0, 1.0)
    absorb = fx.clip((v_mag - v3) * (1.0 / (v4 - v3)), 0.0, 1.0)
    return Q_MAX * boost - Q_MAX * absorb


def window_start_vmag(spec: Spec, fx, cx, st: dict):
    """|V_pos| of each row's algebra at its window's start: its state, the
    event tables' inputs at the step's time, its breaker. The PCC voltage
    reads neither setpoint, so the state's stand in for the step's."""
    t_clock = cx.cast(st["t_step"]) * cx.scalar(spec.dt)
    conn = 1.0 - fx.cast(st["tripped"])
    u = env.held_inputs(fx, cx, st, t_clock, st["vdc_ref"], st["q_ref"],
                        conn, fx.cast(st["ces"]))
    g = rhs_core.algebra(st["y"].T, fx.cast(t_clock), spec.der, u, fx)
    return fx.hypot(g.v_pos.re, g.v_pos.im)


def step(spec: Spec, fx, cx, st: dict, action, uv):
    """One control interval of every row, as the frozen `env.step`, with
    the Volt-VAR setpoint where the configuration enables it: the frozen
    step runs from the state with ``q_ref`` the curve's value and the
    agent's Q actions (1 and 2) held, so that its nudge adds 0 and its
    clamp to the q_ref bounds passes the curve's value unchanged."""
    if spec.env.get("voltvar_enable", False):
        q_ref = voltvar_q(fx, window_start_vmag(spec, fx, cx, st))
        st = dict(st, q_ref=q_ref)
        action = action * ((action != 1) & (action != 2))
    return env.step(spec, fx, cx, st, action, uv)


def rollout(spec: Spec, fx, cx, st: dict, actions, uvs):
    """`step` over ``actions`` [T, R] with autoreset draws ``uvs``
    [T, R, 14]: (final state, final obs, rewards [T, R], dones [T, R])."""
    rews, dones, obs = [], [], None
    for a, uv in zip(actions, uvs):
        st, obs, r, d, _ = step(spec, fx, cx, st, a, uv)
        rews.append(r)
        dones.append(d)
    return st, obs, fx.stack(rews), fx.stack(dones)
