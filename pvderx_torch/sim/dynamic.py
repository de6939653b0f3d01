"""Standalone dynamic simulation: the non-gym validation workflow (the
counterpart of `pvderx/sim/dynamic.py:29-131`).

One DER driven through a scripted event schedule over a time horizon,
window by window, with the full supervisory layer (events, ride-through,
MPPT, Volt-VAR) between windows: the semantics of the env's step (a batch
of one env, action 0), minus actions and reward. The series collected are
the reference's (t, states, Vdc, |V|, P, Q, ...), and the window scheme is
the config's ``integrator``: with "rk4" on the card each window is one
launch of the CUDA window kernel; float64 with "rk4" on the card raises, as
that kernel takes float32 only.

The scipy twin of this workflow is `pvderx_torch.oracle.run_trajectory`.
"""
from __future__ import annotations

import torch

from pvderx_torch.env import core
from pvderx_torch.env.core import EnvConfig, make_env_config
from pvderx_torch.ops.window import P_FIELDS, pack_struct
from pvderx_torch.params import DERParams
from pvderx_torch.scenario.events import EventBuilder, EventSchedule, make_exog
from pvderx_torch.scenario.mppt_voltvar import mppt_init
from pvderx_torch.scenario.ride_through import rt_init

NEWTON_ITERS = 30


def _one(x: torch.Tensor) -> torch.Tensor:
    """A 0-d or [1] leaf as [1] (a batch of one env)."""
    return x.reshape(1)


def _exog(st: core.EnvState, t):
    return make_exog(st.sched, t, st.vdc_ref, st.q_ref, 1.0 - st.rt.tripped,
                     st.rt.ces)


def init_from_schedule(cfg: EnvConfig, sched: EventSchedule,
                       vdc_ref: float = 1.0, q_ref: float = 0.0):
    """Steady-state init against the schedule's t=0 baseline (SPEC.md §7).

    ``sched`` holds one env's [K, D] tables on ``cfg.device``. Returns
    (state, residual): a batched `EnvState` of one env and the [1] max-abs
    Newton residual."""
    dtype, dev = cfg.dtype, cfg.device
    der = DERParams(n_ph=cfg.der.n_ph,
                    **{f: _one(getattr(cfg.der, f)) for f in P_FIELDS})
    sched = EventSchedule(solar=sched.solar[None], grid=sched.grid[None],
                          load=sched.load[None])
    zero = torch.zeros(1, dtype=dtype, device=dev)
    vdc_ref = torch.full((1,), float(vdc_ref), dtype=dtype, device=dev)
    q_ref = torch.full((1,), float(q_ref), dtype=dtype, device=dev)
    exog0 = make_exog(sched, zero, vdc_ref, q_ref, zero + 1.0, zero)
    y0, res = core.steady_state(der, exog0, iters=NEWTON_ITERS)
    g = core._algebra(y0, zero, der, exog0)
    st = core.EnvState(
        der=der, sched=sched, y=y0,
        t_step=torch.zeros(1, dtype=torch.int32, device=dev),
        vdc_ref=vdc_ref, q_ref=q_ref,
        rt=rt_init((1,), dtype, dev), mppt=mppt_init(g.p_pv),
        init_res=res, y0=y0, s0=exog0.s_irr, tc0=exog0.t_cell,
        # standalone sims never auto-reset; the cached obs is unused
        obs0=torch.zeros(1, core.OBS_DIM, dtype=dtype, device=dev),
        ppv0=g.p_pv,
    )
    return st, res


def simulate(cfg: EnvConfig, sched: EventSchedule, n_steps: int,
             vdc_ref: float = 1.0, q_ref: float = 0.0):
    """Run n_steps control windows of one DER, collecting the full series.

    Returns (state, series): series is a dict of [n_steps]-leading tensors
    on ``cfg.device``: t, y [n_steps, n_s], vdc, v_mag, p_pcc, q_pcc, p_pv,
    f_meas, m_mag, i_mag, tripped — the reference's collected trajectory.
    """
    st, _ = init_from_schedule(cfg, sched, vdc_ref, q_ref)
    action = torch.zeros(1, dtype=torch.int64, device=cfg.device)
    p_pack = pack_struct(st.der, P_FIELDS)
    rows = []
    for _ in range(n_steps):
        st, _, _, _, info = core.step(cfg, st, action, p_pack)
        t = st.t_step.to(st.y.dtype) * cfg.dt_ctrl
        g = core._algebra(st.y, t, st.der, _exog(st, t))
        rows.append(dict(
            t=t, y=st.y, vdc=info["vdc"], v_mag=info["v_mag"],
            p_pcc=info["p_pcc"], q_pcc=info["q_pcc"], p_pv=info["p_pv"],
            f_meas=info["f_meas"],
            m_mag=torch.hypot(g.m.re, g.m.im).amax(0),
            i_mag=torch.hypot(g.i.re, g.i.im).amax(0),
            tripped=st.rt.tripped))
    series = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
    return st, series


class DynamicSimulation:
    """Host-side wrapper with the reference's class surface: build, run,
    read the collected series as numpy (``sim.series["vdc"]`` or the
    reference-style ``sim.Vdc_t``), print the state."""

    def __init__(self, preset: str = "10", events: EventBuilder | None = None,
                 tStop: float = 10.0, dtype=torch.float32, device="cuda",
                 **cfg_kw):
        self.events = events if events is not None else EventBuilder()
        self.tStop = float(tStop)
        self.cfg = make_env_config(preset, dtype=dtype, device=device,
                                   **cfg_kw)
        self.series = None
        self.state = None

    @property
    def n_steps(self) -> int:
        return int(round(self.tStop / self.cfg.dt_ctrl))

    def run_simulation(self, vdc_ref: float = 1.0, q_ref: float = 0.0):
        sched = self.events.build(dtype=self.cfg.dtype,
                                  device=self.cfg.device)
        self.state, series = simulate(self.cfg, sched, self.n_steps,
                                      vdc_ref, q_ref)
        self.series = {k: v.cpu().numpy() for k, v in series.items()}
        return self.series

    # reference-style collected-series accessors (t_t, Vdc_t, ...)
    def __getattr__(self, name):
        if name.endswith("_t") and self.__dict__.get("series") is not None:
            key = name[:-2].lower()
            if key in self.series:
                return self.series[key]
        raise AttributeError(name)

    def show_PV_DER_states(self):
        """Pretty-print the current state (`pvderx_torch.utils.show_states`)."""
        if self.state is None:
            print("simulation not run")
            return
        from pvderx_torch.utils import show_states

        st = self.state
        t = st.t_step.to(st.y.dtype) * self.cfg.dt_ctrl
        show_states(st.y[0], self.cfg.der, _exog(st, t), float(t))
        print(f"  tripped={float(st.rt.tripped) > 0.5}")


__all__ = ["DynamicSimulation", "simulate", "init_from_schedule"]
