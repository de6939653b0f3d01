"""Gymnasium adapters over the batched torch env (the counterpart of
`pvderx/env/gym_adapter.py:31-287`).

- `PVDEREnv`: one PV-DER env (a batch of one), Discrete(5) / Box(2) /
  Discrete(6) actions, Box(13) observations;
- `PVDERVectorEnv`: N envs stepped as one batch, SAME_STEP autoreset;
- `PVDERFleetEnv`: M inverters on a shared feeder, aggregate or per-unit.

Each takes ``device`` (default ``"cuda"``) and draws its episodes from a
`torch.Generator` on that device, seeded by ``seed`` and by
``reset(seed=...)``. The Gymnasium contract returns numpy, so every step
copies its outputs to the host. The ids `pvderx_torch/PVDER-v0` and
`pvderx_torch/PVDERFleet-v0` are registered by `register_envs`, which
`import pvderx_torch` calls, when gymnasium is installed. Without
gymnasium the classes keep the same reset/step surface, without spaces.

`PVDERVectorEnv` and `PVDERFleetEnv` take ``mesh`` (`pvderx_torch.dist`):
the adapter on a rank then steps that rank's rows of the global batch
(``num_envs / W`` vector envs, or one fleet episode of a global batch of W)
and returns its local observations; episodes are drawn at the global shape
from the same seed on every rank, so the W ranks together step what one
adapter of the global size steps. The reference's ``window`` and ``block``
arguments are left out: the port has no window knob (rk4 runs the CUDA
window kernel on the card, the implicit schemes `ode.implicit`).
"""
from __future__ import annotations

import numpy as np
import torch

try:
    import gymnasium as gym
    from gymnasium import spaces
    _HAS_GYM = True
except ImportError:
    gym = None
    spaces = None
    _HAS_GYM = False

from pvderx_torch._gym_ids import register_envs
from pvderx_torch.dist.mesh import local_count
from pvderx_torch.env import core, fleet
from pvderx_torch.ops.window import P_FIELDS, pack_struct

_BASE = gym.Env if _HAS_GYM else object
_VBASE = gym.vector.VectorEnv if _HAS_GYM else object


def _action_space(cfg: core.EnvConfig):
    if cfg.continuous:
        return spaces.Box(low=-1.0, high=1.0, shape=(core.ACT_DIM_CONT,),
                          dtype=np.float32)
    if cfg.anomaly_detect:
        return spaces.Discrete(core.N_ACTIONS_ANOM)
    return spaces.Discrete(core.N_ACTIONS)


def _obs_space(dim: int):
    return spaces.Box(low=-np.inf, high=np.inf, shape=(dim,),
                      dtype=np.float32)


def _actions(cfg: core.EnvConfig, actions, shape):
    """Gymnasium actions as the env's [N] int64 or [N, 2] float tensor."""
    if cfg.continuous:
        return torch.as_tensor(np.asarray(actions, np.float32),
                               dtype=cfg.dtype,
                               device=cfg.device).reshape(*shape, -1)
    return torch.as_tensor(np.asarray(actions, np.int64),
                           device=cfg.device).reshape(shape)


def _host(info: dict, row=None) -> dict:
    """Info tensors as numpy (row ``row`` of each, or all rows)."""
    return {k: (v.cpu().numpy() if row is None else v[row].cpu().numpy())
            for k, v in info.items()}


def _init_res_tol(cfg: core.EnvConfig, tol):
    # dtype-aware default: the Newton residual of a healthy f32 init sits in
    # the 2e-5..4e-4 roundoff band, the f64 band below 1e-8, so one
    # f64-grade tolerance would reject every healthy f32 reset
    if tol is None:
        tol = 1e-6 if cfg.dtype == torch.float64 else 1e-3
    return float(tol)


class PVDEREnv(_BASE):
    """One PV-DER environment with the SPEC.md §9 contract.

    action: Discrete(5), hold / Q± / Vdc±; Box(-1, 1, (2,)) with
    ``continuous=True``; Discrete(6) with ``anomaly_detect=True``.
    observation: Box(13,). ``strict_init`` raises on a reset whose Newton
    residual exceeds ``init_res_tol`` (default 1e-6 in float64, 1e-3 in
    float32) instead of starting the episode from a failed solve."""

    metadata = {"render_modes": ["ansi"]}

    def __init__(self, preset: str = "10", seed: int = 0, render_mode=None,
                 cfg: core.EnvConfig | None = None, strict_init: bool = False,
                 init_res_tol: float | None = None, device="cuda", **cfg_kw):
        self.cfg = cfg if cfg is not None else core.make_env_config(
            preset, device=device, **cfg_kw)
        self.strict_init = bool(strict_init)
        self.init_res_tol = _init_res_tol(self.cfg, init_res_tol)
        self._gen = torch.Generator(device=self.cfg.device).manual_seed(seed)
        self._state = None
        self._last = None
        self.render_mode = render_mode
        if _HAS_GYM:
            self.action_space = _action_space(self.cfg)
            self.observation_space = _obs_space(core.OBS_DIM)

    def reset(self, *, seed=None, options=None):
        # seed the inherited np_random too: `check_env` and seed-forwarding
        # wrappers expect `super().reset(seed=...)` semantics
        if _HAS_GYM:
            super().reset(seed=seed, options=options)
        if seed is not None:
            self._gen.manual_seed(int(seed))
        self._state, obs = core.reset(self.cfg, 1, self._gen)
        self._last = None
        init_res = float(self._state.init_res[0])
        if self.strict_init and not init_res <= self.init_res_tol:
            raise RuntimeError(
                f"steady-state init failed: Newton residual {init_res:.3e} > "
                f"tol {self.init_res_tol:g} (randomized scenario too "
                "aggressive for the Newton basin — see pvderx_torch.checks)")
        return obs[0].cpu().numpy().astype(np.float32), {"init_res": init_res}

    def step(self, action):
        a = _actions(self.cfg, action, (1,))
        self._state, obs, reward, _, info = core.step(self.cfg, self._state,
                                                      a)
        info_np = _host(info, 0)
        terminated = bool(info_np.pop("terminated"))
        truncated = bool(info_np.pop("truncated"))
        self._last = info_np
        return (obs[0].cpu().numpy().astype(np.float32), float(reward[0]),
                terminated, truncated, info_np)

    def render(self):
        if self._last is None:
            return "PVDER(t=0)"
        i = self._last
        return (f"t={int(self._state.t_step[0])} Vdc={float(i['vdc']):.4f} "
                f"|V|={float(i['v_mag']):.3f} P={float(i['p_pcc']):.3f} "
                f"Q={float(i['q_pcc']):.3f} f={float(i['f_meas']) * 60:.2f}Hz "
                f"tripped={bool(i['tripped'] > 0.5)}")


class PVDERVectorEnv(_VBASE):
    """N envs as one Gymnasium `VectorEnv`, stepped as one batch (on the
    card: one window-kernel launch per step with "rk4").

    Autoreset is SAME_STEP: when an episode ends, the returned observation
    is already the reset one, and ``infos["final_obs"]`` carries the
    pre-reset observation with ``infos["_final_obs"]`` marking the rows
    (Gymnasium 1.x `AutoresetMode.SAME_STEP`).

    ``mesh``: ``num_envs`` is the global count and this adapter steps the
    rank's ``num_envs / W`` of them (its ``num_envs``); a count the env
    axis does not divide raises ``ValueError``."""

    metadata = {"autoreset_mode": (gym.vector.AutoresetMode.SAME_STEP
                                   if _HAS_GYM else None)}

    def __init__(self, num_envs: int, preset: str = "10", seed: int = 0,
                 cfg: core.EnvConfig | None = None, device="cuda", mesh=None,
                 **cfg_kw):
        self.mesh = mesh
        self.num_envs = local_count(mesh, int(num_envs))
        self.cfg = cfg if cfg is not None else core.make_env_config(
            preset, device=device, **cfg_kw)
        self.render_mode = None
        self._gen = torch.Generator(device=self.cfg.device).manual_seed(seed)
        self._state = None
        self._p_pack = None
        if _HAS_GYM:
            from gymnasium.vector.utils import batch_space
            self.single_action_space = _action_space(self.cfg)
            self.single_observation_space = _obs_space(core.OBS_DIM)
            self.action_space = batch_space(self.single_action_space,
                                            self.num_envs)
            self.observation_space = batch_space(
                self.single_observation_space, self.num_envs)

    def reset(self, *, seed=None, options=None):
        if _HAS_GYM:
            super().reset(seed=seed, options=options)
        if seed is not None:
            self._gen.manual_seed(int(seed))
        self._state, obs = core.reset(self.cfg, self.num_envs, self._gen,
                                      self.mesh)
        # per-env params never change across soft resets: pack them once
        self._p_pack = pack_struct(self._state.der, P_FIELDS)
        return (obs.cpu().numpy().astype(np.float32),
                {"init_res": self._state.init_res.cpu().numpy()})

    def step(self, actions):
        cfg, n = self.cfg, self.num_envs
        st1, obs_f, rew, done, info = core.step(
            cfg, self._state, _actions(cfg, actions, (n,)), self._p_pack)
        self._state, obs, _ = core.restart_done(
            cfg, done, (st1, obs_f),
            core.event_draws(cfg, n, self._gen, self.mesh))
        info_np = _host(info)
        terminated = info_np.pop("terminated")
        truncated = info_np.pop("truncated")
        done_np = done.cpu().numpy()
        if done_np.any():
            info_np["final_obs"] = obs_f.cpu().numpy().astype(np.float32)
            info_np["_final_obs"] = done_np
        return (obs.cpu().numpy().astype(np.float32),
                rew.cpu().numpy().astype(np.float32), terminated, truncated,
                info_np)

    def close_extras(self, **kwargs):
        self._state = self._p_pack = None


class PVDERFleetEnv(_BASE):
    """M inverters per episode on a shared feeder (BASELINE config 5;
    `pvderx_torch.env.fleet`). Aggregate mode (default): one Discrete(5)
    action for the fleet, Box(13) aggregate observation. Per-unit mode
    (``per_unit=True``): MultiDiscrete([5]*M) actions, one per inverter, and
    Box(13 + 4M) observations with the per-unit [Vdc | P | Q | conn]
    block.

    ``mesh``: each rank's adapter runs its own episode, row ``r`` of a
    global batch of W fleet episodes (one per env-axis rank), drawn at
    the global shape."""

    metadata = {"render_modes": ["ansi"]}

    def __init__(self, preset: str = "10", m: int = 16, seed: int = 0,
                 render_mode=None, fc: fleet.FleetConfig | None = None,
                 per_unit: bool = False, device="cuda", mesh=None, **cfg_kw):
        self.mesh = mesh
        self.fc = fc if fc is not None else fleet.make_fleet_config(
            preset, m=m, per_unit=per_unit, device=device, **cfg_kw)
        if self.fc.base.continuous or self.fc.base.anomaly_detect:
            raise ValueError(
                "the fleet env is Discrete(5)-only: continuous/anomaly_detect "
                "modes are single-DER features (pvderx_torch/PVDER-v0); "
                "the fleet's _pre_window would silently ignore them")
        self._gen = torch.Generator(
            device=self.fc.base.device).manual_seed(seed)
        self._state = None
        self._last = None
        self.render_mode = render_mode
        if _HAS_GYM:
            self.action_space = (
                spaces.MultiDiscrete([core.N_ACTIONS] * self.fc.m)
                if self.fc.per_unit else spaces.Discrete(core.N_ACTIONS))
            self.observation_space = _obs_space(fleet.fleet_obs_dim(self.fc))

    def reset(self, *, seed=None, options=None):
        if _HAS_GYM:
            super().reset(seed=seed, options=options)
        if seed is not None:
            self._gen.manual_seed(int(seed))
        self._state, obs = fleet.reset(self.fc, 1, self._gen, self.mesh)
        self._last = None
        return (obs[0].cpu().numpy().astype(np.float32),
                {"init_res": float(self._state.init_res[0])})

    def step(self, action):
        fc = self.fc
        a = _actions(fc.base, action, (1, fc.m) if fc.per_unit else (1,))
        self._state, obs, reward, _, info = fleet.step(fc, self._state, a)
        info_np = _host(info, 0)
        terminated = bool(info_np.pop("terminated"))
        truncated = bool(info_np.pop("truncated"))
        self._last = info_np
        return (obs[0].cpu().numpy().astype(np.float32), float(reward[0]),
                terminated, truncated, info_np)

    def render(self):
        if self._last is None:
            return f"PVDERFleet(m={self.fc.m}, t=0)"
        i = self._last
        return (f"t={int(self._state.t_step[0])} m={self.fc.m} "
                f"Vdc={float(i['vdc']):.4f} |V|={float(i['v_mag']):.3f} "
                f"P={float(i['p_pcc']):.3f} "
                f"tripped={float(i['tripped_frac']):.2f}")


__all__ = ["PVDEREnv", "PVDERVectorEnv", "PVDERFleetEnv", "register_envs"]
