"""Carry parameters, env state and net weights into the port from numpy.

The dict layouts are those of the JAX package's dataclasses, so a state
taken there as numpy (``dataclasses.asdict`` of the state with every leaf
turned into a numpy array) steps here unchanged: a batched `EnvState`, or a
batched `FleetState` (per-unit leaves [N, M, ...]). The JAX state's per-env PRNG
``key`` has no counterpart (the port draws from a `torch.Generator`) and is
dropped.

A learner net's weights come over from Flax params, a nested dict of numpy
arrays (``{"params": {"Dense_0": {"kernel", "bias"}, ...}}``, the
``"params"`` level optional). Flax names a module's Dense layers
``Dense_0..n`` in call order, and each net of `pvderx_torch.learn.nets`
lists its `Linear` layers in that order (``net.layers()``); a Flax kernel
is ``[in, out]`` and a torch weight its transpose. `flax_state_dict` pairs
the two lists into the net's `state_dict`.
"""
from __future__ import annotations

import numpy as np
import torch

from pvderx_torch.env.core import EnvConfig, EnvState
from pvderx_torch.env.fleet import FleetConfig, FleetState
from pvderx_torch.ops.window import P_FIELDS
from pvderx_torch.params import DERParams
from pvderx_torch.scenario.events import EventSchedule
from pvderx_torch.scenario.mppt_voltvar import MPPTState
from pvderx_torch.scenario.ride_through import RideThroughState


def params_from_numpy(d: dict, dtype=torch.float32, device="cuda") -> DERParams:
    """A `DERParams` from a dict of numpy leaves keyed by its field names."""
    return DERParams(n_ph=int(d["n_ph"]), **{
        f: torch.as_tensor(d[f], dtype=dtype, device=device) for f in P_FIELDS})


def _leaves(d: dict, cfg: EnvConfig, device):
    """The fields an env state and a fleet state share, as tensors."""
    f = lambda a: torch.as_tensor(a, dtype=cfg.dtype, device=device)
    return dict(
        der=params_from_numpy(d["der"], cfg.dtype, device),
        sched=EventSchedule(**{k: f(d["sched"][k])
                               for k in ("solar", "grid", "load")}),
        y=f(d["y"]),
        t_step=torch.as_tensor(d["t_step"], dtype=torch.int32, device=device),
        vdc_ref=f(d["vdc_ref"]), q_ref=f(d["q_ref"]),
        rt=RideThroughState(**{k: f(d["rt"][k])
                               for k in ("timers", "tripped", "ces")}),
        mppt=MPPTState(p_prev=f(d["mppt"]["p_prev"]),
                       direction=f(d["mppt"]["direction"])),
        init_res=f(d["init_res"]),
        y0=f(d["y0"]), s0=f(d["s0"]), tc0=f(d["tc0"]), obs0=f(d["obs0"]),
        ppv0=f(d["ppv0"]),
    )


def state_from_numpy(d: dict, cfg: EnvConfig, device=None) -> EnvState:
    """An `EnvState` from a nested dict of numpy arrays keyed like the
    state's fields (batched, env axis leading). Floats take ``cfg.dtype``;
    the step counter is int32. ``device`` defaults to ``cfg.device``."""
    return EnvState(**_leaves(d, cfg, cfg.device if device is None else device))


def fleet_state_from_numpy(d: dict, fc: FleetConfig,
                           device=None) -> FleetState:
    """A `FleetState` from the numpy dict of a batched JAX fleet state
    (leaf by leaf, as `state_from_numpy`)."""
    cfg = fc.base
    device = cfg.device if device is None else device
    return FleetState(
        **_leaves(d, cfg, device),
        s_scale=torch.as_tensor(d["s_scale"], dtype=cfg.dtype, device=device))


def dense_layers(params: dict) -> list:
    """Flax params -> [(kernel [in, out], bias)] in Dense_0..n order."""
    p = params["params"] if "params" in params else params
    idx = sorted(int(k.split("_")[1]) for k in p if k.startswith("Dense_"))
    return [(np.asarray(p[f"Dense_{i}"]["kernel"]),
             np.asarray(p[f"Dense_{i}"]["bias"])) for i in idx]


def flax_state_dict(net: torch.nn.Module, params: dict) -> dict:
    """Flax params -> the `state_dict` of ``net`` (any net of
    `pvderx_torch.learn.nets`): float32 tensors, the i-th `Linear` of
    ``net.layers()`` taking Dense_i."""
    layers, dense = net.layers(), dense_layers(params)
    if len(layers) != len(dense):
        raise ValueError(f"{len(dense)} Dense layers for {len(layers)} "
                         f"Linear layers of {type(net).__name__}")
    names = {id(m): n for n, m in net.named_modules()}
    sd = {}
    for lin, (k, b) in zip(layers, dense):
        sd[f"{names[id(lin)]}.weight"] = torch.tensor(k.T, dtype=torch.float32)
        sd[f"{names[id(lin)]}.bias"] = torch.tensor(b, dtype=torch.float32)
    return sd
