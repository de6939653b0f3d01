"""pvderx_torch — the PV-DER RL environment engine in PyTorch for NVIDIA Hopper.

A second package beside `pvderx` (JAX): the same physics, scenarios, batched
environments, learners, Gymnasium adapters and standalone simulation, with
the RK4 control windows as hand-written CUDA kernels
(`pvderx_torch/ops/csrc/`). Entry points take ``device=`` and default to
``"cuda"``; pass ``device="cpu"`` to run the plain torch versions.

    from pvderx_torch.env import make_env_config, make_batch_fns, rollout
    cfg = make_env_config("10", n_sub=64, device="cuda")
    reset_batch, step_batch = make_batch_fns(cfg)

Importing the package registers the Gymnasium ids `pvderx_torch/PVDER-v0`
(with a vector entry point) and `pvderx_torch/PVDERFleet-v0` when gymnasium
is installed (`pvderx_torch.env.gym_adapter.register_envs`); the entry
points are strings, resolved at `gym.make` time, so the env stack is not
imported here.
"""
from pvderx_torch import physics
from pvderx_torch._gym_ids import register_envs as _register_envs
from pvderx_torch.models import DER_MODEL_TYPES, make_der
from pvderx_torch.params import (
    PRESETS, DERParams, Exog, make_params, nominal_exog)

_register_envs()

# top-level conveniences, resolved on first access so `import pvderx_torch`
# stays light for physics-only users
_LAZY = {
    "check_parameters": ("pvderx_torch.checks", "check_parameters"),
    "check_scenario": ("pvderx_torch.checks", "check_scenario"),
    "creation_message": ("pvderx_torch.checks", "creation_message"),
    "make_env_config": ("pvderx_torch.env", "make_env_config"),
    "EventBuilder": ("pvderx_torch.scenario", "EventBuilder"),
    "DynamicSimulation": ("pvderx_torch.sim", "DynamicSimulation"),
    "SimulationResults": ("pvderx_torch.diag.plots", "SimulationResults"),
    "Stopwatch": ("pvderx_torch.diag.profiler", "Stopwatch"),
    "compile_report": ("pvderx_torch.diag.profiler", "compile_report"),
    "device_op_summary": ("pvderx_torch.diag.profiler", "device_op_summary"),
    "trace": ("pvderx_torch.diag.profiler", "trace"),
}

# submodules resolvable as attributes (`pvderx_torch.env.make_env_config`)
_LAZY_MODULES = ("env", "sim", "scenario", "ode", "oracle", "learn", "dist",
                 "diag", "utils", "config", "ops", "convert", "native")


def __getattr__(name):
    import importlib

    if name in _LAZY:
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    if name in _LAZY_MODULES:
        return importlib.import_module(f"pvderx_torch.{name}")
    raise AttributeError(f"module 'pvderx_torch' has no attribute {name!r}")


__all__ = [
    "DERParams", "Exog", "make_params", "nominal_exog", "PRESETS",
    "DER_MODEL_TYPES",
    "make_der", "physics", *_LAZY,
]
