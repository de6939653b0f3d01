"""The port's Gymnasium ids and their registration.

A module of its own, outside `pvderx_torch.env`, so that `import
pvderx_torch` can register the ids without importing the env stack: the
entry points are strings, resolved at `gym.make` time. Users call it as
`pvderx_torch.env.gym_adapter.register_envs`.
"""
from __future__ import annotations

import importlib.util


def register_envs() -> None:
    """Register `pvderx_torch/PVDER-v0` (with its vector entry point) and
    `pvderx_torch/PVDERFleet-v0` with Gymnasium. Idempotent; without
    gymnasium installed it does nothing."""
    if importlib.util.find_spec("gymnasium") is None:
        return
    from gymnasium.envs.registration import register, registry

    if "pvderx_torch/PVDER-v0" not in registry:
        register(id="pvderx_torch/PVDER-v0",
                 entry_point="pvderx_torch.env.gym_adapter:PVDEREnv",
                 vector_entry_point="pvderx_torch.env.gym_adapter:"
                                    "PVDERVectorEnv")
    if "pvderx_torch/PVDERFleet-v0" not in registry:
        register(id="pvderx_torch/PVDERFleet-v0",
                 entry_point="pvderx_torch.env.gym_adapter:PVDERFleetEnv")
