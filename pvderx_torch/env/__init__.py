from pvderx_torch.env.core import (
    ACT_DIM_CONT, INTEGRATORS, N_ACTIONS, N_ACTIONS_ANOM, OBS_DIM, EnvConfig,
    EnvState, ScenarioConfig, make_env_config, reset, step)
from pvderx_torch.env.vector import make_batch_fns, rollout

__all__ = [
    "ACT_DIM_CONT", "INTEGRATORS", "N_ACTIONS", "N_ACTIONS_ANOM", "OBS_DIM",
    "EnvConfig", "EnvState", "ScenarioConfig", "make_env_config", "reset",
    "step", "make_batch_fns", "rollout",
]
