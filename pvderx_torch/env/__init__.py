from pvderx_torch.env.core import (
    ACT_DIM_CONT, INTEGRATORS, N_ACTIONS, N_ACTIONS_ANOM, OBS_DIM, EnvConfig,
    EnvState, ScenarioConfig, make_env_config, reset, step)
from pvderx_torch.env.fleet import (
    FleetConfig, FleetState, fleet_obs_dim, fleet_rollout, make_fleet_batch_fns,
    make_fleet_config)
from pvderx_torch.env.vector import (
    make_batch_fns, make_batch_fns_df, rollout, rollout_df)

__all__ = [
    "ACT_DIM_CONT", "INTEGRATORS", "N_ACTIONS", "N_ACTIONS_ANOM", "OBS_DIM",
    "EnvConfig", "EnvState", "ScenarioConfig", "make_env_config", "reset",
    "step", "make_batch_fns", "rollout", "make_batch_fns_df", "rollout_df",
    "FleetConfig", "FleetState", "fleet_obs_dim", "fleet_rollout",
    "make_fleet_batch_fns", "make_fleet_config",
]
