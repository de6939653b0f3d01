"""The learners: PPO, DQN and SAC over the single-DER and fleet envs, their
networks, the packed replay and the numpy policy export (the port of
`pvderx.learn`)."""
from pvderx_torch.learn.dqn import DQNConfig, DQNRunner, make_dqn
from pvderx_torch.learn.env_api import EnvAPI, make_env_api
from pvderx_torch.learn.export import (
    NumpyMLPPolicy, export_actor_critic, export_qnetwork,
    export_tanh_gaussian)
from pvderx_torch.learn.nets import (
    ActorCritic, DoubleCritic, QNetwork, TanhGaussianActor)
from pvderx_torch.learn.ppo import PPOConfig, PPORunner, make_ppo
from pvderx_torch.learn.sac import SACConfig, SACRunner, make_sac

__all__ = [
    "ActorCritic", "DoubleCritic", "QNetwork", "TanhGaussianActor",
    "DQNConfig", "make_dqn", "DQNRunner",
    "PPOConfig", "make_ppo", "PPORunner",
    "SACConfig", "make_sac", "SACRunner",
    "EnvAPI", "make_env_api",
    "NumpyMLPPolicy", "export_actor_critic", "export_qnetwork",
    "export_tanh_gaussian",
]
