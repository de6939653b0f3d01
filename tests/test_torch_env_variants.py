"""The port's env variants against the JAX env: Volt-VAR with MPPT, the
anomaly-detection reward and the continuous action space.

Same protocol as tests/test_torch_env.py: a JAX float64 reset state with
scripted events is carried into the port and both step the same seeded
actions; obs, reward and done agree to 1e-9.
"""
import numpy as np
import pytest

from test_torch_env import N_ENVS, _pair, _step_both


@pytest.mark.parametrize("variant", ["voltvar_mppt", "anomaly", "continuous"])
def test_torch_env_variants_match_jax(variant):
    kw = {"voltvar_mppt": dict(voltvar_enable=True, mppt_enable=True,
                               n_mppt=3),
          "anomaly": dict(anomaly_detect=True),
          "continuous": dict(continuous=True)}[variant]
    cfg_j, st_j, cfg, st = _pair(n_sub=40, **kw)
    rng = np.random.default_rng(11)
    if variant == "continuous":
        acts = [rng.uniform(-1.5, 1.5, (N_ENVS, 2)) for _ in range(12)]
    else:
        acts = [rng.integers(0, 6 if variant == "anomaly" else 5,
                             N_ENVS).astype(np.int32) for _ in range(12)]
    _step_both(cfg_j, st_j, cfg, st, acts)
