"""The port's fleet env variants against the JAX fleet env: Volt-VAR (one
setpoint for the fleet, from the shared PCC voltage) and per-unit MPPT.

Same protocol as tests/test_torch_fleet_env.py: a JAX float64 fleet reset
state with scripted events is carried into the port and both step the same
seeded actions for 60 steps; obs, reward and done agree to 1e-9.
"""
import pytest

from test_torch_fleet_env import step_both


@pytest.mark.parametrize("variant", ["voltvar", "mppt"])
def test_torch_fleet_variants_match_jax(variant):
    kw = {"voltvar": dict(voltvar_enable=True),
          "mppt": dict(mppt_enable=True, n_mppt=3)}[variant]
    step_both(seed=5, **kw)
