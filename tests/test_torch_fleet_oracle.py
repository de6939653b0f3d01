"""A port fleet episode against the independent supervisory oracle.

`pvderx.oracle.supervisory_np.run_fleet_episode_independent` recomputes the
fleet's whole supervisory layer (event lookup, per-unit ride-through on the
common PCC voltage, setpoints, aggregate obs, fleet-mean reward,
termination) in plain numpy and integrates each window of the coupled
feeder with LSODA. The port steps the same JAX reset state (carried over
leaf by leaf) through its plain fleet window at n_sub=120 in float64; the
only difference left is integrator error, so obs and rewards agree to 1e-6
as in tests/test_supervisory_oracle.py, and done exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.env import fleet as jfleet
from pvderx.oracle import supervisory_np
from pvderx_torch.convert import fleet_state_from_numpy
from pvderx_torch.env import fleet, make_fleet_config

TOL_OBS, TOL_REW = 1e-6, 1e-6


@pytest.mark.parametrize("per_unit", [False, True], ids=["aggregate", "per_unit"])
def test_torch_fleet_episode_matches_independent_oracle(per_unit):
    m, horizon = 2, 16
    kw = dict(m=m, per_unit=per_unit, n_sub=120, horizon=horizon)
    fcj = jfleet.make_fleet_config("10", dtype=jnp.float64, **kw)
    st_j, _ = jax.vmap(lambda k: jfleet.reset(fcj, k))(
        jax.random.split(jax.random.PRNGKey(5), 1))
    fc = make_fleet_config("10", dtype=torch.float64, device="cpu", **kw)
    st = fleet_state_from_numpy(
        dataclasses.asdict(jax.tree.map(np.asarray, st_j)), fc)
    rng = np.random.default_rng(6)
    actions = rng.integers(0, 5, (horizon, m) if per_unit else (horizon,))
    obs_o, rew_o, done_o = supervisory_np.run_fleet_episode_independent(
        fcj, jax.tree.map(lambda x: x[0], st_j), actions)
    obs_l, rew_l, done_l = [], [], []
    for a in actions:
        st, ob, r, d, _ = fleet.step(fc, st, torch.as_tensor(a)[None])
        obs_l.append(ob[0].numpy())
        rew_l.append(float(r[0]))
        done_l.append(bool(d[0]))
        if done_l[-1]:
            break
    assert len(obs_l) == len(obs_o)
    np.testing.assert_allclose(np.stack(obs_l), obs_o, rtol=0, atol=TOL_OBS)
    np.testing.assert_allclose(np.asarray(rew_l), rew_o, rtol=0, atol=TOL_REW)
    np.testing.assert_array_equal(np.asarray(done_l), done_o)
