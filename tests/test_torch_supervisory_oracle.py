"""The port's single-DER env against the independent supervisory oracle.

`pvderx.oracle.supervisory_np.run_episode_independent` recomputes the whole
supervisory layer (event lookup, ride-through timers, latch and cessation,
MPPT, Volt-VAR, actions, obs, reward, termination) in plain numpy and
integrates each window with LSODA. The twins of the cases of
tests/test_supervisory_oracle.py:57-135: the same configs, reset keys and
actions; each JAX float64 reset state is carried into the port leaf by leaf
(`convert.state_from_numpy`), the episodes of one case stepped as one batch
through `env.core.step` at n_sub=120 in float64. The only difference left is
integrator error: obs and rewards within 1e-6 (the reference test's
bounds), done exactly, the episode ending on the same step. The random
scenarios, the trip episode and continuous actions run here; the features,
three-phase and the unbalanced sag in
`tests/test_torch_supervisory_oracle_variants.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.env import core as jcore
from pvderx.oracle import supervisory_np
from pvderx_torch.convert import state_from_numpy
from pvderx_torch.env import core, make_env_config

TOL_OBS, TOL_REW = 1e-6, 1e-6

TRIP = dict(p_sag=1.0, p_freq=0.0, sag_depth_lo=0.25, sag_depth_hi=0.35,
            sag_t_lo=0.2, sag_t_hi=0.3, sag_dur_lo=1.5, sag_dur_hi=2.0)
UNBALANCED = dict(p_sag=1.0, p_freq=0.0, p_unb=1.0, unb_frac=0.6,
                  sag_depth_lo=0.5, sag_depth_hi=0.7, sag_t_lo=0.2,
                  sag_t_hi=0.3, sag_dur_lo=0.2, sag_dur_hi=0.3)

# case -> (preset, seeds, config keywords): tests/test_supervisory_oracle.py
CASES = {
    "random_scenarios": ("10", range(100, 108), dict(horizon=60)),
    "trip_episode": ("10", [11], dict(horizon=90, scen=TRIP)),
    "voltvar": ("10", [11], dict(horizon=60, voltvar_enable=True)),
    "mppt": ("10", [11], dict(horizon=60, mppt_enable=True)),
    "anomaly": ("10", [11], dict(horizon=60, anomaly_detect=True)),
    "three_phase": ("50", [11], dict(horizon=40)),
    "unbalanced_sag": ("50", [17], dict(horizon=40, scen=UNBALANCED)),
    "continuous_actions": ("10", [11], dict(horizon=40, continuous=True)),
}


def _configs(preset, kw):
    scen = kw.get("scen")
    jkw = dict(kw, **({"scen": jcore.ScenarioConfig(**scen)} if scen else {}))
    pkw = dict(kw, **({"scen": core.ScenarioConfig(**scen)} if scen else {}))
    return (jcore.make_env_config(preset, dtype=jnp.float64, n_sub=120, **jkw),
            make_env_config(preset, dtype=torch.float64, n_sub=120,
                            device="cpu", **pkw))


def _actions(cfg_j, seed):
    """The reference test's actions of an episode (`_compare_episode`)."""
    key = jax.random.PRNGKey(seed + 1)
    if cfg_j.continuous:      # beyond [-1, 1]: the clip path
        return np.asarray(jax.random.uniform(
            key, (cfg_j.horizon, jcore.ACT_DIM_CONT), jnp.float64,
            minval=-1.2, maxval=1.2))
    n_act = jcore.N_ACTIONS_ANOM if cfg_j.anomaly_detect else jcore.N_ACTIONS
    return np.asarray(jax.random.randint(key, (cfg_j.horizon,), 0, n_act))


def check_case(case):
    """The port's episodes of ``case`` against the oracle's."""
    preset, seeds, kw = CASES[case]
    cfg_j, cfg = _configs(preset, kw)
    states = [jcore.reset(cfg_j, jax.random.PRNGKey(s))[0] for s in seeds]
    actions = np.stack([_actions(cfg_j, s) for s in seeds], axis=1)
    want = [supervisory_np.run_episode_independent(cfg_j, st, actions[:, i])
            for i, st in enumerate(states)]
    batch = jax.tree.map(lambda *x: np.stack([np.asarray(v) for v in x]),
                         *states)
    st = state_from_numpy(dataclasses.asdict(batch), cfg)
    steps = max(len(w[0]) for w in want)
    obs, rew, done = [], [], []
    for k in range(steps):
        a = torch.from_numpy(actions[k])
        st, o, r, d, _ = core.step(cfg, st, a if cfg.continuous else a.long())
        obs.append(o.numpy())
        rew.append(r.numpy())
        done.append(d.numpy())
    obs, rew, done = np.stack(obs), np.stack(rew), np.stack(done)
    for i, (obs_o, rew_o, done_o) in enumerate(want):
        t = len(obs_o)
        ends = np.flatnonzero(done[:, i])
        assert ends.size and ends[0] + 1 == t, (
            f"seed {seeds[i]}: episode lengths differ: port "
            f"{ends[:1] + 1}, oracle {t}")
        np.testing.assert_allclose(obs[:t, i], obs_o, rtol=0, atol=TOL_OBS,
                                   err_msg=f"seed {seeds[i]}")
        np.testing.assert_allclose(rew[:t, i], rew_o, rtol=0, atol=TOL_REW,
                                   err_msg=f"seed {seeds[i]}")
        np.testing.assert_array_equal(done[:t, i], done_o)
    if case == "trip_episode":
        assert want[0][2][-1] and len(want[0][0]) < kw["horizon"]


@pytest.mark.parametrize("case", ["random_scenarios", "trip_episode",
                                  "continuous_actions"])
def test_torch_env_episode_matches_independent_oracle(case):
    check_case(case)
