"""The port's Gymnasium adapters (pvderx_torch/env/gym_adapter.py), on the
CPU.

- gymnasium's `check_env` passes on the discrete, continuous and anomaly
  single-DER variants, an implicit-integrator variant, the fleet in
  aggregate and per-unit mode, and the two registered port ids
  (`pvderx_torch/PVDER-v0`, `pvderx_torch/PVDERFleet-v0`); only the
  checker's warnings about the ±inf observation bounds and the render modes
  are allowed, as in tests/test_gym_conformance.py.
- The vector env keeps the SAME_STEP autoreset contract (twin of
  tests/test_gym_conformance.py:65-101), and its row 0 steps as a single
  env given the same reset draw.
- From a JAX float64 state carried over, the single, vector and fleet
  adapters return what the JAX adapters return: obs, reward and info
  <= 1e-9, the same terminated/truncated (and final_obs).
- Without gymnasium the adapters import and step, with no spaces.
- ``strict_init`` raises on a reset residual above the tolerance, whose
  default follows the dtype.
"""
import dataclasses
import pathlib
import subprocess
import sys
import warnings

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from gymnasium.utils.env_checker import check_env

import pvderx.env.gym_adapter as jgym
from pvderx.env import core as jcore
from pvderx_torch._struct import tree_map
from pvderx_torch.convert import fleet_state_from_numpy, state_from_numpy
from pvderx_torch.env.gym_adapter import (
    PVDEREnv, PVDERFleetEnv, PVDERVectorEnv)
from test_torch_env import _schedules

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-9
VARIANTS = [dict(n_sub=40), dict(n_sub=40, continuous=True),
            dict(n_sub=40, anomaly_detect=True),
            dict(n_sub=8, integrator="trapezoid")]


def _check(env):
    with warnings.catch_warnings():
        # ±inf observation bounds are intentional (unbounded measurements);
        # everything else the checker flags is a real failure
        warnings.simplefilter("error")
        warnings.filterwarnings("ignore", message=".*Box observation space.*")
        warnings.filterwarnings("ignore", message=".*render modes.*")
        check_env(env, skip_render_check=False)


@pytest.mark.parametrize("kw", VARIANTS,
                         ids=["discrete", "continuous", "anomaly", "trapezoid"])
def test_torch_gym_check_env_all_variants(kw):
    _check(PVDEREnv("10", device="cpu", **kw))


@pytest.mark.parametrize("per_unit", [False, True],
                         ids=["aggregate", "per_unit"])
def test_torch_gym_check_env_fleet(per_unit):
    env = PVDERFleetEnv("10", m=4, n_sub=40, horizon=12, per_unit=per_unit,
                        device="cpu")
    _check(env)
    obs, info = env.reset(seed=1)
    assert obs.shape == (13 + 16 * per_unit,) and info["init_res"] < 1e-3
    assert env.render().startswith("PVDERFleet(m=4")
    # single-DER-only modes are rejected, not silently ignored
    for kw in (dict(anomaly_detect=True), dict(continuous=True)):
        with pytest.raises(ValueError, match="Discrete.5.-only"):
            PVDERFleetEnv("10", m=4, n_sub=40, device="cpu", **kw)


@pytest.mark.parametrize("env_id,kw", [
    ("pvderx_torch/PVDER-v0", dict(n_sub=40)),
    ("pvderx_torch/PVDERFleet-v0", dict(m=4, n_sub=40, horizon=12)),
])
def test_torch_gym_make_registered_ids(env_id, kw):
    env = gym.make(env_id, device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        check_env(env.unwrapped)
    obs, info = env.reset(seed=3)
    assert obs.shape == (13,) and obs.dtype == np.float32
    env.close()


def test_torch_gym_vector_env_contract():
    """Hand-rolled vector checker: spaces = batch_space(single), obs/reward/
    done shapes and dtypes, seed determinism, SAME_STEP autoreset info."""
    from gymnasium.vector.utils import batch_space

    n = 8
    env = gym.make_vec("pvderx_torch/PVDER-v0", num_envs=n, n_sub=40,
                       horizon=5, device="cpu")
    assert isinstance(env.unwrapped, PVDERVectorEnv)
    assert env.observation_space == batch_space(env.single_observation_space, n)
    assert env.action_space == batch_space(env.single_action_space, n)

    obs1, info1 = env.reset(seed=123)
    obs2, _ = env.reset(seed=123)
    np.testing.assert_array_equal(obs1, obs2)  # seed determinism
    assert obs1.shape == (n, env.single_observation_space.shape[0])
    assert obs1 in env.observation_space
    assert np.all(info1["init_res"] < 1e-3)

    rng = np.random.default_rng(0)
    done_seen = False
    for _ in range(6):  # horizon 5 -> guaranteed truncation
        acts = rng.integers(0, env.single_action_space.n, size=n)
        obs, rew, term, trunc, info = env.step(acts)
        assert obs in env.observation_space
        assert obs.dtype == np.float32 and rew.shape == (n,)
        assert term.shape == (n,) and trunc.shape == (n,)
        done = np.logical_or(term, trunc)
        if np.any(done):
            done_seen = True
            # SAME_STEP autoreset: obs is already the reset obs; the
            # pre-reset observation rides in info["final_obs"]
            assert "final_obs" in info and "_final_obs" in info
            assert info["final_obs"].shape == obs.shape
            np.testing.assert_array_equal(info["_final_obs"], done)
            assert not np.allclose(info["final_obs"][done], obs[done])
            np.testing.assert_array_equal(obs[done], obs1[done])
        else:
            assert "final_obs" not in info
    assert done_seen
    env.close()


def test_torch_gym_vector_row0_matches_single_env():
    """Row 0 of the vector env, carried into a single env (the same reset
    draw), steps the same; and a one-env vector env resets as the single
    env from the same seed."""
    cfg_kw = dict(n_sub=40, horizon=16, device="cpu")
    venv = PVDERVectorEnv(num_envs=4, preset="10", **cfg_kw)
    senv = PVDEREnv("10", **cfg_kw)
    venv.reset(seed=5)
    senv.reset(seed=5)
    senv._state = tree_map(lambda x: x[0:1], venv._state)
    for a in (0, 1, 3, 2):
        vo, vr, _, _, _ = venv.step(np.full(4, a))
        so, sr, _, _, _ = senv.step(a)
        np.testing.assert_allclose(so, vo[0], rtol=0, atol=2e-5)
        np.testing.assert_allclose(sr, vr[0], rtol=0, atol=2e-5)
    one = PVDERVectorEnv(num_envs=1, preset="10", **cfg_kw)
    np.testing.assert_array_equal(one.reset(seed=9)[0][0],
                                  senv.reset(seed=9)[0])


def _carry(tree, cfg, convert, batched=False):
    d = dataclasses.asdict(jax.tree.map(
        lambda x: np.asarray(x) if batched else np.asarray(x)[None], tree))
    return convert(d, cfg)


def _compare(got, want, what):
    obs, rew, term, trunc, info = got
    obs_j, rew_j, term_j, trunc_j, info_j = want
    np.testing.assert_allclose(obs, obs_j, rtol=0, atol=TOL, err_msg=what)
    np.testing.assert_allclose(rew, rew_j, rtol=0, atol=TOL, err_msg=what)
    np.testing.assert_array_equal(term, term_j)
    np.testing.assert_array_equal(trunc, trunc_j)
    assert set(info) == set(info_j), what
    for k in info:
        if np.asarray(info[k]).dtype == bool:
            np.testing.assert_array_equal(info[k], info_j[k])
        else:
            np.testing.assert_allclose(info[k], info_j[k], rtol=0, atol=TOL,
                                       err_msg=f"{what} info[{k}]")


def test_torch_gym_single_env_step_matches_jax_adapter():
    """20 steps at n_sub=40 from a JAX float64 reset state on a scripted sag
    (cessation inside the steps run)."""
    jenv = jgym.PVDEREnv("10", n_sub=40, dtype=jnp.float64)
    jenv.reset(seed=0)
    sched = {k: jnp.asarray(v[0]) for k, v in _schedules().items()}
    jenv._state = dataclasses.replace(jenv._state,
                                      sched=jcore.EventSchedule(**sched))
    env = PVDEREnv("10", n_sub=40, dtype=torch.float64, device="cpu")
    env.reset(seed=0)
    env._state = _carry(jenv._state, env.cfg, state_from_numpy)
    ces = False
    for k in range(20):
        a = (k * 3) % 5
        got, want = env.step(a), jenv.step(a)
        _compare(got, want, f"step {k}")
        ces |= bool(env._state.rt.ces[0] > 0)
    assert ces and env.render() == jenv.render()


def test_torch_gym_vector_env_step_matches_jax_adapter():
    """A horizon-4 episode of 4 envs from a JAX float64 state: every step,
    and at the done step final_obs, equal the JAX adapter's (the restarted
    episodes' events are new draws, so the comparison stops there)."""
    jenv = jgym.PVDERVectorEnv(4, "10", n_sub=40, horizon=4,
                               dtype=jnp.float64, window="scan")
    jenv.reset(seed=0)
    jenv._state = dataclasses.replace(jenv._state, sched=jcore.EventSchedule(
        **{k: jnp.asarray(v) for k, v in _schedules().items()}))
    env = PVDERVectorEnv(4, "10", n_sub=40, horizon=4, dtype=torch.float64,
                         device="cpu")
    env.reset(seed=0)
    env._state = _carry(jenv._state, env.cfg, state_from_numpy, batched=True)
    for k in range(4):
        a = (np.arange(4) + k) % 5
        got, want = env.step(a), jenv.step(a)
        _compare(got, want, f"step {k}")
    assert "final_obs" in got[4]


@pytest.mark.parametrize("per_unit", [False, True],
                         ids=["aggregate", "per_unit"])
def test_torch_gym_fleet_env_step_matches_jax_adapter(per_unit):
    m = 3
    jenv = jgym.PVDERFleetEnv("10", m=m, n_sub=40, per_unit=per_unit,
                              dtype=jnp.float64)
    jenv.reset(seed=0)
    sched = {k: jnp.asarray(v[0]) for k, v in _schedules().items()}
    jenv._state = dataclasses.replace(jenv._state,
                                      sched=jcore.EventSchedule(**sched))
    env = PVDERFleetEnv("10", m=m, n_sub=40, per_unit=per_unit,
                        dtype=torch.float64, device="cpu")
    env.reset(seed=0)
    env._state = _carry(jenv._state, env.fc, fleet_state_from_numpy)
    rng = np.random.default_rng(2)
    for k in range(20):
        a = rng.integers(0, 5, m) if per_unit else int(rng.integers(0, 5))
        _compare(env.step(a), jenv.step(a), f"step {k}")
    assert env.render() == jenv.render()


def test_torch_gym_strict_init_and_dtype_tolerance():
    assert PVDEREnv("10", n_sub=40, device="cpu").init_res_tol == 1e-3
    env = PVDEREnv("10", n_sub=40, dtype=torch.float64, device="cpu",
                   strict_init=True)
    assert env.init_res_tol == 1e-6
    _, info = env.reset(seed=0)
    assert info["init_res"] <= 1e-6
    tight = PVDEREnv("10", n_sub=40, dtype=torch.float64, device="cpu",
                     strict_init=True, init_res_tol=0.0)
    with pytest.raises(RuntimeError, match="steady-state init failed"):
        tight.reset(seed=0)


def test_torch_gym_adapters_work_without_gymnasium():
    """In an interpreter where gymnasium cannot be imported, the package
    registers nothing and the adapters reset and step (no spaces)."""
    code = (
        "import sys\n"
        "sys.modules['gymnasium'] = None\n"
        "import numpy as np\n"
        "import pvderx_torch\n"
        "from pvderx_torch.env import gym_adapter as ga\n"
        "assert not ga._HAS_GYM\n"
        "e = ga.PVDEREnv('10', n_sub=40, horizon=3, device='cpu')\n"
        "assert not hasattr(e, 'action_space')\n"
        "o, i = e.reset(seed=1)\n"
        "o, r, te, tr, info = e.step(1)\n"
        "assert o.shape == (13,) and not te and not tr\n"
        "v = ga.PVDERVectorEnv(2, n_sub=40, horizon=2, device='cpu')\n"
        "v.reset(seed=1)\n"
        "for _ in range(2):\n"
        "    o, r, te, tr, info = v.step(np.zeros(2, np.int64))\n"
        "assert tr.all() and info['_final_obs'].all()\n"
        "f = ga.PVDERFleetEnv('10', m=2, n_sub=40, per_unit=True, "
        "device='cpu')\n"
        "f.reset(seed=1)\n"
        "o, r, te, tr, info = f.step(np.array([1, 2]))\n"
        "assert o.shape == (13 + 8,)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
