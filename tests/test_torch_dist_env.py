"""The env paths of `pvderx_torch.dist` on W gloo ranks of the CPU.

The ranks start through `python -m pvderx_torch.dist.launch --cpu` (one
intra-op thread each) and run `tests/torch_dist_cases.py`:

- the env step over a mesh of 2 and of 4 env ranks, each rank stepping its
  own rows from slices of this process's one-rank reset with the one-rank
  generator state, equals the one-rank rollout bit for bit (obs, reward,
  done and the final state): the single-DER env in float64 and float32
  (12 steps over a horizon of 8, random actions drawn at the global shape,
  so autoreset draws fire), the fleet at M = 4 (6 steps, horizon 4), the
  df32 tier (3 steps, horizon 2; hi and lo), and the implicit schemes
  (`ode.implicit`, which the CPU runs over the batch padded as the plain
  windows pad theirs): the trapezoidal and backward-Euler env in float64
  (n_sub 4, 6 steps, horizon 4) and the trapezoidal fleet at M = 2
  (n_sub 2, 4 steps, horizon 3);
- a reset under the mesh equals the slice of the one-rank reset (the CPU's
  batched solve is per matrix);
- `process_env_slice` is the reference's formula (`pvderx.dist.multihost`,
  its process index and count set to the rank's); `make_global_array`
  takes each rank's rows (a shard of another size raises) and
  `process_allgather` gives the whole batch back on every rank;
- the Gymnasium adapters under the mesh: `PVDERVectorEnv` of 8 global
  envs steps each rank's 4 (its ``num_envs``) as the one-rank adapter
  steps them (observations, rewards and SAME_STEP final_obs bit for bit,
  over a horizon of 4 and 6 random steps), `PVDERFleetEnv` runs rank r's
  episode of a global batch of W (its reset and step equal row r of the
  one-rank fleet env's), and `check_env` passes on each rank;
- a global batch the env axis does not divide raises ``ValueError`` naming
  the divisibility, for the env, fleet and df32 resets and `shard_batch`,
  and a DQN or SAC replay whose capacity rollout_len·n_envs does not divide
  raises at `init_runner` under W = 2 ranks.
"""
import os
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

import torch_dist_cases as cases  # noqa: E402

KINDS = ("env_f64", "env_f32", "fleet", "df32", "trapezoid", "backward_euler",
         "fleet_trapezoid")


def run_ranks(workdir, nproc, names, timeout=240):
    """The cases on ``nproc`` gloo ranks; {case: [rank results]}."""
    from pvderx_torch.dist.launch import launch

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")]))
    rc = launch("torch_dist_cases", [str(workdir), *names], nproc=nproc,
                cpu=True, timeout=timeout, env=env)
    assert rc == 0, f"ranks failed (rc {rc})"
    return {c: [torch.load(workdir / f"{c}-rank{r}.pt", weights_only=False)
                for r in range(nproc)] for c in names}


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """The one-rank reset and rollout of each env kind; the reset saved
    for the ranks."""
    workdir = tmp_path_factory.mktemp("dist_env")
    out = {}
    for kind in KINDS:
        state, obs, _ = cases.env_reset(kind)
        gen = torch.Generator().manual_seed(5)
        torch.save({"state": state, "obs": obs, "gen": gen.get_state()},
                   workdir / f"{kind}-input.pt")
        st = state[0] if kind == "df32" else state
        out[kind] = dict(cases.env_run(kind, state, obs, gen), reset_y=st.y,
                         reset_obs=obs)
    return workdir, out


@pytest.fixture(scope="module")
def ranks(world1):
    workdir, _ = world1
    return {2: run_ranks(workdir, 2, ["slice", *KINDS, "errors", "gym"]),
            4: run_ranks(workdir, 4, ["slice", *KINDS])}


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_torch_dist_env_step_is_bitwise_the_one_rank_step(world1, ranks, kind,
                                                          w):
    want = world1[1][kind]
    assert want["dones"].any(), "the horizon must end within the rollout"
    for r, got in enumerate(ranks[w][kind]):
        sl = slice(r * cases.N // w, (r + 1) * cases.N // w)
        for k in ("obs", "y", "y_lo"):
            if k in want:
                assert torch.equal(got[k], want[k][sl]), (kind, w, r, k)
        for k in ("rews", "dones"):
            assert torch.equal(got[k], want[k][:, sl]), (kind, w, r, k)


@pytest.mark.parametrize("w", [2, 4])
def test_torch_dist_env_reset_under_a_mesh_is_the_slice(world1, ranks, w):
    for kind in KINDS:
        want = world1[1][kind]
        for r, got in enumerate(ranks[w][kind]):
            sl = slice(r * cases.N // w, (r + 1) * cases.N // w)
            assert torch.equal(got["reset_y"], want["reset_y"][sl]), kind
            assert torch.equal(got["reset_obs"], want["reset_obs"][sl]), kind


@pytest.mark.parametrize("w", [2, 4])
def test_torch_dist_process_env_slice_is_the_references_formula(
        ranks, monkeypatch, w):
    import jax

    from pvderx.dist import multihost as j_multihost

    for r, got in enumerate(ranks[w]["slice"]):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: w)
        assert got["slice"] == j_multihost.process_env_slice(64)
        assert got["rows"] == slice(r * cases.N // w, (r + 1) * cases.N // w)
        assert got["world"] == w
        whole = torch.arange(cases.N * 3.0).reshape(cases.N, 3)
        assert torch.equal(got["gathered"], whole)
        assert torch.equal(got["gathered_world"], whole)
        assert "rank shard has 16 rows" in got["bad_shard"]


def test_torch_dist_gym_adapters_step_this_ranks_rows(ranks):
    import numpy as np

    from pvderx_torch.env import fleet

    want = cases.gym_run()
    fc = fleet.make_fleet_config("10", m=3, n_sub=40, device="cpu")
    st, fobs = fleet.reset(fc, 2, torch.Generator().manual_seed(4))
    _, fobs1, frew, *_ = fleet.step(fc, st, torch.full((2,), 2))
    for r, got in enumerate(ranks[2]["gym"]):
        sl = slice(4 * r, 4 * r + 4)
        assert got["num_envs"] == 4 and got["check_env"]
        for a, b in zip(got["vec_obs"], want["vec_obs"]):
            np.testing.assert_array_equal(a, b[sl])
        for a, b in zip(got["vec_rew"], want["vec_rew"]):
            np.testing.assert_array_equal(a, b[sl])
        assert any(f is not None for f in want["final"])
        for a, b in zip(got["final"], want["final"]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b[sl])
        np.testing.assert_array_equal(got["fleet_obs"][0],
                                      fobs[r].numpy().astype(np.float32))
        np.testing.assert_array_equal(got["fleet_obs"][1],
                                      fobs1[r].numpy().astype(np.float32))
        assert got["fleet_rew"] == float(frew[r])


@pytest.mark.parametrize("what", ["env", "fleet", "df32", "shard"])
def test_torch_dist_non_divisible_batch_raises(ranks, what):
    for got in ranks[2]["errors"]:
        msg = got[what]
        assert msg is not None and "not divisible" in msg, msg
        assert "N=17" in msg and "size 2" in msg, msg


@pytest.mark.parametrize("learner", ["dqn", "sac"])
def test_torch_dist_replay_capacity_must_divide(ranks, learner):
    for got in ranks[2]["errors"]:
        msg = got[f"{learner}_capacity"]
        assert msg is not None and "capacity=96" in msg and "64" in msg, msg


def test_torch_dist_shard_batch_gives_contiguous_rows():
    """The env fields a rank keeps are contiguous (the kernels take no
    other), also where the env axis is not the leading one (the params
    pack [29, N])."""
    from pvderx_torch.dist import Mesh, shard_batch

    mesh = Mesh(axis_names=("env",), sizes=(2,), coords=(1,), groups=(None,),
                device=torch.device("cpu"), backend="gloo")
    pack = torch.arange(29 * 8.0).reshape(29, 8)
    got = shard_batch(pack, mesh, axis=1)
    assert got.is_contiguous() and torch.equal(got, pack[:, 4:])
    st = shard_batch({"y": torch.arange(16.0).reshape(8, 2),
                      "k": torch.tensor(3)}, mesh)
    assert torch.equal(st["y"], torch.arange(8.0, 16.0).reshape(4, 2))
    assert st["k"].dim() == 0


def test_torch_dist_launch_returns_a_failing_ranks_code(tmp_path):
    """The launcher returns the first non-zero code and stops the others."""
    from pvderx_torch.dist.launch import main

    assert main(["--nproc", "2", "--cpu", "--timeout", "60", "-m",
                 "pvderx_torch.dist._no_such_module"]) != 0
