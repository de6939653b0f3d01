"""Rank-side cases of the `tests/test_torch_dist_*.py` files (torch only).

Started as W ranks on the CPU by the tests:

    python -m pvderx_torch.dist.launch --nproc W --cpu -m torch_dist_cases \\
        WORKDIR CASE [CASE ...]

(with ``tests/`` on the path). Each rank joins the gloo group, runs the
cases in order and writes each case's results to
``WORKDIR/CASE-rank{r}.pt``; a case reads what the test left in
``WORKDIR/CASE-input.pt``, if anything. Expected errors are caught and
written as their messages, so no rank is left waiting in a collective.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import torch

torch.set_num_threads(1)

from pvderx_torch import dist as D  # noqa: E402
from pvderx_torch.diag import checkpoint  # noqa: E402
from pvderx_torch.dist.mesh import draw_rows  # noqa: E402
from pvderx_torch.dist.tp import (  # noqa: E402
    MODEL_AXIS, gather_param, make_mesh_2d, shard_params_tp, shard_runner_tp)
from pvderx_torch.env import (  # noqa: E402
    core, fleet, make_batch_fns, make_batch_fns_df, make_env_config,
    make_fleet_batch_fns, make_fleet_config, rollout, rollout_df)
from pvderx_torch.learn import (  # noqa: E402
    DQNConfig, PPOConfig, SACConfig, make_dqn, make_ppo, make_sac)

N = 16


# ---------------------------------------------------------------------------
# the configurations the tests and the ranks share
# ---------------------------------------------------------------------------
def env_cfg(kind: str):
    """(config, steps) of an env case."""
    if kind == "env_f64":
        return make_env_config("10", dtype=torch.float64, n_sub=40,
                               horizon=8, device="cpu"), 12
    if kind == "env_f32":
        return make_env_config("10", dtype=torch.float32, n_sub=40,
                               horizon=8, device="cpu"), 12
    if kind == "fleet":
        return make_fleet_config("10", m=4, dtype=torch.float64, n_sub=40,
                                 horizon=4, device="cpu"), 6
    if kind == "df32":
        return make_env_config("10", dtype=torch.float32, n_sub=40,
                               horizon=2, device="cpu"), 3
    if kind in ("trapezoid", "backward_euler"):
        return make_env_config("10", dtype=torch.float64, n_sub=4,
                               horizon=4, integrator=kind, device="cpu"), 6
    if kind == "fleet_trapezoid":
        return make_fleet_config("10", m=2, dtype=torch.float64, n_sub=2,
                                 horizon=3, integrator="trapezoid",
                                 device="cpu"), 4
    raise KeyError(kind)


def random_policy(mesh):
    """Actions drawn at the global shape (the rank keeps its rows)."""
    return lambda obs, g: draw_rows(mesh, lambda s: torch.randint(
        0, core.N_ACTIONS, s, generator=g), (obs.shape[0],))


def env_run(kind: str, state, obs, gen, mesh=None):
    """The env case's rollout (from ``state``, ``obs``) under ``mesh``:
    {obs, rews, dones, y} of the final state and every step."""
    cfg, steps = env_cfg(kind)
    pol = random_policy(mesh)
    if kind.startswith("fleet"):
        st, ob, r, d = fleet.fleet_rollout(cfg, state, obs, pol, steps, gen,
                                           mesh)
        return dict(obs=ob, rews=r, dones=d, y=st.y)
    if kind == "df32":
        (st, lo), ob, r, d = rollout_df(cfg, state, obs, pol, steps, gen,
                                        mesh)
        return dict(obs=ob, rews=r, dones=d, y=st.y, y_lo=lo)
    st, ob, r, d = rollout(cfg, state, obs, pol, steps, gen, mesh)
    return dict(obs=ob, rews=r, dones=d, y=st.y)


def env_reset(kind: str, mesh=None, seed: int = 0):
    """(state, obs, generator) of the env case's reset under ``mesh``."""
    cfg, _ = env_cfg(kind)
    gen = torch.Generator().manual_seed(seed)
    fns = {"fleet": make_fleet_batch_fns, "fleet_trapezoid":
           make_fleet_batch_fns, "df32": make_batch_fns_df}.get(
        kind, make_batch_fns)
    state, obs = fns(cfg, mesh=mesh)[0](N, gen)
    return state, obs, gen


def learner(name: str, mesh=None, hidden=(32, 32)):
    """(init_runner, train_step) of a learner case."""
    cfg = make_env_config("10", dtype=torch.float32, n_sub=40, horizon=8,
                          device="cpu", continuous=name == "sac")
    if name == "ppo":
        return make_ppo(cfg, PPOConfig(rollout_len=4, n_epochs=2,
                                       n_minibatch=2), hidden, mesh=mesh)[:2]
    if name == "fleet_ppo":
        fc = make_fleet_config("10", m=4, per_unit=True, n_sub=40, horizon=4,
                               device="cpu")
        return make_ppo(fc, PPOConfig(rollout_len=2, n_epochs=1,
                                      n_minibatch=2), hidden, mesh=mesh)[:2]
    if name == "dqn":
        return make_dqn(cfg, DQNConfig(rollout_len=4, n_updates=2,
                                       batch_size=16, capacity=128,
                                       target_every=2), hidden,
                        mesh=mesh)[:2]
    if name == "sac":
        return make_sac(cfg, SACConfig(rollout_len=4, n_updates=2,
                                       batch_size=16, capacity=128), hidden,
                        mesh=mesh)[:2]
    raise KeyError(name)


def learner_params(runner) -> list:
    """Every learned tensor of a runner, in a fixed order."""
    mods = [getattr(runner, k) for k in ("net", "net_tgt", "actor", "critic",
                                         "critic_tgt") if hasattr(runner, k)]
    out = [p.detach().clone() for m in mods for p in m.parameters()]
    if hasattr(runner, "log_alpha"):
        out.append(runner.log_alpha.detach().clone())
    return out


def tp_setup(seed=0, hidden=(128, 128)):
    """The TP cases' PPO (test_tp.py's: rollout 4, one epoch of two
    minibatches, hidden 128²) and a whole runner of 16 envs."""
    cfg = make_env_config("10", dtype=torch.float32, n_sub=40, horizon=8,
                          device="cpu")
    ppo = PPOConfig(rollout_len=4, n_epochs=1, n_minibatch=2)
    init, ts, make_net = make_ppo(cfg, ppo, hidden)
    return cfg, ppo, init(N, torch.Generator().manual_seed(seed)), ts


# ---------------------------------------------------------------------------
# the cases (each returns what the rank writes)
# ---------------------------------------------------------------------------
def case_slice(workdir, mesh):
    """This rank's slice; a global array assembled from its rows and
    gathered back whole; a shard of the wrong size refused."""
    rows = mesh.rows(N)
    local = D.make_global_array(torch.arange(N * 3.0).reshape(N, 3)[rows],
                                mesh, N)
    D.sync_hosts("slice")
    return {"slice": D.process_env_slice(64), "rows": rows,
            "world": torch.distributed.get_world_size(),
            "gathered": D.process_allgather(local, mesh),
            "gathered_world": D.process_allgather(local),
            "bad_shard": _raises(lambda: D.make_global_array(
                torch.zeros(N, 3), mesh, N))}


def _env_case(kind, workdir, mesh):
    inp = torch.load(os.path.join(workdir, f"{kind}-input.pt"),
                     weights_only=False)
    gen = torch.Generator()
    gen.set_state(inp["gen"])
    state = D.shard_batch(inp["state"], mesh)
    out = env_run(kind, state, D.shard_batch(inp["obs"], mesh), gen, mesh)
    st_r, obs_r, _ = env_reset(kind, mesh)
    y_r = (st_r[0] if kind == "df32" else st_r).y
    out.update(reset_y=y_r, reset_obs=obs_r)
    return out


def case_env_f64(workdir, mesh):
    return _env_case("env_f64", workdir, mesh)


def case_env_f32(workdir, mesh):
    return _env_case("env_f32", workdir, mesh)


def case_fleet(workdir, mesh):
    return _env_case("fleet", workdir, mesh)


def case_df32(workdir, mesh):
    return _env_case("df32", workdir, mesh)


def case_trapezoid(workdir, mesh):
    return _env_case("trapezoid", workdir, mesh)


def case_backward_euler(workdir, mesh):
    return _env_case("backward_euler", workdir, mesh)


def case_fleet_trapezoid(workdir, mesh):
    return _env_case("fleet_trapezoid", workdir, mesh)


def gym_run(mesh=None, n=8, steps=6):
    """`PVDERVectorEnv` (n envs, horizon 4: SAME_STEP autoreset fires) and
    `PVDERFleetEnv` (M = 3, this rank's episode of a global batch of W)
    under ``mesh``: their observations, rewards and final_obs."""
    import numpy as np

    from pvderx_torch.env.gym_adapter import PVDERFleetEnv, PVDERVectorEnv

    venv = PVDERVectorEnv(n, seed=3, n_sub=40, horizon=4, device="cpu",
                          mesh=mesh)
    obs, _ = venv.reset()
    out = {"vec_obs": [obs], "vec_rew": [], "final": []}
    rng = np.random.default_rng(0)
    for _ in range(steps):
        acts = rng.integers(0, 5, n)
        if mesh is not None:
            sl = mesh.rows(n)
            acts = acts[sl]
        obs, rew, term, trunc, info = venv.step(acts)
        out["vec_obs"].append(obs)
        out["vec_rew"].append(rew)
        out["final"].append(info.get("final_obs"))
    fenv = PVDERFleetEnv(m=3, seed=4, n_sub=40, device="cpu", mesh=mesh)
    fobs, _ = fenv.reset()
    fobs1, frew, *_ = fenv.step(2)
    out.update(num_envs=venv.num_envs, fleet_obs=[fobs, fobs1],
               fleet_rew=frew)
    return out


def case_gym(workdir, mesh):
    """The adapters under the mesh, and `check_env` of the fleet adapter
    on this rank."""
    from gymnasium.utils.env_checker import check_env

    from pvderx_torch.env.gym_adapter import PVDERFleetEnv

    out = gym_run(mesh)
    check_env(PVDERFleetEnv(m=2, n_sub=40, device="cpu", mesh=mesh),
              skip_render_check=True)
    out["check_env"] = True
    return out


def _raises(fn) -> str | None:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def case_errors(workdir, mesh):
    """Non-divisible global batches and a replay that cannot shard."""
    gen = torch.Generator().manual_seed(0)
    cfg, _ = env_cfg("env_f64")
    fc, _ = env_cfg("fleet")
    cfg32, _ = env_cfg("df32")
    odd = N + 1
    out = {
        "env": _raises(lambda: make_batch_fns(cfg, mesh)[0](odd, gen)),
        "fleet": _raises(lambda: make_fleet_batch_fns(fc, mesh)[0](odd,
                                                                   gen)),
        "df32": _raises(lambda: make_batch_fns_df(cfg32, mesh)[0](odd, gen)),
        "shard": _raises(lambda: D.shard_batch(torch.zeros(odd, 3), mesh)),
    }
    cfg_c = dataclasses.replace(cfg, continuous=True)
    for name, make, lcfg, c in (
            ("dqn_capacity", make_dqn, DQNConfig(rollout_len=4, capacity=96),
             cfg), ("sac_capacity", make_sac,
                    SACConfig(rollout_len=4, capacity=96), cfg_c)):
        init = make(c, lcfg, (16, 16), mesh=mesh)[0]
        out[name] = _raises(lambda: init(N, torch.Generator()))
    return out


def _learner_case(name, mesh, steps=2):
    init1, _ = learner(name)
    _, tsw = learner(name, mesh)
    runner = D.shard_runner(init1(N, torch.Generator().manual_seed(0)), mesh)
    for _ in range(steps):
        runner, metrics = tsw(runner)
    return {"params": learner_params(runner),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "obs": runner.obs}


def case_ppo(workdir, mesh):
    return _learner_case("ppo", mesh)


def case_fleet_ppo(workdir, mesh):
    return _learner_case("fleet_ppo", mesh)


def case_dqn(workdir, mesh):
    return _learner_case("dqn", mesh)


def case_sac(workdir, mesh):
    return _learner_case("sac", mesh)


def case_init(workdir, mesh):
    """A runner built under the mesh from one seed: the generator is
    replicated from rank 0, so ranks seeded apart still agree."""
    init, ts = learner("ppo", mesh)
    rank = torch.distributed.get_rank()
    runner = init(N, torch.Generator().manual_seed(0 if rank == 0 else 99))
    runner, m = ts(runner)
    return {"params": learner_params(runner), "obs": runner.obs,
            "metrics": {k: float(v) for k, v in m.items()}}


def case_checkpoint(workdir, mesh):
    """A world-W PPO runner saved, restored into one built from another
    seed, both trained on: bitwise equal."""
    init, ts = learner("ppo", mesh)
    runner, _ = ts(init(N, torch.Generator().manual_seed(1)))
    path = checkpoint.save(os.path.join(workdir, "ckpt"), runner, mesh)
    restored = checkpoint.restore(path, init(N, torch.Generator()
                                             .manual_seed(2)), mesh)
    out = {"same_before": _bitwise(runner, restored),
           "files": sorted(os.listdir(path))}
    for _ in range(2):
        runner, m1 = ts(runner)
        restored, m2 = ts(restored)
    out["same_after"] = _bitwise(runner, restored)
    out["loss"] = (float(m1["loss"]), float(m2["loss"]))
    return out


def _bitwise(a, b) -> bool:
    pa, pb = checkpoint.plain(a), checkpoint.plain(b)
    def eq(x, y):
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(eq(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(map(eq, x, y))
        return x == y
    return eq(pa, pb)


def case_ppo_twin(workdir, mesh):
    """PPO of the reference twin (tests/test_torch_learn_ppo.py's single-DER
    anomaly case): the test's JAX init carried over, greedy actions."""
    from pvderx_torch import convert
    from pvderx_torch.learn import ppo as ppo_mod
    from pvderx_torch.learn.env_api import pack_params

    inp = torch.load(os.path.join(workdir, "ppo_twin-input.pt"),
                     weights_only=False)
    cfg = make_env_config("10", dtype=torch.float64, n_sub=40, horizon=50,
                          device="cpu", anomaly_detect=True)
    init, ts, _ = make_ppo(cfg, PPOConfig(**inp["ppo"]), hidden=(32, 32),
                           dtype=torch.float64, mesh=mesh)
    ppo_mod._categorical = lambda logits, g, mesh=None: torch.argmax(
        logits, dim=-1)
    runner = init(inp["n"], torch.Generator().manual_seed(0))
    runner.net.load_state_dict(convert.flax_state_dict(runner.net,
                                                       inp["params"]))
    st = D.shard_batch(convert.state_from_numpy(inp["env_state"], cfg), mesh)
    runner = dataclasses.replace(
        runner, env_state=st, p_pack=pack_params(st),
        obs=D.shard_batch(torch.tensor(inp["obs"]), mesh))
    metrics = []
    for _ in range(2):
        runner, m = ts(runner)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"state_dict": runner.net.state_dict(), "metrics": metrics,
            "obs": runner.obs, "update_i": runner.update_i}


# -- tensor parallelism -----------------------------------------------------
def _tp_mesh(mesh):
    w = torch.distributed.get_world_size()
    return make_mesh_2d(w // 2, 2, device="cpu")


def case_tp(workdir, mesh):
    """One PPO train step on the (W/2, 2) mesh from test_tp.py's runner:
    the loss and the whole params (gathered), Dense_0's and its Adam
    moment's shard shapes."""
    mesh2 = _tp_mesh(mesh)
    cfg, ppo, runner, _ = tp_setup()
    _, ts2, _ = make_ppo(cfg, ppo, (128, 128), mesh=mesh2)
    r2 = shard_runner_tp(runner, mesh2)
    shapes = {"dense0": tuple(r2.net.trunk[0].weight.shape)}
    r2, m2 = ts2(r2)
    full = [gather_param(p.detach(), p, mesh2) for p in r2.net.parameters()]
    shapes["mu0"] = tuple(
        r2.opt.state[r2.net.trunk[0].weight]["exp_avg"].shape)
    return {"loss": float(m2["loss"]), "params": full, "shapes": shapes,
            "coords": mesh2.coords}


def case_tp_moments(workdir, mesh):
    """shard_runner_tp of a trained runner keeps the Adam moments: this
    rank's shard of each, and the step counts."""
    mesh2 = _tp_mesh(mesh)
    _, _, runner, ts = tp_setup(seed=1)
    trained, _ = ts(runner)
    whole = {k: {n: v.clone() if isinstance(v, torch.Tensor) else v
                 for n, v in st.items()}
             for k, st in enumerate(trained.opt.state.values())}
    placed = shard_runner_tp(trained, mesh2)
    local = {k: dict(st) for k, st in enumerate(placed.opt.state.values())}
    return {"whole": whole, "local": local, "coords": mesh2.coords,
            "shards": [getattr(p, "tp_shard", None)
                       for p in placed.net.parameters()]}


def case_tp_grad(workdir, mesh):
    """The gradient of a scalar of each net's outputs, through the TP
    forward on the (W/2, 2) mesh: the whole gradient (gathered)."""
    from pvderx_torch.learn import (
        ActorCritic, DoubleCritic, QNetwork, TanhGaussianActor)

    mesh2 = _tp_mesh(mesh)
    x = torch.randn(6, 13, generator=torch.Generator().manual_seed(3))
    act = torch.randn(6, 2, generator=torch.Generator().manual_seed(4))
    out = {}
    for name, make, fwd in (
            ("ActorCritic", lambda g: ActorCritic(13, 80, generator=g),
             lambda n: n(x)),
            ("QNetwork", lambda g: QNetwork(13, 5, generator=g),
             lambda n: (n(x),)),
            ("TanhGaussianActor",
             lambda g: TanhGaussianActor(13, 2, generator=g), lambda n: n(x)),
            ("DoubleCritic", lambda g: DoubleCritic(13, 2, generator=g),
             lambda n: n(x, act))):
        net = make(torch.Generator().manual_seed(5))
        shard_params_tp(net, mesh2)
        outs = fwd(net)
        loss = sum((o * torch.linspace(-1, 1, o.numel()).reshape(o.shape))
                   .sum() for o in outs)
        grads = torch.autograd.grad(loss, list(net.parameters()))
        out[name] = {"loss": float(loss.detach()),
                     "grads": [gather_param(g, p, mesh2) for g, p in
                               zip(grads, net.parameters())]}
    return out


def case_tp_checkpoint(workdir, mesh):
    """A DP checkpoint (env axis 2, no model axis) restored onto the (2, 2)
    mesh continues: the loss and params bitwise equal to
    shard_runner_tp(original)'s; restoring onto a 1-D mesh of W env ranks
    raises, naming both sizes."""
    mesh2 = _tp_mesh(mesh)
    cfg, ppo, runner, ts = tp_setup(seed=2)
    original, _ = ts(runner)
    path = checkpoint.save(os.path.join(workdir, "dp_ckpt"),
                           D.shard_runner(original, mesh2), mesh2)
    _, ts2, _ = make_ppo(cfg, ppo, (128, 128), mesh=mesh2)
    direct = shard_runner_tp(original, mesh2)
    _, _, other, _ = tp_setup(seed=3)
    restored = checkpoint.restore(path, shard_runner_tp(other, mesh2), mesh2)
    direct, m1 = ts2(direct)
    restored, m2 = ts2(restored)
    out = {"loss": (float(m1["loss"]), float(m2["loss"])),
           "params": all(torch.equal(a, b) for a, b in zip(
               direct.net.parameters(), restored.net.parameters())),
           "files": sorted(os.listdir(path))}
    out["wrong_size"] = _raises(lambda: checkpoint.restore(
        path, D.shard_runner(tp_setup(seed=3)[2], mesh), mesh))
    return out


def main(argv) -> int:
    workdir, cases = argv[0], argv[1:]
    D.init_multihost()
    mesh = D.make_mesh(device="cpu")
    rank = torch.distributed.get_rank()
    for case in cases:
        res = globals()[f"case_{case}"](workdir, mesh)
        torch.save(res, os.path.join(workdir, f"{case}-rank{rank}.pt"))
    D.sync_hosts("cases")
    D.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
