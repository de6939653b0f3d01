"""Build the demo notebooks (the counterpart of the reference's
`examples/notebooks/build_notebooks.py`): a standalone simulation, and
training DQN, PPO and SAC on the PV-DER environment.

    python -m pvderx_torch.examples.notebooks.build_notebooks \\
        [--device cuda|cpu] [--out DIR] [--execute]

The cells are plain data (`standalone_cells`, `train_cells`), so that
`run_cells` can run them where `nbformat` is not installed. Each cell
imports what it uses, so that a section runs after the first code cell
alone. Each cell is tagged at build time: ``compute`` for the cells that
set up and run the work, ``plot`` for the cells that draw it (matplotlib,
IPython). The
device is a parameter of the build: every cell runs on ``DEVICE``, which
the first code cell sets, and none falls back to another device. The
committed `.ipynb` files are built for ``"cuda"`` and carry no outputs;
``--device cpu --out DIR --execute`` builds and runs a CPU copy in DIR
(`nbclient`, the ``python3`` kernel; plots are written there as PNGs).
"""
from __future__ import annotations

import argparse
import os
from typing import NamedTuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the reference notebooks' sizes
SIZES = dict(t_stop=12.0, gym_steps=120, dqn_updates=60, ppo_updates=60,
             sac_updates=300, random_steps=320)
# the smallest that still runs every cell (run_cells --tiny)
TINY = dict(t_stop=0.05, gym_steps=3, dqn_updates=2, ppo_updates=2,
            sac_updates=2, random_steps=3)
DQN_ROLLOUT, PPO_ROLLOUT, SAC_ROLLOUT = 4, 16, 8


class Cell(NamedTuple):
    kind: str            # "markdown" or "code"
    source: str
    tags: tuple = ()     # code cells: ("compute",) or ("plot",)


def _md(text: str) -> Cell:
    return Cell("markdown", text)


def _compute(src: str) -> Cell:
    return Cell("code", src, ("compute",))


def _plot(src: str) -> Cell:
    return Cell("code", src, ("plot",))


def _setup(device: str) -> Cell:
    return _compute(
        "import numpy as np\n"
        "import torch\n"
        "\n"
        f"DEVICE = {device!r}   # every cell runs here; build the notebook "
        "with\n"
        "                   # build_notebooks.py --device for another one\n")


def env_steps(name: str, sizes=SIZES) -> int:
    """The batched env steps a notebook's compute cells take at ``sizes``
    (an episode that ends early would take fewer)."""
    s = sizes
    if name == "standalone_simulation":
        return int(round(s["t_stop"] * 60.0))
    return (s["gym_steps"] + DQN_ROLLOUT * s["dqn_updates"]
            + PPO_ROLLOUT * s["ppo_updates"] + SAC_ROLLOUT * s["sac_updates"]
            + 2 * s["random_steps"])


def standalone_cells(device: str, sizes=SIZES) -> list:
    return [
        _md("# Standalone PV-DER simulation\n\n"
            "The non-RL validation workflow (reference analog: the upstream "
            "demo notebooks driving `DynamicSimulation` + `SimulationEvents` "
            "+ `SimulationResults`, SURVEY.md §3.4): script a scenario of "
            "solar / grid / load events, integrate the full inverter ODE "
            "over the horizon, and plot the collected trajectory series.\n\n"
            "Everything below runs through the public `pvderx_torch` API on "
            "`DEVICE`: on the card each control window is one launch of the "
            "CUDA RK4 window kernel, on the CPU its plain torch version."),
        _setup(device),
        _md("## Script a scenario\n\n"
            "Events mirror the reference's `add_solar_event / add_grid_event "
            "/ add_load_event` surface. Grid events take optional "
            "negative-sequence components `(v2, phi2)` for unbalanced "
            "(SLG/LL-type) sags — three-phase models only."),
        _compute(
            "from pvderx_torch.scenario import EventBuilder\n"
            "\n"
            "ev = EventBuilder()\n"
            "ev.add_grid_event(2.0, v=0.6)            # balanced 0.6 pu sag "
            "...\n"
            "ev.add_grid_event(2.5, v=1.0)            # ... cleared after "
            "0.5 s\n"
            "ev.add_solar_event(4.0, 400.0)           # cloud: insolation "
            "1000 -> 400 W/m^2\n"
            "ev.add_solar_event(6.0, 1000.0)          # cloud passes\n"
            "ev.add_grid_event(8.0, v=0.7, v2=0.15, phi2=0.5)  # unbalanced "
            "sag\n"
            "ev.add_grid_event(8.3, v=1.0)\n"
            "ev.add_load_event(10.0, g_load=0.3)      # local load step\n"),
        _md("## Run the simulation\n\n"
            "`DynamicSimulation` mirrors the reference class surface: "
            "`run_simulation()` integrates window-by-window (1/60 s control "
            "windows, RK4 substeps, supervisory layer between windows) and "
            "collects the trajectory series, accessible as `sim.t_t`, "
            "`sim.vdc_t`, `sim.p_pcc_t`, ... like the reference's `t_t, "
            "Vdc_t, ...` accessors."),
        _compute(
            "from pvderx_torch.sim import DynamicSimulation\n"
            "\n"
            "sim = DynamicSimulation(\"50\", events=ev, "
            f"tStop={sizes['t_stop']!r},\n"
            "                        device=DEVICE)   # 50 kW three-phase\n"
            "series = sim.run_simulation()\n"
            "print(sorted(series.keys()))\n"
            "print(f\"steps={len(sim.t_t)}  Vdc in [{sim.vdc_t.min():.4f}, \"\n"
            "      f\"{sim.vdc_t.max():.4f}] pu  "
            "tripped={bool(sim.tripped_t[-1])}\")\n"),
        _compute("sim.show_PV_DER_states()\n"),
        _md("## Plot the reference plot set\n\n"
            "`SimulationResults.plot_DER_simulation` reproduces the "
            "reference's plot types (`power`, `voltage`, `current`, "
            "`duty_cycle`, `frequency`, `dc`, or `all`)."),
        _plot(
            "from IPython.display import Image, display\n"
            "from pvderx_torch.diag.plots import SimulationResults\n"
            "\n"
            "res = SimulationResults(series, title=\"50 kW three-phase, "
            "eventful scenario\")\n"
            "path = res.plot_DER_simulation(\"all\", "
            "save_path=\"pvderx_torch_nb_all.png\")\n"
            "display(Image(path))\n"),
        _md("The sag at t=2 s dips the PCC voltage and power; the cloud "
            "between 4–6 s cuts PV power to ~40%; the unbalanced sag at t=8 s "
            "shows up as a voltage/power dip with a nonzero "
            "negative-sequence component; the load step at t=10 s shifts the "
            "PCC operating point. The DC link stays regulated at 1 pu "
            "throughout — the reference behavior, which the port holds to "
            "≤1e-6 against the LSODA oracle (`tests/test_torch_sim.py`)."),
    ]


def train_cells(device: str, sizes=SIZES) -> list:
    s = sizes
    return [
        _md("# Training RL agents on the PV-DER environment\n\n"
            "The reference demos train stable-baselines DQN/PPO against "
            "`gym.make('PVDER-v0')` one env-step at a time. `pvderx_torch` "
            "keeps that single-env Gymnasium surface (below) and adds the "
            "batched path: thousands of envs stepped as one batch inside "
            "each `train_step`, one window-kernel launch per step on the "
            "card (SURVEY.md §2.5). This notebook shows both, at the "
            "reference notebook's sizes."),
        _setup(device),
        _md("## Gymnasium single-env rollout (reference-style)\n\n"
            "`PVDEREnv` is the env that `gym.make(\"pvderx_torch/PVDER-v0\")` "
            "returns (wrapped in Gymnasium's checkers) where gymnasium is "
            "installed; `register_envs()` registers the ids there and does "
            "nothing without it. The cell builds the class directly and "
            "draws its random actions with numpy, so it runs the same "
            "on a host without gymnasium."),
        _compute(
            "from pvderx_torch.env.core import N_ACTIONS\n"
            "from pvderx_torch.env.gym_adapter import PVDEREnv, register_envs\n"
            "register_envs()\n"
            "\n"
            f"env = PVDEREnv(n_sub=40, horizon={s['gym_steps']}, "
            "device=DEVICE)\n"
            "rng = np.random.default_rng(0)\n"
            "obs, _ = env.reset(seed=0)\n"
            "ret = 0.0\n"
            f"for k in range({s['gym_steps']}):\n"
            "    obs, r, term, trunc, info = env.step(int(rng.integers("
            "N_ACTIONS)))\n"
            "    ret += r\n"
            "    if k % 30 == 0:\n"
            "        print(env.render())\n"
            "    if term or trunc:\n"
            "        break\n"
            "print(f\"random-policy return: {ret:.2f}\")\n"),
        _md("## Batched DQN (the reference's DQN demo, batched)\n\n"
            "One `train_step` = epsilon-greedy collection over all envs + "
            "replay writes + double-DQN updates. Over several ranks the same "
            "runner splits its envs over the mesh's env axis "
            "(`pvderx_torch.dist.shard_runner`)."),
        _compute(
            "from pvderx_torch.env import make_env_config\n"
            "from pvderx_torch.learn import DQNConfig, make_dqn\n"
            "\n"
            "cfg = make_env_config(\"10\", n_sub=40, horizon=120, "
            "device=DEVICE)\n"
            f"dqn = DQNConfig(rollout_len={DQN_ROLLOUT}, n_updates=4, "
            "batch_size=128,\n"
            "                capacity=16384, eps_decay_updates=40)\n"
            "init_runner, train_step, _ = make_dqn(cfg, dqn)\n"
            "runner = init_runner(64, torch.Generator(device=DEVICE)"
            ".manual_seed(0))\n"
            "\n"
            "hist = []\n"
            f"for i in range({s['dqn_updates']}):\n"
            "    runner, dqn_m = train_step(runner)\n"
            "    hist.append(float(dqn_m[\"reward_mean\"]))\n"
            f"    if i % 15 == 0 or i == {s['dqn_updates'] - 1}:\n"
            "        print(f\"update {i:3d}: reward={hist[-1]:+.3f} \"\n"
            "              f\"eps={float(dqn_m['epsilon']):.2f} "
            "loss={float(dqn_m['loss']):.4f}\")\n"),
        _plot(
            "import matplotlib\n"
            "matplotlib.use(\"Agg\")\n"
            "import matplotlib.pyplot as plt\n"
            "from IPython.display import Image, display\n"
            "\n"
            "fig, ax = plt.subplots(figsize=(7, 3.2))\n"
            "w = 5  # smooth over a 5-update window\n"
            "sm = np.convolve(hist, np.ones(w) / w, mode=\"valid\")\n"
            "ax.plot(np.arange(len(sm)) + w - 1, sm, lw=2, color=\"#2f6f9f\")\n"
            "ax.set_xlabel(\"train_step\")\n"
            "ax.set_ylabel(\"mean per-step reward\")\n"
            "ax.set_title(f\"DQN on pvderx_torch/PVDER-v0 (64 envs, "
            "{DEVICE})\")\n"
            "ax.grid(True, alpha=0.3)\n"
            "fig.savefig(\"pvderx_torch_nb_dqn.png\", dpi=120, "
            "bbox_inches=\"tight\")\n"
            "plt.close(fig)\n"
            "display(Image(\"pvderx_torch_nb_dqn.png\"))\n"),
        _md("## PPO (the reference's PPO demo) — and proof that it LEARNS\n\n"
            "Same design: rollout collection + GAE + minibatched clipped-PPO "
            "epochs in one `train_step`. Here on the BASELINE config-3 task "
            "(anomaly detection under frequent sags): the agent earns +0.5 "
            "for flagging while an injected event is active, −0.2 for false "
            "alarms. The reference's policy reaches ≈0.099/step within 60 "
            "updates against ≈0.064 for a random one — the seeded gate "
            "`tests/test_learning.py` enforces, which the port passes on the "
            "card (`pvderx_torch.learn.gates`). For full-scale runs use "
            "`python -m pvderx_torch.examples.train_ppo --n-envs 8192`."),
        _compute(
            "from pvderx_torch.env import ScenarioConfig, make_env_config\n"
            "from pvderx_torch.learn import PPOConfig, make_env_api, "
            "make_ppo\n"
            "\n"
            "cfg3 = make_env_config(\"10\", n_sub=40, horizon=50, "
            "anomaly_detect=True,\n"
            "                       scen=ScenarioConfig(p_sag=0.9, "
            "p_freq=0.1,\n"
            "                                          sag_depth_lo=0.2, "
            "sag_depth_hi=0.85),\n"
            "                       device=DEVICE)\n"
            f"ppo = PPOConfig(rollout_len={PPO_ROLLOUT}, n_epochs=2, "
            "n_minibatch=4,\n"
            "                lr=3e-3, ent_coef=0.005)\n"
            "init_runner, train_step, _ = make_ppo(cfg3, ppo, "
            "hidden=(32, 32))\n"
            "prunner = init_runner(64, torch.Generator(device=DEVICE)"
            ".manual_seed(1))\n"
            "ppo_hist = []\n"
            f"for i in range({s['ppo_updates']}):\n"
            "    prunner, ppo_m = train_step(prunner)\n"
            "    ppo_hist.append(float(ppo_m[\"reward_mean\"]))\n"
            f"    if i % 15 == 0 or i == {s['ppo_updates'] - 1}:\n"
            "        print(f\"update {i:2d}: reward={ppo_hist[-1]:+.4f} \"\n"
            "              f\"loss={float(ppo_m['loss']):.4f} "
            "entropy={float(ppo_m['entropy']):.3f}\")\n"
            "\n"
            "# random-policy baseline on the same env\n"
            "api = make_env_api(cfg3)\n"
            "gen = torch.Generator(device=DEVICE).manual_seed(2)\n"
            "act_gen = torch.Generator(device=DEVICE).manual_seed(3)\n"
            "st, ob = api.reset_batch(64, gen)\n"
            "tot = []\n"
            "with torch.no_grad():\n"
            f"    for _ in range({s['random_steps']}):\n"
            "        a = torch.randint(0, api.n_actions, (64,), "
            "generator=act_gen,\n"
            "                          device=DEVICE)\n"
            "        st, ob, r, d, _ = api.step(st, a, gen)\n"
            "        tot.append(r.mean())\n"
            "rand_ret = float(torch.stack(tot).mean())\n"
            "print(f\"random policy: {rand_ret:+.4f}   PPO (last 10): \"\n"
            "      f\"{float(np.mean(ppo_hist[-10:])):+.4f}\")\n"),
        _plot(
            "import matplotlib\n"
            "matplotlib.use(\"Agg\")\n"
            "import matplotlib.pyplot as plt\n"
            "from IPython.display import Image, display\n"
            "\n"
            "fig, ax = plt.subplots(figsize=(7, 3.2))\n"
            "sm = np.convolve(ppo_hist, np.ones(5) / 5, mode=\"valid\")\n"
            "ax.plot(np.arange(len(sm)) + 4, sm, lw=2, color=\"#2f6f9f\",\n"
            "        label=\"PPO (5-update smoothed)\")\n"
            "ax.axhline(rand_ret, color=\"#b0413e\", ls=\"--\", lw=1.5,\n"
            "           label=f\"random policy ({rand_ret:+.3f})\")\n"
            "ax.set_xlabel(\"train_step\")\n"
            "ax.set_ylabel(\"mean per-step reward\")\n"
            "ax.set_title(f\"PPO learns anomaly flagging (BASELINE config 3, "
            "{DEVICE})\")\n"
            "ax.legend(loc=\"lower right\")\n"
            "ax.grid(True, alpha=0.3)\n"
            "fig.savefig(\"pvderx_torch_nb_ppo.png\", dpi=120, "
            "bbox_inches=\"tight\")\n"
            "plt.close(fig)\n"
            "display(Image(\"pvderx_torch_nb_ppo.png\"))\n"),
        _md("## SAC (continuous extension) — the same learning proof\n\n"
            "The continuous Box(2) action space (per-step `(dq, dv)` deltas) "
            "trains with SAC. On a high-authority variant (dq=0.15/dv=0.06 "
            "per step) a uniform-random policy damages its own setpoint "
            "tracking (≈0.054/step in the reference) while 300 seeded SAC "
            "updates reach ≈0.085 — the pinned margin gate is "
            "`tests/test_learning.py::test_sac_learns_better_than_random` "
            "(margin 0.015)."),
        _compute(
            "from pvderx_torch.env import make_env_config\n"
            "from pvderx_torch.learn import SACConfig, make_env_api, "
            "make_sac\n"
            "\n"
            "cfg_c = make_env_config(\"10\", n_sub=40, horizon=50, "
            "continuous=True,\n"
            "                        dq_action=0.15, dv_action=0.06, "
            "device=DEVICE)\n"
            "init_runner, sac_step, _ = make_sac(cfg_c, "
            f"SACConfig(rollout_len={SAC_ROLLOUT}, lr=3e-3,\n"
            "                                                    "
            "init_alpha=0.05),\n"
            "                                     hidden=(32, 32))\n"
            "srunner = init_runner(64, torch.Generator(device=DEVICE)"
            ".manual_seed(0))\n"
            "sac_hist = []\n"
            f"for i in range({s['sac_updates']}):\n"
            "    srunner, sac_m = sac_step(srunner)\n"
            "    sac_hist.append(float(sac_m[\"reward_mean\"]))\n"
            "\n"
            "api_c = make_env_api(cfg_c)\n"
            "gen = torch.Generator(device=DEVICE).manual_seed(7)\n"
            "act_gen = torch.Generator(device=DEVICE).manual_seed(7 + 999)\n"
            "st, ob = api_c.reset_batch(64, gen)\n"
            "tot = []\n"
            "with torch.no_grad():\n"
            f"    for _ in range({s['random_steps']}):\n"
            "        a = 2.0 * torch.rand(64, api_c.act_dim, "
            "generator=act_gen,\n"
            "                             device=DEVICE) - 1.0\n"
            "        st, ob, r, d, _ = api_c.step(st, a, gen)\n"
            "        tot.append(r.mean())\n"
            "sac_rand = float(torch.stack(tot).mean())\n"
            "print(f\"random: {sac_rand:+.4f}   SAC (last 20): \"\n"
            "      f\"{float(np.mean(sac_hist[-20:])):+.4f}\")\n"),
        _plot(
            "import matplotlib\n"
            "matplotlib.use(\"Agg\")\n"
            "import matplotlib.pyplot as plt\n"
            "from IPython.display import Image, display\n"
            "\n"
            "fig, ax = plt.subplots(figsize=(7, 3.2))\n"
            "sm = np.convolve(sac_hist, np.ones(15) / 15, mode=\"valid\")\n"
            "ax.plot(np.arange(len(sm)) + 14, sm, lw=2, color=\"#2f6f9f\",\n"
            "        label=\"SAC (15-update smoothed)\")\n"
            "ax.axhline(sac_rand, color=\"#b0413e\", ls=\"--\", lw=1.5,\n"
            "           label=f\"random policy ({sac_rand:+.3f})\")\n"
            "ax.set_xlabel(\"train_step\")\n"
            "ax.set_ylabel(\"mean per-step reward\")\n"
            "ax.set_title(\"SAC learns continuous setpoint control "
            "(high-authority variant)\")\n"
            "ax.legend(loc=\"lower right\")\n"
            "ax.grid(True, alpha=0.3)\n"
            "fig.savefig(\"pvderx_torch_nb_sac.png\", dpi=120, "
            "bbox_inches=\"tight\")\n"
            "plt.close(fig)\n"
            "display(Image(\"pvderx_torch_nb_sac.png\"))\n"),
        _md("## Deploying the trained policy\n\n"
            "Controllers ultimately run on hosts without torch (inverter "
            "controllers, EMS/SCADA). `pvderx_torch.learn.export` flattens "
            "the trained MLP into a numpy-only forward plus a portable JSON "
            "artifact; on the same observations it acts as the torch net's "
            "argmax (tests/test_torch_learn_export.py)."),
        _compute(
            "from pvderx_torch.learn import NumpyMLPPolicy, "
            "export_actor_critic\n"
            "\n"
            "pol = export_actor_critic(prunner.net)\n"
            "artifact = pol.to_json()                    # ship this file\n"
            "pol2 = NumpyMLPPolicy.from_json(artifact)   # ... on the target "
            "host\n"
            "obs_np = prunner.obs.cpu().numpy()\n"
            "deployed = pol2.act(obs_np)\n"
            "with torch.no_grad():\n"
            "    torch_actions = prunner.net(prunner.obs)[0].argmax(-1)"
            ".cpu().numpy()\n"
            "print(\"artifact size:\", len(artifact) // 1024, \"KiB\")\n"
            "print(\"deployed actions:\", deployed[:10])\n"
            "print(\"the torch net's on all\", len(deployed), \"envs:\",\n"
            "      \"equal\" if (deployed == torch_actions).all() else "
            "\"DIFFERENT\")\n"),
        _md("All three runners are checkpointable (`pvderx_torch.diag."
            "checkpoint`) and split their envs over several ranks unchanged "
            "— see `tests/test_torch_dist_learn.py` and "
            "`pvderx_torch/examples/train_*.py`."),
    ]


def _finite(xs) -> bool:
    return bool(np.all(np.isfinite(np.asarray(list(xs), np.float64))))


def standalone_checks(ns: dict, sizes=SIZES) -> dict:
    """What the standalone notebook's namespace must hold after its compute
    cells: every window of the horizon simulated, every series finite."""
    sim = ns["sim"]
    windows = len(sim.t_t)
    finite = all(np.isfinite(v).all() for v in sim.series.values())
    return dict(ok=windows == env_steps("standalone_simulation", sizes)
                and finite, windows=windows, finite=finite,
                vdc_min=float(sim.vdc_t.min()), vdc_max=float(sim.vdc_t.max()),
                tripped=bool(sim.tripped_t[-1] > 0.5))


def train_checks(ns: dict, sizes=SIZES) -> dict:
    """What the training notebook's namespace must hold after its compute
    cells: each learner's last metrics and its reward history finite, the
    random baselines finite, and the exported numpy policy acting as the
    torch net's argmax on the same observations."""
    metrics = {name: {k: float(v) for k, v in ns[name].items()}
               for name in ("dqn_m", "ppo_m", "sac_m")}
    hists = {name: len(ns[name]) for name in ("hist", "ppo_hist", "sac_hist")}
    finite = (all(_finite(m.values()) for m in metrics.values())
              and all(_finite(ns[name]) for name in hists)
              and _finite([ns["rand_ret"], ns["sac_rand"]]))
    equal = bool(np.array_equal(ns["deployed"], ns["torch_actions"]))
    want = {"hist": sizes["dqn_updates"], "ppo_hist": sizes["ppo_updates"],
            "sac_hist": sizes["sac_updates"]}
    return dict(ok=finite and equal and hists == want, finite=finite,
                export_equal=equal, export_rows=int(len(ns["deployed"])),
                updates=hists, metrics=metrics,
                random=dict(ppo=ns["rand_ret"], sac=ns["sac_rand"]),
                trained=dict(ppo_last10=float(np.mean(ns["ppo_hist"][-10:])),
                             sac_last20=float(np.mean(ns["sac_hist"][-20:]))))


# name -> (cells, checks)
NOTEBOOKS = {"standalone_simulation": (standalone_cells, standalone_checks),
             "train_rl": (train_cells, train_checks)}


def to_notebook(cells):
    """An `nbformat` v4 notebook of ``cells``, each code cell's tags in its
    metadata."""
    import nbformat as nbf

    nb = nbf.v4.new_notebook()
    nb.metadata["kernelspec"] = {"display_name": "Python 3",
                                 "language": "python", "name": "python3"}
    for c in cells:
        if c.kind == "markdown":
            nb.cells.append(nbf.v4.new_markdown_cell(c.source))
        else:
            nb.cells.append(nbf.v4.new_code_cell(
                c.source, metadata={"tags": list(c.tags)}))
    return nb


def nb_standalone(device: str, sizes=SIZES):
    return to_notebook(standalone_cells(device, sizes))


def nb_train(device: str, sizes=SIZES):
    return to_notebook(train_cells(device, sizes))


def execute(nb, workdir: str):
    """Run ``nb`` in place through `nbclient` with ``workdir`` as its
    working directory (at most 1200 s per cell)."""
    from nbclient import NotebookClient

    NotebookClient(nb, timeout=1200, kernel_name="python3",
                   resources={"metadata": {"path": workdir}}).execute()
    return nb


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=HERE)
    ap.add_argument("--execute", action="store_true")
    args = ap.parse_args(argv)
    import nbformat as nbf

    os.makedirs(args.out, exist_ok=True)
    for name, build in (("standalone_simulation", nb_standalone),
                        ("train_rl", nb_train)):
        nb = build(args.device)
        if args.execute:
            execute(nb, args.out)
        path = os.path.join(args.out, f"{name}.ipynb")
        nbf.write(nb, path)
        print("wrote", path)


if __name__ == "__main__":
    main()
