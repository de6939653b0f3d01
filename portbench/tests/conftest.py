"""Shared helpers of the benchmark's CPU tests: the checkout's root on the
module path, and cells cut to a size the CPU runs in seconds."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a cell whose files are in place and whose BENCHMARK.json entries wait
# for the env model's DC-link runaway to be fixed (PERF.md section 7)
WAITING = {"der10_ppo": {"name": "der10_ppo", "config": "der10_1ph",
                         "traffic": "ppo_16x4x4", "chips": 1}}
# each cell's traffic cut for the CPU (the program's plain windows)
TINY = {
    "der10_rollout": dict(n_envs=6, chunk_steps=3, check_chunks=3,
                          check_envs=4, trace_chunks=1),
    "der10_ppo": dict(n_envs=6, check_envs=4, trace_steps=1, hidden=[16, 16],
                      ppo=dict(lr=3e-4, gamma=0.99, lam=0.95, clip_eps=0.2,
                               ent_coef=0.01, vf_coef=0.5,
                               max_grad_norm=0.5, rollout_len=3, n_epochs=2,
                               n_minibatch=2)),
}
# events early enough to fall inside a tiny window's few steps
TINY_EVENTS = dict(sag_t_lo=0.0, sag_t_hi=0.08, sag_dur_lo=0.02,
                   sag_dur_hi=0.05, p_sag=0.6, p_freq=0.3)
# a horizon that a tiny window reaches: the chunk or train step the checks
# follow at the horizon (`common.horizon_unit`) is the window's first
TINY_HORIZON = 6


def tiny_cell(name, seed=20240611, seconds=1.5, trace=False, root=ROOT):
    from portbench import harness

    bench = with_waiting(harness.load_json(pathlib.Path(root)
                                           / "BENCHMARK.json"))
    cell = harness.Cell(bench, name, seed, seconds, trace, device="cpu",
                        root=root)
    cell.traffic.update(TINY[name])
    cell.config = dict(cell.config, horizon=TINY_HORIZON,
                       scenario=dict(cell.config["scenario"], **TINY_EVENTS))
    return cell


def with_waiting(bench):
    names = {w["name"] for w in bench["workloads"]}
    bench["workloads"] += [w for n, w in WAITING.items() if n not in names]
    return bench


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
