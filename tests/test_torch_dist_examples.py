"""The three training examples (`pvderx_torch.examples.train_ppo`,
`train_dqn`, `train_sac`, the twins of the reference's `examples/train_*.py`)
with ``--cpu`` at a tiny size (4 global envs, one update, n_sub 40): each
through its ``main(argv)`` in this process, and each as 2 gloo ranks under
`python -m pvderx_torch.dist.launch --nproc 2 --cpu` (PPO with ``--tp 2``,
a 2-D (env=1, model=2) mesh, and a checkpoint); every run exits 0 with
finite metrics, and only rank 0 writes the metrics file.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--cpu", "--n-envs", "4", "--updates", "1", "--n-sub", "40"]
KEYS = {"train_ppo": "loss", "train_dqn": "loss", "train_sac": "critic_loss"}


@pytest.mark.parametrize("name", sorted(KEYS))
def test_torch_dist_example_runs_on_one_rank(name, tmp_path):
    import importlib

    mod = importlib.import_module(f"pvderx_torch.examples.{name}")
    metrics = mod.main(TINY + ["--metrics", str(tmp_path / "m.jsonl")])
    assert math.isfinite(float(metrics[KEYS[name]]))
    rec = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[-1])
    assert rec["step"] == 0 and math.isfinite(rec[KEYS[name]])


@pytest.mark.parametrize("name", sorted(KEYS))
def test_torch_dist_example_runs_on_two_ranks(name, tmp_path):
    extra = ["--tp", "2", "--ckpt", str(tmp_path / "ckpt")] \
        if name == "train_ppo" else []
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "pvderx_torch.dist.launch", "--nproc", "2",
         "--cpu", "--timeout", "240", "-m", f"pvderx_torch.examples.{name}",
         *TINY, "--metrics", str(tmp_path / "m.jsonl"), *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(lines) == 1          # rank 0 alone writes
    assert math.isfinite(json.loads(lines[0])[KEYS[name]])
    if extra:
        assert sorted(os.listdir(tmp_path / "ckpt")) == [
            "rank0-of-1.pt", "replicated.pt"]
