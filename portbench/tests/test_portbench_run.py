"""A whole run of each cell on the CPU at a tiny size: the result line's
keys and metrics; and `run.py` refusing to run, with no result line,
without a card or without the program."""
import json
import shutil
import subprocess
import sys
import time

import pytest

from conftest import ROOT, tiny_cell

from portbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["der10_rollout", "der10_ppo"])
@pytest.mark.parametrize("trace", [False, True])
def test_portbench_result_line_of_a_tiny_run(name, trace):
    cell = tiny_cell(name, trace=trace)
    result, checks, _ = harness.run_cell(cell, time.perf_counter(),
                                         require_device=False)
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert [k for k, _, _ in checks] == list(result["checks"])
    want = {m["name"] for m in harness.cell_metrics(cell.bench, name, trace)}
    got = set(result["metrics"])
    if trace:
        # readers of device time find no kernel on the CPU
        assert got <= want and "breakdown" in result
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        assert got == want
        assert all(v["value"] > 0 for v in result["metrics"].values())
    assert result["attempted"] > 0 and result["failed"] == 0
    json.dumps(result)


def run_py(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "der10_rollout",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_portbench_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = run_py(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout and "CUDA" in out.stderr


def test_portbench_run_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.parametrize("horizon, unit_steps, before, unit", [
    (600, 16, 3, 34),    # der10_ppo: the window's 35th train step
    (600, 60, 1, 8),     # der10_rollout: the window's 9th chunk
    (6, 3, 3, 0), (6, 3, 1, 0), (600, 700, 0, 0)])
def test_portbench_horizon_unit(horizon, unit_steps, before, unit):
    from portbench.drivers import common

    assert common.horizon_unit(horizon, unit_steps, before) == unit


def test_portbench_rollout_checks_the_chunk_at_the_horizon(monkeypatch):
    import importlib

    from portbench.drivers import common

    cell = tiny_cell("der10_rollout", seconds=3.0)
    driver = importlib.import_module("portbench.drivers.rollout").Driver(cell)
    driver.setup()
    driver.window(cell.seconds)
    driver.release()
    seen = []
    monkeypatch.setattr(common, "sample_ids",
                        lambda n, k, seed: seen.append(n) or [n - 1])
    followed = []
    replay = driver._replay
    monkeypatch.setattr(driver, "_replay",
                        lambda g, p: followed.append(g) or replay(g, p))
    driver.readings()
    at = common.horizon_unit(cell.config["horizon"], driver.chunk, 1)
    assert seen and seen[0] > at
    # the horizon's chunk is followed besides the sampled one
    assert len(followed) == 2
    assert bool(driver.records[at][2].any())


def test_portbench_ppo_checks_a_window_step_at_the_horizon():
    import importlib

    cell = tiny_cell("der10_ppo")
    driver = importlib.import_module("portbench.drivers.ppo").Driver(cell)
    driver.setup()
    driver.window(cell.seconds)
    driver.release()
    readings = driver.readings()
    assert readings["window_update"] <= cell.limits["window_update"]
    # the kept step ends the sampled episodes at the horizon, by the
    # autoreset inside collect
    assert driver.detail["window_step"] == 0
    assert bool(driver.late["traj"]["done"][:, driver.rows].any())


def test_portbench_host_window_reads_the_units_of_work():
    out = harness.host_window([2000.0, 2100.0], [0.0, 1.0, 2.0, 4.0, 6.0])
    assert out["cpu_mhz"] == [2000.0, 2100.0] and out["cpus_allowed"] >= 1
    assert out["unit_s_quartiles"] == pytest.approx([1.0, 1.5, 2.0])
    assert out["second_over_first"] == pytest.approx(2.0)
