"""`correct` comes out false where it must: for the control (the
reference in bfloat16 in the program's place) and for runs whose timed
path is broken underneath (`portbench.faults`: a step that returns its
state unchanged, half of the batch left out, an answer altered where it is
produced), the rest of each run as it is and the look for a card
skipped."""
import importlib
import time

import pytest

from conftest import tiny_cell

from portbench import faults, harness
from portbench.drivers import common

CELLS = ["der10_rollout", "der10_ppo"]


@pytest.mark.parametrize("name", CELLS)
def test_portbench_control_is_not_correct(name):
    cell = tiny_cell(name)
    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}").Driver(cell)
    driver.setup()
    driver.window(cell.seconds)
    driver.release()
    checks = common.checks(cell.limits, driver.readings(control=True))
    assert not all(v <= lim for _, v, lim in checks), checks


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_portbench_broken_timed_path_is_not_correct(name, fault):
    cell = tiny_cell(name)
    with faults.FAULTS[fault](cell):
        result = harness.run_cell(cell, time.perf_counter(),
                                  require_device=False)[0]
    assert result["correct"] is False, result["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]])
def test_portbench_on_the_card_the_program_is_correct_and_the_control_not(
        name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.Cell(bench, name, 4242424242, 3.0, False)
    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}").Driver(cell)
    driver.setup()
    driver.window(cell.seconds)
    driver.release()
    ok = common.checks(cell.limits, driver.readings())
    assert all(v <= lim for _, v, lim in ok), ok
    bad = common.checks(cell.limits, driver.readings(control=True))
    assert not all(v <= lim for _, v, lim in bad), bad
