"""The port's examples (`pvderx_torch/examples/`), the twins of the
reference's `examples/standalone_simulation.py`, `gym_rollout.py`,
`fleet_simulation.py` and `gain_tuning.py`, run with ``--cpu`` at a tiny
size through their ``main(argv)``: each finishes with finite results, and
gain tuning lowers its loss. Without ``--cpu`` each runs on the card, with
no fallback: on a host without one it raises.
"""
import numpy as np
import pytest
import torch

from pvderx_torch.examples import (
    fleet_simulation, gain_tuning, gym_rollout, standalone_simulation)


def test_torch_example_standalone_simulation(tmp_path):
    series = standalone_simulation.main(
        ["--cpu", "--tstop", "0.1", "--outdir", str(tmp_path)])
    assert len(series["vdc"]) == 6 and np.isfinite(series["vdc"]).all()


@pytest.mark.parametrize("continuous", [False, True])
def test_torch_example_gym_rollout(continuous):
    total = gym_rollout.main(["--cpu", "--steps", "4"]
                             + ["--continuous"] * continuous)
    assert np.isfinite(total)


def test_torch_example_fleet_simulation():
    tot = fleet_simulation.main(["--cpu", "--m", "3", "--n-envs", "2",
                                 "--steps", "3", "--n-sub", "40"])
    assert tot.shape == (2,) and torch.isfinite(tot).all()


def test_torch_example_gain_tuning_lowers_the_loss():
    loss, gains = gain_tuning.make_loss(windows=3, n_sub=40, device="cpu")
    v0, grads = gain_tuning.value_and_grad(loss, gains)
    assert all(torch.isfinite(g) and g != 0 for g in grads.values())
    final = gain_tuning.main(["--cpu", "--iters", "2", "--windows", "3",
                              "--n-sub", "40"])
    assert np.isfinite(final) and final < float(v0)


@pytest.mark.parametrize("example", [standalone_simulation, gym_rollout,
                                     fleet_simulation, gain_tuning],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_torch_example_runs_on_the_card_or_raises(example):
    if torch.cuda.is_available():
        pytest.skip("the card is present: the example would run on it")
    with pytest.raises((RuntimeError, AssertionError)):
        example.main(["--steps", "1"] if example is gym_rollout else
                     ["--tstop", "0.05"] if example is standalone_simulation
                     else ["--steps", "1", "--n-envs", "1", "--m", "2"]
                     if example is fleet_simulation else
                     ["--iters", "1", "--windows", "1"])
