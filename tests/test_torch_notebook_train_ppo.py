"""The training notebook's PPO section and its export, built for
``device="cpu"``, executed through `nbclient` after the notebook's first
code cell, at the reference notebook's sizes (PPO on config 3 at 64 envs
for 60 updates, a 320-step random baseline), once per module: every code
cell ran without an error, each metric of the last update and the reward
history are finite, the exported numpy policy's actions equal the torch
net's argmax on the same observations, and the plot is displayed and
written. The other sections run in `tests/test_torch_notebook_train.py`.
"""
import math

import pytest

from pvderx_torch.examples.notebooks import build_notebooks as bn
from test_torch_notebook_standalone import (
    check_cell_ran, code_cells, execute_probed)
from test_torch_notebook_train import METRICS, parts, probe

CELLS = parts(bn.train_cells("cpu"))[1]


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("train_ppo")
    nb, got = execute_probed(CELLS, probe("ppo") + (
        ", ppo_hist=ppo_hist, rand_ret=rand_ret, "
        "export_equal=bool((deployed == torch_actions).all()), "
        "rows=len(deployed), devices=sorted({str(p.device) for p in "
        "prunner.net.parameters()}))"), workdir)
    return workdir, nb, got


@pytest.mark.parametrize("cell", code_cells(CELLS))
def test_torch_notebook_train_ppo_cell_runs_on_the_cpu(executed, cell):
    check_cell_ran(executed[1], cell)


@pytest.mark.parametrize("key", METRICS["ppo"])
def test_torch_notebook_train_ppo_metric_is_finite(executed, key):
    assert math.isfinite(executed[2]["ppo"][key])


def test_torch_notebook_train_ppo_history_is_whole_and_finite(executed):
    values = executed[2]["ppo_hist"]
    assert len(values) == 60 and all(map(math.isfinite, values))
    assert math.isfinite(executed[2]["rand_ret"])


def test_torch_notebook_train_ppo_export_acts_as_the_torch_net(executed):
    got = executed[2]
    assert got["export_equal"] and got["rows"] == 64
    assert got["devices"] == ["cpu"]


def test_torch_notebook_train_ppo_writes_its_plot(executed):
    assert (executed[0] / "pvderx_torch_nb_ppo.png").stat().st_size > 0
