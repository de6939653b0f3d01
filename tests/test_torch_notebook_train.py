"""The training notebook, built for ``device="cpu"``, executed through
`nbclient` (one CPU thread) in a temporary directory at the reference
notebook's sizes, in two kernels so that each test file stays a few minutes
long: here the 120-step gym rollout, DQN at 64 envs for 60 updates and SAC
for 300 updates with its 320-step random baseline;
`tests/test_torch_notebook_train_ppo.py` runs PPO's section (config 3, 60
updates, its baseline) and the export. Once per module: every code cell
ran without an error (a plot cell displays its figure), each metric of the
learners' last update and their reward histories are finite, and the
plots are written.
"""
import math

import pytest

from pvderx_torch.examples.notebooks import build_notebooks as bn
from test_torch_notebook_standalone import (
    check_cell_ran, code_cells, execute_probed)

METRICS = {"dqn": ("loss", "q_mean", "epsilon", "reward_mean",
                   "buffer_size"),
           "ppo": ("loss", "pg_loss", "v_loss", "entropy", "reward_mean",
                   "done_frac"),
           "sac": ("critic_loss", "actor_loss", "entropy", "alpha",
                   "reward_mean", "buffer_size")}


def parts(cells):
    """The training notebook in two: (its cells without PPO's section and
    the export's, its first two cells with those two sections), split at
    the headings "## PPO", "## SAC" and "## Deploying"."""
    head = lambda k: next(i for i, c in enumerate(cells) if c.kind ==
                          "markdown" and c.source.startswith(k))
    ppo, sac, deploy = head("## PPO"), head("## SAC"), head("## Deploying")
    return (cells[:ppo] + cells[sac:deploy],
            cells[:2] + cells[ppo:sac] + cells[deploy:])


def probe(*learners) -> str:
    """The probe expression: each learner's last metrics (``<name>_m``)."""
    return "dict(" + ", ".join(
        f"{n}={{k: float(v) for k, v in {n}_m.items()}}" for n in learners)


CELLS = parts(bn.train_cells("cpu"))[0]


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("train")
    nb, got = execute_probed(CELLS, probe("dqn", "sac") + (
        ", hist=hist, sac_hist=sac_hist, sac_rand=sac_rand)"), workdir)
    return workdir, nb, got


@pytest.mark.parametrize("cell", code_cells(CELLS))
def test_torch_notebook_train_cell_runs_on_the_cpu(executed, cell):
    check_cell_ran(executed[1], cell)


@pytest.mark.parametrize("learner,key", [(n, k) for n in ("dqn", "sac")
                                         for k in METRICS[n]])
def test_torch_notebook_train_metric_is_finite(executed, learner, key):
    assert math.isfinite(executed[2][learner][key])


@pytest.mark.parametrize("hist,n", [("hist", 60), ("sac_hist", 300)])
def test_torch_notebook_train_history_is_whole_and_finite(executed, hist,
                                                          n):
    values = executed[2][hist]
    assert len(values) == n and all(map(math.isfinite, values))


def test_torch_notebook_train_random_baseline_is_finite(executed):
    assert math.isfinite(executed[2]["sac_rand"])


@pytest.mark.parametrize("name", ["dqn", "sac"])
def test_torch_notebook_train_writes_its_plot(executed, name):
    path = executed[0] / f"pvderx_torch_nb_{name}.png"
    assert path.stat().st_size > 0
