"""The standalone-simulation notebook, built for ``device="cpu"``, executed
through `nbclient` (the ``python3`` kernel, one CPU thread) in a temporary
directory at the reference notebook's sizes (preset 50, tStop 12 s: 720
control windows of the plain window at n_sub 120), once per module: every
code cell ran without an error (a plot cell displays its figure), the
namespace passes `build_notebooks.standalone_checks`, each collected series
holds 720 finite rows, and the plot is written.
"""
import json
import os
import pathlib

import nbformat
import pytest

from pvderx_torch.examples.notebooks import build_notebooks as bn

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERIES = ("t", "y", "vdc", "v_mag", "p_pcc", "q_pcc", "p_pv", "f_meas",
          "m_mag", "i_mag", "tripped")


def execute_probed(cells, probe: str, workdir):
    """Execute a notebook of ``cells`` in ``workdir``, then a last cell that
    prints the JSON of the expression ``probe`` over its namespace; returns
    (the executed notebook, that value)."""
    nb = bn.to_notebook(cells)
    nb.cells.append(nbformat.v4.new_code_cell(
        "import json\n"
        "from pvderx_torch.examples.notebooks import build_notebooks\n"
        f"print('PROBE ' + json.dumps({probe}))\n"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONPATH", os.pathsep.join(
            [str(ROOT), os.environ.get("PYTHONPATH", "")]))
        mp.setenv("OMP_NUM_THREADS", "1")
        bn.execute(nb, str(workdir))
    text = "".join(o.get("text", "") for o in nb.cells[-1].outputs
                   if o.output_type == "stream")
    return nb, json.loads(text.split("PROBE ", 1)[1])


def code_cells(cells):
    """Indices of the code cells of a cell list."""
    return [i for i, c in enumerate(cells) if c.kind == "code"]


def check_cell_ran(nb, i):
    """Cell ``i`` of an executed notebook ran, without an error output; a
    plot cell displayed its figure."""
    cell = nb.cells[i]
    kinds = [o.output_type for o in cell.outputs]
    assert cell.execution_count is not None and "error" not in kinds
    if "plot" in cell.metadata.get("tags", []):
        assert kinds == ["display_data"]


PROBE = ("dict(checks=build_notebooks.standalone_checks(globals()), "
         "series={k: [len(v), bool(np.isfinite(v).all())] "
         "for k, v in series.items()})")


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("standalone")
    nb, got = execute_probed(bn.standalone_cells("cpu"), PROBE, workdir)
    return workdir, nb, got


@pytest.mark.parametrize("cell", code_cells(bn.standalone_cells("cpu")))
def test_torch_notebook_standalone_cell_runs_on_the_cpu(executed, cell):
    check_cell_ran(executed[1], cell)


def test_torch_notebook_standalone_passes_its_checks(executed):
    checks = executed[2]["checks"]
    assert checks["ok"] and checks["windows"] == 720 and checks["finite"]
    assert not checks["tripped"]


@pytest.mark.parametrize("name", SERIES)
def test_torch_notebook_standalone_series_is_whole_and_finite(executed, name):
    assert executed[2]["series"][name] == [720, True]


def test_torch_notebook_standalone_writes_its_plot(executed):
    assert (executed[0] / "pvderx_torch_nb_all.png").stat().st_size > 0
