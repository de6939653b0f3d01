"""The port's demo notebooks (`pvderx_torch/examples/notebooks/`), built
from `build_notebooks`' cell lists.

- The committed `.ipynb` files are the builder's output for
  ``device="cuda"``, cell for cell, with no outputs (they are committed
  unexecuted).
- Every code cell is tagged ``compute`` or ``plot`` at build time, the plot
  cells being the ones that draw (matplotlib, IPython's display); no cell
  probes for a device or a package.
- At the reference notebooks' sizes the notebooks take 720 and 4360 batched
  env steps (120 gym + 240 DQN + 960 PPO + 320 random + 2400 SAC + 320
  random).

Both notebooks are executed on the CPU by
`tests/test_torch_notebook_standalone.py`,
`tests/test_torch_notebook_train.py` and
`tests/test_torch_notebook_train_ppo.py`.
"""
import json
import pathlib

import pytest

from pvderx_torch.examples.notebooks import build_notebooks as bn

HERE = pathlib.Path(bn.HERE)


@pytest.mark.parametrize("name", list(bn.NOTEBOOKS))
def test_torch_committed_notebook_is_the_builders_for_cuda(name):
    nb = json.loads((HERE / f"{name}.ipynb").read_text())
    want = bn.NOTEBOOKS[name][0]("cuda")
    assert len(nb["cells"]) == len(want)
    for got, cell in zip(nb["cells"], want):
        assert got["cell_type"] == cell.kind
        assert "".join(got["source"]) == cell.source
        if cell.kind == "code":
            assert got["metadata"]["tags"] == list(cell.tags)
            assert got["outputs"] == [] and got["execution_count"] is None
    assert "DEVICE = 'cuda'" in "".join(nb["cells"][1]["source"])


@pytest.mark.parametrize("name", list(bn.NOTEBOOKS))
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_torch_notebook_cells_are_tagged_and_take_the_device(name, device):
    cells = bn.NOTEBOOKS[name][0](device)
    code = [c for c in cells if c.kind == "code"]
    assert code[0].source.count(f"DEVICE = {device!r}") == 1
    for c in code:
        assert c.tags in (("compute",), ("plot",)), c.source
        plots = any(w in c.source for w in ("matplotlib", "IPython", "plt.",
                                            "display("))
        assert plots == (c.tags == ("plot",)), c.source
        assert "is_available" not in c.source and "find_spec" not in c.source
        assert "'cuda'" not in c.source or c is code[0]
    assert any(c.tags == ("plot",) for c in code)


def test_torch_notebook_env_steps_at_the_reference_sizes():
    assert bn.env_steps("standalone_simulation") == 720
    assert bn.env_steps("train_rl") == 120 + 240 + 960 + 320 + 2400 + 320
