"""The demo notebooks, the twins of the reference's
`examples/notebooks/`: `build_notebooks` writes `standalone_simulation.ipynb`
and `train_rl.ipynb` from its cell lists, and `run_cells` runs their
compute cells as a script (the card's host has no Jupyter).

    python -m pvderx_torch.examples.notebooks.build_notebooks
    python -m pvderx_torch.examples.notebooks.run_cells --device cuda
"""
