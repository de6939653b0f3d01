"""Run the demo notebooks' compute cells as a script, for a host without
Jupyter (the card's):

    python -m pvderx_torch.examples.notebooks.run_cells --device cuda \\
        [--tiny] [--notebook standalone_simulation|train_rl ...]

Every cell tagged ``compute`` of each notebook runs in order, in one
namespace per notebook, the cells built by `build_notebooks` for
``--device``; a cell tagged ``plot`` never runs. ``--tiny`` builds them at
`build_notebooks.TINY`'s sizes, not the reference's. One line per cell,
``[cell] {json}``: its seconds, the K1 launches it made
(`ops.window.rk4_window_batch.launches`; the CPU's plain window makes
none) and the batched env steps it took (calls of `env.core.step`, which
every single-DER step goes through); then one ``[notebook] {json}`` line
with the totals and the notebook's checks (`build_notebooks.NOTEBOOKS`).
Exits 1 if a cell raises (its traceback on stderr) or a check fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from pvderx_torch.examples.notebooks import build_notebooks as bn


class StepCounter:
    """Counts the calls of `env.core.step` while it is installed."""

    def __init__(self):
        self.count = 0
        self._real = None

    def __enter__(self):
        from pvderx_torch.env import core

        self._real = real = core.step

        def step(*args, **kwargs):
            self.count += 1
            return real(*args, **kwargs)

        core.step = step
        return self

    def __exit__(self, *exc):
        from pvderx_torch.env import core

        core.step = self._real


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_notebook(name: str, device: str, sizes=bn.SIZES) -> dict:
    """Run one notebook's compute cells; prints a line per cell and returns
    the notebook's summary (``failed`` names the cell that raised)."""
    from pvderx_torch.ops.window import rk4_window_batch

    cells_of, checks_of = bn.NOTEBOOKS[name]
    ns = {"__name__": "__main__"}
    rows = []
    t_nb = time.perf_counter()
    with StepCounter() as steps:
        for i, cell in enumerate(cells_of(device, sizes)):
            if cell.kind != "code" or "plot" in cell.tags:
                continue
            k0, s0 = rk4_window_batch.launches, steps.count
            t = time.perf_counter()
            try:
                exec(compile(cell.source, f"<{name} cell {i}>", "exec"), ns)
                _sync(device)
            except Exception as exc:
                traceback.print_exc()
                return dict(notebook=name, device=device, cells=rows,
                            failed=dict(cell=i, error=f"{type(exc).__name__}"
                                        f": {exc}"))
            row = dict(notebook=name, cell=i,
                       seconds=time.perf_counter() - t,
                       k1_launches=rk4_window_batch.launches - k0,
                       env_steps=steps.count - s0)
            rows.append(row)
            print("[cell] " + json.dumps(row), flush=True)
    return dict(notebook=name, device=device,
                seconds=time.perf_counter() - t_nb,
                k1_launches=sum(r["k1_launches"] for r in rows),
                env_steps=sum(r["env_steps"] for r in rows),
                want_env_steps=bn.env_steps(name, sizes),
                cells=rows, checks=checks_of(ns, sizes))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--notebook", nargs="+", choices=list(bn.NOTEBOOKS),
                    default=list(bn.NOTEBOOKS))
    args = ap.parse_args(argv)
    sizes = bn.TINY if args.tiny else bn.SIZES
    for name in args.notebook:
        out = run_notebook(name, args.device, sizes)
        print("[notebook] " + json.dumps(
            {k: v for k, v in out.items() if k != "cells"}), flush=True)
        if "failed" in out or not out["checks"]["ok"]:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
