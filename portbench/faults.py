"""Faults planted in the program's timed path, to show that a cell's checks
catch them: each is a context manager that patches the program while it
is open. The CPU tests drive whole runs under them; `calibrate.py
--fault` reads them on the card at a cell's own size.

- ``unchanged``: a step that returns its state unchanged (the env's ODE
  state for the env cells; no Adam step for the learner);
- ``half_batch``: half of the batch left out (the window integrates the
  first half of the envs; each PPO minibatch's loss is the mean over half
  of its rows, the other half repeating them);
- ``altered``: an answer altered where it is produced (every reward plus
  1e-3).

One chip, so no cell has an exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def unchanged(cell):
    import torch

    if cell.traffic["driver"] == "ppo":
        with patched(torch.optim.Adam, "step", lambda self, *a, **k: None):
            yield
        return
    from pvderx_torch.env import core

    step = core.step

    def broken(cfg, st, action, p_pack=None):
        st1, *rest = step(cfg, st, action, p_pack)
        return (dataclasses.replace(st1, y=st.y), *rest)

    with patched(core, "step", broken):
        yield


@contextlib.contextmanager
def half_batch(cell):
    import torch

    if cell.traffic["driver"] == "ppo":
        from pvderx_torch.learn import ppo

        n_mb = int(cell.traffic["ppo"]["n_minibatch"])

        def randperm(n, **kw):
            perm = torch.randperm(n, **kw).reshape(n_mb, -1)
            half = perm.shape[1] // 2
            return torch.cat([perm[:, :half], perm[:, :perm.shape[1] - half]],
                             1).reshape(-1)

        proxy = types.ModuleType("torch")
        proxy.__dict__.update(torch.__dict__)
        proxy.randperm = randperm
        with patched(ppo, "torch", proxy):
            yield
        return
    from pvderx_torch.env import core

    window = core.rk4_window_batch

    def broken(y, *args, **kw):
        y1 = window(y, *args, **kw)
        half = y.shape[0] // 2
        return torch.cat([y1[:half], y[half:]])

    with patched(core, "rk4_window_batch", broken):
        yield


@contextlib.contextmanager
def altered(cell):
    from pvderx_torch.env import core

    reward = core._reward
    with patched(core, "_reward", lambda *a: reward(*a) + 1e-3):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
