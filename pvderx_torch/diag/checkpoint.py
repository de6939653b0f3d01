"""Checkpoint and resume of a whole training runner: the counterpart of
`pvderx/diag/checkpoint.py`.

`save` writes one `torch.save` file of plain containers, keyed by field
path through the runner's nested dataclasses (the env state, the replay,
the event tables): the tensors, the ``state_dict`` of every `nn.Module`
and `torch.optim.Optimizer`, every `torch.Generator`'s state (its
``get_state()`` bytes) and the int, float, bool and str fields. So the file
loads under ``torch.load(weights_only=True)``, which refuses a pickled
generator.

`restore` loads it into a runner of ``target``'s structure and device:
modules and optimizers by ``load_state_dict`` and generators by
``set_state`` (in place, so each optimizer keeps its parameters), tensors
as new tensors, except a tensor that requires grad (a parameter an
optimizer holds, such as SAC's ``log_alpha``), which is copied into in
place. Resumed training is bitwise equal to the saved runner's.
"""
from __future__ import annotations

import dataclasses
import os

import torch

_SCALARS = (int, float, bool, str, type(None))


def _flatten(obj, path: str, out: dict) -> None:
    if isinstance(obj, torch.Tensor):
        out["tensors"][path] = obj.detach().cpu()
    elif isinstance(obj, torch.nn.Module):
        out["modules"][path] = {k: v.detach().cpu()
                                for k, v in obj.state_dict().items()}
    elif isinstance(obj, torch.optim.Optimizer):
        out["optimizers"][path] = _to_cpu(obj.state_dict())
    elif isinstance(obj, torch.Generator):
        out["generators"][path] = obj.get_state()
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _flatten(getattr(obj, f.name), f"{path}.{f.name}", out)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(v, f"{path}.{k}", out)
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            _flatten(v, f"{path}.{i}", out)
    elif isinstance(obj, _SCALARS):
        out["scalars"][path] = obj
    else:
        raise TypeError(
            f"checkpoint: cannot save {path} ({type(obj).__name__})")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def plain(runner) -> dict:
    """What `save` writes: {"tensors", "modules", "optimizers",
    "generators", "scalars"}, each keyed by field path, every tensor on the
    CPU."""
    out = {k: {} for k in ("tensors", "modules", "optimizers", "generators",
                           "scalars")}
    _flatten(runner, "", out)
    return out


def save(path: str, runner) -> str:
    """Write ``runner`` (any nesting of the types above) to ``path``."""
    path = os.path.abspath(path)
    torch.save(plain(runner), path)
    return path


def _rebuild(obj, path: str, saved: dict):
    if isinstance(obj, torch.Tensor):
        t = saved["tensors"][path]
        if obj.requires_grad:
            with torch.no_grad():
                obj.copy_(t)
            return obj
        return t.to(obj.device)
    if isinstance(obj, (torch.nn.Module, torch.optim.Optimizer)):
        obj.load_state_dict(saved["modules" if isinstance(obj, torch.nn.Module)
                                  else "optimizers"][path])
        return obj
    if isinstance(obj, torch.Generator):
        obj.set_state(saved["generators"][path])
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _rebuild(getattr(obj, f.name), f"{path}.{f.name}", saved)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, dict):
        return {k: _rebuild(v, f"{path}.{k}", saved) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_rebuild(v, f"{path}.{i}", saved)
                         for i, v in enumerate(obj))
    return saved["scalars"][path]


def restore(path: str, target):
    """The runner saved at ``path``, rebuilt on ``target``: its modules,
    optimizers, generators and grad-requiring tensors are loaded in place
    and returned in the new runner; every other tensor is new, on the
    device of ``target``'s tensor at the same path."""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    return _rebuild(target, "", saved)


__all__ = ["plain", "save", "restore"]
