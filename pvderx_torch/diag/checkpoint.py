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

Over a mesh (`pvderx_torch.dist`), ``save(path, runner, mesh)`` makes
``path`` a directory: global rank 0 writes the replicated fields to
``path/replicated.pt`` (tensor-parallel parameters and their optimizer
moments gathered whole), and model-rank 0 of each env index ``r`` writes
that index's env shard (`dist.sharding.ENV_FIELDS`) to
``path/rank{r}-of-{W}.pt``, ``W`` the env-axis size (the per-host shards
of the reference's checkpoint). ``restore(path, target, mesh)`` reads the
replicated file and this rank's env shard, and slices what ``target``
holds tensor-parallel to its layout: the env-axis size must be the one
saved, the model-axis size may be any. So a DP checkpoint restores onto an
``("env", "model")`` runner and continues.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from pvderx_torch.dist.mesh import ENV_AXIS
from pvderx_torch.dist.sharding import ENV_FIELDS
from pvderx_torch.dist.tp import MODEL_AXIS, gather_param, local_shard

_SCALARS = (int, float, bool, str, type(None))
_REPLICATED = "replicated.pt"


def _opt_params(opt: torch.optim.Optimizer) -> list:
    """The optimizer's parameters in its ``state_dict`` index order."""
    return [p for g in opt.param_groups for p in g["params"]]


def _module_state(mod: torch.nn.Module, mesh) -> dict:
    params = dict(mod.named_parameters())
    return {k: (gather_param(v.detach(), params[k], mesh) if k in params
                and mesh is not None else v.detach()).cpu()
            for k, v in mod.state_dict().items()}


def _opt_state(opt: torch.optim.Optimizer, mesh) -> dict:
    sd = opt.state_dict()
    if mesh is not None:
        params = _opt_params(opt)
        sd["state"] = {i: {k: gather_param(v, params[i], mesh)
                           if isinstance(v, torch.Tensor) else v
                           for k, v in st.items()}
                       for i, st in sd["state"].items()}
    return _to_cpu(sd)


def _flatten(obj, path: str, out: dict, mesh=None) -> None:
    if isinstance(obj, torch.Tensor):
        out["tensors"][path] = obj.detach().cpu()
    elif isinstance(obj, torch.nn.Module):
        out["modules"][path] = _module_state(obj, mesh)
    elif isinstance(obj, torch.optim.Optimizer):
        out["optimizers"][path] = _opt_state(obj, mesh)
    elif isinstance(obj, torch.Generator):
        out["generators"][path] = obj.get_state()
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _flatten(getattr(obj, f.name), f"{path}.{f.name}", out, mesh)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(v, f"{path}.{k}", out, mesh)
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            _flatten(v, f"{path}.{i}", out, mesh)
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


def plain(runner, fields=None, mesh=None) -> dict:
    """What `save` writes: {"tensors", "modules", "optimizers",
    "generators", "scalars"}, each keyed by field path, every tensor on the
    CPU. ``fields``: only these top-level fields of the runner. ``mesh``:
    tensor-parallel parameters and moments gathered whole (a collective:
    every rank of the mesh calls it)."""
    out = {k: {} for k in ("tensors", "modules", "optimizers", "generators",
                           "scalars")}
    if fields is None:
        _flatten(runner, "", out, mesh)
    else:
        for f in fields:
            _flatten(getattr(runner, f), f".{f}", out, mesh)
    return out


def _env_file(path: str, r: int, w: int) -> str:
    return os.path.join(path, f"rank{r}-of-{w}.pt")


def _split(runner):
    names = [f.name for f in dataclasses.fields(runner)]
    return ([n for n in names if n not in ENV_FIELDS],
            [n for n in names if n in ENV_FIELDS])


def save(path: str, runner, mesh=None) -> str:
    """Write ``runner`` (any nesting of the types above) to ``path``; over
    a ``mesh``, the directory of the module docstring (every rank calls
    it)."""
    path = os.path.abspath(path)
    if mesh is None:
        if dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError("checkpoint.save under a process group of "
                             f"{dist.get_world_size()} ranks needs its mesh")
        torch.save(plain(runner), path)
        return path
    rep_fields, env_fields = _split(runner)
    rep = plain(runner, rep_fields, mesh)
    rep["mesh"] = {ENV_AXIS: mesh.size(ENV_AXIS)}
    os.makedirs(path, exist_ok=True)
    if dist.get_rank() == 0:
        torch.save(rep, os.path.join(path, _REPLICATED))
    model_rank = (mesh.coord(MODEL_AXIS) if MODEL_AXIS in mesh.axis_names
                  else 0)
    if model_rank == 0:
        torch.save(plain(runner, env_fields),
                   _env_file(path, mesh.coord(ENV_AXIS), mesh.size(ENV_AXIS)))
    dist.barrier()
    return path


def _rebuild(obj, path: str, saved: dict):
    if isinstance(obj, torch.Tensor):
        t = saved["tensors"][path]
        if obj.requires_grad:
            with torch.no_grad():
                obj.copy_(t)
            return obj
        return t.to(obj.device)
    if isinstance(obj, torch.nn.Module):
        params = dict(obj.named_parameters())
        obj.load_state_dict({k: local_shard(v, params[k]) if k in params
                             else v
                             for k, v in saved["modules"][path].items()})
        return obj
    if isinstance(obj, torch.optim.Optimizer):
        sd, params = saved["optimizers"][path], _opt_params(obj)
        sd = dict(sd, state={i: {k: local_shard(v, params[i])
                                 if isinstance(v, torch.Tensor) else v
                                 for k, v in st.items()}
                             for i, st in sd["state"].items()})
        obj.load_state_dict(sd)
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


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore(path: str, target, mesh=None):
    """The runner saved at ``path``, rebuilt on ``target``: its modules,
    optimizers, generators and grad-requiring tensors are loaded in place
    and returned in the new runner; every other tensor is new, on the
    device of ``target``'s tensor at the same path. A tensor-parallel
    parameter of ``target`` (and its moments) takes its shard of the saved
    whole. ``mesh``: a checkpoint saved over a mesh of the same env-axis
    size (raises ``ValueError`` naming both sizes otherwise)."""
    path = os.path.abspath(path)
    if mesh is None:
        if os.path.isdir(path):
            raise ValueError(f"{path} was saved over a mesh: restore it "
                             "with that mesh")
        return _rebuild(target, "", _load(path))
    saved = _load(os.path.join(path, _REPLICATED))
    w_saved, w = saved.pop("mesh")[ENV_AXIS], mesh.size(ENV_AXIS)
    if w_saved != w:
        raise ValueError(
            f"checkpoint {path} was saved over an '{ENV_AXIS}' axis of size "
            f"{w_saved}; this mesh's is {w}: restore onto the same env-axis "
            "size")
    shard = _load(_env_file(path, mesh.coord(ENV_AXIS), w))
    for k in saved:
        saved[k].update(shard[k])
    return _rebuild(target, "", saved)


__all__ = ["plain", "save", "restore"]
