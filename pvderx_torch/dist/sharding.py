"""Placing a runner over the mesh: env batches split, the rest replicated.

The port of `pvderx/dist/sharding.py`. Where the reference attaches a
``NamedSharding`` to each leaf and lets GSPMD move the data, a rank here
keeps the rows of its own envs (`shard_batch`) and holds a copy of the
learner (`replicate`, broadcast from rank 0).
"""
from __future__ import annotations

import dataclasses

import torch

from pvderx_torch.dist.mesh import ENV_AXIS, Mesh

# a runner's env fields, each with its env axis (the params pack is
# [29, N] or [29, N, M]: fields first)
ENV_FIELDS = {"env_state": 0, "obs": 0, "p_pack": 1, "replay": 0}


def env_sharding(mesh: Mesh, n_global: int) -> slice:
    """This rank's rows of a ``[n_global, ...]`` env batch (raises when the
    env axis does not divide it)."""
    return mesh.rows(n_global)


def shard_batch(tree, mesh: Mesh, axis: int = 0):
    """This rank's rows of every ``[N_global, ...]`` tensor in ``tree``
    (tensors, nested dataclasses, tuples, lists, dicts), on the mesh's
    device; ``axis`` is the env axis when it is not the leading one. 0-d
    tensors (counters) stay whole; an object with a
    ``__shard_batch__(mesh)`` method (the replay) shards itself; other
    fields pass through."""
    if isinstance(tree, torch.Tensor):
        if tree.dim() == 0:
            return tree.to(mesh.device)
        sl = mesh.rows(tree.shape[axis])
        return tree.narrow(axis, sl.start, sl.stop - sl.start).to(
            mesh.device).contiguous()       # the kernels take contiguous
    if hasattr(tree, "__shard_batch__"):
        return tree.__shard_batch__(mesh)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: shard_batch(getattr(tree, f.name), mesh, axis)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(v, mesh, axis) for v in tree)
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in tree.items()}
    return tree


def _copy_bcast(t: torch.Tensor, mesh: Mesh) -> None:
    with torch.no_grad():
        t.copy_(mesh.broadcast(t))


def replicate(tree, mesh: Mesh):
    """Rank 0's copy of ``tree`` on every rank: `nn.Module` parameters and
    buffers and optimizer state in place, generator states by
    ``set_state``, tensors broadcast (a tensor that requires grad, a
    parameter an optimizer holds, in place); nested dataclasses, tuples,
    lists and dicts field by field. Plain Python fields are left as they
    are."""
    if isinstance(tree, torch.nn.Module):
        for t in [*tree.parameters(), *tree.buffers()]:
            _copy_bcast(t, mesh)
        return tree
    if isinstance(tree, torch.optim.Optimizer):
        for st in tree.state.values():
            for v in st.values():
                if isinstance(v, torch.Tensor):
                    _copy_bcast(v, mesh)
        return tree
    if isinstance(tree, torch.Generator):
        tree.set_state(mesh.broadcast(tree.get_state()))
        return tree
    if isinstance(tree, torch.Tensor):
        if tree.requires_grad:
            _copy_bcast(tree, mesh)
            return tree
        return mesh.broadcast(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: replicate(getattr(tree, f.name), mesh)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(v, mesh) for v in tree)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    return tree


def shard_runner(runner, mesh: Mesh, env_fields=ENV_FIELDS):
    """A learner runner over the mesh: its env fields (``env_state``,
    ``obs``, the params pack, the replay; a dict of field -> env axis)
    sharded by `shard_batch`, everything else replicated from rank 0 (DP
    over envs, the gradient all-reduced by the learner)."""
    return dataclasses.replace(runner, **{
        f.name: (shard_batch(v, mesh, env_fields[f.name])
                 if f.name in env_fields else replicate(v, mesh))
        for f in dataclasses.fields(runner)
        for v in [getattr(runner, f.name)]})


__all__ = ["ENV_AXIS", "ENV_FIELDS", "env_sharding", "shard_batch",
           "replicate", "shard_runner"]
