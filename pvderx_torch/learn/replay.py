"""Packed circular replay buffer, shared by the DQN and SAC learners.

The port of `pvderx.learn.replay`: one ``[capacity, row_dim]`` matrix plus a
circular ``ptr`` and ``size``. Each learner packs and unpacks its own row
layout; the buffer mechanics live here once. One wide-row scatter per insert
and one wide-row gather per sample, as in the reference.

The reference's buffer is an immutable array that each insert copies; here
`insert_rows` writes the rows into ``data`` in place (the returned `Replay`
shares it with its argument), which spares a copy of the whole buffer per
insert. ``ptr`` and ``size`` are host integers: they follow from the row
counts alone.

Under a mesh (`pvderx_torch.dist`) a rank keeps the rows of its own envs,
in the one-rank buffer's t-major order: the learners insert ``T·N`` rows
per step (T steps of N envs), so with a capacity that ``T·N`` divides,
global slot ``q·N + i`` of env ``i`` is local slot ``q·n + (i - start)``
of the rank holding env ``i`` (`dist.mesh.owned_rows`). `sample_owned`
draws the one-rank sample's global slots and returns the rows this rank
owns; ``ptr`` and ``size`` are then this rank's, ``size · W`` the global
fill.
"""
from __future__ import annotations

import dataclasses

import torch

from pvderx_torch.dist.mesh import ENV_AXIS, owned_rows


@dataclasses.dataclass(frozen=True)
class Replay:
    """Circular replay as one packed matrix (see the module docstring)."""

    data: torch.Tensor   # [capacity, row_dim]
    ptr: int = 0
    size: int = 0
    n_envs: int = 0      # global envs per inserted step (slot ownership)

    def __shard_batch__(self, mesh):
        """This rank's slots of a one-rank buffer (`dist.shard_batch`)."""
        n, w = self.n_envs, mesh.size(ENV_AXIS)
        cap = self.data.shape[0]
        if w == 1:
            return dataclasses.replace(self, data=self.data.to(mesh.device))
        if n == 0 or cap % n:
            raise ValueError(f"a replay of capacity {cap} with {n} envs per "
                             f"step does not shard over {w} ranks")
        sl = mesh.rows(n)
        per = sl.stop - sl.start
        slots = torch.arange(cap, device=self.data.device)
        mask, _ = owned_rows(slots, n, mesh)
        return Replay(data=self.data[mask].to(mesh.device),
                      ptr=self.ptr // n * per, size=self.size // n * per,
                      n_envs=n)


def make_replay(capacity: int, row_dim: int, dtype, device,
                n_envs: int = 0) -> Replay:
    return Replay(data=torch.zeros(capacity, row_dim, dtype=dtype,
                                   device=device), n_envs=n_envs)


def check_shardable(capacity: int, rows_per_insert: int, mesh) -> None:
    """Under a mesh of W > 1 env ranks, the capacity must be a multiple of
    the global rows one train step inserts (``rollout_len · n_envs``)."""
    if mesh is not None and mesh.size(ENV_AXIS) > 1 and (
            capacity % rows_per_insert):
        raise ValueError(
            f"capacity={capacity} is not a multiple of rollout_len·n_envs="
            f"{rows_per_insert}: a replay sharded over "
            f"{mesh.size(ENV_AXIS)} env ranks keeps each rank's env rows "
            "in the one-rank buffer's order, which needs whole inserts")


def insert_rows(rp: Replay, rows: torch.Tensor) -> Replay:
    """Circular write of ``[n, row_dim]`` packed rows (one wide scatter, in
    place). ``n`` may not exceed the capacity: one write would then hold a
    slot twice, and which row survived would be unspecified."""
    capacity = rp.data.shape[0]
    n = rows.shape[0]
    if n > capacity:
        raise ValueError(
            f"insert_rows: {n} rows > capacity {capacity}; shrink "
            f"rollout_len*n_envs or grow the buffer")
    idx = (rp.ptr + torch.arange(n, device=rp.data.device)) % capacity
    rp.data[idx] = rows.to(rp.data.dtype)
    return dataclasses.replace(rp, ptr=(rp.ptr + n) % capacity,
                               size=min(rp.size + n, capacity))


def sample_rows(rp: Replay, generator: torch.Generator,
                batch_size: int) -> torch.Tensor:
    """A uniform sample of ``[batch_size, row_dim]`` packed rows from the
    filled slots ``[0, max(size, 1))`` (one wide gather)."""
    idx = torch.randint(0, max(rp.size, 1), (batch_size,), generator=generator,
                        device=rp.data.device)
    return rp.data[idx]


def sample_owned(rp: Replay, generator: torch.Generator, batch_size: int,
                 mesh):
    """`sample_rows` of the global buffer under a mesh: the same global
    draw on every rank, of which this rank returns the rows it owns and the
    mask of their places in the global sample."""
    size = rp.size * mesh.size(ENV_AXIS)
    idx = torch.randint(0, max(size, 1), (batch_size,), generator=generator,
                        device=rp.data.device)
    mask, local = owned_rows(idx, rp.n_envs, mesh)
    return rp.data[local], mask


__all__ = ["Replay", "make_replay", "insert_rows", "sample_rows",
           "sample_owned", "check_shardable"]
