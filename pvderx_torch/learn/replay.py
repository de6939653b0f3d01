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
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Replay:
    """Circular replay as one packed matrix (see the module docstring)."""

    data: torch.Tensor   # [capacity, row_dim]
    ptr: int = 0
    size: int = 0


def make_replay(capacity: int, row_dim: int, dtype, device) -> Replay:
    return Replay(data=torch.zeros(capacity, row_dim, dtype=dtype,
                                   device=device))


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
    return Replay(data=rp.data, ptr=(rp.ptr + n) % capacity,
                  size=min(rp.size + n, capacity))


def sample_rows(rp: Replay, generator: torch.Generator,
                batch_size: int) -> torch.Tensor:
    """A uniform sample of ``[batch_size, row_dim]`` packed rows from the
    filled slots ``[0, max(size, 1))`` (one wide gather)."""
    idx = torch.randint(0, max(rp.size, 1), (batch_size,), generator=generator,
                        device=rp.data.device)
    return rp.data[idx]


__all__ = ["Replay", "make_replay", "insert_rows", "sample_rows"]
