"""Frozen dataclasses of tensors, and a map over their tensor leaves.

Every configuration and state container of the port is a frozen dataclass.
Fields that hold tensors are the leaves; every other field (an ``int`` such as
``n_ph``, a ``bool`` flag, a string) is static and passes through unchanged.
"""
from __future__ import annotations

import dataclasses

import torch


struct = dataclasses.dataclass(frozen=True)   # the port's container type


replace = dataclasses.replace


def tree_map(fn, obj, *others):
    """Apply ``fn`` to every tensor leaf of ``obj`` (and the matching leaves
    of ``others``, which share its structure), recursing into nested
    dataclasses. Non-tensor fields are taken from ``obj``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj, *others)
    if dataclasses.is_dataclass(obj):
        kw = {f.name: tree_map(fn, getattr(obj, f.name),
                               *(getattr(o, f.name) for o in others))
              for f in dataclasses.fields(obj)}
        return type(obj)(**kw)
    return obj
