"""The torch array namespace that `rhs_core` runs on.

`rhs_core` is written against a numpy-like module ``xp``. This namespace gives
it that surface over torch tensors, with two differences from calling torch
directly:

- constants it creates (``zeros``, ``asarray``) take the namespace's dtype
  and device, so a float64 evaluation gets float64 angle tables (numpy's
  default) and a card evaluation gets its constants on the card;
- ``maximum``/``minimum`` accept a Python float on either side (torch's own
  reject it), and ``mean`` takes numpy's ``axis=`` and ``keepdims=``.
"""
from __future__ import annotations

import torch


class TorchXP:
    """numpy-like functions over torch tensors, bound to a dtype and device."""

    def __init__(self, dtype=torch.float64, device="cpu"):
        self.dtype = dtype
        self.device = torch.device(device)

    def _t(self, x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def sqrt(self, x):
        return torch.sqrt(self._t(x))

    def exp(self, x):
        return torch.exp(self._t(x))

    def sin(self, x):
        return torch.sin(self._t(x))

    def cos(self, x):
        return torch.cos(self._t(x))

    def mean(self, x, axis=0, keepdims=False):
        return torch.mean(x, dim=axis, keepdim=keepdims)

    def maximum(self, a, b):
        return _minmax(a, b, torch.maximum, "min")

    def minimum(self, a, b):
        return _minmax(a, b, torch.minimum, "max")

    def stack(self, seq):
        return torch.stack([self._t(s) for s in seq])

    def concatenate(self, seq):
        return torch.cat([self._t(s) for s in seq])

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or self.dtype, device=self.device)

    def asarray(self, obj, dtype=None):
        return torch.as_tensor(obj, dtype=dtype or self.dtype,
                               device=self.device)


def _minmax(a, b, both, clamp_kw):
    """Elementwise max/min where either side may be a Python number."""
    ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
    if ta and tb:
        return both(a, b)
    if ta:
        return torch.clamp(a, **{clamp_kw: b})
    if tb:
        return torch.clamp(b, **{clamp_kw: a})
    return max(a, b) if clamp_kw == "min" else min(a, b)


def like(t: torch.Tensor) -> TorchXP:
    """The namespace bound to ``t``'s dtype and device."""
    return TorchXP(t.dtype, t.device)
