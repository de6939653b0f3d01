"""Array namespaces the frozen reference runs on.

`rhs_core` (the frozen physics) is written against a numpy-like module
``xp``; `env` (the frozen step glue) adds a few more functions. Two
namespaces give that surface:

- `NumpyXP`: numpy bound to a dtype (float64 for the reference, float32 for
  the clock and the event tables, which follow the configuration's dtype);
- `TorchXP`: torch bound to a dtype and device (bfloat16 for the control,
  float32 on the CPU for the operation count of `roofline`). Its
  ``maximum``/``minimum`` take a Python float on either side, as numpy's do
  (a copy of the port's `pvderx_torch/physics/xp.py`, with the glue's
  functions added).
"""
from __future__ import annotations

import numpy as np
import torch


class NumpyXP:
    """numpy functions with constants made in ``dtype``."""

    backend = "numpy"

    def __init__(self, dtype=np.float64):
        self.dtype = np.dtype(dtype)

    sqrt = staticmethod(np.sqrt)
    exp = staticmethod(np.exp)
    sin = staticmethod(np.sin)
    cos = staticmethod(np.cos)
    maximum = staticmethod(np.maximum)
    minimum = staticmethod(np.minimum)
    abs = staticmethod(np.abs)
    hypot = staticmethod(np.hypot)

    def mean(self, x, axis=0, keepdims=False):
        return np.mean(x, axis=axis, keepdims=keepdims)

    def stack(self, seq, axis=0):
        return np.stack([np.asarray(s) for s in seq], axis=axis)

    def concatenate(self, seq, axis=0):
        return np.concatenate(seq, axis=axis)

    def zeros(self, shape, dtype=None):
        return np.zeros(shape, dtype=dtype or self.dtype)

    def full(self, shape, value, dtype=None):
        return np.full(shape, value, dtype=dtype or self.dtype)

    def asarray(self, obj, dtype=None):
        return np.asarray(obj, dtype=dtype or self.dtype)

    def scalar(self, value):
        """A 0-d value in this dtype (rounded once, as a typed constant)."""
        return self.dtype.type(value)

    def where(self, c, a, b):
        return np.where(c, a, b)

    def clip(self, x, lo, hi):
        return np.clip(x, self.scalar(lo), self.scalar(hi))

    def amax(self, x, axis=-1):
        return np.max(x, axis=axis)

    def amin(self, x, axis=-1):
        return np.min(x, axis=axis)

    def fsum(self, x, axis=-1):
        return np.sum(x, axis=axis)

    def remainder(self, x, m):
        return np.remainder(x, self.scalar(m))

    def cast(self, x):
        """``x`` in this namespace's dtype."""
        return np.asarray(x).astype(self.dtype)


class TorchXP:
    """torch functions over tensors, bound to a dtype and device."""

    backend = "torch"

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

    def abs(self, x):
        return torch.abs(self._t(x))

    def hypot(self, a, b):
        return torch.hypot(self._t(a), self._t(b))

    def mean(self, x, axis=0, keepdims=False):
        return torch.mean(x, dim=axis, keepdim=keepdims)

    def maximum(self, a, b):
        return _minmax(a, b, torch.maximum, "min")

    def minimum(self, a, b):
        return _minmax(a, b, torch.minimum, "max")

    def stack(self, seq, axis=0):
        return torch.stack([self._t(s) for s in seq], dim=axis)

    def concatenate(self, seq, axis=0):
        return torch.cat([self._t(s) for s in seq], dim=axis)

    def zeros(self, shape, dtype=None):
        return torch.zeros(_shape(shape), dtype=dtype or self.dtype,
                           device=self.device)

    def full(self, shape, value, dtype=None):
        return torch.full(_shape(shape), value, dtype=dtype or self.dtype,
                          device=self.device)

    def asarray(self, obj, dtype=None):
        return torch.as_tensor(obj, dtype=dtype or self.dtype,
                               device=self.device)

    def scalar(self, value):
        return torch.tensor(value, dtype=self.dtype, device=self.device)

    def where(self, c, a, b):
        return torch.where(c, self._t(a), self._t(b))

    def clip(self, x, lo, hi):
        return torch.clamp(x, lo, hi)

    def amax(self, x, axis=-1):
        return torch.amax(x, dim=axis)

    def amin(self, x, axis=-1):
        return torch.amin(x, dim=axis)

    def fsum(self, x, axis=-1):
        return torch.sum(x, dim=axis)

    def remainder(self, x, m):
        return torch.remainder(x, m)

    def cast(self, x):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(self.dtype).to(self.device)


def _shape(shape):
    return tuple(shape) if isinstance(shape, (tuple, list, torch.Size)) \
        else (shape,)


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


def to_numpy(x) -> np.ndarray:
    """Any array of either namespace as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)
