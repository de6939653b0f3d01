"""Debug mode and a checked env step: the counterpart of `pvderx/diag/debug.py`.

- `debug_mode()`: a `TorchDispatchMode` that traps the first NaN (after
  every aten op with a floating output) and any op that mixes floating
  tensors of two dtypes, the counterparts of ``jax_debug_nans`` and strict
  dtype promotion. It traps NaN only, not inf (the event tables are padded
  with +inf), and lets Python scalars mix (JAX's weak types). The dispatch
  mode cannot see inside the window kernels' ctypes launches, so while the
  trap is on the launchers check their own outputs
  (`ops.window.check_outputs` reads the mode's ``traps_nans``). The trap reads every output on the host:
  a debugging aid, not a fast path.
- `checked_step(cfg)`: the batched env step with its state checked on the
  device (finite, Vdc inside a physical band), the flags returned beside
  the outputs instead of synced inside the step; ``error.throw()`` raises
  naming the first bad env.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ops whose output is uninitialized memory (a NaN there is garbage, not a
# result) or that convert dtypes on purpose
_UNINITIALIZED = {"empty", "empty_like", "empty_strided", "new_empty"}
_CONVERSIONS = {"_to_copy", "copy_", "copy"}


class PromotionError(RuntimeError):
    """An op mixed floating dtypes under debug_mode's strict dtypes (not a
    TypeError: torch's operators turn those into NotImplemented)."""


class _DebugMode(TorchDispatchMode):
    def __init__(self, nans: bool, strict_dtypes: bool):
        super().__init__()
        self.traps_nans = nans        # read by the kernels' launchers too
        self.strict_dtypes = strict_dtypes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if self.strict_dtypes and name not in _CONVERSIONS:
            dtypes = {a.dtype for a in tree_flatten((args, kwargs))[0]
                      if isinstance(a, torch.Tensor) and a.is_floating_point()}
            if len(dtypes) > 1:
                raise PromotionError(f"{func} mixes floating dtypes "
                                     f"{sorted(str(d) for d in dtypes)} "
                                     f"(strict dtypes: cast explicitly)")
        out = func(*args, **kwargs)
        if self.traps_nans and name not in _UNINITIALIZED:
            for o in tree_flatten(out)[0]:
                if (isinstance(o, torch.Tensor)
                        and (o.is_floating_point() or o.is_complex())
                        and bool(torch.isnan(o).any())):
                    raise FloatingPointError(f"NaN in the output of {func}")
        return out


def debug_mode(nans: bool = True, strict_dtypes: bool = True) -> _DebugMode:
    """A context that traps NaNs and mixed floating dtypes in its block; the
    dispatch mode is popped on exit, also on an exception.

    >>> with debug_mode():
    ...     step_batch(state, actions, generator)   # raises at the first NaN
    """
    return _DebugMode(nans, strict_dtypes)


class CheckError(RuntimeError):
    """A check of `checked_step` failed."""


@dataclasses.dataclass(frozen=True)
class StepError:
    """Per-env flags of one checked step, on the step's device."""

    nonfinite: torch.Tensor   # [N] bool: a state entry is not finite
    vdc_out: torch.Tensor     # [N] bool: Vdc outside the band

    def get(self) -> str | None:
        """The first failed check's message (one host fetch), or None."""
        flags = torch.stack([self.nonfinite, self.vdc_out]).cpu()
        for row, what in zip(flags, ("non-finite state after step",
                                     "Vdc left the physical band")):
            bad = torch.nonzero(row).flatten()
            if len(bad):
                return (f"{what}: env {int(bad[0])} ({len(bad)} of "
                        f"{len(row)} envs)")
        return None

    def throw(self) -> None:
        msg = self.get()
        if msg is not None:
            raise CheckError(msg)


def checked_step(cfg, vdc_band=(0.05, 3.0)):
    """`env.core.step` of every env with its state checked after the step:
    returns ``step_fn(state, action, p_pack=None) -> (error, (state', obs,
    reward, done, info))``; the checks are device tensors (no sync in the
    step), ``error.throw()`` raises `CheckError` host-side."""
    from pvderx_torch.env import core

    lo, hi = vdc_band
    i_vdc = 6 * cfg.der.n_ph

    def stepper(st, action, p_pack=None):
        out = core.step(cfg, st, action, p_pack)
        y = out[0].y
        vdc = y[:, i_vdc]
        return StepError(nonfinite=~torch.isfinite(y).all(dim=-1),
                         vdc_out=~((vdc > lo) & (vdc < hi))), out

    return stepper


__all__ = ["debug_mode", "checked_step", "StepError", "CheckError",
           "PromotionError"]
