"""The physics core and its torch bindings (the counterpart of
`pvderx/physics/__init__.py`).

`rhs_core` is written against a numpy-like namespace and puts the state
axis first (``y [n_s]`` for one env, ``[n_s, N]`` for a batch); the
bindings below evaluate it on torch tensors through `TorchXP`, bound to the
dtype and device of their tensor inputs.
"""
from __future__ import annotations

import dataclasses

import torch

from pvderx_torch.ode.implicit import rhs_and_jacobian
from pvderx_torch.physics import rhs_core
from pvderx_torch.physics.rhs_core import Algebra, unpack
from pvderx_torch.physics.xp import TorchXP, like


def _xp(*xs) -> TorchXP:
    """The namespace of the first tensor among ``xs`` and, for a dataclass
    among them, its leaves (float64 on the CPU if there is none)."""
    for x in xs:
        if dataclasses.is_dataclass(x):
            x = next((getattr(x, f.name) for f in dataclasses.fields(x)
                      if isinstance(getattr(x, f.name), torch.Tensor)), None)
        if isinstance(x, torch.Tensor):
            return like(x)
    return TorchXP()


def rhs(y, t, p, u):
    """dy/dt (SPEC.md §5)."""
    return rhs_core.rhs(y, t, p, u, like(y))


def rhs_jacobian(y, t, p, u):
    """∂(dy/dt)/∂y, the [n_s, n_s] system Jacobian of one env's state
    y [n_s] (the analog of the reference's hand-written `jac_ODE_model`),
    exact forward-mode differentiation of the RHS by the complex step
    (`ode.implicit.rhs_and_jacobian`) where the reference takes
    `jax.jacfwd`."""
    xp = like(y)
    f = lambda yc: rhs_core.rhs(yc.movedim(-1, 0), t, p, u, xp).movedim(0, -1)
    return rhs_and_jacobian(f, y[None])[1][0]


def algebra(y, t, p, u) -> Algebra:
    """Algebraic measurements (SPEC.md §4)."""
    return rhs_core.algebra(y, t, p, u, like(y))


def pv_power(vdc, s_irr, t_cell, p):
    return rhs_core.pv_power(vdc, s_irr, t_cell, p,
                             _xp(vdc, s_irr, t_cell, p))


def steady_state_guess(p, u):
    return rhs_core.steady_state_guess(p, u, _xp(p, u))


__all__ = ["rhs_core", "TorchXP", "like", "rhs", "rhs_jacobian", "algebra",
           "pv_power", "steady_state_guess", "Algebra", "unpack"]
