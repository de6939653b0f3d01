"""M inverters on a shared feeder (BASELINE config 5; SPEC.md §11).

The units couple only through the shared PCC voltage: the feeder KCL uses
the **mean** per-unit injection (currents in per-unit of the aggregate base
M·S_base, so M identical units at 1 pu each inject 1 pu aggregate). The
per-DER physics is `rhs_core.rhs_given_v`; only the coupling is here.

Layout: the unit axis M is the LAST axis of every leaf. A fleet state is
``[n_s, *batch, M]`` (field-major, as `rhs_core` expects), params and exog
leaves are ``[*batch, M]``, and a time broadcasts against ``[*batch, 1]``.
`rhs_core` is batch-transparent over trailing axes, so every unit is
evaluated at once with no loop over M. The functions are generic over the
array namespace ``xp``: `TorchXP` for the port, ``numpy`` for the oracle
(`pvderx_torch.oracle`). The feeder's fields (grid source, grid impedance,
load) are read from unit 0.
"""
from __future__ import annotations

import dataclasses

import torch

from pvderx_torch.params import DERParams, Exog
from pvderx_torch.physics.rhs_core import (
    C, algebra_given_v, cscale, pcc_voltage, rhs_given_v, steady_state_guess)
from pvderx_torch.physics.xp import TorchXP


def shared(tree):
    """Unit 0 of every ``[..., M]`` leaf, kept as ``[..., 1]``: the feeder."""
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name)[..., 0:1]
        for f in dataclasses.fields(tree)
        if getattr(getattr(tree, f.name), "ndim", 0) > 0})


def fleetify(tree, m: int):
    """Broadcast every ``[...]`` tensor leaf of a params/exog dataclass to
    ``[..., M]`` (an expanded view)."""
    return dataclasses.replace(tree, **{
        f.name: getattr(tree, f.name).unsqueeze(-1).expand(
            *getattr(tree, f.name).shape, m)
        for f in dataclasses.fields(tree)
        if isinstance(getattr(tree, f.name), torch.Tensor)})


def mean_injection(Y, fu, n_ph: int, xp) -> C:
    """The mean over the M units of conn·i, ``[n_ph, *batch, 1]``."""
    return C(xp.mean(fu.conn * Y[0:n_ph], axis=-1, keepdims=True),
             xp.mean(fu.conn * Y[n_ph:2 * n_ph], axis=-1, keepdims=True))


def fleet_pcc_voltage(Y, t, fp, fu, xp) -> C:
    """Shared PCC voltage ``[n_ph, *batch, 1]`` from the mean per-unit
    injection of all M units."""
    return pcc_voltage(mean_injection(Y, fu, fp.n_ph, xp), t, shared(fp),
                       shared(fu), xp)


def fleet_rhs(Y, t, fp, fu, xp):
    """dY/dt of the fleet; Y ``[n_s, *batch, M]``, fp/fu leaves
    ``[*batch, M]``, t broadcastable to ``[*batch, 1]``."""
    v = fleet_pcc_voltage(Y, t, fp, fu, xp)
    return rhs_given_v(Y, t, fp, fu, v, xp)


def fleet_algebra(Y, t, fp, fu, xp):
    """Per-unit `Algebra` at the shared PCC voltage (per-unit leaves
    ``[*batch, M]``; the PCC quantities v, v_pos ``[..., *batch, 1]``)."""
    v = fleet_pcc_voltage(Y, t, fp, fu, xp)
    return algebra_given_v(Y, t, fp, fu, v, xp)


_P = [f.name for f in dataclasses.fields(DERParams) if f.name != "n_ph"]
_U = [f.name for f in dataclasses.fields(Exog)]


def fleet_guess(fp, fu):
    """Stacked single-DER steady-state guesses ``[n_s, *batch, M]`` (weak
    coupling -> a good Newton start). Torch leaves ``[*batch, M]``."""
    shape = fp.rf.shape
    xp = TorchXP(fp.rf.dtype, fp.rf.device)
    pk = torch.stack([getattr(fp, f).reshape(-1) for f in _P], -1)
    uk = torch.stack([getattr(fu, f).reshape(-1) for f in _U], -1)

    def one(pv, uv):
        p = DERParams(n_ph=fp.n_ph, **{f: pv[i] for i, f in enumerate(_P)})
        u = Exog(**{f: uv[i] for i, f in enumerate(_U)})
        return steady_state_guess(p, u, xp)

    g = torch.func.vmap(one)(pk, uk)                  # [B, n_s]
    return g.T.reshape(g.shape[-1], *shape)
