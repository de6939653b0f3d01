"""Human-readable state pretty-printer (the counterpart of
`pvderx/utils/printing.py`): the DER's phasor states, powers and controller
internals in engineering units, for inspection and debugging.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pvderx_torch.params import DERParams, Exog
from pvderx_torch.physics import rhs_core


def _host(tree):
    """The dataclass with every tensor leaf as a Python float (0-d or
    one-element leaves: one DER)."""
    return dataclasses.replace(tree, **{
        f.name: float(v) for f in dataclasses.fields(tree)
        for v in [getattr(tree, f.name)] if isinstance(v, torch.Tensor)})


def show_states(y, p: DERParams, u: Exog, t: float = 0.0, file=None) -> str:
    """Format (and print) the state vector like the reference's
    `show_PV_DER_states`: per-phase phasors in per-unit and SI, the shared
    scalar states and the derived powers. ``y`` [n_s] (tensor or array);
    ``p``/``u`` of one DER. The algebra runs in float64 numpy. Returns the
    formatted string."""
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu()
    y = np.asarray(y, dtype=np.float64)
    p, u = _host(p), _host(u)
    n = p.n_ph
    names = "abc"[:n]
    g = rhs_core.algebra(y, float(t), p, u, np)
    i, x, uf, vdc, xdc, xq, xpll, theta = rhs_core.unpack(y, n)

    def mag_ang(re, im):
        return float(np.hypot(re, im)), float(np.degrees(np.arctan2(im, re)))

    L = [f"--- PV-DER states @ t={float(t):.4f}s "
         f"({n}-phase, {p.s_rated/1e3:.0f} kVA"
         + (", constant-Vdc variant" if float(p.const_vdc) else "")
         + ") ---"]
    for k, ph in enumerate(names):
        im, ia = mag_ang(i.re[k], i.im[k])
        vm, va = mag_ang(np.asarray(g.v.re)[k], np.asarray(g.v.im)[k])
        mm, _ = mag_ang(np.asarray(g.m.re)[k], np.asarray(g.m.im)[k])
        L.append(
            f"  phase {ph}: i = {im:.4f} pu ∠{ia:7.2f}°"
            f" ({im * p.i_base:8.2f} A peak) | v_pcc = {vm:.4f} pu ∠{va:7.2f}°"
            f" | m = {mm:.4f}")
    L.append(f"  Vdc = {float(vdc):.4f} pu ({float(vdc) * p.vdc_base:7.1f} V)"
             f" | xDC = {float(xdc):+.4f} | xQ = {float(xq):+.4f}"
             f" | xPLL = {float(xpll):+.4f} | θ = {float(theta):+.3f} rad")
    L.append(f"  P_pcc = {float(g.p_pcc):+.4f} pu "
             f"({float(g.p_pcc) * p.s_rated / 1e3:+8.2f} kW)"
             f" | Q_pcc = {float(g.q_pcc):+.4f} pu"
             f" ({float(g.q_pcc) * p.s_rated / 1e3:+8.2f} kVAr)")
    L.append(f"  P_pv  = {float(g.p_pv):+.4f} pu | "
             f"P_inv = {float(g.p_inv):+.4f} pu"
             f" | f = {float(g.f_meas) * 60.0:7.3f} Hz")
    s = "\n".join(L)
    print(s, file=file)
    return s
