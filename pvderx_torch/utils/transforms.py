"""Phase, sequence and frame conversions (the counterpart of
`pvderx/utils/transforms.py:28-99`).

Generic over the array namespace ``xp`` (numpy by default, or
`pvderx_torch.physics.xp.TorchXP` for tensors), like the physics core, and
consistent with its conventions: per-unit phasors are peak-amplitude
complex pairs (:class:`pvderx_torch.physics.rhs_core.C`), phase k is
rotated by ``a_k = e^{j·[0, -2π/3, +2π/3][k]}``, the positive sequence is
``mean_k(x_k · conj(a_k))`` and the negative sequence ``mean_k(x_k · a_k)``
(`rhs_core.neg_seq`).
"""
from __future__ import annotations

import math

import numpy as np

from pvderx_torch.physics.rhs_core import (
    C, _shift_angles, cconj, cexpj, cmean, cmul)

SQRT2 = math.sqrt(2.0)
TWO_PI_3 = 2.0 * math.pi / 3.0


# ---------------------------------------------------------------------------
# RMS <-> phasor
# ---------------------------------------------------------------------------
def rms_to_phasor(v_rms, phi, xp=np) -> C:
    """RMS magnitude + angle -> peak-amplitude phasor pair (re, im)."""
    return C(SQRT2 * v_rms * xp.cos(phi), SQRT2 * v_rms * xp.sin(phi))


def phasor_to_rms(x: C, xp=np):
    """Peak-amplitude phasor -> RMS magnitude."""
    return xp.sqrt(x.re * x.re + x.im * x.im) / SQRT2


# ---------------------------------------------------------------------------
# instantaneous abc <-> rotating dq0 (Park, amplitude-invariant)
# ---------------------------------------------------------------------------
def abc_to_dq0(x_abc, theta, xp=np):
    """Amplitude-invariant Park transform.

    x_abc: [..., 3] instantaneous phase quantities; theta: rotating-frame
    angle. Returns (d, q, z): a balanced set of peak amplitude A maps to
    d² + q² = A² and z = 0.
    """
    x_abc = xp.asarray(x_abc)
    a, b, c = x_abc[..., 0], x_abc[..., 1], x_abc[..., 2]
    th_a = theta
    th_b = theta - TWO_PI_3
    th_c = theta + TWO_PI_3
    d = (2.0 / 3.0) * (a * xp.cos(th_a) + b * xp.cos(th_b) + c * xp.cos(th_c))
    q = -(2.0 / 3.0) * (a * xp.sin(th_a) + b * xp.sin(th_b) + c * xp.sin(th_c))
    z = (a + b + c) / 3.0
    return d, q, z


def dq0_to_abc(d, q, z, theta, xp=np):
    """Inverse amplitude-invariant Park transform -> [..., 3]."""
    th_a = theta
    th_b = theta - TWO_PI_3
    th_c = theta + TWO_PI_3
    a = d * xp.cos(th_a) - q * xp.sin(th_a) + z
    b = d * xp.cos(th_b) - q * xp.sin(th_b) + z
    c = d * xp.cos(th_c) - q * xp.sin(th_c) + z
    return xp.stack([a, b, c], axis=-1)


# ---------------------------------------------------------------------------
# per-phase phasors <-> symmetric components (rhs_core conventions)
# ---------------------------------------------------------------------------
def sequence_components(x: C, xp=np):
    """Per-phase phasor set [3, ...] -> (positive, negative, zero) sequence
    phasors: pos = mean(x·conj(a_k)), neg = mean(x·a_k), zero = mean(x)."""
    a_k = cexpj(_shift_angles(3, xp, None,
                              getattr(x.re, "ndim", 1) - 1), xp)
    pos = cmean(cmul(x, cconj(a_k)), xp)
    neg = cmean(cmul(x, a_k), xp)
    zero = cmean(x, xp)
    return pos, neg, zero


def sequence_to_phase(pos: C, neg: C, zero: C, xp=np) -> C:
    """Inverse of sequence_components: x_k = pos·a_k + neg·conj(a_k) + zero."""
    bd = getattr(xp.asarray(pos.re), "ndim", 0)
    a_k = cexpj(_shift_angles(3, xp, None, bd), xp)
    p = cmul(_bcast(pos, xp), a_k)
    n = cmul(_bcast(neg, xp), cconj(a_k))
    z = _bcast(zero, xp)
    return C(p.re + n.re + z.re, p.im + n.im + z.im)


def _bcast(x: C, xp) -> C:
    """Add a leading phase axis to a sequence phasor for broadcasting."""
    re = xp.asarray(x.re)
    im = xp.asarray(x.im)
    return C(re[None, ...], im[None, ...])
