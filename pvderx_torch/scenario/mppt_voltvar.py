"""MPPT (perturb & observe) and Volt-VAR droop — branchless supervisory logic.

Semantics per SPEC.md §8. Every function is elementwise over the env batch.
"""
from __future__ import annotations

import torch

from pvderx_torch._struct import struct


@struct
class MPPTState:
    p_prev: torch.Tensor     # last sampled PV power [pu]
    direction: torch.Tensor  # +1 / -1 perturb direction


def mppt_init(p0) -> MPPTState:
    """P&O state starting from the sampled PV power ``p0`` (a tensor)."""
    return MPPTState(p_prev=p0, direction=torch.ones_like(p0))


# P&O power deadband [pu]: |dP| below this keeps the current direction.
# Real P&O controllers reject measurement noise this way; here it ALSO pins
# the cross-backend contract — at the MPP the raw dP >= 0 decision is
# sign-of-last-ulp, and backends that differ by an ulp would flip direction
# bits. 1e-6 pu (~0.25 W on the 250 kW preset) is far above any backend ulp
# and far below a real P&O step's dP.
MPPT_DEADBAND = 1e-6


def mppt_update(ms: MPPTState, vdc_ref, p_pv, k_step, n_mppt: int,
                dv: float = 0.005, lo: float = 0.7, hi: float = 1.2):
    """P&O update, active once every n_mppt control steps (SPEC.md §8).

    Returns (new_state, new_vdc_ref). Direction flips only when the power
    moved DOWN by more than MPPT_DEADBAND (see above).
    """
    active = (k_step % n_mppt == 0).to(vdc_ref.dtype)
    dp = p_pv - ms.p_prev
    new_dir = torch.where(dp >= -MPPT_DEADBAND, ms.direction, -ms.direction)
    vdc_new = torch.clamp(vdc_ref + dv * new_dir, lo, hi)
    return (
        MPPTState(
            p_prev=ms.p_prev + active * (p_pv - ms.p_prev),
            direction=ms.direction + active * (new_dir - ms.direction),
        ),
        vdc_ref + active * (vdc_new - vdc_ref),
    )


# Volt-VAR droop curve knots (SPEC.md §8): full boost below 0.92, deadband
# 0.98..1.02, full absorb above 1.08.
VV_V = (0.92, 0.98, 1.02, 1.08)


def voltvar_qref(v_mag, q_max: float = 0.44):
    """Piecewise-linear Q_ref = f(|V_pos|), branchless.

    torch has no ``interp``: each segment is evaluated as
    ``fp[i-1] + ((v - xp[i-1]) / (xp[i] - xp[i-1])) * (fp[i] - fp[i-1])``
    with knots in ``v_mag``'s dtype (the formula of ``numpy.interp``), and a
    select picks the segment ``xp[i-1] <= v < xp[i]``, clamping to the end
    values outside the knots."""
    xp = torch.tensor(VV_V, dtype=v_mag.dtype, device=v_mag.device)
    fp = torch.tensor([q_max, 0.0, 0.0, -q_max], dtype=v_mag.dtype,
                      device=v_mag.device)
    out = torch.where(v_mag < xp[0], fp[0], fp[3])
    for i in (3, 2, 1):
        seg = fp[i - 1] + ((v_mag - xp[i - 1]) / (xp[i] - xp[i - 1])) * (
            fp[i] - fp[i - 1])
        lo_ok = v_mag >= xp[i - 1]
        hi_ok = (v_mag < xp[i]) if i < 3 else (v_mag <= xp[i])
        out = torch.where(lo_ok & hi_ok, seg, out)
    return out
