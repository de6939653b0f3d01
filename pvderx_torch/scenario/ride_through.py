"""IEEE-1547-style voltage/frequency ride-through — branchless state machine.

Pure masked arithmetic on a [6]-vector of zone timers per env (SPEC.md §8):
timers accumulate dt_ctrl while in zone else reset; exceeding the zone limit
latches a trip (conn=0) for the rest of the episode; the LV2 zone
additionally forces momentary cessation while active.

Zone order: [LV1, LV2, HV1, HV2, LF, HF].
"""
from __future__ import annotations

import torch

from pvderx_torch._struct import struct

N_ZONES = 6
_T_LIM = (3.0, 1.0, 1.0, 0.16, 3.0, 3.0)


@struct
class RideThroughParams:
    """Thresholds [pu], time limits [s], per-zone enables (floats 0/1)."""

    v_lv1: float
    v_lv2: float
    v_hv1: float
    v_hv2: float
    f_lf: float
    f_hf: float
    t_lim: torch.Tensor   # [6]
    enable: torch.Tensor  # [6]


def default_rt_params(enabled: bool = True, dtype=torch.float32,
                      device="cuda") -> RideThroughParams:
    e = 1.0 if enabled else 0.0
    # t_lim is float32 in every dtype, as the reference keeps it
    t_lim = torch.tensor(_T_LIM, dtype=torch.float32).to(dtype)
    return RideThroughParams(
        v_lv1=0.88, v_lv2=0.50, v_hv1=1.10, v_hv2=1.20, f_lf=0.98, f_hf=1.02,
        t_lim=t_lim.to(device),
        enable=torch.full((N_ZONES,), e, dtype=dtype, device=device),
    )


@struct
class RideThroughState:
    timers: torch.Tensor   # [..., 6]
    tripped: torch.Tensor  # [...] 0/1 (latched)
    ces: torch.Tensor      # [...] 0/1 (momentary cessation, not latched)


def rt_init(shape=(), dtype=torch.float32, device="cuda") -> RideThroughState:
    shape = tuple(shape)
    return RideThroughState(
        timers=torch.zeros(shape + (N_ZONES,), dtype=dtype, device=device),
        tripped=torch.zeros(shape, dtype=dtype, device=device),
        ces=torch.zeros(shape, dtype=dtype, device=device),
    )


def rt_update(rt: RideThroughState, rtp: RideThroughParams, v_mag, f_meas, dt):
    """One supervisory update (between windows). Returns new state.

    `tripped` latches; `ces` is 1 only while the LV2 zone is active.
    """
    in_zone = torch.stack([
        v_mag < rtp.v_lv1,
        v_mag < rtp.v_lv2,
        v_mag > rtp.v_hv1,
        v_mag > rtp.v_hv2,
        f_meas < rtp.f_lf,
        f_meas > rtp.f_hf,
    ], -1).to(rt.timers.dtype) * rtp.enable
    timers = (rt.timers + dt) * in_zone
    trip_now = torch.amax((timers > rtp.t_lim).to(rt.tripped.dtype), dim=-1)
    tripped = torch.maximum(rt.tripped, trip_now)
    ces = in_zone[..., 1].to(rt.ces.dtype)
    return RideThroughState(timers=timers, tripped=tripped, ces=ces)
