"""The env step's pre-window glue as one CUDA kernel (`csrc/pre_window.cu`).

`pre_window_batch` computes in one launch what the plain version,
`env.core._pre_window_plain`, computes before the control window: the
window's start time, the action's setpoint nudges (discrete or continuous,
with the anomaly flag where the config has it), the clamps of the
setpoints, the event-table lookups of `scenario.events.make_exog` and, with
Volt-VAR or MPPT, the supervisory layer on the algebra at the window start.
It writes the exog straight into the [15, N] pack that the window kernels
read (`ops.window.U_FIELDS` order), so nothing stacks it again. With
Volt-VAR it can count the envs whose setpoint the curve moved off 0 (one
atomic a block into a slot of `diag.profiler.counter`). It takes
and returns tensors: every leaf it computes (`OUT_LEAVES`) a fresh tensor,
no input written. `env.core._pre_window` routes between the two, this
kernel for tensors on the card and the plain version for tensors on the
CPU, and views the pack's rows as the step's exog.
On the card the kernel equals the plain version bit for bit, but for the
Volt-VAR setpoint at three phases, where torch's own reduction sets the
order of the phase means (`chip_smoke.check_pre_window`).
"""
from __future__ import annotations

import torch

from pvderx_torch.ops import _build
from pvderx_torch.ops.window import P_FIELDS, U_FIELDS
from pvderx_torch.scenario.mppt_voltvar import (
    MPPT_DEADBAND, VV_V, mppt_update)

# the order of the entry's pointer arrays (csrc/pre_window.cu: In, Out)
IN_LEAVES = ("t_step", "q_ref", "vdc_ref", "tripped", "ces", "action",
             "solar", "grid", "load", "y", "p", "p_prev", "direction")
OUT_LEAVES = ("u", "t", "flag", "p_prev", "direction")
# the config's switches, bit k of the entry's ``modes`` (csrc: Mode)
MODES = ("continuous", "anomaly", "voltvar", "mppt")
_DTYPES = {torch.float32: 0, torch.float64: 1}


def pre_window_constants(cfg) -> list:
    """The Python scalars of the plain version for ``cfg`` (an
    `EnvConfig`), in the order of csrc/pre_window.cu's `Const`: the
    config's action steps, setpoint bounds and Volt-VAR reach,
    `mppt_update`'s step and bounds, the P&O deadband's floor and the
    Volt-VAR knots. The kernel rounds each once to the working type, as
    torch rounds a Python scalar."""
    return [cfg.dt_ctrl, cfg.dq_action, cfg.dv_action, cfg.q_lo, cfg.q_hi,
            cfg.v_lo, cfg.v_hi, cfg.q_vv, *mppt_update.__defaults__,
            -MPPT_DEADBAND, *VV_V]


def pre_window_bytes(n: int, dtype=torch.float32) -> int:
    """Device-memory bytes one launch must move with discrete actions and
    neither the anomaly flag nor the supervisory layer, at the config's
    table sizes ([4, 3], [4, 6], [2, 3]): one read of the tables, of
    t_step (int32), q_ref, vdc_ref, the trip latch, the cessation flag and
    the action (int64); one write of the exog pack and t."""
    size = torch.finfo(dtype).bits // 8
    reads = (4 * 3 + 4 * 6 + 2 * 3 + 4) * size + 4 + 8
    writes = (len(U_FIELDS) + 1) * size
    return n * (reads + writes)


def pre_window_batch(ins: dict, consts, count=None, *, n_ph: int,
                     n_mppt: int, continuous: bool = False,
                     anomaly: bool = False, voltvar: bool = False,
                     mppt: bool = False):
    """The pre-window glue of a batch in one kernel launch.

    ins: {name: tensor} of every leaf in `IN_LEAVES`: ``t_step`` [N]
    int32; ``q_ref``, ``vdc_ref``, ``tripped`` and ``ces`` [N]; the action,
    [N] int64 or with ``continuous`` [N, 2]; the event tables ``solar``
    [N, K_s, 3], ``grid`` [N, K_g, 6] and ``load`` [N, K_l, 3]; with
    ``voltvar`` or ``mppt`` the state ``y`` [N, 6 n_ph + 5] and the params
    pack ``p`` [29, N], else None; with ``mppt`` the P&O state ``p_prev``
    and ``direction`` [N], else None. consts: `pre_window_constants` of
    the config. Every tensor contiguous, on one CUDA device, float32 or
    float64 but for t_step and a discrete action. count: with
    ``voltvar``, a one-element int64 slot on the card into which the kernel
    adds the envs whose Volt-VAR setpoint is not 0 (`diag.profiler.counter`),
    or None. Returns {name: tensor}:
    ``u``, the [15, N] exog pack, and ``t`` [N], the window's start; with
    ``anomaly`` the flag [N]; with ``mppt`` the new ``p_prev`` and
    ``direction`` [N]. Each a fresh tensor; no input is written. Each
    launch adds one to ``pre_window_batch.launches``.
    """
    q_ref = ins["q_ref"]
    dtype, dev, n = q_ref.dtype, q_ref.device, q_ref.shape[0]
    if dtype not in _DTYPES:
        raise ValueError(f"the CUDA pre-window kernel takes float32 or "
                         f"float64, got {dtype}")
    ks = [ins[k].shape[1] if ins[k].dim() == 3 else 0
          for k in ("solar", "grid", "load")]
    want = {"t_step": (torch.int32, (n,)), "solar": (dtype, (n, ks[0], 3)),
            "grid": (dtype, (n, ks[1], 6)), "load": (dtype, (n, ks[2], 3)),
            "action": ((dtype, (n, 2)) if continuous
                       else (torch.int64, (n,))),
            "y": (dtype, (n, 6 * n_ph + 5)), "p": (dtype, (len(P_FIELDS), n))}
    for k in IN_LEAVES:
        a = ins[k]
        if a is None:
            continue
        kind, shape = want.get(k, (dtype, (n,)))
        if a.device != dev or a.dtype != kind or tuple(a.shape) != shape:
            raise ValueError(
                f"{k} must be {kind} {shape} on {dev}, got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
    if count is not None and (count.dtype != torch.int64 or not voltvar):
        raise ValueError(f"count must be an int64 slot, with Volt-VAR; got "
                         f"{count.dtype}, voltvar={voltvar}")
    out = {"u": torch.empty(len(U_FIELDS), n, dtype=dtype, device=dev),
           "t": torch.empty(n, dtype=dtype, device=dev)}
    if anomaly:
        out["flag"] = torch.empty(n, dtype=dtype, device=dev)
    if mppt:
        out["p_prev"] = torch.empty(n, dtype=dtype, device=dev)
        out["direction"] = torch.empty(n, dtype=dtype, device=dev)
    modes = sum(1 << i for i, on in enumerate(
        (continuous, anomaly, voltvar, mppt)) if on)
    _build.launch("pvderx_pre_window", "pre-window",
                  tuple(ins[k] for k in IN_LEAVES),
                  tuple(out.get(k) for k in OUT_LEAVES), list(consts),
                  count, n, n_ph, *ks, n_mppt, modes, _DTYPES[dtype],
                  check=list(out.values()))
    pre_window_batch.launches += 1
    return out


pre_window_batch.launches = 0
