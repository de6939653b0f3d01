"""The env step's post-window glue as one CUDA kernel (`csrc/post_window.cu`).

`post_window_batch` computes in one launch what the plain version,
`env.core._post_window_plain`, computes after the control window: the
algebra of the stepped state at t + dt, the ride-through update, the
observation, the reward (with the anomaly terms where the config has them),
terminated, truncated, done and the info leaves. It takes and returns
tensors: every leaf it computes (`OUT_LEAVES`) a fresh tensor, no input
written. `env.core._post_window` routes between the two, this kernel for
tensors on the card and the plain version for tensors on the CPU, and
builds the step's state and ``info`` from these leaves as it does from the
plain version's (`env.core._stepped`).
On the card the kernel equals the plain version bit for bit at one phase;
at three, torch's own reduction sets the order of the phase means
(`chip_smoke.check_post_window`).
"""
from __future__ import annotations

import torch

from pvderx_torch.ops import _build
from pvderx_torch.ops.window import P_FIELDS, U_FIELDS

# the order of the entry's pointer arrays (csrc/post_window.cu: In, Out)
IN_LEAVES = ("y", "t", "t_step", "p", "u", "timers", "tripped", "t_lim",
             "enable", "flag", "s0")
OUT_LEAVES = ("obs", "reward", "done", "terminated", "truncated", "t_step",
              "timers", "tripped", "ces", "v_mag", "f_meas", "v_unb",
              "p_pcc", "q_pcc", "p_pv", "trip_now")
# the rows of the packs the kernel reads; with three phases also v_g2 and
# phi_g2, with the anomaly reward v_g2 (`post_window_bytes`)
P_READ = ("rg", "xg", "w_base", "vdc_base", "np_par", "isc_ref", "ki_t",
          "irs", "gamma", "kp_pll", "s_rated")
U_READ = ("s_irr", "t_cell", "v_g", "phi_g", "dw_g", "t_g", "g_load",
          "b_load", "vdc_ref", "q_ref", "conn", "ces")
_DTYPES = {torch.float32: 0, torch.float64: 1}
_BOOL_OUT = ("done", "terminated", "truncated")


def step_constants(cfg) -> list:
    """The Python scalars of the plain version for ``cfg`` (an
    `EnvConfig`), in the order of csrc/post_window.cu's `Const`: the kernel
    rounds each once to the working type, as torch rounds a Python scalar."""
    rt = cfg.rt
    return [cfg.dt_ctrl, rt.v_lv1, rt.v_lv2, rt.v_hv1, rt.v_hv2, rt.f_lf,
            rt.f_hf, cfg.r_alive, cfg.w_vdc, cfg.w_q, cfg.w_vband,
            cfg.r_trip, cfg.r_anom_tp, cfg.r_anom_fp, cfg.r_anom_fn]


def post_window_bytes(n: int, n_ph: int, dtype=torch.float32) -> int:
    """Device-memory bytes one launch must move without the anomaly reward
    (which reads the flag, s0 and, at one phase, v_g2 besides): one read of
    y1, of the pack rows the step reads (`P_READ`, `U_READ`), of t, the
    zone timers and the trip latch; one write of obs, the reward, the
    timers, the trip latch, the cessation flag and the seven float info
    leaves; t_step read and written (int32), done, terminated and truncated
    written (one byte each)."""
    n_s = 6 * n_ph + 5
    u_rows = len(U_READ) + (2 if n_ph == 3 else 0)
    reads = n_s + len(P_READ) + u_rows + 1 + 6 + 1
    writes = 13 + 1 + 6 + 1 + 1 + 7
    return n * ((reads + writes) * torch.finfo(dtype).bits // 8 + 2 * 4 + 3)


def post_window_batch(y, t, t_step, p_pack, u_pack, timers, tripped, t_lim,
                      enable, flag, s0, consts, *, n_ph: int, horizon: int):
    """The post-window glue of a stepped batch in one kernel launch.

    y: [N, n_s], the window's end state; t: [N], the window's start time;
    t_step: [N] int32; p_pack: [29, N] and u_pack: [15, N], the window's
    packs (`ops.window.pack_struct`); timers: [N, 6] and tripped: [N], the
    ride-through state the step started from; t_lim, enable: [6], the
    config's ride-through tables; flag and s0: [N] each for the anomaly
    reward, or None without it; consts: `step_constants` of the config.
    Every tensor on one CUDA device, float32 or float64 (t_step int32).
    Returns {name: [N, ...] tensor} of every leaf in `OUT_LEAVES`, each a
    fresh tensor; no input is written. Each launch adds one to
    ``post_window_batch.launches``.
    """
    dtype = y.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"the CUDA post-window kernel takes float32 or "
                         f"float64, got {dtype}")
    n, n_s = y.shape
    if n_s != 6 * n_ph + 5:
        raise ValueError(f"y must be [N, {6 * n_ph + 5}], got "
                         f"{tuple(y.shape)}")
    leaves = {
        "y": (y, dtype, (n, n_s)), "t": (t, dtype, (n,)),
        "t_step": (t_step, torch.int32, (n,)),
        "p": (p_pack, dtype, (len(P_FIELDS), n)),
        "u": (u_pack, dtype, (len(U_FIELDS), n)),
        "timers": (timers, dtype, (n, 6)), "tripped": (tripped, dtype, (n,)),
        "t_lim": (t_lim, dtype, (6,)), "enable": (enable, dtype, (6,)),
    }
    if flag is not None:
        leaves["flag"] = (flag, dtype, (n,))
    if s0 is not None:
        leaves["s0"] = (s0, dtype, (n,))
    src = _build.check_leaves(y.device, leaves)
    shapes = {"obs": (n, 13), "timers": (n, 6)}
    types = {"t_step": torch.int32, **dict.fromkeys(_BOOL_OUT, torch.bool)}
    out = {k: torch.empty(shapes.get(k, (n,)), dtype=types.get(k, dtype),
                          device=y.device) for k in OUT_LEAVES}
    _build.launch("pvderx_post_window", "post-window",
                  tuple(src.get(k) for k in IN_LEAVES),
                  tuple(out[k] for k in OUT_LEAVES), list(consts), n, n_ph,
                  horizon, _DTYPES[dtype],
                  check=[v for v in out.values() if v.is_floating_point()])
    post_window_batch.launches += 1
    return out


post_window_batch.launches = 0
