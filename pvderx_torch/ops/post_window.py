"""The env step's post-window glue as one CUDA kernel (`csrc/post_window.cu`).

`post_window_batch` computes in one launch what the plain version,
`env.core._post_window_plain`, computes after the control window: the
algebra of the stepped state at t + dt, the ride-through update, the
observation, the reward (with the anomaly terms where the config has them),
terminated, truncated, done and the info leaves. It returns the same
objects with the same aliasing: the state's ``y`` is the window's y1,
``info["vdc"]`` a view of it, ``info["tripped"]`` the state's new trip
latch, the setpoints the exog's. Every other output is a fresh tensor, and
no input is written. `env.core._post_window` routes between the two: this
kernel for tensors on the card, the plain version for tensors on the CPU.
On the card the kernel equals the plain version bit for bit at one phase;
at three, torch's own reduction sets the order of the phase means
(`chip_smoke.check_post_window`).
"""
from __future__ import annotations

import ctypes

import torch

from pvderx_torch._struct import replace
from pvderx_torch.ops.window import (
    P_FIELDS, U_FIELDS, check_outputs, guard_launch, pack_struct)

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


def post_window_batch(cfg, st, exog, mppt, t, y1, flag, *, p_pack=None,
                      u_pack=None):
    """The post-window glue of a stepped batch in one kernel launch.

    cfg: the `EnvConfig`; st: the `EnvState` the step started from; exog,
    mppt, t, flag: what `env.core._pre_window` returned; y1: [N, n_s], the
    window's end state; p_pack: the [29, N] params pack of ``st.der`` and
    u_pack: the [15, N] pack of ``exog`` (`ops.window.pack_struct`), each
    packed here when None. Every tensor on one CUDA device, float32 or
    float64 (t_step int32). Returns (state, obs, reward, done, info) as
    `env.core._post_window_plain`; each launch adds one to
    ``post_window_batch.launches``.
    """
    dev, dtype = y1.device, y1.dtype
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dtype not in _DTYPES:
        raise ValueError(f"the CUDA post-window kernel takes float32 or "
                         f"float64, got {dtype}")
    n_ph = cfg.der.n_ph
    n, n_s = y1.shape
    if n_s != 6 * n_ph + 5:
        raise ValueError(f"y1 must be [N, {6 * n_ph + 5}], got "
                         f"{tuple(y1.shape)}")
    if p_pack is None:
        p_pack = pack_struct(st.der, P_FIELDS)
    if u_pack is None:
        u_pack = pack_struct(exog, U_FIELDS)
    leaves = {
        "y": (y1, dtype, (n, n_s)), "t": (t, dtype, (n,)),
        "t_step": (st.t_step, torch.int32, (n,)),
        "p": (p_pack, dtype, (len(P_FIELDS), n)),
        "u": (u_pack, dtype, (len(U_FIELDS), n)),
        "timers": (st.rt.timers, dtype, (n, 6)),
        "tripped": (st.rt.tripped, dtype, (n,)),
        "t_lim": (cfg.rt.t_lim, dtype, (6,)),
        "enable": (cfg.rt.enable, dtype, (6,)),
    }
    if cfg.anomaly_detect:
        leaves["flag"] = (flag, dtype, (n,))
        leaves["s0"] = (st.s0, dtype, (n,))
    src = {}
    for name, (a, want, shape) in leaves.items():
        if a.device != dev or a.dtype != want or tuple(a.shape) != shape:
            raise ValueError(
                f"{name} must be {want} {shape} on {dev}, got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
        src[name] = a.contiguous()
    guard_launch("post-window", src["y"], src["p"], src["u"])
    shapes = {"obs": (n, 13), "timers": (n, 6)}
    types = {"t_step": torch.int32, **dict.fromkeys(_BOOL_OUT, torch.bool)}
    out = {k: torch.empty(shapes.get(k, (n,)), dtype=types.get(k, dtype),
                          device=dev) for k in OUT_LEAVES}
    from pvderx_torch.ops import _build
    lib = _build.load()
    ptr = lambda d, k: d[k].data_ptr() if k in d else None
    ins = (ctypes.c_void_p * len(IN_LEAVES))(*(ptr(src, k) for k in IN_LEAVES))
    outs = (ctypes.c_void_p * len(OUT_LEAVES))(*(ptr(out, k)
                                                  for k in OUT_LEAVES))
    consts = step_constants(cfg)
    consts = (ctypes.c_double * len(consts))(*consts)
    with torch.cuda.device(dev):
        err = lib.pvderx_post_window(
            ctypes.addressof(ins), ctypes.addressof(outs),
            ctypes.addressof(consts), n, n_ph, cfg.horizon, _DTYPES[dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"post-window kernel launch failed: {_build.error_string(err)}")
    post_window_batch.launches += 1
    check_outputs("post-window", *(v for v in out.values()
                                   if v.is_floating_point()))
    rt1 = replace(st.rt, timers=out["timers"], tripped=out["tripped"],
                  ces=out["ces"])
    st1 = replace(st, y=y1, t_step=out["t_step"], vdc_ref=exog.vdc_ref,
                  q_ref=exog.q_ref, rt=rt1, mppt=mppt)
    info = {
        "vdc": y1[:, 6 * n_ph], "v_mag": out["v_mag"],
        "f_meas": out["f_meas"], "v_unb": out["v_unb"],
        "p_pcc": out["p_pcc"], "q_pcc": out["q_pcc"], "p_pv": out["p_pv"],
        "tripped": rt1.tripped, "trip_now": out["trip_now"],
        "terminated": out["terminated"], "truncated": out["truncated"],
    }
    return st1, out["obs"], out["reward"], out["done"], info


post_window_batch.launches = 0
