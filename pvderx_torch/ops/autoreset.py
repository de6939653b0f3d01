"""The env step's autoreset as one CUDA kernel (`csrc/autoreset.cu`).

`autoreset_batch` restarts the done envs of a stepped single-DER batch in
one launch: where an env is done, its soft reset (the event tables of
`env.core._sample_events` from its draws, then its cached episode start);
elsewhere a copy of its stepped leaves. It computes what the plain version
computes -- `env.core._soft_reset` of every env, then `env.core.autoreset`'s
``torch.where`` per leaf -- bit for bit, and touches the restart arithmetic
of the done envs only. The plain version lives in `env.core`, which routes
between the two (`env.core.restart_done`): this kernel for tensors on the
card, the plain version for tensors on the CPU.

Every output is a fresh tensor: no leaf of the input state, and nothing
that the step returned (``info["vdc"]`` is a view of the stepped y,
``info["tripped"]`` the stepped trip latch), is written.
"""
from __future__ import annotations

import ctypes
import math

import torch

from pvderx_torch._struct import replace
from pvderx_torch.ops.window import check_outputs, guard_launch

# the order of the entry's pointer arrays (csrc/autoreset.cu: In, Out)
IN_LEAVES = ("done", "uv", "s0", "tc0", "y0", "obs0", "ppv0", "w_base",
             "solar", "grid", "load", "y", "t_step", "vdc_ref", "q_ref",
             "timers", "tripped", "ces", "p_prev", "direction", "obs", "y_lo")
OUT_LEAVES = ("solar", "grid", "load", "y", "t_step", "vdc_ref", "q_ref",
              "timers", "tripped", "ces", "p_prev", "direction", "obs",
              "y_lo")
_DTYPES = {torch.float32: 0, torch.float64: 1}


def scenario_constants(sc) -> list:
    """The scalars of `env.core._sample_events` for ``sc`` (a
    `ScenarioConfig`), each the double its Python expression gives there,
    in the order of csrc/autoreset.cu's `Const`: the kernel rounds each once
    to the working type, as torch rounds a Python scalar."""
    two_pi = 2.0 * math.pi
    return [sc.p_cloud, sc.sag_t_lo, sc.sag_t_hi - sc.sag_t_lo,
            sc.cloud_frac_lo, sc.cloud_frac_hi - sc.cloud_frac_lo,
            0.5, 3.0 - 0.5, sc.p_sag, sc.p_sag + sc.p_freq,
            sc.sag_depth_lo, sc.sag_depth_hi - sc.sag_depth_lo,
            sc.sag_dur_lo, sc.sag_dur_hi - sc.sag_dur_lo,
            -sc.df_max, sc.df_max - (-sc.df_max), two_pi,
            sc.p_unb, sc.unb_frac, 0.0, two_pi - 0.0,
            sc.p_load, 0.05, sc.load_g_hi - 0.05]


def autoreset_bytes(n: int, n_ph: int, dtype=torch.float32,
                    lo: bool = False) -> int:
    """Device-memory bytes one launch must move with no env done: one read
    of ``done`` and one read and one write of every leaf that changes (the
    event tables, y, obs, timers, seven scalars; y_lo with ``lo``)."""
    n_s = 6 * n_ph + 5
    width = 42 + n_s + 13 + 6 + 7 + (n_s if lo else 0)
    return n * (1 + 2 * width * torch.finfo(dtype).bits // 8)


def autoreset_batch(done, uv, state, obs, *, scen, w_base, n_ph: int,
                    y_lo=None, count=None):
    """Restart the done envs of a stepped batch in one kernel launch.

    done: [N] bool; uv: [N, 14] draws; state: the stepped `EnvState`
    (its ``s0``, ``tc0``, ``y0``, ``obs0``, ``ppv0`` the cached episode
    start); obs: [N, 13] stepped; scen: the config's `ScenarioConfig`;
    w_base: the config's 0-d ``der.w_base``; y_lo: the df32 tier's [N, n_s]
    lo residual (zeroed where done), or None; count: a one-element int64
    slot on the card into which the kernel adds the envs it restarted
    (`diag.profiler.counter`), or None. Every tensor on one CUDA device,
    float32 or float64 (t_step int32). Returns (state, obs, y_lo or None),
    the state's other leaves those of ``state``; each launch adds one to
    ``autoreset_batch.launches``.
    """
    dev, dtype = state.y.device, state.y.dtype
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dtype not in _DTYPES:
        raise ValueError(f"the CUDA autoreset kernel takes float32 or "
                         f"float64, got {dtype}")
    n, n_s = state.y.shape
    if n_s != 6 * n_ph + 5:
        raise ValueError(f"y must be [N, {6 * n_ph + 5}], got "
                         f"{tuple(state.y.shape)}")
    sched, rt, mppt = state.sched, state.rt, state.mppt
    leaves = {
        "done": (done, torch.bool, (n,)), "uv": (uv, dtype, (n, 14)),
        "s0": (state.s0, dtype, (n,)), "tc0": (state.tc0, dtype, (n,)),
        "y0": (state.y0, dtype, (n, n_s)), "obs0": (state.obs0, dtype, (n, 13)),
        "ppv0": (state.ppv0, dtype, (n,)), "w_base": (w_base, dtype, ()),
        "solar": (sched.solar, dtype, (n, 4, 3)),
        "grid": (sched.grid, dtype, (n, 4, 6)),
        "load": (sched.load, dtype, (n, 2, 3)),
        "y": (state.y, dtype, (n, n_s)),
        "t_step": (state.t_step, torch.int32, (n,)),
        "vdc_ref": (state.vdc_ref, dtype, (n,)),
        "q_ref": (state.q_ref, dtype, (n,)),
        "timers": (rt.timers, dtype, (n, 6)),
        "tripped": (rt.tripped, dtype, (n,)), "ces": (rt.ces, dtype, (n,)),
        "p_prev": (mppt.p_prev, dtype, (n,)),
        "direction": (mppt.direction, dtype, (n,)),
        "obs": (obs, dtype, (n, 13)),
    }
    if y_lo is not None:
        leaves["y_lo"] = (y_lo, dtype, (n, n_s))
    src = {}
    for name, (a, want, shape) in leaves.items():
        if a.device != dev or a.dtype != want or tuple(a.shape) != shape:
            raise ValueError(
                f"{name} must be {want} {shape} on {dev}, got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
        src[name] = a.contiguous()
    if count is not None and (count.device != dev
                              or count.dtype != torch.int64):
        raise ValueError("count must be an int64 slot on the state's device")
    guard_launch("autoreset", *(src[k] for k in ("uv", "y", "y0", "obs",
                                                  "obs0")))
    out = {k: torch.empty_like(src[k]) for k in OUT_LEAVES if k in src}
    from pvderx_torch.ops import _build
    lib = _build.load()
    ptr = lambda d, k: d[k].data_ptr() if k in d else None
    ins = (ctypes.c_void_p * len(IN_LEAVES))(*(ptr(src, k) for k in IN_LEAVES))
    outs = (ctypes.c_void_p * len(OUT_LEAVES))(*(ptr(out, k)
                                                  for k in OUT_LEAVES))
    consts = scenario_constants(scen)
    consts = (ctypes.c_double * len(consts))(*consts)
    with torch.cuda.device(dev):
        err = lib.pvderx_autoreset(
            ctypes.addressof(ins), ctypes.addressof(outs),
            ctypes.addressof(consts),
            None if count is None else count.data_ptr(), n, n_ph,
            _DTYPES[dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"autoreset kernel launch failed: {_build.error_string(err)}")
    autoreset_batch.launches += 1
    check_outputs("autoreset", *(v for k, v in out.items() if k != "t_step"))
    st = replace(
        state, sched=replace(sched, solar=out["solar"], grid=out["grid"],
                             load=out["load"]),
        y=out["y"], t_step=out["t_step"], vdc_ref=out["vdc_ref"],
        q_ref=out["q_ref"],
        rt=replace(rt, timers=out["timers"], tripped=out["tripped"],
                   ces=out["ces"]),
        mppt=replace(mppt, p_prev=out["p_prev"],
                     direction=out["direction"]))
    return st, out["obs"], out.get("y_lo")


autoreset_batch.launches = 0
