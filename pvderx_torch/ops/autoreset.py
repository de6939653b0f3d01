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

It takes and returns tensors, and `env.core.restart_done` builds the
restarted state from them. Every output is a fresh tensor: no leaf of the
input state, and nothing that the step returned (``info["vdc"]`` is a view
of the stepped y, ``info["tripped"]`` the stepped trip latch), is written.
"""
from __future__ import annotations

import math

import torch

from pvderx_torch.ops import _build

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


def autoreset_batch(ins: dict, consts, count=None, *, n_ph: int):
    """Restart the done envs of a stepped batch in one kernel launch.

    ins: {name: tensor} of every leaf in `IN_LEAVES`: ``done`` [N] bool;
    ``uv`` [N, 14] draws; the cached episode start (``s0``, ``tc0``,
    ``y0``, ``obs0``, ``ppv0``); the config's 0-d ``w_base``; the stepped
    leaves (the event tables, ``y``, ``t_step``, the setpoints, the
    ride-through and MPPT state, ``obs``); ``y_lo``, the df32 tier's
    [N, n_s] lo residual (zeroed where done), or None. consts:
    `scenario_constants` of the config's scenario; count: a one-element
    int64 slot on the card into which the kernel adds the envs it restarted
    (`diag.profiler.counter`), or None. Every tensor on one CUDA device,
    float32 or float64 (t_step int32). Returns {name: tensor} of the leaves
    in `OUT_LEAVES` (``y_lo`` only when given), each a fresh tensor; no
    input is written. Each launch adds one to ``autoreset_batch.launches``.
    """
    y = ins["y"]
    dtype = y.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"the CUDA autoreset kernel takes float32 or "
                         f"float64, got {dtype}")
    n, n_s = y.shape
    if n_s != 6 * n_ph + 5:
        raise ValueError(f"y must be [N, {6 * n_ph + 5}], got "
                         f"{tuple(y.shape)}")
    want = {
        "done": (torch.bool, (n,)), "uv": (dtype, (n, 14)),
        "y0": (dtype, (n, n_s)), "obs0": (dtype, (n, 13)),
        "w_base": (dtype, ()), "solar": (dtype, (n, 4, 3)),
        "grid": (dtype, (n, 4, 6)), "load": (dtype, (n, 2, 3)),
        "y": (dtype, (n, n_s)), "t_step": (torch.int32, (n,)),
        "timers": (dtype, (n, 6)), "obs": (dtype, (n, 13)),
        "y_lo": (dtype, (n, n_s)),
    }
    src = _build.check_leaves(y.device, {
        k: (ins[k], *want.get(k, (dtype, (n,)))) for k in IN_LEAVES
        if k != "y_lo" or ins[k] is not None})
    if count is not None and count.dtype != torch.int64:
        raise ValueError(f"count must be an int64 slot, got {count.dtype}")
    out = {k: torch.empty_like(src[k]) for k in OUT_LEAVES if k in src}
    _build.launch("pvderx_autoreset", "autoreset",
                  tuple(src.get(k) for k in IN_LEAVES),
                  tuple(out.get(k) for k in OUT_LEAVES), list(consts), count,
                  n, n_ph, _DTYPES[dtype],
                  check=[v for k, v in out.items() if k != "t_step"])
    autoreset_batch.launches += 1
    return out


autoreset_batch.launches = 0
