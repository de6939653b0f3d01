"""pvderx_torch.native — the float64 engine on the card.

The counterpart of `pvderx.native`, the reference's C++ engine
(`pvderx/native/src/pvderx_native.cpp`): the same SPEC.md §§4-5 equations
in float64 with a Kahan-compensated RK4 window, an adaptive Dormand-Prince
5(4) truth integrator, a Newton steady-state solve and a batched RK4 window
over N envs, with the reference's names, arguments and meaning. Each
function also takes ``device=``: the card (``"cuda"``, the default), where
it launches one of the four CUDA kernels of `csrc/native.cu`
(`pvderx_torch.native.kernels`), or ``"cpu"``, where it runs their plain
torch versions. Inputs may be numpy arrays or tensors; every result is a
float64 tensor on the device it ran on.

``available()`` says whether a CUDA device is present and the kernel
library built and loaded; ``load_error()`` why not. Asking for the card
when it is not available raises; a failed build or launch raises. There is
no fallback to the CPU. A failed DP5(4) window or Newton solve raises
``RuntimeError``, as the reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pvderx_torch.native import kernels
from pvderx_torch.params import DERParams, Exog

# Frozen packed-field orders: the kernels index packed arrays by them
# (rhs.cuh's PField / UField). tests/test_torch_native.py holds them to
# `pvderx_torch.ops.window.P_FIELDS` / `U_FIELDS` and to the reference's.
P_ORDER = (
    "rf", "lf", "rg", "xg", "kv", "w_base", "s_rated", "v_base", "i_base",
    "vdc_base", "tau_dc", "vdc_floor", "np_par", "isc_ref", "ki_t", "irs",
    "gamma", "w_f", "kp_gcc", "ki_gcc", "kp_dc", "ki_dc", "kp_q", "ki_q",
    "kp_pll", "ki_pll", "m_max", "i_max", "const_vdc",
)
U_ORDER = (
    "s_irr", "t_cell", "v_g", "phi_g", "dw_g", "t_g", "v_g2", "phi_g2",
    "g_load", "b_load", "vdc_ref", "q_ref", "conn", "ces", "p_ref",
)

_load_error: str | None = None


def available() -> bool:
    """True when a CUDA device is present and the kernel library built and
    loaded (building it on first call)."""
    global _load_error
    _load_error = None
    if not torch.cuda.is_available():
        _load_error = "no CUDA device is available"
        return False
    from pvderx_torch.ops import _build
    try:
        _build.load()
    except (OSError, RuntimeError) as e:
        _load_error = f"{type(e).__name__}: {e}"
    return _load_error is None


def load_error() -> str | None:
    """Why the last `available()` found the card's engine unavailable."""
    return _load_error


def _device(device) -> torch.device:
    """``device`` as a torch device: the CPU, or a card that is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pvderx_torch native engine: no CUDA device is available "
            "(pass device='cpu' for the plain torch versions)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _f64(a, dev) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float64, device=dev).contiguous()


def pack_params(p: DERParams, device="cuda") -> torch.Tensor:
    """The params as float64 [29] in `P_ORDER`."""
    return _f64([float(getattr(p, f)) for f in P_ORDER], _device(device))


def pack_exog(u: Exog, device="cuda") -> torch.Tensor:
    """The exog as float64 [15] in `U_ORDER`."""
    return _f64([float(getattr(u, f)) for f in U_ORDER], _device(device))


def _one(y, t, p: DERParams, u: Exog, dev):
    """One env as a batch of one: y [1, n_s], t [1], packs [29, 1] / [15, 1]."""
    return (_f64(y, dev).reshape(1, -1), _f64([float(t)], dev),
            pack_params(p, dev)[:, None], pack_exog(u, dev)[:, None])


def rhs(y, t: float, p: DERParams, u: Exog, device="cuda") -> torch.Tensor:
    """dy/dt at (y, t): [n_s]."""
    dev = _device(device)
    return kernels.rhs_batch(*_one(y, t, p, u, dev), n_ph=p.n_ph)[0]


def rk4_window(y, t0: float, dt: float, n_sub: int, p: DERParams, u: Exog,
               device="cuda") -> torch.Tensor:
    """n_sub Kahan-compensated RK4 substeps over [t0, t0 + dt]: y1 [n_s]."""
    dev = _device(device)
    return kernels.rk4_batch(*_one(y, t0, p, u, dev), n_ph=p.n_ph,
                             n_sub=n_sub, dt=dt)[0]


def dp54_window(y, t0: float, dt: float, p: DERParams, u: Exog,
                rtol: float = 1e-10, atol: float = 1e-10,
                device="cuda") -> torch.Tensor:
    """Adaptive DP5(4) over one control window (the truth integrator):
    y1 [n_s]. Raises `RuntimeError` on step-size underflow."""
    dev = _device(device)
    y1, steps, _ = kernels.dp54_batch(*_one(y, t0, p, u, dev), n_ph=p.n_ph,
                                      dt=dt, rtol=rtol, atol=atol)
    if int(steps[0]) < 0:
        raise RuntimeError(f"native DP54 failed at t0={t0}")
    return y1[0]


def _floats(tree):
    """A params / exog dataclass with every leaf a Python float."""
    return dataclasses.replace(tree, **{
        f.name: float(getattr(tree, f.name))
        for f in dataclasses.fields(tree) if f.name != "n_ph"})


def steady_state(p: DERParams, u: Exog, iters: int = 50, tol: float = 1e-11,
                 device="cuda") -> torch.Tensor:
    """Newton steady state from the analytic guess (SPEC §7): y [n_s].
    Raises `RuntimeError` if it does not converge."""
    from pvderx_torch.physics import rhs_core

    dev = _device(device)
    guess = rhs_core.steady_state_guess(_floats(p), _floats(u), np)
    y, _, pk, uk = _one(guess, 0.0, p, u, dev)
    y, res = kernels.newton_batch(y, pk, uk, n_ph=p.n_ph, iters=iters,
                                  tol=tol)
    if int(res[0]) < 0:
        raise RuntimeError("native Newton steady-state did not converge")
    return y[0]


def rk4_window_batch(y, t0, dt: float, n_sub: int, p, u,
                     device="cuda") -> torch.Tensor:
    """Batched RK4 windows: y [N, n_states] -> y1 [N, n_states].

    t0: a float or [N]; p: one DERParams (shared) or a list of N; u: one
    Exog or a list of N. Shared params and exog are expanded to every env.
    """
    dev = _device(device)
    y = _f64(y, dev)
    n_env, _ = y.shape
    t0 = _f64(t0, dev).broadcast_to((n_env,)).contiguous()
    p_list = p if isinstance(p, (list, tuple)) else [p]
    u_list = u if isinstance(u, (list, tuple)) else [u]
    if len(p_list) not in (1, n_env):
        raise ValueError(f"params list has {len(p_list)} entries; "
                         f"need 1 (shared) or n_env={n_env}")
    if len(u_list) not in (1, n_env):
        raise ValueError(f"exog list has {len(u_list)} entries; "
                         f"need 1 (shared) or n_env={n_env}")
    n_ph = p_list[0].n_ph
    if any(q.n_ph != n_ph for q in p_list):
        raise ValueError("mixed n_ph across the params list")
    pp = torch.stack([pack_params(q, dev) for q in p_list], 1)
    uu = torch.stack([pack_exog(q, dev) for q in u_list], 1)
    pp = pp.expand(-1, n_env).contiguous()
    uu = uu.expand(-1, n_env).contiguous()
    return kernels.rk4_batch(y, t0, pp, uu, n_ph=n_ph, n_sub=n_sub, dt=dt)


def run_trajectory(p: DERParams, exog_seq, y0=None, dt: float = 1.0 / 60.0,
                   rtol: float = 1e-10, atol: float = 1e-10,
                   device="cuda") -> torch.Tensor:
    """The native twin of the oracle's `run_trajectory` (DP54 windows):
    [len(exog_seq) + 1, n_states]."""
    dev = _device(device)
    if y0 is None:
        y0 = steady_state(p, exog_seq[0], device=dev)
    ys = [_f64(y0, dev)]
    for k, u in enumerate(exog_seq):
        ys.append(dp54_window(ys[-1], k * dt, dt, p, u, rtol, atol,
                              device=dev))
    return torch.stack(ys)
