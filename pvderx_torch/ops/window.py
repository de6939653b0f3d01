"""The fused RK4 control-window integrators: CUDA kernels and plain versions.

This is the hot op of the engine: 4·n_sub RHS evaluations per env per
control window. Two windows, each a hand-written CUDA kernel beside its
plain torch version:

- `rk4_window_batch`, one DER per env (`csrc/window.cu`, one thread per env,
  state in registers, one pass over device memory per window);
- `rk4_fleet_window_batch`, M DERs per env on a shared feeder
  (`csrc/fleet_window.cu`, one thread per unit, the M-mean injection reduced
  across the env's lanes in every RHS evaluation).

A wrapper launches its kernel on tensors that live on the card and runs the
plain version (`*_ref`) on tensors that live on the CPU. There is no
fallback between the two: a CUDA tensor launches the kernel or raises.

The kernels have no backward. The plain versions are torch operations and
differentiable; a launch with grad enabled and an input that requires grad
raises (`_build.guard_launch`) instead of returning an output that silently
drops the window's share of the gradient: `pvderx_torch.ode.rk4_window` is
the differentiable window. While `pvderx_torch.diag.debug.debug_mode` traps
NaNs, which its dispatch mode cannot see inside a kernel, every launch
checks its outputs (`_build.check_outputs`). Every kernel of the port is
launched through `_build.launch`.

Both compute what the reference Pallas kernel computes: exog held constant
over the window; the window-invariant `Prep` hoisted once; the grid phasor
evaluated twice per substep (k2/k3 share the half-point, and the endpoint is
the next substep's k1); Kahan-compensated accumulation in a fixed order.

On the CPU the plain versions run the batch padded to a multiple of
`CPU_LANES` envs (`pad_envs`; a reset's draws by `pad_draws`, its state
cut back by `unpad_reset`): torch's CPU elementwise kernels run a vector
loop over whole blocks and a scalar loop over the rest, and the two can
differ in the last bit (``pow`` with a scalar exponent). Padded, every env
takes the vector loop, so an env's result does not depend on the batch
size or on its place in the batch: W ranks stepping N/W envs each give the
one-rank run's bits. This holds with one intra-op thread (as
`pvderx_torch.dist.launch --cpu` gives each rank): on several, torch splits
an op of 32768 elements or more at offsets that need not be multiples of
`CPU_LANES`, each chunk gets a scalar tail, and the batch size matters
again. (One thread per env on the card has no such effect.)
"""
from __future__ import annotations

import dataclasses

import torch

from pvderx_torch._struct import tree_map
from pvderx_torch.ops import _build
from pvderx_torch.params import DERParams, Exog
from pvderx_torch.physics import fleet, rhs_core
from pvderx_torch.physics.xp import like

P_FIELDS = [f.name for f in dataclasses.fields(DERParams) if f.name != "n_ph"]
# a multiple of every CPU vector loop's block (AVX-512 float32: 2 x 16 lanes)
CPU_LANES = 32
U_FIELDS = [f.name for f in dataclasses.fields(Exog)]

# Operations per env per RK4 substep of this window program (4 RHS
# evaluations with hoisted Prep, 2 grid rotations, the Kahan combine), as
# the reference's jaxpr op counter counts them (pvderx/diag/roofline.py);
# `pvderx_torch.diag.roofline.substep_op_count` re-derives them from this
# package's own program.
OPS_PER_SUBSTEP = {1: 923, 3: 2371}


def pack_struct(tree, fields) -> torch.Tensor:
    """Stack a dataclass of [N] leaves into one [n_fields, N] tensor."""
    return torch.stack([getattr(tree, f) for f in fields])


def unpack_struct(cls, arr, fields, **meta):
    """Rebuild the dataclass with index-0 views of a [n_fields, ...] tensor."""
    kw = {f: arr[i] for i, f in enumerate(fields)}
    kw.update(meta)
    return cls(**kw)


def window_bytes(n: int, n_ph: int) -> int:
    """Device-memory bytes one window must move: one f32 read of
    (t0, y, p_pack, u_pack) and one f32 write of y1 per env."""
    n_s = 6 * n_ph + 5
    return 4 * n * (1 + 2 * n_s + len(P_FIELDS) + len(U_FIELDS))


def window_ops(n: int, n_ph: int, n_sub: int) -> int:
    """Arithmetic operations one window of n envs performs."""
    return OPS_PER_SUBSTEP[n_ph] * n_sub * n


def pad_envs(n: int, *tensors_axes):
    """The tensors, each ``(tensor, env axis)``, padded on the CPU to a
    multiple of `CPU_LANES` envs with copies of env ``n - 1`` (unchanged on
    the card, or when ``n`` is a multiple already)."""
    k = -n % CPU_LANES
    if k == 0 or tensors_axes[0][0].device.type != "cpu":
        return [t for t, _ in tensors_axes]
    return [torch.cat([t, t.narrow(ax, n - 1, 1).expand(
        *(k if i == ax else d for i, d in enumerate(t.shape)))], ax)
        for t, ax in tensors_axes]


def pad_tree(n: int, tree):
    """`pad_envs` of every ``[n, ...]`` leaf of a dataclass (env axis
    leading; 0-d leaves stay): the per-env inputs a closure over the batch
    holds, for a window that takes no packs (`ode.implicit`)."""
    return tree_map(lambda x: pad_envs(n, (x, 0))[0] if x.dim() else x,
                    tree)


def pad_draws(n: int, *draws):
    """A reset's draws ([n, ...] each) padded like `pad_envs`, and the padded
    count: the whole reset then runs every env through the CPU's vector
    loops, so an env's steady state does not depend on the batch size."""
    out = pad_envs(n, *((d, 0) for d in draws))
    return out, out[0].shape[0]


def unpad_reset(state, obs, n: int, n_pad: int):
    """The first ``n`` envs of a reset made on ``n_pad`` (`pad_draws`):
    (state, obs); 0-d fields stay whole."""
    if n == n_pad:
        return state, obs
    return (tree_map(lambda x: x[:n].clone() if x.dim() else x, state),
            obs[:n].clone())


def _substep_constants(dt: float, n_sub: int):
    """(h, h/2, h/6) as Python doubles. Both versions round each ONCE to the
    working type, as the reference kernel does with its Python-double
    constants, so the substep times ``t0 + k*h`` agree."""
    h = dt / n_sub
    return h, 0.5 * h, h / 6.0


def _check(y, n_ph, **want):
    """Shapes, devices and dtypes of a window's arguments: y ends in n_s
    states; ``want`` maps each other argument's name to (tensor, shape)."""
    n_s = 6 * n_ph + 5
    if n_ph not in (1, 3):
        raise ValueError(f"n_ph must be 1 or 3, got {n_ph}")
    if y.shape[-1] != n_s or min(y.shape) < 1:
        raise ValueError(f"y must end in {n_s} states with every axis >= 1, "
                         f"got {tuple(y.shape)}")
    for name, (a, shape) in want.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
    for name, a in {"y": y, **{k: v[0] for k, v in want.items()}}.items():
        if a.device != y.device:
            raise ValueError(f"{name} is on {a.device}, y on {y.device}")
        if a.dtype != y.dtype:
            raise ValueError(f"{name} is {a.dtype}, y is {y.dtype}")


def _check_single(y, t0, p_pack, u_pack, n_ph):
    if y.dim() != 2:
        raise ValueError(f"y must be [N, n_s], got {tuple(y.shape)}")
    n = y.shape[0]
    _check(y, n_ph, t0=(t0, (n,)), p_pack=(p_pack, (len(P_FIELDS), n)),
           u_pack=(u_pack, (len(U_FIELDS), n)))


def _check_fleet(y, t0, p_pack, u_pack, n_ph, m):
    if y.dim() != 3 or y.shape[1] != m:
        raise ValueError(f"y must be [N, M={m}, n_s], got {tuple(y.shape)}")
    n = y.shape[0]
    _check(y, n_ph, t0=(t0, (n,)), p_pack=(p_pack, (len(P_FIELDS), n, m)),
           u_pack=(u_pack, (len(U_FIELDS), n, m)))


def _float32(what: str, y) -> None:
    if y.dtype != torch.float32:
        raise ValueError(f"the CUDA {what} kernel takes float32, got {y.dtype}")


def rk4_window_batch_ref(y, t0, p_pack, u_pack, *, n_ph: int, n_sub: int,
                         dt: float):
    """Plain torch version of the window: the same hoisted arithmetic through
    `rhs_core` on [n_s, N] field-major tensors. y: [N, n_s]; t0: [N];
    p_pack: [29, N]; u_pack: [15, N]. Returns y1 [N, n_s]."""
    _check_single(y, t0, p_pack, u_pack, n_ph)
    n = y.shape[0]
    y, t0, p_pack, u_pack = pad_envs(n, (y, 0), (t0, 0), (p_pack, 1),
                                     (u_pack, 1))
    xp = like(y)
    p = unpack_struct(DERParams, p_pack, P_FIELDS, n_ph=n_ph)
    u = unpack_struct(Exog, u_pack, U_FIELDS)
    prep = rhs_core.prep_invariants(p, u, xp, bdims=1)
    h, hh, h6 = (torch.tensor(c, dtype=y.dtype, device=y.device)
                 for c in _substep_constants(dt, n_sub))
    yt = y.T
    c = torch.zeros_like(yt)
    r1 = rhs_core.grid_rot(t0, p, u, xp)
    for k in range(n_sub):
        t = t0 + k * h
        rh = rhs_core.grid_rot(t + hh, p, u, xp)
        r4 = rhs_core.grid_rot(t + h, p, u, xp)
        k1 = rhs_core.rhs(yt, t, p, u, xp, prep, r1)
        k2 = rhs_core.rhs(yt + hh * k1, t + hh, p, u, xp, prep, rh)
        k3 = rhs_core.rhs(yt + hh * k2, t + hh, p, u, xp, prep, rh)
        k4 = rhs_core.rhs(yt + h * k3, t + h, p, u, xp, prep, r4)
        d = (h6 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)) - c
        s = yt + d
        c = (s - yt) - d
        yt, r1 = s, r4
    return yt.T[:n].contiguous()


def rk4_window_batch(y, t0, p_pack, u_pack, *, n_ph: int, n_sub: int,
                     dt: float):
    """Integrate all N envs over one control window.

    y: [N, n_s]; t0: [N]; p_pack: [29, N]; u_pack: [15, N], all contiguous
    and on one device. Returns y1 [N, n_s]. Any N >= 1.

    On the CPU this is `rk4_window_batch_ref` (float32 or float64). On a
    CUDA device the tensors must be float32, and the CUDA kernel runs on
    the current stream; each launch adds one to ``rk4_window_batch.launches``.
    """
    _check_single(y, t0, p_pack, u_pack, n_ph)
    if y.device.type == "cpu":
        return rk4_window_batch_ref(y, t0, p_pack, u_pack, n_ph=n_ph,
                                    n_sub=n_sub, dt=dt)
    _float32("window", y)
    out = torch.empty_like(y)
    _build.launch("pvderx_rk4_window", "window", y, t0, p_pack, u_pack, out,
                  y.shape[0], n_ph, n_sub, *_substep_constants(dt, n_sub),
                  check=(out,))
    rk4_window_batch.launches += 1
    return out


rk4_window_batch.launches = 0


# ---------------------------------------------------------------------------
# the fleet window: M DERs per env on a shared feeder
# ---------------------------------------------------------------------------
# The CUDA fleet kernel runs one env's units in one block (csrc/fleet_window.cu)
MAX_UNITS_CUDA = 1024


def fleet_window_bytes(n: int, m: int, n_ph: int) -> int:
    """Device-memory bytes one fleet window must move: one f32 read of t0
    per env and of (y, p_pack, u_pack) per unit, one f32 write of y1."""
    n_s = 6 * n_ph + 5
    return 4 * n * (1 + m * (2 * n_s + len(P_FIELDS) + len(U_FIELDS)))


def fleet_window_ops(n: int, m: int, n_ph: int, n_sub: int) -> int:
    """Arithmetic operations one fleet window of n envs performs, counted as
    M single-DER windows (the reference's convention; it over-counts the
    shared PCC voltage by ~1%)."""
    return OPS_PER_SUBSTEP[n_ph] * m * n_sub * n


def rk4_fleet_window_batch_ref(y, t0, p_pack, u_pack, *, n_ph: int, m: int,
                               n_sub: int, dt: float):
    """Plain torch version of the fleet window, on [n_s, N, M] field-major
    tensors: per-unit `Prep`, the feeder's `Prep` and grid rotation from unit
    0's fields, and in every RHS evaluation the M-mean of conn·i, the shared
    `pcc_voltage`, then `rhs_given_v` per unit. y: [N, M, n_s]; t0: [N];
    p_pack: [29, N, M]; u_pack: [15, N, M]. Returns y1 [N, M, n_s]."""
    _check_fleet(y, t0, p_pack, u_pack, n_ph, m)
    n = y.shape[0]
    y, t0, p_pack, u_pack = pad_envs(n, (y, 0), (t0, 0), (p_pack, 1),
                                     (u_pack, 1))
    xp = like(y)
    p = unpack_struct(DERParams, p_pack, P_FIELDS, n_ph=n_ph)
    u = unpack_struct(Exog, u_pack, U_FIELDS)
    p_sh, u_sh = fleet.shared(p), fleet.shared(u)
    prep = rhs_core.prep_invariants(p, u, xp, bdims=2)
    prep_sh = rhs_core.prep_invariants(p_sh, u_sh, xp, bdims=2)
    h, hh, h6 = (torch.tensor(c, dtype=y.dtype, device=y.device)
                 for c in _substep_constants(dt, n_sub))

    def f(yy, t, rot):
        i_inj = fleet.mean_injection(yy, u, n_ph, xp)
        v = rhs_core.pcc_voltage(i_inj, t, p_sh, u_sh, xp, prep_sh, rot)
        return rhs_core.rhs_given_v(yy, t, p, u, v, xp, prep)

    t0 = t0[:, None]
    yt = y.permute(2, 0, 1)
    c = torch.zeros_like(yt)
    r1 = rhs_core.grid_rot(t0, p_sh, u_sh, xp)
    for k in range(n_sub):
        t = t0 + k * h
        rh = rhs_core.grid_rot(t + hh, p_sh, u_sh, xp)
        r4 = rhs_core.grid_rot(t + h, p_sh, u_sh, xp)
        k1 = f(yt, t, r1)
        k2 = f(yt + hh * k1, t + hh, rh)
        k3 = f(yt + hh * k2, t + hh, rh)
        k4 = f(yt + h * k3, t + h, r4)
        d = (h6 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)) - c
        s = yt + d
        c = (s - yt) - d
        yt, r1 = s, r4
    return yt.permute(1, 2, 0)[:n].contiguous()


def rk4_fleet_window_batch(y, t0, p_pack, u_pack, *, n_ph: int, m: int,
                           n_sub: int, dt: float):
    """Integrate N fleet envs (M units each) over one control window.

    y: [N, M, n_s]; t0: [N]; p_pack: [29, N, M]; u_pack: [15, N, M], all
    contiguous and on one device. Returns y1 [N, M, n_s]. Any N >= 1 and
    M >= 1 (at most MAX_UNITS_CUDA on the card).

    On the CPU this is `rk4_fleet_window_batch_ref` (float32 or float64). On
    a CUDA device the tensors must be float32, and the CUDA kernel runs on
    the current stream; each launch adds one to
    ``rk4_fleet_window_batch.launches``.
    """
    _check_fleet(y, t0, p_pack, u_pack, n_ph, m)
    if y.device.type == "cpu":
        return rk4_fleet_window_batch_ref(y, t0, p_pack, u_pack, n_ph=n_ph,
                                          m=m, n_sub=n_sub, dt=dt)
    if m > MAX_UNITS_CUDA:
        raise ValueError(f"the CUDA fleet kernel takes M <= {MAX_UNITS_CUDA} "
                         f"units per env, got {m}")
    _float32("fleet window", y)
    out = torch.empty_like(y)
    _build.launch("pvderx_rk4_fleet_window", "fleet window", y, t0, p_pack,
                  u_pack, out, y.shape[0], m, n_ph, n_sub,
                  *_substep_constants(dt, n_sub), check=(out,))
    rk4_fleet_window_batch.launches += 1
    return out


rk4_fleet_window_batch.launches = 0
