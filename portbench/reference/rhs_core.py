"""The PV-DER ODE right-hand side: a frozen copy of the port's physics.

Copied unchanged (below this docstring) from `pvderx_torch/physics/rhs_core.py`
when the benchmark was introduced, so that later changes to the program
cannot move the yardstick. It implements SPEC.md §§4-5 over an array
namespace ``xp`` (`portbench.reference.xp`: numpy in float64 for the
reference, torch for the lower-precision control and the operation count).
Complex phasors are explicit (re, im) pairs (:class:`C`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

TWO_PI_3 = 2.0 * math.pi / 3.0


# --------------------------------------------------------------------------
# complex-pair arithmetic (backend-generic, broadcasts like the underlying xp)
# --------------------------------------------------------------------------
class C(NamedTuple):
    """A complex value/array as an explicit (re, im) pair."""

    re: object
    im: object


def cmul(a: C, b: C) -> C:
    return C(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def cconj(a: C) -> C:
    return C(a.re, -a.im)


def cadd(a: C, b: C) -> C:
    return C(a.re + b.re, a.im + b.im)


def csub(a: C, b: C) -> C:
    return C(a.re - b.re, a.im - b.im)


def cscale(a: C, s) -> C:
    """Multiply by a real scalar/array."""
    return C(a.re * s, a.im * s)


def cjmul(a: C) -> C:
    """Multiply by j."""
    return C(-a.im, a.re)


def cabs(a: C, xp):
    return xp.sqrt(a.re * a.re + a.im * a.im)


def cdiv(a: C, b: C) -> C:
    d = b.re * b.re + b.im * b.im
    return C((a.re * b.re + a.im * b.im) / d, (a.im * b.re - a.re * b.im) / d)


def cinv(b: C) -> C:
    d = b.re * b.re + b.im * b.im
    return C(b.re / d, -b.im / d)


def cexpj(phi, xp) -> C:
    return C(xp.cos(phi), xp.sin(phi))


def cmean(a: C, xp) -> C:
    """Mean over the phase axis (axis 0). All phase-indexed arrays are
    [n_ph] or [n_ph, B] (trailing batch axis), so axis-0 reductions make the
    whole RHS batch-transparent — the plain window (`ops.window`) exploits
    this by calling the identical code on [n_s, N] field-major batches."""
    return C(xp.mean(a.re, axis=0), xp.mean(a.im, axis=0))


# --------------------------------------------------------------------------
# state layout (SPEC.md §2)
# --------------------------------------------------------------------------
def unpack(y, n_ph: int):
    """Split the flat state into phasor pairs + scalars."""
    n = n_ph
    i = C(y[0 * n:1 * n], y[1 * n:2 * n])
    x = C(y[2 * n:3 * n], y[3 * n:4 * n])
    u = C(y[4 * n:5 * n], y[5 * n:6 * n])
    vdc = y[6 * n + 0]
    xdc = y[6 * n + 1]
    xq = y[6 * n + 2]
    xpll = y[6 * n + 3]
    theta = y[6 * n + 4]
    return i, x, u, vdc, xdc, xq, xpll, theta


def pack(di: C, dx: C, du: C, dvdc, dxdc, dxq, dxpll, dth, xp):
    return xp.concatenate([
        di.re, di.im, dx.re, dx.im, du.re, du.im,
        xp.stack([dvdc, dxdc, dxq, dxpll, dth]),
    ])


def _shift_angles(n_ph: int, xp, dtype=None, bdims: int = 0):
    """Per-phase rotation angles [0, -2π/3, +2π/3][:n_ph].

    Shape [n_ph] followed by ``bdims`` singleton axes — phase-indexed arrays
    carry trailing batch axes ([n_ph, N] for a batch of envs), and a bare
    [n_ph] would mis-broadcast against them.
    """
    shape = (n_ph,) + (1,) * bdims
    if n_ph == 1:
        return xp.zeros(shape, dtype=dtype)
    a = xp.asarray([0.0, -TWO_PI_3, TWO_PI_3], dtype=dtype)
    return a.reshape(shape)


# --------------------------------------------------------------------------
# physics
# --------------------------------------------------------------------------
class Algebra(NamedTuple):
    """Algebraic intermediates of SPEC.md §4 (shared by RHS and observations)."""

    i: C         # [n_ph] filter current phasor (pu)
    v: C         # [n_ph] PCC voltage (pu)
    vt: C        # [n_ph] inverter terminal voltage (pu)
    m: C         # [n_ph] modulation index (saturated)
    v_pos: C     # positive-sequence PCC voltage
    i_pos: C     # positive-sequence injected current
    v_q: object  # PLL q-axis voltage
    f_meas: object  # measured frequency [pu]
    p_pv: object    # PV array power [pu total]
    p_inv: object   # inverter terminal power [pu total]
    p_pcc: object   # PCC active power [pu total]
    q_pcc: object   # PCC reactive power [pu total]
    i_ref: C        # [n_ph] current reference
    id_ref: object  # d-axis current reference (post-limit)
    iq_ref: object  # q-axis current reference (post-limit)
    e_dc: object
    e_q: object
    aw: object      # anti-windup gate


SAT_K = 16.0     # p-norm softness of magnitude limits (SPEC.md §4)
AW_KAPPA = 40.0  # anti-windup sigmoid sharpness
VDC_PIN_RATE = 1000.0  # [1/s] stiff-source pin of Vdc in the const-Vdc variant


def _pow16(r):
    """r^16 by repeated squaring (4 multiplies), not a generic pow (an
    exp/log pair); the CUDA kernel squares the same way."""
    r2 = r * r
    r4 = r2 * r2
    r8 = r4 * r4
    return r8 * r8


def soft_limit_scale(mag, lim, xp, inv_lim=None):
    """Smooth radial limiter: scale s.t. mag*s -> lim as mag grows.

    s = (1 + (mag/lim)^k)^(-1/k). Smooth (C-inf) so fixed-step RK4 and the
    adaptive oracle converge to the same trajectory (hard min() kinks leave an
    O(1e-5) integrator-dependent floor at limit-crossing events).
    `inv_lim` (optional): precomputed 1/lim — the limit is window-invariant,
    so the Prep path hoists the reciprocal (all backends share it, so oracle
    and kernel stay arithmetic-identical).
    """
    r = xp.minimum(mag * inv_lim if inv_lim is not None else mag / lim, 8.0)
    return (1.0 + _pow16(r)) ** (-1.0 / SAT_K)


def aw_gate(mag, lim, xp, inv_lim=None):
    """Smooth anti-windup gate: ~1 below the limit, ~0 above."""
    r = mag * inv_lim if inv_lim is not None else mag / lim
    z = AW_KAPPA * (1.0 - r)
    return 1.0 / (1.0 + xp.exp(-xp.minimum(z, 40.0)))


def photo_current(s_irr, t_cell, p):
    """Irradiance/temperature part of the diode model — state-independent,
    so window-invariant under ZOH exogenous inputs (hoisted by Prep)."""
    t_ref = 298.15
    return (p.isc_ref + p.ki_t * (t_cell - t_ref)) * (s_irr / 1000.0)


def pv_power(vdc, s_irr, t_cell, p, xp, iph=None, g_over_t=None,
             inv_s=None):
    """Single-diode array power, pu of S_rated (SPEC.md §4.8).

    exp(x)-1 rather than expm1: x ≈ 17 at operating Vdc so the -1 is far
    below f32 ulp anyway, and every backend has exp.
    `g_over_t`/`inv_s` (optional): hoisted gamma/T_cell and 1/S_rated
    (window-invariant divides — see soft_limit_scale).
    """
    vdc_v = vdc * p.vdc_base
    if iph is None:
        iph = photo_current(s_irr, t_cell, p)
    ex = (g_over_t * vdc_v if g_over_t is not None
          else p.gamma * vdc_v / t_cell)
    i_arr = p.np_par * (iph - p.irs * (xp.exp(ex) - 1.0))
    i_arr = xp.maximum(i_arr, 0.0)
    pw = i_arr * vdc_v
    return pw * inv_s if inv_s is not None else pw / p.s_rated


class Prep(NamedTuple):
    """Window-invariant precomputations (state- and time-independent under
    the ZOH contract, SPEC.md §3): computed once per control window by the
    window integrators instead of at every RK4 RHS evaluation. A `None` prep
    means "compute inline" (the default/oracle path — identical arithmetic,
    so the two modes agree bitwise). The reciprocals (inv_*/g_over_t) turn
    8 of the ~17 divides per RHS evaluation into multiplies."""

    y_g: C          # grid admittance 1/(rg + j·xg)
    y_tot: C        # y_g + load admittance
    inv_y_tot: C    # 1/y_tot — turns the per-eval PCC cdiv into a cmul
    en: object      # conn·(1-ces)
    iph: object     # photo-current of the diode model
    inv_m_max: object   # 1/m_max (modulation soft limiter)
    inv_i_max: object   # 1/i_max (current soft limiter + anti-windup gate)
    g_over_t: object    # gamma/T_cell (diode exponent)
    inv_s: object       # 1/S_rated (power normalization)
    a_k: object     # phase rotators exp(j·phi_k) (None for n_ph == 1)
    v2: object      # neg-seq source phasor v_g2·e^{j·phi_g2}·conj(a_k) [n_ph]
                    # (None for n_ph == 1 — unbalance needs three phases)


def prep_invariants(p, u, xp, bdims: int = 0) -> Prep:
    """Build the per-window invariants (see Prep)."""
    y_g = cinv(C(p.rg, p.xg))
    y_tot = C(y_g.re + u.g_load, y_g.im + u.b_load)
    en = u.conn * (1.0 - u.ces)
    iph = photo_current(u.s_irr, u.t_cell, p)
    if p.n_ph == 1:
        a_k = v2 = None
    else:
        a_k = cexpj(_shift_angles(p.n_ph, xp, None, bdims), xp)
        v2 = cscale(cmul(cexpj(u.phi_g2, xp), cconj(a_k)), u.v_g2)
    one = 1.0 + 0.0 * en
    return Prep(y_g=y_g, y_tot=y_tot, inv_y_tot=cinv(y_tot), en=en, iph=iph,
                inv_m_max=one / p.m_max, inv_i_max=one / p.i_max,
                g_over_t=p.gamma / u.t_cell, inv_s=one / p.s_rated,
                a_k=a_k, v2=v2)


def grid_rot(t, p, u, xp) -> C:
    """Grid-source rotation phasor e^{j(phi_g + w_base*dw_g*(t - t_g))}
    (SPEC §4.2). A pure function of time under the ZOH contract — the window
    integrators compute it once per RK4 stage *time* (2 per substep: the
    half-point is shared by k2/k3 and the endpoint is the next substep's
    start) instead of once per RHS evaluation (4)."""
    return cexpj(u.phi_g + p.w_base * u.dw_g * (t - u.t_g), xp)


def pcc_voltage(i_inj, t, p, u, xp, prep: Prep | None = None,
                rot: C | None = None) -> C:
    """PCC voltage from the grid Thevenin source + load + injected current
    (SPEC §4.1-4.2). `i_inj` is the total injected phase-current phasor pair
    [n_ph] — for a fleet on a shared feeder, pass the per-unit *mean* over
    units (currents in per-unit of the aggregate base; SPEC §11)."""
    n_ph = p.n_ph
    if prep is None:
        prep = prep_invariants(p, u, xp, getattr(i_inj.re, "ndim", 1) - 1)
    if rot is None:
        rot = grid_rot(t, p, u, xp)
    v_gpos = cscale(rot, u.v_g)
    # n_ph == 1: a_k = exp(j·0) = 1+0j — multiplying by it is a bitwise
    # identity in IEEE arithmetic, so skip it (broadcasting against i_inj's
    # leading phase axis keeps shapes); big win inside the window kernel.
    # n_ph == 3: both sequence components rotate with the common grid phase
    # `rot` (the grid is one unbalanced three-phase source at grid frequency);
    # the neg-seq phasor prep.v2 is window-invariant (SPEC.md §4.2).
    if n_ph == 1:
        v_g = v_gpos
    else:
        v_g = cadd(cmul(v_gpos, prep.a_k), cmul(rot, prep.v2))
    return cmul(cadd(cmul(v_g, prep.y_g), i_inj), prep.inv_y_tot)


def algebra_given_v(y, t, p, u, v: C, xp, prep: Prep | None = None) -> Algebra:
    """All algebraic relations of SPEC.md §4 downstream of the PCC voltage
    (the fleet coupling point: a shared feeder computes `v` once from the
    total injection, then evaluates this per unit-DER)."""
    n_ph = p.n_ph
    if prep is None:
        prep = prep_invariants(p, u, xp, getattr(y, "ndim", 1) - 1)
    i, x, uf, vdc, xdc, xq, xpll, theta = unpack(y, n_ph)
    i_inj = cscale(i, u.conn)
    if n_ph == 1:
        # a_k ≡ 1: rotations are bitwise identities (see pcc_voltage)
        v_pos = cmean(v, xp)
        i_pos = cmean(i_inj, xp)
    else:
        a_k = prep.a_k
        v_pos = cmean(cmul(v, cconj(a_k)), xp)
        i_pos = cmean(cmul(i_inj, cconj(a_k)), xp)

    # modulation + terminal voltage (SPEC §4.4-4.5), smooth saturation
    m_raw = cadd(cscale(uf, p.kp_gcc), x)
    m_mag = xp.sqrt(m_raw.re * m_raw.re + m_raw.im * m_raw.im + 1e-30)
    m = cscale(m_raw, soft_limit_scale(m_mag, p.m_max, xp, prep.inv_m_max))
    vdc_pos = xp.maximum(vdc, p.vdc_floor)
    vt = cscale(m, p.kv * vdc_pos)

    # PLL (SPEC §4.6). One cexpj serves both the -theta rotation (via conj)
    # and the +theta current-reference rotation below — halves the sin/cos
    # count of the hot loop (cos(-θ)=cos(θ), sin(-θ)=-sin(θ) exactly).
    e_th = cexpj(theta, xp)
    v_q = cmul(v_pos, cconj(e_th)).im
    f_meas = 1.0 + p.kp_pll * v_q + xpll

    # powers
    p_inv = xp.mean(cmul(vt, cconj(i)).re, axis=0)
    s_pcc = cmul(v, cconj(i_inj))
    p_pcc = xp.mean(s_pcc.re, axis=0)
    q_pcc = xp.mean(s_pcc.im, axis=0)
    p_pv = pv_power(vdc, u.s_irr, u.t_cell, p, xp, iph=prep.iph,
                    g_over_t=prep.g_over_t, inv_s=prep.inv_s)

    # outer loops -> current reference (SPEC §4.7). The const-Vdc variant
    # (SURVEY.md §2.1 #7) retargets the d-axis loop from Vdc regulation to
    # active-power tracking of u.p_ref — branchless blend on p.const_vdc.
    c = p.const_vdc
    e_dc = (1.0 - c) * (vdc - u.vdc_ref) + c * (u.p_ref - p_pcc)
    id_raw = p.kp_dc * e_dc + xdc
    e_q = u.q_ref - q_pcc
    iq_raw = -(p.kp_q * e_q + xq)
    mag = xp.sqrt(id_raw * id_raw + iq_raw * iq_raw + 1e-30)
    s_lim = soft_limit_scale(mag, p.i_max, xp, prep.inv_i_max)
    en = prep.en
    id_ref = id_raw * s_lim
    iq_ref = iq_raw * s_lim
    i_dq = cmul(C(id_ref, iq_ref), e_th)
    i_ref = cscale(i_dq if n_ph == 1 else cmul(i_dq, a_k), en)
    aw = en * aw_gate(mag, p.i_max, xp, prep.inv_i_max)

    return Algebra(i=i, v=v, vt=vt, m=m, v_pos=v_pos, i_pos=i_pos, v_q=v_q,
                   f_meas=f_meas, p_pv=p_pv, p_inv=p_inv, p_pcc=p_pcc,
                   q_pcc=q_pcc, i_ref=i_ref, id_ref=id_ref, iq_ref=iq_ref,
                   e_dc=e_dc, e_q=e_q, aw=aw)


def algebra(y, t, p, u, xp, prep: Prep | None = None,
            rot: C | None = None) -> Algebra:
    """All algebraic relations of SPEC.md §4 (single DER on its own feeder)."""
    i, *_ = unpack(y, p.n_ph)
    if prep is None:
        prep = prep_invariants(p, u, xp, getattr(y, "ndim", 1) - 1)
    v = pcc_voltage(cscale(i, u.conn), t, p, u, xp, prep, rot)
    return algebra_given_v(y, t, p, u, v, xp, prep)


def rhs_from_algebra(y, t, p, u, g: Algebra, xp, prep: Prep | None = None):
    """Assemble dy/dt (SPEC.md §5) from precomputed algebra."""
    n_ph = p.n_ph
    i, x, uf, vdc, xdc, xq, xpll, theta = unpack(y, n_ph)
    en = (u.conn * (1.0 - u.ces)) if prep is None else prep.en

    wb = p.w_base
    di_conn = csub(cscale(csub(csub(g.vt, g.v), cscale(i, p.rf)), wb / p.lf),
                   cscale(cjmul(i), wb))
    di = cadd(cscale(di_conn, u.conn), cscale(i, -(1.0 - u.conn) * wb))
    du = cscale(csub(csub(g.i_ref, i), uf), p.w_f)
    dx = cscale(uf, p.ki_gcc * en)

    vdc_pos = xp.maximum(vdc, p.vdc_floor)
    c = p.const_vdc
    # const-Vdc variant: a stiff external DC source pins the bus to vdc_ref
    # (first-order at VDC_PIN_RATE — keeps the steady-state Jacobian
    # nonsingular, unlike a structurally-zero dVdc row)
    dvdc = ((1.0 - c) * (g.p_pv - u.conn * g.p_inv) / (p.tau_dc * vdc_pos)
            + c * VDC_PIN_RATE * (u.vdc_ref - vdc))
    dxdc = p.ki_dc * g.e_dc * g.aw
    dxq = p.ki_q * g.e_q * g.aw
    dxpll = p.ki_pll * g.v_q
    dth = wb * (p.kp_pll * g.v_q + xpll)

    return pack(di, dx, du, dvdc, dxdc, dxq, dxpll, dth, xp)


def rhs(y, t, p, u, xp, prep: Prep | None = None, rot: C | None = None):
    """dy/dt per SPEC.md §5. Pure; static shapes; branchless.

    `prep` (optional) supplies the window-invariant precomputations; `rot`
    (optional) the grid rotation phasor at time t (see grid_rot). Passing
    them changes nothing numerically (identical arithmetic) but lets the
    window integrators hoist/share that work across RHS evaluations."""
    g = algebra(y, t, p, u, xp, prep, rot)
    return rhs_from_algebra(y, t, p, u, g, xp, prep)


def rhs_given_v(y, t, p, u, v: C, xp, prep: Prep | None = None):
    """dy/dt with an externally supplied PCC voltage (fleet coupling)."""
    g = algebra_given_v(y, t, p, u, v, xp, prep)
    return rhs_from_algebra(y, t, p, u, g, xp, prep)


def neg_seq(x: C, n_ph: int, xp) -> C:
    """Negative-sequence component of a per-phase phasor set [n_ph]:
    mean_k(x_k·a_k), the inverse of the conj(a_k) pos-seq extraction in
    `algebra_given_v`. Zero for n_ph == 1. Diagnostics/observations only —
    never evaluated inside the RHS hot loop."""
    if n_ph == 1:
        return C(0.0 * x.re[0], 0.0 * x.im[0])
    a_k = cexpj(_shift_angles(n_ph, xp, None, getattr(x.re, "ndim", 1) - 1), xp)
    return cmean(cmul(x, a_k), xp)


def steady_state_guess(p, u, xp):
    """Analytic warm start for the steady-state solve (SPEC.md §7)."""
    theta = u.phi_g
    vdc = u.vdc_ref
    a_k = cexpj(_shift_angles(p.n_ph, xp, getattr(u.phi_g, "dtype", None)), xp)
    ones = 1.0 + 0.0 * a_k.re
    v = cscale(cmul(cexpj(u.phi_g, xp), a_k), u.v_g)   # ignore grid impedance drop
    vmag = xp.maximum(cabs(C(v.re[0], v.im[0]), xp), 1e-6)
    p_pv = pv_power(vdc, u.s_irr, u.t_cell, p, xp)
    p_cmd = (1.0 - p.const_vdc) * p_pv + p.const_vdc * u.p_ref
    id0 = p_cmd / vmag
    iq0 = -u.q_ref / vmag
    i = cmul(cmul(C(id0, iq0), cexpj(theta, xp)), a_k)
    vt = cadd(v, cmul(C(p.rf, p.lf), i))
    m = cscale(vt, 1.0 / (p.kv * xp.maximum(vdc, p.vdc_floor)))
    x = m
    uf = C(0.0 * ones, 0.0 * ones)
    zero = 0.0 * id0
    tail = xp.stack([vdc + zero, id0 + zero, -iq0 + zero, zero, theta + zero])
    return xp.concatenate([i.re, i.im, x.re, x.im, uf.re, uf.im, tail])
