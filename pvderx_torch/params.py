"""DER parameters, exogenous inputs, and presets (the port's own copy).

All numeric values are those of SPEC.md §10. ``make_params`` returns Python
float leaves; ``.to(dtype, device)`` turns them into 0-d tensors, and
per-env batches are the same dataclasses with ``[N]`` tensor leaves.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from pvderx_torch._struct import replace, struct

Q_E = 1.602176634e-19   # elementary charge [C]
K_B = 1.380649e-23      # Boltzmann [J/K]
T_REF = 298.15          # STC cell temperature [K]
F0 = 60.0
W_BASE = 2.0 * math.pi * F0


def _to(obj, dtype, device, skip=()):
    kw = {f.name: (getattr(obj, f.name) if f.name in skip else
                   torch.as_tensor(getattr(obj, f.name), dtype=dtype,
                                   device=device))
          for f in dataclasses.fields(obj)}
    return type(obj)(**kw)


@struct
class DERParams:
    """Per-unit DER + grid + controller parameters (SPEC.md §§1,4,5,10).

    ``n_ph`` is static; every other field is a leaf (a float, a 0-d tensor,
    or an ``[N]`` tensor for a per-env batch).
    """

    n_ph: int
    # circuit (pu)
    rf: float
    lf: float
    rg: float
    xg: float
    # bases / conversion
    kv: float          # Vdc_base / (2 V_base)
    w_base: float
    s_rated: float     # [VA] all phases
    v_base: float      # [V] peak phase
    i_base: float      # [A] peak phase
    vdc_base: float    # [V]
    # DC link
    tau_dc: float      # [s]
    vdc_floor: float
    # PV array (single-diode, SPEC §4.8)
    np_par: float
    isc_ref: float     # [A] module short-circuit current at STC
    ki_t: float        # [A/K]
    irs: float         # [A]
    gamma: float       # q/(kB*A*Nc*Ns) [K/V]; diode exponent = gamma*Vdc_V/T
    # controllers
    w_f: float
    kp_gcc: float
    ki_gcc: float
    kp_dc: float
    ki_dc: float
    kp_q: float
    ki_q: float
    kp_pll: float
    ki_pll: float
    # limits
    m_max: float
    i_max: float
    # model variant: 1.0 = constant-Vdc three-phase variant: the DC bus is
    # pinned to vdc_ref by a stiff external source and the d-axis outer loop
    # tracks the active-power setpoint `Exog.p_ref` instead of Vdc.
    const_vdc: float

    @property
    def n_states(self) -> int:
        return 6 * self.n_ph + 5

    def to(self, dtype=torch.float32, device="cuda") -> "DERParams":
        return _to(self, dtype, device, skip=("n_ph",))


@struct
class Exog:
    """Exogenous inputs, zero-order-held over one control step (SPEC.md §3)."""

    s_irr: float    # insolation [W/m^2]
    t_cell: float   # cell temperature [K]
    v_g: float      # grid voltage magnitude, positive sequence [pu]
    phi_g: float    # grid voltage angle [rad]
    dw_g: float     # grid frequency deviation [pu]
    t_g: float      # activation time of current grid event [s]
    # unbalanced grid source (three-phase only; ignored for n_ph == 1):
    # negative-sequence component in symmetric-component form
    v_g2: float     # negative-sequence magnitude [pu]
    phi_g2: float   # negative-sequence angle relative to phi_g [rad]
    g_load: float   # local load conductance [pu]
    b_load: float   # local load susceptance [pu]
    vdc_ref: float  # [pu]
    q_ref: float    # [pu total]
    conn: float     # breaker closed (1) / tripped open (0)
    ces: float      # momentary cessation flag
    p_ref: float    # [pu total] active-power setpoint (const-Vdc variant only)

    def to(self, dtype=torch.float32, device="cuda") -> "Exog":
        return _to(self, dtype, device)


def nominal_exog(vdc_ref: float = 1.0, q_ref: float = 0.0,
                 p_ref: float = 0.0) -> Exog:
    return Exog(
        s_irr=1000.0, t_cell=T_REF, v_g=1.0, phi_g=0.0, dw_g=0.0, t_g=0.0,
        v_g2=0.0, phi_g2=0.0,
        g_load=0.0, b_load=0.0, vdc_ref=vdc_ref, q_ref=q_ref, conn=1.0, ces=0.0,
        p_ref=p_ref,
    )


# --- module constants (classic 305 W / 96-cell module, SPEC.md §10) -----------
_MOD = dict(voc=64.2, isc=5.96, n_cells=96.0, ideality=1.3, ki_t=3.5e-3)

# preset -> (n_ph, S_rated, V_rms, Vdc_base, Ns, Np, C_dc)
PRESETS = {
    "10": dict(n_ph=1, s_rated=10e3, v_rms=120.0, vdc_base=550.0, ns=10, np_par=3, c_dc=4700e-6),
    "50": dict(n_ph=3, s_rated=50e3, v_rms=277.0, vdc_base=1100.0, ns=20, np_par=8, c_dc=4400e-6),
    "250": dict(n_ph=3, s_rated=250e3, v_rms=277.0, vdc_base=1100.0, ns=20, np_par=41, c_dc=22000e-6),
}

_SHARED = dict(
    rf=0.015, lf=0.15, rg=0.01, xg=0.1, vdc_floor=0.1,
    w_f=6283.0, kp_gcc=0.5, ki_gcc=100.0, kp_dc=4.0, ki_dc=40.0,
    kp_q=0.5, ki_q=30.0, kp_pll=0.4, ki_pll=8.0, m_max=1.0, i_max=1.2,
    const_vdc=0.0,
)


def make_params(preset: str = "10", validate: bool = True,
                **overrides) -> DERParams:
    """Build a :class:`DERParams` (Python-float leaves) from a named preset.

    With ``validate=True`` (default) the result is range- and
    consistency-checked (`pvderx_torch.checks.check_parameters`) and bad
    values raise ``ValueError`` listing every violation.
    """
    c = PRESETS[preset]
    v_base = math.sqrt(2.0) * c["v_rms"]
    s_base = c["s_rated"] / c["n_ph"]
    i_base = 2.0 * s_base / v_base
    # module diode exponent at module level; gamma folds in Ns so the RHS uses
    # the array voltage directly: exponent = gamma * Vdc_V / T  (SPEC §4.8)
    beta_mod = Q_E / (K_B * _MOD["ideality"] * _MOD["n_cells"])  # [K/V] per module
    gamma = beta_mod / c["ns"]
    irs = _MOD["isc"] / math.expm1(beta_mod * _MOD["voc"] / T_REF)
    kw = dict(
        n_ph=c["n_ph"],
        kv=c["vdc_base"] / (2.0 * v_base),
        w_base=W_BASE,
        s_rated=c["s_rated"],
        v_base=v_base,
        i_base=i_base,
        vdc_base=c["vdc_base"],
        tau_dc=c["c_dc"] * c["vdc_base"] ** 2 / c["s_rated"],
        np_par=float(c["np_par"]),
        isc_ref=_MOD["isc"],
        ki_t=_MOD["ki_t"],
        irs=irs,
        gamma=gamma,
        **_SHARED,
    )
    kw.update(overrides)
    der = DERParams(**kw)
    if validate:
        from pvderx_torch.checks import check_parameters
        check_parameters(der)
    return der


__all__ = [
    "DERParams", "Exog", "nominal_exog", "make_params", "PRESETS",
    "replace", "T_REF", "W_BASE",
]
