"""DER parameters and exogenous inputs of the frozen reference.

`make_params` is a copy of the arithmetic of `pvderx_torch/params.py`'s
`make_params` (SPEC.md §10), taken when the benchmark was introduced, but it
reads its numbers from a configuration file's ``"der"`` block instead of the
program's preset table, so the configuration file states the deployment in
full. Leaves are Python floats (one DER, broadcast over a batch).
"""
from __future__ import annotations

import dataclasses
import math

Q_E = 1.602176634e-19   # elementary charge [C]
K_B = 1.380649e-23      # Boltzmann [J/K]
T_REF = 298.15          # STC cell temperature [K]


@dataclasses.dataclass(frozen=True)
class DERParams:
    """Per-unit DER, grid and controller parameters (the fields and order of
    the program's `DERParams`: 29 numbers and ``n_ph``)."""

    n_ph: int
    rf: float
    lf: float
    rg: float
    xg: float
    kv: float
    w_base: float
    s_rated: float
    v_base: float
    i_base: float
    vdc_base: float
    tau_dc: float
    vdc_floor: float
    np_par: float
    isc_ref: float
    ki_t: float
    irs: float
    gamma: float
    w_f: float
    kp_gcc: float
    ki_gcc: float
    kp_dc: float
    ki_dc: float
    kp_q: float
    ki_q: float
    kp_pll: float
    ki_pll: float
    m_max: float
    i_max: float
    const_vdc: float

    @property
    def n_states(self) -> int:
        return 6 * self.n_ph + 5


@dataclasses.dataclass(frozen=True)
class Exog:
    """Exogenous inputs, held over one control window (SPEC.md §3)."""

    s_irr: object
    t_cell: object
    v_g: object
    phi_g: object
    dw_g: object
    t_g: object
    v_g2: object
    phi_g2: object
    g_load: object
    b_load: object
    vdc_ref: object
    q_ref: object
    conn: object
    ces: object
    p_ref: object


N_PARAMS = len(dataclasses.fields(DERParams)) - 1     # 29
N_EXOG = len(dataclasses.fields(Exog))                 # 15


def make_params(der: dict) -> DERParams:
    """The DER of a configuration's ``"der"`` block: its rating, voltages,
    string layout and DC capacitance, the PV module, and the circuit and
    controller constants."""
    mod = der["module"]
    n_ph = int(der["n_ph"])
    v_base = math.sqrt(2.0) * der["v_rms"]
    s_base = der["s_rated"] / n_ph
    i_base = 2.0 * s_base / v_base
    beta_mod = Q_E / (K_B * mod["ideality"] * mod["n_cells"])
    return DERParams(
        n_ph=n_ph,
        kv=der["vdc_base"] / (2.0 * v_base),
        w_base=2.0 * math.pi * der["f0"],
        s_rated=der["s_rated"],
        v_base=v_base,
        i_base=i_base,
        vdc_base=der["vdc_base"],
        tau_dc=der["c_dc"] * der["vdc_base"] ** 2 / der["s_rated"],
        np_par=float(der["np_par"]),
        isc_ref=mod["isc"],
        ki_t=mod["ki_t"],
        irs=mod["isc"] / math.expm1(beta_mod * mod["voc"] / T_REF),
        gamma=beta_mod / der["ns"],
        **der["circuit"],
    )
