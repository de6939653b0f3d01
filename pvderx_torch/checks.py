"""Parameter and scenario validation (the port's own copy).

Every `DERParams` / `ScenarioConfig` is built from concrete Python floats on
the host, so range and consistency checks run eagerly in `make_params` /
`make_env_config` and raise `ValueError` with the full list of violations.
A batched (per-env tensor) leaf is skipped field by field; the Newton
residual carried in `EnvState.init_res` covers those at reset time.
"""
from __future__ import annotations

import math

from pvderx_torch.params import DERParams, T_REF


def _concrete(v) -> float | None:
    """Conversion of a leaf to a Python float; None if it is a batch."""
    try:
        return float(v)
    except (TypeError, ValueError, RuntimeError):
        return None


# (field, low, high, low_inclusive) — bounds on DERParams leaves. The bands
# are deliberately generous: they catch sign errors, zeros that divide, and
# unit mistakes (e.g. ohms where per-unit was expected), not tuning choices.
_PARAM_BANDS = [
    ("rf", 0.0, 1.0, False),        # filter resistance [pu]
    ("lf", 0.0, 2.0, False),        # filter inductance [pu] (divides the RHS)
    ("rg", 0.0, 1.0, True),         # grid resistance [pu]
    ("xg", 0.0, 2.0, False),        # grid reactance [pu] (Thevenin source)
    ("kv", 0.0, 20.0, False),       # Vdc_base / (2 V_base)
    ("w_base", 0.0, 1e4, False),    # [rad/s]
    ("s_rated", 0.0, 1e9, False),   # [VA]
    ("v_base", 0.0, 1e6, False),    # [V peak]
    ("i_base", 0.0, 1e6, False),    # [A peak]
    ("vdc_base", 0.0, 1e6, False),  # [V]
    ("tau_dc", 0.0, 10.0, False),   # DC-link time constant [s]
    ("vdc_floor", 0.0, 1.0, False),
    ("np_par", 1.0, 1e4, True),     # parallel strings
    ("isc_ref", 0.0, 1e3, False),   # [A]
    ("ki_t", 0.0, 1.0, True),       # [A/K]
    ("irs", 0.0, 1.0, False),       # diode saturation current [A]
    ("gamma", 0.0, 10.0, False),    # [K/V] (array-level diode exponent slope)
    ("w_f", 0.0, 1e6, False),       # measurement filter corner [rad/s]
    ("kp_gcc", 0.0, 100.0, True),
    ("ki_gcc", 0.0, 1e5, True),
    ("kp_dc", 0.0, 100.0, True),
    ("ki_dc", 0.0, 1e5, True),
    ("kp_q", 0.0, 100.0, True),
    ("ki_q", 0.0, 1e5, True),
    ("kp_pll", 0.0, 100.0, True),
    ("ki_pll", 0.0, 1e5, True),
    ("m_max", 0.0, 2.0, False),     # modulation-index ceiling
    ("i_max", 0.0, 5.0, False),     # current limit [pu]
]


def check_parameters(der: DERParams, raise_on_error: bool = True) -> list[str]:
    """Validate a `DERParams` instance; returns the list of violations."""
    errs: list[str] = []
    if der.n_ph not in (1, 3):
        errs.append(f"n_ph must be 1 or 3, got {der.n_ph}")
    vals = {}
    for name, lo, hi, lo_inc in _PARAM_BANDS:
        v = _concrete(getattr(der, name))
        if v is None:
            continue  # batched — the reset residual covers it
        vals[name] = v
        if not math.isfinite(v):
            errs.append(f"{name}={v} is not finite")
        elif (v < lo) or (v == lo and not lo_inc) or (v > hi):
            lb = "[" if lo_inc else "("
            errs.append(f"{name}={v:g} outside {lb}{lo:g}, {hi:g}]")

    cv = _concrete(der.const_vdc)
    if cv is not None and cv not in (0.0, 1.0):
        errs.append(f"const_vdc must be 0.0 or 1.0, got {cv}")

    # consistency checks (only when every involved leaf is concrete)
    if all(k in vals for k in ("gamma", "vdc_base")):
        # diode exponent at nominal DC voltage and STC temperature: a sane
        # single-diode array lands in the tens; far outside means a unit error
        # in gamma/Ns folding (exp overflow or a dead diode term).
        expo = vals["gamma"] * vals["vdc_base"] / T_REF
        if not 2.0 < expo < 200.0:
            errs.append(
                f"diode exponent gamma*vdc_base/T_ref = {expo:.1f} outside "
                "(2, 200) — gamma/Ns/vdc_base are inconsistent")
    if all(k in vals for k in ("i_max",)) and vals["i_max"] < 1.0:
        errs.append(
            f"i_max={vals['i_max']:g} < 1.0 pu — the current limiter would "
            "clip rated output")
    if all(k in vals for k in ("m_max", "kv")):
        # at rated operation v_t ≈ 1 pu ⇒ m ≈ 1/(kv·vdc) ⇒ need m_max·kv ≳ 1
        if vals["m_max"] * vals["kv"] < 0.8:
            errs.append(
                f"m_max*kv = {vals['m_max'] * vals['kv']:.2f} < 0.8 — the "
                "inverter cannot synthesize rated AC voltage from vdc_base")
    if all(k in vals for k in ("s_rated", "v_base", "i_base")) and der.n_ph in (1, 3):
        s_imp = der.n_ph * vals["v_base"] * vals["i_base"] / 2.0
        if abs(s_imp - vals["s_rated"]) > 1e-6 * vals["s_rated"]:
            errs.append(
                f"rating inconsistency: n_ph*v_base*i_base/2 = {s_imp:g} VA "
                f"!= s_rated = {vals['s_rated']:g} VA")

    if errs and raise_on_error:
        raise ValueError(
            "invalid DERParams (%d problem%s):\n  - %s"
            % (len(errs), "s" if len(errs) != 1 else "", "\n  - ".join(errs)))
    return errs


def check_scenario(scen, raise_on_error: bool = True) -> list[str]:
    """Validate a `ScenarioConfig` (episode-randomization ranges)."""
    errs: list[str] = []
    g = lambda n: _concrete(getattr(scen, n))
    for lo_n, hi_n in [("s0_lo", "s0_hi"), ("tc_lo", "tc_hi"),
                       ("sag_depth_lo", "sag_depth_hi"),
                       ("sag_t_lo", "sag_t_hi"), ("sag_dur_lo", "sag_dur_hi"),
                       ("cloud_frac_lo", "cloud_frac_hi")]:
        lo, hi = g(lo_n), g(hi_n)
        if lo is not None and hi is not None and lo > hi:
            errs.append(f"{lo_n}={lo:g} > {hi_n}={hi:g}")
    for pn in ("p_sag", "p_freq", "p_unb", "p_cloud", "p_load"):
        p = g(pn)
        if p is not None and not 0.0 <= p <= 1.0:
            errs.append(f"{pn}={p:g} outside [0, 1]")
    ps, pf = g("p_sag"), g("p_freq")
    if ps is not None and pf is not None and ps + pf > 1.0:
        errs.append(f"p_sag + p_freq = {ps + pf:g} > 1 (mutually exclusive "
                    "events share one draw)")
    s0 = g("s0_lo")
    if s0 is not None and s0 <= 0.0:
        errs.append(f"s0_lo={s0:g} must be > 0 (dark-start has no steady state)")
    zj = g("zg_jitter")
    if zj is not None and not 0.0 <= zj < 1.0:
        errs.append(f"zg_jitter={zj:g} outside [0, 1) (1 would allow rg/xg=0)")
    fj = g("fleet_s_jitter")
    if fj is not None and not 0.0 <= fj < 1.0:
        errs.append(f"fleet_s_jitter={fj:g} outside [0, 1)")
    if errs and raise_on_error:
        raise ValueError(
            "invalid ScenarioConfig (%d problem%s):\n  - %s"
            % (len(errs), "s" if len(errs) != 1 else "", "\n  - ".join(errs)))
    return errs


__all__ = ["check_parameters", "check_scenario"]
