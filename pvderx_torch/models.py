"""DER model selection by type string (the counterpart of
`pvderx/models.py:15-39`).

There is one shared equation core (`pvderx_torch/physics/rhs_core.py`); a
"model" is a `DERParams` configuration: phase count and rating come from the
preset, the constant-Vdc variant is the branchless ``const_vdc`` mask (so
fleets mixing variants still batch into one kernel launch).
"""
from __future__ import annotations

from pvderx_torch.params import DERParams, make_params

# type string -> (default preset, parameter overrides)
DER_MODEL_TYPES = {
    "SolarPVDERSinglePhase": ("10", {}),
    "SolarPVDERThreePhase": ("50", {}),
    "SolarPVDERThreePhaseBalanced": ("50", {}),
    "SolarPVDERThreePhaseConstantVdc": ("50", {"const_vdc": 1.0}),
}


def make_der(der_type: str, preset: str | None = None,
             **overrides) -> DERParams:
    """Build a `DERParams` from a model-type string (+ optional rating
    preset).

    >>> make_der("SolarPVDERThreePhaseConstantVdc", preset="250").const_vdc
    1.0
    """
    try:
        default_preset, type_over = DER_MODEL_TYPES[der_type]
    except KeyError:
        raise KeyError(
            f"unknown DER model type {der_type!r}; "
            f"known: {sorted(DER_MODEL_TYPES)}") from None
    kw = dict(type_over)
    kw.update(overrides)
    return make_params(preset or default_preset, **kw)


__all__ = ["DER_MODEL_TYPES", "make_der"]
