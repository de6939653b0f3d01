"""The standalone simulation's integrator knob (twin of
tests/test_variants.py:186-206), on the CPU: `DynamicSimulation` with the
trapezoidal rule at n_sub 16 and with RK4 at 72, float64, on a 0.6 pu sag
from 0.3 to 0.6 s; both finite, and their Vdc series within 2e-2 of each
other (the reference's bound).
"""
import numpy as np
import torch

from pvderx_torch.scenario import EventBuilder
from pvderx_torch.sim import DynamicSimulation


def test_torch_dynamic_simulation_integrator_knob():
    """The standalone sim takes the env's integrator knob."""
    ev = EventBuilder()
    ev.add_grid_event(0.3, 0.6)
    ev.add_grid_event(0.6, 1.0)
    sims = {}
    for integ, n_sub in [("trapezoid", 16), ("rk4", 72)]:
        sim = DynamicSimulation("10", events=ev, tStop=1.0, n_sub=n_sub,
                                integrator=integ, dtype=torch.float64,
                                device="cpu")
        series = sim.run_simulation()
        assert np.isfinite(series["vdc"]).all()
        sims[integ] = series
    # both schemes resolve the same physics (trapezoid@16 is 2nd-order)
    assert np.abs(sims["trapezoid"]["vdc"] - sims["rk4"]["vdc"]).max() < 2e-2
