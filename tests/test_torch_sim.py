"""The port's standalone simulation (pvderx_torch/sim/dynamic.py), plots and
metrics, on the CPU (twins of tests/test_sim_diag.py:25-78 and :104-114).

- `DynamicSimulation("10")` in float64 (default n_sub 120) on a cloud step
  and a 0.7 pu sag: the collected series and the reference-style accessors;
  its states against the port's float64 LSODA trajectory on the same exogs
  (`pvderx_torch.oracle.run_trajectory`): < 1e-6.
- `show_PV_DER_states` and every plot type of `SimulationResults`.
- `MetricsLogger` writes JSONL records of numbers and tensors.

The integrator knob's twin is tests/test_torch_sim_integrators.py.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pvderx_torch import oracle
from pvderx_torch.diag import MetricsLogger, SimulationResults
from pvderx_torch.params import make_params, nominal_exog
from pvderx_torch.scenario import EventBuilder
from pvderx_torch.sim import DynamicSimulation


@pytest.fixture(scope="module")
def sim_series():
    ev = EventBuilder()
    ev.add_solar_event(1.0, 500.0)
    ev.add_grid_event(2.0, v=0.7)
    ev.add_grid_event(2.4)
    sim = DynamicSimulation("10", events=ev, tStop=3.0, dtype=torch.float64,
                            device="cpu")
    series = sim.run_simulation()
    return sim, series


def test_torch_dynamic_simulation_series(sim_series):
    sim, series = sim_series
    assert series["t"].shape == (180,) and series["y"].shape == (180, 11)
    assert all(v.shape[0] == 180 for v in series.values())
    # cloud event halves insolation -> P roughly halves
    assert series["p_pcc"][170] < 0.7 * series["p_pcc"][50]
    # sag visible in |V|
    i_sag = np.searchsorted(series["t"], 2.2)
    assert series["v_mag"][i_sag] < 0.8
    assert series["tripped"][-1] == 0.0
    # reference-style accessors
    assert np.array_equal(sim.Vdc_t, series["vdc"])
    assert np.array_equal(sim.t_t, series["t"])
    with pytest.raises(AttributeError):
        sim.nope_t


def test_torch_sim_matches_oracle(sim_series):
    """The standalone sim equals the LSODA trajectory on the same schedule
    (ride-through enabled but not triggered)."""
    _, series = sim_series
    u = nominal_exog()
    exogs = []
    for k in range(180):
        t = k / 60.0
        uu = u
        if t >= 1.0:
            uu = dataclasses.replace(uu, s_irr=500.0)
        if 2.0 <= t < 2.4:
            uu = dataclasses.replace(uu, v_g=0.7)
        exogs.append(uu)
    traj = oracle.run_trajectory(make_params("10"), exogs)
    err = np.max(np.abs(series["y"] - traj[1:]))
    assert err < 1e-6, f"sim vs oracle max-abs-err {err:.3e}"


def test_torch_show_states_and_plots(sim_series, tmp_path, capsys):
    sim, series = sim_series
    sim.show_PV_DER_states()
    out = capsys.readouterr().out
    assert "t=3.0000s" in out and "Vdc" in out and "tripped=False" in out
    res = SimulationResults(series)
    for pt in ("power", "voltage", "current", "duty_cycle", "frequency", "dc",
               "all"):
        path = res.plot_DER_simulation(pt, save_path=str(tmp_path / f"{pt}.png"))
        assert os.path.getsize(path) > 1000
    with pytest.raises(ValueError):
        res.plot_DER_simulation("nope")
    # tensors are taken as they come
    SimulationResults({k: torch.as_tensor(v) for k, v in series.items()})


def test_torch_metrics_logger(tmp_path):
    path = str(tmp_path / "m.jsonl")
    ml = MetricsLogger(path)
    ml.write(0, {"loss": torch.tensor(1.5), "reward": 0.25})
    ml.write(1, {"loss": torch.tensor([1.2]), "reward": 0.5})
    ml.close()
    recs = [json.loads(line) for line in open(path)]
    assert recs[1]["loss"] == pytest.approx(1.2)
    assert recs[0]["step"] == 0 and recs[0]["reward"] == 0.25
