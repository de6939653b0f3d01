"""Standalone dynamic simulation: the reference's validation workflow.

Build events, run `DynamicSimulation` over a horizon, print the state and
plot the collected series (when matplotlib is installed). Run:

    python -m pvderx_torch.examples.standalone_simulation [--preset 50] [--tstop 20]
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="10", choices=["10", "50", "250"])
    ap.add_argument("--tstop", type=float, default=20.0)
    ap.add_argument("--outdir", default=os.path.join(tempfile.gettempdir(),
                                                     "pvderx_torch_demo"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from pvderx_torch.diag import SimulationResults
    from pvderx_torch.scenario import EventBuilder
    from pvderx_torch.sim import DynamicSimulation
    from pvderx_torch.utils import get_logger

    log = get_logger("examples")
    ev = EventBuilder()
    ev.add_solar_event(10.0, 85.0, 300.0)     # insolation collapse at t=10s
    ev.add_solar_event(14.0, 1000.0, 298.15)  # recovery
    ev.add_grid_event(5.0, v=0.6)             # 0.6 pu sag at t=5s
    ev.add_grid_event(5.5, v=1.0)             # clears after 0.5s

    sim = DynamicSimulation(preset=args.preset, events=ev, tStop=args.tstop,
                            device="cpu" if args.cpu else "cuda")
    log.info("running %s steps of %s kW preset...", sim.n_steps, args.preset)
    series = sim.run_simulation()
    sim.show_PV_DER_states()

    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: plots skipped")
        return series
    os.makedirs(args.outdir, exist_ok=True)
    res = SimulationResults(series, title=f"{args.preset} kW PV-DER")
    for pt in ("power", "voltage", "all"):
        path = res.plot_DER_simulation(pt, save_path=os.path.join(
            args.outdir, f"{args.preset}kW_{pt}.png"))
        log.info("wrote %s", path)
    return series


if __name__ == "__main__":
    main()
