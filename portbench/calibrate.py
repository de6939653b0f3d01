#!/usr/bin/env python3
"""Readings of a cell's correctness checks over many seeds in one process:
the program's (the lower readings of each limit) and the control's (the
reference in bfloat16 in the program's place: the upper readings).

    python3 portbench/calibrate.py --workload <cell> --seconds 3 \
        --seeds 11 12 ... --control-seeds 11 12 13

Each seed runs the cell's set-up and a window of ``--seconds`` at the
cell's own sizes, then its checks' readings (no limits applied). One JSON
line per seed and side: {"seed", "side": "program" | "control" | the
fault, "readings"}. With ``--fault NAME`` the program runs with that fault
of `portbench.faults` planted (the upper readings of a training cell's
numbers). Run on the card; the benchmark's own runs never run the
control.
"""
import argparse
import json
import pathlib
import sys
import time

sys.path[0] = str(pathlib.Path(__file__).resolve().parent.parent)

from portbench import harness  # noqa: E402


def readings(cell, control_too: bool, fault: str | None):
    import contextlib
    import importlib

    from portbench.faults import FAULTS

    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}").Driver(cell)
    with FAULTS[fault](cell) if fault else contextlib.nullcontext():
        driver.setup()
        driver.window(cell.seconds, None)
    driver.release()
    out = [(fault or "program", driver.readings(False),
            getattr(driver, "detail", None))]
    if control_too:
        out.append(("control", driver.readings(True), None))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=("unchanged", "half_batch", "altered"),
                    help="read the program with this fault planted "
                         "(portbench.faults) instead")
    args = ap.parse_args()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for seed in args.seeds:
        t = time.perf_counter()
        cell = harness.Cell(bench, args.workload, seed, args.seconds, False)
        for side, r, detail in readings(cell, seed in args.control_seeds,
                                        args.fault):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "readings": r, "detail": detail,
                              "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
