"""Run one cell of the benchmark and print its result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness finds everything else by those names, so a cell, a configuration
or a metric is added by adding files and entries:

- ``portbench/configs/<config>.json``: the deployment as it is run (the
  ``file`` of its ``configs`` entry);
- ``portbench/traffic/<traffic>.json``: the traffic mix; its ``driver``
  names the module ``portbench/drivers/<driver>.py`` that drives it;
- ``portbench/limits/<cell>.json``: the limits of the cell's correctness
  checks, with the readings they were set from;
- ``portbench/metrics/<metric>.py``: the reader of one per-layer metric,
  ``read(run) -> float | None``; a metric split by the end-to-end metric
  it moves (``device_idle_pct.rollout``, and a later ``.train``) may
  share one reader, named by the part before the first dot.

A run: set-up (imports, the kernel library's build or load, the reset, a
warm-up of every shape the window uses), ended by a device sync, is
``setup_s``, from the first line of ``run.py``; then the window of
``--seconds``; with ``--trace 1`` the driver's first units of work in it
run under the profiler. Once the window has closed: the peak device
memory, the program's state freed, the trace read, the correctness
checks. The last line of standard output is the result (`run_cell`); the
checks, each beside its limit, are also the last lines of standard error.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "pvderx")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One cell's entries and files, the run's arguments, and its seeds."""

    def __init__(self, bench: dict, name: str, seed: int, seconds: float,
                 trace: bool, device: str = "cuda", root=ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.bench, self.name, self.workload = bench, name, cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.root = pathlib.Path(root)
        here = self.root / "portbench"
        self.config = load_json(self.root / conf["file"])
        self.traffic = load_json(here / "traffic" /
                                 f"{self.workload['traffic']}.json")
        limits = here / "limits" / f"{name}.json"
        self.limits = load_json(limits)["limits"] if limits.exists() else {}
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = device
        self.chips = int(self.workload["chips"])

    def seed_for(self, stream: int) -> int:
        """The seed of one random stream of the run (0, 1, ...): the same
        ``--seed`` gives the same streams."""
        return (self.seed * 1_000_003 + 7919 * (stream + 1)) % (2 ** 62)

    @property
    def n_envs(self) -> int:
        return int(self.traffic.get("n_envs", self.config["n_envs"]))


def nvidia_smi() -> dict:
    """The card's name, clocks, power and temperature, or {} where
    nvidia-smi does not answer."""
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    rows = [r.split(", ") for r in out.stdout.strip().splitlines()]
    if out.returncode != 0 or not rows or len(rows[0]) != 6:
        return {}
    keys = ("name", "power_limit_w", "power_draw_w", "sm_clock_mhz",
            "max_sm_clock_mhz", "temperature_c")
    return {k: (v if k == "name" else _num(v)) for k, v in zip(keys, rows[0])}


def cpu_mhz():
    """The host's mean CPU clock in MHz as /proc/cpuinfo gives it, or None."""
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(r.split(":")[1]) for r in f if r.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        return None
    return sum(mhz) / len(mhz) if mhz else None


def host_window(mhz: list, marks: list) -> dict:
    """What the host did over the window: its CPU clock before and after,
    the CPUs the process may run on, and the host-clock seconds of the
    window's units of work (their quartiles, and the second half's mean
    over the first half's: a host that changes speed during the window
    moves it off 1)."""
    out = {"cpu_mhz": mhz, "cpus_allowed": len(os.sched_getaffinity(0))}
    units = [b - a for a, b in zip(marks, marks[1:])]
    if len(units) >= 4:
        half = len(units) // 2
        out["unit_s_quartiles"] = statistics.quantiles(units, n=4)
        out["second_over_first"] = (sum(units[half:]) / (len(units) - half)
                                    / (sum(units[:half]) / half))
    return out


def _num(s: str):
    try:
        return float(s)
    except ValueError:
        return s


def load_reader(name: str, root=ROOT):
    """The ``read`` function of ``portbench/metrics/<name>.py``, or where
    there is none, of the reader named by the part of ``name`` before its
    first dot."""
    here = pathlib.Path(root) / "portbench" / "metrics"
    path = here / f"{name}.py"
    if not path.exists():
        path = here / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The entries of the metrics this cell reports: its end-to-end metrics
    (those that list it, or list no cells), or with ``trace`` its per-layer
    ones (those that list it, or list no cells and move one of its
    end-to-end metrics)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if cell in m["workloads"]
            or ("workloads" not in m and m["moves"] in names)]


def banned_modules() -> list:
    """The top-level names of `BANNED` that ``sys.modules`` holds, each
    module name compared by its part before the first dot."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(BANNED))


class Run:
    """What a per-layer reader sees: the cell, the trace's summary (or
    None), the driver's per-layer values, and the env steps traced."""

    def __init__(self, cell, trace, layer, traced_steps):
        self.cell, self.trace = cell, trace
        self.layer, self.traced_steps = layer, traced_steps


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run_cell(cell: Cell, t_start: float, require_device: bool = True):
    """Set-up, window, checks of one cell. Returns (result, checks, card),
    or raises `SystemExit` where the run cannot give a result."""
    import torch

    if require_device and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < cell.chips):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell.chips} CUDA device(s), "
              f"{have} available", file=sys.stderr)
        raise SystemExit(2)
    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}").Driver(cell)
    driver.setup()
    cuda = cell.device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    card = nvidia_smi() if cuda else {}
    capture = None
    if cell.trace:
        from portbench.trace import Capture
        capture = Capture(driver.trace_units)
    mhz = cpu_mhz()
    e2e = driver.window(cell.seconds, capture)
    host = host_window([mhz, cpu_mhz()], driver.marks)
    card_after = nvidia_smi() if cuda else {}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    driver.release()
    summary = None
    if capture is not None and capture.prof is not None:
        from portbench.trace import summarize
        summary = summarize(capture.events())
    checks = driver.check()
    found = banned_modules()
    if found:
        print(f"portbench: modules loaded that the port must not load: "
              f"{found}", file=sys.stderr)
        raise SystemExit(3)

    metrics = {}
    run = Run(cell, summary, driver.layer, driver.traced_steps)
    for m in cell_metrics(cell.bench, cell.name, cell.trace):
        if cell.trace:
            value = load_reader(m["name"], cell.root)(run)
        else:
            value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    for key in ("power_limit_w", "sm_clock_mhz"):
        if key in card:
            device[key] = card[key]
    result = {"correct": all(finite(v) and v <= lim for _, v, lim in checks),
              "attempted": int(driver.attempted), "failed": int(driver.failed),
              "metrics": metrics, "device": device}
    if summary is not None:
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {name: {"value": v if finite(v) else str(v),
                               "limit": lim} for name, v, lim in checks}
    return result, checks, {"before": card, "after": card_after,
                            "host": host}


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = Cell(bench, args.workload, args.seed, args.seconds,
                bool(args.trace))
    result, checks, card = run_cell(cell, t_start)
    print("# card " + json.dumps(card), flush=True)
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
