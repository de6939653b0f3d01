"""Device-trace capture and its arithmetic: busy time, idle share, launches,
kernel and copy times, and the idle gaps named by what the host was doing.

The sums are those of the repository's `profile_torch_step.py` (busy time as
the device activity of the one stream, launches as the kernel-launch
runtime calls), the capture's idle guards those of
`pvderx_torch/diag/profiler.py`'s `trace` (copied here, not imported): the
profiler drops device activity stamped outside its capture window, and on
some card hosts the device's clock runs milliseconds behind, so a traced
block starts and ends inside `GUARD_S` of idle time. The traced block is
one `record_function` span, `WINDOW_SPAN`, ended by a device sync; every
reading is clipped to it.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import shutil
import tempfile
import time

GUARD_S = 0.05
WINDOW_SPAN = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_RE = re.compile(r"^(cuda|cu)LaunchKernel")
TOP = 10


class Capture:
    """``torch.profiler`` over a run's first units of work (chunks, train
    steps, adapter steps). The profiler starts before the first unit, which
    it does not count: the profiler comes up during it (a second or more on
    some hosts, during which its clock does not follow the host's). The
    next ``units`` units run inside the `WINDOW_SPAN` span, between idle
    guards. The driver calls `unit` after each unit and `stop` if its
    window ends first; `events` reads the chrome trace once the window has
    closed, from a directory under the temporary directory that it
    deletes."""

    def __init__(self, units: int):
        self.units, self.done = int(units), 0
        self.prof = self.span = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if torch.cuda.is_available() else []))
        self.prof.__enter__()

    def unit(self) -> bool:
        """Count one unit done; True once the traced units are done and the
        profiler has stopped."""
        from torch.profiler import record_function

        self.done += 1
        if self.done == 1:
            _sync()
            time.sleep(GUARD_S)
            self.span = record_function(WINDOW_SPAN)
            self.span.__enter__()
        elif self.done == 1 + self.units:
            self.stop()
            return True
        return False

    def stop(self) -> int:
        """Close the span and the profiler; the units traced."""
        _sync()
        if self.span is not None:
            self.span.__exit__(None, None, None)
            time.sleep(GUARD_S)
        self.prof.__exit__(None, None, None)
        return max(0, self.done - 1)

    def events(self) -> list:
        d = tempfile.mkdtemp(prefix="portbench-trace-")
        try:
            path = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(d, ignore_errors=True)
            self.prof = None


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, namespace and argument
    list, at most ``width`` long."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    name = name[5:] if name.startswith("void ") else name
    name = name.strip()
    return name if len(name) <= width else name[:width - 3] + "..."


def summarize(events: list) -> dict:
    """Readings of the `WINDOW_SPAN` of a chrome trace (times in seconds):
    ``window_s``, ``busy_s`` (the union of device activity), ``launches``,
    ``kernels`` {name: [seconds, count]}, ``d2h_s``, ``device_ops`` and
    ``idle_gaps`` (each the `TOP` largest [name, seconds])."""
    spans = [e for e in events if e.get("name") == WINDOW_SPAN
             and e.get("ph") == "X" and "gpu" not in e.get("cat", "")]
    if not spans:
        raise ValueError(f"no {WINDOW_SPAN!r} span in the trace")
    w0 = spans[0]["ts"]
    w1 = w0 + spans[0]["dur"]
    dev, kernels, d2h, launches = [], {}, 0.0, 0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        a, b = e["ts"], e["ts"] + e["dur"]
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            rec = kernels.setdefault(e["name"], [0.0, 0])
            rec[0] += (b - a) / 1e6
            rec[1] += 1
            if cat == "gpu_memcpy" and "DtoH" in e["name"]:
                d2h += (b - a) / 1e6
        elif cat == "cuda_runtime" and LAUNCH_RE.match(e.get("name", "")) \
                and w0 <= a <= w1:
            launches += 1
    busy = _union(dev) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy,
            "launches": launches, "kernels": kernels, "d2h_s": d2h,
            "device_ops": _top_ops(kernels),
            "idle_gaps": _idle_gaps(events, dev, w0, w1)}


def _top_ops(kernels: dict) -> list:
    by_name = {}
    for name, (sec, _) in kernels.items():
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + sec
    return sorted(([k, v] for k, v in by_name.items()),
                  key=lambda kv: -kv[1])[:TOP]


def _idle_gaps(events, dev, w0, w1) -> list:
    """Idle device time between activities inside the window, summed by the
    innermost host operation running at each gap's midpoint ("host: no
    operation" where none was)."""
    ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") == "cpu_op" and e.get("ph") == "X"
                 and "dur" in e)
    starts = [o[0] for o in ops]
    gaps, end = [], w0
    for a, b in sorted(dev) + [(w1, w1)]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    by_host = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "host: no operation"
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(i - 64, -1), -1):
            if ops[j][1] >= mid:
                name = ops[j][2]
                break
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6
    return sorted(([k, v] for k, v in by_host.items()),
                  key=lambda kv: -kv[1])[:TOP]
