"""Profiling and timing hooks: the counterpart of `pvderx/diag/profiler.py`.

- `force_sync(tree)`: a host fetch of one scalar summed from every tensor
  leaf; on the card the fetch cannot return before the current stream
  (where the window kernels launch) has run everything it depends on.
  Every timed path of the port syncs this way.
- `trace(logdir)`: a `torch.profiler` capture (CPU, and CUDA when a card is
  present) written as a gzipped Chrome trace,
  ``<logdir>/<host>.<pid>.<ts>.pt.trace.json.gz``, viewable in Perfetto or
  TensorBoard.
- `device_op_summary(logdir)`: device time per kernel name from the newest
  trace under ``logdir`` (host operations on a CPU-only trace).
- `compile_report(fn, *args)`: the cold first call's wall time (on the card
  it includes building or loading the kernel library), then one pass under
  `diag.roofline.OpCounter` for flops and bytes, and the peak device
  memory. The counter sees torch operations only: the work inside a
  kernel's ctypes launch is not in its flops.
- `Stopwatch`: chained-state throughput timing, synced by `force_sync`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import gzip
import json
import os
import tempfile
import time
from collections import Counter

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _leaves(tree):
    """Every tensor of nested dataclasses, dicts, tuples and lists, and the
    parameters and buffers of modules."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def force_sync(tree) -> float:
    """Wait until everything ``tree``'s tensors depend on has run, and
    return the sum of every floating, integer or bool leaf (one host fetch;
    inf or nan where a leaf holds them: still a barrier)."""
    acc = None
    for leaf in _leaves(tree):
        if leaf.is_complex():
            continue
        s = leaf.detach().sum(dtype=torch.float64)
        acc = s if acc is None else acc + s.to(acc.device)
    if acc is None:
        raise ValueError("force_sync: no tensor leaf in the tree")
    return acc.item()


def _sync_devices():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# The profiler drops a device activity whose timestamps fall outside its
# capture window, and on some card hosts the device's timestamps run
# milliseconds behind the window's start: the first kernels of a block
# traced right after the start went missing (a main-path step's K1 among
# them). A traced block therefore starts and ends inside this much idle
# time on the card.
TRACE_GUARD_S = 0.05


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a `torch.profiler` trace of the block into ``logdir``
    (default: ``pvderx_torch-trace`` under the temp directory); yields the
    directory. With a card, the block runs between two idle guards of
    `TRACE_GUARD_S`, the device synced before each."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler)

    logdir = logdir or os.path.join(tempfile.gettempdir(), "pvderx_torch-trace")
    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(
            logdir, use_gzip=True)):
        if cuda:
            _sync_devices()
            time.sleep(TRACE_GUARD_S)
        try:
            yield logdir
        finally:
            _sync_devices()
            if cuda:
                time.sleep(TRACE_GUARD_S)


def trace_events(logdir: str) -> list:
    """The events of the newest trace `trace` wrote under ``logdir``."""
    paths = glob.glob(os.path.join(logdir, "*.pt.trace.json*"))
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir!r}; run trace() first")
    path = max(paths, key=os.path.getmtime)
    with (gzip.open if path.endswith(".gz") else open)(path, "rt") as f:
        return json.load(f)["traceEvents"]


def device_op_summary(logdir: str, top: int = 20) -> list:
    """Total device time per op name in the newest trace under ``logdir``:
    the complete (``ph == "X"``) events of kernels, copies and sets; on a
    trace with none (CPU only), the host's ``cpu_op`` events. Returns
    [(name, total_ms, count)], largest first."""
    events = [e for e in trace_events(logdir)
              if e.get("ph") == "X" and "dur" in e]
    rows = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if not rows:
        rows = [e for e in events if e.get("cat") == "cpu_op"]
    tot, cnt = Counter(), Counter()
    for e in rows:
        tot[e["name"]] += e["dur"]
        cnt[e["name"]] += 1
    return [(name, us / 1e3, cnt[name]) for name, us in tot.most_common(top)]


def compile_report(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` cold, then once under the op counter.

    Keys as the reference's: ``compile_s`` (the first call, synced),
    ``trace_s`` (the counted call), ``flops`` and ``bytes_accessed`` (the
    counter's: an elementwise op counts its output elements, a reduction
    its input elements less its outputs; transcendentals apart, under
    ``transcendentals``), and on the card ``peak_bytes``
    (`torch.cuda.max_memory_allocated` over both calls)."""
    from pvderx_torch.diag.roofline import OpCounter

    dev = next((a.device for a in _leaves((args, kwargs))), None)
    cuda = dev is not None and dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    force_sync(fn(*args, **kwargs))
    t1 = time.perf_counter()
    with OpCounter() as count:
        out = fn(*args, **kwargs)
    force_sync(out)
    t2 = time.perf_counter()
    rep = {"compile_s": t1 - t0, "trace_s": t2 - t1, "flops": count.flops,
           "transcendentals": count.transcendentals,
           "bytes_accessed": count.bytes}
    if cuda:
        rep["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return rep


class Stopwatch:
    """Throughput timer for step-like functions ``(state, ...) -> (state,
    ...)``: chains the state through the reps, so no call's work can be
    skipped, and syncs by `force_sync` at both ends of the timed region.

    >>> sw = Stopwatch(step_fn, state0, n_warmup=2)
    >>> rate = sw.rate(reps=20, items_per_call=n_envs)
    """

    def __init__(self, fn, state0, n_warmup: int = 2, extra_args=()):
        self.fn = fn
        self.extra = tuple(extra_args)
        s = state0
        for _ in range(n_warmup):
            s = self._once(s)
        force_sync(s)
        self.state = s

    def _once(self, s):
        out = self.fn(s, *self.extra)
        return out[0] if isinstance(out, tuple) else out

    def elapsed(self, reps: int = 10) -> float:
        """Seconds per call over ``reps`` chained calls."""
        s = self.state
        force_sync(s)
        t0 = time.perf_counter()
        for _ in range(reps):
            s = self._once(s)
        force_sync(s)
        el = time.perf_counter() - t0
        self.state = s
        return el / reps

    def rate(self, reps: int = 10, items_per_call: int = 1) -> float:
        return items_per_call / self.elapsed(reps)


__all__ = ["force_sync", "trace", "trace_events", "device_op_summary",
           "compile_report", "Stopwatch"]
