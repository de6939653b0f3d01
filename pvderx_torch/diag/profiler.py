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
- `span(name)`: a named region of the env step, recorded only while a
  profiler records (`torch.profiler`, `trace`): a ``user_annotation`` in
  the chrome trace, and a record of its host and device time that
  `records()` returns. With no profiler recording it does nothing.
- `Stopwatch`: chained-state throughput timing, synced by `force_sync` at
  its start and by a device sync at its end.
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
import torch.autograd.profiler as _autograd_profiler

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


# The spans recorded while a profiler records, oldest first, each a list
# [name, parent, host start ns, host end ns, start event, end event,
# drained]; at most MAX_RECORDS, those beyond counted in `_dropped`.
MAX_RECORDS = 131072
_NULL_SPAN = contextlib.nullcontext()
_records: list = []
_open: list = []        # the index of each span entered and not yet left
_last_exit: dict = {}   # name -> the end event of its latest span
_dropped = 0


class _Span:
    """A span while a profiler records: `torch.profiler.record_function`,
    and a record of the span's host clock and, where CUDA is initialized,
    two timing events on the current stream."""

    __slots__ = ("name", "rf", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _dropped
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.rec = None
        if len(_records) >= MAX_RECORDS:
            _dropped += 1
            _open.append(None)
            return self
        start = drained = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            prev = _last_exit.get(self.name)
            drained = None if prev is None else prev.query()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        self.rec = [self.name, _open[-1] if _open else None,
                    time.perf_counter_ns(), None, start, None, drained]
        _open.append(len(_records))
        _records.append(self.rec)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            if rec[4] is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                rec[5] = _last_exit[self.name] = end
            rec[3] = time.perf_counter_ns()
        if _open:
            _open.pop()
        return self.rf.__exit__(*exc)


def span(name: str):
    """A context manager naming a region of the program. While a profiler
    records, the region is a ``user_annotation`` of the chrome trace and a
    record of `records()`; otherwise it is one shared null context that
    records, launches and syncs nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL_SPAN
    return _Span(name)


def records() -> list:
    """The recorded spans, oldest first, as dicts: ``name``; ``parent``,
    the index of the enclosing recorded span (None at the top);
    ``host_ms``; ``device_ms``, the current CUDA stream's time from the
    span's entry to its exit (the host time where CUDA was not
    initialized); ``drained``, whether the device had finished the
    previous span of the same name when this one was entered (None on the
    host, or for a name's first span). One device sync resolves the
    events; a span not yet left reads None times."""
    if any(r[5] is not None for r in _records):
        torch.cuda.synchronize()
    out = []
    for name, parent, h0, h1, e0, e1, drained in _records:
        host_ms = None if h1 is None else (h1 - h0) / 1e6
        device_ms = host_ms if e0 is None else (
            None if e1 is None else e0.elapsed_time(e1))
        out.append({"name": name, "parent": parent, "host_ms": host_ms,
                    "device_ms": device_ms, "drained": drained})
    return out


def dropped() -> int:
    """Spans not recorded since the last `clear`: those past MAX_RECORDS."""
    return _dropped


def clear():
    """Forget every recorded span; call it between spans."""
    global _dropped
    _records.clear()
    _open.clear()
    _last_exit.clear()
    _dropped = 0


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
    skipped. The timed region starts after a `force_sync` and ends with a
    device sync where the state is on a card (`force_sync` on the host),
    so it reads no leaf of the state on the card.

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
        self.cuda = any(leaf.is_cuda for leaf in _leaves(s))

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
        if self.cuda:
            torch.cuda.synchronize()
        else:
            force_sync(s)
        el = time.perf_counter() - t0
        self.state = s
        return el / reps

    def rate(self, reps: int = 10, items_per_call: int = 1) -> float:
        return items_per_call / self.elapsed(reps)


__all__ = ["force_sync", "trace", "span", "records", "dropped", "clear",
           "trace_events", "device_op_summary", "compile_report", "Stopwatch"]
