"""The program's own spans of the env step, as the per-layer readers of
`portbench/metrics/` read them.

`pvderx_torch.diag.profiler.records()` returns the spans the program
entered while a profiler recorded: the traced run's first unit of work
(one `rollout` call, during which the profiler comes up, and which the
trace's readings leave out too) and the traced units after it. The
readers drop the first `rollout` span and every span under it, and read
the ``env.step`` spans left and their children. A program without the
recorder, or a run with no ``env.step`` span left, reads nothing.
"""
from __future__ import annotations

import statistics


def program_records():
    """The program's recorded spans, or None where it has no recorder."""
    from pvderx_torch.diag import profiler

    read = getattr(profiler, "records", None)
    return None if read is None else read()


def kept(records) -> list:
    """(index, record) of every record but the first ``rollout`` span and
    those under it."""
    first = next((i for i, r in enumerate(records)
                  if r["name"] == "rollout"), None)
    dropped = set() if first is None else {first}
    out = []
    for i, r in enumerate(records):
        if i in dropped or r["parent"] in dropped:
            dropped.add(i)
        else:
            out.append((i, r))
    return out


def steps(records) -> list:
    """(index, record) of the kept ``env.step`` spans."""
    return [(i, r) for i, r in kept(records) if r["name"] == "env.step"]


def phase_ms(records, child: str):
    """The median over the kept ``env.step`` spans of the device ms of
    their ``child`` span; None where there is none."""
    if not records:
        return None
    ids = {i for i, _ in steps(records)}
    ms = [r["device_ms"] for r in records
          if r["name"] == child and r["parent"] in ids
          and r["device_ms"] is not None]
    return statistics.median(ms) if ms else None


def drained_pct(records):
    """The share in % of the kept ``env.step`` spans entered after the
    device had finished the previous one; None where there is none."""
    if not records:
        return None
    st = steps(records)
    if not st:
        return None
    return 100.0 * sum(r["drained"] is True for _, r in st) / len(st)
