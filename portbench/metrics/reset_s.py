"""Seconds of the cell's reset (the program's batched reset of every env:
draws, event tables, the Newton steady state), host clock, ended by a
device sync."""


def read(run):
    return run.layer.get("reset_s")
