"""Kernel-launch runtime calls in the traced window per env step (one
batched step of every env), the benchmark's own policy draw (one launch a
step) and its per-chunk gathers of the sampled rows included."""


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    return run.trace["launches"] / run.traced_steps
