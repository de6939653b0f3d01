"""K1's share of its roofline: the least time of one single-DER window
launch at the cell's envs (`portbench.reference.roofline.window_bound`,
counted on the frozen reference) over K1's mean device time per launch in
the trace, in %. Nothing where the trace shows no K1 launch."""
import re

from portbench.reference.roofline import window_bound

K1 = re.compile(r"(?<![A-Za-z_])window_kernel")


def read(run):
    if run.trace is None:
        return None
    hits = [v for k, v in run.trace["kernels"].items() if K1.search(k)]
    count = sum(n for _, n in hits)
    if not count:
        return None
    ms = 1e3 * sum(s for s, _ in hits) / count
    return 100.0 * window_bound(run.cell.config,
                                run.cell.n_envs)["bound_ms"] / ms
