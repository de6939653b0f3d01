"""K1's share of its roofline at three phases: the least time of one
window launch at the cell's envs (`portbench.reference.roofline.window_bound`,
counted on the frozen reference, over the configuration with its
supervisory flags cleared: they never enter the window) over the mean
device time per launch of the three-phase K1 in the trace, in %. Nothing
where the trace shows no such launch."""
import re

from portbench.reference.roofline import window_bound

K1_3PH = re.compile(r"(?<![A-Za-z_])window_kernel<3>")
SUPERVISORY = ("mppt_enable", "voltvar_enable", "anomaly_detect")


def read(run):
    if run.trace is None:
        return None
    hits = [v for k, v in run.trace["kernels"].items() if K1_3PH.search(k)]
    count = sum(n for _, n in hits)
    if not count:
        return None
    ms = 1e3 * sum(s for s, _ in hits) / count
    config = dict(run.cell.config, env=dict(
        run.cell.config["env"], **{k: False for k in SUPERVISORY}))
    return 100.0 * window_bound(config, run.cell.n_envs)["bound_ms"] / ms
