"""The share in % of the traced env steps that the program entered after
the device had finished the step before (`portbench.spans`): near 0 where
the host runs ahead of the device, near 100 where the host sets the
pace. Nothing where the program records no spans."""
from portbench import spans


def read(run):
    return spans.drained_pct(spans.program_records())
