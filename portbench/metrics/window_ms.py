"""Device ms of the program's `env.window` span per env step: the median
over the traced steps (`portbench.spans`; CUDA events on the stream the
step runs on). Nothing where the program records no spans."""
from portbench import spans


def read(run):
    return spans.phase_ms(spans.program_records(), "env.window")
