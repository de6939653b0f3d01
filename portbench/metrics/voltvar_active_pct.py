"""The share in % of the env steps traced in which Volt-VAR moved the
setpoint (`portbench.spans`): |V_pos| at the window's start outside the
curve's 0.98-1.02 deadband, so q_ref is not 0. The ``count`` and ``total``
of the `env.pre_window` span under each kept ``env.step``, summed. Nothing
where the program records no spans or no such counter."""
from portbench import spans


def read(run):
    records = spans.program_records()
    if not records:
        return None
    ids = {i for i, _ in spans.steps(records)}
    got = [(r["count"], r["total"]) for r in records
           if r["name"] == "env.pre_window" and r["parent"] in ids
           and r.get("count") is not None and r.get("total")]
    total = sum(t for _, t in got)
    return 100.0 * sum(c for c, _ in got) / total if total else None
