"""The share in % of the envs that the program's autoreset restarted over
the traced env steps (`portbench.spans`): the ``count`` and ``total`` of
the `env.autoreset` span under each kept ``env.step``, summed. Nothing
where the program records no spans or no such counter."""
from portbench import spans


def read(run):
    records = spans.program_records()
    if not records:
        return None
    ids = {i for i, _ in spans.steps(records)}
    got = [(r["count"], r["total"]) for r in records
           if r["name"] == "env.autoreset" and r["parent"] in ids
           and r.get("count") is not None and r.get("total")]
    total = sum(t for _, t in got)
    return 100.0 * sum(c for c, _ in got) / total if total else None
