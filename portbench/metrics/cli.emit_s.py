"""Mean ``emit`` wall per family (formatting and writing its ranking),
from the batch command's own per-family records (host clock)."""


def read(run):
    walls = [f["record"].get("timings_s", {}).get("emit")
             for f in run.families()]
    walls = [w for w in walls if w is not None]
    return sum(walls) / len(walls) if walls else None
