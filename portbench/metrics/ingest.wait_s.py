"""Mean ``ingest`` wall per family, from the batch command's records:
how long the batch loop waits for the prefetched parse (host clock)."""


def read(run):
    walls = [f["record"].get("timings_s", {}).get("ingest")
             for f in run.families()]
    walls = [w for w in walls if w is not None]
    return sum(walls) / len(walls) if walls else None
