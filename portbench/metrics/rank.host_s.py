"""Mean host seconds of ``compute_ranking`` per call, from the harness's
wrapper around it (traced runs only)."""


def read(run):
    spans = run.spans.get("rank", [])
    return sum(s["host_s"] for s in spans) / len(spans) if spans else None
