#!/usr/bin/env python3
"""Stress the port's pod harness on the CPU.

Runs the children of ``tests/test_torch_pod.py``'s two CPU pod tests
(the collectives and the storage-sharded solve, in turn) through
``parallel.podspawn.spawn_pod`` many times, several pods at once, and
counts the pods in which a child failed. Each child prints a marker when
its body has run, so a failure can be placed before or after the body
(at interpreter exit).

    python scripts/torch_pod_stress.py [--runs 600] [--parallel 8]
        [--repo PATH]

``--repo`` takes the harness, the package and the test bodies from
another checkout (a parent commit unpacked with ``git archive``, say), so
two commits can be stressed side by side. Prints each failure as it
happens, the counts every 50 runs, and a final JSON line.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import json
import os
import sys
import tempfile

MARK = "POD-STRESS-BODY-DONE"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=600)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path[:0] = [repo, os.path.join(repo, "tests")]
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import test_torch_pod as pod
    from gaussdca_tpu_torch.parallel.podspawn import spawn_pod

    end = f"\nprint({MARK!r}, flush=True)\n"
    bodies = {"collectives": pod._COLLECTIVES_CHILD + end,
              "solve": pod._SOLVE_CHILD + end}
    names = sorted(bodies)

    def one(k):
        name = names[k % len(names)]
        with tempfile.TemporaryDirectory() as td:
            outs = spawn_pod(bodies[name], timeout=240,
                             args_per_proc=lambda i: [td])
        return name, [{"process": i, "rc": rc, "body_done": MARK in out,
                       "stderr_tail": err[-300:]}
                      for i, (rc, out, err) in enumerate(outs) if rc != 0]

    counts = collections.Counter()
    with concurrent.futures.ThreadPoolExecutor(args.parallel) as ex:
        for k, (name, bad) in enumerate(ex.map(one, range(args.runs))):
            counts[f"{name} {'failed' if bad else 'ok'}"] += 1
            if bad:
                print(json.dumps({"failed": name, "children": bad}),
                      flush=True)
            if (k + 1) % 50 == 0:
                print(k + 1, dict(counts), flush=True)
    print(json.dumps({"repo": repo, "runs": args.runs,
                      "parallel": args.parallel, "counts": dict(counts)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
