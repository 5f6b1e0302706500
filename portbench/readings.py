"""The readings that a cell's limits are set from; not part of a run.

    python3 portbench/readings.py --workload di-wide --seeds 101-112 \
        --control-seeds 101-103

For each seed of ``--seeds``: the cell's pool, one batch call of the
timed path over it (the same command line as the window's calls), and
the check's numbers against the reference: the program's readings. For
each seed of ``--control-seeds``: the control, the reference computed in
TF32 (``reference.gdca``'s "tf32"), put in the program's place: its
rankings written as the program writes them and judged the same way.
One JSON line a reading; the limits file plays no part except for
``top_k`` heads.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text: str):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def write_ranking(path: str, S, min_separation: int) -> None:
    from portbench.reference import reference_ranking

    i, j, s = reference_ranking(S, min_separation)
    with open(path, "w") as fh:
        fh.write("".join(f"{a} {b} {x:e}\n" for a, b, x in zip(i, j, s)))


def readings(root: str, name: str, seeds, control_seeds, device: str,
             bench_dir: str = None):
    """Yield one reading dict a (seed, side)."""
    from portbench import check, harness, spec, traffic

    cell = spec.load_cell(root, name, bench_dir or spec.HERE)
    settings = cell.config["settings"]
    m = int(settings["min_separation"])
    top_k = cell.traffic.get("cli", {}).get("top_k")
    for side, side_seeds in (("program", seeds), ("control", control_seeds)):
        for seed in side_seeds:
            with tempfile.TemporaryDirectory(prefix="portbench-") as work:
                pool = traffic.make_pool(cell.traffic, seed,
                                         os.path.join(work, "pool"))
                out = os.path.join(work, "out")
                t0 = time.perf_counter()
                if side == "program":
                    call = harness.batch_call(harness.cli_argv(
                        cell, [f.path for f in pool], out, device, work))
                    if call.rc != 0:
                        raise RuntimeError("\n".join(
                            line for _, line in call.lines[-20:]))
                else:
                    os.makedirs(out)
                    low = harness.references(cell, pool, device, "tf32")
                    for path, S in zip(harness.output_paths(out, pool), low):
                        write_ranking(path, S, m)
                t1 = time.perf_counter()
                refs = harness.references(cell, pool, device)
                t2 = time.perf_counter()
                limits = dict(cell.limits)
                got = check.judge(harness.output_paths(out, pool), refs, m,
                                  limits, top_k)
            yield {"workload": name, "side": side, "seed": seed,
                   **{k: v["value"] for k, v in got.items()},
                   "side_s": t1 - t0, "reference_s": t2 - t1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    for r in readings(ROOT, args.workload, args.seeds, args.control_seeds,
                      args.device):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
