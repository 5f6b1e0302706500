"""The port's benchmark: one run of one cell on the card.

    python3 portbench/run.py --workload di-wide --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. Prints the result as the last line of
standard output, one JSON object, and the numbers the check compared,
each beside its limit, as the last lines of standard error. Exits
non-zero, with no result, when no CUDA card is visible, when the cell
asks for more cards than there are, or when a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every compiler cache in a fixed place inside the checkout, so only
    # the first run of a checkout builds
    cache = os.path.join(ROOT, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device is visible", file=sys.stderr)
        return 2
    from portbench import harness, spec

    cell = spec.load_cell(ROOT, args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result, lines = harness.run_cell(ROOT, args.workload, args.seed,
                                     args.seconds, bool(args.trace), "cuda",
                                     T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
