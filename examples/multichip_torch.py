"""Multi-device usage of the PyTorch port: one entry point that scales.

``mesh="auto"`` lays a (data, model) mesh over every visible CUDA card;
``--device cpu`` demonstrates the same sharded program on a mesh of
eight CPU shards in one process (no card required):

    python examples/multichip_torch.py [path/to/family.fasta.gz]
        [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))
import torch  # noqa: E402

import gaussdca_tpu_torch as g  # noqa: E402
from gaussdca_tpu_torch.parallel.mesh import Mesh  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("path", nargs="?", default=os.path.join(
    os.path.dirname(__file__), "..", "tests", "data", "small.fasta.gz"))
ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
args = ap.parse_args()

if args.device == "cpu":
    mesh = Mesh([torch.device("cpu")] * 8, (4, 2))
    n_devices = 8
else:
    mesh = "auto"
    n_devices = torch.cuda.device_count()

# single-device and sharded runs of the same family, same entry point
r1 = g.gdca(args.path, device=args.device)
r8 = g.gdca(args.path, device=args.device, mesh=mesh)  # or mesh=(4, 2)

print(f"devices: {n_devices}  M={r8.M} N={r8.N} q={r8.q} "
      f"theta={r8.theta:.4f} Meff={r8.meff:.2f}")
print("top-5 (sharded):", [(i, j, round(s, 4)) for i, j, s in r8[:5]])
# f32 reductions run in a different order on the mesh: scores agree
# to summation-order noise (~1e-4 relative through the f32 solve)
agree = all(abs(a[2] - b[2]) < 5e-4 * max(1.0, abs(a[2]))
            for a, b in zip(sorted(r1.ranking), sorted(r8.ranking)))
print("single-chip == sharded (to f32 summation order):", agree)
