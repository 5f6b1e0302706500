#!/usr/bin/env python3
"""Accuracy of the port's f32 covariance inverse, one device vs a mesh.

    python3 scripts/torch_solve_accuracy.py [--device cuda|cpu] [--shards 4]

On the covariance of ``tests/data/large.fasta.gz`` (dedup, pc 0.2,
auto-theta; Ns = 8000, the narrowest f32 golden gate), for the
single-device solve (``spd_inverse``: cuSOLVER/LAPACK Cholesky + inverse)
and the storage-sharded solve (``spd_inverse_dist`` over ``--shards``
shards of one device), each with 0, 1 and 2 Newton steps, prints:

- the max relative error of the f32 inverse against inv(C64), the
  inverse of the f64 covariance, and against inv(C32), the f64 inverse of
  the f32 covariance (which isolates the solver's own error from C's f32
  rounding);
- the max abs error of the DI scores that inverse gives (``di_score``,
  APC, ranking) against the golden file ``large.DIRout.txt``, the number
  the f32 golden gate (1e-3) reads.

Imports torch, never JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    from gaussdca_tpu_torch.core.runtime import full_f32_matmuls
    from gaussdca_tpu_torch.io import fasta
    from gaussdca_tpu_torch.parallel.mesh import Mesh
    from gaussdca_tpu_torch.score.apc import correct_apc
    from gaussdca_tpu_torch.score.di import di_score
    from gaussdca_tpu_torch.score.rank import compute_ranking
    from gaussdca_tpu_torch.solve import distributed
    from gaussdca_tpu_torch.solve.cholesky import spd_inverse
    from gaussdca_tpu_torch.stats import frequencies, pseudocount, reweight

    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(f"device {torch.cuda.get_device_name(dev)}")
    data = os.path.join(REPO, "tests", "data")
    msa = fasta.remove_duplicate_sequences(fasta.read_fasta_alignment(
        os.path.join(data, "large.fasta.gz"), 0.9))
    Z = torch.as_tensor(msa.tokens, device=dev)
    golden = {}
    with open(os.path.join(data, "large.DIRout.txt")) as fh:
        for line in fh:
            i, j, x = line.split()
            golden[(int(i), int(j))] = float(x)

    def rel_err(X, ref):
        return float((X.double() - ref).abs().max() / ref.abs().max())

    def covariance(dt):
        W, _, _ = reweight.compute_weights_streaming(Z, "auto", msa.q,
                                                     dtype=dt)
        Pi, Pij, _ = frequencies.weighted_frequencies(Z, W, msa.q, dtype=dt)
        return pseudocount.compute_C(
            *pseudocount.add_pseudocount(Pi, Pij, 0.2, msa.q))

    def golden_err(mJ, C):
        S = correct_apc(di_score(mJ, C, msa.q))
        got = {(i, j): x for i, j, x in compute_ranking(S.cpu().numpy(), 5)}
        if set(got) != set(golden):
            raise AssertionError("DI ranking lost the golden pair set")
        return max(abs(got[k] - golden[k]) for k in golden)

    with full_f32_matmuls():
        C64 = covariance(torch.float64)
        C32 = covariance(torch.float32)
        refs = {"inv(C64)": torch.linalg.inv(C64),
                "inv(C32)": torch.linalg.inv(C32.double())}
        print(f"Ns {C64.shape[0]}, cond(C64) "
              f"{float(torch.linalg.cond(C64)):.4e}")
        mesh = Mesh([dev] * args.shards, (args.shards, 1))
        n = C32.shape[0]
        for steps in (0, 1, 2):
            single = spd_inverse(C32, refine_iters=steps)
            slabs = distributed.spd_inverse_dist(
                distributed.to_slabs(C32, mesh, 1024), mesh, block=1024,
                refine_iters=steps)
            sharded = distributed.from_slabs(slabs, n, dev)
            for name, X in (("single", single), ("mesh", sharded)):
                errs = ", ".join(
                    f"vs {r} {rel_err(X, R):.3e}" for r, R in refs.items())
                print(f"{name:6s} {steps} Newton step(s): inverse {errs}; "
                      f"golden DI max abs {golden_err(X, C32):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
