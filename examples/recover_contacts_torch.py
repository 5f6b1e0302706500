"""End-to-end demo of the PyTorch port: recover planted covarying pairs.

Generates a synthetic MSA where K position pairs covary (position j
copies a permuted image of position i with high probability) against an
iid background, runs the port's whole pipeline (``gdca_from_msa``) on it,
and reports how many planted pairs land in the top-K ranking: the
contact-prediction task the method exists for, checked without any
external data.

    python examples/recover_contacts_torch.py [--score DI] [--seqs 2000]
        [--device cuda|cpu] [--dtype float32|float64]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def synth_msa(M=2000, N=60, q=21, n_pairs=8, copy_p=0.8, min_sep=5,
              seed=0):
    """(tokens [M, N] in 1..q, planted pair list, 1-based)."""
    rng = np.random.default_rng(seed)
    Z = rng.integers(1, q + 1, size=(M, N), dtype=np.int8)
    pairs = []
    free = list(range(N))
    while len(pairs) < n_pairs and len(free) > min_sep + 1:
        i = free[rng.integers(0, len(free) // 2)]
        js = [j for j in free if j >= i + min_sep]
        if not js:
            free.remove(i)
            continue
        j = js[rng.integers(0, len(js))]
        free.remove(i)
        free.remove(j)
        perm = rng.permutation(q) + 1
        copy = rng.random(M) < copy_p
        Z[copy, j] = perm[Z[copy, i] - 1]
        pairs.append((i + 1, j + 1))
    return Z, sorted(pairs)


def recover(Z, planted, score, *, device="cuda", dtype="float32", q=21,
            theta=0.2):
    """Run the port on tokens Z (pseudocount 0.2 for DI, else 0.8) and
    return (result, the top len(planted) pairs, planted pairs among
    them)."""
    from gaussdca_tpu_torch import api
    from gaussdca_tpu_torch.core.config import GDCAConfig
    from gaussdca_tpu_torch.interop import msa_from_arrays

    msa = msa_from_arrays(Z, q, [f"s{i}" for i in range(len(Z))])
    cfg = GDCAConfig(score=score, pseudocount=0.2 if score == "DI" else 0.8,
                     theta=theta, dtype=dtype, device=device)
    res = api.gdca_from_msa(msa, cfg)
    top = {(i, j) for i, j, _ in res.ranking[:len(planted)]}
    return res, top, sum(1 for p in planted if p in top)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--score", choices=["frob", "DI"], default="frob")
    ap.add_argument("--seqs", type=int, default=2000)
    ap.add_argument("--cols", type=int, default=60)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=["float32", "float64"],
                    default="float32")
    args = ap.parse_args(argv)

    Z, planted = synth_msa(args.seqs, args.cols, n_pairs=args.pairs)
    res, top, hits = recover(Z, planted, args.score, device=args.device,
                             dtype=args.dtype)
    print(f"score={args.score}  planted={planted}")
    print(f"top-{len(planted)}: {sorted(top)}")
    print(f"recovered {hits}/{len(planted)} planted pairs "
          f"(theta={res.theta:.3f}, Meff={res.meff:.0f})")


if __name__ == "__main__":
    main()
