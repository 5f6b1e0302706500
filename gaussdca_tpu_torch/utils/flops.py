"""Static operation counts per pipeline stage, as the port executes them.

The costs are closed-form in (M, N, q) and the path taken, so the batch
log reports achieved TFLOP/s per family without device instrumentation.
They count what this package runs on the card, not what the TPU package
runs:

- reweight: kernel A over the half grid, M^2 N q int8 operations on one
  device; kernel C over the full rectangle, 2 M^2 N q, on a mesh; plus
  3 M N q for the closed-form auto-theta;
- frequencies: the one-hot product, 2 M Ns^2 (Ns = N (q - 1));
- solve: Ns^3 for the Cholesky factorization and the inverse from it
  (``solve.cholesky.spd_inverse`` and the mesh's storage-sharded solve
  alike; neither takes a Newton step);
- DI: P pairs of kernel B (``di_pair_flops``), with the Newton-Schulz step
  count of ``score.di.ns_iters`` for the pairs a device scores; frob:
  4 s^2 a pair.

No step count is copied here: it comes from ``score/di.py``, the module
that runs the steps.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gaussdca_tpu_torch.score.di import ns_iters


def di_pair_flops(s: int, iters: int) -> float:
    """Operations of one pair in kernel B at block size s: the rho and G
    products (3 + 1 s x s products), the trimmed Newton-Schulz loop
    (3 (iters - 2) + 2 products) and the elimination's 2 s^3 / 3."""
    products = 3 + 1 + 3 * (iters - 2) + 2
    return products * 2.0 * s ** 3 + 2.0 * s ** 3 / 3.0


def pipeline_flops(M: int, N: int, q: int, *, score: str = "frob",
                   auto_theta: bool = True,
                   dtype: torch.dtype = torch.float32,
                   shards: Optional[int] = None) -> Dict[str, float]:
    """Operations per stage for one family of M sequences, N columns and
    q states; ``shards``: the mesh's shard count (None: one device)."""
    s = q - 1
    Ns = N * s
    out = {
        "reweight": (2.0 if shards else 1.0) * M * M * N * q
        + (3.0 * M * N * q if auto_theta else 0.0),
        "frequencies": 2.0 * M * Ns * Ns,
    }
    out["solve"] = float(Ns) ** 3
    P = N * (N - 1) // 2
    if score == "DI":
        iters = ns_iters(dtype, -(-P // shards) if shards else P)
        out["score"] = P * di_pair_flops(s, iters)
    else:
        out["score"] = P * 4.0 * s * s
    out["total"] = sum(out.values())
    return out
