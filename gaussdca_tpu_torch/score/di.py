"""Gaussian Direct Information scores.

The contract of ``gaussdca_tpu.score.di.di_score`` (DCAUtils
``compute_DI_gauss``): for each position pair (i, j),

    DI_ij = 1/2 logdet((I + sqrtm(G)) / 2),  G = I + 4 rho rho^T,
    rho = L_i^T J_ij L_j,  C_ii = L_i L_i^T (Cholesky),

over all P = N(N-1)/2 pairs, assembled into a symmetric N x N matrix with
a zero diagonal. One formulation serves every dtype and pair count: the
Newton-Schulz core of ``_di_pairs_bm_minor`` (``ops.di_kernel.di_pairs``,
the Hopper kernel on a CUDA tensor), run for the JAX package's step count
(``ns_iters``): 40 steps in f64, where JAX runs its monitored loop to
convergence with a cap of 40; 28 in f32 below 16384 pairs, JAX's
fixed-step small-batch path; else 14, its batch-minor core. The JAX
package's TPU lane layouts (mapped / tiled / gathered) are not part of
this port.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussdca_tpu_torch.ops.di_kernel import BM_NS_ITERS, di_pairs

__all__ = ["BM_NS_ITERS", "site_cholesky", "di_score", "ns_iters"]

# gaussdca_tpu.score.di: sqrtm_spd's cap (f64), FALLBACK_NS_ITERS (f32
# below _BM_MIN_PAIRS pairs) and _BM_MIN_PAIRS
F64_NS_ITERS = 40
SMALL_NS_ITERS = 28
BM_MIN_PAIRS = 16384


def ns_iters(dtype: torch.dtype, npairs: int) -> int:
    """Newton-Schulz steps for a batch of ``npairs`` pairs in ``dtype``,
    the JAX package's rule: 40 in f64, 28 in f32 below 16384 pairs, else
    14. A mesh judges by its pairs a shard, ceil(P / shards), as JAX's
    sharded DI does, so every shard runs the same count."""
    if dtype == torch.float64:
        return F64_NS_ITERS
    return SMALL_NS_ITERS if npairs < BM_MIN_PAIRS else BM_NS_ITERS


def site_cholesky(C: torch.Tensor, q: int) -> torch.Tensor:
    """Cholesky factor of every diagonal site block C_ii: [N, s, s]."""
    s = q - 1
    N = C.shape[0] // s
    idx = torch.arange(N, device=C.device)
    Cii = C.reshape(N, s, N, s)[idx, :, idx, :]
    return torch.linalg.cholesky(Cii)


def di_score(mJ: torch.Tensor, C: torch.Tensor, q: int) -> torch.Tensor:
    """S [N, N]: Gaussian direct information per position pair."""
    s = q - 1
    N = mJ.shape[0] // s
    Lsite = site_cholesky(C, q).contiguous()
    iu_np, ju_np = np.triu_indices(N, k=1)
    iu = torch.as_tensor(iu_np, device=mJ.device)
    ju = torch.as_tensor(ju_np, device=mJ.device)
    di = di_pairs(mJ, Lsite, iu, ju, ns_iters(mJ.dtype, iu.numel()))
    S = torch.zeros((N, N), dtype=mJ.dtype, device=mJ.device)
    S[iu, ju] = di
    S[ju, iu] = di
    return S
