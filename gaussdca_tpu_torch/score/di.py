"""Gaussian Direct Information scores.

The contract of ``gaussdca_tpu.score.di.di_score`` (DCAUtils
``compute_DI_gauss``): for each position pair (i, j),

    DI_ij = 1/2 logdet((I + sqrtm(G)) / 2),  G = I + 4 rho rho^T,
    rho = L_i^T J_ij L_j,  C_ii = L_i L_i^T (Cholesky),

over all P = N(N-1)/2 pairs, assembled into a symmetric N x N matrix with
a zero diagonal. One formulation serves every dtype and pair count: the
fixed-step Newton-Schulz core of ``_di_pairs_bm_minor``
(``ops.di_kernel.di_pairs``, the Hopper kernel on a CUDA tensor). The JAX
package's monitored f64 loop, its small-P gemm path and its TPU lane
layouts (mapped / tiled / gathered) are not part of this port.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussdca_tpu_torch.ops.di_kernel import BM_NS_ITERS, di_pairs

__all__ = ["BM_NS_ITERS", "site_cholesky", "di_score"]


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
    di = di_pairs(mJ, Lsite, iu, ju, BM_NS_ITERS)
    S = torch.zeros((N, N), dtype=mJ.dtype, device=mJ.device)
    S[iu, ju] = di
    S[ju, iu] = di
    return S
