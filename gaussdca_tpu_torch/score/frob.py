"""Frobenius-norm coupling scores.

The contract of ``gaussdca_tpu.score.frob.frob_score`` (DCAUtils
``compute_FN``): for each position pair (i, j) take the s x s block J_ij
of mJ (s = q - 1), move it to the zero-sum gauge over the block itself,

  K_ab = J_ab - R_a/s - Cl_b/s + T/s^2   (R row sums, Cl column sums,
                                          T the block total),

and score the pair by ||K||_F. The result is the symmetric N x N matrix
with a zero diagonal. Row-chunked: memory O(chunk * N * s^2).
"""

from __future__ import annotations

import torch


def frob_score(mJ: torch.Tensor, q: int, *, row_chunk: int = 64
               ) -> torch.Tensor:
    """S [N, N]: zero-sum-gauge Frobenius norm per position pair."""
    s = q - 1
    N = mJ.shape[0] // s
    J4 = mJ.reshape(N, s, N, s)
    S = torch.empty((N, N), dtype=mJ.dtype, device=mJ.device)
    for r0 in range(0, N, row_chunk):
        Jb = J4[r0:r0 + row_chunk].permute(0, 2, 1, 3)   # [c, N, s, s]
        rm = Jb.mean(3)                                  # row means
        cm = Jb.mean(2)                                  # column means
        mm = rm.mean(2)                                  # grand mean
        K = Jb - rm[..., :, None] - cm[..., None, :] + mm[..., None, None]
        S[r0:r0 + row_chunk] = torch.sqrt((K * K).sum((2, 3)))
    return S * (1.0 - torch.eye(N, dtype=mJ.dtype, device=mJ.device))
