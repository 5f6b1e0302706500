"""Frobenius-norm coupling scores.

The contract of ``gaussdca_tpu.score.frob.frob_score`` (DCAUtils
``compute_FN``): for each position pair (i, j) take the s x s block J_ij
of mJ (s = q - 1), move it to the zero-sum gauge over the block itself,

  K_ab = J_ab - R_a/s - Cl_b/s + T/s^2   (R row sums, Cl column sums,
                                          T the block total),

and score the pair by ||K||_F. The result is the symmetric N x N matrix
with a zero diagonal. Row-chunked: memory O(chunk * N * s^2).
``frob_rows`` scores a row slab of mJ, so the mesh path scores each
shard's slab where it lies.
"""

from __future__ import annotations

import torch


def frob_rows(J: torch.Tensor, q: int, *, row_chunk: int = 64
              ) -> torch.Tensor:
    """Scores [rows, N] of a row slab J [rows * s, N * s] of mJ (the
    diagonal blocks of the slab's sites are scored too: the caller masks
    them)."""
    s = q - 1
    rows, N = J.shape[0] // s, J.shape[1] // s
    J4 = J.reshape(rows, s, N, s)
    S = torch.empty((rows, N), dtype=J.dtype, device=J.device)
    for r0 in range(0, rows, row_chunk):
        Jb = J4[r0:r0 + row_chunk].permute(0, 2, 1, 3)   # [c, N, s, s]
        rm = Jb.mean(3)                                  # row means
        cm = Jb.mean(2)                                  # column means
        mm = rm.mean(2)                                  # grand mean
        K = Jb - rm[..., :, None] - cm[..., None, :] + mm[..., None, None]
        S[r0:r0 + row_chunk] = torch.sqrt((K * K).sum((2, 3)))
    return S


def frob_score(mJ: torch.Tensor, q: int, *, row_chunk: int = 64
               ) -> torch.Tensor:
    """S [N, N]: zero-sum-gauge Frobenius norm per position pair."""
    S = frob_rows(mJ, q, row_chunk=row_chunk)
    N = S.shape[0]
    return S * (1.0 - torch.eye(N, dtype=mJ.dtype, device=mJ.device))
