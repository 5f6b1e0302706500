"""SPD inverse of the covariance via Cholesky.

The reference's ``mJ = inv(cholesky(C))`` (src/GaussDCA.jl:34):
``torch.linalg.cholesky_ex`` + ``torch.cholesky_inverse`` (LAPACK on the
CPU, cuSOLVER on the card), then symmetrized and returned row-major. In
f32 one Newton step ``X <- X + X (I - C X)`` (``newton_refine``) follows
at full f32 (the pipeline runs with TF32 off), the f32 default of
``gaussdca_tpu.solve.cholesky.spd_inverse``
(``refine_iters=1``): it recovers most of what the factorization loses
through cond(C). The JAX package's doubling triangular inverse and slab
SYRK exist because the TPU's TRSM serializes its panel steps; they are not
part of this port.
"""

from __future__ import annotations

from typing import Optional

import torch

NOT_POSITIVE_DEFINITE = (
    "non-finite contact scores: the covariance matrix is not "
    "positive definite (pseudocount too small for this "
    "alignment depth?) — the reference fails here with "
    "PosDefException from inv(cholesky(C))")


def newton_refine(C: torch.Tensor, X: torch.Tensor,
                  iters: int) -> torch.Tensor:
    """``iters`` Newton steps ``X <- X + X (I - C X)`` on an approximate
    inverse X of C, each followed by ``X <- (X + X^T) / 2``; the products
    run at the dtype's full precision (the pipeline keeps TF32 off)."""
    for _ in range(iters):
        # R = I - C X, the identity added on the diagonal in place
        R = -(C @ X)
        R.diagonal().add_(1.0)
        X = X + X @ R
        X = (X + X.T) * 0.5
    return X


def spd_inverse(C: torch.Tensor,
                refine_iters: Optional[int] = None) -> torch.Tensor:
    """Inverse of a symmetric positive-definite matrix; raises
    ArithmeticError when the Cholesky factorization fails.
    ``refine_iters`` Newton steps follow (None: 1 in f32, 0 in f64)."""
    L, info = torch.linalg.cholesky_ex(C)
    if int(info) != 0:
        raise ArithmeticError(NOT_POSITIVE_DEFINITE)
    if refine_iters is None:
        refine_iters = 1 if C.dtype == torch.float32 else 0
    if refine_iters:
        # no reference kept here: the first step frees the factorization's
        # inverse (an [Ns, Ns] buffer, 1.6 GB at the f32 DI cell)
        S = newton_refine(C, torch.cholesky_inverse(L), refine_iters)
    else:
        X = torch.cholesky_inverse(L)
        S = (X + X.T) * 0.5
    # exactly symmetric (a + b == b + a; newton_refine ends on the same
    # step), so its transpose is the same matrix: hand it on row-major,
    # where X is column-major as LAPACK and cuSOLVER write it, and the
    # consumers' row blocks need no copy
    return S if S.is_contiguous() else S.T.contiguous()
