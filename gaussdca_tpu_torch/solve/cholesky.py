"""SPD inverse of the covariance via Cholesky, in place, in the least work.

The reference's ``mJ = inv(cholesky(C))`` (src/GaussDCA.jl:34) in three
blocked steps on one Ns x Ns buffer beside C (C stays: the DI score reads
it), b = ``BLOCK`` wide, each Ns^3 / 6 multiply-adds:

1. L = chol(C), right-looking: each b x b diagonal block factored
   (``torch.linalg.cholesky_ex``), the panel below it solved against it,
   and the trailing update applied to the lower block triangle only, one
   block row at a time;
2. W = L^-1, by block forward substitution on L W = I: block row k of W
   is L[k, k]^-1 times its right-hand side, which then takes
   -L[k1:, k] W[k, :k1] in every row below (one product a step); W's
   zero blocks right of the diagonal are never touched;
3. X = W^T W, one block column at a time, left to right:
   X[:i1, i] = W[i:, :i1]^T W[i:, i] reads only W's rows at or below
   block i, so it and its mirror image X[i, :i1] overwrite rows and
   columns that no later block reads.

In all Ns^3 / 2 multiply-adds at the dtype's full precision (the pipeline
keeps TF32 off), and besides the buffer at most two Ns x b panels. X is
exactly symmetric (each off-diagonal block is written with its transpose,
each diagonal block averaged with its own) and row-major, so the
consumers' row blocks need no copy. No Newton step follows by default, in
either dtype: in f32 the step's residual pulls any inverse to a floor of
its own, which this inverse starts below and cuSOLVER's whole-matrix
factor and inverse start above; the f32 error grows with b
(``scripts/torch_solve_accuracy.py``; PERF.md's solve accuracy table has
the readings). ``newton_refine`` still takes the step on request. The JAX
package's doubling triangular inverse and slab SYRK exist because the
TPU's TRSM serializes its panel steps; they are not part of this port.
"""

from __future__ import annotations

from typing import Dict

import torch

NOT_POSITIVE_DEFINITE = (
    "non-finite contact scores: the covariance matrix is not "
    "positive definite (pseudocount too small for this "
    "alignment depth?) — the reference fails here with "
    "PosDefException from inv(cholesky(C))")

# the block width b (PERF.md: the fastest at Ns = 20000 on an H100 of the
# widths whose f32 inverse passes the large golden family's gate)
BLOCK = 1024


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


def solve_steps(n: int, refine_iters: int = 0) -> Dict[str, int]:
    """What ``spd_inverse`` does for an n x n C: its block steps and its
    Newton steps (the ``solve`` span's attributes)."""
    return {"blocks": -(-n // BLOCK), "refine": refine_iters}


def _spd_inverse_blocked(C: torch.Tensor, block: int) -> torch.Tensor:
    """inv(C) by the module's three steps at block width ``block``;
    raises ArithmeticError when the Cholesky factorization fails."""
    n = C.shape[0]
    b = min(block, n)
    steps = [(k0, min(n, k0 + b)) for k0 in range(0, n, b)]
    A = C.tril()
    # 1. L in A's lower triangle; a failed block leaves its info, checked
    # once after the loop
    info = torch.zeros((), dtype=torch.int32, device=C.device)
    for k0, k1 in steps:
        Lkk, inf = torch.linalg.cholesky_ex(A[k0:k1, k0:k1])
        info += inf
        A[k0:k1, k0:k1] = Lkk
        if k1 < n:
            # the panel P solves P Lkk^T = A[k1:, k] into a panel of its own:
            # solved in place on an H100 it came out slower and less
            # accurate (PERF.md)
            P = torch.linalg.solve_triangular(Lkk.mT, A[k1:, k0:k1],
                                              upper=True, left=False)
            A[k1:, k0:k1] = P
            for r0, r1 in steps:
                if r0 >= k1:
                    A[r0:r1, k1:r1].addmm_(P[r0 - k1:r1 - k1],
                                           P[:r1 - k1].mT, alpha=-1)
    if int(info) != 0:
        raise ArithmeticError(NOT_POSITIVE_DEFINITE)
    panel = torch.empty((n, b), dtype=C.dtype, device=C.device)
    # 2. W in place of L: rows below block k hold their right-hand sides
    # left of column k1 and L right of it
    for k0, k1 in steps:
        Lkk = A[k0:k1, k0:k1].clone()
        R = A[k0:k1, :k1]
        R[:, k0:k1].zero_()
        R[:, k0:k1].diagonal().fill_(1.0)
        torch.linalg.solve_triangular(Lkk, R, upper=False, out=R)
        if k1 < n:
            P = panel[:n - k1, :k1 - k0]
            P.copy_(A[k1:, k0:k1])
            A[k1:, k0:k1].zero_()
            A[k1:, :k1].addmm_(P, R, alpha=-1)
    # 3. X in place of W
    for i0, i1 in steps:
        T = torch.mm(A[i0:, :i1].mT, A[i0:, i0:i1],
                     out=panel[:i1, :i1 - i0])
        D = T[i0:]
        D.copy_((D + D.mT) * 0.5)
        A[:i1, i0:i1] = T
        A[i0:i1, :i1] = T.mT
    return A


def spd_inverse(C: torch.Tensor, refine_iters: int = 0) -> torch.Tensor:
    """Inverse of a symmetric positive-definite matrix, row-major and
    exactly symmetric; raises ArithmeticError when the Cholesky
    factorization fails. ``refine_iters`` Newton steps follow."""
    X = _spd_inverse_blocked(C, BLOCK)
    if refine_iters:
        X = newton_refine(C, X, refine_iters)
    return X
