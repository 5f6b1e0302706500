"""Storage-sharded SPD inverse: no shard ever holds a full matrix.

The port of ``gaussdca_tpu.solve.distributed``. Every matrix lives as
row slabs ``[w, npad]``, slab d on shard d's device (``npad = ndev * w``;
``plan_padding`` pads n so that the factorization block b divides w, with
an identity tail: block-diag([C, I]) factors and inverts blockwise, so
the top-left n x n corner of the result is exactly inv(C)). One process
drives every shard; the collectives are written out (``parallel.mesh``):

- ``_chol``: right-looking blocked Cholesky. Per step k the b-wide
  column block is gathered, the b x b diagonal block is factored and the
  panel formed once, and every slab takes its rows of the panel and
  applies the rank-b trailing update to its rows below the pivot (the
  JAX body also updates the rows above, whose panel rows are zero, and
  leaves junk there that later steps overwrite; skipping them gives the
  same L).
- ``_tri_inv``: W = inv(L) by block-row forward substitution: block row
  i of L is read from its owner, contracted against the slabs of W that
  hold rows below i b, and the owner solves the b x b triangular system.
- ``_syrk``: X = W^T W, one source slab at a time (W's triangularity
  skips the zero blocks).
- ``_newton``: X <- X + X (I - C X) over the slabs, then X <- (X + X^T)/2
  by a slab transpose.

Precision: the JAX package factors at HIGH (3-pass bf16) and runs one
Newton correction at DEFAULT; here every product runs in full f32 or f64
(the pipeline switches TF32 off, as ``solve/cholesky.py`` does) and no
Newton step is taken by default, in either dtype. In f32 the step's
residual I - C X carries rounding of the size of the error it corrects,
so it pulls any inverse to a floor of its own: on the H100 it brings the
one-device cuSOLVER inverse of the large golden family down to it and
this blocked inverse, which starts below it, up to it; it does not lower
the mesh's golden DI error, and it is half of the solve's products
(``scripts/torch_solve_accuracy.py`` and ``chip_smoke.py``; PERF.md has
the readings). ``refine_iters`` still takes it on request. A failed
block Cholesky raises ``ArithmeticError(NOT_POSITIVE_DEFINITE)``.

Slabs that share a device alias when one is "broadcast" to the other
(``Tensor.to`` onto its own device is a no-op): only the owner's slab is
ever updated in place, and the factorization works on a clone of C.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from gaussdca_tpu_torch.parallel.mesh import Mesh
from gaussdca_tpu_torch.solve.cholesky import NOT_POSITIVE_DEFINITE

Slabs = List[torch.Tensor]


def plan_padding(n: int, ndev: int, block: int) -> Tuple[int, int, int]:
    """(npad, w, b): pad n to ndev*w with b | w and b <= block."""
    w0 = -(-n // ndev)
    b = max(1, min(block, w0))
    w = -(-w0 // b) * b
    return ndev * w, w, b


def pad_slab(C_rows: torch.Tensor, d: int, w: int,
             npad: int) -> torch.Tensor:
    """Slab d [w, npad] of block-diag([C, I]) from the r rows of C it
    holds (global rows d w .. d w + r - 1); the rest is the identity
    tail."""
    r, n = C_rows.shape
    out = torch.zeros((w, npad), dtype=C_rows.dtype, device=C_rows.device)
    out[:r, :n] = C_rows
    tail = torch.arange(r, w, device=C_rows.device)
    out[tail, d * w + tail] = 1.0
    return out


def to_slabs(C: torch.Tensor, mesh: Mesh, block: int) -> Slabs:
    """C [n, n] -> the padded row slabs ``spd_inverse_dist`` takes, slab
    d on shard d's device."""
    npad, w, _ = plan_padding(C.shape[0], mesh.size, block)
    return [pad_slab(C[d * w:(d + 1) * w].to(dev), d, w, npad)
            for d, dev in enumerate(mesh.flat)]


def from_slabs(X: Sequence[torch.Tensor], n: int,
               device: torch.device) -> torch.Tensor:
    """The top-left n x n corner of the slabbed matrix, on ``device``."""
    return torch.cat([x.to(device) for x in X])[:n, :n]


def _chol(A: Slabs, devs, *, npad: int, w: int, b: int) -> torch.Tensor:
    """L = chol(C) in place on the slabs A (owned by the caller); returns
    the summed Cholesky ``info`` of the diagonal blocks (0: success)."""
    home = devs[0]
    eye_b = torch.eye(b, dtype=A[0].dtype, device=home)
    info = torch.zeros((), dtype=torch.int32, device=home)
    for kb in range(0, npad, b):
        col = torch.cat([a[:, kb:kb + b].to(home) for a in A])  # [npad, b]
        Akk = col[kb:kb + b]
        Lkk, inf = torch.linalg.cholesky_ex(0.5 * (Akk + Akk.T))
        info += inf
        Lcol = torch.zeros_like(col)
        Lcol[kb:kb + b] = Lkk
        if kb + b < npad:
            Winv = torch.linalg.solve_triangular(Lkk, eye_b, upper=False)
            Lcol[kb + b:] = col[kb + b:] @ Winv.T
        rest = {dev: Lcol[kb + b:].to(dev) for dev in dict.fromkeys(devs)}
        for d, (a, dev) in enumerate(zip(A, devs)):
            mine = Lcol[d * w:(d + 1) * w].to(dev)
            a[:, kb:kb + b] = mine
            lo = min(w, max(0, kb + b - d * w))   # first row below the pivot
            if kb + b < npad and lo < w:
                a[lo:, kb + b:] -= mine[lo:] @ rest[dev].T
    return info


def _tri_inv(L: Slabs, devs, *, npad: int, w: int, b: int) -> Slabs:
    """Slabs of W = inv(L) from the slabs of lower-triangular L."""
    home = devs[0]
    W = [torch.zeros_like(x) for x in L]
    eye_b = torch.eye(b, dtype=L[0].dtype, device=home)
    for ib in range(0, npad, b):
        own, off = divmod(ib, w)                 # b | w: one owner
        Lrow = L[own][off:off + b]               # [b, npad], read only
        Lii = Lrow[:, ib:ib + b].to(home)
        rhs = eye_b
        if ib:
            # W rows >= ib are still zero: only slabs starting below ib
            # contribute, and W's triangularity bounds the columns at ib
            S = sum((Lrow[:, d * w:(d + 1) * w].to(dev) @ W[d][:, :ib]
                     ).to(home)
                    for d, dev in enumerate(devs) if d * w < ib)
            rhs = torch.cat([-S, eye_b], dim=1)
        Wrow = torch.linalg.solve_triangular(Lii, rhs, upper=False)
        W[own][off:off + b, :ib + b] = Wrow.to(devs[own])
    return W


def _syrk(W: Slabs, devs, *, w: int) -> Slabs:
    """Slabs of X = W^T W from the slabs of lower-triangular W."""
    X = [torch.zeros_like(x) for x in W]
    for src, Ws in enumerate(W):
        hi = (src + 1) * w        # W's rows of slab src end at column hi
        for d in range(src + 1):  # slabs d > src meet only zero columns
            Wsd = Ws.to(devs[d])
            X[d][:, :hi] += Wsd[:, d * w:(d + 1) * w].T @ Wsd[:, :hi]
    return X


def _transpose(X: Slabs, devs, *, w: int) -> Slabs:
    """Slabs of X^T from the slabs of X."""
    Xt = [torch.empty_like(x) for x in X]
    for d, dev in enumerate(devs):
        for src, Xs in enumerate(X):
            Xt[d][:, src * w:(src + 1) * w] = \
                Xs[:, d * w:(d + 1) * w].T.to(dev)
    return Xt


def _symmetrize(X: Slabs, devs, *, w: int) -> Slabs:
    Xt = _transpose(X, devs, w=w)
    return [0.5 * (x + xt) for x, xt in zip(X, Xt)]


def _newton(C: Slabs, X: Slabs, devs, *, w: int, iters: int) -> Slabs:
    """X <- X + X (I - C X) over the slabs, symmetrized, ``iters`` times."""
    for _ in range(iters):
        R = []
        for d, dev in enumerate(devs):
            Rd = torch.zeros_like(X[d])
            Rd[:, d * w:(d + 1) * w].diagonal().fill_(1.0)
            for src, Xs in enumerate(X):
                Rd -= C[d][:, src * w:(src + 1) * w] @ Xs.to(dev)
            R.append(Rd)
        Xn = []
        for d, dev in enumerate(devs):
            Dd = torch.zeros_like(X[d])
            for src, Rs in enumerate(R):
                Dd += X[d][:, src * w:(src + 1) * w] @ Rs.to(dev)
            Xn.append(X[d] + Dd)
        del R
        X = _symmetrize(Xn, devs, w=w)
    return X


def spd_inverse_dist(C_slabs: Sequence[torch.Tensor], mesh: Mesh,
                     block: int = 1024, refine_iters: int = 0) -> Slabs:
    """Storage-sharded ``spd_inverse``: the padded row slabs of C
    (``to_slabs``; slab d on shard d's device) -> the row slabs of
    inv(C), same layout. Per-shard memory O(npad^2 / ndev + npad b).

    ``refine_iters`` Newton steps follow the factorization (none by
    default; see the module docstring). Raises ArithmeticError when C is
    not positive definite.
    """
    devs = mesh.flat
    if len(C_slabs) != len(devs):
        raise ValueError(f"{len(C_slabs)} slabs for a mesh of {len(devs)}")
    w, npad = C_slabs[0].shape
    # plan_padding picks b = w0 <= block (then w = b) or b = block | w
    b = w if w <= block else block
    if npad != len(devs) * w or w % b or any(
            c.shape != (w, npad) or c.device != dev
            for c, dev in zip(C_slabs, devs)):
        raise ValueError(
            "spd_inverse_dist: expected one [w, ndev*w] slab per shard on "
            f"its device with the block dividing w, got w={w}, npad={npad}"
            f", block={block}")
    L = [c.clone() for c in C_slabs]
    info = _chol(L, devs, npad=npad, w=w, b=b)
    W = _tri_inv(L, devs, npad=npad, w=w, b=b)
    del L
    X = _syrk(W, devs, w=w)
    del W
    if int(info) != 0:
        raise ArithmeticError(NOT_POSITIVE_DEFINITE)
    if refine_iters:
        return _newton(list(C_slabs), X, devs, w=w, iters=refine_iters)
    return _symmetrize(X, devs, w=w)
