"""Gaussian DCA from a FASTA file to its ranked contacts, written plainly.

The method (Baldassi et al. 2014, PLoS ONE 9(3):e92721; GaussDCA.jl's
``gDCA``): read the alignment, drop gappy sequences (and duplicates when
asked), weight each sequence by one over its neighbours within the
identity threshold, take the weighted one- and two-site frequencies,
shrink them by the pseudocount, invert the covariance, score each
position pair (the Frobenius norm of its gauge-fixed coupling block, or
its Gaussian direct information), correct by the average product and rank
the pairs at least ``min_separation`` apart.

Everything is computed in blocks of rows so that an alignment of 100,000
sequences fits, on whichever torch device is given. ``precision`` is
"float64" (the reference), "float32", or "tf32": float32 whose matrix
products round their operands to TF32's 10-bit mantissa, as the tensor
cores do when TF32 is allowed (the rounding is done here, so the same
numbers come out on a CPU and on a card). Matrix products otherwise run
at the dtype's full precision: TF32 is switched off while this runs.
"""

from __future__ import annotations

import contextlib
import gzip
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

PRECISIONS = ("float64", "float32", "tf32")
# the 20 standard amino acids, alphabetical, are states 1..20; every other
# letter and the gap are state 21
AMINO = b"ACDEFGHIKLMNPQRSTVWY"
GAP = ord("-")
AUTO_THETA_COEFF = 0.38 * 0.32

Ranking = Tuple[np.ndarray, np.ndarray, np.ndarray]

_LUT = np.full(256, 21, dtype=np.uint8)
_LUT[np.frombuffer(AMINO, dtype=np.uint8)] = np.arange(1, 21, dtype=np.uint8)
# insert states, removed from each sequence: lowercase letters and '.'
_INSERTS = bytes(range(ord("a"), ord("z") + 1)) + b"."


def _records(data: bytes) -> Iterator[bytes]:
    seq: List[bytes] = []
    started = False
    for line in data.split(b"\n"):
        line = line.strip()
        if line.startswith(b">"):
            if started:
                yield b"".join(seq)
            started, seq = True, []
        elif started and line:
            seq.append(line)
    if started:
        yield b"".join(seq)


def read_fasta(path: str, max_gap_fraction: float) -> np.ndarray:
    """Tokens [M, N] (uint8, states 1..21) of a FASTA file, gzipped or
    not: insert states removed, sequences with more than
    ``max_gap_fraction`` gaps dropped."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    kept, width = [], None
    for seq in _records(data):
        seq = seq.translate(None, _INSERTS)
        if width is None:
            width = len(seq)
        elif len(seq) != width:
            raise ValueError(f"{path}: sequences of lengths {width} and "
                             f"{len(seq)}")
        if seq.count(GAP) / width <= max_gap_fraction:
            kept.append(seq)
    if not kept:
        raise ValueError(f"{path}: no sequence within the gap limit")
    raw = np.frombuffer(b"".join(kept), dtype=np.uint8)
    return _LUT[raw].reshape(len(kept), width)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10-bit
    mantissa."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


class _Arith:
    """The dtype and the matrix products of one precision."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.dtype = torch.float64 if precision == "float64" else \
            torch.float32
        self.round = to_tf32 if precision == "tf32" else (lambda x: x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)

    def ein(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self.round(o) for o in ops))


@contextlib.contextmanager
def _full_precision_products():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _one_hot(Z: torch.Tensor, states: int, dtype) -> torch.Tensor:
    """[rows, N * states]: column k * states + c - 1 is 1 where Z[:, k] is
    state c (1 <= c <= states)."""
    c = torch.arange(1, states + 1, device=Z.device, dtype=Z.dtype)
    return (Z[:, :, None] == c).reshape(Z.shape[0], -1).to(dtype)


def _block(rows: int, width: int, budget: int = 1 << 27) -> int:
    """Rows of a block whose [rows, width] product fits ``budget``
    values."""
    return max(1, min(rows, budget // max(1, width)))


def sequence_weights(Z: torch.Tensor, q: int, theta, ar: _Arith
                     ) -> Tuple[torch.Tensor, float]:
    """(W [M], theta): W[a] = 1 / (1 + #{b != a : hamming(a, b) <
    floor(theta N)}); auto theta = min(0.5, 0.1216 / mean fraction
    identity over the M (M - 1) / 2 pairs)."""
    M, N = Z.shape
    if theta == "auto":
        # summed over ordered pairs (a, b), a = b included, the matches
        # are sum over columns k and states c of n_kc^2, with n_kc the
        # sequences holding c at k; each sequence matches itself N times
        n = torch.stack([(Z == c).sum(0) for c in range(1, q + 1)])
        pairs_total = float((n.to(torch.float64) ** 2).sum()) - M * N
        mean_identity = pairs_total / 2 / (N * M * (M - 1) / 2)
        theta = min(0.5, AUTO_THETA_COEFF / mean_identity)
    thresh = int(np.floor(float(theta) * N))
    # one-hot products count matches exactly at every precision here
    # (0/1 operands, sums of at most N)
    E = _one_hot(Z, q, ar.dtype)
    near = torch.empty(M, dtype=torch.int64, device=Z.device)
    step = _block(M, M)
    for r0 in range(0, M, step):
        matches = E[r0:r0 + step] @ E.T
        # neighbours: hamming = N - matches < thresh
        near[r0:r0 + step] = (matches > N - thresh + 0.5).sum(1)
    # the sequence itself (matches = N) is one whenever thresh > 0
    near -= 1 if thresh > 0 else 0
    W = 1.0 / (1.0 + near.to(ar.dtype))
    return W, float(theta)


def covariance(Z: torch.Tensor, W: torch.Tensor, q: int, pc: float,
               ar: _Arith) -> Tuple[torch.Tensor, float]:
    """(C [N s, N s], Meff) over the reduced alphabet 1..s, s = q - 1."""
    M, N = Z.shape
    s = q - 1
    Ns = N * s
    meff = W.sum()
    pi = torch.zeros(Ns, dtype=ar.dtype, device=Z.device)
    pij = torch.zeros((Ns, Ns), dtype=ar.dtype, device=Z.device)
    step = _block(M, Ns, 1 << 26)
    for r0 in range(0, M, step):
        Eb = _one_hot(Z[r0:r0 + step], s, ar.dtype)
        wb = W[r0:r0 + step]
        pi += ar.mm(wb[None, :], Eb)[0]
        pij += ar.mm((Eb * wb[:, None]).T, Eb)
        del Eb
    Pi = (1 - pc) * (pi / meff) + pc / q
    Pij = (1 - pc) * (pij / meff) + pc / q ** 2
    del pij
    # within one site the pseudocount goes on the diagonal only
    Pij.view(N, s, N, s).diagonal(dim1=0, dim2=2).sub_(pc / q ** 2)
    Pij.diagonal().add_(pc / q)
    Pij -= torch.outer(Pi, Pi)
    return Pij, float(meff)


def frob_scores(mJ: torch.Tensor, N: int, s: int) -> torch.Tensor:
    """||P J_ij P||_F per pair, P = I - 1/s (the zero-sum gauge)."""
    J4 = mJ.view(N, s, N, s)
    S = torch.empty((N, N), dtype=mJ.dtype, device=mJ.device)
    step = _block(N, N * s * s, 1 << 24)
    for r0 in range(0, N, step):
        J = J4[r0:r0 + step].permute(0, 2, 1, 3)
        K = J - J.mean(3, keepdim=True) - J.mean(2, keepdim=True) \
            + J.mean((2, 3), keepdim=True)
        S[r0:r0 + step] = K.square().sum((2, 3)).sqrt()
    S.fill_diagonal_(0.0)
    return S


def di_scores(mJ: torch.Tensor, C: torch.Tensor, N: int, s: int,
              ar: _Arith) -> torch.Tensor:
    """Gaussian direct information per pair: with C_ii = L_i L_i^T and
    rho = L_i^T J_ij L_j, DI = 1/2 sum_k log((1 + sqrt(1 + 4 l_k)) / 2)
    over the eigenvalues l_k of rho rho^T."""
    idx = torch.arange(N, device=C.device)
    L = torch.linalg.cholesky(C.view(N, s, N, s)[idx, :, idx, :])
    J4 = mJ.view(N, s, N, s)
    S = torch.zeros((N, N), dtype=mJ.dtype, device=mJ.device)
    step = _block(N, N * s * s, 1 << 23)
    for r0 in range(0, N, step):
        r1 = min(N, r0 + step)
        # the pairs (i, j >= r0) of these rows; j > i is kept below
        left = ar.ein("iba,ibjd->iajd", L[r0:r1], J4[r0:r1, :, r0:])
        rho = ar.ein("iajd,jde->ijae", left, L[r0:])
        del left
        lam = torch.linalg.eigvalsh(ar.ein("ijae,ijbe->ijab", rho, rho))
        lam = lam.clamp_min(0.0)
        S[r0:r1, r0:] = 0.5 * torch.log(
            (1.0 + torch.sqrt(1.0 + 4.0 * lam)) / 2.0).sum(-1)
    S = torch.triu(S, diagonal=1)
    return S + S.T


def apc(S: torch.Tensor) -> torch.Tensor:
    """S - (row sums)(column sums) / (sum (1 - 1/N)); S has a zero
    diagonal."""
    N = S.shape[0]
    total = S.sum() * (1.0 - 1.0 / N)
    if float(total) == 0.0:
        return S
    return S - torch.outer(S.sum(1), S.sum(0)) / total


def reference_scores(path: str, settings: Dict, *, device="cpu",
                     precision: str = "float64"
                     ) -> Tuple[np.ndarray, Dict]:
    """(S [N, N] after APC, as float64 NumPy; facts {M, N, q, theta,
    meff}) of the FASTA file under ``settings`` (score, pseudocount,
    theta, max_gap_fraction, remove_dups)."""
    ar = _Arith(precision)
    tokens = read_fasta(path, float(settings["max_gap_fraction"]))
    if settings.get("remove_dups"):
        _, first = np.unique(tokens, axis=0, return_index=True)
        tokens = tokens[np.sort(first)]
    M, N = tokens.shape
    q = int(tokens.max())
    s = q - 1
    with _full_precision_products(), torch.no_grad():
        Z = torch.as_tensor(tokens, device=device)
        W, theta = sequence_weights(Z, q, settings["theta"], ar)
        C, meff = covariance(Z, W, q, float(settings["pseudocount"]), ar)
        del Z, W
        mJ = torch.linalg.inv(C)
        mJ = (mJ + mJ.T) / 2
        if settings["score"] == "DI":
            S = di_scores(mJ, C, N, s, ar)
        elif settings["score"] == "frob":
            S = frob_scores(mJ, N, s)
        else:
            raise ValueError(f"score {settings['score']!r}")
        del mJ, C
        S = apc(S).to(torch.float64).cpu().numpy()
    return S, {"M": M, "N": N, "q": q, "theta": theta, "meff": meff}


def reference_ranking(S: np.ndarray, min_separation: int) -> Ranking:
    """1-based (i, j, score) arrays of the pairs j >= i + min_separation,
    scored S[j, i], by descending score."""
    i, j = np.triu_indices(S.shape[0], k=min_separation)
    score = S[j, i]
    order = np.argsort(-score, kind="stable")
    return i[order] + 1, j[order] + 1, score[order]
