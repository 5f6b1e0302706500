"""All-pairs sequence-identity row statistics (hot loop #1).

``row_stats(Z, thresh) -> (rowsum, below)`` is the contract of
``gaussdca_tpu.ops.distance.row_stats_sym_pallas``: for every row a of the
token matrix Z [M, N],

    rowsum[a] = sum_b matches(a, b)
    below[a]  = #{b : N - matches(a, b) < thresh}

over all b, b = a included, where ``matches`` counts the columns on which
two rows carry the same non-zero token (token 0 is padding and matches
nothing, itself included). The [M, M] match matrix never exists.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
A, ``csrc/row_stats.cu`` (tokens packed 4 to a word, bytewise compare and
popcount, upper-triangle tiles with integer atomics; the source says what
bounds it). On a CPU tensor it runs ``row_stats_torch``, the plain
PyTorch version.

``row_stats_rect(ZA, ZB, thresh)`` is the contract of
``row_stats_rect_pallas``: the same statistics for A's rows against all of
B's rows, the per-shard reweighting of the mesh path. On a CUDA tensor it
launches kernel C, ``csrc/row_stats_rect.cu`` (the same packed compare
over the full rectangular tile grid); on a CPU tensor it runs
``row_stats_rect_torch``. ``row_stats_full(Z, t)`` is ``row_stats_rect(Z,
Z, t)``, the port of the full-grid ``row_stats_pallas``.
"""

from __future__ import annotations

import ctypes

import torch

from gaussdca_tpu_torch.ops import _build

# the kernel stages 16 words of 4 tokens per step: pad N to a multiple
_TOKEN_ALIGN = 64


def row_stats_rect_torch(ZA: torch.Tensor, ZB: torch.Tensor, thresh,
                         n_true=None, *, row_chunk: int = 4096):
    """Plain PyTorch ``row_stats_rect``: a row-chunked one-hot matmul of
    A's rows against B's.

    Match counts are sums of 0/1 products, exact in f32 while N < 2^24
    (also under TF32, which represents 0 and 1 exactly); row sums are
    accumulated in f64 so they round once, like the kernel's integer
    sums. Peak memory is the two [M, N*q] f32 one-hots plus one
    [row_chunk, Mb] count block.
    """
    Ma, N = ZA.shape
    Mb = ZB.shape[0]
    n = N if n_true is None else int(n_true)
    rowsum = torch.zeros(Ma, dtype=torch.float32, device=ZA.device)
    below = torch.zeros(Ma, dtype=torch.float32, device=ZA.device)
    if Ma == 0 or Mb == 0:
        return rowsum, below
    q = max(int(ZA.max()), int(ZB.max()))
    states = torch.arange(1, q + 1, dtype=ZA.dtype, device=ZA.device)

    def one_hot(Z):
        return (Z[:, :, None] == states).reshape(Z.shape[0], N * q).to(
            torch.float32)

    EB = one_hot(ZB)
    th = float(thresh)
    for r0 in range(0, Ma, row_chunk):
        D = one_hot(ZA[r0:r0 + row_chunk]) @ EB.T       # [chunk, Mb]
        rowsum[r0:r0 + row_chunk] = D.sum(1, dtype=torch.float64).float()
        below[r0:r0 + row_chunk] = ((n - D) < th).sum(1).float()
    return rowsum, below


def row_stats_torch(Z: torch.Tensor, thresh, *, row_chunk: int = 4096):
    """Plain PyTorch ``row_stats``: ``row_stats_rect_torch(Z, Z, ...)``."""
    return row_stats_rect_torch(Z, Z, thresh, row_chunk=row_chunk)


def _check_tokens(fn: str, *Zs: torch.Tensor) -> None:
    for Z in Zs:
        if Z.dim() != 2 or Z.dtype not in (torch.uint8, torch.int8):
            raise ValueError(
                f"{fn}: expected a 2-D uint8/int8 token matrix, got "
                f"{Z.dtype} of shape {tuple(Z.shape)}")
        if Z.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{fn}: unsupported device {Z.device}")


def pack_tokens(Z: torch.Tensor) -> torch.Tensor:
    """The kernels' input layout: tokens [M, N] -> int32 words [M, Np / 4],
    4 tokens a word, N zero-padded to a multiple of 64 (padding never
    matches). A row block of Z packs to the same row block of words."""
    M, N = Z.shape
    Np = max(_TOKEN_ALIGN, -(-N // _TOKEN_ALIGN) * _TOKEN_ALIGN)
    Zp = torch.zeros((M, Np), dtype=torch.uint8, device=Z.device)
    Zp[:, :N] = Z.view(torch.uint8)
    return Zp.view(torch.int32)


def _lib(name: str, fn_name: str, argtypes) -> ctypes.CDLL:
    lib = _build.library(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def row_stats(Z: torch.Tensor, thresh):
    """(rowsum [M] f32, below [M] f32) of token matrix Z (uint8 or int8,
    states 0..31). ``thresh``: a Python or 0-d tensor scalar, compared in
    f32 like the TPU kernel. CPU tensors take ``row_stats_torch``; CUDA
    tensors launch kernel A (build and launch errors raise)."""
    _check_tokens("row_stats", Z)
    if Z.device.type == "cpu":
        return row_stats_torch(Z, thresh)
    M, N = Z.shape
    rowsum = torch.zeros(M, dtype=torch.int64, device=Z.device)
    below = torch.zeros(M, dtype=torch.int64, device=Z.device)
    if M == 0:
        return rowsum.float(), below.float()
    words = pack_tokens(Z)
    fn = _lib("row_stats", "gdca_row_stats", [_P, _I, _I, _I, _F, _P, _P, _P])
    with torch.cuda.device(Z.device):
        err = fn(words.data_ptr(), M, words.shape[1], N, float(thresh),
                 rowsum.data_ptr(), below.data_ptr(),
                 torch.cuda.current_stream(Z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_stats kernel launch failed: CUDA error {err}")
    row_stats.launches += 1
    return rowsum.to(torch.float32), below.to(torch.float32)


row_stats.launches = 0


def row_stats_rect_packed(A: torch.Tensor, B: torch.Tensor, n_true: int,
                          thresh):
    """``row_stats_rect`` on packed words (``pack_tokens``) on one CUDA
    device: the mesh path packs the tokens once per device and passes
    each shard's row block as a slice of them."""
    if (A.dtype != torch.int32 or B.dtype != torch.int32 or A.dim() != 2
            or B.dim() != 2 or A.shape[1] != B.shape[1]):
        raise ValueError("row_stats_rect_packed: expected int32 words "
                         f"[Ma, W], [Mb, W]; got {A.dtype} {tuple(A.shape)}, "
                         f"{B.dtype} {tuple(B.shape)}")
    if A.device.type != "cuda" or B.device != A.device:
        raise ValueError("row_stats_rect_packed: A and B must lie on one "
                         f"CUDA device, got {A.device} and {B.device}")
    A, B = A.contiguous(), B.contiguous()
    Ma, Mb = A.shape[0], B.shape[0]
    rowsum = torch.zeros(Ma, dtype=torch.int64, device=A.device)
    below = torch.zeros(Ma, dtype=torch.int64, device=A.device)
    if Ma and Mb:
        fn = _lib("row_stats_rect", "gdca_row_stats_rect",
                  [_P, _I, _P, _I, _I, _I, _F, _P, _P, _P])
        with torch.cuda.device(A.device):
            err = fn(A.data_ptr(), Ma, B.data_ptr(), Mb, A.shape[1],
                     int(n_true), float(thresh), rowsum.data_ptr(),
                     below.data_ptr(),
                     torch.cuda.current_stream(A.device).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"row_stats_rect kernel launch failed: CUDA error {err}")
        row_stats_rect.launches += 1
    return rowsum.to(torch.float32), below.to(torch.float32)


def row_stats_rect(ZA: torch.Tensor, ZB: torch.Tensor, thresh,
                   n_true=None):
    """(rowsum [Ma] f32, below [Ma] f32) of A's rows against all of B's:
    ``rowsum[a] = sum_b matches(a, b)``, ``below[a] = #{b : n_true -
    matches(a, b) < thresh}`` (``n_true`` defaults to N). CPU tensors take
    ``row_stats_rect_torch``; CUDA tensors launch kernel C (build and
    launch errors raise)."""
    _check_tokens("row_stats_rect", ZA, ZB)
    if ZA.shape[1] != ZB.shape[1] or ZA.device != ZB.device:
        raise ValueError(
            f"row_stats_rect: ZA {tuple(ZA.shape)} on {ZA.device} and ZB "
            f"{tuple(ZB.shape)} on {ZB.device} need one width and device")
    n = ZA.shape[1] if n_true is None else int(n_true)
    if ZA.device.type == "cpu":
        return row_stats_rect_torch(ZA, ZB, thresh, n)
    B = pack_tokens(ZB)
    A = B if ZA is ZB else pack_tokens(ZA)
    return row_stats_rect_packed(A, B, n, thresh)


row_stats_rect.launches = 0


def row_stats_full(Z: torch.Tensor, thresh):
    """The full-grid square row stats (the port of ``row_stats_pallas``):
    ``row_stats_rect(Z, Z, ...)``, the same result as ``row_stats`` for
    twice its tile pairs. No pipeline path calls it."""
    return row_stats_rect(Z, Z, thresh)
