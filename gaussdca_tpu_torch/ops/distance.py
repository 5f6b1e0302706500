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
``csrc/row_stats.cu`` (tokens packed 4 to a word, bytewise compare and
popcount, upper-triangle tiles with integer atomics; the source says what
bounds it). On a CPU tensor it runs ``row_stats_torch``, the plain
PyTorch version.
"""

from __future__ import annotations

import ctypes

import torch

from gaussdca_tpu_torch.ops import _build

# the kernel stages 16 words of 4 tokens per step: pad N to a multiple
_TOKEN_ALIGN = 64


def row_stats_torch(Z: torch.Tensor, thresh, *, row_chunk: int = 4096):
    """Plain PyTorch ``row_stats``: a row-chunked one-hot matmul.

    Match counts are sums of 0/1 products, exact in f32 while N < 2^24
    (also under TF32, which represents 0 and 1 exactly); row sums are
    accumulated in f64 so they round once, like the kernel's integer
    sums. Peak memory is the [M, N*q] f32 one-hot plus one
    [row_chunk, M] count block.
    """
    M, N = Z.shape
    rowsum = torch.zeros(M, dtype=torch.float32, device=Z.device)
    below = torch.zeros(M, dtype=torch.float32, device=Z.device)
    if M == 0:
        return rowsum, below
    q = int(Z.max())
    states = torch.arange(1, q + 1, dtype=Z.dtype, device=Z.device)
    E = (Z[:, :, None] == states).reshape(M, N * q).to(torch.float32)
    th = float(thresh)
    for r0 in range(0, M, row_chunk):
        D = E[r0:r0 + row_chunk] @ E.T                  # [chunk, M]
        rowsum[r0:r0 + row_chunk] = D.sum(1, dtype=torch.float64).float()
        below[r0:r0 + row_chunk] = ((N - D) < th).sum(1).float()
    return rowsum, below


def _lib() -> ctypes.CDLL:
    lib = _build.library("row_stats")
    fn = lib.gdca_row_stats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def row_stats(Z: torch.Tensor, thresh):
    """(rowsum [M] f32, below [M] f32) of token matrix Z (uint8 or int8,
    states 0..31). ``thresh``: a Python or 0-d tensor scalar, compared in
    f32 like the TPU kernel. CPU tensors take ``row_stats_torch``; CUDA
    tensors launch the kernel (build and launch errors raise)."""
    if Z.dim() != 2 or Z.dtype not in (torch.uint8, torch.int8):
        raise ValueError(
            f"row_stats: expected a 2-D uint8/int8 token matrix, got "
            f"{Z.dtype} of shape {tuple(Z.shape)}")
    if Z.device.type == "cpu":
        return row_stats_torch(Z, thresh)
    if Z.device.type != "cuda":
        raise ValueError(f"row_stats: unsupported device {Z.device}")
    M, N = Z.shape
    rowsum = torch.zeros(M, dtype=torch.int64, device=Z.device)
    below = torch.zeros(M, dtype=torch.int64, device=Z.device)
    if M == 0:
        return rowsum.float(), below.float()
    Np = max(_TOKEN_ALIGN, -(-N // _TOKEN_ALIGN) * _TOKEN_ALIGN)
    Zp = torch.zeros((M, Np), dtype=torch.uint8, device=Z.device)
    Zp[:, :N] = Z.view(torch.uint8)
    words = Zp.view(torch.int32)                      # [M, Np / 4]
    lib = _lib()
    with torch.cuda.device(Z.device):
        err = lib.gdca_row_stats(
            words.data_ptr(), M, Np // 4, N, float(thresh),
            rowsum.data_ptr(), below.data_ptr(),
            torch.cuda.current_stream(Z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_stats kernel launch failed: CUDA error {err}")
    row_stats.launches += 1
    return rowsum.to(torch.float32), below.to(torch.float32)


row_stats.launches = 0
