"""Per-pair Gaussian DI kernel (hot loop #2) and its plain versions.

``di_pairs(mJ, Lsite, iu, ju, iters)`` computes the DI of every position
pair (iu[p], ju[p]) with the math of
``gaussdca_tpu.score.di._di_pairs_bm_minor``: rho = Li^T J_ij Lj,
G = 4 rho rho^T + I, trace/inf-norm-scaled coupled Newton-Schulz square
root for a fixed number of steps, then 1/2 logdet((I + sqrt G) / 2) by
unpivoted elimination with pivots clamped at 0.1.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/di_pairs.cu`` (register-blocked products: each lane owns a micro-
tile of every s x s product, two pairs a warp at s = 20, s zero-padded to
a multiple of 4; iterates in shared memory; f32 and f64), which takes the
place of both the TPU's Pallas Newton-Schulz kernel ``ns_sqrtm_pallas``
and the XLA core around it; the source says what bounds it. On a CPU
tensor it runs ``di_pairs_torch``.
``ns_sqrtm_torch`` is the plain counterpart of ``ns_sqrtm_pallas``.

``mJ`` may be a row slab ``[rows s, N s]`` of the coupling matrix that
starts at site ``row0`` (the mesh path keeps mJ in per-shard slabs): J_ij
is then read from slab row ``(i - row0) s``, and every ``iu`` must lie in
the slab. ``Lsite`` stays global.
"""

from __future__ import annotations

import ctypes

import torch

from gaussdca_tpu_torch.ops import _build

# Fixed Newton-Schulz step count of the DI core, as
# gaussdca_tpu.score.di.BM_NS_ITERS: with the min(trace, inf-norm) scale
# it covers cond(G) up to ~2.25^(14-6) ~ 660.
BM_NS_ITERS = 14


def _eye(s: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(s, dtype=like.dtype, device=like.device)


def ns_sqrtm_torch(G: torch.Tensor, iters: int = 18):
    """(Y, Z, c): Y ~ sqrt(G/c), Z ~ (G/c)^{-1/2}, c = per-block trace
    [P, 1, 1], by ``iters`` coupled Newton-Schulz steps on a [P, s, s]
    SPD batch — the contract of ``ns_sqrtm_pallas``."""
    s = G.shape[-1]
    eye = _eye(s, G)
    c = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    Y = G / c
    Z = eye.expand_as(G)
    for _ in range(iters):
        T = 1.5 * eye - 0.5 * (Z @ Y)
        Y, Z = Y @ T, T @ Z
    return Y, Z, c


def _di_block(Jb, Li, Lj, iters: int) -> torch.Tensor:
    """DI of a batch of pairs from gathered [P, s, s] blocks."""
    s = Jb.shape[-1]
    eye = _eye(s, Jb)
    rho = Li.transpose(-1, -2) @ (Jb @ Lj)
    G = 4.0 * (rho @ rho.transpose(-1, -2)) + eye
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    inf = G.abs().sum(-1).amax(-1)
    c = torch.minimum(tr, inf)[:, None, None]
    Y = G / c
    if iters >= 1:
        # step 1 has Z = I (its identity products skipped, value-exact)
        T = 1.5 * eye - 0.5 * Y
        Y, Z = Y @ T, T
        for it in range(1, iters):
            T = 1.5 * eye - 0.5 * (Z @ Y)
            Y = Y @ T
            if it < iters - 1:        # the last Z update feeds nothing
                Z = T @ Z
    S = Y * torch.sqrt(c)
    H = 0.5 * (S + eye)
    H = 0.5 * (H + H.transpose(-1, -2))
    acc = torch.zeros(Jb.shape[0], dtype=Jb.dtype, device=Jb.device)
    for k in range(s):
        # clamp keeps an under-converged pair finite; NaN stays NaN
        pivot = torch.clamp(H[:, k, k], min=0.1)
        acc = acc + torch.log(pivot)
        col = H[:, :, k] / pivot[:, None]
        H = H - col[:, :, None] * H[:, k, None, :]
    return 0.5 * acc


def di_pairs_torch(mJ: torch.Tensor, Lsite: torch.Tensor, iu: torch.Tensor,
                   ju: torch.Tensor, iters: int = BM_NS_ITERS, *,
                   row0: int = 0, pair_chunk: int = 65536) -> torch.Tensor:
    """Plain PyTorch ``di_pairs``: batched matmuls over pair chunks,
    gathering each chunk's [chunk, s, s] blocks (memory O(chunk s^2))."""
    N, s, _ = Lsite.shape
    J4 = mJ.reshape(mJ.shape[0] // s, s, N, s)
    P = iu.numel()
    out = torch.empty(P, dtype=mJ.dtype, device=mJ.device)
    for c0 in range(0, P, pair_chunk):
        ii = iu[c0:c0 + pair_chunk]
        jj = ju[c0:c0 + pair_chunk]
        out[c0:c0 + pair_chunk] = _di_block(J4[ii - row0, :, jj, :],
                                            Lsite[ii], Lsite[jj], iters)
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.library("di_pairs")
    for fn in (lib.gdca_di_pairs_f32, lib.gdca_di_pairs_f64):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def di_pairs(mJ: torch.Tensor, Lsite: torch.Tensor, iu: torch.Tensor,
             ju: torch.Tensor, iters: int = BM_NS_ITERS,
             row0: int = 0) -> torch.Tensor:
    """DI [P] of the pairs (iu[p], ju[p]) from the coupling matrix mJ
    [N s, N s], or its row slab [rows s, N s] from site ``row0`` on, and
    the site Cholesky factors Lsite [N, s, s] (s <= 30). CPU tensors take
    ``di_pairs_torch``; CUDA tensors launch the kernel (build and launch
    errors raise)."""
    N, s, s2 = Lsite.shape
    rows = mJ.shape[0] // s if s else 0
    if (s != s2 or mJ.dim() != 2 or mJ.shape != (rows * s, N * s)
            or not 1 <= s <= 30 or rows < 1 or not 0 <= row0 <= N - rows):
        raise ValueError(
            f"di_pairs: shapes mJ {tuple(mJ.shape)}, Lsite "
            f"{tuple(Lsite.shape)}, row0 {row0} (need mJ [rows s, N s] "
            "with row0 + rows <= N, 1 <= s <= 30)")
    if mJ.dtype != Lsite.dtype or mJ.dtype not in (torch.float32,
                                                   torch.float64):
        raise ValueError(f"di_pairs: dtypes {mJ.dtype}, {Lsite.dtype} "
                         "(need one of float32 / float64)")
    if iu.shape != ju.shape or iu.dim() != 1 or iters < 0:
        raise ValueError("di_pairs: iu, ju must be equal-length 1-D "
                         "index vectors and iters >= 0")
    if iu.numel() and not (
            row0 <= int(iu.min()) and int(iu.max()) < row0 + rows
            and 0 <= int(ju.min()) and int(ju.max()) < N):
        raise ValueError(
            f"di_pairs: pair indices out of range (iu in [{row0}, "
            f"{row0 + rows}), ju in [0, {N}) required)")
    if mJ.device.type == "cpu":
        return di_pairs_torch(mJ, Lsite, iu, ju, iters, row0=row0)
    if mJ.device.type != "cuda":
        raise ValueError(f"di_pairs: unsupported device {mJ.device}")
    mJ = mJ.contiguous()
    Lsite = Lsite.contiguous()
    iu = iu.to(device=mJ.device, dtype=torch.int64).contiguous()
    ju = ju.to(device=mJ.device, dtype=torch.int64).contiguous()
    if Lsite.device != mJ.device:
        raise ValueError("di_pairs: mJ and Lsite must share a device")
    P = iu.numel()
    out = torch.empty(P, dtype=mJ.dtype, device=mJ.device)
    if P == 0:
        return out
    lib = _lib()
    fn = (lib.gdca_di_pairs_f32 if mJ.dtype == torch.float32
          else lib.gdca_di_pairs_f64)
    with torch.cuda.device(mJ.device):
        err = fn(mJ.data_ptr(), Lsite.data_ptr(), iu.data_ptr(),
                 ju.data_ptr(), out.data_ptr(), P, s, N * s, row0, iters,
                 torch.cuda.current_stream(mJ.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"di_pairs kernel launch failed: CUDA error {err}")
    di_pairs.launches += 1
    return out


di_pairs.launches = 0
