"""All-pairs sequence-identity row statistics (hot loop #1).

``row_stats(Z, thresh, q=21) -> (rowsum, below)`` is the contract of
``gaussdca_tpu.ops.distance.row_stats_sym_pallas``: for every row a of the
token matrix Z [M, N],

    rowsum[a] = sum_b matches(a, b)
    below[a]  = #{b : N - matches(a, b) < thresh}

over all b, b = a included, where ``matches`` counts the columns on which
two rows carry the same token in 1..q (token 0 is padding and matches
nothing, itself included; as in the JAX kernel, a token above q matches
nothing either). The [M, M] match matrix never exists.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
A, ``csrc/row_stats.cu`` (int8 ``wgmma`` over one-hot operands built
on chip from packed token words, upper-triangle tiles with integer
atomics; the source says what bounds it). On a CPU tensor it runs
``row_stats_torch``, the plain PyTorch version.

``row_stats_rect(ZA, ZB, thresh, q=q)`` is the contract of
``row_stats_rect_pallas``: the same statistics for A's rows against all of
B's rows, the per-shard reweighting of the mesh path. On a CUDA tensor it
launches kernel C, ``csrc/row_stats_rect.cu`` (kernel A's tensor-core tile,
``csrc/onehot_wgmma.cuh``, over the full rectangular tile grid); on a CPU
tensor it runs ``row_stats_rect_torch``. ``row_stats_full(Z, t, q)`` is
``row_stats_rect(Z, Z, t, q=q)``, the port of the full-grid
``row_stats_pallas``.

Three more kernels port the JAX package's other distance kernels:

- ``match_counts(Z, q)``: the dense [M, M] int32 identity counts of
  ``match_counts_pallas`` (kernel D, ``csrc/match_counts.cu``: kernel A's
  tile over the upper triangle, each tile written at its place and
  transposed); plain version ``match_counts_torch``.
- ``row_stats_asym(Z, thresh, q)``: ``row_stats`` by the grouped-row
  covering of ``row_stats_asym_pallas`` (kernel E,
  ``csrc/row_stats_asym.cu``: two resident 128-row tiles a block share
  each expansion of a B tile, behind a producer warpgroup and an mbarrier
  ring; ``plan_asym`` checks the resident words fit shared memory, and a
  width with no plan takes ``row_stats``); plain version
  ``row_stats_asym_torch``, which walks the same covering.
- ``row_stats_sym_e8(Z, thresh, q)``: ``row_stats`` from one-hot planes
  (``one_hot_planes``) on the int8 tensor cores, the port of
  ``row_stats_sym_e8_pallas`` (kernel F, ``csrc/row_stats_e8.cu``: TMA
  loads into swizzled shared stages, ``wgmma`` with both operands from
  shared memory, persistent blocks over a grouped tile order); plain
  version ``row_stats_e8_torch`` on the same planes.
"""

from __future__ import annotations

import ctypes

import torch

from gaussdca_tpu_torch.ops import _build

# packed rows of 16 words (64 tokens): a multiple of the 8-word chunk of
# kernels A, C, D and E, and 16-byte aligned
# rows, so a row slice of packed words is aligned too
_TOKEN_ALIGN = 64
# shared memory a block may use on an H100 (dynamic and static)
_SMEM_PER_BLOCK = 232448
# kernel E: fine tiles of 128 rows, k = 2 of them resident a block, a ring
# of 6 stages of expanded B operands, 3 states of 4 KB a stage; its fixed
# bytes: the alignment slack of the dynamic base, the column partials and
# the barriers
_ASYM_TILE = 128
_ASYM_K = 2
_ASYM_STAGES = 6
_ASYM_STAGE_BYTES = 3 * 4096
_ASYM_SMEM_FIXED = 128 + 2 * 128 * 4 + 2 * 8 * 6
# the planes' K is padded to a multiple of 64 bytes (kernel F's TMA rows
# need a multiple of 16; its 128-byte stages zero-fill past K)
_E8_DEPTH = 64
# kernels A, C and D sum 2^14 a match in int32: fewer columns than 2^17
_TC_MAX_WIDTH = 1 << 17


def row_stats_rect_torch(ZA: torch.Tensor, ZB: torch.Tensor, thresh,
                         n_true=None, *, q: int = 31, row_chunk: int = 4096):
    """Plain PyTorch ``row_stats_rect``: a row-chunked one-hot matmul of
    A's rows against B's over states 1..q (tokens above q match nothing).

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
    EB = _one_hot(ZB, q, torch.float32)
    th = float(thresh)
    for r0 in range(0, Ma, row_chunk):
        D = _one_hot(ZA[r0:r0 + row_chunk], q, torch.float32) @ EB.T
        rowsum[r0:r0 + row_chunk] = D.sum(1, dtype=torch.float64).float()
        below[r0:r0 + row_chunk] = ((n - D) < th).sum(1).float()
    return rowsum, below


def row_stats_torch(Z: torch.Tensor, thresh, q: int = 21, *,
                    row_chunk: int = 4096):
    """Plain PyTorch ``row_stats`` over states 1..q:
    ``row_stats_rect_torch(Z, Z, ..., q=q)``."""
    return row_stats_rect_torch(Z, Z, thresh, q=q, row_chunk=row_chunk)


def _check_tokens(fn: str, *Zs: torch.Tensor) -> None:
    for Z in Zs:
        if Z.dim() != 2 or Z.dtype not in (torch.uint8, torch.int8):
            raise ValueError(
                f"{fn}: expected a 2-D uint8/int8 token matrix, got "
                f"{Z.dtype} of shape {tuple(Z.shape)}")
        if Z.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{fn}: unsupported device {Z.device}")


def _check_states(fn: str, q: int) -> None:
    if not 1 <= q <= 31:
        raise ValueError(f"{fn}: q must be in 1..31, got {q}")


def _check_width(fn: str, N: int) -> None:
    if N >= _TC_MAX_WIDTH:
        raise ValueError(f"{fn}: N = {N} columns, the kernel counts "
                         f"fewer than {_TC_MAX_WIDTH}")


def pack_tokens(Z: torch.Tensor, q: int = 31) -> torch.Tensor:
    """The kernels' input layout: tokens [M, N] -> int32 words [M, Np / 4],
    4 tokens a word, N zero-padded to a multiple of 64 (padding never
    matches), tokens above q zeroed (they match nothing; the byte compare
    of kernels A, C and D takes tokens 0..q only). A row block of Z packs
    to the same row block of words."""
    M, N = Z.shape
    Np = max(_TOKEN_ALIGN, -(-N // _TOKEN_ALIGN) * _TOKEN_ALIGN)
    Zp = torch.zeros((M, Np), dtype=torch.uint8, device=Z.device)
    Zp[:, :N] = Z.view(torch.uint8)
    Zp.masked_fill_(Zp > q, 0)
    return Zp.view(torch.int32)


def _lib(name: str, fn_name: str, argtypes) -> ctypes.CDLL:
    lib = _build.library(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def row_stats(Z: torch.Tensor, thresh, q: int = 21):
    """(rowsum [M] f32, below [M] f32) of token matrix Z (uint8 or int8,
    states 0..31) over states 1..q (1 <= q <= 31; tokens above q match
    nothing). ``thresh``: a Python or 0-d tensor scalar, compared in f32
    like the TPU kernel. CPU tensors take ``row_stats_torch``; CUDA
    tensors launch kernel A (build and launch errors raise)."""
    _check_tokens("row_stats", Z)
    _check_states("row_stats", q)
    if Z.device.type == "cpu":
        return row_stats_torch(Z, thresh, q)
    M, N = Z.shape
    _check_width("row_stats", N)
    rowsum = torch.zeros(M, dtype=torch.int64, device=Z.device)
    below = torch.zeros(M, dtype=torch.int64, device=Z.device)
    if M == 0:
        return rowsum.float(), below.float()
    words = pack_tokens(Z, q)
    fn = _lib("row_stats", "gdca_row_stats",
              [_P, _I, _I, _I, _F, _I, _P, _P, _P])
    with torch.cuda.device(Z.device):
        err = fn(words.data_ptr(), M, words.shape[1], N, float(thresh), q,
                 rowsum.data_ptr(), below.data_ptr(),
                 torch.cuda.current_stream(Z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_stats kernel launch failed: CUDA error {err}")
    row_stats.launches += 1
    return rowsum.to(torch.float32), below.to(torch.float32)


row_stats.launches = 0


def row_stats_rect_packed(A: torch.Tensor, B: torch.Tensor, n_true: int,
                          thresh, q: int = 31):
    """``row_stats_rect`` on packed words (``pack_tokens(Z, q)``) on one
    CUDA device: the mesh path packs the tokens once per device and passes
    each shard's row block as a slice of them (a row slice of packed words
    keeps kernel C's 16-byte alignment: a packed row is a multiple of 64
    bytes)."""
    if (A.dtype != torch.int32 or B.dtype != torch.int32 or A.dim() != 2
            or B.dim() != 2 or A.shape[1] != B.shape[1]):
        raise ValueError("row_stats_rect_packed: expected int32 words "
                         f"[Ma, W], [Mb, W]; got {A.dtype} {tuple(A.shape)}, "
                         f"{B.dtype} {tuple(B.shape)}")
    if A.device.type != "cuda" or B.device != A.device:
        raise ValueError("row_stats_rect_packed: A and B must lie on one "
                         f"CUDA device, got {A.device} and {B.device}")
    _check_states("row_stats_rect", q)
    _check_width("row_stats_rect", int(n_true))
    A, B = A.contiguous(), B.contiguous()
    if B.data_ptr() % 16:
        raise ValueError("row_stats_rect_packed: B's words must be 16-byte "
                         "aligned")
    Ma, Mb = A.shape[0], B.shape[0]
    rowsum = torch.zeros(Ma, dtype=torch.int64, device=A.device)
    below = torch.zeros(Ma, dtype=torch.int64, device=A.device)
    if Ma and Mb:
        fn = _lib("row_stats_rect", "gdca_row_stats_rect",
                  [_P, _I, _P, _I, _I, _I, _F, _I, _P, _P, _P])
        with torch.cuda.device(A.device):
            err = fn(A.data_ptr(), Ma, B.data_ptr(), Mb, A.shape[1],
                     int(n_true), float(thresh), q, rowsum.data_ptr(),
                     below.data_ptr(),
                     torch.cuda.current_stream(A.device).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"row_stats_rect kernel launch failed: CUDA error {err}")
        row_stats_rect.launches += 1
    return rowsum.to(torch.float32), below.to(torch.float32)


def row_stats_rect(ZA: torch.Tensor, ZB: torch.Tensor, thresh,
                   n_true=None, *, q: int = 31):
    """(rowsum [Ma] f32, below [Ma] f32) of A's rows against all of B's
    over states 1..q (1 <= q <= 31; tokens above q match nothing):
    ``rowsum[a] = sum_b matches(a, b)``, ``below[a] = #{b : n_true -
    matches(a, b) < thresh}`` (``n_true`` defaults to N). CPU tensors take
    ``row_stats_rect_torch``; CUDA tensors launch kernel C (build and
    launch errors raise)."""
    _check_tokens("row_stats_rect", ZA, ZB)
    if ZA.shape[1] != ZB.shape[1] or ZA.device != ZB.device:
        raise ValueError(
            f"row_stats_rect: ZA {tuple(ZA.shape)} on {ZA.device} and ZB "
            f"{tuple(ZB.shape)} on {ZB.device} need one width and device")
    _check_states("row_stats_rect", q)
    n = ZA.shape[1] if n_true is None else int(n_true)
    if ZA.device.type == "cpu":
        return row_stats_rect_torch(ZA, ZB, thresh, n, q=q)
    _check_width("row_stats_rect", ZA.shape[1])
    B = pack_tokens(ZB, q)
    A = B if ZA is ZB else pack_tokens(ZA, q)
    return row_stats_rect_packed(A, B, n, thresh, q)


row_stats_rect.launches = 0


def row_stats_full(Z: torch.Tensor, thresh, q: int = 31):
    """The full-grid square row stats over states 1..q (the port of
    ``row_stats_pallas``): ``row_stats_rect(Z, Z, ..., q=q)``, the same
    result as ``row_stats(Z, thresh, q)`` for twice its tile pairs. No
    pipeline path calls it: a caller passes it as ``row_stats_fn``."""
    return row_stats_rect(Z, Z, thresh, q=q)


def _one_hot(Z: torch.Tensor, q: int, dtype) -> torch.Tensor:
    """[M, N q] one-hot over states 1..q, position-major (column n q + c
    - 1 is state c at position n); token 0 gives a zero segment."""
    M, N = Z.shape
    states = torch.arange(1, q + 1, dtype=torch.uint8, device=Z.device)
    return (Z.view(torch.uint8)[:, :, None] == states).reshape(
        M, N * q).to(dtype)


# --- kernel D: dense identity counts ------------------------------------

def match_counts_torch(Z: torch.Tensor, q: int = 31, *,
                       row_chunk: int = 4096) -> torch.Tensor:
    """Plain PyTorch ``match_counts``: a row-chunked one-hot f32 product
    over states 1..q, exact (0/1 products summed in f32 while N < 2^24)."""
    M = Z.shape[0]
    out = torch.empty((M, M), dtype=torch.int32, device=Z.device)
    if M == 0:
        return out
    E = _one_hot(Z, q, torch.float32)
    for r0 in range(0, M, row_chunk):
        out[r0:r0 + row_chunk] = (E[r0:r0 + row_chunk] @ E.T).to(torch.int32)
    return out


def match_counts(Z: torch.Tensor, q: int = 31) -> torch.Tensor:
    """[M, M] int32: ``out[a, b] = matches(a, b)`` of token matrix Z
    (uint8 or int8, states 0..31; token 0 matches nothing) over states
    1..q (1 <= q <= 31; tokens above q match nothing). CPU tensors take
    ``match_counts_torch``; CUDA tensors launch kernel D (build and launch
    errors raise)."""
    _check_tokens("match_counts", Z)
    _check_states("match_counts", q)
    if Z.device.type == "cpu":
        return match_counts_torch(Z, q)
    M, N = Z.shape
    _check_width("match_counts", N)
    out = torch.empty((M, M), dtype=torch.int32, device=Z.device)
    if M == 0:
        return out
    words = pack_tokens(Z, q)
    fn = _lib("match_counts", "gdca_match_counts", [_P, _I, _I, _I, _P, _P])
    with torch.cuda.device(Z.device):
        err = fn(words.data_ptr(), M, words.shape[1], q, out.data_ptr(),
                 torch.cuda.current_stream(Z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"match_counts kernel launch failed: CUDA error {err}")
    match_counts.launches += 1
    return out


match_counts.launches = 0


# --- kernel E: grouped-row row statistics --------------------------------

def _asym_stride(W: int) -> int:
    """Kernel E's row stride of the resident words: W padded to 4 mod 32
    words, so a warp's fragment reads hit 32 banks."""
    return W + (4 - W) % 32


def plan_asym(N: int) -> int:
    """Kernel E's group size k for token width N: 2 (two resident 128-row
    tiles, one consumer warpgroup each, as many as the registers hold)
    when their packed words and the ring of B stages fit a block's shared
    memory, else 1 (no plan: ``row_stats_asym`` takes ``row_stats``), as
    ``_plan_asym`` plans against VMEM."""
    W = max(_TOKEN_ALIGN, -(-N // _TOKEN_ALIGN) * _TOKEN_ALIGN) // 4
    need = (_ASYM_K * _ASYM_TILE * _asym_stride(W) * 4
            + _ASYM_STAGES * _ASYM_STAGE_BYTES + _ASYM_SMEM_FIXED)
    return _ASYM_K if need <= _SMEM_PER_BLOCK else 1


def _asym_cover(M: int, k: int, tile: int):
    """(T, J): fine tiles of the padded rows (a multiple of k) and window
    steps of the grouped covering."""
    T = -(-M // (k * tile)) * k
    return T, T // 2 + k


def plan_asym_chunks(M: int, sms: int, k: int = _ASYM_K,
                     tile: int = _ASYM_TILE) -> int:
    """How many blocks share one group's window of J steps (gridDim.y):
    the fewest that minimise waves x steps a block, with one block an SM
    (kernel E's shared memory and registers)."""
    T, J = _asym_cover(M, k, tile)
    G = T // k
    cost = lambda c: -(-G * c // sms) * -(-J // c)      # noqa: E731
    return min(range(1, J + 1), key=lambda c: (cost(c), c))


def row_stats_asym_torch(Z: torch.Tensor, thresh, k: int, q: int = 31, *,
                         tile: int = _ASYM_TILE):
    """Plain PyTorch ``row_stats_asym`` over states 1..q (tokens above q
    match nothing): kernel E's covering walked step by step. Group g holds
    fine tiles alpha = g k + r; step jp pairs them with tile beta = (g k +
    jp) mod T, and sub-tile r counts the pair iff d = jp - r is in [0, T //
    2] (d = T / 2 for even T only when alpha < T / 2): every unordered tile
    pair once, the diagonal toward its rows only. Each step is one batched
    one-hot f32 product over the groups; sums in f64, so the counts are
    exact."""
    M, N = Z.shape
    if M == 0:
        return (torch.zeros(0, dtype=torch.float32, device=Z.device),) * 2
    dev = Z.device
    T, J = _asym_cover(M, k, tile)
    G, Mp = T // k, T * tile
    Zp = torch.zeros((Mp, N), dtype=torch.uint8, device=dev)
    Zp[:M] = Z.view(torch.uint8)
    E = _one_hot(Zp, q, torch.float32)
    EA = E.view(G, k * tile, -1)
    EB = E.view(T, tile, -1)
    valid = torch.arange(Mp, device=dev) < M
    rs = torch.zeros(Mp, dtype=torch.float64, device=dev)
    bl = torch.zeros(Mp, dtype=torch.float64, device=dev)
    gk = torch.arange(G, device=dev) * k
    r = torch.arange(k, device=dev)
    alpha = gk[:, None] + r                                     # [G, k]
    rows_ok = valid.view(G, k * tile)
    th = float(thresh)
    for jp in range(J):
        d = jp - r
        live = ((d >= 0) & (d <= T // 2))[None, :] & ~(
            (2 * d == T)[None, :] & (alpha >= T // 2))          # [G, k]
        if not bool(live.any()):
            continue
        beta = (gk + jp) % T
        D = EA @ EB[beta].transpose(1, 2)                       # [G, k t, t]
        cols = beta[:, None] * tile + torch.arange(tile, device=dev)
        mask = ((live.repeat_interleave(tile, 1) & rows_ok)[:, :, None]
                & valid[cols][:, None, :])
        near = ((N - D) < th) & mask
        Dm = D * mask
        rs += Dm.sum(2, dtype=torch.float64).view(-1)
        bl += near.sum(2, dtype=torch.float64).view(-1)
        col = (live & (d != 0)[None, :]).repeat_interleave(tile, 1)
        rs.index_add_(0, cols.reshape(-1),
                      (Dm * col[:, :, None]).sum(1, dtype=torch.float64)
                      .reshape(-1))
        bl.index_add_(0, cols.reshape(-1),
                      (near & col[:, :, None]).sum(1, dtype=torch.float64)
                      .reshape(-1))
    return rs[:M].float(), bl[:M].float()


def row_stats_asym(Z: torch.Tensor, thresh, q: int = 31):
    """``row_stats(Z, thresh, q)`` by kernel E's grouped-row covering: the
    same (rowsum, below) over states 1..q (1 <= q <= 31; tokens above q
    match nothing). A width with no plan (``plan_asym`` gives 1) takes
    ``row_stats(Z, thresh, q)`` (kernel A on a card, counted there). CPU
    tensors take ``row_stats_asym_torch``; CUDA tensors launch kernel E
    (build and launch errors raise)."""
    _check_tokens("row_stats_asym", Z)
    _check_states("row_stats_asym", q)
    M, N = Z.shape
    k = plan_asym(N)
    if k < 2:
        return row_stats(Z, thresh, q=q)
    if Z.device.type == "cpu":
        return row_stats_asym_torch(Z, thresh, k, q)
    _check_width("row_stats_asym", N)
    rowsum = torch.zeros(M, dtype=torch.int64, device=Z.device)
    below = torch.zeros(M, dtype=torch.int64, device=Z.device)
    if M == 0:
        return rowsum.float(), below.float()
    words = pack_tokens(Z, q)
    sms = torch.cuda.get_device_properties(Z.device).multi_processor_count
    fn = _lib("row_stats_asym", "gdca_row_stats_asym",
              [_P, _I, _I, _I, _F, _I, _I, _P, _P, _P])
    with torch.cuda.device(Z.device):
        err = fn(words.data_ptr(), M, words.shape[1], N, float(thresh), q,
                 plan_asym_chunks(M, sms, k), rowsum.data_ptr(),
                 below.data_ptr(),
                 torch.cuda.current_stream(Z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"row_stats_asym kernel launch failed: CUDA error {err}")
    row_stats_asym.launches += 1
    return rowsum.to(torch.float32), below.to(torch.float32)


row_stats_asym.launches = 0


# --- kernel F: row statistics from one-hot planes ------------------------

def one_hot_planes(Z: torch.Tensor, q: int) -> torch.Tensor:
    """E8 [M, K] int8 on Z's device: E8[a, n q + c - 1] = 1 iff Z[a, n] =
    c (c = 1..q, position-major; token 0 gives a zero segment), K = N q
    zero-padded to a multiple of 64 (``_E8_DEPTH``)."""
    M, N = Z.shape
    K = N * q
    Kp = max(_E8_DEPTH, -(-K // _E8_DEPTH) * _E8_DEPTH)
    E8 = torch.zeros((M, Kp), dtype=torch.int8, device=Z.device)
    E8[:, :K] = _one_hot(Z, q, torch.int8)
    return E8


def row_stats_e8_torch(E8: torch.Tensor, n_true: int, thresh, *,
                       row_chunk: int = 4096):
    """Plain PyTorch ``row_stats_e8``: row-chunked f32 products of the
    planes; exact, as ``row_stats_rect_torch``."""
    M = E8.shape[0]
    rowsum = torch.zeros(M, dtype=torch.float32, device=E8.device)
    below = torch.zeros(M, dtype=torch.float32, device=E8.device)
    Ef = E8.to(torch.float32)
    th = float(thresh)
    for r0 in range(0, M, row_chunk):
        D = Ef[r0:r0 + row_chunk] @ Ef.T
        rowsum[r0:r0 + row_chunk] = D.sum(1, dtype=torch.float64).float()
        below[r0:r0 + row_chunk] = ((n_true - D) < th).sum(1).float()
    return rowsum, below


def row_stats_e8(E8: torch.Tensor, n_true: int, thresh):
    """(rowsum [M], below [M]) f32 from one-hot planes E8 [M, K] int8
    (``one_hot_planes``) over token width ``n_true``. CPU tensors take
    ``row_stats_e8_torch``; CUDA tensors launch kernel F (build and launch
    errors raise; counted on ``row_stats_sym_e8``)."""
    if (E8.dim() != 2 or E8.dtype != torch.int8
            or E8.shape[1] % _E8_DEPTH != 0 or E8.shape[1] == 0):
        raise ValueError(
            "row_stats_e8: expected int8 planes [M, K] with K a positive "
            f"multiple of {_E8_DEPTH}, got {E8.dtype} {tuple(E8.shape)}")
    if E8.device.type == "cpu":
        return row_stats_e8_torch(E8, n_true, thresh)
    if E8.device.type != "cuda":
        raise ValueError(f"row_stats_e8: unsupported device {E8.device}")
    E8 = E8.contiguous()
    M, K = E8.shape
    rowsum = torch.zeros(M, dtype=torch.int64, device=E8.device)
    below = torch.zeros(M, dtype=torch.int64, device=E8.device)
    if M:
        fn = _lib("row_stats_e8", "gdca_row_stats_e8",
                  [_P, _I, _I, _I, _F, _P, _P, _P])
        with torch.cuda.device(E8.device):
            err = fn(E8.data_ptr(), M, K, int(n_true), float(thresh),
                     rowsum.data_ptr(), below.data_ptr(),
                     torch.cuda.current_stream(E8.device).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"row_stats_e8 kernel launch failed: CUDA error {err}")
        row_stats_sym_e8.launches += 1
    return rowsum.to(torch.float32), below.to(torch.float32)


def row_stats_sym_e8(Z: torch.Tensor, thresh, q: int):
    """``row_stats`` from the one-hot planes of Z over states 1..q (tokens
    above q match nothing, as in ``row_stats_sym_e8_pallas``): the port
    of that kernel, which no pipeline path calls."""
    _check_tokens("row_stats_sym_e8", Z)
    return row_stats_e8(one_hot_planes(Z, q), Z.shape[1], thresh)


row_stats_sym_e8.launches = 0
