"""Multi-device gDCA pipeline over a ``Mesh``, in one process or a pod.

The port of ``gaussdca_tpu.parallel.sharded``; shard d is the d-th shard
of the mesh in row-major order, and devices may repeat (several shards on
one card). Each process runs its own shards (all of them with one
process) and meets the others in the mesh's collectives
(``parallel.mesh``), so one implementation serves both cases:

- reweighting is data-parallel: shard d holds its row block of the
  tokens and runs ``row_stats_rect`` (kernel C on a card) of its rows
  against all rows; the tokens are packed once per device and shared by
  the shards there. Only O(M) row statistics are all-gathered, on each
  process's home device, for the weights;
- weighted frequencies are summed per process from its shards' rows and
  weights, each partial split into the row slabs of the statistical
  dimension Ns = N s as it is summed and then freed, and every slab
  reduced to its owner (a reduce-scatter), so Pij and C only ever exist
  as per-shard row slabs;
- below ``cfg.solve_min_dim`` the covariance is all-gathered and
  inverted once (``spd_inverse``; on process 0, then broadcast), and mJ
  is copied to each distinct device; at or above it the solve is
  storage-sharded (``solve.distributed``) and mJ stays in row slabs;
- scores: frob rows are computed per site-aligned slab of mJ; DI pairs
  are split over the shards (one ``di_pairs`` launch each) against the
  replicated mJ, or, storage-sharded, anchored at the shard that holds
  one endpoint's rows (``_pair_assignment``) and read from that slab
  (kernel B's ``row0``). S is all-gathered, so APC and the ranking run on
  the same S on every process.

The JAX package's opt-in ``_di_sharded_tiled`` (``GDCA_DI_SHARDED=tiled``)
exists for the TPU's 128-lane layout and is not ported: kernel B already
reads each block by index.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.core.runtime import full_f32_matmuls
from gaussdca_tpu_torch.ops import di_kernel, distance
from gaussdca_tpu_torch.parallel.mesh import Mesh, all_gather, \
    all_to_all, on_first, psum, reduce_scatter, replicate
from gaussdca_tpu_torch.score.apc import correct_apc
from gaussdca_tpu_torch.score.di import ns_iters
from gaussdca_tpu_torch.score.frob import frob_rows
from gaussdca_tpu_torch.solve.cholesky import solve_steps, spd_inverse
from gaussdca_tpu_torch.solve.distributed import pad_slab, plan_padding, \
    spd_inverse_dist
from gaussdca_tpu_torch.stats import reweight
from gaussdca_tpu_torch.stats.frequencies import (accumulate_frequencies,
                                                   frequency_chunk)
from gaussdca_tpu_torch.stats.pseudocount import add_pseudocount, compute_C
from gaussdca_tpu_torch.utils.log import dtype_name, span

Bounds = List[Tuple[int, int]]


def _even_bounds(n: int, ndev: int, per: int) -> Bounds:
    """Shard d's rows [d per, (d + 1) per) clipped to n."""
    return [(min(d * per, n), min((d + 1) * per, n)) for d in range(ndev)]


def _row_stats_sharded(mesh: Mesh, Z_on: dict, m_loc: int) -> Callable:
    """``fn(Z, thresh, q) -> (rowsum, below)`` over all rows and states
    1..q, on the home device of every process: each of this process's
    shards computes its row block against all rows, and the O(M)
    statistics are all-gathered. On a card each call packs the tokens
    once per device (``pack_tokens``, tokens above q zeroed) and each
    shard's block is a slice of them."""
    N = Z_on[mesh.home].shape[1]
    cuda = mesh.home.type == "cuda"

    def fn(Z: torch.Tensor, thresh, q: int):
        if Z.shape != Z_on[mesh.home].shape:
            raise ValueError("sharded row stats: unexpected token matrix")
        words = {dev: distance.pack_tokens(Zd, q)
                 for dev, Zd in Z_on.items()} if cuda else None
        parts = []
        for d, dev in zip(mesh.shards, mesh.flat):
            rows = slice(d * m_loc, (d + 1) * m_loc)
            if cuda:
                parts.append(distance.row_stats_rect_packed(
                    words[dev][rows], words[dev], N, thresh, q))
            else:
                parts.append(distance.row_stats_rect(
                    Z_on[dev][rows], Z_on[dev], thresh, q=q))
        return tuple(all_gather([p[k] for p in parts], mesh.home, mesh)
                     for k in range(2))
    return fn


def _site_blocks(C: torch.Tensor, row0: int, s: int) -> torch.Tensor:
    """[r, s]: each row of the slab C [r, Ns] (global rows row0..) on the
    columns of its own site, i.e. that row of its diagonal site block."""
    g = torch.arange(row0, row0 + C.shape[0], device=C.device)
    cols = (g // s)[:, None] * s + torch.arange(s, device=C.device)
    return C.gather(1, cols)


def _reslab(X: Sequence[torch.Tensor], w: int, bounds: Bounds, mesh: Mesh,
            ncols: int) -> List[torch.Tensor]:
    """Rows ``bounds[d]`` (columns :ncols) of the matrix held as slabs of
    w rows, for each of this process's shards d on its device: from the
    solve's row slabs to the site-aligned slabs the scores read (an
    all-to-all of the overlapping pieces)."""
    def piece(x, k, g0, g1):
        lo, hi = max(g0, k * w), min(g1, (k + 1) * w)
        return x[lo - k * w:hi - k * w, :ncols] if lo < hi else x[:0, :ncols]

    recv = all_to_all([[piece(x, k, g0, g1) for g0, g1 in bounds]
                       for k, x in zip(mesh.shards, X)], mesh)
    return [torch.cat([p for p in pieces if p.shape[0]] or [pieces[0]])
            for pieces in recv]


def _pair_assignment(N: int, ndev: int):
    """Pair -> shard for the slab-local DI: a pair is scored by the shard
    whose site slab holds its anchor, i when (i + j) is even, else j (near
    uniform). Returns nloc (sites a shard) and per shard (anchor, other,
    i, j) index arrays. A pair anchored at j is scored as (j, i): DI is
    invariant under that swap (rho -> rho^T leaves the spectrum of
    rho rho^T, hence the value, unchanged up to rounding)."""
    nloc = -(-N // ndev)
    iu, ju = np.triu_indices(N, k=1)
    use_i = ((iu + ju) % 2) == 0
    anchor = np.where(use_i, iu, ju)
    other = np.where(use_i, ju, iu)
    owner = anchor // nloc
    return nloc, [(anchor[owner == d], other[owner == d], iu[owner == d],
                   ju[owner == d]) for d in range(ndev)]


def _di_replicated(mesh: Mesh, mJ: List[torch.Tensor],
                   Ls: List[torch.Tensor], N: int) -> torch.Tensor:
    """DI with the pair batch split over the shards, each against its
    device's copy of mJ; S on every process."""
    iu, ju = np.triu_indices(N, k=1)
    chunks = np.array_split(np.arange(iu.size), mesh.size)
    iters = ns_iters(mJ[0].dtype, -(-iu.size // mesh.size))
    di = [di_kernel.di_pairs(mJ[k], Ls[k],
                             torch.as_tensor(iu[chunks[d]], device=dev),
                             torch.as_tensor(ju[chunks[d]], device=dev),
                             iters)
          for k, (d, dev) in enumerate(zip(mesh.shards, mesh.flat))]
    di = all_gather(di, mesh.home, mesh)
    iu, ju = (torch.as_tensor(x, device=mesh.home) for x in (iu, ju))
    S = torch.zeros((N, N), dtype=di.dtype, device=mesh.home)
    S[iu, ju] = di
    S[ju, iu] = di
    return S


def _di_local(mesh: Mesh, J: List[torch.Tensor], Ls: List[torch.Tensor],
              N: int) -> torch.Tensor:
    """DI with mJ kept in site-aligned row slabs: every pair is read from
    the slab of its anchor (``_pair_assignment``); S on every process."""
    nloc, assign = _pair_assignment(N, mesh.size)
    iters = ns_iters(J[0].dtype, -(-(N * (N - 1) // 2) // mesh.size))
    di = []
    for k, (d, dev) in enumerate(zip(mesh.shards, mesh.flat)):
        a, o, _, _ = assign[d]
        di.append(di_kernel.di_pairs(
            J[k], Ls[k], torch.as_tensor(a, device=dev),
            torch.as_tensor(o, device=dev), iters, row0=d * nloc)
            if a.size else J[k].new_zeros(0))
    oi, oj = (torch.as_tensor(np.concatenate([x[k] for x in assign]),
                              device=mesh.home) for k in (2, 3))
    S = torch.zeros((N, N), dtype=J[0].dtype, device=mesh.home)
    S[oi, oj] = all_gather(di, mesh.home, mesh)
    return S + S.T


def sharded_scores(mesh: Mesh, Z: torch.Tensor, cfg: GDCAConfig, q: int,
                   m_true: Optional[int] = None):
    """Tokens Z [M, N] (M a multiple of the shard count; rows at or past
    ``m_true`` are token-0 padding; the whole matrix on every process) ->
    (S [N, N] APC-corrected on the mesh's home device, resolved theta,
    Meff), the same on every process. ``cfg.device`` is not read: the
    mesh's devices are where it runs. The stages are the spans of
    ``api.scores_pipeline``, after "upload"; their device times are those
    of the home device."""
    dtype = cfg.resolve_dtype()
    dt = dtype_name(dtype)
    devs, home, ndev = mesh.flat, mesh.home, mesh.size
    M, N = Z.shape
    if M % ndev:
        raise ValueError(f"sharded_scores: M={M} is not a multiple of the "
                         f"{ndev} shards (pad with token-0 rows)")
    m_loc = M // ndev
    s = q - 1
    Ns = N * s
    with span("upload", home):
        Z_on = {dev: Z.to(dev) for dev in mesh.distinct}

    # --- reweighting: shard rows vs all rows, O(M) statistics -----------
    theta = "auto" if cfg.auto_theta else float(cfg.theta)
    with span("reweight", home, M=M, N=N, q=q):
        W, Meff, th = reweight.compute_weights_streaming(
            Z_on[home], theta, q, dtype=dtype, m_true=m_true,
            row_stats_fn=_row_stats_sharded(mesh, Z_on, m_loc))

    # --- frequencies: per-shard partials, summed into row slabs ---------
    # every process sums its shards' partials into one slab per global
    # shard (its own shards' on their devices, the others' on home), then
    # each slab is reduced to its owner
    npad, w, _ = plan_padding(Ns, ndev, min(cfg.solve_block, Ns))
    rows = _even_bounds(Ns, ndev, w)
    m_chunk = frequency_chunk(m_loc, N, q, dtype)
    with span("frequencies", home, M=M, N=N, q=q, dtype=dt):
        pis = []
        Pij = [torch.zeros((r1 - r0, Ns), dtype=dtype,
                           device=devs[d - mesh.shards.start]
                           if mesh.is_local(d) else home)
               for d, (r0, r1) in enumerate(rows)]
        for src, dev in zip(mesh.shards, devs):
            loc = slice(src * m_loc, (src + 1) * m_loc)
            p_pi, p_pij = accumulate_frequencies(
                Z_on[dev][loc], W[loc].to(dev), q, dtype=dtype,
                m_chunk=m_chunk)
            pis.append(p_pi)
            for (r0, r1), slab in zip(rows, Pij):
                slab += p_pij[r0:r1].to(slab.device)
            del p_pij   # each partial is a full [Ns, Ns]: drop it once summed
        Pij = reduce_scatter(Pij, mesh)
        Pi_t = psum(pis, home, mesh) / Meff
    with span("covariance", home):
        C = []
        for k, (d, dev) in enumerate(zip(mesh.shards, devs)):
            r0 = rows[d][0]
            Pi, slab = add_pseudocount(Pi_t, Pij[k] / Meff.to(dev),
                                       cfg.pseudocount, q, row0=r0)
            Pij[k] = None
            C.append(compute_C(Pi, slab, row0=r0))
            del slab
        Lsite = None
        if cfg.score == "DI":
            # site Cholesky factors [N, s, s]: tiny, replicated
            Lsite = torch.linalg.cholesky(all_gather(
                [_site_blocks(c, rows[d][0], s)
                 for c, d in zip(C, mesh.shards)], home, mesh).reshape(
                     N, s, s))

    # --- solve: replicated below the threshold, storage-sharded above ---
    sites = _even_bounds(N, ndev, -(-N // ndev))
    site_rows = [(a * s, b * s) for a, b in sites]
    storage_sharded = Ns >= cfg.solve_min_dim
    with span("solve", home, Ns=Ns, dtype=dt) as sp:
        if storage_sharded:
            for k, d in enumerate(mesh.shards):
                C[k] = pad_slab(C[k], d, w, npad)
            X = spd_inverse_dist(C, mesh, block=min(cfg.solve_block, Ns))
            del C
            J = _reslab(X, w, site_rows, mesh, Ns)
            del X
        else:
            sp.set(**solve_steps(Ns))
            full = all_gather(C, home, mesh)
            del C
            # inverted once (on process 0 of a pod) and broadcast: every
            # process holds the same bits of mJ
            mJ = on_first(mesh, lambda: spd_inverse(full), full.shape,
                          full.dtype)
            del full
            J_on = replicate(mJ, mesh)
            J = [J_on[k][site_rows[d][0]:site_rows[d][1]]
                 for k, d in enumerate(mesh.shards)]

    # --- scores: gathered, so S is replicated on every process ----------
    with span("score", home, score=cfg.score, N=N, q=q, dtype=dt):
        if cfg.score == "DI":
            Ls = replicate(Lsite.contiguous(), mesh)
            S = (_di_local(mesh, J, Ls, N) if storage_sharded
                 else _di_replicated(mesh, J_on, Ls, N))
        else:
            S = all_gather([frob_rows(j, q) for j in J], home, mesh)
            S = S * (1.0 - torch.eye(N, dtype=S.dtype, device=home))
    with span("apc", home):
        S = correct_apc(S)
    return S, th, Meff


def run_sharded(mesh: Mesh, Z, pc: float, theta: Union[str, float], *,
                q: int, score: str = "frob",
                dtype: torch.dtype = torch.float32,
                solve_min_dim: int = 4096, solve_block: int = 1024):
    """``gaussdca_tpu.parallel.sharded.run_sharded``: pad the tokens to a
    multiple of the shard count, run one pass, return (S, theta, Meff)."""
    Z = torch.as_tensor(np.asarray(Z).astype(np.uint8))
    M = Z.shape[0]
    cfg = GDCAConfig(pseudocount=pc, theta=theta, score=score,
                     dtype=dtype, device=mesh.home,
                     solve_min_dim=solve_min_dim, solve_block=solve_block)
    with full_f32_matmuls():
        return sharded_scores(mesh, pad_rows(Z, mesh.size), cfg, q,
                              m_true=M)


def pad_rows(Z: torch.Tensor, ndev: int) -> torch.Tensor:
    """Z with token-0 rows appended up to a multiple of ``ndev``."""
    pad = -Z.shape[0] % ndev
    if not pad:
        return Z
    return torch.cat([Z, torch.zeros((pad, Z.shape[1]), dtype=Z.dtype,
                                     device=Z.device)])
