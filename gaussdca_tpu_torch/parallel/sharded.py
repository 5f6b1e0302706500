"""Multi-device gDCA pipeline over a ``Mesh``, driven from one process.

The port of ``gaussdca_tpu.parallel.sharded``; shard d is the d-th device
of the mesh in row-major order, and devices may repeat (several shards on
one card):

- reweighting is data-parallel: shard d holds its row block of the
  tokens and runs ``row_stats_rect`` (kernel C on a card) of its rows
  against all rows; the tokens are packed once per device and shared by
  the shards there. Only O(M) row statistics come back, gathered on the
  mesh's home device (shard 0's) for the weights;
- weighted frequencies are summed per shard from its rows and weights;
  each partial is split into the row slabs of the statistical dimension
  Ns = N s as it is summed (a reduce-scatter), then freed, so Pij and C
  only ever exist as per-shard row slabs;
- below ``cfg.solve_min_dim`` the covariance is gathered and inverted
  once (``spd_inverse``), and mJ is copied to each distinct device; at or
  above it the solve is storage-sharded (``solve.distributed``) and mJ
  stays in row slabs;
- scores: frob rows are computed per site-aligned slab of mJ; DI pairs
  are split over the shards (one ``di_pairs`` launch each) against the
  replicated mJ, or, storage-sharded, anchored at the shard that holds
  one endpoint's rows (``_pair_assignment``) and read from that slab
  (kernel B's ``row0``). APC and ranking run on the gathered S.

The JAX package's opt-in ``_di_sharded_tiled`` (``GDCA_DI_SHARDED=tiled``)
exists for the TPU's 128-lane layout and is not ported: kernel B already
reads each block by index.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.core.runtime import full_f32_matmuls, no_mark
from gaussdca_tpu_torch.ops import di_kernel, distance
from gaussdca_tpu_torch.parallel.mesh import Mesh, all_gather, psum, \
    replicate
from gaussdca_tpu_torch.score.apc import correct_apc
from gaussdca_tpu_torch.score.di import ns_iters
from gaussdca_tpu_torch.score.frob import frob_rows
from gaussdca_tpu_torch.solve.cholesky import spd_inverse
from gaussdca_tpu_torch.solve.distributed import pad_slab, plan_padding, \
    spd_inverse_dist
from gaussdca_tpu_torch.stats import reweight
from gaussdca_tpu_torch.stats.frequencies import (accumulate_frequencies,
                                                   frequency_chunk)
from gaussdca_tpu_torch.stats.pseudocount import add_pseudocount, compute_C

Bounds = List[Tuple[int, int]]


def _even_bounds(n: int, ndev: int, per: int) -> Bounds:
    """Shard d's rows [d per, (d + 1) per) clipped to n."""
    return [(min(d * per, n), min((d + 1) * per, n)) for d in range(ndev)]


def _row_stats_sharded(mesh: Mesh, Z_on: dict, m_loc: int) -> Callable:
    """``fn(Z, thresh, q) -> (rowsum, below)`` over all rows and states
    1..q, on the home device: shard d computes its row block against all
    rows. On a card each call packs the tokens once per device
    (``pack_tokens``, tokens above q zeroed) and each shard's block is a
    slice of them."""
    N = Z_on[mesh.home].shape[1]
    cuda = mesh.home.type == "cuda"

    def fn(Z: torch.Tensor, thresh, q: int):
        if Z.shape != Z_on[mesh.home].shape:
            raise ValueError("sharded row stats: unexpected token matrix")
        words = {dev: distance.pack_tokens(Zd, q)
                 for dev, Zd in Z_on.items()} if cuda else None
        parts = []
        for d, dev in enumerate(mesh.flat):
            rows = slice(d * m_loc, (d + 1) * m_loc)
            if cuda:
                parts.append(distance.row_stats_rect_packed(
                    words[dev][rows], words[dev], N, thresh, q))
            else:
                parts.append(distance.row_stats_rect(
                    Z_on[dev][rows], Z_on[dev], thresh, q=q))
        return tuple(all_gather([p[k] for p in parts], mesh.home)
                     for k in range(2))
    return fn


def _site_blocks(C: torch.Tensor, row0: int, s: int) -> torch.Tensor:
    """[r, s]: each row of the slab C [r, Ns] (global rows row0..) on the
    columns of its own site, i.e. that row of its diagonal site block."""
    g = torch.arange(row0, row0 + C.shape[0], device=C.device)
    cols = (g // s)[:, None] * s + torch.arange(s, device=C.device)
    return C.gather(1, cols)


def _reslab(X: Sequence[torch.Tensor], w: int, bounds: Bounds, devs,
            ncols: int) -> List[torch.Tensor]:
    """Rows ``bounds[d]`` (columns :ncols) of the matrix held as slabs of
    w rows, gathered on shard d's device: from the solve's row slabs to
    the site-aligned slabs the scores read."""
    out = []
    for (g0, g1), dev in zip(bounds, devs):
        pieces = [x[max(g0, k * w) - k * w:min(g1, (k + 1) * w) - k * w,
                    :ncols].to(dev)
                  for k, x in enumerate(X)
                  if max(g0, k * w) < min(g1, (k + 1) * w)]
        out.append(torch.cat(pieces) if pieces else
                   torch.empty((0, ncols), dtype=X[0].dtype, device=dev))
    return out


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
    device's copy of mJ."""
    iu, ju = np.triu_indices(N, k=1)
    chunks = np.array_split(np.arange(iu.size), mesh.size)
    iters = ns_iters(mJ[0].dtype, -(-iu.size // mesh.size))
    di = [di_kernel.di_pairs(mJ[d], Ls[d],
                             torch.as_tensor(iu[c], device=dev),
                             torch.as_tensor(ju[c], device=dev), iters)
          for d, (c, dev) in enumerate(zip(chunks, mesh.flat))]
    di = all_gather(di, mesh.home)
    iu, ju = (torch.as_tensor(x, device=mesh.home) for x in (iu, ju))
    S = torch.zeros((N, N), dtype=di.dtype, device=mesh.home)
    S[iu, ju] = di
    S[ju, iu] = di
    return S


def _di_local(mesh: Mesh, J: List[torch.Tensor], Ls: List[torch.Tensor],
              N: int) -> torch.Tensor:
    """DI with mJ kept in site-aligned row slabs: every pair is read from
    the slab of its anchor (``_pair_assignment``)."""
    nloc, assign = _pair_assignment(N, mesh.size)
    iters = ns_iters(J[0].dtype, -(-(N * (N - 1) // 2) // mesh.size))
    di, oi, oj = [], [], []
    for d, dev in enumerate(mesh.flat):
        a, o, i, j = assign[d]
        if a.size:
            di.append(di_kernel.di_pairs(
                J[d], Ls[d], torch.as_tensor(a, device=dev),
                torch.as_tensor(o, device=dev), iters, row0=d * nloc))
            oi.append(i)
            oj.append(j)
    oi, oj = (torch.as_tensor(np.concatenate(x), device=mesh.home)
              for x in (oi, oj))
    S = torch.zeros((N, N), dtype=J[0].dtype, device=mesh.home)
    S[oi, oj] = all_gather(di, mesh.home)
    return S + S.T


def sharded_scores(mesh: Mesh, Z: torch.Tensor, cfg: GDCAConfig, q: int,
                   m_true: Optional[int] = None, *,
                   mark: Callable[[str], None] = no_mark):
    """Tokens Z [M, N] (M a multiple of the shard count; rows at or past
    ``m_true`` are token-0 padding) -> (S [N, N] APC-corrected on the
    mesh's home device, resolved theta, Meff). ``cfg.device`` is not
    read: the mesh's devices are where it runs. ``mark(stage)`` is called
    after "reweight", "frequencies", "solve" and "score"."""
    dtype = cfg.resolve_dtype()
    devs, home, ndev = mesh.flat, mesh.home, mesh.size
    M, N = Z.shape
    if M % ndev:
        raise ValueError(f"sharded_scores: M={M} is not a multiple of the "
                         f"{ndev} shards (pad with token-0 rows)")
    m_loc = M // ndev
    s = q - 1
    Ns = N * s
    Z_on = {dev: Z.to(dev) for dev in mesh.distinct}

    # --- reweighting: shard rows vs all rows, O(M) statistics -----------
    theta = "auto" if cfg.auto_theta else float(cfg.theta)
    W, Meff, th = reweight.compute_weights_streaming(
        Z_on[home], theta, q, dtype=dtype, m_true=m_true,
        row_stats_fn=_row_stats_sharded(mesh, Z_on, m_loc))
    mark("reweight")

    # --- frequencies: per-shard partials, summed into row slabs ---------
    npad, w, _ = plan_padding(Ns, ndev, min(cfg.solve_block, Ns))
    rows = _even_bounds(Ns, ndev, w)
    m_chunk = frequency_chunk(m_loc, N, q, dtype)
    pis = []
    Pij = [torch.zeros((r1 - r0, Ns), dtype=dtype, device=dev)
           for (r0, r1), dev in zip(rows, devs)]
    for src, dev in enumerate(devs):
        loc = slice(src * m_loc, (src + 1) * m_loc)
        p_pi, p_pij = accumulate_frequencies(
            Z_on[dev][loc], W[loc].to(dev), q, dtype=dtype, m_chunk=m_chunk)
        pis.append(p_pi)
        for (r0, r1), slab in zip(rows, Pij):
            slab += p_pij[r0:r1].to(slab.device)
        del p_pij   # each partial is a full [Ns, Ns]: drop it once summed
    Pi_t = psum(pis, home) / Meff
    C = []
    for d, (r0, _) in enumerate(rows):
        Pi, slab = add_pseudocount(Pi_t, Pij[d] / Meff.to(devs[d]),
                                   cfg.pseudocount, q, row0=r0)
        Pij[d] = None
        C.append(compute_C(Pi, slab, row0=r0))
        del slab
    Lsite = None
    if cfg.score == "DI":
        # site Cholesky factors [N, s, s]: tiny, replicated
        Lsite = torch.linalg.cholesky(all_gather(
            [_site_blocks(c, r0, s) for c, (r0, _) in zip(C, rows)],
            home).reshape(N, s, s))
    mark("frequencies")

    # --- solve: replicated below the threshold, storage-sharded above ---
    sites = _even_bounds(N, ndev, -(-N // ndev))
    site_rows = [(a * s, b * s) for a, b in sites]
    storage_sharded = Ns >= cfg.solve_min_dim
    if storage_sharded:
        for d in range(ndev):
            C[d] = pad_slab(C[d], d, w, npad)
        X = spd_inverse_dist(C, mesh, block=min(cfg.solve_block, Ns))
        del C
        J = _reslab(X, w, site_rows, devs, Ns)
        del X
    else:
        mJ = spd_inverse(all_gather(C, home))
        del C
        J_on = replicate(mJ, mesh)
        J = [J_on[d][r0:r1] for d, (r0, r1) in enumerate(site_rows)]
    mark("solve")

    # --- scores ----------------------------------------------------------
    if cfg.score == "DI":
        Ls = replicate(Lsite.contiguous(), mesh)
        S = (_di_local(mesh, J, Ls, N) if storage_sharded
             else _di_replicated(mesh, J_on, Ls, N))
    else:
        S = all_gather([frob_rows(j, q) for j in J], home)
        S = S * (1.0 - torch.eye(N, dtype=S.dtype, device=home))
    S = correct_apc(S)
    mark("score")
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
