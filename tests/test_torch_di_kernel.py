"""PyTorch port: the per-pair DI core and Newton-Schulz vs the JAX package.

``ns_sqrtm_torch`` is held against the Pallas kernel ``ns_sqrtm_pallas``
in interpret mode; ``di_pairs`` (on a CPU tensor, its plain version)
against the batch-minor DI core ``_di_pairs_bm_minor`` on the same blocks.
The CUDA kernel's zero padding of s to a multiple of 4 is emulated here
and held against both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussdca_tpu.ops.di_kernel import ns_sqrtm_pallas
from gaussdca_tpu.score.di import BM_NS_ITERS as JAX_BM_NS_ITERS
from gaussdca_tpu.score.di import _di_pairs_bm_minor
from gaussdca_tpu_torch.ops import di_kernel as tdi


def test_ns_iteration_count_matches_reference():
    assert tdi.BM_NS_ITERS == JAX_BM_NS_ITERS == 14


def test_ns_sqrtm_matches_pallas():
    rng = np.random.default_rng(5)
    P, s = 130, 20   # not a multiple of the Pallas tile: identity padding
    A = rng.standard_normal((P, s, s)).astype(np.float32)
    G = (np.einsum("pij,pkj->pik", A, A) / s
         + np.eye(s, dtype=np.float32)).astype(np.float32)
    Yp, Zp, cp = ns_sqrtm_pallas(jnp.asarray(G), tile_p=64, interpret=True)
    Y, Z, c = tdi.ns_sqrtm_torch(torch.as_tensor(G))
    for got, want in ((Y, Yp), (Z, Zp), (c, cp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def _blocks(N, s, seed):
    """A symmetric coupling matrix [N s, N s] and lower Cholesky factors
    [N, s, s] of random SPD site blocks, at DCA-like scales."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N * s, N * s)) * (10.0 / s)
    mJ = (A + A.T) / 2
    B = rng.standard_normal((N, s, s)) / np.sqrt(s)
    Cii = 0.05 * (np.einsum("nij,nkj->nik", B, B) + np.eye(s))
    return mJ, np.linalg.cholesky(Cii)


@pytest.mark.parametrize("dtype,tol", [
    (np.float64, dict(rtol=1e-12, atol=0)),
    (np.float32, dict(rtol=0, atol=1e-5)),
])
@pytest.mark.parametrize("s", [1, 8, 20, 30])
def test_di_pairs_matches_batch_minor_core(s, dtype, tol):
    N = 9
    mJ, Ls = _blocks(N, s, seed=s)
    mJ, Ls = mJ.astype(dtype), Ls.astype(dtype)
    iu, ju = np.triu_indices(N, k=1)
    J4 = mJ.reshape(N, s, N, s)
    want = _di_pairs_bm_minor(jnp.asarray(np.moveaxis(J4[iu, :, ju, :], 0, -1)),
                              jnp.asarray(np.moveaxis(Ls[iu], 0, -1)),
                              jnp.asarray(np.moveaxis(Ls[ju], 0, -1)),
                              iters=14)
    got = tdi.di_pairs(torch.as_tensor(mJ), torch.as_tensor(Ls),
                       torch.as_tensor(iu), torch.as_tensor(ju))
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(mJ).dtype
    assert np.all(want > 0)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_di_pairs_pair_chunks_and_order():
    """Chunking the pair batch, and the order of the pairs, change
    nothing: each pair reads its own block by index."""
    mJ, Ls = _blocks(6, 4, seed=11)
    mJ, Ls = torch.as_tensor(mJ), torch.as_tensor(Ls)
    iu, ju = (torch.as_tensor(x) for x in np.triu_indices(6, k=1))
    whole = tdi.di_pairs_torch(mJ, Ls, iu, ju)
    chunked = tdi.di_pairs_torch(mJ, Ls, iu, ju, pair_chunk=4)
    np.testing.assert_array_equal(whole.numpy(), chunked.numpy())
    rev = tdi.di_pairs(mJ, Ls, iu.flip(0), ju.flip(0))
    np.testing.assert_allclose(rev.flip(0).numpy(), whole.numpy(),
                               rtol=1e-15, atol=0)


def test_di_pairs_rejects_bad_shapes():
    mJ, Ls = _blocks(3, 2, seed=1)
    iu, ju = (torch.as_tensor(x) for x in np.triu_indices(3, k=1))
    with pytest.raises(ValueError, match="shapes"):
        tdi.di_pairs(torch.as_tensor(mJ[:-1, :-1]), torch.as_tensor(Ls),
                     iu, ju)
    with pytest.raises(ValueError, match="dtypes"):
        tdi.di_pairs(torch.as_tensor(mJ).float(), torch.as_tensor(Ls),
                     iu, ju)


def _pad_blocks(X, S):
    out = X.new_zeros((X.shape[0], S, S))
    out[:, :X.shape[1], :X.shape[2]] = X
    return out


def _di_zero_padded(Jb, Li, Lj, iters):
    """(DI, Y) by kernel B's padded arithmetic: the [P, s, s] blocks are
    zero-padded to S = s rounded up to a multiple of 4, G = 4 rho rho^T +
    I over all S, the trace over the first s diagonal entries, the
    infinity norm over every row, and the logdet over the first s
    pivots."""
    P, s, _ = Jb.shape
    S = -(-s // 4) * 4
    Jp, Lip, Ljp = (_pad_blocks(X, S) for X in (Jb, Li, Lj))
    eye = torch.eye(S, dtype=Jb.dtype)
    rho = Lip.transpose(-1, -2) @ (Jp @ Ljp)
    G = 4.0 * (rho @ rho.transpose(-1, -2)) + eye
    tr = torch.diagonal(G, dim1=-2, dim2=-1)[:, :s].sum(-1)
    inf = G.abs().sum(-1).amax(-1)
    c = torch.minimum(tr, inf)[:, None, None]
    Y = G / c
    T = 1.5 * eye - 0.5 * Y
    Y, Z = Y @ T, T
    for it in range(1, iters):
        T = 1.5 * eye - 0.5 * (Z @ Y)
        Y = Y @ T
        if it < iters - 1:
            Z = T @ Z
    H = 0.5 * (Y * torch.sqrt(c) + eye)
    H = 0.5 * (H + H.transpose(-1, -2))
    acc = torch.zeros(P, dtype=Jb.dtype)
    for k in range(s):
        pivot = torch.clamp(H[:, k, k], min=0.1)
        acc = acc + torch.log(pivot)
        H = H - (H[:, :, k] / pivot[:, None])[:, :, None] * H[:, k, None, :]
    return 0.5 * acc, Y


@pytest.mark.parametrize("s", range(1, 31))
def test_di_zero_padding_is_exact(s):
    """Kernel B pads s up to a multiple of 4 with zeros: the emulation
    gives ``di_pairs_torch``'s DI within 1e-12 in f64 and the JAX core's,
    with the padded off-diagonal blocks exactly zero and the padded
    block finite."""
    N = 5
    mJ, Ls = _blocks(N, s, seed=100 + s)
    iu, ju = np.triu_indices(N, k=1)
    J4 = mJ.reshape(N, s, N, s)
    Jb, Li, Lj = (torch.as_tensor(x) for x in (J4[iu, :, ju, :], Ls[iu],
                                               Ls[ju]))
    got, Y = _di_zero_padded(Jb, Li, Lj, tdi.BM_NS_ITERS)
    want = tdi.di_pairs_torch(torch.as_tensor(mJ), torch.as_tensor(Ls),
                              torch.as_tensor(iu), torch.as_tensor(ju))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=0)
    jax_di = _di_pairs_bm_minor(jnp.asarray(np.moveaxis(J4[iu, :, ju, :],
                                                        0, -1)),
                                jnp.asarray(np.moveaxis(Ls[iu], 0, -1)),
                                jnp.asarray(np.moveaxis(Ls[ju], 0, -1)),
                                iters=14)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_di), rtol=1e-12,
                               atol=0)
    assert torch.count_nonzero(Y[:, :s, s:]) == 0
    assert torch.count_nonzero(Y[:, s:, :s]) == 0
    assert torch.isfinite(Y).all()
