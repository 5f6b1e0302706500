"""PyTorch port: the storage-sharded SPD inverse vs the JAX package.

The port's ``spd_inverse_dist`` on a CPU mesh of four shards must agree
with the JAX ``spd_inverse_dist`` on a four-device mesh, with the port's
single-device ``spd_inverse`` and with NumPy, to factorization round-off
in f64; its f32 Newton path must stay close to f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussdca_tpu.parallel import mesh as jmesh
from gaussdca_tpu.solve import distributed as jdist
from gaussdca_tpu_torch.parallel.mesh import Mesh
from gaussdca_tpu_torch.solve import distributed as tdist
from gaussdca_tpu_torch.solve.cholesky import spd_inverse

MESH = Mesh([torch.device("cpu")] * 4, (2, 2))


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, max(n // 4, 16)))
    return A @ A.T / A.shape[1] + 0.5 * np.eye(n)


def _inverse(C, block, dtype=torch.float64, **kw):
    Ct = torch.as_tensor(C, dtype=dtype)
    X = tdist.spd_inverse_dist(tdist.to_slabs(Ct, MESH, block), MESH,
                               block=block, **kw)
    return tdist.from_slabs(X, C.shape[0], torch.device("cpu")).numpy()


def test_plan_padding_matches_jax():
    for n in (100, 1060, 8000, 20000, 7260, 84, 7):
        for ndev in (1, 2, 4, 8):
            for block in (8, 64, 512, 1024):
                assert tdist.plan_padding(n, ndev, block) == \
                    jdist.plan_padding(n, ndev, block)


@pytest.mark.parametrize("n,block", [(40, 8), (43, 8), (64, 32)])
def test_spd_inverse_dist_matches_jax_f64(n, block):
    """n = 43 needs an identity tail (plan_padding: 44 rows); block 32 >
    the per-shard width 16 is clamped to it."""
    C = _spd(n, seed=3 * n)
    got = _inverse(C, block)
    m = jmesh.make_mesh(4, shape=(2, 2))
    want = np.asarray(jax.jit(
        lambda c: jdist.spd_inverse_dist(c, mesh=m, block=block))(
            jnp.asarray(C)))
    single = spd_inverse(torch.as_tensor(C)).numpy()
    for ref in (want, single, np.linalg.inv(C)):
        np.testing.assert_allclose(got, ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max())
    np.testing.assert_array_equal(got, got.T)   # exactly symmetrized


@pytest.mark.parametrize("refine_iters", [0, 1])
def test_spd_inverse_dist_f32_newton_close_to_f64(refine_iters):
    """f32 with no Newton step (the default) and with one (JAX's f32
    default) both stay close to f64 and to the JAX f32 solve."""
    C = _spd(70, seed=5)
    want = _inverse(C, 8)
    got = _inverse(C, 8, dtype=torch.float32, refine_iters=refine_iters)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    m = jmesh.make_mesh(4, shape=(2, 2))
    jax_f32 = np.asarray(jax.jit(
        lambda c: jdist.spd_inverse_dist(c, mesh=m, block=8))(
            jnp.asarray(C, jnp.float32)))
    assert np.abs(got - jax_f32).max() / np.abs(want).max() < 1e-4


def test_spd_inverse_dist_leaves_its_input_alone():
    """Four shards on one device alias whenever a slab is broadcast:
    nothing may update the caller's slabs in place."""
    C = torch.as_tensor(_spd(36, seed=8))
    slabs = tdist.to_slabs(C, MESH, 8)
    before = [s.clone() for s in slabs]
    tdist.spd_inverse_dist(slabs, MESH, block=8)
    for a, b in zip(slabs, before):
        assert torch.equal(a, b)


def test_singular_covariance_raises():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((30, 5))
    C = torch.as_tensor(A @ A.T)                      # rank 5
    with pytest.raises(ArithmeticError, match="positive definite"):
        tdist.spd_inverse_dist(tdist.to_slabs(C, MESH, 8), MESH, block=8)


def test_slab_layout_errors():
    slabs = tdist.to_slabs(torch.as_tensor(_spd(40)), MESH, 8)
    with pytest.raises(ValueError, match="slabs for a mesh"):
        tdist.spd_inverse_dist(slabs[:3], MESH, block=8)
    with pytest.raises(ValueError, match="block dividing w"):
        tdist.spd_inverse_dist(slabs, MESH, block=3)
