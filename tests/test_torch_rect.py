"""PyTorch port: rectangular and full-grid row statistics.

``row_stats_rect`` (on a CPU tensor, its plain version) must equal the JAX
package's ``row_stats_rect_jnp`` and the TPU kernel
``row_stats_rect_pallas`` in interpret mode exactly: the statistics are
integer counts. ``row_stats_full`` (rect on (Z, Z)) must equal
``row_stats`` and the JAX ``row_stats_pallas`` it ports. The port reads
no ``GDCA_DISTANCE_IMPL``: the JAX package's kernel switch leaves the
port's pipeline on ``row_stats``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussdca_tpu.ops import distance as jdist
from gaussdca_tpu_torch import api as tapi
from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.ops import distance as tdist
from gaussdca_tpu_torch.stats import reweight as trw


def _tokens(M, N, q, seed, pad_rows=0):
    """Seeded alignment with near-duplicate families and ``pad_rows``
    all-token-0 rows at the end (as the mesh path pads)."""
    rng = np.random.default_rng(seed)
    Z = rng.integers(1, q + 1, size=(M, N), dtype=np.uint8)
    for f in range(0, M - 8, 16):
        mut = rng.random((7, N)) < 0.1
        Z[f + 1:f + 8] = np.where(mut, rng.integers(1, q + 1, (7, N)), Z[f])
    Z[M - pad_rows:] = 0
    return Z


def _threshold(Z, q, theta):
    N = Z.shape[1]
    if theta == "auto":
        theta = float(trw.auto_theta_closed_form(torch.as_tensor(Z), q))
    return float(np.float32(np.floor(theta * N)))


@pytest.mark.parametrize("Mb,N,q,pad,rows,theta", [
    (130, 53, 21, 0, (0, 65), 0.2),       # A a row block, Ma % 64 != 0
    (150, 40, 21, 6, (100, 150), "auto"),  # A holds the token-0 pad rows
    (96, 24, 8, 3, (24, 48), 0.0),
    (120, 33, 31, 0, None, 0.2),           # A independent of B, Ma != Mb
    (77, 61, 21, 2, None, "auto"),
    (64, 30, 2, 0, (32, 64), 0.2),
])
def test_row_stats_rect_matches_jax(Mb, N, q, pad, rows, theta):
    ZB = _tokens(Mb, N, q, seed=Mb * 7 + N, pad_rows=pad)
    ZA = (ZB[rows[0]:rows[1]] if rows is not None
          else _tokens(Mb // 2 + 3, N, q, seed=N))
    thresh = _threshold(ZB, q, theta)
    rs, below = tdist.row_stats_rect(torch.as_tensor(ZA),
                                     torch.as_tensor(ZB), thresh)
    rs_j, below_j = jdist.row_stats_rect_jnp(
        jnp.asarray(ZA), jnp.asarray(ZB), jnp.float32(thresh), q)
    np.testing.assert_array_equal(rs.numpy(), np.asarray(rs_j))
    np.testing.assert_array_equal(below.numpy(), np.asarray(below_j))
    padded = ZA.max(axis=1) == 0
    assert (rs.numpy()[padded] == 0).all()
    assert (below.numpy()[padded] == 0).all()


def test_row_stats_rect_matches_pallas_interpret():
    ZB = _tokens(200, 45, 21, seed=2, pad_rows=4)
    ZA = ZB[70:170]
    thresh = _threshold(ZB, 21, 0.2)
    rs, below = tdist.row_stats_rect(torch.as_tensor(ZA),
                                     torch.as_tensor(ZB), thresh)
    rs_p, below_p = jdist.row_stats_rect_pallas(
        jnp.asarray(ZA.astype(np.int8)), jnp.asarray(ZB.astype(np.int8)),
        jnp.float32(thresh), 21, tile_m=128, interpret=True)
    np.testing.assert_array_equal(rs.numpy(), np.asarray(rs_p))
    np.testing.assert_array_equal(below.numpy(), np.asarray(below_p))


@pytest.mark.parametrize("theta", [0.0, 0.2, "auto"])
def test_row_stats_full_equals_row_stats(theta):
    """The B4 contract: rect on (Z, Z) is the square row statistics."""
    Z = torch.as_tensor(_tokens(140, 37, 21, seed=11, pad_rows=5))
    t = _threshold(Z.numpy(), 21, theta)
    for a, b in zip(tdist.row_stats_full(Z, t), tdist.row_stats(Z, t)):
        assert torch.equal(a, b)


def test_row_stats_rect_n_true_and_errors():
    """``n_true`` is the width the hamming distance is taken over."""
    ZB = _tokens(60, 20, 9, seed=4)
    ZA = ZB[:25]
    A, B = torch.as_tensor(ZA), torch.as_tensor(ZB)
    D = ((ZA[:, None, :] == ZB[None, :, :]) & (ZA[:, None, :] > 0)).sum(-1)
    _, below = tdist.row_stats_rect(A, B, 5.0, n_true=23)
    np.testing.assert_array_equal(below.numpy(),
                                  ((23 - D) < 5.0).sum(1).astype(np.float32))
    with pytest.raises(ValueError, match="one width"):
        tdist.row_stats_rect(A, B[:, :10], 5.0)
    with pytest.raises(ValueError, match="token matrix"):
        tdist.row_stats_rect(A.to(torch.int32), B, 5.0)


@pytest.mark.parametrize("M,q,theta", [(96, 21, 0.2), (140, 8, 0.0),
                                       (77, 31, "auto")])
def test_row_stats_full_matches_pallas_interpret(M, q, theta):
    """The port of ``row_stats_pallas`` against the TPU kernel itself
    (interpret mode) on gap-free tokens."""
    Z = _tokens(M, 29, q, seed=M + q)
    Z[Z == 0] = 1
    thresh = _threshold(Z, q, theta)
    rs, below = tdist.row_stats_full(torch.as_tensor(Z), thresh)
    rs_p, below_p = jdist.row_stats_pallas(
        jnp.asarray(Z.astype(np.int8)), jnp.float32(thresh), q, tile_m=128,
        interpret=True)
    np.testing.assert_array_equal(rs.numpy(), np.asarray(rs_p))
    np.testing.assert_array_equal(below.numpy(), np.asarray(below_p))


@pytest.mark.parametrize("impl", ["", "pallas_full", "asym", "mxu",
                                  "fallback"])
def test_pipeline_ignores_the_jax_kernel_switch(monkeypatch, impl):
    """Whatever ``GDCA_DISTANCE_IMPL`` holds for the JAX package, the
    port's one-device pipeline takes ``row_stats`` and gives the same
    scores."""
    calls = []
    for mod, name in ((trw, "row_stats"), (tdist, "row_stats_full"),
                      (tdist, "row_stats_rect")):
        def spy(*a, _f=getattr(mod, name), _n=name, **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    Z = torch.as_tensor(_tokens(90, 16, 8, seed=6))
    cfg = GDCAConfig(pseudocount=0.5, dtype=torch.float64, device="cpu")
    S0, th0, m0 = tapi.scores_pipeline(Z, 8, cfg)
    monkeypatch.setenv("GDCA_DISTANCE_IMPL", impl)
    S1, th1, m1 = tapi.scores_pipeline(Z, 8, cfg)
    assert calls == ["row_stats", "row_stats"]
    assert float(m0) == float(m1) and float(th0) == float(th1)
    assert torch.equal(S0, S1)


def _tokens_all_states(M, N, seed, pad_rows=0):
    """Tokens 1..31 (so that tokens above q occur for q < 31), families,
    and ``pad_rows`` token-0 rows at the end."""
    return _tokens(M, N, 31, seed, pad_rows=pad_rows)


@pytest.mark.parametrize("q", [9, 21])
@pytest.mark.parametrize("Mb,rows", [(200, (70, 170)), (150, None)])
def test_row_stats_rect_tokens_above_q_match_nothing(q, Mb, rows):
    """``row_stats_rect(ZA, ZB, t, q=q)`` equals the TPU kernel run in
    interpret mode with the same q, on tokens 1..31: a token above q
    matches nothing. Every token counts with the default q = 31."""
    N = 45
    ZB = _tokens_all_states(Mb, N, seed=q + Mb, pad_rows=4)
    ZA = (ZB[rows[0]:rows[1]] if rows is not None
          else _tokens_all_states(61, N, seed=q))
    A, B = torch.as_tensor(ZA), torch.as_tensor(ZB)
    for theta in (0.2, 0.5):
        thresh = float(np.float32(np.floor(theta * N)))
        rs, below = tdist.row_stats_rect(A, B, thresh, q=q)
        rs_p, below_p = jdist.row_stats_rect_pallas(
            jnp.asarray(ZA.astype(np.int8)), jnp.asarray(ZB.astype(np.int8)),
            jnp.float32(thresh), q, tile_m=128, interpret=True)
        np.testing.assert_array_equal(rs.numpy(), np.asarray(rs_p))
        np.testing.assert_array_equal(below.numpy(), np.asarray(below_p))
    every, _ = tdist.row_stats_rect(A, B, thresh)
    assert float(every.sum()) > float(rs.sum())


@pytest.mark.parametrize("q", [9, 21, 31])
def test_row_stats_full_counts_states_up_to_q(q):
    """``row_stats_full(Z, t, q)`` equals ``row_stats(Z, t, q)`` and the
    JAX ``row_stats_pallas`` with the same q on tokens 1..31."""
    Z = _tokens_all_states(140, 29, seed=q, pad_rows=3)
    thresh = _threshold(Z, 31, 0.3)
    full = tdist.row_stats_full(torch.as_tensor(Z), thresh, q)
    for a, b in zip(full, tdist.row_stats(torch.as_tensor(Z), thresh, q)):
        assert torch.equal(a, b)
    want = jdist.row_stats_pallas(jnp.asarray(Z.astype(np.int8)),
                                  jnp.float32(thresh), q, tile_m=128,
                                  interpret=True)
    for g, w in zip(full, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rect_and_match_counts_check_q():
    Z = torch.as_tensor(_tokens_all_states(20, 9, seed=1))
    for bad in (0, 32):
        with pytest.raises(ValueError, match="q must be"):
            tdist.row_stats_rect(Z, Z, 3.0, q=bad)
        with pytest.raises(ValueError, match="q must be"):
            tdist.row_stats_full(Z, 3.0, bad)
        with pytest.raises(ValueError, match="q must be"):
            tdist.match_counts(Z, bad)


@pytest.mark.parametrize("q", [9, 21])
@pytest.mark.parametrize("theta", [0.2, 0.4])
def test_mesh_row_stats_fn_passes_q(q, theta):
    """The mesh's ``row_stats_fn`` (4 shards on a CPU mesh, M = 62 padded
    to 64) counts states 1..q: W, Meff and theta equal the JAX sharded
    reweighting (``shard_map`` of the Pallas rect kernel, interpret mode,
    over the 8 virtual devices) with the same q, on tokens 1..31."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from gaussdca_tpu.parallel import mesh as jmesh
    from gaussdca_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from gaussdca_tpu.stats import reweight as jrw
    from gaussdca_tpu_torch.parallel import mesh as tmesh
    from gaussdca_tpu_torch.parallel import sharded as tsharded

    M, N = 62, 27
    Z = tsharded.pad_rows(torch.as_tensor(_tokens_all_states(M, N, seed=q)),
                          4)
    cpu = torch.device("cpu")
    fn = tsharded._row_stats_sharded(tmesh.Mesh([cpu] * 4, (2, 2)),
                                     {cpu: Z}, Z.shape[0] // 4)
    W1, Meff1, th1 = trw.compute_weights_streaming(
        Z, theta, q, dtype=torch.float64, row_stats_fn=fn, m_true=M)

    rows = (DATA_AXIS, MODEL_AXIS)
    local = shard_map(
        lambda zl, zf, t: jdist.row_stats_rect_pallas(
            zl, zf, t, q, tile_m=128, interpret=True),
        mesh=jmesh.make_mesh(8, shape=(4, 2)),
        in_specs=(P(rows, None), P(), P()), out_specs=(P(rows), P(rows)),
        check_vma=False)
    W0, Meff0, th0 = jrw.compute_weights_streaming(
        jnp.asarray(Z.numpy().astype(np.int8)), theta, q,
        lambda z, t, _q: local(z, z, t), dtype=jnp.float64, m_true=M)
    np.testing.assert_array_equal(W1.numpy(), np.asarray(W0))
    assert float(Meff1) == pytest.approx(float(Meff0), rel=1e-13)
    assert float(th1) == float(th0)
