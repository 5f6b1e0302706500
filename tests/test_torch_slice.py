"""PyTorch port, whole slice: golden files, parity with the JAX package,
and the reference's error behaviour (CPU, f64)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gaussdca_tpu import api as japi
from gaussdca_tpu.core.config import GDCAConfig as JConfig
from gaussdca_tpu.io.fasta import MSA as JMSA
from gaussdca_tpu_torch import api as tapi
from gaussdca_tpu_torch import gdca
from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.interop import config_from_reference, msa_from_arrays
from gaussdca_tpu_torch.score.rank import format_rank

GOLDEN = [
    ("small.fasta.gz", "small.FNRout.txt", dict(), 1176),
    ("small.fasta.gz", "small.DIRout.txt",
     dict(pseudocount=0.2, score="DI", remove_dups=True), 1176),
    ("small.fasta.gz", "small.DIRout2.txt",
     dict(pseudocount=0.2, score="DI", theta=0.0, max_gap_fraction=0.8,
          min_separation=4), 1225),
    ("large.fasta.gz", "large.DIRout.txt",
     dict(pseudocount=0.2, score="DI", remove_dups=True), 78210),
]


def _todict(text):
    d = {}
    for line in text.splitlines():
        i, j, x = line.split()
        assert (int(i), int(j)) not in d
        d[(int(i), int(j))] = float(x)
    return d


@pytest.mark.parametrize("fasta,golden,kw,npairs", GOLDEN,
                         ids=[g[1] for g in GOLDEN])
def test_golden_f64_cpu(golden_dir, fasta, golden, kw, npairs):
    """tests/test_golden.py's semantics: the same pair set, rtol 1e-6
    against the printed golden values."""
    r = gdca(os.path.join(golden_dir, fasta), dtype=torch.float64,
             device="cpu", **kw)
    assert len(r) == npairs
    got = _todict(format_rank(r.ranking))
    want = _todict(open(os.path.join(golden_dir, golden)).read())
    assert set(got) == set(want)
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=1e-6, atol=1e-12)


def _synthetic_msa(seed=9, M=200, N=40, q=21):
    """Seeded families of mutated founders (a star phylogeny)."""
    rng = np.random.default_rng(seed)
    founders = rng.integers(1, q + 1, size=(10, N), dtype=np.uint8)
    rows = []
    for k in range(M):
        child = founders[k % 10].copy()
        mut = rng.random(N) < 0.2
        child[mut] = rng.integers(1, q + 1, size=int(mut.sum()))
        rows.append(child)
    Z = np.stack(rows)
    Z[0, 0] = q
    return JMSA(tokens=Z, headers=[f"s{i}" for i in range(M)], q=q,
                n_dropped_gaps=2)


@pytest.mark.parametrize("score,pc,theta", [("frob", 0.8, "auto"),
                                            ("DI", 0.2, 0.2)])
def test_slice_matches_jax(score, pc, theta):
    """The port and the JAX package on the same state (tokens + config,
    carried over through interop): rtol 1e-9 on every ranked score."""
    jmsa = _synthetic_msa()
    jcfg = JConfig(score=score, pseudocount=pc, theta=theta,
                   remove_dups=True, min_separation=3)
    want = japi.gdca_from_msa(jmsa, jcfg)

    msa = msa_from_arrays(jmsa.tokens, jmsa.q, jmsa.headers,
                          jmsa.n_dropped_gaps, jmsa.n_dropped_dups)
    cfg = dataclasses.replace(
        config_from_reference(dataclasses.asdict(jcfg)),
        dtype=torch.float64, device="cpu")
    got = tapi.gdca_from_msa(msa, cfg)

    for f in ("M", "N", "q", "n_dropped_gaps", "n_dropped_dups"):
        assert getattr(got, f) == getattr(want, f)
    np.testing.assert_allclose(got.theta, want.theta, rtol=1e-12)
    np.testing.assert_allclose(got.meff, want.meff, rtol=1e-12)
    g = {(i, j): x for i, j, x in got.ranking}
    w = {(i, j): x for i, j, x in want.ranking}
    assert set(g) == set(w)
    keys = sorted(w)
    np.testing.assert_allclose([g[k] for k in keys], [w[k] for k in keys],
                               rtol=1e-9, atol=1e-12)
    assert [p[:2] for p in got.ranking[:20]] == \
        [p[:2] for p in want.ranking[:20]]


@pytest.mark.parametrize("score", ["frob", "DI"])
def test_singular_covariance_raises(score):
    """pc=0 with M << N*s makes C singular: the reference dies with a
    PosDefException; the port raises ArithmeticError, like the JAX
    package, instead of ranking NaNs."""
    rng = np.random.default_rng(3)
    Z = rng.integers(1, 9, size=(6, 12)).astype(np.uint8)   # M=6, Ns=84
    msa = msa_from_arrays(Z, 8, [f"s{i}" for i in range(6)])
    cfg = GDCAConfig(pseudocount=0.0, theta=0.2, min_separation=1,
                     score=score, dtype=torch.float64, device="cpu")
    with pytest.raises(ArithmeticError, match="positive definite"):
        tapi.gdca_from_msa(msa, cfg)


@pytest.mark.parametrize("kwargs", [
    dict(pseudocount=-0.1),
    dict(pseudocount=1.5),
    dict(theta=-0.2),
    dict(theta=2.0),
    dict(theta="automatic"),
    dict(max_gap_fraction=-0.5),
    dict(max_gap_fraction=1.01),
    dict(score="frobenius"),
    dict(score="di"),
    dict(min_separation=0),
    dict(solve_min_dim=0),
    dict(solve_block=4),
])
def test_config_errors_match_jax(kwargs):
    with pytest.raises(ValueError) as want:
        JConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        GDCAConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_config_defaults_and_resolution():
    cfg = GDCAConfig()
    for f in ("pseudocount", "theta", "max_gap_fraction", "score",
              "min_separation", "remove_dups"):
        assert getattr(cfg, f) == getattr(JConfig(), f)
    assert cfg.resolve_dtype() == torch.float32
    assert cfg.resolve_device() == torch.device("cuda")
    assert GDCAConfig(dtype="float64").resolve_dtype() == torch.float64
    with pytest.raises(ValueError, match="dtype"):
        GDCAConfig(dtype=torch.float16)
    with pytest.raises(ValueError, match="device"):
        GDCAConfig(device="tpu")


def test_config_from_reference_refuses_unsupported_fields():
    base = dataclasses.asdict(JConfig(score="DI", pseudocount=0.2))
    cfg = config_from_reference(base)
    assert (cfg.score, cfg.pseudocount) == ("DI", 0.2)
    assert cfg.dtype == torch.float32 and cfg.device == "cuda"
    assert config_from_reference(
        dict(base, dtype="float64")).dtype == torch.float64
    for field, value in [("m_bucket", 64), ("n_bucket", 32),
                         ("force_fallback", True), ("precision", "high")]:
        with pytest.raises(ValueError, match=field):
            config_from_reference(dict(base, **{field: value}))
    # the mesh-path solve thresholds carry over (the port has the mesh)
    cfg = config_from_reference(dict(base, solve_block=512,
                                     solve_min_dim=100))
    assert (cfg.solve_block, cfg.solve_min_dim) == (512, 100)
    with pytest.raises(ValueError, match="unknown"):
        config_from_reference(dict(base, mesh="auto"))


def test_q_limits_and_missing_file():
    cfg = GDCAConfig(dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="too big"):
        tapi.gdca_from_msa(
            msa_from_arrays(np.full((4, 6), 32, np.uint8), 32, list("abcd")),
            cfg)
    with pytest.raises(ValueError, match="at least 2"):
        tapi.gdca_from_msa(
            msa_from_arrays(np.ones((4, 6), np.uint8), 1, list("abcd")), cfg)
    with pytest.raises(ValueError, match="cannot open file"):
        gdca("/nonexistent/path/foo.fasta", device="cpu")
