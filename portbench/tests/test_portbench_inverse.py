"""The reference's covariance, built in place, and its blocked Cholesky
inverse, against the plain formulas they replace: a family of N = 37
columns (Ns = 740), cut into blocks of 64 (eleven whole, a ragged
twelfth) and into one block."""

import os

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.reference import gdca

N, Q, M = 37, 21, 300
SETTINGS = {"score": "DI", "pseudocount": 0.2, "theta": "auto",
            "max_gap_fraction": 0.9, "min_separation": 5,
            "remove_dups": False}


def _tokens(seed=5):
    rng = np.random.default_rng(seed)
    return traffic.family_tokens(M, N, Q, rng)


def _weights_and_covariance(precision, pc=0.2):
    ar = gdca._Arith(precision)
    Z = torch.as_tensor(_tokens())
    W, _ = gdca.sequence_weights(Z, Q, "auto", ar)
    C, meff = gdca.covariance(Z, W, Q, pc, ar)
    return Z, W, C, meff, ar


@pytest.fixture(params=[64, 1024], ids=["blocks64", "one_block"])
def block(request, monkeypatch):
    monkeypatch.setattr(gdca, "_INV_BLOCK", request.param)
    return request.param


def test_blocked_inverse_equals_inv(block):
    _, _, C, _, ar = _weights_and_covariance("float64")
    want = torch.linalg.inv(C)
    got = gdca.spd_inverse_(C.clone(), ar)
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-10, err


@pytest.mark.parametrize("precision", ["float64", "tf32"])
def test_inverse_is_exactly_symmetric(block, precision):
    _, _, C, _, ar = _weights_and_covariance(precision)
    mJ = gdca.spd_inverse_(C, ar)
    assert torch.equal(mJ, mJ.T)


def test_covariance_in_place_equals_the_plain_formula():
    Z, W, C, meff, _ = _weights_and_covariance("float64", pc=0.2)
    pc, s = 0.2, Q - 1
    E = gdca._one_hot(Z, s, torch.float64)
    pi = W @ E
    pij = (E * W[:, None]).T @ E
    Pi = (1 - pc) * (pi / meff) + pc / Q
    Pij = (1 - pc) * (pij / meff) + pc / Q ** 2
    Pij.view(N, s, N, s).diagonal(dim1=0, dim2=2).sub_(pc / Q ** 2)
    Pij.diagonal().add_(pc / Q)
    want = Pij - torch.outer(Pi, Pi)
    err = float((C - want).abs().max() / want.abs().max())
    assert err < 1e-13, err


def _tf32_valued(x):
    return x.dtype != torch.float32 or \
        not bool((x.contiguous().view(torch.int32) & 0x1FFF).any())


def test_tf32_rounds_every_products_operands(tmp_path, monkeypatch, block):
    """In the TF32 control, every matrix product (the covariance's sums,
    the three kinds of the inverse, the DI score's) takes operands that
    TF32 holds exactly."""
    path = os.path.join(tmp_path, "fam.fasta.gz")
    traffic.write_fasta_gz(path, _tokens())
    seen = {"matmul": 0, "addmm_": 0, "einsum": 0}
    matmul, addmm_, einsum = (torch.Tensor.__matmul__,
                              torch.Tensor.addmm_, torch.einsum)

    def checked(name, fn):
        def call(*ops, **k):
            tensors = [o for o in ops if isinstance(o, torch.Tensor)]
            if name == "addmm_":
                tensors = tensors[1:]
            assert all(_tf32_valued(t) for t in tensors), name
            seen[name] += 1
            return fn(*ops, **k)
        return call

    monkeypatch.setattr(torch.Tensor, "__matmul__",
                        checked("matmul", matmul))
    monkeypatch.setattr(torch.Tensor, "addmm_", checked("addmm_", addmm_))
    monkeypatch.setattr(torch, "einsum", checked("einsum", einsum))
    S, _ = gdca.reference_scores(path, SETTINGS, precision="tf32")
    assert np.isfinite(S).all()
    # the covariance's blocks, the trailing updates, the inverse's and
    # mJ's blocks, the DI score's three products per row block
    assert seen["addmm_"] >= 1 and seen["einsum"] >= 3
    assert seen["matmul"] >= (3 if block >= N * (Q - 1) else 12)
