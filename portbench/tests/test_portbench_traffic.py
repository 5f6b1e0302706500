"""The generator: the same seed writes the same pool, byte for byte;
another seed writes other families of the same sizes."""

import gzip
import hashlib
import json
import os

import numpy as np
import pytest

from conftest import ROOT, TINY
from portbench import traffic
from portbench.reference import read_fasta


def _digest(pool):
    return [hashlib.sha256(open(f.path, "rb").read()).hexdigest()
            for f in pool]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3])
def test_same_seed_same_pool(tmp_path, seed):
    a = traffic.make_pool(TINY, seed, str(tmp_path / "a"))
    b = traffic.make_pool(TINY, seed, str(tmp_path / "b"))
    assert _digest(a) == _digest(b)
    assert [(f.M, f.N) for f in a] == [(f.M, f.N) for f in b]


def test_other_seed_same_sizes_other_families(tmp_path):
    a = traffic.make_pool(TINY, 1, str(tmp_path / "a"))
    b = traffic.make_pool(TINY, 2, str(tmp_path / "b"))
    assert sorted((f.M, f.N) for f in a) == sorted((f.M, f.N) for f in b)
    assert set(_digest(a)).isdisjoint(_digest(b))


def test_pool_families_distinct_and_as_sized(tmp_path):
    pool = traffic.make_pool(TINY, 5, str(tmp_path))
    assert len(set(_digest(pool))) == len(pool)
    for f in pool:
        Z = read_fasta(f.path, 1.0)
        assert Z.shape == (f.M, f.N) and Z.min() >= 1 and Z.max() == 21
        assert gzip.open(f.path).read(3) == b">s0"


@pytest.mark.parametrize("name", ["wide", "mid", "deep"])
def test_mix_sizes(name):
    with open(os.path.join(ROOT, "portbench", "traffic", name + ".json")) \
            as fh:
        mix = json.load(fh)
    sizes = np.array(traffic.family_sizes(mix))
    assert len(sizes) == mix["families"]
    for axis, key in ((0, "M"), (1, "N")):
        (kind, value), = mix[key].items()
        lo, hi = (value, value) if kind == "fixed" else value
        assert sizes[:, axis].min() >= lo and sizes[:, axis].max() <= hi
