"""PyTorch port: the native C++ FASTA parser, the NumPy parser and the JAX
package's parser agree (tokens, headers, q, drop count, error texts).

The cases are copies of tests/test_native_io.py's parity cases; each holds
``gaussdca_tpu_torch.io.fasta.read_fasta_alignment`` with
``use_native=True`` and ``use_native=False`` and
``gaussdca_tpu.io.fasta.read_fasta_alignment`` equal on the same file.
"""

import gzip
import os
import threading

import numpy as np
import pytest

from gaussdca_tpu.io import fasta as jfasta
from gaussdca_tpu_torch.io import fasta, native
from gaussdca_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(fn):
    try:
        m = fn()
    except ValueError as e:
        return ("err", str(e))
    return ("ok", m.tokens.shape, m.tokens.tobytes(), tuple(m.headers), m.q,
            m.n_dropped_gaps)


def _three(path, mgf):
    """(port native, port NumPy, JAX) results on one file."""
    path = str(path)
    return (_read(lambda: fasta.read_fasta_alignment(path, mgf,
                                                     use_native=True)),
            _read(lambda: fasta.read_fasta_alignment(path, mgf,
                                                     use_native=False)),
            _read(lambda: jfasta.read_fasta_alignment(path, mgf)))


def _parity(path, mgf):
    a, b, c = _three(path, mgf)
    assert a == b == c, (a[0], b[0], c[0])
    return a


def test_native_parser_builds_and_is_the_default(golden_dir):
    assert native.available(), native.build_error()
    path = os.path.join(golden_dir, "small.fasta.gz")
    assert fasta.read_fasta_alignment(path, 0.9).parser == "native"
    assert fasta.read_fasta_alignment(path, 0.9,
                                      use_native=False).parser == "numpy"
    dedup = fasta.remove_duplicate_sequences(
        fasta.read_fasta_alignment(path, 0.9))
    assert dedup.parser == "native"


def test_source_is_the_jax_packages_parser():
    """The port builds its own copy, equal to native/fasta_native.cpp from
    the first #include on (only the header comment differs)."""
    def body(p):
        src = open(p).read()
        return src[src.index("#include <zlib.h>"):]

    assert body(os.path.join(REPO, "gaussdca_tpu_torch", "csrc",
                             "fasta_native.cpp")) \
        == body(os.path.join(REPO, "native", "fasta_native.cpp"))


@pytest.mark.parametrize("name,mgf", [
    ("small.fasta.gz", 0.9), ("small.fasta.gz", 0.8),
    ("large.fasta.gz", 0.9), ("large.fasta.gz", 1.0),
])
def test_parity_on_reference_data(golden_dir, name, mgf):
    assert _parity(os.path.join(golden_dir, name), mgf)[0] == "ok"


def test_parity_ragged_error(tmp_path):
    p = tmp_path / "ragged.fasta"
    p.write_text(">s1\nACDEF\n>s2\nACDEFG\n")
    res = _parity(p, 0.9)
    assert res[0] == "err" and "inconsistent" in res[1]


def test_parity_synthetic(tmp_path):
    # multi-line sequences, insert states (lowercase + '.'), CRLF endings,
    # blank lines, header whitespace, non-standard letters (Z -> gap
    # state), a gap-heavy sequence, plain and gzipped input; all
    # sequences are length 10 after insert removal
    good = (">s1/1-10 desc here\r\n"
            "ACDEF.xy\nGHIKL\n"
            "\n"
            ">s2\n"
            "MNPQRSTVWY\n"
            ">s3\n"
            "--------AB\n"
            ">s4\n"
            "ZZZZZZZZZZ\n")
    for gz in (False, True):
        p = tmp_path / ("good.fasta" + (".gz" if gz else ""))
        if gz:
            with gzip.open(p, "wt") as fh:
                fh.write(good)
        else:
            p.write_text(good)
        for mgf in (0.9, 0.8, 0.5, 1.0):   # 0.8 hits the inclusive boundary
            assert _parity(p, mgf)[0] == "ok"


def test_parity_multimember_gzip(tmp_path):
    """Concatenated gzip members are one logical stream (RFC 1952 2.2)."""
    p = tmp_path / "multi.fasta.gz"
    p.write_bytes(gzip.compress(b">m1\nACDEFGHIKL\n>m2\nMNPQRSTVWY\n")
                  + gzip.compress(b">m3\nAAAAAAAAAA\n"))
    msa = fasta.read_fasta_alignment(str(p), 0.9, use_native=True)
    assert msa.M == 3 and msa.headers == ["m1", "m2", "m3"]
    _parity(p, 0.9)


@pytest.mark.parametrize("name,text,mgf", [
    ("noheader.fasta", "ACDEF\n>s1\nACDEF\n", 0.9),
    ("empty.fasta", "", 0.9),
    ("headeronly.fasta", ">s1\n>s2\nACD\n", 0.9),
    ("allgap.fasta", ">a\n-----\n>b\n-----\n", 0.5),
])
def test_parity_error_texts(tmp_path, name, text, mgf):
    """The same ValueError text from all three parsers (the NumPy parser
    prints the gap fraction as the native parser's "%f" does)."""
    p = tmp_path / name
    p.write_text(text)
    res = _parity(p, mgf)
    assert res[0] == "err" and res[1].startswith(f"invalid FASTA file {p}")


def test_differential_fuzz(tmp_path):
    """Random structured FASTA-ish inputs: the three parsers agree on the
    output or all reject with the same text."""
    rng = np.random.default_rng(0)
    seq_alpha = list("ACDEFGHIKLMNPQRSTVWYXZB-")
    ins_alpha = list("acd.z")
    n_ok = 0
    for trial in range(60):
        width = int(rng.integers(3, 15))
        lines = []
        for _ in range(int(rng.integers(1, 6))):
            lines.append(">" + "".join(
                rng.choice(list("abc /1-9"), size=rng.integers(0, 8))))
            w = width
            if rng.random() < 0.15:               # corrupt: ragged length
                w = max(1, width + int(rng.integers(-2, 3)) or width)
            chars = list(rng.choice(seq_alpha, size=w))
            for _ in range(int(rng.integers(0, 4))):   # inserts (removed)
                chars.insert(int(rng.integers(0, len(chars) + 1)),
                             str(rng.choice(ins_alpha)))
            k = int(rng.integers(0, len(chars) + 1)) \
                if rng.random() < 0.4 else len(chars)
            lines.append("".join(chars[:k]))
            if k < len(chars):
                lines.append("".join(chars[k:]))
            if rng.random() < 0.2:
                lines.append("")                       # blank line
        if rng.random() < 0.1:
            lines.insert(0, "LEADINGJUNK")             # data before header
        text = ("\r\n" if rng.random() < 0.3 else "\n").join(lines)
        if rng.random() < 0.5:
            text += "\n"
        p = tmp_path / f"fuzz{trial}.fasta"
        p.write_text(text)
        res = _parity(p, float(rng.choice([0.5, 0.9, 1.0])))
        n_ok += res[0] == "ok"
    assert n_ok >= 5  # the generator produces some valid files


def test_parity_nonascii_and_control_bytes(tmp_path):
    """A Latin-1 byte in a sequence maps to the gap state, a control byte
    at a line edge is trimmed, non-UTF-8 header bytes decode with
    replacement."""
    p = tmp_path / "bytes.fasta"
    p.write_bytes(b">s1 caf\xe9\n"
                  b"\x01ACDEF\xe9KLMN\x02\n"
                  b">s2\n"
                  b"ACDEFGHKLM\n")
    _parity(p, 0.9)
    msa = fasta.read_fasta_alignment(str(p), 0.9, use_native=True)
    assert msa.N == 10 and msa.tokens[0, 5] == 21


def test_parity_trailing_garbage_gzip(tmp_path):
    """A valid gzip member with trailing junk: zlib's tolerant reader
    semantics in both parsers."""
    p = tmp_path / "junk.fasta.gz"
    p.write_bytes(gzip.compress(b">s1\nACDEF\n>s2\nGHKLM\n")
                  + b"\xff\xff\xff\xff")
    assert _parity(p, 0.9)[0] == "ok"


def test_differential_fuzz_arbitrary_bytes(tmp_path):
    """Full-byte-range fuzz (headers and sequences drawn from 1..255)."""
    rng = np.random.default_rng(1)
    n_ok = 0
    for trial in range(40):
        width = int(rng.integers(3, 12))
        parts = []
        for _ in range(int(rng.integers(1, 5))):
            hdr = bytes(rng.integers(0x21, 256, size=int(
                rng.integers(0, 6))).astype(np.uint8).tolist())
            parts.append(b">" + hdr)
            w = width
            if rng.random() < 0.15:               # corrupt: ragged
                w = max(1, width + int(rng.integers(-2, 3)))
            seq = bytes(rng.integers(1, 256, size=w).astype(
                np.uint8).tolist())
            parts.append(seq.replace(b"\n", b"A").replace(b">", b"B"))
        data = b"\n".join(parts) + (b"\n" if rng.random() < 0.5 else b"")
        p = tmp_path / f"bfuzz{trial}.fasta"
        p.write_bytes(data)
        res = _parity(p, float(rng.choice([0.5, 0.9, 1.0])))
        n_ok += res[0] == "ok"
    assert n_ok >= 5


def test_unbuildable_parser(monkeypatch, tmp_path, golden_dir):
    """Where g++ cannot build the parser: use_native=None takes NumPy and
    says so, use_native=True raises with the compiler's output."""
    def no_gxx(name, variants):
        raise RuntimeError("g++ failed to build fasta_native.cpp: "
                           "fatal error: zlib.h: No such file or directory")

    monkeypatch.setattr(_build, "build_host", no_gxx)
    monkeypatch.setattr(native, "_LIBRARY", native._Library())
    path = os.path.join(golden_dir, "small.fasta.gz")
    assert not native.available()
    assert "zlib.h" in native.build_error()
    assert fasta.read_fasta_alignment(path, 0.9).parser == "numpy"
    with pytest.raises(RuntimeError, match="zlib.h"):
        fasta.read_fasta_alignment(path, 0.9, use_native=True)


def test_first_load_races_build_once(monkeypatch):
    """The CLI's prefetch thread and its main thread may both parse first:
    the library is built and loaded once."""
    real = _build.build_host
    calls = []
    gate = threading.Barrier(8)

    def counted(name, variants):
        calls.append(name)
        return real(name, variants)

    monkeypatch.setattr(_build, "build_host", counted)
    lib = native._Library()
    got = []

    def first_use():
        gate.wait(timeout=30)
        got.append(lib.load())

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and got[0] is not None
    assert all(x is got[0] for x in got) and calls == ["fasta_native"]
