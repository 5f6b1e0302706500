"""PyTorch port: package boundaries.

The port imports neither JAX nor the JAX package, never needs nvcc on a
CPU run, and reaches its kernels' plain versions (with the launch counters
untouched) when its tensors lie on the CPU.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import gaussdca_tpu_torch
from gaussdca_tpu_torch import api as tapi
from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.interop import msa_from_arrays
from gaussdca_tpu_torch.ops import _build
from gaussdca_tpu_torch.ops import di_kernel, distance

PKG = os.path.dirname(gaussdca_tpu_torch.__file__)
REPO = os.path.dirname(PKG)
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|gaussdca_tpu)\b",
                        re.M)


# the JAX package's examples, which the port's own do not import either
_JAX_EXAMPLES = re.compile(
    r"^\s*(import|from)\s+(recover_contacts|multichip)\b", re.M)


def _port_sources():
    """The package, ``chip_smoke.py`` and ``examples/*_torch.py``."""
    for root, _, files in os.walk(PKG):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")
    examples = os.path.join(REPO, "examples")
    yield from (os.path.join(examples, f) for f in sorted(os.listdir(examples))
                if f.endswith("_torch.py"))


def test_source_imports_no_jax():
    sources = list(_port_sources())
    assert {"chip_smoke.py", "recover_contacts_torch.py",
            "multichip_torch.py"} <= {os.path.basename(p) for p in sources}
    offenders = [os.path.relpath(path, REPO) for path in sources
                 if _FORBIDDEN.search(open(path).read())
                 or _JAX_EXAMPLES.search(open(path).read())]
    assert offenders == []


def test_import_and_cpu_run_load_no_jax():
    """Not even indirectly: a fresh interpreter runs the port on the CPU,
    on one device and on a mesh, and ends with neither JAX nor the JAX
    package loaded."""
    code = (
        "import sys, numpy as np, torch\n"
        "import gaussdca_tpu_torch as g\n"
        "from gaussdca_tpu_torch.interop import msa_from_arrays\n"
        "rng = np.random.default_rng(0)\n"
        "Z = rng.integers(1, 5, size=(30, 12), dtype=np.uint8)\n"
        "msa = msa_from_arrays(Z, 4, [str(i) for i in range(30)])\n"
        "from gaussdca_tpu_torch.parallel.mesh import Mesh\n"
        "mesh = Mesh(['cpu'] * 4, (2, 2))\n"
        "for score in ('frob', 'DI'):\n"
        "    cfg = g.GDCAConfig(score=score, device='cpu', solve_min_dim=8)\n"
        "    g.gdca_from_msa(msa, cfg)\n"
        "    g.gdca_from_msa(msa, cfg, mesh=mesh)\n"
        "g.gdca_from_msa(msa, cfg, top_k=5)\n"
        "from gaussdca_tpu_torch.ops import distance\n"
        "from gaussdca_tpu_torch.stats import reweight\n"
        "Zt = torch.as_tensor(Z)\n"
        "reweight.compute_weights(Zt, 'auto', q=4)\n"
        "distance.row_stats_asym(Zt, 3.0)\n"
        "distance.row_stats_full(Zt, 3.0)\n"
        "distance.row_stats_sym_e8(Zt, 3.0, 4)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'gaussdca_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _small_msa():
    rng = np.random.default_rng(4)
    Z = rng.integers(1, 8, size=(40, 14), dtype=np.uint8)
    Z[1:10] = Z[0]
    return msa_from_arrays(Z, 7, [f"s{i}" for i in range(40)])


@pytest.mark.parametrize("score", ["frob", "DI"])
def test_cpu_run_takes_plain_versions_without_nvcc(monkeypatch, score):
    def no_compiler(*args, **kwargs):
        raise AssertionError("a CPU run must not build CUDA kernels")

    monkeypatch.setattr(subprocess, "run", no_compiler)
    monkeypatch.setattr(_build, "build", no_compiler)
    calls = []
    for mod, name in ((distance, "row_stats_torch"),
                      (di_kernel, "di_pairs_torch")):
        plain = getattr(mod, name)

        def spy(*a, _plain=plain, _name=name, **k):
            calls.append(_name)
            return _plain(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    before = (distance.row_stats.launches, di_kernel.di_pairs.launches)

    r = tapi.gdca_from_msa(_small_msa(), GDCAConfig(
        score=score, pseudocount=0.5, dtype=torch.float64, device="cpu"))

    assert len(r) == (14 - 5) * (14 - 4) // 2
    assert all(np.isfinite(x) for _, _, x in r.ranking)
    assert (distance.row_stats.launches, di_kernel.di_pairs.launches) \
        == before == (0, 0)
    assert "row_stats_torch" in calls
    assert ("di_pairs_torch" in calls) == (score == "DI")


def test_pipeline_restores_tf32_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with tapi.full_f32_matmuls():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("name,call", [
    ("match_counts", lambda Z: distance.match_counts(Z)),
    ("row_stats_asym", lambda Z: distance.row_stats_asym(Z, 4.0)),
    ("row_stats_sym_e8", lambda Z: distance.row_stats_sym_e8(Z, 4.0, 7)),
])
def test_new_kernels_take_plain_versions_on_the_cpu(monkeypatch, name,
                                                    call):
    """Kernels D, E and F on a CPU tensor: no build, no launch."""
    def no_compiler(*args, **kwargs):
        raise AssertionError("a CPU tensor must not build CUDA kernels")

    monkeypatch.setattr(_build, "build", no_compiler)
    wrapper = getattr(distance, name)
    before = wrapper.launches
    Z = torch.as_tensor(_small_msa().tokens)
    out = call(Z)
    assert wrapper.launches == before == 0
    assert all(torch.isfinite(x.float()).all()
               for x in (out if isinstance(out, tuple) else (out,)))


def test_build_is_keyed_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    """The library name follows the source's content, and a machine
    without nvcc gets a clear error instead of a fallback."""
    a = _build.library_path("row_stats")
    b = _build.library_path("di_pairs")
    assert a != b and a.startswith(_build.BUILD_DIR)
    names = ("row_stats", "row_stats_rect", "di_pairs", "match_counts",
             "row_stats_asym", "row_stats_e8")
    assert len({_build.library_path(n) for n in names}) == len(names)
    assert a == _build.library_path("row_stats")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(os.path, "isfile",
                        lambda p: False if p.endswith("nvcc") else True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
