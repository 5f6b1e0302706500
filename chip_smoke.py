#!/usr/bin/env python3
"""Drive the PyTorch port (gaussdca_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and
prints no result line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, the TF32 flags as the pipeline sets them;
2. build: both CUDA kernels from ``gaussdca_tpu_torch/csrc`` with nvcc;
3. kernels vs their plain PyTorch versions on the card: row statistics
   (exact equality) at four shapes, per-pair DI at s = 8, 20, 30 on blocks
   from real pipelines (f32 max abs <= 1e-5, f64 <= 1e-10), then the
   median times of kernel and plain version at the main-path shapes;
4. the four golden configs through ``gdca(..., device="cuda")``: f64 with
   the CPU suite's gate (same pair set, rtol 1e-6), f32 with the same pair
   set and max abs error <= 5e-4 (small) / 1e-3 (large);
5. real size: frob with auto-theta at M=32768, N=384, q=21 and DI with
   pc=0.2 at M=1024, N=1000, q=21, seeded synthetic families, end to end
   and by stage (reweight, frequencies, solve, score, rank).

The launch counters are zeroed right before phase 4 and read after phase
5: both kernels must have run on the main path. The line before the last
is the kernel summary JSON; the last line is
``{"ok": true, "device": {...}}``. No CUDA device: exit 1, no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "data")


def log(msg: str) -> None:
    print(msg, flush=True)


def family_tokens(M: int, N: int, q: int, seed: int,
                  mut: float = 0.3) -> np.ndarray:
    """Seeded alignment of M sequences: mutated copies of M // 32
    founders (state q appears, so the alphabet is exactly 1..q)."""
    rng = np.random.default_rng(seed)
    founders = rng.integers(1, q + 1, size=(max(1, M // 32), N),
                            dtype=np.uint8)
    Z = founders[rng.integers(0, founders.shape[0], size=M)]
    hit = rng.random((M, N)) < mut
    Z = np.where(hit, rng.integers(1, q + 1, size=(M, N), dtype=np.uint8), Z)
    Z[0, 0] = q
    return Z.astype(np.uint8)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` in ms (CUDA events), after a
    warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch
    from gaussdca_tpu_torch.api import full_f32_matmuls

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    log(f"[device] nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    with full_f32_matmuls():
        log(f"[device] pipeline TF32 flags: matmul "
            f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
            f"{torch.backends.cudnn.allow_tf32}")


def phase_build():
    from gaussdca_tpu_torch.ops import _build

    for name in ("row_stats", "di_pairs"):
        t0 = time.perf_counter()
        path = _build.build(name)
        _build.library(name)
        log(f"[build] {name}: {time.perf_counter() - t0:.1f} s -> "
            f"{os.path.relpath(path, REPO)}")
        with open(path[:-3] + ".log") as fh:
            for line in fh:
                if "registers" in line or "spill" in line:
                    log(f"[build]   {line.strip()}")


def _covariance(tokens: np.ndarray, q: int, *, pc: float, theta, device):
    """(mJ, C) of an alignment in f64 through the port's own stages."""
    import torch
    from gaussdca_tpu_torch.solve.cholesky import spd_inverse
    from gaussdca_tpu_torch.stats import frequencies, pseudocount, reweight

    Z = torch.as_tensor(tokens, device=device)
    W, _, _ = reweight.compute_weights_streaming(Z, theta, q,
                                                 dtype=torch.float64)
    Pi, Pij, _ = frequencies.weighted_frequencies(Z, W, q,
                                                  dtype=torch.float64)
    C = pseudocount.compute_C(*pseudocount.add_pseudocount(Pi, Pij, pc, q))
    return spd_inverse(C), C


def phase_kernels(dev):
    """Kernel vs plain version on the card; returns the kernel records
    (without launch counts) for the summary line."""
    import torch
    from gaussdca_tpu_torch.io import fasta
    from gaussdca_tpu_torch.ops import di_kernel, distance
    from gaussdca_tpu_torch.score.di import site_cholesky
    from gaussdca_tpu_torch.stats import reweight

    # --- kernel A: exact equality
    err_a = 0.0
    for M, N, q, pad in [(1000, 53, 21, 24), (777, 250, 31, 0),
                         (4096, 384, 21, 0), (32768, 384, 21, 0)]:
        Z = family_tokens(M, N, q, seed=M + N)
        M, N = Z.shape
        if pad:
            Z = np.concatenate([Z, np.zeros((pad, N), np.uint8)])
        Zt = torch.as_tensor(Z, device=dev)
        th_auto = float(reweight.auto_theta_closed_form(Zt, q))
        for theta in (0.0, 0.2, th_auto):
            thresh = float(np.float32(np.floor(theta * N)))
            got = distance.row_stats(Zt, thresh)
            want = distance.row_stats_torch(Zt, thresh)
            torch.cuda.synchronize()
            for g, w, what in zip(got, want, ("rowsum", "below")):
                if not torch.equal(g, w):
                    bad = int((g != w).sum())
                    raise AssertionError(
                        f"row_stats {what} differs from its plain version "
                        f"at M={M} N={N} q={q} thresh={thresh}: {bad} rows")
                err_a = max(err_a, float((g - w).abs().max()))
            if pad and (got[0][-pad:].any() or got[1][-pad:].any()):
                raise AssertionError("token-0 rows must score 0")
        log(f"[kernels] row_stats == plain at M={M} N={N} q={q} "
            f"(+{pad} token-0 rows), theta 0 / 0.2 / auto={th_auto:.4f}")

    # --- kernel B: realistic blocks at s = 8, 20, 30
    large = fasta.remove_duplicate_sequences(fasta.read_fasta_alignment(
        os.path.join(GOLDEN_DIR, "large.fasta.gz"), 0.9))
    q9 = np.where(large.tokens == 21, 9, (large.tokens - 1) % 8 + 1)
    sources = [
        ("large golden, states folded to q=9", q9.astype(np.uint8), 9),
        ("large golden", large.tokens, 21),
        ("synthetic q=31 families", family_tokens(400, 60, 31, seed=31,
                                                  mut=0.15), 31),
    ]
    err_b = {torch.float32: 0.0, torch.float64: 0.0}
    tol = {torch.float32: 1e-5, torch.float64: 1e-10}
    for what, tokens, q in sources:
        mJ, C = _covariance(tokens, q, pc=0.2, theta="auto", device=dev)
        Ls = site_cholesky(C, q).contiguous()
        N = Ls.shape[0]
        iu, ju = (torch.as_tensor(x, device=dev)
                  for x in np.triu_indices(N, k=1))
        for dt in (torch.float64, torch.float32):
            a, b = mJ.to(dt), Ls.to(dt)
            got = di_kernel.di_pairs(a, b, iu, ju)
            want = di_kernel.di_pairs_torch(a, b, iu, ju)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not (np.isfinite(err) and err <= tol[dt]):
                raise AssertionError(
                    f"di_pairs differs from its plain version ({what}, "
                    f"s={q - 1}, {dt}): max abs {err} > {tol[dt]}")
            err_b[dt] = max(err_b[dt], err)
            log(f"[kernels] di_pairs vs plain, {what}: s={q - 1} P={iu.numel()}"
                f" {str(dt)[6:]} max abs {err:.3e} (max DI "
                f"{float(want.max()):.4f})")

    # --- main-path shapes: times (f32 pipeline dtype)
    Z = torch.as_tensor(family_tokens(32768, 384, 21, seed=1), device=dev)
    thresh = float(np.floor(0.2 * Z.shape[1]))
    ms_a = cuda_ms(lambda: distance.row_stats(Z, thresh), reps=5)
    plain_a = cuda_ms(lambda: distance.row_stats_torch(Z, thresh), reps=3)
    log(f"[kernels] row_stats M={Z.shape[0]} N={Z.shape[1]} q=21: kernel "
        f"{ms_a:.3f} ms, plain {plain_a:.3f} ms")
    del Z
    mJ, C = _covariance(family_tokens(1024, 1000, 21, seed=2), 21, pc=0.2,
                        theta=0.2, device=dev)
    Ls = site_cholesky(C, 21).contiguous().float()
    mJ = mJ.float()
    del C
    iu, ju = (torch.as_tensor(x, device=dev)
              for x in np.triu_indices(Ls.shape[0], k=1))
    ms_b = cuda_ms(lambda: di_kernel.di_pairs(mJ, Ls, iu, ju), reps=5)
    plain_b = cuda_ms(lambda: di_kernel.di_pairs_torch(mJ, Ls, iu, ju),
                      reps=3)
    log(f"[kernels] di_pairs N={Ls.shape[0]} s=20 P={iu.numel()} f32: kernel "
        f"{ms_b:.3f} ms, plain {plain_b:.3f} ms")
    return [
        {"name": "row_stats", "route": "cuda",
         "source": "gaussdca_tpu_torch/csrc/row_stats.cu",
         "replaces": "gaussdca_tpu/ops/distance.py:310",
         "max_abs_err": err_a, "ms": ms_a, "plain_ms": plain_a},
        {"name": "di_pairs", "route": "cuda",
         "source": "gaussdca_tpu_torch/csrc/di_pairs.cu",
         "replaces": "gaussdca_tpu/ops/di_kernel.py:80",
         "max_abs_err": err_b[torch.float32], "ms": ms_b,
         "plain_ms": plain_b},
    ]


GOLDEN = [
    ("small frob defaults", "small.fasta.gz", "small.FNRout.txt", {}, 5e-4),
    ("small DI dedup", "small.fasta.gz", "small.DIRout.txt",
     dict(score="DI", pseudocount=0.2, remove_dups=True), 5e-4),
    ("small DI theta0", "small.fasta.gz", "small.DIRout2.txt",
     dict(score="DI", pseudocount=0.2, theta=0.0, max_gap_fraction=0.8,
          min_separation=4), 5e-4),
    ("large DI dedup", "large.fasta.gz", "large.DIRout.txt",
     dict(score="DI", pseudocount=0.2, remove_dups=True), 1e-3),
]


def _load_golden(path):
    out = {}
    with open(path) as fh:
        for line in fh:
            i, j, x = line.split()
            out[(int(i), int(j))] = float(x)
    return out


def phase_golden():
    import torch
    import gaussdca_tpu_torch as g

    for name, fa, gold, kw, f32_tol in GOLDEN:
        want = _load_golden(os.path.join(GOLDEN_DIR, gold))
        keys = sorted(want)
        w = np.array([want[k] for k in keys])
        top = [k for k, _ in sorted(want.items(), key=lambda t: -t[1])]
        for dt in (torch.float64, torch.float32):
            t0 = time.perf_counter()
            r = g.gdca(os.path.join(GOLDEN_DIR, fa), dtype=dt,
                       device="cuda", **kw)
            wall = time.perf_counter() - t0
            got = {(i, j): x for i, j, x in r.ranking}
            if set(got) != set(want):
                raise AssertionError(f"golden {name} {dt}: pair sets differ")
            gv = np.array([got[k] for k in keys])
            err = float(np.max(np.abs(gv - w)))
            if dt == torch.float64:
                ok = np.allclose(gv, w, rtol=1e-6, atol=1e-12)
                gate = "rtol 1e-6"
            else:
                ok = err <= f32_tol
                gate = f"max abs <= {f32_tol:g}"
            ranked = [(i, j) for i, j, _ in r.ranking]
            overlap = [len(set(ranked[:k]) & set(top[:k])) for k in (10, 100)]
            log(f"[golden] {name} {str(dt)[6:]}: max abs err {err:.3e} "
                f"({gate}: {'PASS' if ok else 'FAIL'}), top-10 overlap "
                f"{overlap[0]}/10, top-100 {overlap[1]}/100, {wall:.2f} s")
            if not ok:
                raise AssertionError(f"golden {name} {dt} failed its gate")


def phase_real_size(dev):
    import torch
    from gaussdca_tpu_torch import api
    from gaussdca_tpu_torch.core.config import GDCAConfig
    from gaussdca_tpu_torch.interop import msa_from_arrays

    runs = [
        ("frob auto-theta M=32768 N=384 q=21", 32768, 384,
         dict(score="frob", pseudocount=0.8, theta="auto")),
        ("DI pc=0.2 theta=0.2 M=1024 N=1000 q=21", 1024, 1000,
         dict(score="DI", pseudocount=0.2, theta=0.2)),
    ]
    for name, M, N, kw in runs:
        tokens = family_tokens(M, N, 21, seed=M + N)
        M, N = tokens.shape
        msa = msa_from_arrays(tokens, 21, [str(i) for i in range(M)])
        cfg = GDCAConfig(device="cuda", dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = api.gdca_from_msa(msa, cfg)
        e2e = time.perf_counter() - t0
        npairs = (N - 5) * (N - 4) // 2
        if len(r) != npairs or not all(np.isfinite(x) for _, _, x in r):
            raise AssertionError(f"{name}: ranking is not {npairs} finite "
                                 "pairs")
        # the same pipeline again, synchronized after every stage
        stamps = [("start", time.perf_counter())]

        def mark(stage):
            torch.cuda.synchronize()
            stamps.append((stage, time.perf_counter()))

        torch.cuda.reset_peak_memory_stats()
        Z = torch.as_tensor(tokens, device=dev)
        with api.full_f32_matmuls():
            S, _, _ = api.scores_pipeline(Z, 21, cfg, mark=mark)
        api._checked_ranking(S.cpu().numpy(), cfg.min_separation)
        stamps.append(("rank", time.perf_counter()))
        stages = ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                           for a, b in zip(stamps, stamps[1:]))
        log(f"[real] {name}: end to end {e2e:.3f} s (theta {r.theta:.4f}, "
            f"Meff {r.meff:.1f}, {len(r)} pairs, top {r[0]}); stages (s): "
            f"{stages}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "gaussdca_tpu_torch")):
        log("chip_smoke: gaussdca_tpu_torch/ is not beside this script")
        return 1
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False — this check "
            "runs only on a CUDA device")
        return 1
    from gaussdca_tpu_torch.ops import di_kernel, distance

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    kernels = phase_kernels(dev)

    distance.row_stats.launches = 0
    di_kernel.di_pairs.launches = 0
    phase_golden()
    phase_real_size(dev)
    launches = {"row_stats": distance.row_stats.launches,
                "di_pairs": di_kernel.di_pairs.launches}
    log(f"[main path] kernel launches: {launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"kernel {k['name']} never ran on the "
                                 "main path")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
