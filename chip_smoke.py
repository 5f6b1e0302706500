#!/usr/bin/env python3
"""Drive the PyTorch port (gaussdca_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and
prints no result line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, the TF32 flags as the pipeline sets them;
2. build: the six CUDA kernels from ``gaussdca_tpu_torch/csrc`` with
   nvcc, one compiler process each, all started together; then the
   ranking sorted on the card: ``compute_ranking`` of a CUDA tensor equal
   to that of the same S as an ndarray (the host sort), order and sign
   bits included, on tied scores and on zeros of both signs at N = 7,
   50, 300 and 1000 (the card's small and large sorts) in f32 and f64,
   a NaN refused, and both timed at the cells' widths (host wall,
   median of 5); then the one-device solve (``phase_solve``):
   ``spd_inverse`` against the solve it replaced (cuSOLVER's potrf and
   potrs on an identity, one Newton step) at Ns = 7,680 and 20,000, and
   alone at 60,000, each timed with CUDA events beside its peak memory,
   and each inverse row-major, exactly symmetric and within 1e-3 of C^-1
   on a probe vector;
3. kernels vs their plain PyTorch versions on the card: row statistics
   (kernel A, exact equality) at four shapes of tokens 1..31, each at
   q = 9, 21 and 31 (tokens above q match nothing); rectangular row
   statistics (kernel C, exact) at the same shapes and q, on a row block
   at a row offset (with token-0 pad rows), an unrelated A of 333 rows and
   a B of 70 rows, and C on (Z, Z) equal to kernel A at every q; per-pair
   DI (kernel B) at
   s = 8, 20, 30 on blocks from real pipelines, on the whole coupling
   matrix and on a row slab (f32 max abs <= 1e-5, f64 <= 1e-10, the slab
   bitwise equal to the whole), the same at a full and a ragged s of
   every padded size the kernel dispatches on (``DI_SWEEP``), and at
   the DI family's N=1000, s=20 on the whole matrix and on each shard's
   row slab and anchored pairs of the 4-shard mesh (f32 <= 1e-5); the
   dense counts (kernel D), the grouped-row row statistics (kernel E)
   and the one-hot-plane row statistics on the int8 tensor cores
   (kernel F), each equal to its plain version and to kernel A at five
   shapes (ragged M, token-0 pad rows, q = 21 / 29 / 31, for E a width
   where its plan groups k >= 2 row tiles and one where it has no plan;
   D, E and F also on tokens 1..31 at q = 9, 21 and 31, D's rows and E
   and F equal to kernel A's),
   then at the main shape M=32768, N=384 (E and F equal to their plain
   versions and to kernel A on tokens 1..31 at q = 9, 21 and 31; at q=21
   D's row sums and neighbour counts equal to kernel A's, and D equal to
   the one-hot ``torch.matmul`` in f32 and to ``torch._int_mm`` on the
   int8 one-hot, its two library calls); then the median times of kernel
   and plain version at the main-path shapes;
4. single device: the four golden configs through ``gdca(...,
   device="cuda")``, f64 with the CPU suite's gate (same pair set, rtol
   1e-6), f32 with the same pair set and max abs error <= 5e-4 (small) /
   1e-3 (large); then real size: frob with auto-theta at M=32768, N=384,
   q=21 and DI with pc=0.2 at M=1024, N=1000, q=21, seeded synthetic
   families, end to end and by stage (the spans of a traced run,
   ``utils.log.tracing()``: each stage's host wall and stream time);
5. mesh: the same golden configs and real-size families through
   ``gdca(..., mesh=...)`` on four shards of cuda:0 (a 2x2 mesh); the DI
   family (Ns = 20000) takes the storage-sharded solve and the slab-local
   DI. Each real-size mesh run is held against the single-device run of
   the same call (same pair set, finite, max abs difference <= 1e-5 frob
   / 2e-4 DI, top-100 overlap >= 95). With
   more than one card, the families run once more, one shard per card;
6. ``top_k``: the small frob golden through ``gdca(..., top_k=100)``
   gives the head of the full ranking of phase 4; then ``recover``, the
   method's own check at real size: ``examples/recover_contacts_torch.py``
   plants 16 covarying pairs (copy probability 0.9, q = 21) in a frob
   family of 32768x384 and a DI family of 1024x1000 and runs
   ``gdca_from_msa`` at theta 0.2 in f32; every planted pair must be in
   the top 16;
7. the other distance kernels at the main shape, M=32768, N=384, q=21,
   each as the distance pass a caller of the weight functions picks
   (``compute_weights_streaming(..., row_stats_fn=...)`` with
   ``row_stats_asym`` (E), ``row_stats_full`` (C on (Z, Z)) and
   ``row_stats_sym_e8`` (F), and the dense ``compute_weights`` on
   ``match_counts`` (D)), in f32 and f64: W, Meff and theta equal to
   kernel A's.

8. the batch front end, ``python -m gaussdca_tpu_torch`` run in this
   process as ``cli.main([...])`` with stderr captured: gzipped FASTA
   files of the two real-size families, the auto-theta frob cell of
   ``bench.py`` (M=100,000, N=200) and an ingest-only 100,000x400 file;
   native and NumPy parse times (the same tokens); kernel A at
   M=100,000 against its plain version (and the weights from each); then
   the paths ``cli`` (a frob batch of the small golden and the two frob
   families with ``--merge-output``, and the DI family, with
   ``--cache-dir``: each output against ``gdca_from_msa`` of the same
   parsed MSA within rel 1e-6, the small one against its golden file),
   ``cli cached`` (the same batches again: every record cached, the
   outputs byte-identical, no kernel launched), ``cli no-prefetch`` (the
   batches parsed in turn: byte-identical outputs), ``cli mesh`` (``--mesh
   1,1``, within 1e-5 of ``cli``), ``cli top_k`` (``--top-k 100``, the
   head of the ranking) and ``cli profile`` (``--profile-dir``: the trace
   names kernel A); then family mode, two processes of the port's
   ``podspawn`` on cuda:0 with ``--distributed --merge-output``, whose
   part files hold the merged file's lines; then the pod (``cli pod``):
   two processes on cuda:0 with ``--distributed --mesh 2,2`` (two shards
   a process, gloo staging through host buffers) run the frob and DI
   batches as one sharded program, process 0's outputs within 1e-5 frob /
   2e-4 DI of the ``cli`` run's and of the one-process 2x2 mesh's (the
   small golden family within its f32 golden envelope; the 32768x384 frob
   family and the DI family take
   the storage-sharded solve, the deep one the replicated solve computed
   once and broadcast), process 1 writing nothing, and again from the
   cache (``cli pod cached``); each process prints its families'
   ``pipeline`` walls, its batch walls, its peak device memory, and the
   DI family through ``sharded_scores`` twice more, untraced and under
   ``utils.log.tracing()``: both walls, the host time and bytes of the
   ``collective`` spans (the ``torch.distributed`` calls alone) from the
   counters, and each stage's host wall, stream time and host time
   inside its collectives, from the spans.

The launch counters are zeroed right before each path of phases 4-8 and
read after it; each path fails if a kernel of it never ran (A and B in 4,
C and B in 5, A in 6's ``top_k`` and A and B in its ``recover``, E, C,
F and D in the four paths of 7, where kernel A must not run, and A, B,
C as named in 8, where the pod runs C and B and not A, and its cached
rerun nothing); family mode and the pod sum the two processes' counts.
The line before the last is the kernel summary JSON; the last line is
``{"ok": true, "device": {...}}``. No CUDA device: exit 1, no result.
"""

from __future__ import annotations

import concurrent.futures
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
    from gaussdca_tpu_torch.core.runtime import full_f32_matmuls

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


KERNELS = ("row_stats", "row_stats_rect", "di_pairs", "match_counts",
           "row_stats_asym", "row_stats_e8")
# kernel A's state counts checked at every shape; 31 (every state) last
A_STATES = (9, 21, 31)
# kernel B's s values: a full and a ragged s for each padded size S =
# 4, 8, ..., 32 that the kernel dispatches on (s = 1 too)
DI_SWEEP = (1, 3, 4, 6, 8, 10, 12, 13, 16, 19, 20, 21, 24, 27, 28, 29, 30)

# peak rates of one H100 SXM (NVIDIA's data sheet, dense) for the bounds
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12
F32_FLOPS_S = 67e12
# the popcount pipe: 16 a clock on each of 132 SMs at 1.98 GHz
POPC_WORDS_S = 16 * 132 * 1.98e9


# the ranking's check widths (the card's small and large sorts) and the
# benchmark cells' widths for its timing
RANK_N = (7, 50, 300, 1000)
RANK_TIMED = (1000, 384, 200)


def _rank_scores(kind: str, N: int, rng) -> np.ndarray:
    """``ties``: five values; ``zeros``: zeros of both signs among a few
    +-1; ``random``: no ties."""
    if kind == "ties":
        return rng.integers(-2, 3, size=(N, N)) / 2.0
    if kind == "zeros":
        S = np.where(rng.random((N, N)) < 0.5, -0.0, 0.0)
        S[rng.random((N, N)) < 0.1] = 1.0
        S[rng.random((N, N)) < 0.1] = -1.0
        return S
    return rng.random((N, N))


def phase_rank(dev):
    """``compute_ranking`` of a tensor on the card against the host sort
    of the same S; then the two timed."""
    import math

    import torch
    from gaussdca_tpu_torch import api
    from gaussdca_tpu_torch.score.rank import compute_ranking

    def signed(R):
        return [(i, j, x, math.copysign(1.0, x)) for i, j, x in R]

    rng = np.random.default_rng(15)
    for N in RANK_N:
        for kind in ("ties", "zeros", "random"):
            for dt in (np.float32, np.float64):
                S = _rank_scores(kind, N, rng).astype(dt)
                for m in (0, 5):
                    got = compute_ranking(torch.as_tensor(S, device=dev), m)
                    if signed(got) != signed(compute_ranking(S, m)):
                        raise AssertionError(
                            f"rank: N={N} {kind} {dt.__name__} m={m}: the "
                            "card's ranking differs from the host sort's")
    S = torch.rand(300, 300, device=dev)
    S[200, 3] = float("nan")
    try:
        api._checked_ranking(S, 5)
    except ArithmeticError:
        pass
    else:
        raise AssertionError("rank: a NaN score was ranked")
    log(f"[rank] card == host sort (order, sign bits) at N = {RANK_N}, "
        "ties, zeros of both signs, random, f32 and f64; a NaN refused")

    def wall(fn):
        fn()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    for N in RANK_TIMED:
        S = _rank_scores("random", N, rng).astype(np.float32)
        T = torch.as_tensor(S, device=dev)
        card = wall(lambda: compute_ranking(T, 5))
        host = wall(lambda: compute_ranking(T.cpu().numpy(), 5))
        log(f"[rank] N={N}, {(N - 5) * (N - 4) // 2} pairs, f32: on the card "
            f"{card:.4f} s, copy and host sort {host:.4f} s (host wall, "
            "median of 5)")


# the one-device solve's widths: frob-mid's and the DI cells' Ns, then the
# N = 3000 DI family's, timed on the new solve alone
SOLVE_NS = (7680, 20000)
SOLVE_ALONE_NS = (60000,)


def _spd_matrix(n: int, dev, seed: int):
    """A seeded f32 SPD matrix, G G^T / k + I / 2 with G [n, k], k = 4096:
    no n^3 product to make it and no second n x n buffer."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn((n, 4096), generator=gen, device=dev)
    C = torch.mm(G, G.T).div_(4096)
    C.diagonal().add_(0.5)
    return C


def phase_solve(dev):
    """The one-device solve: ``spd_inverse`` (no Newton step) against the
    solve it replaced (cuSOLVER's potrf and potrs on an identity, then one
    Newton step through ``newton_refine``) at ``SOLVE_NS``, each timed
    with CUDA events (median of 3) with its peak memory beside C; then
    ``spd_inverse`` alone at ``SOLVE_ALONE_NS``. Fails on a strided or
    asymmetric inverse, or on one that misses C^-1 (C v) = v by more than
    1e-3 of v."""
    import torch
    from gaussdca_tpu_torch.core.runtime import full_f32_matmuls
    from gaussdca_tpu_torch.solve.cholesky import newton_refine, spd_inverse

    def replaced(C):
        S = newton_refine(C, torch.cholesky_inverse(
            torch.linalg.cholesky(C)), 1)
        return S if S.is_contiguous() else S.T.contiguous()

    def measure(name, fn, C, reps):
        n = C.shape[0]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        X = fn(C)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        if not X.is_contiguous() or not torch.equal(X, X.T):
            raise AssertionError(f"solve: {name} at Ns={n} gave a strided "
                                 "or asymmetric inverse")
        v = torch.randn(n, 1, device=dev, dtype=C.dtype)
        err = float((X @ (C @ v) - v).abs().max() / v.abs().max())
        if err > 1e-3:
            raise AssertionError(f"solve: {name} at Ns={n}: C^-1 (C v) "
                                 f"misses v by {err:.3e}")
        del X
        ms = cuda_ms(lambda: fn(C), reps)
        log(f"[solve] Ns={n} {name}: {ms:.2f} ms (CUDA events, median of "
            f"{reps}), {n ** 3 / ms / 1e9:.2f} TFLOP/s of Ns^3; peak beside "
            f"C {peak / 2 ** 30:.3f} GiB ({peak / (4 * n * n):.2f} Ns^2 "
            f"buffers); C^-1 (C v) - v {err:.2e} of v")
        torch.cuda.empty_cache()

    with full_f32_matmuls():
        for n in SOLVE_NS + SOLVE_ALONE_NS:
            C = _spd_matrix(n, dev, seed=n)
            if n in SOLVE_NS:
                measure("replaced: potrf, potrs, 1 Newton step", replaced,
                        C, 3)
            measure("spd_inverse", spd_inverse, C, 3)
            del C
            torch.cuda.empty_cache()


def bound(nbytes: float, ops: float, rate: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_build():
    from gaussdca_tpu_torch.ops import _build

    def build(name):
        t0 = time.perf_counter()
        return _build.build(name), time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(build, KERNELS))
    for name, (path, secs) in zip(KERNELS, built):
        _build.library(name)
        log(f"[build] {name}: {secs:.1f} s -> "
            f"{os.path.relpath(path, REPO)}")
        kernel = "?"
        with open(path[:-3] + ".log") as fh:
            for line in fh:
                if "Compiling entry function" in line:
                    kernel = line.split("'")[1]    # ptxas's mangled name
                elif "registers" in line or "spill" in line:
                    log(f"[build]   {kernel}: {line.split(':', 1)[-1].strip()}")


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


def _rect_check(ZA, ZB, thresh, q, what):
    """Kernel C equal to its plain version at states 1..q; returns the
    result and the max abs error."""
    import torch
    from gaussdca_tpu_torch.ops import distance

    got = distance.row_stats_rect(ZA, ZB, thresh, q=q)
    want = distance.row_stats_rect_torch(ZA, ZB, thresh, q=q)
    torch.cuda.synchronize()
    err = 0.0
    for g, w, name in zip(got, want, ("rowsum", "below")):
        if not torch.equal(g, w):
            raise AssertionError(
                f"row_stats_rect {name} differs from its plain version "
                f"({what}, q={q}, thresh={thresh}): {int((g != w).sum())} "
                "rows")
        err = max(err, float((g - w).abs().max()))
    return got, err


def phase_kernels(dev):
    """Kernel vs plain version on the card; returns the kernel records
    (without launch counts) for the summary line."""
    import torch
    from gaussdca_tpu_torch.io import fasta
    from gaussdca_tpu_torch.ops import di_kernel, distance
    from gaussdca_tpu_torch.parallel.sharded import _pair_assignment
    from gaussdca_tpu_torch.score.di import ns_iters, site_cholesky
    from gaussdca_tpu_torch.stats import reweight
    from gaussdca_tpu_torch.utils.flops import di_pair_flops

    # --- kernel A: exact equality; kernel C on row blocks of the same Z;
    # tokens 1..31, so that tokens above q occur at q = 9 and 21
    err_a = err_c = 0.0
    for M, N, q, pad, rows in [(1000, 53, 31, 24, (100, 1024)),
                               (777, 250, 31, 0, None),
                               (4096, 384, 31, 0, (1024, 2048)),
                               (32768, 384, 31, 0, (8192, 16384))]:
        Z = family_tokens(M, N, q, seed=M + N)
        M, N = Z.shape
        if pad:
            Z = np.concatenate([Z, np.zeros((pad, N), np.uint8)])
        Zt = torch.as_tensor(Z, device=dev)
        # a row block of Z (here with the pad rows), or, at 777 x 250,
        # an unrelated A with Ma = 333 (not a multiple of 128)
        ZA = (Zt[rows[0]:rows[1]] if rows else torch.as_tensor(
            family_tokens(333, N, q, seed=5), device=dev))
        th_auto = float(reweight.auto_theta_closed_form(Zt, q))
        for theta in (0.0, 0.2, th_auto):
            thresh = float(np.float32(np.floor(theta * N)))
            # the state loop at q = 9 (tokens above it match nothing), 21
            # and 31 (every state)
            for qk in A_STATES:
                got = distance.row_stats(Zt, thresh, qk)
                want = distance.row_stats_torch(Zt, thresh, qk)
                torch.cuda.synchronize()
                for g, w, what in zip(got, want, ("rowsum", "below")):
                    if not torch.equal(g, w):
                        bad = int((g != w).sum())
                        raise AssertionError(
                            f"row_stats {what} differs from its plain "
                            f"version at M={M} N={N} tokens 1..{q} q={qk} "
                            f"thresh={thresh}: {bad} rows")
                    err_a = max(err_a, float((g - w).abs().max()))
                if pad and (got[0][-pad:].any() or got[1][-pad:].any()):
                    raise AssertionError("token-0 rows must score 0")
                # kernel C at the same q: the row block, and at M = 1000
                # a B of 70 rows (one B tile, mostly padding)
                rect, err = _rect_check(
                    ZA, Zt, thresh, qk,
                    f"Ma={ZA.shape[0]} Mb={Zt.shape[0]} N={N}")
                err_c = max(err_c, err)
                if pad and (rect[0][-pad:].any() or rect[1][-pad:].any()):
                    raise AssertionError("token-0 rows must score 0 (rect)")
                if M == 1000:
                    err_c = max(err_c, _rect_check(
                        Zt[:50], Zt[900:970], thresh, qk,
                        f"Ma=50 Mb=70 N={N}")[1])
                # the B4 contract: full-grid rect on (Z, Z) is kernel A
                full = distance.row_stats_full(Zt, thresh, qk)
                if not all(torch.equal(x, y) for x, y in zip(full, got)):
                    raise AssertionError(
                        f"row_stats_rect(Z, Z) != row_stats(Z) at M={M} "
                        f"N={N} q={qk}")
        log(f"[kernels] row_stats == plain at M={M} N={N} tokens 1..{q} "
            f"(+{pad} token-0 rows), q {' / '.join(map(str, A_STATES))}, "
            f"theta 0 / 0.2 / auto={th_auto:.4f}; at each q "
            f"row_stats_rect == plain at Ma={ZA.shape[0]} "
            f"({'rows %d:%d' % rows if rows else 'unrelated A'}"
            f"{', and Ma=50 vs Mb=70' if M == 1000 else ''}), "
            "and == row_stats on (Z, Z)")

    # --- kernel B: realistic blocks at s = 8, 20, 30, whole and slab
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
        s = q - 1
        iu, ju = (torch.as_tensor(x, device=dev)
                  for x in np.triu_indices(N, k=1))
        # a row slab of sites [r0, r1) and every pair anchored there, with
        # the other site below or above it, as the slab-local DI reads them
        r0, r1 = N // 4, N // 2
        si_np = np.repeat(np.arange(r0, r1), N)
        sj_np = np.tile(np.arange(N), r1 - r0)
        keep = si_np != sj_np
        si, sj = (torch.as_tensor(x[keep], device=dev)
                  for x in (si_np, sj_np))
        for dt in (torch.float64, torch.float32):
            a, b = mJ.to(dt), Ls.to(dt)
            slab = a[r0 * s:r1 * s]
            for name, args, kw in (
                    ("whole", (a, b, iu, ju), {}),
                    (f"slab {r0}:{r1}", (slab, b, si, sj), {"row0": r0})):
                got = di_kernel.di_pairs(*args, **kw)
                want = di_kernel.di_pairs_torch(*args, **kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not (np.isfinite(err) and err <= tol[dt]):
                    raise AssertionError(
                        f"di_pairs differs from its plain version ({what},"
                        f" {name}, s={s}, {dt}): max abs {err} > {tol[dt]}")
                err_b[dt] = max(err_b[dt], err)
                log(f"[kernels] di_pairs vs plain, {what}, {name}: s={s} "
                    f"P={args[2].numel()} {str(dt)[6:]} max abs {err:.3e} "
                    f"(max DI {float(want.max()):.4f})")
            # the slab call reads the same values as the whole-matrix call
            whole = di_kernel.di_pairs(a, b, si, sj)
            if not torch.equal(whole, di_kernel.di_pairs(slab, b, si, sj,
                                                         row0=r0)):
                raise AssertionError("di_pairs on a slab != on the whole "
                                     f"matrix ({what}, {dt})")

    # --- kernel B: every padded size S (s rounded up to a multiple of 4)
    # the kernel dispatches on, at a full and a ragged s each, small P
    for s in DI_SWEEP:
        q = s + 1
        mJ, C = _covariance(family_tokens(240, 24, q, seed=100 + s), q,
                            pc=0.2, theta="auto", device=dev)
        Ls = site_cholesky(C, q).contiguous()
        N = Ls.shape[0]
        iu, ju = (torch.as_tensor(x, device=dev)
                  for x in np.triu_indices(N, k=1))
        r0, r1 = N // 3, N // 3 + 5
        si = torch.arange(r0, r1, device=dev).repeat_interleave(N)
        sj = torch.arange(N, device=dev).repeat(r1 - r0)
        keep = si != sj
        si, sj = si[keep], sj[keep]
        errs = []
        for dt in (torch.float64, torch.float32):
            a, b = mJ.to(dt), Ls.to(dt)
            slab = a[r0 * s:r1 * s]
            for args, kw in (((a, b, iu, ju), {}),
                             ((slab, b, si, sj), {"row0": r0})):
                got = di_kernel.di_pairs(*args, **kw)
                want = di_kernel.di_pairs_torch(*args, **kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not (np.isfinite(err) and err <= tol[dt]):
                    raise AssertionError(
                        f"di_pairs differs from its plain version at s={s} "
                        f"({'slab' if kw else 'whole'}, {dt}): max abs "
                        f"{err} > {tol[dt]}")
                err_b[dt] = max(err_b[dt], err)
                errs.append(err)
            if not torch.equal(di_kernel.di_pairs(a, b, si, sj),
                               di_kernel.di_pairs(slab, b, si, sj, row0=r0)):
                raise AssertionError("di_pairs on a slab != on the whole "
                                     f"matrix (s={s}, {dt})")
        log(f"[kernels] di_pairs vs plain at s={s} (S={-(-s // 4) * 4}), "
            f"N={N}: whole / slab max abs f64 {errs[0]:.2e} / "
            f"{errs[1]:.2e}, f32 {errs[2]:.2e} / {errs[3]:.2e}; slab == "
            "whole")

    # --- main-path shapes: times (f32 pipeline dtype)
    Z = torch.as_tensor(family_tokens(32768, 384, 21, seed=1), device=dev)
    M, N = Z.shape
    thresh = float(np.floor(0.2 * N))
    ms_a = cuda_ms(lambda: distance.row_stats(Z, thresh), reps=5)
    plain_a = cuda_ms(lambda: distance.row_stats_torch(Z, thresh), reps=3)
    # kernel A: M^2 Np q int8 operations (the half grid of the JAX sym
    # kernel's count); reads Z once, writes two [M] results
    bound_a = bound(M * N + 8 * M, M * M * N * 21, INT8_OPS_S)
    log(f"[kernels] row_stats M={M} N={N} q=21: kernel "
        f"{ms_a:.3f} ms, plain {plain_a:.3f} ms; bound {bound_a[0]:.2f} ms"
        f" ({bound_a[1]}), popcount-pipe bound "
        f"{M * M / 2 * N / 4 / POPC_WORDS_S * 1e3:.2f} ms")
    # the full-grid square kernel (row_stats_pallas' port) is kernel C
    # on (Z, Z): twice kernel A's pairs
    ms_full = cuda_ms(lambda: distance.row_stats_full(Z, thresh, 21),
                      reps=3)
    plain_full = cuda_ms(
        lambda: distance.row_stats_rect_torch(Z, Z, thresh, q=21), reps=3)
    bound_full = bound(M * N + 8 * M, 2 * M * M * N * 21, INT8_OPS_S)
    log(f"[kernels] row_stats_full M={M} N={N} q=21: kernel "
        f"{ms_full:.3f} ms, plain {plain_full:.3f} ms; bound "
        f"{bound_full[0]:.2f} ms "
        f"({bound_full[1]}), popcount-pipe bound "
        f"{M * M * N / 4 / POPC_WORDS_S * 1e3:.2f} ms")
    # kernel C at one shard of the 4-shard main path: 8192 rows vs all
    ZA = Z[8192:16384]
    Ma = ZA.shape[0]
    ms_c = cuda_ms(lambda: distance.row_stats_rect(ZA, Z, thresh, q=21),
                   reps=5)
    plain_c = cuda_ms(
        lambda: distance.row_stats_rect_torch(ZA, Z, thresh, q=21), reps=3)
    bound_c = bound((Ma + M) * N + 8 * Ma, 2 * Ma * M * N * 21, INT8_OPS_S)
    log(f"[kernels] row_stats_rect Ma={Ma} Mb={M} N={N} q=21: kernel "
        f"{ms_c:.3f} ms, plain {plain_c:.3f} ms; bound {bound_c[0]:.2f} ms"
        f" ({bound_c[1]}), popcount-pipe bound "
        f"{Ma * M * N / 4 / POPC_WORDS_S * 1e3:.2f} ms")
    del Z, ZA
    mJ, C = _covariance(family_tokens(1024, 1000, 21, seed=2), 21, pc=0.2,
                        theta=0.2, device=dev)
    Ls = site_cholesky(C, 21).contiguous().float()
    mJ = mJ.float()
    del C
    # the solve hands mJ on row-major: di_pairs reads it with no copy
    if not mJ.is_contiguous():
        raise AssertionError(f"spd_inverse gave a strided mJ "
                             f"{tuple(mJ.stride())}: di_pairs would copy it")
    N, s = Ls.shape[0], 20
    iu, ju = (torch.as_tensor(x, device=dev)
              for x in np.triu_indices(N, k=1))
    P = iu.numel()
    # the main paths' own calls at this shape, each against its plain
    # version: the whole matrix (one device), then every shard's row slab
    # of a 4-shard mesh with the pairs anchored there (the last slab too)
    nloc, assign = _pair_assignment(N, 4)
    calls = [("whole matrix", (mJ, Ls, iu, ju), {})]
    for d, (a, o, _, _) in enumerate(assign):
        calls.append((f"shard {d} slab, sites {d * nloc}:"
                      f"{min(N, (d + 1) * nloc)}",
                      (mJ[d * nloc * s:(d + 1) * nloc * s], Ls,
                       torch.as_tensor(a, device=dev),
                       torch.as_tensor(o, device=dev)), {"row0": d * nloc}))
    for name, args, kw in calls:
        got = di_kernel.di_pairs(*args, **kw)
        want = di_kernel.di_pairs_torch(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (np.isfinite(err) and err <= tol[torch.float32]):
            raise AssertionError(
                f"di_pairs differs from its plain version at N={N} s={s} "
                f"({name}): max abs {err} > {tol[torch.float32]}")
        err_b[torch.float32] = max(err_b[torch.float32], err)
        log(f"[kernels] di_pairs vs plain, N={N} s={s} {name}: "
            f"P={args[2].numel()} f32 max abs {err:.3e}")
    del got, want, calls
    ms_b = cuda_ms(lambda: di_kernel.di_pairs(mJ, Ls, iu, ju), reps=5)
    plain_b = cuda_ms(lambda: di_kernel.di_pairs_torch(mJ, Ls, iu, ju),
                      reps=3)
    # per pair: the s x s products and the elimination at the pipeline's
    # step count (utils/flops.py, the CLI's count), in f32 off the tensor
    # cores; reads each pair's J block and two factors, writes one value
    bound_b = bound(P * (3 * s * s + 5) * 4,
                    P * di_pair_flops(s, ns_iters(torch.float32, P)),
                    F32_FLOPS_S)
    # the same values laid out column-major, as cuSOLVER writes the
    # inverse: the wrapper then copies mJ before its launch
    mJ_cm = mJ.T.contiguous().T
    ms_b_cm = cuda_ms(lambda: di_kernel.di_pairs(mJ_cm, Ls, iu, ju), reps=3)
    copy_ms = cuda_ms(lambda: mJ_cm.contiguous(), reps=3)
    del mJ_cm
    log(f"[kernels] di_pairs N={N} s={s} P={P} f32: kernel "
        f"{ms_b:.3f} ms, plain {plain_b:.3f} ms; bound {bound_b[0]:.2f} ms"
        f" ({bound_b[1]}); on a column-major mJ {ms_b_cm:.3f} ms, of which "
        f"the wrapper's copy {copy_ms:.3f} ms")
    return [
        {"name": "row_stats", "route": "cuda",
         "source": "gaussdca_tpu_torch/csrc/row_stats.cu",
         "replaces": "gaussdca_tpu/ops/distance.py:310",
         "max_abs_err": err_a, "ms": ms_a, "plain_ms": plain_a,
         "bound_ms": bound_a[0], "bound_by": bound_a[1],
         "library_ms": None},
        {"name": "row_stats_rect", "route": "cuda",
         "source": "gaussdca_tpu_torch/csrc/row_stats_rect.cu",
         "replaces": "gaussdca_tpu/ops/distance.py:720",
         "max_abs_err": err_c, "ms": ms_c, "plain_ms": plain_c,
         "bound_ms": bound_c[0], "bound_by": bound_c[1],
         "library_ms": None},
        {"name": "di_pairs", "route": "cuda",
         "source": "gaussdca_tpu_torch/csrc/di_pairs.cu",
         "replaces": "gaussdca_tpu/ops/di_kernel.py:80",
         "max_abs_err": err_b[torch.float32], "ms": ms_b,
         "plain_ms": plain_b, "bound_ms": bound_b[0],
         "bound_by": bound_b[1], "library_ms": None},
    ]


def _equal_stats(got, want, what):
    """Row statistics equal, exactly; returns the max abs difference."""
    import torch

    for g, w, name in zip(got, want, ("rowsum", "below")):
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: {name} differs in "
                                 f"{int((g != w).sum())} rows")
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def _dense_check(Z, q, thresh, what, D=None):
    """Kernel D (or its result ``D``) equal to its plain version at states
    1..q, every entry; with ``thresh``, its rows also equal to kernel A's
    row statistics. Returns the max abs error."""
    import torch
    from gaussdca_tpu_torch.ops import distance

    D = distance.match_counts(Z, q) if D is None else D
    Dp = distance.match_counts_torch(Z, q)
    torch.cuda.synchronize()
    if not torch.equal(D, Dp):
        raise AssertionError(f"match_counts differs from its plain version "
                             f"at {what}: {int((D != Dp).sum())} entries")
    if thresh is not None:
        _equal_stats((D.sum(1, dtype=torch.int64).float(),
                      ((Z.shape[1] - D) < thresh).sum(1).float()),
                     distance.row_stats(Z, thresh, q),
                     f"match_counts rows vs row_stats, {what}")
    return float((D - Dp).abs().max())


def phase_dense_kernels(dev):
    """Kernels D, E and F against their plain versions and kernel A;
    returns their records (without launch counts) for the summary line."""
    import torch
    from gaussdca_tpu_torch.ops import distance
    from gaussdca_tpu_torch.stats import reweight

    err = {"match_counts": 0.0, "row_stats_asym": 0.0,
           "row_stats_sym_e8": 0.0}
    for M, N, q, pad in [(1000, 53, 21, 24), (777, 250, 31, 0),
                         (300, 40, 29, 5), (4096, 384, 21, 0),
                         (2000, 1000, 21, 3)]:
        Z = family_tokens(M, N, q, seed=3 * M + N)
        if pad:
            Z = np.concatenate([Z, np.zeros((pad, N), np.uint8)])
        Zt = torch.as_tensor(Z, device=dev)
        k = distance.plan_asym(N)
        # kernels D, E and F on tokens 1..31 at each q of kernel A (tokens
        # above q match nothing): equal to their plain versions, their rows
        # equal to A's
        Z31 = family_tokens(M, N, 31, seed=3 * M + N + 1)
        if pad:
            Z31 = np.concatenate([Z31, np.zeros((pad, N), np.uint8)])
        Z31 = torch.as_tensor(Z31, device=dev)
        thresh = float(np.float32(np.floor(0.2 * N)))
        for qk in A_STATES:
            what = f"M={M + pad} N={N} tokens 1..31 q={qk}"
            err["match_counts"] = max(err["match_counts"], _dense_check(
                Z31, qk, thresh, what))
            _asym_e8_check(Z31, qk, thresh, err, what)
        D = distance.match_counts(Zt, q)
        err["match_counts"] = max(err["match_counts"], _dense_check(
            Zt, q, None, f"M={M + pad} N={N} tokens 1..{q} q={q}", D))
        planes = distance.one_hot_planes(Zt, q)
        th_auto = float(reweight.auto_theta_closed_form(Zt, q))
        for theta in (0.0, 0.2, th_auto, 0.7):
            thresh = float(np.float32(np.floor(theta * N)))
            what = f"M={M + pad} N={N} q={q} thresh={thresh}"
            A = distance.row_stats(Zt, thresh, q)
            E = distance.row_stats_asym(Zt, thresh, q)
            F = distance.row_stats_e8(planes, N, thresh)
            err["row_stats_asym"] = max(err["row_stats_asym"], _equal_stats(
                E, distance.row_stats_asym_torch(Zt, thresh, k, q),
                f"row_stats_asym vs plain, {what}"))
            err["row_stats_sym_e8"] = max(
                err["row_stats_sym_e8"], _equal_stats(
                    F, distance.row_stats_e8_torch(planes, N, thresh),
                    f"row_stats_sym_e8 vs plain, {what}"))
            _equal_stats(E, A, f"row_stats_asym vs row_stats, {what}")
            _equal_stats(F, A, f"row_stats_sym_e8 vs row_stats, {what}")
            _equal_stats((D.sum(1, dtype=torch.int64).float(),
                          ((N - D) < thresh).sum(1).float()), A,
                         f"match_counts rows vs row_stats, {what}")
        log(f"[kernels] match_counts, row_stats_asym (plan k={k}"
            f"{', no plan: kernel A' if k < 2 else ''}), row_stats_sym_e8 "
            f"== plain and == row_stats at M={M} N={N} q={q} (+{pad} "
            f"token-0 rows), theta 0 / 0.2 / auto={th_auto:.4f} / 0.7; "
            f"match_counts, row_stats_asym and row_stats_sym_e8 == plain "
            f"and their rows == row_stats on tokens 1..31 at q "
            f"{' / '.join(map(str, A_STATES))}")

    # --- the main shape: E and F on tokens 1..31 at each q, equal to their
    # plain versions and kernel A; then at q = 21
    Z31 = torch.as_tensor(family_tokens(32768, 384, 31, seed=7), device=dev)
    thresh = float(np.floor(0.2 * 384))
    for qk in A_STATES:
        _asym_e8_check(Z31, qk, thresh, err, f"M=32768 N=384 tokens 1..31 "
                       f"q={qk}")
    del Z31
    log(f"[kernels] at M=32768 N=384 tokens 1..31 thresh={thresh}: "
        "row_stats_asym and row_stats_sym_e8 == plain == row_stats at q "
        f"{' / '.join(map(str, A_STATES))}")
    Z = torch.as_tensor(family_tokens(32768, 384, 21, seed=1), device=dev)
    M, N, q = Z.shape[0], Z.shape[1], 21
    k = distance.plan_asym(N)
    A = distance.row_stats(Z, thresh)
    _equal_stats(distance.row_stats_asym(Z, thresh, q), A,
                 "row_stats_asym vs row_stats at the main shape")
    planes = distance.one_hot_planes(Z, q)
    _equal_stats(distance.row_stats_e8(planes, N, thresh), A,
                 "row_stats_sym_e8 vs row_stats at the main shape")
    D = distance.match_counts(Z, q)
    _equal_stats((D.sum(1, dtype=torch.int64).float(),
                  ((N - D) < thresh).sum(1).float()), A,
                 "match_counts rows vs row_stats at the main shape")
    for lib in (match_counts_library, match_counts_int_mm):
        if not torch.equal(lib(Z, q), D):
            raise AssertionError(f"{lib.__name__} differs from match_counts "
                                 "at the main shape")
    del D
    log(f"[kernels] at M={M} N={N} q={q} thresh={thresh}: row_stats_asym "
        f"(k={k}), row_stats_sym_e8 and the rows of match_counts == "
        "row_stats; match_counts == one-hot f32 torch.matmul == "
        "torch._int_mm")
    ms_e = cuda_ms(lambda: distance.row_stats_asym(Z, thresh, q), reps=5)
    plain_e = cuda_ms(
        lambda: distance.row_stats_asym_torch(Z, thresh, k, q), reps=3)
    ms_f = cuda_ms(lambda: distance.row_stats_e8(planes, N, thresh), reps=5)
    plain_f = cuda_ms(lambda: distance.row_stats_e8_torch(planes, N,
                                                          thresh), reps=3)
    ms_planes = cuda_ms(lambda: distance.one_hot_planes(Z, q), reps=3)
    del planes
    ms_d = cuda_ms(lambda: distance.match_counts(Z, q), reps=5)
    plain_d = cuda_ms(lambda: distance.match_counts_torch(Z, q), reps=3)
    lib_d = cuda_ms(lambda: match_counts_int_mm(Z, q), reps=3)
    lib_d_f32 = cuda_ms(lambda: match_counts_library(Z, q), reps=3)
    # E: kernel A's half grid (M^2 N q int8 operations as the JAX kernel
    # counts them); reads Z once, writes two [M] results
    bound_e = bound(M * N + 8 * M, M * M * N * q, INT8_OPS_S)
    # F: the same half grid over the planes, read once
    bound_f = bound(M * planes_width(N, q) + 8 * M, M * M * N * q,
                    INT8_OPS_S)
    # D: the half grid (the counts are symmetric); reads Z once, writes
    # the [M, M] int32 counts
    bound_d = bound(M * N + 4 * M * M, M * M * N * q, INT8_OPS_S)
    popc_half = M * M / 2 * N / 4 / POPC_WORDS_S * 1e3
    log(f"[kernels] row_stats_asym M={M} N={N} q={q} k={k}: kernel "
        f"{ms_e:.3f} ms, plain {plain_e:.3f} ms; bound {bound_e[0]:.2f} ms "
        f"({bound_e[1]}), popcount-pipe bound {popc_half:.2f} ms")
    log(f"[kernels] row_stats_sym_e8 M={M} N={N} q={q} (planes "
        f"{M * planes_width(N, q) / 1e6:.0f} MB, built in {ms_planes:.3f} "
        f"ms): kernel {ms_f:.3f} ms, plain {plain_f:.3f} ms; bound "
        f"{bound_f[0]:.2f} ms ({bound_f[1]})")
    log(f"[kernels] match_counts M={M} N={N} q={q}: kernel {ms_d:.3f} ms, "
        f"plain {plain_d:.3f} ms, library: one-hot torch._int_mm "
        f"{lib_d:.3f} ms, one-hot f32 torch.matmul {lib_d_f32:.3f} ms; "
        f"bound {bound_d[0]:.2f} ms ({bound_d[1]}, the half grid; the full "
        f"grid {2 * M * M * N * q / INT8_OPS_S * 1e3:.2f} ms, the output "
        f"alone {4 * M * M / HBM_BYTES_S * 1e3:.2f} ms), popcount-pipe "
        f"bound {2 * popc_half:.2f} ms")
    return [
        {"name": "match_counts", "route": "cuda",
         "source": "gaussdca_tpu_torch/csrc/match_counts.cu",
         "replaces": "gaussdca_tpu/ops/distance.py:804",
         "max_abs_err": err["match_counts"], "ms": ms_d,
         "plain_ms": plain_d, "bound_ms": bound_d[0],
         "bound_by": bound_d[1], "library_ms": lib_d,
         "library_f32_ms": lib_d_f32},
        {"name": "row_stats_asym", "route": "cuda",
         "source": "gaussdca_tpu_torch/csrc/row_stats_asym.cu",
         "replaces": "gaussdca_tpu/ops/distance.py:641",
         "max_abs_err": err["row_stats_asym"], "ms": ms_e,
         "plain_ms": plain_e, "bound_ms": bound_e[0],
         "bound_by": bound_e[1], "library_ms": None},
        {"name": "row_stats_sym_e8", "route": "cuda",
         "source": "gaussdca_tpu_torch/csrc/row_stats_e8.cu",
         "replaces": "gaussdca_tpu/ops/distance.py:448",
         "max_abs_err": err["row_stats_sym_e8"], "ms": ms_f,
         "plain_ms": plain_f, "bound_ms": bound_f[0],
         "bound_by": bound_f[1], "library_ms": None},
    ]


def match_counts_library(Z, q: int):
    """Kernel D's counts from one library call, for its ``library_ms``
    only: a one-hot f32 ``torch.matmul`` over states 1..q with TF32 off
    (exact while N < 2^24)."""
    import torch
    from gaussdca_tpu_torch.core.runtime import full_f32_matmuls

    states = torch.arange(1, q + 1, dtype=torch.uint8, device=Z.device)
    E = (Z[:, :, None] == states).reshape(Z.shape[0], -1).float()
    with full_f32_matmuls():
        return (E @ E.T).to(torch.int32)


def match_counts_int_mm(Z, q: int):
    """Kernel D's counts from one int8 library product, for its
    ``library_ms`` only: ``torch._int_mm`` of the int8 one-hot over states
    1..q with its transpose (int32 out, exact; N q a multiple of 8)."""
    import torch

    states = torch.arange(1, q + 1, dtype=torch.uint8, device=Z.device)
    E = (Z[:, :, None] == states).reshape(Z.shape[0], -1).to(torch.int8)
    return torch._int_mm(E, E.T)


def _asym_e8_check(Z, q, thresh, err, what):
    """Kernels E and F at states 1..q equal to their plain versions and to
    kernel A, exactly; folds their max abs errors into ``err``."""
    from gaussdca_tpu_torch.ops import distance

    N = Z.shape[1]
    A = distance.row_stats(Z, thresh, q)
    E = distance.row_stats_asym(Z, thresh, q)
    err["row_stats_asym"] = max(err["row_stats_asym"], _equal_stats(
        E, distance.row_stats_asym_torch(Z, thresh, distance.plan_asym(N), q),
        f"row_stats_asym vs plain, {what}"))
    planes = distance.one_hot_planes(Z, q)
    F = distance.row_stats_e8(planes, N, thresh)
    err["row_stats_sym_e8"] = max(err["row_stats_sym_e8"], _equal_stats(
        F, distance.row_stats_e8_torch(planes, N, thresh),
        f"row_stats_sym_e8 vs plain, {what}"))
    _equal_stats(E, A, f"row_stats_asym vs row_stats, {what}")
    _equal_stats(F, A, f"row_stats_sym_e8 vs row_stats, {what}")


def planes_width(N: int, q: int) -> int:
    """Bytes of one row of one-hot planes (``one_hot_planes``)."""
    return -(-N * q // 64) * 64


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


def phase_golden(mesh=None):
    """The golden configs on cuda:0, or through ``mesh``; returns the f32
    results by name."""
    import torch
    import gaussdca_tpu_torch as g

    tag = "golden" if mesh is None else "mesh golden"
    out = {}
    for name, fa, gold, kw, f32_tol in GOLDEN:
        want = _load_golden(os.path.join(GOLDEN_DIR, gold))
        keys = sorted(want)
        w = np.array([want[k] for k in keys])
        top = [k for k, _ in sorted(want.items(), key=lambda t: -t[1])]
        for dt in (torch.float64, torch.float32):
            t0 = time.perf_counter()
            r = g.gdca(os.path.join(GOLDEN_DIR, fa), dtype=dt,
                       device="cuda", mesh=mesh, **kw)
            wall = time.perf_counter() - t0
            if dt == torch.float32:
                out[name] = r
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
            log(f"[{tag}] {name} {str(dt)[6:]}: max abs err {err:.3e} "
                f"({gate}: {'PASS' if ok else 'FAIL'}), top-10 overlap "
                f"{overlap[0]}/10, top-100 {overlap[1]}/100, {wall:.2f} s")
            if not ok:
                raise AssertionError(f"{tag} {name} {dt} failed its gate")
    return out


# (name, M, N, options, max abs mesh-vs-one-device score difference): the
# limits stand 8-10x above the differences measured on an H100, 1.3e-6
# (frob) and 1.9e-5 (DI); PERF.md has the runs
REAL_SIZE = [
    ("frob auto-theta M=32768 N=384 q=21", 32768, 384,
     dict(score="frob", pseudocount=0.8, theta="auto"), 1e-5),
    ("DI pc=0.2 theta=0.2 M=1024 N=1000 q=21", 1024, 1000,
     dict(score="DI", pseudocount=0.2, theta=0.2), 2e-4),
]


def _against_single(name, r, single, tol):
    """A mesh ranking against the single-device ranking of the same call:
    the same pair set, finite, max abs difference <= tol, top-100 overlap
    >= 95."""
    got = {(i, j): x for i, j, x in r.ranking}
    want = {(i, j): x for i, j, x in single.ranking}
    if set(got) != set(want):
        raise AssertionError(f"{name}: mesh and single-device pair sets "
                             "differ")
    diff = max(abs(got[k] - want[k]) for k in want)
    top = len({p[:2] for p in r.ranking[:100]}
              & {p[:2] for p in single.ranking[:100]})
    log(f"[mesh real] {name}: vs single device max abs diff {diff:.3e} "
        f"(limit {tol:g}), top-100 overlap {top}/100, theta "
        f"{r.theta:.6f} / {single.theta:.6f}, Meff {r.meff:.3f} / "
        f"{single.meff:.3f}")
    if not (np.isfinite(diff) and diff <= tol) or top < 95:
        raise AssertionError(f"{name}: mesh run disagrees with the single-"
                             "device run")


def stage_times(rec) -> list:
    """The top spans of a traced RunLog (the pipeline's stages), each as
    (name, host wall s, stream time s or None, host s inside its
    collectives)."""
    spans = rec.traced()["spans"]
    out = {}
    for k, (name, parent, t0, t1, attrs) in enumerate(spans):
        if parent is None:
            out[k] = [name, t1 - t0, attrs.get("device_s"), 0.0]
        elif name == "collective":
            top = k
            while spans[top][1] is not None:
                top = spans[top][1]
            out[top][3] += t1 - t0
    return list(out.values())


def _ms(seconds) -> str:
    return "n/a" if seconds is None else f"{seconds:.3f}"


def phase_real_size(dev, mesh=None, single=None):
    """The real-size families on ``dev``, or through ``mesh`` held
    against ``single`` (the single-device results by name). Returns the
    results by name."""
    import torch
    from gaussdca_tpu_torch import api
    from gaussdca_tpu_torch.core.config import GDCAConfig
    from gaussdca_tpu_torch.interop import msa_from_arrays
    from gaussdca_tpu_torch.parallel.sharded import pad_rows, sharded_scores
    from gaussdca_tpu_torch.utils.log import RunLog, tracing

    tag = "real" if mesh is None else f"mesh real {mesh.size} shards"
    results = {}
    for name, M, N, kw, tol in REAL_SIZE:
        tokens = family_tokens(M, N, 21, seed=M + N)
        M, N = tokens.shape
        msa = msa_from_arrays(tokens, 21, [str(i) for i in range(M)])
        cfg = GDCAConfig(device="cuda", dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = api.gdca_from_msa(msa, cfg, mesh=mesh)
        e2e = time.perf_counter() - t0
        results[name] = r
        npairs = (N - 5) * (N - 4) // 2
        if len(r) != npairs or not all(np.isfinite(x) for _, _, x in r):
            raise AssertionError(f"{name}: ranking is not {npairs} finite "
                                 "pairs")
        if single is not None:
            _against_single(name, r, single[name], tol)
        # the same pipeline again, traced: each stage's host wall and
        # stream time from its span, with no synchronize between stages
        rec = RunLog(name, enabled=False)
        torch.cuda.reset_peak_memory_stats()
        with tracing(), rec.bound(), api.full_f32_matmuls():
            if mesh is None:
                S, _, _ = api.scores_pipeline(
                    torch.as_tensor(tokens, device=dev), 21, cfg)
            else:
                S, _, _ = sharded_scores(
                    mesh, pad_rows(torch.as_tensor(tokens), mesh.size), cfg,
                    21, m_true=M)
            api._checked_ranking(S, cfg.min_separation)
        stages = ", ".join(f"{st} {w:.3f}/{_ms(d)}"
                           for st, w, d, _ in stage_times(rec))
        log(f"[{tag}] {name}: end to end {e2e:.3f} s (theta "
            f"{r.theta:.4f}, Meff {r.meff:.1f}, {len(r)} pairs, top "
            f"{r[0]}); stages, host wall (s) / stream time: {stages}; "
            "peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return results


def phase_weights(path, weights, ref):
    """W, Meff and theta at the main shape from ``weights(dtype)``, in f32
    and f64, each equal to ``ref[dtype]`` (kernel A's weights)."""
    import torch

    for dt in (torch.float32, torch.float64):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        W, Meff, th = weights(dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        W1, Meff1, th1 = ref[dt]
        ok = (torch.equal(W, W1) and float(Meff) == float(Meff1)
              and float(th) == float(th1))
        log(f"[weights: {path}] M={W.shape[0]} {str(dt)[6:]}: {wall:.3f} s, "
            f"theta {float(th):.6f}, Meff {float(Meff):.4f}; W, Meff, theta "
            f"{'==' if ok else '!='} kernel A's")
        if not ok:
            raise AssertionError(f"the weights on the {path} path differ "
                                 "from the weights on kernel A")


def phase_top_k(golden32):
    """The small frob golden through ``gdca(..., top_k=100)`` on the card,
    f32: the head of the full ranking of the same call."""
    import torch
    import gaussdca_tpu_torch as g

    name, fa, _, kw, _ = GOLDEN[0]
    exact = golden32[name]
    head = g.gdca(os.path.join(GOLDEN_DIR, fa), dtype=torch.float32,
                  device="cuda", top_k=100, **kw)
    ref = {(i, j): x for i, j, x in exact.ranking}
    # ties at the 100th score aside
    cut = exact.ranking[99][2]
    sure = {p[:2] for p in exact.ranking[:100] if p[2] != cut}
    pairs = {p[:2] for p in head.ranking}
    diff = max(abs(x - ref[(i, j)]) for i, j, x in head.ranking)
    log(f"[top_k] {name} f32, top_k=100: {len(head)} pairs, "
        f"{len(pairs & sure)} of the {len(sure)} above the 100th score, max "
        f"abs diff to the full ranking {diff:.3e} (limit 1e-6)")
    if len(head) != 100 or not sure <= pairs or diff > 1e-6 or min(
            x for _, _, x in head.ranking) < cut:
        raise AssertionError("top_k is not the head of the full ranking")


# the planted-pair recovery (phase 6): the two real-size cells' shapes,
# 16 planted pairs each at copy probability 0.9, q = 21, theta 0.2
RECOVER = [("frob", 32768, 384), ("DI", 1024, 1000)]
RECOVER_PAIRS = 16
RECOVER_COPY_P = 0.9


def phase_recover(device="cuda", dtype="float32"):
    """``examples/recover_contacts_torch.py``'s planted-pair recovery at
    each ``RECOVER`` shape on ``device``: every planted pair must be in
    the top ``RECOVER_PAIRS`` of the ranking."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "recover_contacts_torch",
        os.path.join(REPO, "examples", "recover_contacts_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for score, M, N in RECOVER:
        Z, planted = example.synth_msa(M, N, n_pairs=RECOVER_PAIRS,
                                       copy_p=RECOVER_COPY_P)
        t0 = time.perf_counter()
        res, top, hits = example.recover(Z, planted, score, device=device,
                                         dtype=dtype)
        log(f"[recover] {score} M={M} N={N} {dtype} on {device}: "
            f"recovered {hits}/{len(planted)} planted pairs in the top "
            f"{len(planted)} (copy_p {RECOVER_COPY_P}, theta "
            f"{res.theta:.3f}, Meff {res.meff:.1f}, the "
            f"{len(planted)}th score {res.ranking[len(planted) - 1][2]:.5g}"
            f", the next {res.ranking[len(planted)][2]:.5g}); "
            f"{time.perf_counter() - t0:.3f} s")
        if len(planted) != RECOVER_PAIRS or hits != len(planted):
            raise AssertionError(f"recover {score} {M}x{N}: only {hits} of "
                                 f"{len(planted)} planted pairs recovered: "
                                 f"top {sorted(top)}, planted {planted}")


# the CLI batch files (phase 8): name -> (M, N, seed); frob and DI are the
# real-size families of phase 4 (same seeds), deep is the auto-theta frob
# cell of bench.py (M = 100,000, N = 200, q = 21), ingest a file that is
# only parsed
BATCH = {"frob32768x384": (32768, 384, 32768 + 384),
         "deep100000x200": (100000, 200, 100000 + 200),
         "di1024x1000": (1024, 1000, 1024 + 1000),
         "ingest100000x400": (100000, 400, 100000 + 400)}
FROB_BATCH = ("small", "frob32768x384", "deep100000x200")
DI_ARGS = ["--score", "DI", "--pseudocount", "0.2", "--theta", "0.2"]
# states 1..20 are the amino acids in alphabetical order, 21 the gap
ALPHABET = b"ACDEFGHIKLMNPQRSTVWY-"


def write_fasta_gz(path: str, tokens: np.ndarray) -> None:
    """A gzipped FASTA file of the token matrix, one line a sequence."""
    import gzip

    lut = np.frombuffer(b"?" + ALPHABET, dtype=np.uint8)
    rows = lut[tokens]
    with gzip.open(path, "wb", compresslevel=6) as fh:
        fh.write(b"".join(b">s%d\n%s\n" % (i, rows[i].tobytes())
                          for i in range(rows.shape[0])))


def phase_batch_files(tmp: str) -> dict:
    """The batch's gzipped FASTA files; returns name -> path."""
    files = {"small": os.path.join(GOLDEN_DIR, "small.fasta.gz")}
    for name, (M, N, seed) in BATCH.items():
        files[name] = os.path.join(tmp, name + ".fasta.gz")
        write_fasta_gz(files[name], family_tokens(M, N, 21, seed=seed))
    for name, path in files.items():
        log(f"[batch] {name}: {os.path.getsize(path) / 1e6:.2f} MB "
            f"({os.path.relpath(path, REPO) if name == 'small' else path})")
    return files


def phase_ingest(files: dict) -> dict:
    """Native and NumPy parse times of the two largest files (median of
    three), their results equal; returns the times for the summary."""
    from gaussdca_tpu_torch.io import fasta, native

    if native.available():
        from gaussdca_tpu_torch.ops import _build

        lib = _build.build_host("fasta_native", native.BUILD_VARIANTS)
        ldd = subprocess.run(["ldd", lib], capture_output=True, text=True)
        linked = ("libdeflate and zlib" if "libdeflate" in ldd.stdout
                  else "zlib only")
        log(f"[ingest] native parser {os.path.relpath(lib, REPO)}: {linked}")
    else:
        log(f"[ingest] native parser did not build:\n{native.build_error()}")
    log("[ingest] read_fasta_alignment(use_native=None) takes the "
        f"{'native' if native.available() else 'numpy'} parser")
    out = {}
    for name in ("ingest100000x400", "frob32768x384"):
        parsed, times = {}, {}
        for parser in ("native", "numpy")[0 if native.available() else 1:]:
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                parsed[parser] = fasta.read_fasta_alignment(
                    files[name], 0.9, use_native=parser == "native")
                runs.append(time.perf_counter() - t0)
            times[parser] = statistics.median(runs)
            msa = parsed[parser]
            log(f"[ingest] {name} {parser}: {times[parser]:.3f} s (runs "
                f"{', '.join(f'{t:.3f}' for t in runs)}), M={msa.M} N={msa.N}"
                f" q={msa.q}, parser {msa.parser}")
        want = BATCH[name]
        for msa in parsed.values():
            if msa.tokens.shape != want[:2] or not np.array_equal(
                    msa.tokens, family_tokens(*want[:2], 21, seed=want[2])):
                raise AssertionError(f"{name}: parsed tokens differ from the "
                                     "tokens written")
        if len(parsed) == 2 and parsed["native"].headers != \
                parsed["numpy"].headers:
            raise AssertionError(f"{name}: the parsers' headers differ")
        out[name] = times
    return out


def phase_deep_rows(dev, files: dict) -> None:
    """Kernel A at M = 100,000 (M^2 > 2^31) against its plain version on
    the deep family's rows, and the weights from each equal."""
    import torch
    from gaussdca_tpu_torch.io import fasta
    from gaussdca_tpu_torch.ops import distance
    from gaussdca_tpu_torch.stats import reweight

    msa = fasta.read_fasta_alignment(files["deep100000x200"], 0.9)
    Z = torch.as_tensor(msa.tokens, device=dev)
    M, N = Z.shape
    th = float(reweight.auto_theta_closed_form(Z, 21))
    thresh = float(np.float32(np.floor(th * N)))
    got = distance.row_stats(Z, thresh, 21)
    want = distance.row_stats_torch(Z, thresh, 21)
    torch.cuda.synchronize()
    _equal_stats(got, want, f"row_stats vs plain at M={M} N={N}")
    W, Meff, _ = reweight.compute_weights_streaming(Z, "auto", 21,
                                                    dtype=torch.float32)
    Wp, Meffp, _ = reweight.compute_weights_streaming(
        Z, "auto", 21, dtype=torch.float32,
        row_stats_fn=lambda *_: want)
    if not torch.equal(W, Wp):
        raise AssertionError(f"W at M={M} differs from the plain version's")
    log(f"[deep] row_stats == plain at M={M} N={N} q=21 thresh={thresh} "
        f"(theta {th:.4f}; rowsum up to {int(got[0].max())}), W == the "
        f"plain version's W, Meff {float(Meff):.3f}")


def run_cli(argv) -> list:
    """``cli.main(argv)`` in this process with stderr captured; logs and
    returns its JSON records, raises on a non-zero exit."""
    import contextlib
    import io
    from gaussdca_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc = cli.main([str(a) for a in argv])
    recs = []
    for line in buf.getvalue().splitlines():
        if line.startswith("{"):
            recs.append(json.loads(line))
            log(f"[cli] {line}")
    if rc != 0:
        raise AssertionError(f"cli.main exited {rc}:\n"
                             f"{buf.getvalue()[-3000:]}")
    return recs


def read_rank_text(path: str) -> dict:
    with open(path) as fh:
        return {(int(i), int(j)): float(x)
                for i, j, x in (line.split() for line in fh)}


def cli_batches(files: dict, out: str, extra=(), cache=None) -> dict:
    """The frob batch (merged) and the DI batch through ``cli.main`` into
    ``out``; returns the records of both."""
    c = ["--cache-dir", cache] if cache else []
    t0 = time.perf_counter()
    frob = run_cli([*(files[n] for n in FROB_BATCH), "-o", out,
                    "--merge-output", os.path.join(out, "merged.txt"),
                    *c, *extra])
    t1 = time.perf_counter()
    di = run_cli([files["di1024x1000"], "-o", out, *DI_ARGS, *c, *extra])
    t2 = time.perf_counter()
    log(f"[cli] batch walls (host clock around cli.main): frob "
        f"{t1 - t0:.3f} s, DI {t2 - t1:.3f} s")
    return {"frob": frob, "di": di}


def check_cli_outputs(files: dict, out: str) -> None:
    """Each family's output against ``api.gdca_from_msa`` of the same
    parsed MSA and config in this process (same pair set, every value
    within rel 1e-6), the small family also against its golden file in
    the f32 envelope, the merged file against the per-family files."""
    import torch
    from gaussdca_tpu_torch import api
    from gaussdca_tpu_torch.core.config import GDCAConfig
    from gaussdca_tpu_torch.io import fasta
    from gaussdca_tpu_torch.score.rank import format_rank

    runs = [(n, {}) for n in FROB_BATCH] + [
        ("di1024x1000", dict(score="DI", pseudocount=0.2, theta=0.2))]
    for name, kw in runs:
        msa = fasta.read_fasta_alignment(files[name], 0.9)
        r = api.gdca_from_msa(msa, GDCAConfig(device="cuda",
                                              dtype=torch.float32, **kw))
        path = os.path.join(out, name + ".rank.txt")
        with open(path) as fh:
            text = fh.read()
        got = read_rank_text(path)
        want = {(i, j): x for i, j, x in r.ranking}
        if set(got) != set(want):
            raise AssertionError(f"cli {name}: pair set differs from "
                                 "gdca_from_msa's")
        rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-300)
                  for k in want)
        same = text == format_rank(r.ranking)
        log(f"[cli check] {name}: {len(got)} pairs, max rel diff to "
            f"gdca_from_msa {rel:.2e} (limit 1e-6), text "
            f"{'byte-identical' if same else 'differs'}")
        if not rel <= 1e-6:
            raise AssertionError(f"cli {name} disagrees with gdca_from_msa")
    gold = _load_golden(os.path.join(GOLDEN_DIR, "small.FNRout.txt"))
    got = read_rank_text(os.path.join(out, "small.rank.txt"))
    err = max(abs(got[k] - gold[k]) for k in gold) \
        if set(got) == set(gold) else float("inf")
    log(f"[cli check] small vs small.FNRout.txt: max abs err {err:.3e} "
        "(limit 5e-4)")
    if not err <= 5e-4:
        raise AssertionError("cli small output fails the f32 golden gate")
    want = []
    for name in FROB_BATCH:
        with open(os.path.join(out, name + ".rank.txt")) as fh:
            want += [f"{name} {line}" for line in fh]
    with open(os.path.join(out, "merged.txt")) as fh:
        if fh.readlines() != want:
            raise AssertionError("the merged file is not the per-family "
                                 "files with their stems")


def same_outputs(a: str, b: str, names) -> None:
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{name}: {b} differs from {a}")


def check_cached(recs: dict, out: str, ref: str) -> None:
    flat = recs["frob"][:-1] + recs["di"][:-1]
    if len(flat) != 4 or not all(r.get("cached") is True for r in flat):
        raise AssertionError("the rerun was not served from the cache")
    same_outputs(ref, out, [n + ".rank.txt" for n in FROB_BATCH]
                 + ["di1024x1000.rank.txt", "merged.txt"])
    log("[cli cached] every family cached: true, outputs byte-identical")


def max_abs_diff(got: dict, want: dict) -> float:
    """Max abs difference of two rankings over the same pair set (inf when
    the pair sets differ)."""
    if set(got) != set(want):
        return float("inf")
    return max(abs(got[k] - want[k]) for k in want)


def check_close(out: str, ref: str, what: str, limits: dict) -> None:
    """Each family's output in ``out`` against ``ref``'s: the same pair
    set and max abs difference within its limit (name -> limit)."""
    for name, limit in limits.items():
        diff = max_abs_diff(
            read_rank_text(os.path.join(out, name + ".rank.txt")),
            read_rank_text(os.path.join(ref, name + ".rank.txt")))
        log(f"[{what}] {name} vs one device: max abs diff {diff:.3e} "
            f"(limit {limit:g})")
        if not diff <= limit:
            raise AssertionError(f"{what} {name} disagrees")


def check_top_k(out: str, ref: str) -> None:
    with open(os.path.join(ref, "frob32768x384.rank.txt")) as fh:
        full = [(int(i), int(j), float(x))
                for i, j, x in (line.split() for line in fh)]
    with open(os.path.join(out, "frob32768x384.rank.txt")) as fh:
        head = [(int(i), int(j), float(x))
                for i, j, x in (line.split() for line in fh)]
    ref_score = {(i, j): x for i, j, x in full}
    cut = full[99][2]
    sure = {p[:2] for p in full[:100] if p[2] != cut}
    pairs = {p[:2] for p in head}
    diff = max(abs(x - ref_score[(i, j)]) / abs(ref_score[(i, j)])
               for i, j, x in head)
    log(f"[cli top_k] frob32768x384 --top-k 100: {len(head)} pairs, "
        f"{len(pairs & sure)} of the {len(sure)} above the 100th score, max "
        f"rel diff to the full ranking {diff:.2e} (limit 1e-6)")
    if len(head) != 100 or not sure <= pairs or diff > 1e-6 or min(
            x for _, _, x in head) < cut:
        raise AssertionError("cli --top-k is not the head of the ranking")


def check_profile(prof: str) -> None:
    with open(os.path.join(prof, "trace.json")) as fh:
        trace = json.load(fh)
    by_name, span = {}, [float("inf"), 0.0]
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X":
            span = [min(span[0], ev["ts"]), max(span[1], ev["ts"] + ev["dur"])]
        if ev.get("cat") == "kernel":
            by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + ev["dur"]
    top = sorted(by_name.items(), key=lambda t: -t[1])[:8]
    busy = sum(by_name.values())
    log(f"[cli profile] {len(by_name)} kernels in the trace, {busy:.1f} us "
        f"of device time in a {span[1] - span[0]:.1f} us trace (busy "
        f"{busy / max(span[1] - span[0], 1e-9):.1%}); by kernel (us): "
        + "; ".join(f"{n[:70]} {d:.1f}" for n, d in top))
    mine = [(n, d) for n, d in by_name.items() if "row_stats_kernel" in n]
    if not mine:
        raise AssertionError("the profiler trace does not name kernel A's "
                             "row_stats_kernel")
    log(f"[cli profile] kernel A in the trace: {mine[0][0]} {mine[0][1]:.1f} "
        "us")


_FAMILY_CHILD = r"""
import json
out_dir, merge, *inputs = argv
from gaussdca_tpu_torch.cli import main
from gaussdca_tpu_torch.ops import di_kernel, distance

rc = main(inputs + ["-o", out_dir, "--distributed", "--merge-output", merge])
print(json.dumps({"rc": rc, "launches": {
    k: getattr(m, f).launches for k, m, f in (
        ("row_stats", distance, "row_stats"),
        ("row_stats_rect", distance, "row_stats_rect"),
        ("di_pairs", di_kernel, "di_pairs"),
        ("match_counts", distance, "match_counts"),
        ("row_stats_asym", distance, "row_stats_asym"),
        ("row_stats_sym_e8", distance, "row_stats_sym_e8"))}}))
"""


def phase_family_mode(files: dict, out: str, ref: str) -> dict:
    """Two processes of one job on cuda:0 (the port's podspawn) split the
    frob batch with --distributed --merge-output; their part files hold
    the lines of the one-process merged file. Returns the children's
    launch counts, summed."""
    from gaussdca_tpu_torch.parallel.podspawn import spawn_pod

    merge = os.path.join(out, "merged.txt")
    t0 = time.perf_counter()
    outs = spawn_pod(_FAMILY_CHILD, timeout=600,
                     args_per_proc=lambda i: [out, merge, *(
                         files[n] for n in FROB_BATCH)])
    wall = time.perf_counter() - t0
    total = {}
    for i, (rc, sout, serr) in enumerate(outs):
        for line in serr.splitlines():
            if line.startswith("{"):
                log(f"[cli family p{i}] {line}")
        if rc != 0:
            raise AssertionError(f"family-mode process {i} exited {rc}:\n"
                                 f"{sout[-2000:]}\n{serr[-3000:]}")
        res = json.loads(sout.strip().splitlines()[-1])
        if res["rc"] != 0 or res["launches"]["row_stats"] <= 0:
            raise AssertionError(f"family-mode process {i}: {res}")
        log(f"[cli family p{i}] kernel launches: {res['launches']}")
        for k, n in res["launches"].items():
            total[k] = total.get(k, 0) + n
    parts = []
    for i in range(2):
        with open(f"{merge}.part{i}of2") as fh:
            parts += fh.readlines()
    with open(os.path.join(ref, "merged.txt")) as fh:
        want = fh.readlines()
    log(f"[cli family] 2 processes on cuda:0: {wall:.1f} s wall (process "
        f"start included); part files {len(parts)} lines, merged "
        f"{len(want)}")
    if sorted(parts) != sorted(want):
        raise AssertionError("the family-mode part files do not hold the "
                             "merged file's lines")
    return total


_POD_CHILD = r"""
import contextlib, json, time
import torch
from gaussdca_tpu_torch import api
from gaussdca_tpu_torch.cli import main
from gaussdca_tpu_torch.utils.log import RunLog, tracing
from gaussdca_tpu_torch.ops import di_kernel, distance
from gaussdca_tpu_torch.parallel import mesh as meshlib

runs, di_file = json.loads(argv[0]), argv[1]
counters = {k: getattr(m, k) for k, m in (
    ("row_stats", distance), ("row_stats_rect", distance),
    ("di_pairs", di_kernel), ("match_counts", distance),
    ("row_stats_asym", distance), ("row_stats_sym_e8", distance))}
# joined here, once for the four batches: cuda:0 shared, so gloo
meshlib.init_distributed(force=True, device="cuda")
walls = []
real = api.gdca_from_msa


def timed(msa, cfg, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = real(msa, cfg, **kw)
    torch.cuda.synchronize()
    walls.append([f"{msa.M}x{msa.N}", time.perf_counter() - t0])
    return r


api.gdca_from_msa = timed
torch.cuda.reset_peak_memory_stats()
res = []
for argv_k in runs:
    for fn in counters.values():
        fn.launches = 0
    walls.clear()
    t0 = time.perf_counter()
    rc = main(argv_k)
    res.append({"rc": rc, "wall": time.perf_counter() - t0,
                "pipeline": list(walls),
                "launches": {k: fn.launches for k, fn in counters.items()}})
peak = torch.cuda.max_memory_allocated() / 2 ** 30

# the DI family once more through sharded_scores, untraced and then
# traced: the two walls (tracing's cost on the pod), each stage's host
# wall, stream time and host time inside its collectives, and the
# record's collective counters
from chip_smoke import stage_times
from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.core.runtime import full_f32_matmuls
from gaussdca_tpu_torch.io import fasta
from gaussdca_tpu_torch.parallel.sharded import pad_rows, sharded_scores

msa = fasta.read_fasta_alignment(di_file, 0.9)
mesh = meshlib.make_pod_mesh((2, 2), "cuda")
cfg = GDCAConfig(score="DI", pseudocount=0.2, theta=0.2, device="cuda")
Z = pad_rows(torch.as_tensor(msa.tokens), mesh.size)
rec = RunLog("di", enabled=False)
di_walls = []
for ctx in (contextlib.nullcontext(), tracing()):
    t0 = time.perf_counter()
    with ctx, rec.bound(), full_f32_matmuls():
        S, _, _ = sharded_scores(mesh, Z, cfg, msa.q, m_true=msa.M)
        S.cpu()
    di_walls.append(time.perf_counter() - t0)
print(json.dumps({"runs": res, "backend": torch.distributed.get_backend(),
                  "peak_gib": peak, "di_walls": di_walls,
                  "di_counters": rec.counters,
                  "di_stages": stage_times(rec)}))
"""


def check_pod_outputs(files: dict, pod: str, ref: str) -> None:
    """Process 0's outputs against the one-process ``cli`` run's (one
    device) and against ``gdca_from_msa`` on the one-process mesh of the
    same shape (four shards of cuda:0, 2 x 2): the same pair sets; the
    real-size families within 1e-5 (frob) / 2e-4 (DI) of both. The small
    golden family is held to its f32 golden envelope (5e-4), since in f32
    its four-shard sums already move it by ~1e-4 from one device (both
    differences logged). Every difference is logged before any fails."""
    import torch
    from gaussdca_tpu_torch import api
    from gaussdca_tpu_torch.core.config import GDCAConfig
    from gaussdca_tpu_torch.io import fasta
    from gaussdca_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh([torch.device("cuda", 0)] * 4, (2, 2))
    gold = _load_golden(os.path.join(GOLDEN_DIR, "small.FNRout.txt"))
    failed = []
    for name in (*FROB_BATCH, "di1024x1000"):
        kw = dict(score="DI", pseudocount=0.2, theta=0.2) \
            if name == "di1024x1000" else {}
        msa = fasta.read_fasta_alignment(files[name], 0.9)
        r = api.gdca_from_msa(msa, GDCAConfig(device="cuda",
                                              dtype=torch.float32, **kw),
                              mesh=mesh)
        got = read_rank_text(os.path.join(pod, name + ".rank.txt"))
        refs = {"one device (cli)": read_rank_text(
                    os.path.join(ref, name + ".rank.txt")),
                "one-process 2x2 mesh": {(i, j): x
                                         for i, j, x in r.ranking}}
        if name == "small":
            refs["golden file"] = gold
        limit = 2e-4 if "di" in name else 1e-5
        for what, want in refs.items():
            diff = max_abs_diff(got, want)
            lim = (5e-4 if what == "golden file" else None) \
                if name == "small" else limit
            log(f"[cli pod] {name} vs {what}: max abs diff {diff:.3e} "
                + (f"(limit {lim:g})" if lim else "(logged)"))
            if diff == float("inf") or (lim and not diff <= lim):
                failed.append(f"{name} vs {what}")
    if failed:
        raise AssertionError(f"the pod's outputs disagree: {failed}")


def phase_pod(files: dict, tmp: str, ref: str) -> tuple:
    """The pod: two processes of one job on cuda:0 (the port's podspawn),
    each with ``--distributed --mesh 2,2`` (two shards a process, gloo
    through host buffers), run the frob batch (merged) and the DI batch,
    then both again from the cache. Process 0's outputs are held against
    the one-process runs (``check_pod_outputs``), process 1 writes
    nothing, the rerun is served from the cache. Returns the
    launch counts of the first two batches and of the reruns, each summed
    over the processes."""
    from gaussdca_tpu_torch.parallel.podspawn import spawn_pod

    cache = os.path.join(tmp, "cache_pod")
    outs = [os.path.join(tmp, f"out_pod{i}") for i in range(2)]

    def runs(out):
        pod = ["--distributed", "--mesh", "2,2", "--cache-dir", cache]
        frob = [*(files[n] for n in FROB_BATCH), "-o", out, "--merge-output",
                os.path.join(out, "merged.txt"), *pod]
        di = [files["di1024x1000"], "-o", out, *DI_ARGS, *pod]
        return [frob, di, frob, di]

    t0 = time.perf_counter()
    res = spawn_pod(_POD_CHILD, timeout=600,
                    args_per_proc=lambda i: [json.dumps(runs(outs[i])),
                                             files["di1024x1000"]])
    wall = time.perf_counter() - t0
    first, again = {}, {}
    for i, (rc, sout, serr) in enumerate(res):
        for line in serr.splitlines():
            if line.startswith("{"):
                log(f"[cli pod p{i}] {line}")
        if rc != 0:
            raise AssertionError(f"pod process {i} exited {rc}:\n"
                                 f"{sout[-2000:]}\n{serr[-3000:]}")
        r = json.loads(sout.strip().splitlines()[-1])
        log(f"[cli pod p{i}] backend {r['backend']}, peak device memory "
            f"{r['peak_gib']:.2f} GiB")
        for k, (name, run) in enumerate(zip(
                ("frob", "DI", "frob cached", "DI cached"), r["runs"])):
            log(f"[cli pod p{i}] {name}: rc {run['rc']}, batch "
                f"{run['wall']:.3f} s (host clock around cli.main); "
                "pipeline walls (s): " + ", ".join(
                    f"{fam} {t:.3f}" for fam, t in run["pipeline"])
                + f"; launches {run['launches']}")
            if run["rc"] != 0:
                raise AssertionError(f"pod process {i}: {name} exited "
                                     f"{run['rc']}")
            into = first if k < 2 else again
            for kern, n in run["launches"].items():
                into[kern] = into.get(kern, 0) + n
        cnt = r["di_counters"]
        log(f"[cli pod p{i}] DI 1024x1000 through sharded_scores: "
            f"{r['di_walls'][0]:.3f} s untraced, {r['di_walls'][1]:.3f} s "
            f"traced, of it {cnt['collective_s']:.3f} s in collective spans "
            f"({cnt['collective_bytes'] / 1e6:.1f} MB sent, "
            f"{cnt['collective_bytes'] / 1e9 / cnt['collective_s']:.2f} "
            "GB/s); stages, host wall / stream time / host in collective "
            "spans (s): " +
            ", ".join(f"{st} {w:.3f} / {_ms(d)} / {c:.3f}"
                      for st, w, d, c in r["di_stages"]))
        if r["backend"] != "gloo":
            raise AssertionError("two processes on one card must take gloo")
    log(f"[cli pod] 2 processes on cuda:0: {wall:.1f} s wall (process start "
        "included)")
    if os.path.exists(outs[1]):
        raise AssertionError("pod process 1 wrote outputs")
    check_pod_outputs(files, outs[0], ref)
    cached = [json.loads(line) for line in res[0][2].splitlines()
              if line.startswith('{"family"')][-len(FROB_BATCH) - 1:]
    if len(cached) != len(FROB_BATCH) + 1 or not all(
            c.get("cached") is True for c in cached):
        raise AssertionError("the pod's rerun was not served from the cache")
    want = []
    for name in FROB_BATCH:
        with open(os.path.join(outs[0], name + ".rank.txt")) as fh:
            want += [f"{name} {line}" for line in fh]
    with open(os.path.join(outs[0], "merged.txt")) as fh:
        if fh.readlines() != want:
            raise AssertionError("the pod's merged file is not its "
                                 "per-family files")
    log("[cli pod] process 1 wrote nothing; the rerun: every family "
        "cached: true")
    return first, again


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
    from gaussdca_tpu_torch.parallel.mesh import Mesh, make_mesh
    from gaussdca_tpu_torch.stats import reweight

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    phase_rank(dev)
    phase_solve(dev)
    kernels = phase_kernels(dev) + phase_dense_kernels(dev)
    counters = {"row_stats": distance.row_stats,
                "row_stats_rect": distance.row_stats_rect,
                "di_pairs": di_kernel.di_pairs,
                "match_counts": distance.match_counts,
                "row_stats_asym": distance.row_stats_asym,
                "row_stats_sym_e8": distance.row_stats_sym_e8}
    by_path = {}

    def drive(path, needs, phases, absent=()):
        """Run one main path with the counters zeroed just before it;
        records its launches and fails if a kernel of it never ran (or
        one in ``absent`` did)."""
        for fn in counters.values():
            fn.launches = 0
        out = phases()
        launches = {k: fn.launches for k, fn in counters.items()}
        log(f"[main path: {path}] kernel launches: {launches}")
        for k in needs:
            if launches[k] <= 0:
                raise AssertionError(f"kernel {k} never ran on the {path} "
                                     "path")
        for k in absent:
            if launches[k] != 0:
                raise AssertionError(f"kernel {k} ran on the {path} path")
        by_path[path] = launches
        return out

    golden32, single = drive(
        "single", ("row_stats", "di_pairs"),
        lambda: (phase_golden(), phase_real_size(dev)))
    mesh = Mesh([dev] * 4, (2, 2))
    drive("mesh", ("row_stats_rect", "di_pairs"),
          lambda: (phase_golden(mesh), phase_real_size(dev, mesh, single)))
    if torch.cuda.device_count() > 1:
        phase_real_size(dev, make_mesh(), single)
    drive("top_k", ("row_stats",), lambda: phase_top_k(golden32))
    drive("recover", ("row_stats", "di_pairs"), phase_recover)

    # the other distance kernels as the distance pass of the two weight
    # functions at the main shape, each held against kernel A's weights
    # (taken here, outside every counted path)
    Z = torch.as_tensor(family_tokens(32768, 384, 21, seed=1), device=dev)
    ref = {dt: reweight.compute_weights_streaming(Z, "auto", 21, dtype=dt)
           for dt in (torch.float32, torch.float64)}

    def streaming(fn):
        return lambda dt: reweight.compute_weights_streaming(
            Z, "auto", 21, dtype=dt, row_stats_fn=fn)

    for path, kernel, weights in (
            ("asym", "row_stats_asym", streaming(distance.row_stats_asym)),
            ("full", "row_stats_rect", streaming(distance.row_stats_full)),
            ("e8", "row_stats_sym_e8", streaming(distance.row_stats_sym_e8)),
            ("dense", "match_counts", lambda dt: reweight.compute_weights(
                Z, "auto", q=21, dtype=dt))):
        drive(path, (kernel,), lambda: phase_weights(path, weights, ref),
              absent=("row_stats",))
    # the batch front end after every kernel is built and warm
    import tempfile

    del Z, ref
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        files = phase_batch_files(tmp)
        phase_ingest(files)
        phase_deep_rows(dev, files)
        torch.cuda.empty_cache()
        out, cache = os.path.join(tmp, "out"), os.path.join(tmp, "cache")
        drive("cli", ("row_stats", "di_pairs"),
              lambda: cli_batches(files, out, cache=cache))
        check_cli_outputs(files, out)
        again = os.path.join(tmp, "out_cached")
        check_cached(drive("cli cached", (), lambda: cli_batches(
            files, again, cache=cache), absent=tuple(counters)), again, out)
        serial = os.path.join(tmp, "out_serial")
        drive("cli no-prefetch", ("row_stats", "di_pairs"),
              lambda: cli_batches(files, serial, extra=["--no-prefetch"]))
        same_outputs(out, serial, [n + ".rank.txt" for n in FROB_BATCH]
                     + ["di1024x1000.rank.txt", "merged.txt"])
        log("[cli no-prefetch] outputs byte-identical to the prefetched run")
        mesh_out = os.path.join(tmp, "out_mesh")
        drive("cli mesh", ("row_stats_rect",), lambda: run_cli([
            *(files[n] for n in FROB_BATCH), "-o", mesh_out, "--mesh",
            "1,1"]))
        check_close(mesh_out, out, "cli mesh --mesh 1,1",
                    {n: 1e-5 for n in FROB_BATCH})
        top_out = os.path.join(tmp, "out_top")
        drive("cli top_k", ("row_stats",), lambda: run_cli([
            files["frob32768x384"], "-o", top_out, "--top-k", 100]))
        check_top_k(top_out, out)
        prof = os.path.join(tmp, "prof")
        drive("cli profile", ("row_stats",), lambda: run_cli([
            files["small"], "-o", os.path.join(tmp, "out_prof"),
            "--profile-dir", prof]))
        check_profile(prof)
        torch.cuda.empty_cache()
        by_path["cli family"] = phase_family_mode(
            files, os.path.join(tmp, "out_family"), out)
        log(f"[main path: cli family] kernel launches (both processes): "
            f"{by_path['cli family']}")
        torch.cuda.empty_cache()
        for fn in counters.values():
            fn.launches = 0
        by_path["cli pod"], by_path["cli pod cached"] = phase_pod(
            files, tmp, out)
        for path, needs, absent in (
                ("cli pod", ("row_stats_rect", "di_pairs"), ("row_stats",)),
                ("cli pod cached", (), tuple(counters))):
            log(f"[main path: {path}] kernel launches (both processes): "
                f"{by_path[path]}")
            for k in needs:
                if by_path[path][k] <= 0:
                    raise AssertionError(f"kernel {k} never ran on the "
                                         f"{path} path")
            for k in absent:
                if by_path[path][k] != 0:
                    raise AssertionError(f"kernel {k} ran on the {path} "
                                         "path")
    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
