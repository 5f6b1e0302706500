"""Batch command line: the pipeline over one or many MSA files.

    python -m gaussdca_tpu_torch family1.fasta.gz family2.fasta ... -o out/

The front end of ``gaussdca_tpu.cli`` for the port. Per family it writes
``<stem>.rank.txt`` in the reference's "%i %i %e" emission format and logs
one JSON record to stderr: M, N, q, drop counts, resolved theta, Meff, the
device and the parser that ran, and the wall time of each stage (ingest,
pipeline, emit).

- Artifacts are content-addressed in ``--cache-dir`` (sha256 of the file
  bytes, every result-bearing setting, the device type and mesh, the
  package version, the CUDA sources and the DI step constants): a rerun
  skips families whose inputs and settings are unchanged.
- Ingest prefetch: family i + 1 parses on a host thread while family i
  computes. The native parser leaves the interpreter lock during its
  ctypes call, so the parse overlaps the device work.
- ``--profile-dir`` wraps the batch in ``torch.profiler`` (CPU and CUDA
  activity) and writes a Chrome trace there. While a profiler records
  (this one or the caller's), the program's spans (``utils.log``) are
  ``gdca.*`` ranges in the trace, and each record carries its ``spans``
  and ``counters``; the batch's closing record carries those outside
  any family.
- ``--distributed`` deals the families round-robin to the processes of a
  ``torch.distributed`` job (torchrun's ``env://`` rendezvous), each
  scoring its own families on its own device; with ``--merge-output``
  each process writes ``<path>.part<i>of<n>``.
- ``--distributed --mesh DP,TP`` is the pod: every process parses every
  family and runs the same sharded program over one mesh of DP x TP
  shards split evenly over the processes (``parallel/mesh.py``), and
  process 0 alone writes. What every process runs is agreed first
  (process 0's cache hits and its output setup are broadcast; a failed
  setup exits 2 on every process), and a failure inside the program
  prints ``pod_abort`` and raises on that process, never retried.

Nothing runs on the CPU unless ``--device cpu`` says so: ``--device cuda``
(the default) without a card exits 2 before the batch. The JAX CLI's
``--m-bucket``, ``--n-bucket``, ``--compile-cache`` and ``--warm-compile``
are accepted and have no effect (they choose how XLA compiles, and leave
results as they are; eager PyTorch compiles nothing per shape);
``--fallback`` exits 2, since a plain path on the card is a hidden
fallback. The kernels build on first use, inside the first family's
pipeline stage.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import hashlib
import json
import os
import sys
import time
from typing import List, Optional

import torch

from gaussdca_tpu_torch import __version__, api
from gaussdca_tpu_torch.core.config import GDCAConfig
from gaussdca_tpu_torch.io import fasta
from gaussdca_tpu_torch.ops import _build
from gaussdca_tpu_torch.parallel import mesh as meshlib
from gaussdca_tpu_torch.parallel.mesh import Mesh
from gaussdca_tpu_torch.score import di
from gaussdca_tpu_torch.score.rank import format_rank
from gaussdca_tpu_torch.utils.flops import pipeline_flops
from gaussdca_tpu_torch.utils.log import RunLog, span

_NO_EFFECT = ("accepted for the JAX CLI's command lines; no effect: eager "
              "PyTorch compiles nothing per shape, and results are the "
              "same either way")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gaussdca_tpu_torch",
        description="Gaussian Direct Coupling Analysis on an NVIDIA GPU: "
                    "contact-prediction rankings from MSA files.")
    p.add_argument("inputs", nargs="+", help="FASTA alignment file(s), "
                   "optionally gzipped")
    p.add_argument("-o", "--output-dir", default=".",
                   help="directory for <stem>.rank.txt outputs")
    p.add_argument("--pseudocount", type=float, default=0.8)
    p.add_argument("--theta", default="auto",
                   help='"auto" or a number in [0, 1]')
    p.add_argument("--max-gap-fraction", type=float, default=0.9)
    p.add_argument("--score", choices=["frob", "DI"], default="frob")
    p.add_argument("--min-separation", type=int, default=5)
    p.add_argument("--remove-dups", action="store_true")
    p.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32", help="compute dtype (float32)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu); "
                        "nothing runs on the CPU unless asked")
    p.add_argument("--fallback", action="store_true",
                   help="refused (exit 2): the port has no plain path on "
                        "the card; --device cpu runs the plain versions")
    p.add_argument("--top-k", type=int, default=None,
                   help="emit only the top K pairs (selected on the "
                        "device)")
    p.add_argument("--cache-dir", default=None,
                   help="content-addressed artifact cache; unchanged "
                        "(file, settings) pairs are skipped")
    p.add_argument("--m-bucket", type=int, default=256, help=_NO_EFFECT)
    p.add_argument("--n-bucket", type=int, default=32, help=_NO_EFFECT)
    p.add_argument("--compile-cache", default="auto", help=_NO_EFFECT)
    p.add_argument("--warm-compile", action="store_true", help=_NO_EFFECT)
    p.add_argument("--no-prefetch", action="store_true",
                   help="disable threaded ingest prefetch")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the batch "
                        "here")
    p.add_argument("--mesh", default=None, metavar="DPxTP|auto",
                   help="run the sharded pipeline on a (data, model) mesh: "
                        "'auto' lays one over every visible card, or give "
                        "a shape like '4,2' / '4x2' (with --device cpu, a "
                        "shape of CPU shards)")
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed job (env:// "
                        "rendezvous, as torchrun sets it): alone, deal the "
                        "families round-robin to its processes; with "
                        "--mesh, run one sharded program over a mesh "
                        "spanning them all (process 0 writes)")
    p.add_argument("--merge-output", default=None,
                   help="additionally write one merged ranking file: "
                        "'<family> <i> <j> <score>' lines, all families "
                        "concatenated in batch order (with --distributed "
                        "and >1 process, each process writes its own "
                        "<path>.part<i>of<n> shard: concatenate them)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-family JSON logs")
    return p


def _parse_theta(s):
    if s == "auto":
        return "auto"
    try:
        return float(s)
    except ValueError:
        raise SystemExit(f"invalid --theta value: {s}")


def _parse_mesh(s: Optional[str]):
    """'auto' | '4,2' | '4x2' -> the api.resolve_mesh argument (or None)."""
    if s is None:
        return None
    if s == "auto":
        return "auto"
    for sep in (",", "x", "X"):
        if sep in s:
            parts = s.split(sep)
            if len(parts) == 2:
                try:
                    return (int(parts[0]), int(parts[1]))
                except ValueError:
                    break
    raise SystemExit(f"invalid --mesh value: {s} (expected 'auto' or "
                     "'DP,TP' like '4,2')")


def _kernel_sources_digest() -> str:
    """sha256 of the CUDA sources (``csrc/*.cu`` and ``*.cuh``): a kernel
    change can move f32 scores."""
    h = hashlib.sha256()
    for f in sorted(os.listdir(_build.CSRC_DIR)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(_build.CSRC_DIR, f), "rb") as fh:
                h.update(f.encode() + b"\0" + fh.read() + b"\0")
    return h.hexdigest()


def _cache_key(path: str, cfg: GDCAConfig, top_k: Optional[int],
               mesh_desc: str = "") -> str:
    """The artifact's name: the file bytes and everything that can move
    the emitted text."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        h.update(fh.read())
    key = (cfg.pseudocount, cfg.theta, cfg.max_gap_fraction, cfg.score,
           cfg.min_separation, cfg.remove_dups, cfg.solve_min_dim,
           cfg.solve_block, cfg.resolve_dtype(), top_k,
           cfg.resolve_device().type, mesh_desc, __version__,
           _kernel_sources_digest(),
           (di.F64_NS_ITERS, di.SMALL_NS_ITERS, di.BM_MIN_PAIRS,
            di.BM_NS_ITERS))
    h.update(repr(key).encode())
    return h.hexdigest()


def _mesh_desc(mesh: Optional[Mesh]) -> str:
    """Cache-key descriptor of a mesh ('' = one device): mesh runs sum in
    a different order, so artifacts must not be shared; nor may a pod's
    and a one-process mesh's of the same shape (their collectives sum in
    another order)."""
    if mesh is None:
        return ""
    pod = f":pod{mesh.world}" if mesh.world > 1 else ""
    return "mesh:" + "x".join(
        f"{a}{mesh.shape[a]}" for a in mesh.axis_names) + pod


def _stem(path: str) -> str:
    stem = os.path.basename(path)
    for suf in (".gz", ".fasta", ".fa", ".afa", ".fna"):
        if stem.endswith(suf):
            stem = stem[: -len(suf)]
    return stem


def _output_stems(paths: List[str]) -> List[str]:
    """Per-input output stems, disambiguating basename collisions so
    famA/align.fasta and famB/align.fasta don't overwrite each other."""
    seen: dict = {}
    out = []
    for p in paths:
        s = _stem(p)
        n = seen.get(s, 0)
        seen[s] = n + 1
        out.append(s if n == 0 else f"{s}.{n + 1}")
    return out


def run_family(path: str, cfg: GDCAConfig, out_dir: str,
               top_k: Optional[int], cache_dir: Optional[str],
               quiet: bool, msa_future=None, stem: Optional[str] = None,
               cache_key: Optional[str] = None,
               mesh: Optional[Mesh] = None, emit: bool = True,
               cache_read: bool = True, cache_only: bool = False,
               emit_errors_fatal: bool = True,
               parse_log: Optional[RunLog] = None) -> Optional[str]:
    """Process one family; returns the output path (None when nothing
    was written).

    ``msa_future``: optional concurrent.futures.Future holding the
    prefetched ingest result (or raising its parse error), and
    ``parse_log`` the RunLog its thread recorded the parse's spans in.
    ``cache_key``: precomputed ``_cache_key`` (the batch loop computes it
    for prefetch decisions; avoids hashing the file twice).

    The pod's contract (``--distributed --mesh``), as in
    ``gaussdca_tpu.cli.run_family``: ``emit=False`` runs the pipeline
    and writes nothing (a non-writer process: it takes part in the
    collectives, process 0 owns the files). ``cache_read=False`` never
    serves an existing artifact (the pod decides cache hits together: one
    process skipping the collective program on a hit only it sees would
    leave the others waiting). ``emit_errors_fatal=False``: a writer's
    I/O failure after the program (output or cache write) is recorded in
    the family's log and reported as None instead of raised, so process
    0 stays in step with the peers entering the next family.
    ``cache_only=True``: the pod agreed this family is a cache hit (every
    peer skipped it): serve the artifact or record its absence, never
    compute, since entering the program alone would wedge the pod.

    The whole family is the ``family`` span of its record, emitted after
    it closes.
    """
    if stem is None:
        stem = _stem(path)
    log = RunLog(stem, enabled=not quiet)
    with log.bound(), span("family"):
        out_path, record = _family(
            log, path, cfg, out_dir, top_k, cache_dir, msa_future, stem,
            cache_key, mesh, emit, cache_read, cache_only,
            emit_errors_fatal, parse_log)
    if record:
        log.emit()
    return out_path


def _family(log: RunLog, path: str, cfg: GDCAConfig, out_dir: str,
            top_k: Optional[int], cache_dir: Optional[str], msa_future,
            stem: str, cache_key: Optional[str], mesh: Optional[Mesh],
            emit: bool, cache_read: bool, cache_only: bool,
            emit_errors_fatal: bool, parse_log: Optional[RunLog]):
    """``run_family``'s work: (the output path or None, whether the
    family's record is emitted)."""
    out_path = os.path.join(out_dir, stem + ".rank.txt")
    if emit:
        try:
            os.makedirs(out_dir, exist_ok=True)
        except OSError:
            if emit_errors_fatal:
                raise
            # recorded by the emit stage below, which tries again
    device = str(mesh.home if mesh is not None else cfg.resolve_device())

    def write_failed(err: str):
        log.set(emit_error=err)
        return None, True

    cached = None
    if cache_dir and emit:
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError:
            if emit_errors_fatal:
                raise
        if cache_key is None:
            cache_key = _cache_key(path, cfg, top_k, _mesh_desc(mesh))
        cached = os.path.join(cache_dir, cache_key)
        if cache_read and os.path.exists(cached):
            try:
                with open(cached) as fh, open(out_path, "w") as out:
                    out.write(fh.read())
            except OSError as e:
                if emit_errors_fatal:
                    raise
                return write_failed(f"{type(e).__name__}: {e}")
            log.set(cached=True, output=out_path, device=device)
            return out_path, True
    if cache_only:
        # an agreed hit whose artifact is gone: serving needs no
        # collective, so this is the writer's own failure
        err = f"pod-agreed cache artifact missing: {cached}"
        if emit_errors_fatal:
            raise RuntimeError(err)
        return write_failed(err)

    with log.stage("ingest"):
        if msa_future is not None:
            msa = msa_future.result()
        else:
            msa = fasta.read_fasta_alignment(path, cfg.max_gap_fraction)
    if parse_log is not None:
        log.absorb(parse_log, thread="prefetch")
    with log.stage("pipeline"):
        result = api.gdca_from_msa(msa, cfg, top_k=top_k, mesh=mesh)
    if not emit:
        return None, False
    R = result.ranking
    try:
        with log.stage("emit"):
            text = format_rank(R)
            os.makedirs(out_dir, exist_ok=True)
            with open(out_path, "w") as fh:
                fh.write(text)
            if cached:
                # write, then rename: an interrupted run never leaves a
                # truncated artifact for the next run to serve
                with open(cached + ".part", "w") as fh:
                    fh.write(text)
                os.replace(cached + ".part", cached)
    except OSError as e:
        if emit_errors_fatal:
            raise
        return write_failed(f"{type(e).__name__}: {e}")

    fl = pipeline_flops(result.M, result.N, result.q, score=cfg.score,
                        auto_theta=cfg.auto_theta, dtype=cfg.resolve_dtype(),
                        shards=mesh.size if mesh is not None else None)
    pipe_s = log.timings["pipeline"]
    log.set(M=result.M, N=result.N, q=result.q,
            dropped_gaps=result.n_dropped_gaps,
            dropped_dups=result.n_dropped_dups,
            theta=round(result.theta, 6), meff=round(result.meff, 4),
            pairs=len(R), score=cfg.score, output=out_path, cached=False,
            tflop=round(fl["total"] / 1e12, 4),
            tflop_per_s=round(fl["total"] / 1e12 / pipe_s, 2)
            if pipe_s > 0 else None,
            device=device, parser=msa.parser)
    return out_path, True


_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "INTERNAL", "UNAVAILABLE",
                      "DEADLINE_EXCEEDED", "ABORTED")


def _retryable(e: BaseException) -> bool:
    """One-retry policy: retry only runtime-flavored failures.

    Deterministic errors (bad input, config or shape bugs: ValueError,
    TypeError, AssertionError, ...) would fail identically on a retry.
    Transient device state is the retry target: RuntimeError (CUDA errors
    and ``torch.cuda.OutOfMemoryError`` are ones) and anything whose
    message carries a transient status code.
    """
    if isinstance(e, (ValueError, OSError)) and \
            not isinstance(e, RuntimeError):
        return False
    if isinstance(e, (NotImplementedError, RecursionError)):
        # RuntimeError subclasses by inheritance, but deterministic
        return False
    if isinstance(e, RuntimeError):
        return True
    name = type(e).__name__
    if "Runtime" in name or "Xla" in name:
        return True
    msg = str(e)
    return any(m in msg for m in _TRANSIENT_MARKERS)


def _refuse(msg: str) -> int:
    print(f"gaussdca_tpu_torch: error: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.fallback:
        return _refuse("--fallback is not supported: the port has no plain "
                       "path on the card (pass --device cpu to run the "
                       "plain versions on the CPU)")
    mesh_spec = _parse_mesh(args.mesh)
    try:
        cfg = GDCAConfig(
            pseudocount=args.pseudocount, theta=_parse_theta(args.theta),
            max_gap_fraction=args.max_gap_fraction, score=args.score,
            min_separation=args.min_separation, remove_dups=args.remove_dups,
            dtype=args.dtype, device=args.device)
    except ValueError as e:
        return _refuse(str(e))
    dev = cfg.resolve_device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        return _refuse(f"--device {args.device}: no CUDA device is visible "
                       "(pass --device cpu to run on the CPU)")
    # --distributed alone deals whole families to the processes, each
    # running its own program; with --mesh it is the pod: every process
    # runs the same sharded program over one mesh spanning them all
    pod = bool(args.distributed and mesh_spec is not None)
    owns_group = args.distributed and not torch.distributed.is_initialized()
    blog = RunLog("batch", enabled=False)   # the spans outside families
    try:
        with blog.bound():
            return _batch(args, cfg, dev, mesh_spec, pod, blog)
    finally:
        if owns_group and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _prefetch(path: str, max_gap_fraction: float, parse_log: RunLog):
    """The parse on the prefetch thread, its spans into ``parse_log``."""
    with parse_log.bound():
        return fasta.read_fasta_alignment(path, max_gap_fraction)


def _batch(args, cfg: GDCAConfig, dev: torch.device, mesh_spec,
           pod: bool, blog: RunLog) -> int:
    # stems are assigned over the FULL batch (collision disambiguation
    # has to agree across --distributed processes sharing an output dir)
    inputs = list(args.inputs)
    stems = _output_stems(inputs)
    merge_path = args.merge_output
    pidx, pcnt = 0, 1
    is_writer = True
    if args.distributed:
        pidx, pcnt = meshlib.init_distributed(force=True,
                                              device=dev if pod else None)
        # one card a process, round-robin over the visible cards
        dev = meshlib.process_device(dev, pidx)
        cfg = dataclasses.replace(cfg, device=str(dev))
        if pod:
            # every process runs the whole batch in order; process 0
            # writes the outputs, once
            is_writer = pidx == 0
            if not is_writer:
                merge_path = None
        else:
            inputs = meshlib.shard_families(inputs, pidx, pcnt)
            stems = meshlib.shard_families(stems, pidx, pcnt)
            if merge_path is not None and pcnt > 1:
                # one file per process: a shared path opened by each
                # would truncate the others' lines
                merge_path = f"{merge_path}.part{pidx}of{pcnt}"
        if not args.quiet:
            joined = torch.distributed.is_initialized()
            print(json.dumps({
                "process": pidx, "of": pcnt, "pod_mesh": pod,
                "families": len(inputs), "device": str(dev),
                "backend": torch.distributed.get_backend()
                if joined else None}), file=sys.stderr, flush=True)

    mesh_obj = None
    if mesh_spec is not None:
        try:
            if pod:
                mesh_obj = meshlib.make_pod_mesh(
                    None if mesh_spec == "auto" else mesh_spec, dev,
                    rank=pidx, world=pcnt)
            elif dev.type == "cpu":
                if mesh_spec == "auto":
                    raise ValueError("--mesh auto lays a mesh over CUDA "
                                     "cards; with --device cpu give a "
                                     "shape like 2,2")
                dp, tp = mesh_spec
                mesh_obj = Mesh([dev] * (dp * tp), (dp, tp))
            else:
                mesh_obj = api.resolve_mesh(mesh_spec)
        except ValueError as e:
            return _refuse(str(e))
        if not args.quiet:
            print(json.dumps({"mesh": mesh_obj.shape}), file=sys.stderr,
                  flush=True)
    mesh_desc = _mesh_desc(mesh_obj)
    # a pod of several processes: what every process runs is agreed
    # before any compute, and its failures are never retried alone
    lockstep = pod and pcnt > 1

    cache_keys: List[Optional[str]] = [None] * len(inputs)
    pod_skip = [False] * len(inputs)
    if pod and args.cache_dir:
        # a hit must skip the program on every process or on none:
        # process 0 decides from its cache and tells the others
        if is_writer:
            for k, path in enumerate(inputs):
                try:
                    cache_keys[k] = _cache_key(path, cfg, args.top_k,
                                               mesh_desc)
                except OSError:
                    cache_keys[k] = None
            pod_skip = [bool(ck and os.path.exists(
                os.path.join(args.cache_dir, ck))) for ck in cache_keys]
        pod_skip = meshlib.broadcast_object(mesh_obj, pod_skip)

    merge_fh = None
    if lockstep:
        # the writer's directories and merge file are set up before any
        # compute and the outcome shared: a writer failing alone here
        # would leave the peers waiting in the first family's program
        setup_err = ""
        if is_writer:
            try:
                os.makedirs(args.output_dir, exist_ok=True)
                if args.cache_dir:
                    os.makedirs(args.cache_dir, exist_ok=True)
                if merge_path:
                    os.makedirs(os.path.dirname(os.path.abspath(
                        merge_path)), exist_ok=True)
                    merge_fh = open(merge_path, "w")
            except OSError as e:
                setup_err = f"{type(e).__name__}: {e}"
        setup_err = meshlib.broadcast_object(mesh_obj, setup_err)
        if setup_err:
            if merge_fh is not None:
                merge_fh.close()
            print(json.dumps({"pod_abort": True, "setup": True,
                              "error": setup_err[:500]}),
                  file=sys.stderr, flush=True)
            return 2

    profiler = None
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()

    t0 = time.perf_counter()
    n_err = 0
    pool = None if args.no_prefetch else \
        concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def submit(k: int, futures) -> None:
        # skip the parse of a family the artifact cache will serve (the
        # key is kept and passed down: the file is hashed only once)
        if pool is None or k >= len(inputs):
            return
        if pod:
            if pod_skip[k]:
                return
        elif args.cache_dir:
            try:
                cache_keys[k] = _cache_key(inputs[k], cfg, args.top_k,
                                           mesh_desc)
                if os.path.exists(os.path.join(args.cache_dir,
                                               cache_keys[k])):
                    return
            except OSError:
                pass
        parse_logs[k] = RunLog(stems[k], enabled=False)
        futures[k] = pool.submit(_prefetch, inputs[k], cfg.max_gap_fraction,
                                 parse_logs[k])

    # the batch's span, closed before the profiler stops
    batch_span = span("batch", families=len(inputs))
    batch_span.__enter__()
    try:
        if merge_path and merge_fh is None:
            os.makedirs(os.path.dirname(os.path.abspath(merge_path)),
                        exist_ok=True)
            merge_fh = open(merge_path, "w")
        futures = [None] * len(inputs)
        parse_logs: List[Optional[RunLog]] = [None] * len(inputs)
        submit(0, futures)
        for k, path in enumerate(inputs):
            submit(k + 1, futures)
            if pod_skip[k] and not is_writer:
                continue  # an agreed hit: nobody computes it
            # cache reads follow the pod's decision, never local state
            kw = dict(stem=stems[k], cache_key=cache_keys[k], mesh=mesh_obj,
                      emit=is_writer, cache_read=not pod or pod_skip[k],
                      cache_only=lockstep and pod_skip[k],
                      emit_errors_fatal=not lockstep)
            quiet = args.quiet or not is_writer
            try:
                try:
                    out_path = run_family(
                        path, cfg, args.output_dir, args.top_k,
                        args.cache_dir, quiet, msa_future=futures[k],
                        parse_log=parse_logs[k], **kw)
                except Exception as e:
                    if lockstep or not _retryable(e):
                        raise  # deterministic errors: fail fast
                    # transient device state: one bounded retry,
                    # parsing the file again (the prefetched future
                    # is consumed). An illegal address poisons the CUDA
                    # context, so after one the retry fails too.
                    if isinstance(e, torch.cuda.OutOfMemoryError):
                        torch.cuda.empty_cache()
                    print(json.dumps({"family": path, "retry": True,
                                      "error": str(e)[:500]}),
                          file=sys.stderr, flush=True)
                    out_path = run_family(
                        path, cfg, args.output_dir, args.top_k,
                        args.cache_dir, quiet, **kw)
                if is_writer and out_path is None:
                    n_err += 1  # a recorded writer failure (pod)
                elif merge_fh is not None and out_path is not None:
                    try:
                        with open(out_path) as fh:
                            for line in fh:
                                merge_fh.write(f"{stems[k]} {line}")
                    except OSError:
                        if not lockstep:
                            raise
                        n_err += 1
                        print(json.dumps({"family": path,
                                          "merge_error": True}),
                              file=sys.stderr, flush=True)
            except Exception as e:
                if lockstep:
                    # the peers may already wait in this program's
                    # collectives, and a retry or a skip would run a
                    # different program here: abort the batch, visibly
                    print(json.dumps({"family": path, "pod_abort": True,
                                      "error_type": type(e).__name__,
                                      "error": str(e)[:500]}),
                          file=sys.stderr, flush=True)
                    raise
                # a family that fails twice (or has bad input) must not
                # abort the rest of the batch: record it and continue
                n_err += 1
                print(json.dumps({"family": path,
                                  "error_type": type(e).__name__,
                                  "error": str(e)[:500]}),
                      file=sys.stderr, flush=True)
    finally:
        batch_span.__exit__(None, None, None)
        if merge_fh is not None:
            merge_fh.close()
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        if profiler is not None:
            profiler.__exit__(None, None, None)
            name = "trace.json" if pcnt == 1 else \
                f"trace.part{pidx}of{pcnt}.json"
            profiler.export_chrome_trace(os.path.join(args.profile_dir,
                                                      name))
    if not args.quiet:
        print(json.dumps({
            "batch": len(inputs), "errors": n_err,
            "total_s": round(time.perf_counter() - t0, 3),
            **blog.traced()}), file=sys.stderr, flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
