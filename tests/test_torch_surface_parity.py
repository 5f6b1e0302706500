"""PyTorch port: every public function and class of the JAX package is
accounted for.

For each module of ``gaussdca_tpu/``, every public top-level function
and class defined there passes exactly one of three checks:

- the port's module of the same path has the same name; or
- ``COUNTERPART`` maps it to the port's function that does its work;
- ``NOT_PORTED`` gives the reason it has no counterpart (ROADMAP.md,
  "Not ported or dropped").

A public name in neither table and absent from the port, a counterpart
that does not exist, a name listed twice over, and a table entry that
names nothing in the JAX package all fail. Private names (``_...``) and
``__main__`` are out of scope.
"""

import importlib
import inspect
import pkgutil

import pytest

import gaussdca_tpu

# "module:name" in gaussdca_tpu -> "module:name" in gaussdca_tpu_torch
COUNTERPART = {
    "ops.di_kernel:ns_sqrtm_pallas": "ops.di_kernel:di_pairs",
    "ops.distance:row_stats_sym_pallas": "ops.distance:row_stats",
    "ops.distance:row_stats_pallas": "ops.distance:row_stats_full",
    "ops.distance:row_stats_rect_pallas": "ops.distance:row_stats_rect",
    "ops.distance:row_stats_rect_jnp": "ops.distance:row_stats_rect_torch",
    "ops.distance:row_stats_asym_pallas": "ops.distance:row_stats_asym",
    "ops.distance:row_stats_sym_e8_pallas": "ops.distance:row_stats_sym_e8",
    "ops.distance:match_counts_pallas": "ops.distance:match_counts",
    "ops.distance:match_counts_mxu": "ops.distance:match_counts_torch",
    "parallel.sharded:sharded_scores_fn": "parallel.sharded:sharded_scores",
    "score.di:sqrtm_spd_fixed": "ops.di_kernel:ns_sqrtm_torch",
    "score.di:di_pairs_flat": "ops.di_kernel:di_pairs",
    "score.di:bm_ns_iters": "score.di:ns_iters",
    "score.di:matmuls_per_lane": "utils.flops:di_pair_flops",
}

_AOT = ("eager PyTorch with prebuilt kernels compiles nothing per shape, "
        "so there is nothing to compile ahead or cache")
_LANES = ("a TPU lane layout of DI; kernel B reads each pair's block by "
          "index from a row slab and needs no tiles")
_TRSM = ("a TPU TRSM workaround; solve.cholesky inverts the factor by "
         "block column triangular solves and forms W^T W by block rows")
_SHARDING = ("a NamedSharding helper; the port's Mesh places each shard "
             "on its device explicitly")

NOT_PORTED = {
    "api:put_global": "assembles a global jax.Array across processes; "
                      "each pod process holds Z whole and places its own "
                      "shards (parallel.mesh)",
    "api:warm_compile": _AOT,
    "parallel.sharded:cached_scores_fn": _AOT,
    "parallel.podspawn:free_port": "spawn_pod hosts the rendezvous store "
                                   "on a port the system assigns; no free "
                                   "port is chosen, released and bound "
                                   "again",
    "utils.exe_cache:ExecutableCache": _AOT,
    "ops.dispatch:kernels": "GDCA_DISTANCE_IMPL picks among duplicate "
                            "paths of one W; a caller passes row_stats_fn "
                            "or calls compute_weights",
    "parallel.mesh:data_sharding": _SHARDING,
    "parallel.mesh:model_sharding": _SHARDING,
    "parallel.mesh:replicated": _SHARDING,
    "score.di:sqrtm_spd": "the tolerance-stopped iteration; the port runs "
                          "JAX's fixed step rule (score.di.ns_iters)",
    "score.di:di_pairs_bm_gathered": _LANES,
    "score.di:di_score_bm_mapped": _LANES,
    "score.di:di_score_bm_tiled": _LANES,
    "score.di:accounting_plan": "flop accounting of the TPU lane layouts; "
                                "utils.flops counts the pairs kernel B "
                                "scores",
    "score.di:planned_lane_count": "flop accounting of the TPU lane "
                                   "layouts; utils.flops counts the pairs "
                                   "kernel B scores",
    "solve.cholesky:tri_inverse_doubling": _TRSM,
    "solve.cholesky:syrk_lower_blocked": _TRSM,
    "solve.cholesky:syrk_lower_slab": _TRSM,
    "solve.cholesky:chunked_cho_inverse": _TRSM,
    "solve.blocked:blocked_cholesky": "the compute-sharded tested "
                                      "alternative; the port's mesh runs "
                                      "the storage-sharded solve",
    "solve.blocked:tri_inverse_apply": "the compute-sharded tested "
                                       "alternative; the port's mesh runs "
                                       "the storage-sharded solve",
    "solve.blocked:spd_inverse_blocked": "the compute-sharded tested "
                                         "alternative; the port's mesh "
                                         "runs the storage-sharded solve",
    "utils.chunked:balanced_chunk": "sizes lax.map chunks of a traced "
                                    "graph; the port loops over row "
                                    "chunks in Python",
    "utils.chunked:map_rows": "lax.map over row chunks of a traced graph; "
                              "the port loops over row chunks in Python",
}


def _jax_modules():
    names = ["gaussdca_tpu"]
    for m in pkgutil.walk_packages(gaussdca_tpu.__path__, "gaussdca_tpu."):
        if not m.name.endswith("__main__"):
            names.append(m.name)
    return names


def _public(modname):
    """The public top-level functions and classes defined in modname."""
    mod = importlib.import_module(modname)
    return sorted(n for n, o in vars(mod).items()
                  if not n.startswith("_") and callable(o)
                  and not inspect.ismodule(o)
                  and getattr(o, "__module__", None) == modname)


def _rel(modname):
    return modname[len("gaussdca_tpu."):] if "." in modname else ""


def _port(rel):
    return importlib.import_module(
        "gaussdca_tpu_torch" + (f".{rel}" if rel else ""))


def _port_has(rel, name):
    try:
        return hasattr(_port(rel), name)
    except ImportError:
        return False


@pytest.mark.parametrize("modname", _jax_modules())
def test_every_public_name_is_accounted_for(modname):
    rel = _rel(modname)
    wrong = []
    for name in _public(modname):
        key = f"{rel}:{name}"
        checks = [_port_has(rel, name), key in COUNTERPART,
                  key in NOT_PORTED]
        if sum(checks) != 1:
            wrong.append((name, checks))
            continue
        if key in COUNTERPART:
            prel, pname = COUNTERPART[key].split(":")
            if not callable(getattr(_port(prel), pname, None)):
                wrong.append((name, f"no {COUNTERPART[key]} in the port"))
        if key in NOT_PORTED and not NOT_PORTED[key].strip():
            wrong.append((name, "no reason given"))
    assert not wrong, (
        f"{modname}: each public name must be in the port's module, in "
        "COUNTERPART or in NOT_PORTED, exactly one of them (same name, "
        f"counterpart, not ported): {wrong}")


def test_tables_name_only_jax_public_names():
    known = {f"{_rel(m)}:{n}" for m in _jax_modules() for n in _public(m)}
    stale = sorted((set(COUNTERPART) | set(NOT_PORTED)) - known)
    assert not stale, f"table entries naming nothing in gaussdca_tpu: {stale}"
    assert not set(COUNTERPART) & set(NOT_PORTED)
