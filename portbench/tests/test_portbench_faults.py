"""The check catches what it is there to catch. A run on the CPU with
the card's look skipped, the timed path broken underneath, must come out
not correct, once for each fault a one-card cell can have; and the
control, the reference in TF32 put in the program's place, must fail the
cell's limit. Each tiny cell is held to the limits of the real cell of
its configuration."""

import numpy as np
import pytest

from portbench import harness
from portbench.readings import readings

T0 = 0.0


def _run(root, cell):
    return harness.run_cell(root, cell, 21, 0.2, False, "cpu", T0,
                            bench_dir=root + "/portbench")[0]


def _unchanged_apc(monkeypatch):
    # a step that returns its state unchanged
    from gaussdca_tpu_torch import api
    monkeypatch.setattr(api, "correct_apc", lambda S: S)


def _half_the_rows(monkeypatch):
    # half of the batch of sequences left out, the mean over the rest
    from gaussdca_tpu_torch import api
    orig = api.weighted_frequencies

    def half(Z, W, q, **k):
        h = Z.shape[0] // 2
        k["m_chunk"] = 0
        return orig(Z[:h], W[:h], q, **k)

    monkeypatch.setattr(api, "weighted_frequencies", half)


def _altered_answer(monkeypatch):
    # one answer altered where it is produced: the best pair's score
    from gaussdca_tpu_torch import api
    orig = api.compute_ranking

    def altered(S, m):
        R = orig(S, m)
        i, j, x = R[0]
        R[0] = (i, j, x * 1.5)
        return R

    monkeypatch.setattr(api, "compute_ranking", altered)


def _half_the_families(monkeypatch):
    # half of the batch of families left out
    from gaussdca_tpu_torch import cli
    orig = cli.run_family

    def every_other(path, *a, **k):
        if int(path[-len("0.fasta.gz")]) % 2:
            return None
        return orig(path, *a, **k)

    monkeypatch.setattr(cli, "run_family", every_other)


FAULTS = {"unchanged_apc": _unchanged_apc, "half_the_rows": _half_the_rows,
          "altered_answer": _altered_answer,
          "half_the_families": _half_the_families}


@pytest.mark.parametrize("cell", ["tiny-frob", "tiny-di"])
def test_sound_run_is_correct(bench_copy, cell):
    res = _run(bench_copy, cell)
    assert res["correct"] and res["failed"] == 0, res["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["tiny-frob", "tiny-di"])
def test_fault_is_not_correct(bench_copy, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    res = _run(bench_copy, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["tiny-frob", "tiny-di"])
def test_control_fails_the_limit(bench_copy, cell):
    got = list(readings(bench_copy, cell, [], [31, 32, 33], "cpu",
                        bench_copy + "/portbench"))
    from portbench import spec
    limit = spec.load_cell(bench_copy, cell,
                           bench_copy + "/portbench").limits["score_err"]
    errs = np.array([g["score_err"] for g in got])
    assert len(errs) == 3 and np.all(errs > limit), (errs, limit)
