"""The run, with the timed path broken underneath, must judge itself not
correct; the same run unbroken must judge itself correct.  Each fault is
planted at the answer, as the entry point (``Hnsw.search``,
``fast_flat_knn``, ``Hnsw.generate``) returns it: a step that returns its
state unchanged, half of the batch left out, one id altered with its
distance left as it was.  (One chip: no exchange between chips to leave
out.)  A wrong but valid neighbour returned with its true distance passes
these numbers: only ``recall_at_10``'s bound holds it."""

from __future__ import annotations

import pytest
import torch

import parallel_hnsw_tpu_torch as port
from parallel_hnsw_tpu_torch import EMPTY_DIST, EMPTY_ID, Hnsw

from benchmark.test_bench_support import CELLS, TINY_CONFIG, tiny_run


def _unchanged(ids, dists):
    """The queue a search starts from: nothing found past the entry."""
    ids, dists = ids.clone(), dists.clone()
    ids[:, 1:] = EMPTY_ID
    dists[:, 1:] = EMPTY_DIST
    return ids, dists


def _half(ids, dists):
    return ids[: ids.shape[0] // 2], dists[: dists.shape[0] // 2]


def _altered(ids, dists):
    ids = ids.clone()
    ids[0, 0] = (ids[0, 0] + 1) % TINY_CONFIG["rows"]
    return ids, dists


ANSWER_FAULTS = {"unchanged": _unchanged, "half_batch": _half, "altered": _altered}


def _break_answers(monkeypatch, cell: str, fault) -> None:
    if cell == "sift-flat-batch":
        real = port.fast_flat_knn

        def broken(*args, **kwargs):
            return fault(*real(*args, **kwargs))

        monkeypatch.setattr(port, "fast_flat_knn", broken)
    else:
        real = Hnsw.search

        def broken(self, *args, **kwargs):
            return fault(*real(self, *args, **kwargs))

        monkeypatch.setattr(Hnsw, "search", broken)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = tiny_run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("fault", sorted(ANSWER_FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_answers_are_not_correct(monkeypatch, cell, fault):
    _break_answers(monkeypatch, cell, ANSWER_FAULTS[fault])
    result = tiny_run(cell)
    assert not result["correct"], result["checks"]


def test_build_left_unchanged_is_not_correct(monkeypatch):
    """A build that returns its state unchanged: no layer, no answer."""

    def unchanged(cls, source, vector_ids=None, bp=None, metric=None, **kwargs):
        return cls([], source, metric, bp)

    monkeypatch.setattr(Hnsw, "generate", classmethod(unchanged))
    result = tiny_run("nytimes-build")
    assert not result["correct"]
    assert result["checks"]["missing_rows"]["value"] == TINY_CONFIG["rows"]
    assert result["checks"]["unanswered"]["value"] == TINY_CONFIG["queries"]


def test_build_of_half_the_rows_is_not_correct(monkeypatch):
    real = Hnsw.generate.__func__

    def half(cls, source, *args, **kwargs):
        rows = source.vectors[: source.count // 2].contiguous()
        return real(cls, port.DenseSource(vectors=rows), *args, **kwargs)

    monkeypatch.setattr(Hnsw, "generate", classmethod(half))
    result = tiny_run("nytimes-build")
    assert not result["correct"]
    assert result["checks"]["missing_rows"]["value"] == TINY_CONFIG["rows"] // 2


def test_traced_run_judges_alike():
    """``--trace 1`` decides ``correct`` the same way (on the CPU there is no
    device trace: the per-layer metrics that read one are left out)."""
    result = tiny_run("nytimes-graph-batch", trace=True)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"search.hops.qps"}
    assert result["metrics"]["search.hops.qps"]["value"] > 0
