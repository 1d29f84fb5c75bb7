"""Faults of the timed PQ path, for the checks that ``deep-pq-batch``'s
compared numbers catch them: each planted where the program computes it,
under :func:`planted`.  ``benchmark/test_bench_pq.py`` plants them in a
shrunk cell on the CPU, ``studies/pq_scan_faults.py`` at the cell's full
size on the card.  ``dist_gap``, ``bad_rows`` and ``unanswered`` pass every
one of them: every id returned is a row with its true distance."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Tuple

import torch

from parallel_hnsw_tpu_torch import EMPTY_DIST, EMPTY_ID, QuantizedHnsw, SubspaceQuantizer
from parallel_hnsw_tpu_torch import pq as program_pq

Patch = Tuple[object, str, object]


def dropped_code_block() -> List[Patch]:
    """The scan leaves out the codes of its second block (of either route)."""
    real = program_pq._cut_survivors

    def cut(bin_d, bin_cols, offset, kk):
        ids, dists = real(bin_d, bin_cols, offset, kk)
        if offset in (1 << 16, 1 << 19):
            return torch.full_like(ids, EMPTY_ID), torch.full_like(dists, EMPTY_DIST)
        return ids, dists

    return [(program_pq, "_cut_survivors", cut)]


def decoded_with_next_subspace() -> List[Patch]:
    """The scan decodes each code against the next subspace's codebook."""
    real = program_pq.reconstruct
    return [(program_pq, "reconstruct", lambda codebook, codes: real(codebook.roll(1, dims=0), codes))]


def survivors_cut_at_k() -> List[Patch]:
    """The scan keeps ``k`` survivors a query for the rerank, not ``k * oversample``."""
    real = QuantizedHnsw.search_exact

    def search_exact(self, queries, k=10, rerank=True, oversample=4, **kwargs):
        return real(self, queries, k=k, rerank=rerank, oversample=1, **kwargs)

    return [(QuantizedHnsw, "search_exact", search_exact)]


def codes_off_by_one() -> List[Patch]:
    """The quantizer gives the first subspace the next centroid's code."""
    real = SubspaceQuantizer.quantize

    def quantize(self, vecs, exact=False, fast=False):
        codes = real(self, vecs, exact=exact, fast=fast)
        codes[:, 0] = (codes[:, 0] + 1) % self.n_centroids
        return codes

    return [(SubspaceQuantizer, "quantize", quantize)]


def kmeans_iterations_skipped() -> List[Patch]:
    """Training returns its initial centroids: no Lloyd iteration runs."""
    return [(program_pq, "_kmeans_plain", lambda data, init, k, iters: init.float()),
            (program_pq, "_kmeans_big", lambda subs, init, k, iters, block=0: init.float())]


def book_on_next_columns() -> List[Patch]:
    """The first subspace's codebook is fitted on the second subspace's columns."""
    real = program_pq.per_subspace_centroids

    def per_subspace_centroids(vectors, n_centroids, dsub, **kwargs):
        shifted = vectors.clone()
        shifted[:, :dsub] = vectors[:, dsub : 2 * dsub]
        return real(shifted, n_centroids, dsub, **kwargs)

    return [(program_pq, "per_subspace_centroids", per_subspace_centroids)]


def sample_from_first_half() -> List[Patch]:
    """Training samples its sub-vectors from the first half of the rows only."""
    real = program_pq.kmeans_centroids

    def kmeans_centroids(vectors, *args, **kwargs):
        return real(vectors[: vectors.shape[0] // 2], *args, **kwargs)

    return [(program_pq, "kmeans_centroids", kmeans_centroids)]


FAULTS: Dict[str, Callable[[], List[Patch]]] = {
    f.__name__: f
    for f in (dropped_code_block, decoded_with_next_subspace, survivors_cut_at_k, codes_off_by_one,
              kmeans_iterations_skipped, book_on_next_columns, sample_from_first_half)
}


@contextlib.contextmanager
def planted(name: str) -> Iterator[None]:
    """The program with fault ``name`` in it, as it was again on leaving."""
    patches = FAULTS[name]()
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    for owner, attr, value in patches:
        setattr(owner, attr, value)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
