"""Flat scan: ``fast_flat_knn`` (the scan behind
``Hnsw.search_exact(fast=True)``) on batches of the query set, back to back.

No graph: set-up makes one warm call at the cell's batch.  A call sends the
next ``batch`` queries (in turn, wrapping) and ends with the top-k ids and
distances on the host.
"""

from __future__ import annotations

from parallel_hnsw_tpu_torch import DenseSource, Metric, fast_flat_knn


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.batch = cell.traffic["batch"]
        if cell.queries.shape[0] % self.batch:
            raise ValueError(f"batch {self.batch} does not divide the {cell.queries.shape[0]} queries")

    def setup(self) -> None:
        self.source = DenseSource(vectors=self.cell.corpus)
        self.call(0)

    def call(self, i: int) -> int:
        cell, traffic = self.cell, self.cell.traffic
        offset = (i * self.batch) % cell.queries.shape[0]
        q = cell.queries[offset : offset + self.batch]
        cell.log.expect(offset, self.batch)
        with cell.spans.span("scan_call"):
            ids, dists = fast_flat_knn(
                self.source, q, Metric(cell.metric), cell.k,
                oversample=traffic["oversample"], scan_mode=traffic["scan_mode"],
            )
        with cell.spans.span("ids_to_host"):
            ids, dists = ids.cpu(), dists.cpu()
        cell.log.add(offset, self.batch, ids, dists)
        return self.batch

    def finish(self) -> dict:
        return {}

    def free(self) -> None:
        self.source = None
