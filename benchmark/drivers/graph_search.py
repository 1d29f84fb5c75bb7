"""Graph search: ``Hnsw.search`` on batches of the query set, back to back.

Set-up builds the index over the whole corpus with the configuration's
``BuildParams`` and makes one warm call at the cell's batch.  A call sends
the next ``batch`` queries of the set (in turn, wrapping) and ends with the
top-k ids and distances on the host.
"""

from __future__ import annotations

from parallel_hnsw_tpu_torch import DenseSource, Hnsw, Metric

from benchmark.drivers import build_params, search_params


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.batch = cell.traffic["batch"]
        n_queries = cell.queries.shape[0]
        if n_queries % self.batch:
            raise ValueError(f"batch {self.batch} does not divide the {n_queries} queries")
        self.index = None

    def setup(self) -> None:
        cell = self.cell
        self.index = Hnsw.generate(
            DenseSource(vectors=cell.corpus), None, build_params(cell.config), Metric(cell.metric)
        )
        self.sp = search_params(cell.config)
        self.call(0)

    def batch_at(self, i: int):
        offset = (i * self.batch) % self.cell.queries.shape[0]
        return offset, self.cell.queries[offset : offset + self.batch]

    def call(self, i: int) -> int:
        cell = self.cell
        offset, q = self.batch_at(i)
        cell.log.expect(offset, self.batch)
        with cell.spans.span("search_call"):
            ids, dists = self.index.search(q, self.sp)
        with cell.spans.span("ids_to_host"):
            ids, dists = ids[:, : cell.k].cpu(), dists[:, : cell.k].cpu()
        cell.log.add(offset, self.batch, ids, dists)
        return self.batch

    def hops(self, i: int) -> int:
        """Hops of ``Hnsw.search_instrumented`` on the cell's ``i``-th batch."""
        return self.index.search_instrumented(self.batch_at(i)[1], self.sp)[2]["hops"]

    def finish(self) -> dict:
        return {}

    def free(self) -> None:
        self.index = None
