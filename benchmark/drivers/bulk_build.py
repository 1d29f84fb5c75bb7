"""Bulk build: ``Hnsw.generate`` of the whole corpus, back to back.

Set-up warms with one build of ``warm_fraction`` of the corpus.  A call
builds the index over every row with the configuration's ``BuildParams``
and waits for the card; only the last index is kept.  After the window the
last index is searched with the query set in batches of ``check_batch``
(the graph cells' call), and those answers, with the rows its bottom layer
holds, are what is judged.
"""

from __future__ import annotations

import torch

from parallel_hnsw_tpu_torch import DenseSource, Hnsw, Metric

from benchmark.drivers import build_params, search_params


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.index = None

    def _build(self, rows: torch.Tensor) -> Hnsw:
        return Hnsw.generate(
            DenseSource(vectors=rows), None, build_params(self.cell.config), Metric(self.cell.metric)
        )

    def setup(self) -> None:
        corpus = self.cell.corpus
        warm = max(1, int(corpus.shape[0] * self.cell.traffic["warm_fraction"]))
        self._build(corpus[:warm].contiguous())

    def call(self, i: int) -> int:
        self.index = None  # the last build's memory goes back before the next
        with self.cell.spans.span("build_call"):
            self.index = self._build(self.cell.corpus)
            self.cell.sync()
        return self.cell.corpus.shape[0]

    def finish(self) -> dict:
        cell, index = self.cell, self.index
        sp = search_params(cell.config)
        batch = cell.traffic["check_batch"]
        for offset in range(0, cell.queries.shape[0], batch):
            cell.log.expect(offset, batch)
            if index.layers:  # an index with no layer answers nothing
                ids, dists = index.search(cell.queries[offset : offset + batch], sp)
                cell.log.add(offset, batch, ids[:, : cell.k].cpu(), dists[:, : cell.k].cpu())
        n = cell.corpus.shape[0]
        held = torch.unique(index.layers[-1].nodes.long()) if index.layers else torch.empty(0)
        inside = held[(held >= 0) & (held < n)]
        return {"missing_rows": float(n - inside.numel())}

    def free(self) -> None:
        self.index = None
