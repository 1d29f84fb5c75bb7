"""PQ flat scan: a scan-only ``QuantizedHnsw`` (codebooks and codes, no code
graph) searched by ``search_exact`` on batches of the query set, back to back.

Set-up trains the configuration's per-subspace codebooks, quantizes the
whole corpus into codes (``QuantizedHnsw.new(..., build_graph=False)`` over
the f32 corpus, which stays on the card for the exact rerank) and makes one
warm call at the cell's batch.  A call sends the next ``batch`` queries (in
turn, wrapping), scans every code keeping ``oversample * k`` survivors a
query, reranks them against the f32 rows and ends with the top-k ids and
distances on the host.  After the window the plain PQ reference holds the
index's codebooks, its codes and every answer to it (``judge_pq``).
"""

from __future__ import annotations

import torch

from parallel_hnsw_tpu_torch import DenseSource, Metric, QuantizedHnsw

from benchmark import judge_pq


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.batch = cell.traffic["batch"]
        if cell.queries.shape[0] % self.batch:
            raise ValueError(f"batch {self.batch} does not divide the {cell.queries.shape[0]} queries")
        self.index = None

    def setup(self) -> None:
        cell, pq = self.cell, self.cell.config["pq"]
        self.index = QuantizedHnsw.new(
            pq["centroids"], DenseSource(vectors=cell.corpus), pq["dsub"], Metric(cell.metric),
            seed=pq["seed"], use_kmeans=pq["use_kmeans"], per_subspace=pq["per_subspace"],
            kmeans_sample=pq["kmeans_sample"], kmeans_iters=pq["iters"],
            fast_quantize=pq["fast_quantize"],
            chunk_size=pq["chunk_size"], code_dtype=getattr(torch, pq["codes"]),
            build_graph=False,
        )
        self.call(0)

    def call(self, i: int) -> int:
        cell = self.cell
        offset = (i * self.batch) % cell.queries.shape[0]
        q = cell.queries[offset : offset + self.batch]
        cell.log.expect(offset, self.batch)
        with cell.spans.span("scan_call"):
            ids, dists = self.index.search_exact(q, k=cell.k, rerank=True,
                                                 oversample=cell.traffic["oversample"])
            ids, dists = ids.cpu(), dists.cpu()
        cell.log.add(offset, self.batch, ids, dists)
        return self.batch

    def finish(self) -> dict:
        cell, source = self.cell, self.index.hnsw.source
        return judge_pq.numbers(cell.log, cell.corpus, cell.queries, source.codebook, source.codes,
                                cell.metric, cell.k, cell.traffic["oversample"], cell.config["pq"])

    def free(self) -> None:
        self.index = None
