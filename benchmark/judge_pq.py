"""The compared numbers that hold a product-quantized index to the plain
reference (``reference_pq``), beside ``judge``'s.  They hold each step of the
index to the one before it, from the corpus alone to the answers:

* ``codebook_gap``: the mean distance between each of the index's centroids
  and the same centroid of the reference's own codebooks, trained from the
  corpus by ``reference_pq.train`` with the configuration's centroids,
  sample, iterations and seed, in units of the subspace's quantization
  radius (the reference codebook's root mean squared distance of the sample
  to its nearest centroid).  It catches training that skips iterations,
  fits a subspace on other columns or samples other rows: faults that leave
  the codes consistent with their codebooks and the scan with its codes.
* ``code_disagree``: the share of the index's codes, over a seeded sample of
  at most ``SAMPLE_ROWS`` corpus rows, that differ from the reference's
  ``encode`` of those rows with the index's own codebooks.  It catches a
  quantizer that assigns sub-vectors to the wrong centroids.
* ``pq_top10_miss``: the share of the reference ``pq_flat_search``'s top-k
  ids (over the index's codebooks and codes), over every answer of the
  window, missing from the program's top-k.  It catches a scan that decodes
  or cuts wrongly, or leaves codes out, where ``dist_gap`` passes any valid
  id returned with its true distance and only recall would move.
"""

from __future__ import annotations

import torch

from benchmark import data, judge, reference, reference_pq

SAMPLE_ROWS = 1_000_000
#: the sample is the same rows in every run of a size
SAMPLE_SEED = 0


def code_disagree(corpus: torch.Tensor, codebooks: torch.Tensor, codes: torch.Tensor) -> float:
    n = corpus.shape[0]
    gen = data.generator(SAMPLE_SEED, corpus.device)
    pick = torch.randperm(n, generator=gen, device=corpus.device)[:SAMPLE_ROWS]
    want = reference_pq.encode(corpus[pick], codebooks.float())
    got = reference_pq.widen(codes)[pick.to(codes.device)]
    return float((want != got.to(want.device)).float().mean())


def codebook_gap(corpus: torch.Tensor, codebooks: torch.Tensor, pq: dict) -> float:
    want, radius = reference_pq.train(corpus, pq["centroids"], pq["dsub"], pq["iters"],
                                      pq["kmeans_sample"], pq["seed"])
    moved = torch.linalg.vector_norm(codebooks.float().to(want.device) - want, dim=-1)
    return float((moved / radius[:, None]).mean())


def top_k_miss(log: judge.AnswerLog, ref_ids: torch.Tensor, k: int) -> float:
    """Missed reference ids over all reference ids of the answers in ``log``
    (an answer of the wrong shape is ``unanswered``'s, and counted here as
    missing every id)."""
    missed = total = 0
    for a in log.answers:
        ref = ref_ids[a.offset : a.offset + a.due, :k]
        ids = a.ids.to(ref.device).long()
        total += ref.numel() * a.count
        if ids.ndim != 2 or ids.shape[0] != a.due or ids.shape[1] < k:
            missed += ref.numel() * a.count
            continue
        hit = (ref[:, :, None] == ids[:, None, :k]).any(-1)
        missed += int((~hit).sum()) * a.count
    return missed / total if total else 1.0


def numbers(log: judge.AnswerLog, corpus: torch.Tensor, queries: torch.Tensor,
            codebooks: torch.Tensor, codes: torch.Tensor, metric: str, k: int,
            oversample: int, pq: dict) -> dict:
    """The three numbers for the answers in ``log`` from an index of
    ``codebooks`` and ``codes`` trained by the settings ``pq``."""
    with reference.matmul_precision(False):
        gap = codebook_gap(corpus, codebooks, pq)
        disagree = code_disagree(corpus, codebooks, codes)
        ref_ids, _ = reference_pq.pq_flat_search(corpus, codebooks, codes, queries, metric, k, oversample)
    return {"codebook_gap": gap, "code_disagree": disagree,
            "pq_top10_miss": top_k_miss(log, ref_ids, k)}
