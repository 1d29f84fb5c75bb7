"""The plain reference of a product-quantized flat index with exact rerank:
plain torch in float32 (TF32 off), in blocks.

It imports torch, numpy and the benchmark's plain reference alone: nothing
of the program under test, whose codebooks and codes it only reads.  Given
the float32 rows, per-subspace codebooks ``[nsub, K, dsub]`` and codes
``[N, nsub]`` (``uint16`` or integer), it gives:

* :func:`train`: per-subspace codebooks by Lloyd's k-means from the rows
  alone, from the sample and initial centroids that the index's training
  rule draws, so that the program's codebooks can be held to them;
* :func:`encode`: each sub-vector's nearest centroid of its subspace's
  codebook by squared euclidean distance, the reconstruction error, whatever
  the index's metric (the rule ``SubspaceQuantizer.quantize`` states), ties
  to the lowest centroid id;
* :func:`pq_flat_search`: every code decoded, each query's distance to every
  decoded row, the ``k * oversample`` best kept by ``(distance, id)``, then
  the exact distance to those rows' full vectors and the best ``k`` by
  ``(distance, id)``.

Departures from the published description (Jegou, Douze and Schmid,
"Product quantization for nearest neighbor search", IEEE TPAMI 33(1), 2011:
per-subspace k-means codebooks, exhaustive ADC, then a re-ranking of the
short-list with the full vectors):

* k-means runs a fixed number of Lloyd iterations from centroids drawn
  among the sample, with the sample and the draw restated from the index's
  training rule (numpy's ``default_rng(seed + j)`` for subspace ``j``); an
  empty cluster keeps its centroid.  Its assignment takes the least
  ``|c|^2 - 2 x.c`` by one matrix product, not the elementwise differences
  of :func:`encode`: the two part only at ties within float32's rounding.
* The distance to a code is taken to its decoded vector by one matrix
  product, not as a sum of per-subspace lookup tables; the two are the same
  sum, taken in another order in float32.
* Angular distance on decoded rows is the index metric's
  ``(1 - q.x) / 2`` of the decoded vector as it is, not renormalized.
* The short-list is cut by ``(distance, id)`` exactly, where ties at the
  cut would let a selection by distance alone keep either row.

``tf32=True`` computes one precision below: every operand rounded to TF32's
10-bit mantissa (and, on the card, the products in TF32), for the control
(``benchmark/control_pq.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from benchmark import reference


def widen(codes: torch.Tensor) -> torch.Tensor:
    """Codes as int64; ``uint16`` ones through their int16 bit pattern (torch
    indexes and compares few ``uint16`` tensors)."""
    if codes.dtype == torch.uint16:
        return codes.view(torch.int16).long() & 0xFFFF
    return codes.long()


def _rounded(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    return reference.round_tf32(x) if tf32 else x


def encode(rows: torch.Tensor, codebooks: torch.Tensor, tf32: bool = False,
           block_bytes: int = 1 << 30) -> torch.Tensor:
    """``[N, nsub * dsub]`` float32 rows -> ``[N, nsub]`` int64 codes: per
    subspace the centroid of least ``sum((x - c)^2)``, by elementwise
    differences (no matrix product), the first of equal ones."""
    nsub, k, dsub = codebooks.shape
    if rows.shape[1] != nsub * dsub:
        raise ValueError(f"rows of width {rows.shape[1]} against {nsub} x {dsub} codebooks")
    block = max(1, block_bytes // (4 * k * dsub))
    books = _rounded(codebooks.float(), tf32)
    out = torch.empty((rows.shape[0], nsub), dtype=torch.int64, device=rows.device)
    for start in range(0, rows.shape[0], block):
        x = _rounded(rows[start : start + block].float(), tf32).reshape(-1, nsub, dsub)
        for j in range(nsub):
            diff = x[:, j, None, :] - books[j][None, :, :]  # [b, K, dsub]
            out[start : start + block, j] = torch.argmin((diff * diff).sum(-1), dim=1)
    return out


#: past this many rows the index's training rule draws its sample another way
#: (with replacement), which is not restated here
MAX_TRAIN_ROWS = 50_000_000


def _nearest(x: torch.Tensor, c: torch.Tensor, tf32: bool, block_rows: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's nearest centroid by least ``|c|^2 - 2 x.c`` (the first of
    equal ones), and its squared distance ``|x|^2 + |c|^2 - 2 x.c``."""
    c = _rounded(c, tf32)
    c2 = (c * c).sum(1)
    assign = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    sq = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    with reference.matmul_precision(tf32):
        for s in range(0, x.shape[0], block_rows):
            rows = x[s : s + block_rows]
            least, assign[s : s + block_rows] = torch.addmm(c2[None, :], rows, c.T, alpha=-2.0).min(1)
            sq[s : s + block_rows] = (least + (rows * rows).sum(1)).clamp_min(0.0)
    return assign, sq


def train(rows: torch.Tensor, n_centroids: int, dsub: int, iters: int, sample: int,
          seed: int = 0, tf32: bool = False, block_rows: int = 1 << 19
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(codebooks [nsub, K, dsub] float32, radius [nsub])``: for subspace
    ``j``, Lloyd's k-means over a sample of ``sample`` rows' sub-vectors,
    those at the first ``sample`` places of
    ``default_rng(seed + j).permutation(N)`` (all rows, in order, if
    ``sample >= N``), from the ``K`` initial centroids at the first places of
    a fresh ``default_rng(seed + j).permutation(len(sample))``.  ``radius`` is
    each subspace's root mean squared distance of the sample to its nearest
    centroid of the codebook returned."""
    n, dim = rows.shape
    if dim % dsub:
        raise ValueError(f"rows of width {dim} against sub-vectors of {dsub}")
    if n > MAX_TRAIN_ROWS:
        raise ValueError(f"{n} rows: the sample past {MAX_TRAIN_ROWS} rows is not restated")
    books, radius = [], []
    for j in range(dim // dsub):
        col = rows[:, j * dsub : (j + 1) * dsub]
        if sample < n:
            pick = np.random.default_rng(seed + j).permutation(n)[:sample]
            col = col[torch.as_tensor(pick, device=rows.device)]
        x = _rounded(col.float().contiguous(), tf32)
        k = min(n_centroids, x.shape[0])
        init = np.random.default_rng(seed + j).permutation(x.shape[0])[:k]
        c = x[torch.as_tensor(init, device=x.device)]
        for _ in range(iters):
            assign, _ = _nearest(x, c, tf32, block_rows)
            sums = torch.zeros_like(c).index_add_(0, assign, x)
            counts = torch.bincount(assign, minlength=k).float()[:, None]
            c = torch.where(counts > 0, sums / counts.clamp_min(1.0), c)
        books.append(c)
        radius.append(_nearest(x, c, tf32, block_rows)[1].mean().sqrt())
    return torch.stack(books), torch.stack(radius)


def decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """``[N, nsub]`` codes -> ``[N, nsub * dsub]`` float32 rows."""
    codes = widen(codes)
    return torch.cat([codebooks[j][codes[:, j]] for j in range(codebooks.shape[0])], dim=1)


def smallest(d: torch.Tensor, kk: int) -> torch.Tensor:
    """Columns of the ``kk`` least entries of each row of ``d``, by
    ``(value, column)``, in that order."""
    kk = min(kk, d.shape[1])
    vals, pos = torch.topk(d, kk, dim=1, largest=False, sorted=True)
    cut = vals[:, -1:]
    # rows where entries equal to the kk-th straddle the cut: topk keeps any
    # of them, the order keeps the lowest columns
    for r in torch.nonzero((d <= cut).sum(1) > kk)[:, 0].tolist():
        below = torch.nonzero(d[r] < cut[r])[:, 0]
        tied = torch.nonzero(d[r] == cut[r])[:, 0][: kk - below.numel()]
        pos[r] = torch.cat([below, tied])
    return by_value_then_id(torch.gather(d, 1, pos), pos)[1]


def by_value_then_id(vals: torch.Tensor, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals, ids)`` of each row sorted by ``(value, id)``."""
    order = torch.sort(ids, dim=1, stable=True).indices
    vals, ids = torch.gather(vals, 1, order), torch.gather(ids, 1, order)
    order = torch.sort(vals, dim=1, stable=True).indices
    return torch.gather(vals, 1, order), torch.gather(ids, 1, order)


def _exact(corpus: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor, metric: str,
           tf32: bool) -> torch.Tensor:
    """``dist(queries[q], corpus[ids[q, j]])`` by elementwise products."""
    if not tf32:
        return reference.pair_distances(corpus, queries, ids, metric)
    rows = reference.round_tf32(corpus[ids]).view(-1, corpus.shape[1])
    local = torch.arange(ids.numel(), device=ids.device).view(ids.shape)
    return reference.pair_distances(rows, reference.round_tf32(queries), local, metric)


def pq_flat_search(
    corpus: torch.Tensor,
    codebooks: torch.Tensor,
    codes: torch.Tensor,
    queries: torch.Tensor,
    metric: str,
    k: int,
    oversample: int,
    tf32: bool = False,
    block_bytes: int = 4 << 30,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids [Q, k] int64, dists [Q, k])``, ascending by ``(dist, id)``: the
    ``k * oversample`` nearest decoded rows of each query, reranked by their
    exact float32 distance, in query blocks of at most ``block_bytes`` of
    distances."""
    decoded = decode(codes, codebooks.float())
    block = max(1, block_bytes // (4 * decoded.shape[0]))
    out_i, out_d = [], []
    for start in range(0, queries.shape[0], block):
        q = queries[start : start + block]
        d = reference.distances(q, decoded, metric, tf32)
        survivors = smallest(d, k * oversample)
        del d
        dists, ids = by_value_then_id(_exact(corpus, q, survivors, metric, tf32), survivors)
        out_i.append(ids[:, :k])
        out_d.append(dists[:, :k])
    return torch.cat(out_i), torch.cat(out_d)
