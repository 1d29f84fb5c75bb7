"""The plain reference: exact top-k and the distances of given ids, in
float32 with plain torch operations, in blocks.

It imports torch alone: nothing of the program under test, whose answers it
only reads to judge them.  Matrix products run in full float32 (TF32 off)
unless ``tf32`` asks for the lower precision that the control uses: then
both operands are rounded to TF32's 10-bit mantissa first and, on the card,
TF32 is switched on for the product, as a float32 program that let TF32 in
would compute.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import torch

METRICS = ("normalized_cosine", "euclidean")


@contextlib.contextmanager
def matmul_precision(tf32: bool) -> Iterator[None]:
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest value with a 10-bit mantissa (TF32)."""
    bits = x.contiguous().view(torch.int32)
    half = (bits >> 13) & 1  # ties to even
    return ((bits + 0x0FFF + half) & ~0x1FFF).view(torch.float32)


def distances(queries: torch.Tensor, rows: torch.Tensor, metric: str, tf32: bool = False):
    """``[Q, D] x [C, D] -> [Q, C]`` by one matrix product and the metric's
    epilogue (normalized cosine ``(1 - q.x) / 2``; euclidean
    ``sqrt(|q|^2 + |x|^2 - 2 q.x)``)."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    a, b = (round_tf32(queries), round_tf32(rows)) if tf32 else (queries, rows)
    with matmul_precision(tf32):
        dots = a @ b.T
    if metric == "normalized_cosine":
        return (1.0 - dots) / 2.0
    q2 = (queries * queries).sum(1, keepdim=True)
    x2 = (rows * rows).sum(1)[None, :]
    return (q2 + x2 - 2.0 * dots).clamp_min(0.0).sqrt()


def exact_topk(
    corpus: torch.Tensor,
    queries: torch.Tensor,
    metric: str,
    k: int,
    tf32: bool = False,
    block_bytes: int = 4 << 30,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact ``(ids [Q, k] int64, dists [Q, k])``, ascending, over the whole
    corpus, in query blocks of at most ``block_bytes`` of distances."""
    block = max(1, block_bytes // (4 * corpus.shape[0]))
    ids, dists = [], []
    for start in range(0, queries.shape[0], block):
        d = distances(queries[start : start + block], corpus, metric, tf32)
        vals, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
        ids.append(idx)
        dists.append(vals)
        del d
    return torch.cat(ids), torch.cat(dists)


def pair_distances(
    corpus: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor, metric: str
) -> torch.Tensor:
    """``dist(queries[q], corpus[ids[q, j]])`` for ``ids [Q, k]`` (every id a
    row of the corpus), by elementwise products and sums: no matrix product."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    rows = corpus[ids]
    if metric == "normalized_cosine":
        return (1.0 - (rows * queries[:, None, :]).sum(-1)) / 2.0
    diff = rows - queries[:, None, :]
    return (diff * diff).sum(-1).sqrt()
