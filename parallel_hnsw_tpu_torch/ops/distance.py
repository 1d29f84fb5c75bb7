"""Distance metrics on tensors (counterpart of ``parallel_hnsw_tpu.ops.distance``).

* :func:`pairwise_distance` — ``[Q, D] x [C, D] -> [Q, C]``: one fp32 matmul
  plus the metric epilogue.  It is the plain version of the hand-written
  kernel in :mod:`parallel_hnsw_tpu_torch.ops.cuda_distance` in exact mode.
* :func:`pairwise_distance_bf16_dots` — the plain version of that kernel's
  fast mode: dots of the operands rounded to bf16, everything else f32.
* :func:`batched_distance` — ``[..., D] x [..., C, D] -> [..., C]`` per-query
  gathered candidate blocks (the beam-search hop).
* :func:`distance_one` — ``[..., D] x [..., D] -> [...]`` paired distances.

Every matmul here must run in full fp32: distances feed the 1e-5 self-match
epsilon (``constants.MATCH_EPSILON``), which TF32 would break, so a CUDA
operand with ``torch.backends.cuda.matmul.allow_tf32`` set raises.
"""

from __future__ import annotations

import enum

import torch


class Metric(str, enum.Enum):
    """Distance kinds. str-valued for easy JSON persistence."""

    COSINE = "cosine"  # 1 - dot        (unit vectors assumed)
    NORMALIZED_COSINE = "normalized_cosine"  # (1 - dot) / 2  (unit vectors assumed)
    EUCLIDEAN = "euclidean"  # sqrt(sum sq)
    SQUARED_EUCLIDEAN = "squared_euclidean"  # sum sq
    DOT = "dot"  # -dot (maximum inner product as a minimized distance)


def _finish_dot(dots: torch.Tensor, metric: Metric) -> torch.Tensor:
    if metric is Metric.COSINE:
        return 1.0 - dots
    if metric is Metric.NORMALIZED_COSINE:
        return (1.0 - dots) / 2.0
    if metric is Metric.DOT:
        return -dots
    raise ValueError(f"not a dot-based metric: {metric}")


def _is_dot_based(metric: Metric) -> bool:
    return metric in (Metric.COSINE, Metric.NORMALIZED_COSINE, Metric.DOT)


def check_fp32_matmul(x: torch.Tensor) -> None:
    """Raise if a CUDA matmul on ``x`` would run in TF32."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is set: exact distances "
            "need full fp32 matmuls (the 1e-5 self-match epsilon depends on it)"
        )


def _finish_pairwise(
    dots: torch.Tensor, x: torch.Tensor, y: torch.Tensor, metric: Metric
) -> torch.Tensor:
    """The metric's epilogue on ``dots [Q, C]``; the L2 family's norms are
    summed from ``x`` and ``y`` as given."""
    if _is_dot_based(metric):
        return _finish_dot(dots, metric)
    # euclidean family: ||x||^2 + ||y||^2 - 2 x.y
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1)[None, :]
    sq = torch.clamp(x2 + y2 - 2.0 * dots, min=0.0)
    if metric is Metric.SQUARED_EUCLIDEAN:
        return sq
    return torch.sqrt(sq)


def pairwise_distance(
    x: torch.Tensor, y: torch.Tensor, metric: Metric, exact: bool = True
) -> torch.Tensor:
    """``[Q, D] x [C, D] -> [Q, C]`` distances; one fp32 matmul.

    ``exact`` is accepted for signature parity with the kernel's wrapper; both
    values compute in fp32 here (as the JAX package does on a CPU)."""
    metric = Metric(metric)
    check_fp32_matmul(x)
    return _finish_pairwise(torch.matmul(x, y.T), x, y, metric)


def pairwise_distance_bf16_dots(x: torch.Tensor, y: torch.Tensor, metric: Metric) -> torch.Tensor:
    """``[Q, D] x [C, D] -> [Q, C]`` distances in the kernel's fast mode: the
    dots of the operands rounded to bf16, accumulated in f32 (one f32 matmul
    of the widened values: products of bf16 values are exact in f32); the L2
    family's norms from the unrounded f32 operands; the same epilogue."""
    metric = Metric(metric)
    check_fp32_matmul(x)
    dots = torch.matmul(x.to(torch.bfloat16).float(), y.to(torch.bfloat16).float().T)
    return _finish_pairwise(dots, x, y, metric)


def batched_distance(q: torch.Tensor, cands: torch.Tensor, metric: Metric) -> torch.Tensor:
    """``[..., D] x [..., C, D] -> [..., C]`` distances (per-query candidates).

    Candidates narrower than the queries (bf16 routing rows against f32
    queries) are widened first: every product and sum is f32, and so is the
    result."""
    metric = Metric(metric)
    if cands.dtype != q.dtype:
        wide = torch.promote_types(q.dtype, cands.dtype)
        q, cands = q.to(wide), cands.to(wide)
    if _is_dot_based(metric):
        check_fp32_matmul(q)
        dots = torch.matmul(cands, q.unsqueeze(-1)).squeeze(-1)
        return _finish_dot(dots, metric)
    diff = cands - q.unsqueeze(-2)
    sq = torch.sum(diff * diff, dim=-1)
    if metric is Metric.SQUARED_EUCLIDEAN:
        return sq
    return torch.sqrt(sq)


def distance_one(a: torch.Tensor, b: torch.Tensor, metric: Metric) -> torch.Tensor:
    """``[..., D] x [..., D] -> [...]`` elementwise-paired distances."""
    metric = Metric(metric)
    if _is_dot_based(metric):
        dots = torch.sum(a * b, dim=-1)
        return _finish_dot(dots, metric)
    diff = a - b
    sq = torch.sum(diff * diff, dim=-1)
    if metric is Metric.SQUARED_EUCLIDEAN:
        return sq
    return torch.sqrt(sq)
