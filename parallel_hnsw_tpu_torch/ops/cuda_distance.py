"""The pairwise-distance kernel for Hopper, its wrapper and the dispatch.

Counterpart of ``parallel_hnsw_tpu.ops.pallas_distance``: the Pallas
``_dist_kernel`` becomes the CUDA C++ kernel in ``csrc/pairwise_distance.cu``
(see its header for design and bounds), launched through ctypes.  Its plain
version is :func:`parallel_hnsw_tpu_torch.ops.distance.pairwise_distance`.
"""

from __future__ import annotations

import torch

from parallel_hnsw_tpu_torch.ops import _native
from parallel_hnsw_tpu_torch.ops.distance import Metric, pairwise_distance

#: kernel launches by mode, counted where the wrapper launches and nowhere else
LAUNCHES = {"exact": 0, "fast": 0}

_METRIC_CODE = {
    Metric.COSINE: 0,
    Metric.NORMALIZED_COSINE: 1,
    Metric.EUCLIDEAN: 2,
    Metric.SQUARED_EUCLIDEAN: 3,
    Metric.DOT: 4,
}
# the kernel's grid puts query tiles of 64 rows on gridDim.y (at most 65535)
_MAX_ROWS = 65535 * 64
_MAX_INT = 2**31 - 1


def cuda_pairwise_distance(
    x: torch.Tensor, y: torch.Tensor, metric: Metric, exact: bool = True
) -> torch.Tensor:
    """``[Q, D] x [C, D] -> [Q, C]`` f32 distances by the CUDA kernel.

    The kernel computes in fp32 for both values of ``exact``; the flag only
    selects which launch counter ticks."""
    metric = Metric(metric)
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(
            f"cuda_pairwise_distance needs both operands on one CUDA device, "
            f"got {x.device} and {y.device}"
        )
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"cuda_pairwise_distance needs float32, got {x.dtype}, {y.dtype}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"need [Q, D] and [C, D], got {tuple(x.shape)} and {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("cuda_pairwise_distance needs contiguous operands")
    q, d = x.shape
    c = y.shape[0]
    if q > _MAX_ROWS or c > _MAX_INT or d > _MAX_INT:
        raise ValueError(f"shape out of the kernel's range: Q={q}, C={c}, D={d}")
    out = torch.empty((q, c), dtype=torch.float32, device=x.device)
    if q == 0 or c == 0:
        return out
    lib = _native.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pairwise_distance_f32(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), q, c, d,
            _METRIC_CODE[metric], stream,
        )
    if err != 0:
        raise RuntimeError(f"pairwise_distance kernel launch failed: CUDA error {err}")
    LAUNCHES["exact" if exact else "fast"] += 1
    return out


def best_pairwise_distance(
    x: torch.Tensor, y: torch.Tensor, metric: Metric, exact: bool = True
) -> torch.Tensor:
    """Dispatch on the operand's device: the kernel for a CUDA tensor, the
    plain version for a CPU tensor; anything else raises."""
    if x.device.type == "cuda":
        return cuda_pairwise_distance(x, y, metric, exact=exact)
    if x.device.type == "cpu":
        return pairwise_distance(x, y, metric, exact=exact)
    raise ValueError(f"no pairwise-distance path for device {x.device}")
