"""The pairwise-distance kernels for Hopper, their wrapper and the dispatch.

Counterpart of ``parallel_hnsw_tpu.ops.pallas_distance``: the Pallas
``_dist_kernel`` becomes the two CUDA C++ kernels in
``csrc/pairwise_distance.cu`` (see its header for design and bounds), launched
through ctypes:

* ``exact=True``: full fp32 on the FFMA pipes.  Its plain version is
  :func:`parallel_hnsw_tpu_torch.ops.distance.pairwise_distance`.
* ``exact=False``: the dots of the operands rounded to bf16, accumulated in
  f32 on the tensor cores (what the TPU kernel's fast mode is: one bf16 pass
  of the MXU); the L2 family's norms come from the unrounded f32 operands.
  Its plain version is
  :func:`parallel_hnsw_tpu_torch.ops.distance.pairwise_distance_bf16_dots`.
  Callers oversample and rerank in fp32 behind it.  The bf16 copies (zero-
  padded to rows of 16-byte multiples) and those norms are made by a third
  kernel of the same source, once per operand (:func:`prepare_operand`).

On a CPU tensor the dispatch computes both modes in fp32, as the JAX package
does on a CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from parallel_hnsw_tpu_torch.ops import _native
from parallel_hnsw_tpu_torch.ops.distance import Metric, pairwise_distance

#: kernel launches, counted where a wrapper launches and nowhere else: the two
#: modes of the distance kernel and the kernel that prepares a fast-mode operand
LAUNCHES = {"exact": 0, "fast": 0, "operand": 0}

_METRIC_CODE = {
    Metric.COSINE: 0,
    Metric.NORMALIZED_COSINE: 1,
    Metric.EUCLIDEAN: 2,
    Metric.SQUARED_EUCLIDEAN: 3,
    Metric.DOT: 4,
}
_L2 = (Metric.EUCLIDEAN, Metric.SQUARED_EUCLIDEAN)
_MAX_INT = 2**31 - 1


def bf16_rows(m: torch.Tensor) -> torch.Tensor:
    """``m [N, D]`` rounded to bf16 and zero-padded to a multiple of 8 columns,
    so that rows start on 16-byte boundaries (what the bf16 kernels' tensor
    maps need).  Zero columns change no dot and no norm.  A bf16 tensor that
    already has such rows comes back as it is.  Plain PyTorch: the plain
    version of :func:`cuda_bf16_operand`'s rows."""
    n, d = m.shape
    pad = -d % 8
    if pad == 0:
        rows = m.to(torch.bfloat16).contiguous()
        return rows if rows.data_ptr() % 16 == 0 else rows.clone()
    rows = torch.zeros((n, d + pad), dtype=torch.bfloat16, device=m.device)
    rows[:, :d] = m
    return rows


def plain_bf16_operand(
    m: torch.Tensor, with_norms: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`cuda_bf16_operand`."""
    return bf16_rows(m), (torch.sum(m * m, dim=-1) if with_norms else None)


def cuda_bf16_operand(
    m: torch.Tensor, with_norms: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``m [N, D]`` f32 as the bf16 kernels take an operand, by one CUDA kernel
    that reads the rows once: ``(rows, sq_norms)`` with ``rows [N, D rounded up
    to 8]`` bf16 (round to nearest even, zero columns behind) and, if asked
    for, ``sq_norms [N]`` f32, the squared norms of the UNROUNDED rows (summed
    in fp64, rounded once)."""
    if m.device.type != "cuda":
        raise ValueError(f"cuda_bf16_operand needs a CUDA tensor, got {m.device}")
    if m.dtype != torch.float32:
        raise TypeError(f"cuda_bf16_operand needs float32, got {m.dtype}")
    if m.dim() != 2 or not m.is_contiguous():
        raise ValueError(f"cuda_bf16_operand needs a contiguous [N, D] matrix, got {tuple(m.shape)}")
    n, d = m.shape
    if d > _MAX_INT - 8:
        raise ValueError(f"D={d} out of the kernel's range")
    d_pad = d + -d % 8
    rows = torch.empty((n, d_pad), dtype=torch.bfloat16, device=m.device)
    norms = torch.empty((n,), dtype=torch.float32, device=m.device) if with_norms else None
    if n == 0 or d == 0:
        return rows, norms if norms is None else norms.zero_()
    lib = _native.load()
    with torch.cuda.device(m.device):
        err = lib.bf16_operand_f32(
            m.data_ptr(), rows.data_ptr(), norms.data_ptr() if with_norms else None,
            n, d, d_pad, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bf16_operand kernel launch failed: CUDA error {err}")
    LAUNCHES["operand"] += 1
    return rows, norms


class Operand(NamedTuple):
    """One side of a pairwise distance, prepared once per matrix by
    :func:`prepare_operand` and cut per block with :meth:`narrow`."""

    values: torch.Tensor  # [N, D] f32
    rows: Optional[torch.Tensor] = None  # [N, D rounded up to 8] bf16: the fast mode on the card
    sq_norms: Optional[torch.Tensor] = None  # [N] f32 of the unrounded rows: its L2 metrics

    def narrow(self, start: int, stop: int) -> "Operand":
        return Operand(*(None if t is None else t[start:stop] for t in self))


def prepare_operand(m: torch.Tensor, metric: Metric, exact: bool = True) -> Operand:
    """``m [N, D]`` f32 as :func:`best_pairwise_distance` takes it in this mode
    on this device.  Only the fast mode on the card needs anything made (a
    bf16 copy and, for the L2 metrics, norms); a caller that walks blocks of
    one matrix prepares it once and passes :meth:`Operand.narrow` slices."""
    m = m.contiguous()
    if exact or m.device.type != "cuda":
        return Operand(m)
    return Operand(m, *cuda_bf16_operand(m, with_norms=Metric(metric) in _L2))


Matrix = Union[torch.Tensor, Operand]


def cuda_pairwise_distance(x: Matrix, y: Matrix, metric: Metric, exact: bool = True) -> torch.Tensor:
    """``[Q, D] x [C, D] -> [Q, C]`` f32 distances by the CUDA kernels.

    ``exact=True`` launches the fp32 FFMA kernel; ``exact=False`` the bf16
    tensor-core kernel, on what :func:`prepare_operand` made of each side (made
    here, by one more kernel launch a side, where the caller passes a plain
    tensor; a caller that loops over blocks of one matrix prepares it once)."""
    metric = Metric(metric)
    xo = x if isinstance(x, Operand) else None
    yo = y if isinstance(y, Operand) else None
    x = x if xo is None else xo.values
    y = y if yo is None else yo.values
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
    if q > _MAX_INT or c > _MAX_INT or d > _MAX_INT - 8:
        raise ValueError(f"shape out of the kernel's range: Q={q}, C={c}, D={d}")
    out = torch.empty((q, c), dtype=torch.float32, device=x.device)
    if q == 0 or c == 0:
        return out
    lib = _native.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if exact:
            err = lib.pairwise_distance_f32(
                x.data_ptr(), y.data_ptr(), out.data_ptr(), q, c, d,
                _METRIC_CODE[metric], stream,
            )
        else:
            l2 = metric in _L2
            sides = []
            for name, op, m in (("x", xo, x), ("y", yo, y)):
                if op is None or op.rows is None:
                    op = prepare_operand(m, metric, exact=False)
                elif op.rows.shape[0] != m.shape[0] or op.rows.shape[1] != d + -d % 8:
                    raise ValueError(f"{name}'s bf16 rows do not belong to its values")
                elif l2 and op.sq_norms is None:
                    raise ValueError(f"{name} was prepared without the norms of an L2 metric")
                sides.append(op)
            xf, yf = sides
            err = lib.pairwise_distance_bf16(
                xf.rows.data_ptr(), yf.rows.data_ptr(),
                xf.sq_norms.data_ptr() if l2 else None, yf.sq_norms.data_ptr() if l2 else None,
                out.data_ptr(), q, c, xf.rows.shape[1], _METRIC_CODE[metric], stream,
            )
    if err != 0:
        raise RuntimeError(f"pairwise_distance kernel launch failed: CUDA error {err}")
    LAUNCHES["exact" if exact else "fast"] += 1
    return out


def best_pairwise_distance(x: Matrix, y: Matrix, metric: Metric, exact: bool = True) -> torch.Tensor:
    """Dispatch on the operand's device: the kernels for a CUDA tensor, the
    plain fp32 version (both modes) for a CPU tensor; anything else raises.
    Either side may be a tensor or an :class:`Operand`."""
    device = (x.values if isinstance(x, Operand) else x).device
    if device.type == "cuda":
        return cuda_pairwise_distance(x, y, metric, exact=exact)
    if device.type == "cpu":
        x = x.values if isinstance(x, Operand) else x
        y = y.values if isinstance(y, Operand) else y
        return pairwise_distance(x, y, metric, exact=exact)
    raise ValueError(f"no pairwise-distance path for device {device}")
