"""The fused binned and folded distance scans for Hopper, their wrappers,
plain versions and dispatches (counterpart of
``parallel_hnsw_tpu.ops.pallas_scan``).

The Pallas ``_scan_kernel`` and ``_folded_kernel`` become the CUDA C++ kernels
in ``csrc/binned_scan.cu`` (see its header for design and bounds), launched
through ctypes: an fp32 FFMA kernel for float32 operands (exact mode) and a
tensor-core kernel (TMA-fed bf16 ``wgmma``, f32 accumulate; rows of any
width, zero-padded here to a multiple of 8) for bfloat16 operands (fast
mode), each in a binned and a folded form.  Both reduce the *surrogate*
``t[q, c] = w[c] - s * dot(x[q], y[c])`` (``s = 2`` and ``w = |y|^2`` for the
L2 metrics, else ``s = 1`` and ``w = 0``; ``+inf`` on columns past the corpus)
to one minimum per congruence class ``column % 128`` of each corpus tile, with
the first column that attains it, and map only the minima to distances.

The plain versions follow the kernels, not the JAX package's XLA twins: they
reduce the surrogate with f32 norms and then apply the epilogue, so they pick
the same columns as the kernels where the epilogue merges values (the clamp to
0, the square root).  In fast mode (``exact=False``) the operands are rounded
to bf16 and every product and sum is f32 (the tensor cores' f32 accumulation
rounds a little differently from an FFMA chain: the kernels and the plain
versions agree within the tolerances the tests state, not bit for bit).

``clamp_tile_c`` of the JAX module is a VMEM budget and has no counterpart:
the ``tile_c`` given is the one used, by the kernels and the plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from parallel_hnsw_tpu_torch.constants import MATRIX_BYTE_BUDGET
from parallel_hnsw_tpu_torch.ops import _native
from parallel_hnsw_tpu_torch.ops.cuda_distance import bf16_rows, cuda_bf16_operand
from parallel_hnsw_tpu_torch.ops.distance import Metric, check_fp32_matmul

LANES = 128

#: kernel launches, counted where a wrapper launches and nowhere else
LAUNCHES = {"binned": 0, "folded": 0}

# codes shared with csrc/binned_scan.cu
_METRIC_CODE = {
    Metric.COSINE: 0,
    Metric.NORMALIZED_COSINE: 1,
    Metric.EUCLIDEAN: 2,
    Metric.SQUARED_EUCLIDEAN: 3,
    Metric.DOT: 4,
}
_L2 = (Metric.EUCLIDEAN, Metric.SQUARED_EUCLIDEAN)
_MAX_INT = 2**31 - 1
_BLOCK_ROWS = 128  # query rows per block of both kernels in csrc/binned_scan.cu


def fold_shape(c: int, tile_c: int, n_slots: int) -> Tuple[int, int]:
    """``(n_slots, n_jj)`` of a folded scan over ``c`` rows: at most as many
    slots as corpus tiles, ``n_jj`` consecutive tiles per slot."""
    n_c_tiles = max(1, -(-c // tile_c))
    n_slots = min(n_slots, n_c_tiles)
    return n_slots, -(-n_c_tiles // n_slots)


def _check_tile(c: int, tile_c: int, tiles: int) -> None:
    if tile_c <= 0 or tile_c % LANES:
        raise ValueError(f"tile_c must be a positive multiple of {LANES}, got {tile_c}")
    if tiles * tile_c > _MAX_INT:
        raise ValueError(
            f"C={c} rounded up to {tiles} tiles of {tile_c} exceeds int32 column indices"
        )


def _sq_norms(m: torch.Tensor, metric: Metric) -> Optional[torch.Tensor]:
    """f32 squared norms of the rows of ``m`` over the values as stored, for
    the L2 metrics; ``None`` otherwise."""
    if metric not in _L2:
        return None
    mf = m.float()
    return torch.sum(mf * mf, dim=-1)


def _epilogue(t: torch.Tensor, x2: Optional[torch.Tensor], metric: Metric) -> torch.Tensor:
    """Monotone map from surrogate minima ``[Q, B]`` to distances."""
    if metric is Metric.COSINE:
        return 1.0 + t
    if metric is Metric.NORMALIZED_COSINE:
        return 0.5 + 0.5 * t
    if metric is Metric.DOT:
        return t
    d = torch.clamp(x2[:, None] + t, min=0.0)
    return torch.sqrt(d) if metric is Metric.EUCLIDEAN else d


def _first_min(t: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimum along ``dim`` and the FIRST index that attains it, built from
    a comparison so it does not rest on how ``torch.min`` settles ties."""
    best = torch.amin(t, dim=dim, keepdim=True)
    shape = [1] * t.dim()
    shape[dim] = t.shape[dim]
    pos = torch.arange(t.shape[dim], dtype=torch.int32, device=t.device).view(shape)
    first = torch.amin(torch.where(t == best, pos, t.shape[dim]), dim=dim)
    return best.squeeze(dim), first.to(torch.int32)


def scan_operand(m: torch.Tensor) -> torch.Tensor:
    """``m [N, D]`` as the fast-mode scans take it: rounded to bf16 and, on
    the card, zero-padded to a multiple of 8 columns (zero columns change no
    dot and no norm): f32 rows by the kernel behind
    :func:`~parallel_hnsw_tpu_torch.ops.cuda_distance.cuda_bf16_operand`, rows
    that are bf16 already by its plain version.  A caller that scans blocks of
    one matrix prepares it once; the wrappers pass a prepared operand through."""
    if not m.is_cuda:
        return m.to(torch.bfloat16)
    return cuda_bf16_operand(m.contiguous())[0] if m.dtype == torch.float32 else bf16_rows(m)


def _cast(x: torch.Tensor, y: torch.Tensor, exact: bool, operand=scan_operand):
    if exact:
        if x.dtype != torch.float32 or y.dtype != torch.float32:
            raise TypeError(f"exact scans need float32, got {x.dtype}, {y.dtype}")
        return x, y
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"need [Q, D] and [C, D], got {tuple(x.shape)} and {tuple(y.shape)}")
    return operand(x), operand(y)


def _plain_bins(x, y, metric, tile_c, exact):
    """Surrogate bin minima ``[Q, n_tiles * 128]``, their columns and ``x2``."""
    x, y = _cast(x, y, exact, operand=lambda m: m.to(torch.bfloat16))  # no kernel in here
    q, c = x.shape[0], y.shape[0]
    n_tiles = -(-c // tile_c)
    _check_tile(c, tile_c, n_tiles)
    x2 = _sq_norms(x, metric)
    xf = x.float()
    check_fp32_matmul(xf)
    scale = 2.0 if metric in _L2 else 1.0
    groups = tile_c // LANES
    lane = torch.arange(LANES, dtype=torch.int32, device=x.device)
    step = max(1, MATRIX_BYTE_BUDGET // max(1, q * 4 * tile_c))  # tiles per pass
    out_t, out_c = [], []
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        rows = y[t0 * tile_c : t1 * tile_c].float()
        dots = torch.matmul(xf, rows.T)
        w = _sq_norms(rows, metric)
        t = -dots if w is None else w[None, :] - scale * dots
        pad = (t1 - t0) * tile_c - rows.shape[0]
        if pad:
            t = torch.cat([t, t.new_full((q, pad), float("inf"))], dim=-1)
        bin_t, g = _first_min(t.view(q, t1 - t0, groups, LANES), dim=2)
        base = torch.arange(t0, t1, dtype=torch.int32, device=x.device) * tile_c
        out_t.append(bin_t.reshape(q, -1))
        out_c.append((base[None, :, None] + g * LANES + lane).reshape(q, -1))
    if not out_t:
        empty = x.new_empty((q, 0), dtype=torch.float32)
        return empty, empty.to(torch.int32), x2
    return torch.cat(out_t, dim=-1), torch.cat(out_c, dim=-1), x2


def plain_binned_scan(
    x: torch.Tensor, y: torch.Tensor, metric: Metric, tile_c: int = 2048, exact: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`cuda_binned_scan`: walks the corpus in
    groups of tiles so the live surrogate matrix stays within
    ``MATRIX_BYTE_BUDGET``."""
    metric = Metric(metric)
    bin_t, cols, x2 = _plain_bins(x, y, metric, tile_c, exact)
    return _epilogue(bin_t, x2, metric), cols


def plain_folded_scan(
    x: torch.Tensor,
    y: torch.Tensor,
    metric: Metric,
    tile_c: int = 2048,
    n_slots: int = 16,
    exact: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`cuda_folded_scan`: the per-tile bins
    of :func:`plain_binned_scan` in surrogate space, folded over the ``n_jj``
    tiles of each slot (earliest tile wins a tie), then the epilogue."""
    metric = Metric(metric)
    q, c = x.shape[0], y.shape[0]
    n_slots, n_jj = fold_shape(c, tile_c, n_slots)
    _check_tile(c, tile_c, n_slots * n_jj)
    bin_t, cols, x2 = _plain_bins(x, y, metric, tile_c, exact)
    n_tiles = bin_t.shape[1] // LANES
    pad_tiles = n_slots * n_jj - n_tiles
    if pad_tiles:
        lane = torch.arange(LANES, dtype=torch.int32, device=x.device)
        base = torch.arange(n_tiles, n_tiles + pad_tiles, dtype=torch.int32, device=x.device)
        pad_cols = (base[:, None] * tile_c + lane).reshape(1, -1).expand(q, -1)
        bin_t = torch.cat([bin_t, bin_t.new_full((q, pad_tiles * LANES), float("inf"))], dim=-1)
        cols = torch.cat([cols, pad_cols], dim=-1)
    t4 = bin_t.view(q, n_slots, n_jj, LANES)
    out_t, jj = _first_min(t4, dim=2)
    out_c = torch.gather(cols.view(q, n_slots, n_jj, LANES), 2, jj[:, :, None, :].long())[:, :, 0, :]
    out_t = out_t.reshape(q, -1)
    # padding slots (all-inf surrogate) stay +inf through every epilogue
    out_d = torch.where(torch.isinf(out_t), out_t, _epilogue(out_t, x2, metric))
    return out_d, out_c.reshape(q, -1)


def _check_operands(name: str, x: torch.Tensor, y: torch.Tensor) -> str:
    """Raise on what the kernels do not take; returns the symbol suffix."""
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(
            f"{name} needs both operands on one CUDA device, got {x.device} and {y.device}"
        )
    if x.dtype != y.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} needs float32 or bfloat16 operands, got {x.dtype}, {y.dtype}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"need [Q, D] and [C, D], got {tuple(x.shape)} and {tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{name} needs contiguous operands")
    if x.dtype == torch.float32:
        return "f32"
    if x.shape[1] % 8 or x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError(f"{name} needs bf16 rows that start on 16-byte boundaries")
    return "bf16"


def _norm_scratch(suffix: str, x, y, metric: Metric):
    """The pointer argument that only the bf16 entries take, as a list to
    splice into the call: scratch for the norms the launch sums for the L2
    metrics (one f32 per corpus row, rounded up to groups of 128, and per query
    row), null for the other metrics.  The tensor is returned too, so that it
    lives until the launch is enqueued."""
    if suffix != "bf16":
        return [], None
    if metric not in _L2:
        return [None], None
    rows = -(-y.shape[0] // LANES) * LANES + x.shape[0]
    scratch = torch.empty((rows,), dtype=torch.float32, device=x.device)
    return [scratch.data_ptr()], scratch


def _check_grid(q: int, units: int) -> None:
    if -(-q // _BLOCK_ROWS) * units > _MAX_INT:
        raise ValueError(f"grid out of range: Q={q} with {units} corpus tiles or slots")


def cuda_binned_scan(
    x: torch.Tensor, y: torch.Tensor, metric: Metric, tile_c: int = 2048, exact: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[Q, D] x [C, D] -> (bin_d f32, bin_cols int32)`` of shape
    ``[Q, ceil(C / tile_c) * 128]`` by the CUDA kernel.

    Output column ``j * 128 + l`` holds the minimum distance, and its corpus
    column, among the columns of corpus tile ``j`` congruent to ``l`` mod 128;
    a class that is all padding reports ``+inf`` and column ``j * tile_c + l``.
    ``exact`` casts like the dispatch: float32 operands as they are (the
    FFMA kernel), or rounded to bfloat16 (the tensor-core kernel; products
    and sums are f32 either way).  The kernel sums the norms of the L2
    metrics itself, from the operands as stored."""
    metric = Metric(metric)
    x, y = _cast(x, y, exact)
    suffix = _check_operands("cuda_binned_scan", x, y)
    q, d = x.shape
    c = y.shape[0]
    n_tiles = -(-c // tile_c)
    _check_tile(c, tile_c, n_tiles)
    _check_grid(q, n_tiles)
    if d > _MAX_INT:
        raise ValueError(f"D={d} out of the kernel's range")
    out_d = torch.empty((q, n_tiles * LANES), dtype=torch.float32, device=x.device)
    out_i = torch.empty((q, n_tiles * LANES), dtype=torch.int32, device=x.device)
    if q == 0 or c == 0:
        return out_d, out_i
    lib = _native.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        extra, _scratch = _norm_scratch(suffix, x, y, metric)
        err = getattr(lib, f"binned_scan_{suffix}")(
            x.data_ptr(), y.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), *extra,
            q, c, d, tile_c, _METRIC_CODE[metric], stream,
        )
    if err != 0:
        raise RuntimeError(f"binned_scan kernel launch failed: CUDA error {err}")
    LAUNCHES["binned"] += 1
    return out_d, out_i


def cuda_folded_scan(
    x: torch.Tensor,
    y: torch.Tensor,
    metric: Metric,
    tile_c: int = 2048,
    n_slots: int = 16,
    exact: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[Q, D] x [C, D] -> (bin_d f32, bin_cols int32)`` of shape
    ``[Q, n_slots * 128]`` by the CUDA kernel.

    Like :func:`cuda_binned_scan`, but corpus tile ``s * n_jj + jj`` min-folds
    into slot ``s`` inside the kernel (earliest tile wins a tie), so the
    output does not grow with the corpus.  The kernel writes surrogate
    minima; the metric's epilogue runs here on the reduced slab, and slots
    that saw only padding stay ``+inf``.  The kernel sums the corpus norms
    of the L2 metrics itself."""
    metric = Metric(metric)
    x, y = _cast(x, y, exact)
    suffix = _check_operands("cuda_folded_scan", x, y)
    q, d = x.shape
    c = y.shape[0]
    n_slots, n_jj = fold_shape(c, tile_c, n_slots)
    _check_tile(c, tile_c, n_slots * n_jj)
    _check_grid(q, n_slots)
    if d > _MAX_INT:
        raise ValueError(f"D={d} out of the kernel's range")
    out_t = torch.empty((q, n_slots * LANES), dtype=torch.float32, device=x.device)
    out_i = torch.empty((q, n_slots * LANES), dtype=torch.int32, device=x.device)
    if q == 0:
        return out_t, out_i
    lib = _native.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        extra, _scratch = _norm_scratch(suffix, x, y, metric)
        err = getattr(lib, f"folded_scan_{suffix}")(
            x.data_ptr(), y.data_ptr(), out_t.data_ptr(), out_i.data_ptr(), *extra,
            q, c, d, tile_c, n_slots, n_jj, _METRIC_CODE[metric], stream,
        )
    if err != 0:
        raise RuntimeError(f"folded_scan kernel launch failed: CUDA error {err}")
    LAUNCHES["folded"] += 1
    # the query norms of the L2 epilogue: [Q] sums over [Q, D], no corpus pass
    out_d = torch.where(torch.isinf(out_t), out_t, _epilogue(out_t, _sq_norms(x, metric), metric))
    return out_d, out_i


def binned_scan(
    x: torch.Tensor,
    y: torch.Tensor,
    metric: Metric,
    tile_c: int = 2048,
    exact: bool = False,
    tile_q: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on the operand's device: the kernel for a CUDA tensor, the
    plain version for a CPU tensor; anything else raises.  Fast mode
    (``exact=False``) rounds both operands to bf16.  ``tile_q`` is accepted
    for the JAX signature and ignored: the kernel's query tile is fixed."""
    if x.device.type == "cuda":
        return cuda_binned_scan(x, y, metric, tile_c=tile_c, exact=exact)
    if x.device.type == "cpu":
        return plain_binned_scan(x, y, metric, tile_c=tile_c, exact=exact)
    raise ValueError(f"no binned-scan path for device {x.device}")


def folded_scan(
    x: torch.Tensor,
    y: torch.Tensor,
    metric: Metric,
    tile_c: int = 2048,
    n_slots: int = 32,
    exact: bool = False,
    tile_q: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch for the folding kernel, as :func:`binned_scan`.  Output is
    ``[Q, n_slots * 128]``: the caller's top-k input no longer grows with
    the corpus.  ``tile_q`` is accepted and ignored."""
    if x.device.type == "cuda":
        return cuda_folded_scan(x, y, metric, tile_c=tile_c, n_slots=n_slots, exact=exact)
    if x.device.type == "cpu":
        return plain_folded_scan(x, y, metric, tile_c=tile_c, n_slots=n_slots, exact=exact)
    raise ValueError(f"no folded-scan path for device {x.device}")
