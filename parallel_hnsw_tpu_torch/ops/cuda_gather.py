"""The row-gather kernel for Hopper, its wrapper, plain version and dispatch.

Counterpart of ``scripts/gather_kernel_study.py::dma_gather``: the Pallas
``_gather_kernel`` (one DMA per row from scalar-prefetched indices) becomes
the CUDA C++ kernel in ``csrc/row_gather.cu`` (see its header for design and
bound), launched through ctypes.  It copies rows as bytes, so one kernel
serves every row gather of the graph hop: f32 feature rows, bf16 routing
rows, int32 neighbor rows and ``[M, width]`` hop-slab rows.

Indices must be in range on entry, as in the Pallas kernel: the kernel does
not check them, and the callers clamp (``graph.source_get``, the hop).
"""

from __future__ import annotations

import math

import torch

from parallel_hnsw_tpu_torch.ops import _native

#: kernel launches, counted where the wrapper launches and nowhere else
LAUNCHES = {"row_gather": 0}


def _check_table(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() < 2:
        raise ValueError(f"need a table of rows [N, ...], got shape {tuple(table.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"row indices must be int32, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"table on {table.device}, indices on {idx.device}")


def plain_row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`cuda_row_gather`:
    ``out[*i, ...] = table[idx[*i], ...]``."""
    _check_table(table, idx)
    out = table.index_select(0, idx.reshape(-1).long())
    return out.reshape(*idx.shape, *table.shape[1:])


def cuda_row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table [N, ...]``, ``idx [*S] int32`` -> ``[*S, ...]`` of the table's
    type, by the CUDA kernel: ``out[*i, ...] = table[idx[*i], ...]``.

    The table must be contiguous (its rows are copied as bytes); ``idx`` may
    be any view and is made contiguous here.  Every index must lie in
    ``[0, N)``: the kernel does not check."""
    _check_table(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"cuda_row_gather needs CUDA tensors, got {table.device}")
    if not table.is_contiguous():
        raise ValueError("cuda_row_gather needs a contiguous table")
    n = table.shape[0]
    row_bytes = math.prod(table.shape[1:]) * table.element_size()
    out = torch.empty((*idx.shape, *table.shape[1:]), dtype=table.dtype, device=table.device)
    rows = idx.numel()
    if rows == 0 or row_bytes == 0:
        return out
    if n == 0:
        raise ValueError("cannot gather rows from an empty table")
    idx = idx.contiguous()
    lib = _native.load()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.row_gather(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, n, row_bytes, stream
        )
    if err != 0:
        raise RuntimeError(f"row_gather kernel launch failed: CUDA error {err}")
    LAUNCHES["row_gather"] += 1
    return out


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Dispatch on the table's device: the kernel for a CUDA tensor, the plain
    version for a CPU tensor; anything else raises."""
    if table.device.type == "cuda":
        return cuda_row_gather(table, idx)
    if table.device.type == "cpu":
        return plain_row_gather(table, idx)
    raise ValueError(f"no row-gather path for device {table.device}")
