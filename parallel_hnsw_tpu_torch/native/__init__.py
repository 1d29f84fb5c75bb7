"""Native host-side components (C++), compiled on first use."""

from parallel_hnsw_tpu_torch.native.build import load_vecio

__all__ = ["load_vecio"]
