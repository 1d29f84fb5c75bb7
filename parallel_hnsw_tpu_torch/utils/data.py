"""Synthetic corpus generation (reference: src/bigvec.rs:9-65).

Corpora are drawn with numpy from a seed, so the JAX package and the port
can be handed identical inputs, and placed on the requested device
(``None``: the card, :func:`parallel_hnsw_tpu_torch.utils.device.default_device`).
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_hnsw_tpu_torch.graph import DenseSource
from parallel_hnsw_tpu_torch.index import Hnsw
from parallel_hnsw_tpu_torch.ops.distance import Metric
from parallel_hnsw_tpu_torch.params import BuildParams
from parallel_hnsw_tpu_torch.utils import device as _device


def random_corpus(count: int, dim: int, seed: int = 42, device=None) -> DenseSource:
    """Unnormalized Uniform[-1,1) vectors (reference: random_vec,
    src/lib.rs:2443-2447, used by the euclidean test)."""
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, (count, dim)).astype(np.float32)
    return DenseSource(vectors=torch.from_numpy(x).to(_device.resolve_device(device)))


def random_unit_corpus(count: int, dim: int, seed: int = 42, device=None) -> DenseSource:
    """Uniform[-1,1) vectors normalized to unit length (src/bigvec.rs:59-65)."""
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, (count, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return DenseSource(vectors=torch.from_numpy(x).to(_device.resolve_device(device)))


def make_random_hnsw(count: int, dim: int, seed: int = 42, bp=None, device=None, **kw):
    """Convenience mirroring the reference's bigvec::make_random_hnsw
    (src/bigvec.rs:9-36): a seeded random unit corpus on ``device`` (``None``:
    the card) and a normalized-cosine build; ``kw`` goes to ``Hnsw.generate``."""
    source = random_unit_corpus(count, dim, seed, device=device)
    return Hnsw.generate(source, None, bp or BuildParams(), Metric.NORMALIZED_COSINE, **kw)
