"""Synthetic corpus generation (reference: src/bigvec.rs:9-65).

Corpora are drawn with numpy from a seed, so the JAX package and the port
can be handed identical inputs, and placed on the requested device.
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_hnsw_tpu_torch.graph import DenseSource


def random_corpus(count: int, dim: int, seed: int = 42, device="cpu") -> DenseSource:
    """Unnormalized Uniform[-1,1) vectors (reference: random_vec,
    src/lib.rs:2443-2447, used by the euclidean test)."""
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, (count, dim)).astype(np.float32)
    return DenseSource(vectors=torch.from_numpy(x).to(device))


def random_unit_corpus(count: int, dim: int, seed: int = 42, device="cpu") -> DenseSource:
    """Uniform[-1,1) vectors normalized to unit length (src/bigvec.rs:59-65)."""
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, (count, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return DenseSource(vectors=torch.from_numpy(x).to(device))
