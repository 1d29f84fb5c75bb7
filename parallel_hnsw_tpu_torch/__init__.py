"""parallel_hnsw_tpu_torch — the PyTorch/CUDA port of parallel_hnsw_tpu.

The dense build-and-search path of the JAX package, on tensors: bulk ladder
build, the improve/promote self-repair loop, batched beam search and exact
brute-force top-k.  The pairwise-distance kernel is hand-written CUDA for
Hopper (``csrc/pairwise_distance.cu``), built with ``nvcc`` at first use.
A CUDA tensor always goes through the kernel; a CPU tensor takes the plain
PyTorch version.  Imports torch and numpy, never jax.

Quick start::

    from parallel_hnsw_tpu_torch import Hnsw, Metric, BuildParams
    from parallel_hnsw_tpu_torch.utils.data import random_unit_corpus

    source = random_unit_corpus(200_000, 100, device="cuda")
    hnsw = Hnsw.generate(source, metric=Metric.NORMALIZED_COSINE)
    ids, dists = hnsw.search(queries)
"""

from parallel_hnsw_tpu_torch.constants import EMPTY_DIST, EMPTY_ID, MATCH_EPSILON
from parallel_hnsw_tpu_torch.graph import DenseSource, Layer
from parallel_hnsw_tpu_torch.index import Hnsw
from parallel_hnsw_tpu_torch.ops.distance import Metric
from parallel_hnsw_tpu_torch.params import BuildParams, OptimizationParams, SearchParams
from parallel_hnsw_tpu_torch.progress import CallbackProgressMonitor, Interrupt, ProgressMonitor

__all__ = [
    "EMPTY_DIST",
    "EMPTY_ID",
    "MATCH_EPSILON",
    "BuildParams",
    "OptimizationParams",
    "SearchParams",
    "Metric",
    "Hnsw",
    "Layer",
    "DenseSource",
    "ProgressMonitor",
    "CallbackProgressMonitor",
    "Interrupt",
]
