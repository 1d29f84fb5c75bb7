"""parallel_hnsw_tpu_torch — the PyTorch/CUDA port of parallel_hnsw_tpu.

The dense build-and-search path of the JAX package, on tensors: bulk ladder
build (with checkpoint resume), the improve/promote self-repair loop, batched
beam search (plain, instrumented, adaptive, routed over bf16 routing rows,
over hop slabs), all-pairs ``knn`` / ``threshold_nn`` and exact brute-force
top-k; the flat-scan path (``fast_flat_knn``,
``Hnsw.search_exact(fast=True)``); product quantization (``QuantizedHnsw``
over a ``PqSource``: shared or per-subspace codebooks, graph / exact / binned
quantization, ADC tables, flat scan with exact rerank); out-of-core
sources (``MemmapSource``: f32 rows on the host, gathered in bounded
pieces); the sharded indexes over a mesh of devices
(``parallel.ShardedHnsw``, ``parallel.ShardedQuantizedHnsw`` in core and out
of core); index persistence, dense, quantized and sharded (``io``, the
JAX package's directory format); the dataset readers
(``utils.datasets.read_vecs`` / ``vector_chunks`` over a native mmap reader
built with ``g++``) and the BFS graph diagnostics
(``analysis.node_distances`` and its family,
``Hnsw.node_distances_for_layer``).  The kernels are hand-written CUDA for
Hopper, built with ``nvcc`` at first use: pairwise distances
(``csrc/pairwise_distance.cu``), the binned and folded distance scans
(``csrc/binned_scan.cu``), the row gather (``csrc/row_gather.cu``) and the
hop's gather-and-distance (``csrc/gather_distance.cu``).  A CUDA tensor always goes through a kernel; a CPU
tensor takes the plain PyTorch version.  Entry points that create tensors
place them on the card unless the caller names a device.  Imports torch and
numpy, never jax.

Quick start::

    from parallel_hnsw_tpu_torch import Hnsw, Metric, BuildParams
    from parallel_hnsw_tpu_torch.utils.data import random_unit_corpus

    source = random_unit_corpus(200_000, 100)  # on the card
    hnsw = Hnsw.generate(source, metric=Metric.NORMALIZED_COSINE)
    ids, dists = hnsw.search(queries)
    ids, dists = hnsw.search_exact(queries, k=10, fast=True)  # flat scan
    serialize_hnsw(hnsw, "index_dir"); hnsw = deserialize_hnsw("index_dir")

    pq = QuantizedHnsw.new(65535, source, dsub=4, metric=Metric.EUCLIDEAN,
                           fast_quantize=True)
    ids, dists = pq.search(queries)        # code graph + exact rerank
    ids, dists = pq.search_exact(queries)  # flat scan over the codes

    from parallel_hnsw_tpu_torch.parallel import Mesh, ShardedQuantizedHnsw
    mesh = Mesh(["cuda:0"] * 4)            # 4 shards on one card
    corpus = open_memmap_source("corpus.f32", dim=768)  # stays on the host
    sq = ShardedQuantizedHnsw.new(65535, corpus, dsub=8, metric=Metric.EUCLIDEAN,
                                  mesh=mesh, fast_quantize=True, build_graphs=False)
    ids, dists = sq.search_exact(queries)  # code scans, then a host rerank
"""

from parallel_hnsw_tpu_torch.constants import EMPTY_DIST, EMPTY_ID, MATCH_EPSILON
from parallel_hnsw_tpu_torch.graph import (
    DenseSource,
    Layer,
    MemmapSource,
    PqSource,
    open_memmap_source,
)
from parallel_hnsw_tpu_torch.analysis import brute_force_knn, fast_flat_knn, select_scan_mode
from parallel_hnsw_tpu_torch.index import Hnsw
from parallel_hnsw_tpu_torch.io import (
    IndexNotFound,
    SerializationError,
    deserialize_hnsw,
    deserialize_quantized_hnsw,
    deserialize_sharded_hnsw,
    deserialize_sharded_quantized_hnsw,
    deserialize_source,
    read_index_meta,
    serialize_hnsw,
    serialize_quantized_hnsw,
    serialize_sharded_hnsw,
    serialize_sharded_quantized_hnsw,
    serialize_source,
)
from parallel_hnsw_tpu_torch.ops.distance import Metric
from parallel_hnsw_tpu_torch.params import (
    BuildParams,
    OptimizationParams,
    PqBuildParams,
    SearchParams,
)
from parallel_hnsw_tpu_torch.pq import HnswQuantizer, QuantizedHnsw, SubspaceQuantizer
from parallel_hnsw_tpu_torch.progress import CallbackProgressMonitor, Interrupt, ProgressMonitor

__all__ = [
    "EMPTY_DIST",
    "EMPTY_ID",
    "MATCH_EPSILON",
    "BuildParams",
    "OptimizationParams",
    "PqBuildParams",
    "SearchParams",
    "Metric",
    "Hnsw",
    "Layer",
    "DenseSource",
    "PqSource",
    "MemmapSource",
    "open_memmap_source",
    "QuantizedHnsw",
    "HnswQuantizer",
    "SubspaceQuantizer",
    "ProgressMonitor",
    "CallbackProgressMonitor",
    "Interrupt",
    "brute_force_knn",
    "fast_flat_knn",
    "select_scan_mode",
    "serialize_hnsw",
    "deserialize_hnsw",
    "serialize_quantized_hnsw",
    "deserialize_quantized_hnsw",
    "serialize_sharded_hnsw",
    "deserialize_sharded_hnsw",
    "serialize_sharded_quantized_hnsw",
    "deserialize_sharded_quantized_hnsw",
    "serialize_source",
    "deserialize_source",
    "read_index_meta",
    "SerializationError",
    "IndexNotFound",
]
