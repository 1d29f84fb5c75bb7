"""Drive the PyTorch port's paths once on one CUDA card and check them.

    python3 chip_smoke.py [--count 200000]

Phases, each printed as it ends:

0. environment: torch / CUDA versions, the card, ``nvidia-smi``'s name and
   power limit, and the TF32 switch (which must be off);
1. build of the CUDA kernels from ``csrc/`` (one nvcc per source, together);
2. the pairwise-distance kernels against their plain PyTorch versions on the
   card, for every metric: the exact mode (fp32 FFMA) against
   ``pairwise_distance``, the fast mode (bf16 dots on the tensor cores, f32
   accumulate, f32 norms) against ``pairwise_distance_bf16_dots``, at the JAX
   kernel test's shapes, at shapes that cross the 128-row tiles and at the
   main-path block ``[2048 x 65536 x 100]`` and at rows too wide for the
   fast kernel's query tile to stay in shared memory (D = 768); the kernel
   that prepares a fast-mode operand (bf16 rows bit for bit, norms within 5e-7
   relative of ``torch.sum``); then for each mode the median time of kernel and
   plain version at that block, of the library calls that compute the same
   (``torch.addmm`` for normalized cosine, ``torch.cdist`` for L2,
   ``torch.matmul`` of the bf16 operands for the fast mode's product), of the
   operand kernel, of a ``fill_`` of the output, and the least time the card
   could take;
3. the binned and folded scan kernels against their plain versions: every
   metric and both modes at the JAX kernel test's shapes (columns identical,
   distances within 1e-5), a tie case (first index wins), and the main shapes
   (``D = 128``, ``tile_c = 4096``, 1,048,576 rows binned, 2,097,152 rows
   folded into 32 slots; 512 query rows by value, normalized cosine and
   euclidean), then the median time of kernel and plain version at 4096
   query rows beside the bound, the last 512 rows of that launch by value
   too, the fast binned scan at rows too wide for a resident query tile
   (``[4096 x 262,144 x 768]``), and the flat scan's other stages (survivor
   cut, rerank) at the same block;
4. the row-gather kernel against its plain version (``index_select``),
   bit for bit: f32, bf16 and int32 rows of the widths the hop gathers, slab
   rows, 1 to 100,000 indices with repeats and both ends of the table; then
   the median time of kernel, plain version and ``torch.index_select`` at the
   shape the hop gathered feature rows at until the fused kernel (1,572,864
   rows of a 100,000 x 128 and of a 200,000 x 100 f32 table) beside the bound
   by bytes, and at the hop's neighbor rows (32,768 int32 rows of 48); then
   the hop's gather-and-distance kernel against its plain version (row gather
   + ``batched_distance``) for every metric, f32 and bf16 rows, source rows
   and slabs of 48, within 2e-5, and at the hop's shapes (8192 queries x 192
   candidates over 200,000 x 100 and 100,000 x 128 f32 and 200,000 x 100 bf16
   routing rows): its error, the median time of the kernel, of the
   row-gather kernel + ``batched_distance`` (the hop before it), of the
   plain version and of ``torch.index_select`` + ``torch.baddbmm``, beside
   its bounds with the table read once and with every gathered row read;
   then the hop's queue-merge kernel against its plain version
   (``merge_queue_with_flags`` + ``merged_frontier``) bit for bit at 8,192
   and 100 rows of 300 slots + 192 candidates, and the median time of the
   kernel, of the plain version and of the library chain it replaced
   (``merge_queue_with_flags``'s four sorts and gathers + the frontier's
   ``torch.topk``), each replayed from a CUDA graph, beside its bound by
   bytes; then the hop in two launches (the expand kernel and the
   queue-merge kernel with the termination accounting) against the torch hop
   (``hop_graph.fuses`` refused) bit for bit over 20 hops at the graph
   cells' shape (8,192 and 100 rows of 300 slots + 192 candidates over a
   290,000 x 256 f32 layer of M 48), and the device time of a hop of each,
   20 hops replayed from one CUDA graph, with each hop's count of device
   operations under ``torch.profiler``, beside the hop's bound by bytes;
5. the corpus of ``--count`` random 100-d unit vectors and 10,000 held-out
   ones (numpy seed 42) goes through the reference's file format: written
   as an ``.fvecs`` file to a temporary directory and read back with
   ``utils.datasets.read_vecs`` (the native reader, built with ``g++``, on 8
   threads; the file is in the page cache), byte-equal to the drawn rows, to
   the numpy reader and to ``vector_chunks``; then ``Hnsw.generate`` over the
   rows read (normalized cosine, default ``BuildParams``, seed 0): build
   time, layer sizes, stochastic recall, the trace summary and the kernel
   launch counts;
6. ``Hnsw.search`` of 10,000 held-out vectors at the default
   ``SearchParams``: recall@10 against ``Hnsw.search_exact`` and QPS; then
   recall@10 of as many corpus rows as queries (``bench.py``'s measure), and
   the gather-and-distance, queue-merge and row-gather launches of one
   search pass (one of each per hop, plus the entry's row gather per query
   block);
7. the other traversals on that index: ``search_instrumented`` and
   ``search.search(adaptive=True)`` (the plain search's ids and distances,
   bit for bit, though its batches shrink), f32 hop slabs (ids and distances
   identical), cast-only routing without and with slabs
   (recall@10 within 0.02 of the unrouted search after the rerank),
   projected routing (``dr=64``), and one plain search pass under
   ``torch.profiler`` (busy share, device time by kernel, and of the hop's
   two gather kernels) and one fast-tier relink of the bottom layer under it
   too; then on a
   10,000 x 100 index: a build that resumes from its own checkpoint, a
   mutation that drops the slabs, and ``knn(10)``; and a source type of the
   user's (``ScaledSource``, registered with ``source_get`` alone) over the
   same rows: built and searched on the card, each row found first;
8. persistence: the index goes to a temporary directory and comes back onto
   the card; 1,000 queries give identical ids and distances with both;
9. the flat scan at full width: 2,097,152 x 128 unit vectors and 10,000
   held-out queries (numpy seed 42, normalized cosine, ``k = 10``,
   ``oversample = 4``).  On the first 1,048,576 rows ``scan_mode="auto"``
   must pick the binned kernel, on all rows the folded one; for each,
   recall@10 of ``search_exact(fast=True)`` against ``search_exact``, QPS of
   both, the launch counts of one call, and then the other two modes forced;
10. product quantization.  First each kernel at the PQ path's shapes against
   its plain version, timed beside it and the bound: the fast binned scan at
   the quantize block (262,144 sub-vectors of 16 against 65,535 centroids;
   a 100,000-row chunk of 4, padded to 8, against 4096), the exact pairwise
   kernel at D = 16 and at the code graph's relink block of D = 1536, the
   fast one at D = 1536, the gather-and-distance kernel at D = 1536,
   reconstruction of uint16 codes (bit for bit against the CPU).
   10a, the reference's PQ gate (src/pq.rs:956-978) at full scale: 100,000 x
   1536 unit vectors (numpy seed 3), euclidean, 65,535 shared centroids of 16,
   ``fast_quantize=True``: binned codes against the exact argmin (>= 0.999),
   self-query recall@1 of ``search_exact(k=10)`` (>= 0.999) and of the code
   graph with exact quantization (>= 0.99) on 10,000 rows, the centroid-graph
   quantizer on 1,000, QPS, build time by span, the launches of the PQ path
   (the build, one search of each kind).  10b, config4's shapes cut to
   200,000 rows: a clustered 96-d corpus, normalized cosine, per-subspace
   k-means codebooks of 4096 x 4: ``search_exact(k=10, oversample=32)``
   recall@10 against the full-precision scan on 2,048 held-out queries
   (>= 0.95), the binned scan at that call's block (2,048 x 200,000 x 96)
   against its plain version, ``adc_scan`` against the decoded codes (1e-4), the code graph
   plain and routed over bf16 slabs (recall within 0.02).  10c: both indexes
   through ``io`` and back (1,000 queries identical), and 10,000 codes of the
   gate searched with ``DENSIFY_BUDGET_BYTES = 0`` against the densified hop
   (top-1 identical for >= 0.999, distances within 1e-5);
11. out-of-core sources and the sharded indexes, 4 shards on the one card
   (a ``Mesh`` that names it four times).  First the kernels at the sharded
   path's new shapes against their plain versions, timed: the pairwise
   kernel in both modes at ``[10,000 x 50,000 x 100]`` (one shard's flat
   scan) and ``gather_distance`` at its in-shard rerank.  11a: ``ShardedHnsw``
   over phase 5's corpus: build with improve, held-out recall@10 and QPS
   beside the single index's, both flat scans (recall@10 >= 0.999 / 0.99),
   stochastic recall, ``improve_index``, and a round trip through ``io``
   (ids and distances identical).  11b, config 5's code layout out of core:
   2,097,152 x 768 clustered rows written to a temporary file (6.44 GB) 131,072
   rows at a time and opened as a ``MemmapSource``; exact ground truth over
   its chunks; ``ShardedQuantizedHnsw.new`` with 65,535 shared centroids of 8
   (96 uint16 codes), binned quantize, scan-only; ``search_exact(fast=True)``
   of 1,024 held-out queries: recall@10 (>= 0.5), QPS, distances equal to f32
   recomputed from the memmap, the ingest rate (``ooc_ingest_shard``), and peak
   device memory from the build to the search below the corpus's 6.44 GB; the
   binned scan at one shard's block ``[1024 x 524,288 x 768]`` and at the
   quantize block ``[262,144 x 65,535 x 8]``, and ``reconstruct``'s row gather
   of one shard block (bit for bit); a round trip against the external memmap;
   then the in-core twin from the same rows: codes byte-identical, the same
   code scan, and the host rerank of its candidates equal to the card's bit
   for bit.  11c: an in-core ``ShardedQuantizedHnsw`` with code graphs over
   10b's corpus and codebooks: code-graph and flat recall@10 beside 10b's.
12. graph diagnostics on phase 5's index (200,000 / 16,666 / 1,388 / ... nodes):
   ``node_distances_for_layer(0)`` over the 200k bottom layer from its 16,666
   supers, twice (equal bit for bit), against scipy's Dijkstra (unit edges
   for hops, slot + 1 for index_sum) and against the same code on a CPU copy
   of the layer: its iterations, ms and unreachable count, and
   ``discover_nodes_to_promote(0)`` exactly the unreachable nodes; one
   64-super chunk of ``per_super_node_distances`` over the bottom layer,
   timed; on layer 1 (16,666 nodes, 1,388 supers, 22 chunks of 64):
   ``node_distances`` as on layer 0, ``per_super_node_distances`` (its
   minimum over the supers equal to ``node_distances``),
   ``multi_node_distances(k=5)``, ``node_distances_from_closest_super``,
   ``nodes_not_connected_to_super`` and ``group_nodes_by_vectors``, each
   timed on the card and held to the CPU run of the same code (the BFS
   tables on the first 128 supers, two chunks; the partition on all of
   them, equal but for near-ties); ``reachables_from_node_for_layer`` from
   the entry over the top layer.

The second-to-last line is a JSON object describing the kernels; the last is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
there is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from parallel_hnsw_tpu_torch import (
    BuildParams,
    DenseSource,
    Hnsw,
    MemmapSource,
    Metric,
    PqBuildParams,
    PqSource,
    QuantizedHnsw,
    brute_force_knn,
    deserialize_hnsw,
    deserialize_quantized_hnsw,
    deserialize_sharded_hnsw,
    deserialize_sharded_quantized_hnsw,
    fast_flat_knn,
    open_memmap_source,
    select_scan_mode,
    serialize_hnsw,
    serialize_quantized_hnsw,
    serialize_sharded_hnsw,
    serialize_sharded_quantized_hnsw,
)
from parallel_hnsw_tpu_torch import analysis, flat, hop_graph
from parallel_hnsw_tpu_torch.analysis import blocked_topk_pairwise
from parallel_hnsw_tpu_torch.constants import EMPTY_ID
from parallel_hnsw_tpu_torch.graph import (
    Layer,
    host_rows,
    materialize_source,
    narrow_codes,
    reconstruct,
    source_get,
    widen_codes,
)
from parallel_hnsw_tpu_torch.ops import _native, cuda_distance, cuda_gather, cuda_queues, cuda_scan
from parallel_hnsw_tpu_torch.ops.queues import merge_queue_with_flags, merged_frontier, sort_queue
from parallel_hnsw_tpu_torch.optimize import link_layer_to_better_neighbors
from parallel_hnsw_tpu_torch.parallel import Mesh, ShardedHnsw, ShardedQuantizedHnsw
from parallel_hnsw_tpu_torch.pq import adc_lut, adc_scan, quantize_binned
from parallel_hnsw_tpu_torch.routing import exact_rerank
from parallel_hnsw_tpu_torch.ops.distance import (
    batched_distance,
    pairwise_distance,
    pairwise_distance_bf16_dots,
)
from parallel_hnsw_tpu_torch.search import LayerSearchState, _layer_step_fns, auto_query_block
from parallel_hnsw_tpu_torch.search import search as graph_search
from parallel_hnsw_tpu_torch.native import load_vecio
from parallel_hnsw_tpu_torch.utils.data import random_unit_corpus
from parallel_hnsw_tpu_torch.utils.datasets import _read_vecs_numpy, read_vecs, vector_chunks
from parallel_hnsw_tpu_torch.utils.trace import TRACER, enable_tracing

# Published peaks of one H100 SXM at its full 700 W: the bounds are stated
# against them whatever the card's power limit, which is printed beside.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

DIM = 100
# The JAX kernel test's bound (tests/test_pallas_distance.py), at its shapes.
SMALL_ATOL = 2e-5
# Main-path block of unit vectors: every partial sum of the 100-term dot and
# norms stays within [-1, 1], so two fp32 summation orders differ by at most
# ~100 half-ulps of 1 (6e-6).
BLOCK_ATOL = 1e-5
# Fast mode against its plain version (the same bf16-rounded operands, f32
# sums): the two differ only in the order, and in the tensor cores' rounding,
# of f32 sums of exact products.  The small shapes hold unnormalised rows
# (|dot| up to ~40, L2 sums of ~100, where one f32 ulp is 7.6e-6), so they get
# a handful of those ulps; the main block holds unit vectors.
FAST_SMALL_ATOL = 1e-4
FAST_BLOCK_ATOL = 1e-5
MAIN_BLOCK = (2048, 65536)
OPERAND_BIG_ROWS = 1 << 20
QUERIES = 10_000
# Recall floors catch a broken kernel or merge; they are not targets.  On
# uniform 100-d unit vectors held-out queries are the hard case: at ef=300
# the JAX package and the port agree within 0.001 on the CPU (0.986 at 10k,
# 0.937 at 50k, 0.892 at 100k), and the port gives 0.82 at 200k (0.92 at
# ef=600, 0.97 at ef=1200; H100, 700 W).  Queries drawn
# from the corpus, bench.py's own recall measure, reach 0.99999 there.
HELD_OUT_RECALL_FLOOR = 0.80
IN_CORPUS_RECALL_FLOOR = 0.85
STOCHASTIC_RECALL_FLOOR = 0.99

# The flat scan: width, sizes and the floor that catches a broken kernel.
FLAT_DIM = 128
FLAT_TILE_C = flat.TILE_C
FLAT_SLOTS = 32  # folded_scan's default, which fast_flat_knn uses
FLAT_SIZES = ((1 << 20, "binned"), (1 << 21, "folded"))
FLAT_RECALL_FLOOR = 0.95
SCAN_QUERY_BLOCK = 4096  # fast_flat_knn's query block: the kernels' main-path Q
SCAN_CHECK_ROWS = 512  # query rows held against the plain version at the main shapes
WIDE_ROWS, WIDE_DIM = 1 << 18, 768  # a usual embedding width, past the resident query tile
# Scans at the JAX kernel tests' shapes: unit vectors of D <= 16, so the two
# sides' f32 sums differ by a few ulps of values <= 4 (the JAX tests' bound).
SCAN_SMALL_ATOL = 1e-5
# Main shapes: unit vectors of D = 128; two f32 summation orders of a
# 128-term dot with partial sums within [-1, 1] differ by at most ~1e-5.
SCAN_MAIN_ATOL = 2e-5
PERSIST_QUERIES = 1000

# The hop's gather: 8192 queries x 4 beam x 48 neighbors rows per hop, from the
# JAX gather study's table and from the main path's.
GATHER_ROWS = 8192 * 4 * 48
GATHER_TIMED = ((100_000, 128), (200_000, DIM))
# The hop's gather-and-distance: 8192 queries x (beam 4 x 48 neighbors)
# candidates; unit vectors, so partial sums stay within [-4, 4] and two f32
# summation orders differ by a few ulps of 4.
HOP_QUERIES, HOP_CANDIDATES = 8192, 4 * 48
GATHER_DISTANCE_ATOL = 2e-5
# The hop's queue update at ef 300: the batch cell's block and an online call
MERGE_CAP, MERGE_ROWS = 300, (HOP_QUERIES, 100)
# The hop at the graph cells' shape (nytimes-256-angular's bottom layer at
# M0 48, ef 300, beam 4), timed over this many hops from one state
HOP_LAYER_ROWS, HOP_DIM, HOP_M, HOP_BEAM = 290_000, 256, 48, 4
HOP_TIMED_HOPS = 20
# Held-out search QPS of this script's phase 6 on an NVIDIA H100 80GB HBM3 at
# 700 W while the hop still gathered with torch indexing; printed beside
# today's so a slow gather kernel is seen.
SEARCH_QPS_BEFORE_GATHER_KERNEL = 10_932
ROUTED_RECALL_SLACK = 0.02
SMALL_COUNT = 10_000


def _phase(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"== phase {name}: {now - t0:.3f} s", flush=True)
    return now


def _bound(flops: float, peak_flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of operations over the
    peak rate for their type and bytes (inputs read once, outputs written
    once) over the memory rate."""
    by_ops, by_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes"}


def _median_ms(fn, reps: int = 10) -> float:
    """Median over ``reps`` samples of the device time of one call of ``fn``.
    A call shorter than 2 ms is sampled four at a time between two events: the
    host prepares the later calls while the card runs the earlier ones, so a
    short kernel's time is not padded with its wrapper's host time."""
    def sample(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / calls

    fn()
    torch.cuda.synchronize()
    calls = 4 if sample(1) < 2.0 else 1
    return float(np.median([sample(calls) for _ in range(reps)]))


def _graphed_ms(fn, launches: int = 20) -> float:
    """Median device time of one call of ``fn``, replayed from a CUDA graph
    of ``launches`` calls: a wrapper's host time (tens of microseconds),
    which a call of a few microseconds would otherwise be timed by, is not
    counted, as on the hop loop's replayed path."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm on the capture's stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return _median_ms(graph.replay) / launches


def _recall_at_10(ids: torch.Tensor, gt_ids: torch.Tensor) -> float:
    hits = (ids[:, :10, None] == gt_ids[:, None, :]).any(-1).sum()
    return float(hits) / gt_ids.numel()


def check_kernel(device):
    """Returns the ``kernels`` entries of the operand kernel and of the
    pairwise-distance kernel."""
    rng = np.random.default_rng(3)

    def unit(n):
        a = rng.uniform(-1.0, 1.0, (n, DIM)).astype(np.float32)
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    # (name, x, y, exact atol, fast atol, rtol).  The JAX test's shapes are
    # held to its atol alone; then shapes that cross the kernels' 128-row tiles
    # and 32- / 64-wide chunks of D: their L2 sums reach ~300, where one f32
    # ulp is 3e-5, so they also get a relative bound of ~8 ulps.
    def normal(q, c, d, rtol):
        return (f"{q}x{d}/{c}x{d}", rng.normal(size=(q, d)), rng.normal(size=(c, d)),
                SMALL_ATOL, FAST_SMALL_ATOL, rtol)

    def unit_rows(n, d):
        a = rng.normal(size=(n, d)).astype(np.float32)
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    cases = [normal(70, 130, 32, 0.0), normal(1, 3, 7, 0.0), normal(129, 257, 104, 1e-6),
             normal(127, 255, 8, 1e-6), normal(256, 383, 136, 1e-6), normal(300, 1030, 65, 1e-6),
             # wide rows: the fast kernel's query tile streams through the ring
             ("257x768/1281x768", unit_rows(257, 768), unit_rows(1281, 768),
              BLOCK_ATOL, FAST_BLOCK_ATOL, 0.0),
             ("2048x100/65536x100", unit(MAIN_BLOCK[0]), unit(MAIN_BLOCK[1]),
              BLOCK_ATOL, FAST_BLOCK_ATOL, 0.0)]
    max_err = {True: 0.0, False: 0.0}
    for name, xa, ya, atol, fast_atol, rtol in cases:
        x = torch.as_tensor(xa, dtype=torch.float32, device=device)
        y = torch.as_tensor(ya, dtype=torch.float32, device=device)
        for metric in Metric:
            for exact in (True, False):
                want = pairwise_distance(x, y, metric) if exact else pairwise_distance_bf16_dots(x, y, metric)
                got = cuda_distance.cuda_pairwise_distance(x, y, metric, exact=exact)
                torch.cuda.synchronize()
                tol = (atol if exact else fast_atol) + rtol * float(want.abs().max())
                err = float((got - want).abs().max())
                max_err[exact] = max(max_err[exact], err)
                print(f"kernel {name} {metric.value} exact={exact}: max_abs_err={err:.3e} (tolerance {tol:.1e})")
                assert err <= tol, f"kernel disagrees with plain version: {name} {metric.value} {err}"
    # the kernel that prepares a fast-mode operand, against its plain version:
    # rows bit for bit; norms (fp64 sums rounded once, against torch.sum's f32
    # sums) within 5e-7 of the largest norm
    operand_err = 0.0
    for name, xa, ya, *_ in cases:
        for m in (xa, ya):
            m = torch.as_tensor(m, dtype=torch.float32, device=device)
            rows, norms = cuda_distance.cuda_bf16_operand(m, with_norms=True)
            want_rows, want_norms = cuda_distance.plain_bf16_operand(m, with_norms=True)
            assert torch.equal(rows, want_rows), f"bf16_operand rows differ from the plain cast: {name}"
            err = float((norms - want_norms).abs().max())
            tol = 5e-7 * float(want_norms.max())
            assert err <= tol, f"bf16_operand norms disagree with torch.sum: {name} {err} > {tol}"
            assert torch.equal(cuda_distance.cuda_bf16_operand(m)[0], want_rows)
            operand_err = max(operand_err, err)
    print(f"bf16_operand: rows bit-identical to the plain cast at every shape above, norms "
          f"max_abs_err={operand_err:.3e} (tolerance 5e-7 relative)")
    x = torch.as_tensor(cases[-1][1], device=device)
    y = torch.as_tensor(cases[-1][2], device=device)
    exact_ms, fast_ms = {}, {}
    for metric in (Metric.NORMALIZED_COSINE, Metric.EUCLIDEAN):
        # alternate plain, kernel, kernel, plain
        p1 = _median_ms(lambda: pairwise_distance(x, y, metric))
        k1 = _median_ms(lambda: cuda_distance.cuda_pairwise_distance(x, y, metric))
        k2 = _median_ms(lambda: cuda_distance.cuda_pairwise_distance(x, y, metric))
        p2 = _median_ms(lambda: pairwise_distance(x, y, metric))
        exact_ms[metric] = (min(k1, k2), min(p1, p2))
        print(f"time at main-path block {metric.value} exact: kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.4f} / {p2:.4f} ms")
        # fast mode as the paths call it: operands prepared once, not per block;
        # then with both operands prepared inside the call
        xo = cuda_distance.prepare_operand(x, metric, exact=False)
        yo = cuda_distance.prepare_operand(y, metric, exact=False)
        fast = lambda: cuda_distance.cuda_pairwise_distance(xo, yo, metric, exact=False)
        p1 = _median_ms(lambda: pairwise_distance_bf16_dots(x, y, metric))
        k1, k2 = _median_ms(fast), _median_ms(fast)
        p2 = _median_ms(lambda: pairwise_distance_bf16_dots(x, y, metric))
        whole = _median_ms(lambda: cuda_distance.cuda_pairwise_distance(x, y, metric, exact=False))
        fast_ms[metric] = (min(k1, k2), min(p1, p2), whole)
        print(f"time at main-path block {metric.value} fast: kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.4f} / {p2:.4f} ms; with both operands prepared in the call "
              f"(two more launches) {whole:.4f} ms")
    # the operand kernel at the corpus block, with the norms (the L2 metrics)
    o1 = _median_ms(lambda: cuda_distance.plain_bf16_operand(y, with_norms=True))
    ok1 = _median_ms(lambda: cuda_distance.cuda_bf16_operand(y, with_norms=True))
    ok2 = _median_ms(lambda: cuda_distance.cuda_bf16_operand(y, with_norms=True))
    o2 = _median_ms(lambda: cuda_distance.plain_bf16_operand(y, with_norms=True))
    operand_ms, operand_plain_ms = min(ok1, ok2), min(o1, o2)
    operand_x_ms = _median_ms(lambda: cuda_distance.cuda_bf16_operand(x, with_norms=True))
    # ... and at a size where the card, not the wrapper's host time, sets the time
    big = torch.randn((OPERAND_BIG_ROWS, DIM), device=device)
    big_ms = _median_ms(lambda: cuda_distance.cuda_bf16_operand(big, with_norms=True))
    big_plain_ms = _median_ms(lambda: cuda_distance.plain_bf16_operand(big, with_norms=True))
    del big
    out_fill = torch.empty(MAIN_BLOCK, dtype=torch.float32, device=device)
    fill_ms = _median_ms(lambda: out_fill.fill_(1.0))
    del out_fill
    # Library calls, timed here and used nowhere in the port: torch.addmm with
    # a broadcast 0.5 computes 0.5 - 0.5 * x @ y.T (normalized cosine; alpha =
    # -1 and a 1 or 0 give cosine and dot) in one cuBLAS call, torch.cdist the
    # euclidean distance, torch.matmul of the bf16 operands the fast mode's
    # product (into a bf16 matrix: half the kernel's output bytes).
    half = torch.full((), 0.5, device=device)
    addmm = lambda: torch.addmm(half, x, y.T, beta=1.0, alpha=-0.5)
    addmm_err = float((addmm() - pairwise_distance(x, y, Metric.NORMALIZED_COSINE)).abs().max())
    assert addmm_err <= BLOCK_ATOL, f"torch.addmm is not the same function: {addmm_err}"
    addmm_ms = min(_median_ms(addmm), _median_ms(addmm))
    cdist_ms = _median_ms(lambda: torch.cdist(x, y))
    xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
    bf16_matmul_ms = _median_ms(lambda: torch.matmul(xb, yb.T))
    q, c = MAIN_BLOCK
    dpad = DIM + -DIM % 8
    operand_bound = _bound(2.0 * c * DIM, PEAK_FP32_FLOPS, c * (4.0 * DIM + 2.0 * dpad + 4.0))
    print(f"bf16_operand at {c} x {DIM} with norms: kernel {ok1:.4f} / {ok2:.4f} ms, plain (cast, "
          f"pad, torch.sum) {o1:.4f} / {o2:.4f} ms, bound {operand_bound['bound_ms']:.4f} ms by "
          f"{operand_bound['bound_by']}; at {q} x {DIM}: {operand_x_ms:.4f} ms (the same: at these "
          f"sizes the time is the wrapper's on the host); at {OPERAND_BIG_ROWS} x {DIM}: kernel "
          f"{big_ms:.4f} ms ({OPERAND_BIG_ROWS * (4.0 * DIM + 2.0 * dpad + 4.0) / big_ms / 1e9:.2f} "
          f"TB/s), plain {big_plain_ms:.4f} ms; a fill_ of the "
          f"{q} x {c} f32 output: {fill_ms:.4f} ms ({4.0 * q * c / fill_ms / 1e9:.2f} TB/s)")
    bound = _bound(2.0 * q * c * DIM, PEAK_FP32_FLOPS, 4.0 * (q * DIM + c * DIM + q * c))
    fast_bound = _bound(2.0 * q * c * DIM, PEAK_BF16_FLOPS, 2.0 * (q + c) * dpad + 4.0 * q * c)
    ms, plain_ms = exact_ms[Metric.NORMALIZED_COSINE]
    l2_ms, l2_plain_ms = exact_ms[Metric.EUCLIDEAN]
    f_ms, f_plain_ms, f_whole_ms = fast_ms[Metric.NORMALIZED_COSINE]
    f_l2_ms, f_l2_plain_ms, f_l2_whole_ms = fast_ms[Metric.EUCLIDEAN]
    print(f"pairwise_distance exact at {q} x {c} x {DIM}: bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']}; normalized cosine kernel {ms:.4f} ms "
          f"({2.0 * q * c * DIM / ms / 1e9:.2f} TFLOP/s, {bound['bound_ms'] / ms:.1%} of the bound), "
          f"plain {plain_ms:.4f} ms, torch.addmm {addmm_ms:.4f} ms (kernel / library "
          f"{ms / addmm_ms:.3f}); euclidean kernel {l2_ms:.4f} ms, plain {l2_plain_ms:.4f} ms, "
          f"torch.cdist {cdist_ms:.4f} ms (kernel / library {l2_ms / cdist_ms:.3f})")
    print(f"pairwise_distance fast at {q} x {c} x {DIM}: bound {fast_bound['bound_ms']:.4f} ms by "
          f"{fast_bound['bound_by']}; normalized cosine kernel {f_ms:.4f} ms "
          f"({fast_bound['bound_ms'] / f_ms:.1%} of the bound), plain {f_plain_ms:.4f} ms; "
          f"euclidean kernel {f_l2_ms:.4f} ms ({f_l2_whole_ms:.4f} ms with both operands prepared "
          f"in the call), plain {f_l2_plain_ms:.4f} ms; torch.matmul of the "
          f"bf16 operands {bf16_matmul_ms:.4f} ms (kernel / library {f_ms / bf16_matmul_ms:.3f})")
    # the exact kernel over D, beside the library call: the intercept is the
    # output write, the slope the FFMA loop
    for d in (32, 128, 256, 512):
        xd = torch.randn((q, d), device=device)
        yd = torch.randn((c, d), device=device)
        k_ms = _median_ms(lambda: cuda_distance.cuda_pairwise_distance(xd, yd, Metric.NORMALIZED_COSINE), reps=5)
        l_ms = _median_ms(lambda: torch.addmm(half, xd, yd.T, beta=1.0, alpha=-0.5), reps=5)
        print(f"pairwise_distance exact at {q} x {c} x {d}: kernel {k_ms:.4f} ms "
              f"({2.0 * q * c * d / k_ms / 1e9:.2f} TFLOP/s), torch.addmm {l_ms:.4f} ms "
              f"({2.0 * q * c * d / l_ms / 1e9:.2f} TFLOP/s)")
    operand = {"max_abs_err": operand_err, "ms": operand_ms, "plain_ms": operand_plain_ms,
               **operand_bound, "library_ms": None,
               "shape": f"[{c} x {DIM}] f32 -> [{c} x {dpad}] bf16 + [{c}] f32 norms",
               "query_block_ms": operand_x_ms, "big_shape": f"[{OPERAND_BIG_ROWS} x {DIM}]",
               "big_ms": big_ms, "big_plain_ms": big_plain_ms}
    return operand, {"max_abs_err": max_err[True], "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": addmm_ms, "library": "torch.addmm",
            "metric": Metric.NORMALIZED_COSINE.value,
            "l2_ms": l2_ms, "l2_plain_ms": l2_plain_ms, "l2_library_ms": cdist_ms,
            "l2_library": "torch.cdist",
            "fast_max_abs_err": max_err[False], "fast_ms": f_ms, "fast_plain_ms": f_plain_ms,
            "fast_bound_ms": fast_bound["bound_ms"], "fast_bound_by": fast_bound["bound_by"],
            "fast_library_ms": bf16_matmul_ms, "fast_library": "torch.matmul (bf16)",
            "fast_l2_ms": f_l2_ms, "fast_l2_plain_ms": f_l2_plain_ms,
            "fast_unprepared_ms": f_whole_ms, "fast_l2_unprepared_ms": f_l2_whole_ms,
            "output_fill_ms": fill_ms}


def _scan_small_cases(device) -> float:
    """Both scans against their plain versions at the JAX kernel tests'
    shapes, every metric, both modes: columns identical, distances close."""
    rng = np.random.default_rng(3)

    def unit(n, d):
        a = rng.normal(size=(n, d)).astype(np.float32)
        return torch.as_tensor(a / np.linalg.norm(a, axis=1, keepdims=True), device=device)

    # (Q, C, D, tile_c, n_slots): n_slots None = binned
    # the last two, fast mode only: rows too wide for the bf16 kernel's query
    # tile to stay in shared memory
    shapes = [(16, 300, 8, 256, None), (16, 1500, 8, 256, 4), (24, 3000, 16, 256, 8),
              (129, 1500, 768, 256, None), (129, 1500, 712, 256, 4)]
    max_err = 0.0
    for q, c, d, tile_c, n_slots in shapes:
        x, y = unit(q, d), unit(c, d)
        for metric in Metric:
            for exact in (True, False) if d <= 16 else (False,):
                if n_slots is None:
                    name = "binned_scan"
                    got = cuda_scan.cuda_binned_scan(x, y, metric, tile_c=tile_c, exact=exact)
                    want = cuda_scan.plain_binned_scan(x, y, metric, tile_c=tile_c, exact=exact)
                else:
                    name = "folded_scan"
                    got = cuda_scan.cuda_folded_scan(x, y, metric, tile_c=tile_c,
                                                     n_slots=n_slots, exact=exact)
                    want = cuda_scan.plain_folded_scan(x, y, metric, tile_c=tile_c,
                                                       n_slots=n_slots, exact=exact)
                torch.cuda.synchronize()
                fin = torch.isfinite(want[0])
                assert torch.equal(torch.isfinite(got[0]), fin), f"{name}: +inf bins differ"
                err = float((got[0][fin] - want[0][fin]).abs().max())
                same = bool(torch.equal(got[1], want[1]))
                max_err = max(max_err, err)
                print(f"{name} {q}x{d}/{c}x{d} tile_c={tile_c} n_slots={n_slots} {metric.value} "
                      f"exact={exact}: max_abs_err={err:.3e} (atol {SCAN_SMALL_ATOL:.0e}), "
                      f"columns identical: {same}")
                assert err <= SCAN_SMALL_ATOL, f"{name} disagrees with its plain version: {err}"
                if not same:
                    # the tensor cores sum a dot in their own order, so a
                    # near-tie may go to another column: then the plain
                    # distance AT THE KERNEL'S COLUMN must be the plain minimum
                    # within the tolerance (exact ties are held below)
                    assert not exact, f"{name} (f32) reports other columns than its plain version"
                    differ = got[1] != want[1]
                    assert bool(fin[differ].all()) and float(differ.float().mean()) < 0.001
                    xs, ys = x.bfloat16().float(), y.bfloat16().float()
                    at_col = pairwise_distance(xs, ys, metric)[
                        differ.nonzero()[:, 0], got[1][differ].long()]
                    gap = float((at_col - want[0][differ]).abs().max())
                    print(f"  {int(differ.sum())} near-ties took another column, {gap:.3e} from the minimum")
                    assert gap <= SCAN_SMALL_ATOL, f"{name} reports columns that are not minima: {gap}"

    # ties: class l holds the same row eight times; the first group of each
    # tile, and the first tile of each slot, must win
    base = unit(128, 8)
    y, x = torch.cat([base] * 8), unit(6, 8)
    lane = torch.arange(128, device=device)
    for exact in (True, False):
        for metric in (Metric.NORMALIZED_COSINE, Metric.SQUARED_EUCLIDEAN):
            cols = cuda_scan.cuda_binned_scan(x, y, metric, tile_c=256, exact=exact)[1]
            want = (torch.arange(4, device=device)[:, None] * 256 + lane).reshape(1, -1)
            assert torch.equal(cols, want.expand(6, -1).int()), "binned tie: not the first index"
            cols = cuda_scan.cuda_folded_scan(x, y, metric, tile_c=256, n_slots=2, exact=exact)[1]
            want = (torch.arange(2, device=device)[:, None] * 512 + lane).reshape(1, -1)
            assert torch.equal(cols, want.expand(6, -1).int()), "folded tie: not the first tile"
    # torch.min on the card, for the record (the plain versions do not rest on it)
    t = torch.tensor([[3.0, 1.0, 1.0, 2.0, 1.0]], device=device).expand(4096, -1).contiguous()
    print(f"ties: first index wins in both kernels; torch.min(dim) picks index "
          f"{sorted(set(torch.min(t, dim=1).indices.tolist()))} of [3, 1, 1, 2, 1]")
    return max_err


def _distance_at(x, y, cols, metric, rows_per_pass: int = 32) -> torch.Tensor:
    """Plain distances ``[Q, B]`` of ``x[q]`` to ``y[cols[q, b]]``."""
    out = []
    for r in range(0, x.shape[0], rows_per_pass):
        picked = y[cols[r : r + rows_per_pass].long()].float()
        out.append(batched_distance(x[r : r + rows_per_pass].float(), picked, metric))
    return torch.cat(out)


def _check_by_value(name, got, want, x, y, metric, what) -> float:
    """Kernel bins ``got`` against plain bins ``want`` of the same rows, by
    value: two summation orders may swap the columns of near-ties, so the
    kernel's bins must be close to the plain bins and the plain distance AT
    THE COLUMN THE KERNEL REPORTED close to the plain class minimum."""
    (got_d, got_c), (want_d, want_c) = got, want
    assert bool(torch.isfinite(want_d).all()) and bool(torch.isfinite(got_d).all())
    assert int(got_c.min()) >= 0 and int(got_c.max()) < y.shape[0]
    err = float((got_d - want_d).abs().max())
    at_col = float((_distance_at(x, y, got_c, metric) - want_d).abs().max())
    same = float((got_c == want_c).float().mean())
    print(f"{name} main shape {what}: {x.shape[0]} x {y.shape[0]} x {y.shape[1]}, "
          f"bins {tuple(got_d.shape)}: max_abs_err={err:.3e}, plain distance at the "
          f"kernel's column vs plain minimum {at_col:.3e} (atol {SCAN_MAIN_ATOL:.0e}), "
          f"identical columns {same:.6f}")
    assert err <= SCAN_MAIN_ATOL, f"{name} disagrees with its plain version: {err}"
    assert at_col <= SCAN_MAIN_ATOL, f"{name} reports columns that are not minima: {at_col}"
    return max(err, at_col)


def _scan_main_case(name, scan, plain, x, y, metric) -> dict:
    """One scan at a main shape, both modes.  The first 512 query rows
    against the plain version by value, in ``metric`` and in euclidean (the
    norms, the clamp and the square root); the times at 4096 rows; then the
    last 512 rows of a 4096-row launch by value, so the far row tiles of the
    timed grid are held too."""
    out = {}
    for exact in (True, False):
        xs, ys = (x, y) if exact else (x.to(torch.bfloat16), y.to(torch.bfloat16))
        head, tail = xs[:SCAN_CHECK_ROWS], xs[SCAN_QUERY_BLOCK - SCAN_CHECK_ROWS : SCAN_QUERY_BLOCK]
        errs = []
        for m in (metric, Metric.EUCLIDEAN):
            errs.append(_check_by_value(
                name, scan(head, ys, m, exact=exact), plain(head, ys, m, exact=exact),
                head, ys, m, f"{m.value} exact={exact} first rows"))
        # plain, kernel, kernel, plain
        xq = xs[:SCAN_QUERY_BLOCK]
        p1 = _median_ms(lambda: plain(xq, ys, metric, exact=exact), reps=3)
        k1 = _median_ms(lambda: scan(xq, ys, metric, exact=exact))
        k2 = _median_ms(lambda: scan(xq, ys, metric, exact=exact))
        p2 = _median_ms(lambda: plain(xq, ys, metric, exact=exact), reps=3)
        l2_ms = _median_ms(lambda: scan(xq, ys, Metric.EUCLIDEAN, exact=exact), reps=5)
        full_d, full_c = scan(xq, ys, metric, exact=exact)
        errs.append(_check_by_value(
            name, (full_d[-SCAN_CHECK_ROWS:], full_c[-SCAN_CHECK_ROWS:]),
            plain(tail, ys, metric, exact=exact), tail, ys, metric,
            f"{metric.value} exact={exact} last rows of the {SCAN_QUERY_BLOCK}-row launch"))
        q, (c, d) = xq.shape[0], ys.shape
        bins = full_d.shape[1]
        bound = _bound(2.0 * q * c * d, PEAK_FP32_FLOPS if exact else PEAK_BF16_FLOPS,
                       xs.element_size() * (q * d + c * d) + 2 * 4.0 * q * bins)
        print(f"{name} time at {q} x {c} x {d} exact={exact}: kernel {k1:.3f} / {k2:.3f} ms "
              f"({2.0 * q * c * d / min(k1, k2) / 1e9:.2f} TFLOP/s, "
              f"{bound['bound_ms'] / min(k1, k2):.1%} of the bound), plain {p1:.3f} / {p2:.3f} ms, "
              f"bound {bound['bound_ms']:.3f} ms by {bound['bound_by']}; euclidean kernel "
              f"{l2_ms:.3f} ms")
        out[exact] = {"max_abs_err": max(errs), "ms": min(k1, k2), "plain_ms": min(p1, p2),
                      "l2_ms": l2_ms, **bound}
    # the main path runs the fast mode; the exact mode's numbers ride along
    return {**out[False], "library_ms": None,
            "mode": "fast (bf16 in, TMA + wgmma tensor cores, f32 accumulate)",
            "max_abs_err": max(out[True]["max_abs_err"], out[False]["max_abs_err"]),
            "exact_ms": out[True]["ms"], "exact_plain_ms": out[True]["plain_ms"],
            "exact_bound_ms": out[True]["bound_ms"], "exact_l2_ms": out[True]["l2_ms"]}


def _scan_wide_case(device, metric) -> dict:
    """The fast binned scan at rows too wide for its query tile to stay in
    shared memory: ``[4096 x 262,144 x 768]`` unit vectors, 512 query rows
    against the plain version by value, then the time beside the bound."""
    q, c, d = SCAN_QUERY_BLOCK, WIDE_ROWS, WIDE_DIM
    gen = torch.Generator(device=device).manual_seed(7)
    y = torch.nn.functional.normalize(torch.randn((c, d), generator=gen, device=device))
    x = torch.nn.functional.normalize(torch.randn((q, d), generator=gen, device=device))
    xs, ys = cuda_scan.scan_operand(x), cuda_scan.scan_operand(y)
    scan = lambda a: cuda_scan.cuda_binned_scan(a, ys, metric, tile_c=FLAT_TILE_C, exact=False)
    head = xs[:SCAN_CHECK_ROWS]
    err = _check_by_value(
        "binned_scan", scan(head),
        cuda_scan.plain_binned_scan(head, ys, metric, tile_c=FLAT_TILE_C, exact=False),
        head, ys, metric, f"{metric.value} exact=False wide rows")
    ms = min(_median_ms(lambda: scan(xs), reps=5), _median_ms(lambda: scan(xs), reps=5))
    bound = _bound(2.0 * q * c * d, PEAK_BF16_FLOPS,
                   2.0 * (q * d + c * d) + 2 * 4.0 * q * (c // FLAT_TILE_C) * 128)
    print(f"binned_scan time at {q} x {c} x {d} exact=False (query tile streamed): kernel "
          f"{ms:.3f} ms ({2.0 * q * c * d / ms / 1e9:.2f} TFLOP/s, {bound['bound_ms'] / ms:.1%} of "
          f"the bound {bound['bound_ms']:.3f} ms by {bound['bound_by']})")
    return {"wide_shape": f"{q} x {c} x {d}", "wide_ms": ms, "wide_bound_ms": bound["bound_ms"],
            "wide_max_abs_err": err}


def check_scan_kernels(device, vecs: torch.Tensor) -> dict:
    """``vecs``: the flat phase's unit vectors, corpus rows first, the
    held-out queries last."""
    small_err = _scan_small_cases(device)
    metric = Metric.NORMALIZED_COSINE
    x = vecs[FLAT_SIZES[1][0] :][:SCAN_QUERY_BLOCK].contiguous()
    binned = _scan_main_case(
        "binned_scan",
        lambda a, b, m, exact: cuda_scan.cuda_binned_scan(a, b, m, tile_c=FLAT_TILE_C, exact=exact),
        lambda a, b, m, exact: cuda_scan.plain_binned_scan(a, b, m, tile_c=FLAT_TILE_C, exact=exact),
        x, vecs[: FLAT_SIZES[0][0]], metric)
    folded = _scan_main_case(
        "folded_scan",
        lambda a, b, m, exact: cuda_scan.cuda_folded_scan(a, b, m, tile_c=FLAT_TILE_C,
                                                          n_slots=FLAT_SLOTS, exact=exact),
        lambda a, b, m, exact: cuda_scan.plain_folded_scan(a, b, m, tile_c=FLAT_TILE_C,
                                                           n_slots=FLAT_SLOTS, exact=exact),
        x, vecs[: FLAT_SIZES[1][0]], metric)
    for entry in (binned, folded):
        entry["max_abs_err"] = max(entry["max_abs_err"], small_err)
    binned.update(_scan_wide_case(device, metric))

    # the flat scan's other stages at one 4096-query block, beside the kernels
    k_scan = 40
    for (rows, mode), kernel in zip(FLAT_SIZES, (binned, folded)):
        source = DenseSource(vecs[:rows])
        xb, yb = x.to(torch.bfloat16), source.vectors.to(torch.bfloat16)
        # the dispatches, at their defaults, as fast_flat_knn calls them
        scan = cuda_scan.binned_scan if mode == "binned" else cuda_scan.folded_scan
        bd, bc = scan(xb, yb, metric, tile_c=FLAT_TILE_C, exact=False)
        cut_ms = _median_ms(lambda: flat.cut_survivors(bd, bc, 0, k_scan))
        cand = flat.cut_survivors(bd, bc, 0, k_scan)[0]
        rerank_ms = _median_ms(lambda: flat.rerank_blocks(source, metric, x, cand, x.shape[0]))
        cast_ms = _median_ms(lambda: cuda_scan.scan_operand(source.vectors))
        print(f"flat scan stages at {rows} rows, one {SCAN_QUERY_BLOCK}-query block ({mode}): "
              f"kernel {kernel['ms']:.3f} ms, survivor cut (top-{k_scan} of {bd.shape[1]} bins + "
              f"sort) {cut_ms:.3f} ms, rerank (gather + distances + sort) {rerank_ms:.3f} ms; "
              f"bf16 cast of the corpus, once per call, {cast_ms:.3f} ms")
        kernel.update(cut_ms=cut_ms, rerank_ms=rerank_ms, corpus_cast_ms=cast_ms)
    return {"binned_scan": binned, "folded_scan": folded}


def check_gather_kernel(device) -> dict:
    """The row-gather kernel against ``plain_row_gather``, bit for bit, then
    its time at the hop's shapes beside ``torch.index_select`` and the bound."""
    gen = torch.Generator().manual_seed(5)

    def table(n, dtype, *tail):
        t = torch.randint(0, 1 << 15, (n, *tail), generator=gen)
        t = t.to(dtype) if dtype is torch.int32 else (t.float() - 16384.0).to(dtype)
        return t.to(device)

    tables = [table(20_000, torch.float32, d) for d in (100, 128, 96, 1)]
    tables += [table(20_000, torch.bfloat16, d) for d in (64, 100, 128)]
    tables += [table(20_000, torch.int32, m) for m in (24, 48)]
    tables += [table(2_000, torch.float32, 48, 100), table(2_000, torch.bfloat16, 48, 100)]
    cases = 0
    for t in tables:
        n = t.shape[0]
        for r in (1, 2047, 2048, 100_000):
            idx = torch.randint(0, n, (r,), generator=gen, dtype=torch.int32)
            head = torch.tensor([n - 1, 0, 9, 9], dtype=torch.int32)[:r]  # both ends, a repeat
            idx[: head.shape[0]] = head
            idx = idx.to(device)
            got = cuda_gather.cuda_row_gather(t, idx)
            if cases == 0:
                torch.cuda.synchronize()  # a bad address shows here, at the first launch
            want = cuda_gather.plain_row_gather(t, idx)
            assert got.dtype == t.dtype and got.shape == (r, *t.shape[1:])
            assert torch.equal(got, want), (
                f"row_gather differs from index_select: {t.dtype} {tuple(t.shape)} R={r}")
            cases += 1
    torch.cuda.synchronize()
    print(f"row_gather: {cases} cases (f32 D 100/128/96/1, bf16 64/100/128, int32 24/48, "
          f"[N, 48, 100] f32 and bf16 slabs; R 1/2047/2048/100000) bit-identical to index_select")
    del tables

    out = {}
    for n, d in GATHER_TIMED:
        t = torch.randn((n, d), generator=gen).to(device)
        idx = torch.randint(0, n, (GATHER_ROWS,), generator=gen, dtype=torch.int32).to(device)
        # plain, kernel, kernel, plain; the library call is the plain version's
        # own index_select without its index cast and reshape
        p1 = _median_ms(lambda: cuda_gather.plain_row_gather(t, idx))
        k1 = _median_ms(lambda: cuda_gather.cuda_row_gather(t, idx))
        k2 = _median_ms(lambda: cuda_gather.cuda_row_gather(t, idx))
        p2 = _median_ms(lambda: cuda_gather.plain_row_gather(t, idx))
        lib = _median_ms(lambda: torch.index_select(t, 0, idx))
        fancy = _median_ms(lambda: t[idx])
        got, want = cuda_gather.cuda_row_gather(t, idx), torch.index_select(t, 0, idx)
        assert torch.equal(got, want), f"row_gather differs at {GATHER_ROWS} x {n} x {d}"
        nbytes = 4.0 * GATHER_ROWS + 4.0 * n * d + 4.0 * GATHER_ROWS * d
        bound = _bound(0.0, PEAK_FP32_FLOPS, nbytes)
        ms = min(k1, k2)
        print(f"row_gather time at R={GATHER_ROWS} from [{n} x {d}] f32: kernel {k1:.4f} / {k2:.4f} ms "
              f"({nbytes / ms / 1e9:.2f} TB/s of the bound's bytes), plain {p1:.4f} / {p2:.4f} ms, "
              f"torch.index_select {lib:.4f} ms, torch indexing {fancy:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}")
        out[(n, d)] = {"max_abs_err": float((got - want).abs().max()), "ms": ms,
                       "plain_ms": min(p1, p2), "library_ms": lib, "library": "torch.index_select",
                       "fancy_index_ms": fancy, **bound}
    study, main_path = (out[k] for k in GATHER_TIMED)
    n, d = GATHER_TIMED[1]
    # what the hop gathers with it now: the neighbor rows of the expanded nodes
    m = HOP_CANDIDATES // 4
    nbr = torch.randint(0, 1 << 30, (n, m), generator=gen, dtype=torch.int32).to(device)
    idx = torch.randint(0, n, (HOP_QUERIES, 4), generator=gen, dtype=torch.int32).to(device)
    k1 = _median_ms(lambda: cuda_gather.cuda_row_gather(nbr, idx))
    p1 = _median_ms(lambda: cuda_gather.plain_row_gather(nbr, idx))
    k2 = _median_ms(lambda: cuda_gather.cuda_row_gather(nbr, idx))
    nbr_bound = _bound(0.0, PEAK_FP32_FLOPS, 4.0 * idx.numel() * (1 + 2 * m))
    assert torch.equal(cuda_gather.cuda_row_gather(nbr, idx), cuda_gather.plain_row_gather(nbr, idx))
    print(f"row_gather time at the hop's neighbor rows ({idx.numel()} int32 rows of {m} from "
          f"[{n} x {m}]): kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} ms, bound "
          f"{nbr_bound['bound_ms']:.4f} ms by {nbr_bound['bound_by']}")
    return {**main_path, "shape": f"R={GATHER_ROWS}, table [{n} x {d}] f32",
            "study_ms": study["ms"], "study_plain_ms": study["plain_ms"],
            "study_library_ms": study["library_ms"], "study_bound_ms": study["bound_ms"],
            "neighbor_rows_shape": f"R={idx.numel()}, table [{n} x {m}] int32",
            "neighbor_rows_ms": min(k1, k2), "neighbor_rows_plain_ms": p1,
            "neighbor_rows_bound_ms": nbr_bound["bound_ms"]}


def check_gather_distance_kernel(device) -> dict:
    """The hop's gather-and-distance kernel against ``plain_gather_distance``
    (``index_select`` + ``batched_distance``), then its times at the hop's
    shapes beside the two-step hop it replaces, the two library calls that
    compute the same, and its bounds."""
    gen = torch.Generator().manual_seed(6)

    def unit(*shape):
        return torch.nn.functional.normalize(torch.randn(shape, generator=gen), dim=-1)

    max_err, cases = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (100, 128, 64, 33):
            for shape, k in (((20_000, d), 191), ((600, 48, d), 4)):  # rows; slabs of 48
                table = unit(*shape).to(dtype).to(device)
                queries = unit(1000, d).to(device)
                idx = torch.randint(0, shape[0], (1000, k), generator=gen, dtype=torch.int32)
                idx[0, :3] = torch.tensor([0, shape[0] - 1, shape[0] - 1])  # both ends, a repeat
                idx[1, :2] = torch.tensor([2**31 - 1, -1])  # outside the table: +inf
                idx[2] = 2**31 - 1  # a query that is done
                idx = idx.to(device)
                for metric in Metric:
                    got = cuda_gather.cuda_gather_distance(queries, table, idx, metric)
                    if cases == 0:
                        torch.cuda.synchronize()  # a bad address shows here, at the first launch
                    want = cuda_gather.plain_gather_distance(queries, table, idx, metric)
                    assert torch.equal(torch.isinf(got), torch.isinf(want))
                    fin = torch.isfinite(want)
                    err = float((got[fin] - want[fin]).abs().max())
                    assert err <= GATHER_DISTANCE_ATOL, (
                        f"gather_distance disagrees: {dtype} {shape} {metric.value} {err}")
                    max_err = max(max_err, err)
                    cases += 1
    torch.cuda.synchronize()
    print(f"gather_distance: {cases} cases (f32 and bf16 rows, D 100/128/64/33, source rows "
          f"and slabs of 48, every metric, indices outside the table) within "
          f"{GATHER_DISTANCE_ATOL:.0e} of the plain version: max_abs_err={max_err:.3e}")

    metric = Metric.NORMALIZED_COSINE
    half = torch.full((), 0.5, device=device)
    out = {}
    for n, d, dtype in ((200_000, DIM, torch.float32), (100_000, 128, torch.float32),
                        (200_000, DIM, torch.bfloat16)):
        table = unit(n, d).to(dtype).to(device)
        queries = unit(HOP_QUERIES, d).to(device)
        idx = torch.randint(0, n, (HOP_QUERIES, HOP_CANDIDATES), generator=gen,
                            dtype=torch.int32).to(device)
        fused = lambda: cuda_gather.cuda_gather_distance(queries, table, idx, metric)
        before = lambda: batched_distance(queries, cuda_gather.cuda_row_gather(table, idx), metric)
        plain = lambda: cuda_gather.plain_gather_distance(queries, table, idx, metric)
        # the library's two calls: index_select, then 0.5 - 0.5 * dot in one
        # baddbmm (the rows widened to f32 first where they are bf16)
        flat = idx.reshape(-1)
        library = lambda: torch.baddbmm(
            half, torch.index_select(table, 0, flat).view(HOP_QUERIES, HOP_CANDIDATES, d).float(),
            queries.unsqueeze(-1), beta=1.0, alpha=-0.5).squeeze(-1)
        want = plain()
        err = max(float((fused() - want).abs().max()), float((library() - want).abs().max()))
        assert err <= GATHER_DISTANCE_ATOL, f"gather_distance disagrees at the hop's shape: {err}"
        # before, kernel, kernel, before
        b1, k1, k2, b2 = (_median_ms(f) for f in (before, fused, fused, before))
        p_ms = _median_ms(plain)
        lib_ms = _median_ms(library)
        rows_read = float(torch.unique(idx).numel())
        io = 4.0 * (idx.numel() + HOP_QUERIES * d + idx.numel())  # idx, queries, distances
        row_bytes = d * table.element_size()
        flops = 2.0 * idx.numel() * d
        bound = _bound(flops, PEAK_FP32_FLOPS, io + rows_read * row_bytes)
        every_row = _bound(flops, PEAK_FP32_FLOPS, io + idx.numel() * row_bytes)
        ms = min(k1, k2)
        name = f"[{n} x {d}] {str(dtype).replace('torch.', '')}"
        print(f"gather_distance at the hop ({HOP_QUERIES} x {HOP_CANDIDATES} over {name}, "
              f"{metric.value}): max_abs_err={err:.3e}; kernel {k1:.4f} / {k2:.4f} ms; "
              f"row_gather + batched_distance {b1:.4f} / "
              f"{b2:.4f} ms; plain {p_ms:.4f} ms; torch.index_select + torch.baddbmm {lib_ms:.4f} ms; "
              f"bound {bound['bound_ms']:.4f} ms with the {int(rows_read)} distinct rows read once, "
              f"{every_row['bound_ms']:.4f} ms with every gathered row read (by "
              f"{every_row['bound_by']}); kernel at {bound['bound_ms'] / ms:.1%} / "
              f"{every_row['bound_ms'] / ms:.1%} of them")
        out[name] = {"max_abs_err": max(err, max_err), "ms": ms,
                     "plain_ms": p_ms, "before_ms": min(b1, b2), "library_ms": None,
                     "two_call_library_ms": lib_ms,
                     "two_call_library": "torch.index_select + torch.baddbmm", **bound,
                     "every_row_bound_ms": every_row["bound_ms"]}
    main_path, study, routing = out.values()
    names = list(out)
    return {**main_path, "shape": f"{HOP_QUERIES} x {HOP_CANDIDATES} candidates over {names[0]}",
            "study_shape": names[1], "study_ms": study["ms"], "study_before_ms": study["before_ms"],
            "study_bound_ms": study["bound_ms"], "routing_shape": names[2],
            "routing_ms": routing["ms"], "routing_before_ms": routing["before_ms"],
            "routing_bound_ms": routing["bound_ms"]}


def _hop_queues(rows: int, cap: int, c: int, gen: torch.Generator, device):
    """A hop's queue-update inputs at ef ``cap``: queues merged from random
    nodes of a 200,000-row index at distances in [0, 1) (flags 0 or 1), and
    candidates of which a third repeat queued nodes at their distance or one
    ulp below it and a tenth are empty slots; no row done."""
    ids = torch.randint(0, 200_000, (rows, 2 * cap), generator=gen, dtype=torch.int32)
    d = torch.rand(rows, 2 * cap, generator=gen)
    q_ids, q_d, _, _ = merge_queue_with_flags(
        torch.full((rows, cap), EMPTY_ID, dtype=torch.int32), torch.full((rows, cap), float("inf")),
        torch.zeros(rows, cap, dtype=torch.int32), ids, d)
    flags = torch.randint(0, 2, (rows, cap), generator=gen, dtype=torch.int32)
    c_ids = torch.randint(0, 200_000, (rows, c), generator=gen, dtype=torch.int32)
    c_d = torch.rand(rows, c, generator=gen)
    pick = torch.randint(0, cap, (rows, c), generator=gen)
    kind = torch.randint(0, 10, (rows, c), generator=gen)
    again = kind < 3
    c_ids = torch.where(again, torch.gather(q_ids, 1, pick), c_ids)
    c_d = torch.where(again, torch.gather(q_d, 1, pick), c_d)
    c_d = torch.where(kind == 1, torch.nextafter(c_d, torch.tensor(-1.0)), c_d)
    c_ids = torch.where(kind == 9, EMPTY_ID, c_ids)
    c_d = torch.where(kind == 9, float("inf"), c_d)
    frontier, ok = merged_frontier(q_ids, flags, 4)
    return tuple(t.to(device) for t in (q_ids, q_d, flags, c_ids, c_d)) + (None,) + (
        frontier.to(device), ok.to(device))


def check_queue_merge_kernel(device) -> dict:
    """The hop's queue-merge kernel against ``plain_queue_update`` bit for
    bit, at the batch cell's block and an online call's 100 rows (ef 300,
    192 candidates), then its time beside the plain version's, the library
    chain it replaced (``merge_queue_with_flags`` and the frontier's
    ``torch.topk``) and its bound by bytes, each replayed from a CUDA graph
    as the hop is.  The kernel updates in place, so its timed calls merge
    the same candidates again into the queue they made: every candidate is
    then a duplicate, and the work is the same."""
    gen = torch.Generator().manual_seed(16)
    out = {}
    for rows in MERGE_ROWS:
        args = _hop_queues(rows, MERGE_CAP, HOP_CANDIDATES, gen, device)
        want = cuda_queues.plain_queue_update(*args)
        work = tuple(t.clone() if t is not None else None for t in args)
        got = cuda_queues.cuda_queue_update(*work)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            g, w = (g.view(torch.int32), w.view(torch.int32)) if g.is_floating_point() else (g, w)
            assert torch.equal(g, w), f"queue_merge disagrees with its plain version at {rows} rows"
        ids, dists, flags, c_ids, c_d = args[:5]
        cap = MERGE_CAP

        def library():
            m_ids, _, m_flags, _ = merge_queue_with_flags(ids, dists, flags, c_ids, c_d)
            rank = torch.where((m_flags == 0) & (m_ids != EMPTY_ID),
                               torch.arange(cap, device=device), cap)
            return torch.topk(-rank, 4, dim=-1)

        kernel = lambda: cuda_queues.cuda_queue_update(*work)
        plain = lambda: cuda_queues.plain_queue_update(*args)
        k1, l1, l2, k2 = (_graphed_ms(f) for f in (kernel, library, library, kernel))
        p_ms = _graphed_ms(plain)
        nbytes = rows * (cap * 12 * 2 + HOP_CANDIDATES * 8 + 4 * 9 + 1)
        bound = _bound(0.0, PEAK_FP32_FLOPS, nbytes)
        ms, lib_ms = min(k1, k2), min(l1, l2)
        threads = _native.load().queue_merge_threads(cap, HOP_CANDIDATES)
        print(f"queue_merge at [{rows} x ({cap} + {HOP_CANDIDATES})]: bit for bit with its plain "
              f"version; kernel {k1:.4f} / {k2:.4f} ms ({threads} threads a row); plain "
              f"{p_ms:.4f} ms; merge_queue_with_flags + torch.topk {l1:.4f} / {l2:.4f} ms "
              f"(the kernel {lib_ms / ms:.1f}x faster); bound {bound['bound_ms']:.4f} ms by "
              f"bytes, kernel at {bound['bound_ms'] / ms:.1%} of it")
        out[rows] = {"shape": f"{rows} x ({cap} + {HOP_CANDIDATES})", "ms": ms, "plain_ms": p_ms,
                     "library_ms": lib_ms, "library": "merge_queue_with_flags + torch.topk",
                     **bound}
    batch, online = (out[r] for r in MERGE_ROWS)
    return {**batch, "online": online}


def _hop_state(layer: Layer, table: torch.Tensor, queries: torch.Tensor, gen) -> LayerSearchState:
    """A layer search's state at ef ``MERGE_CAP``: queues of random nodes at
    their distances, half of the slots expanded, the frontier they give,
    probes that do not run out in the timed hops (no row finishes early)."""
    rows = queries.shape[0]
    seeds = torch.randint(0, layer.node_count, (rows, MERGE_CAP), generator=gen,
                          dtype=torch.int32).to(queries.device)
    d = cuda_gather.cuda_gather_distance(queries, table, seeds, Metric.NORMALIZED_COSINE)
    dev = seeds.device
    ids, dists = merge_queue_with_flags(
        torch.full((rows, MERGE_CAP), EMPTY_ID, dtype=torch.int32, device=dev),
        torch.full((rows, MERGE_CAP), float("inf"), device=dev),
        torch.zeros((rows, MERGE_CAP), dtype=torch.int32, device=dev), seeds, d)[:2]
    flags = torch.randint(0, 2, (rows, MERGE_CAP), generator=gen, dtype=torch.int32).to(ids.device)
    frontier, ok = merged_frontier(ids, flags, HOP_BEAM)
    return LayerSearchState(
        ids, dists, flags, torch.full((rows,), 1 << 20, dtype=torch.int32, device=dev),
        torch.zeros((rows,), dtype=torch.bool, device=dev), 0,
        torch.zeros((), dtype=torch.int64, device=dev),
        torch.zeros((rows,), dtype=torch.int32, device=dev), frontier, ok)


def _hop_body(layer, table, queries, fused: bool, all_done=None):
    """The eager hop over ``layer`` and ``table`` (a dense source): the two
    launches (with the graph's ``all_done`` flag, as a replay runs them), or
    the torch hop (``hop_graph.fuses`` refused while it is built)."""
    build = lambda: _layer_step_fns(layer, DenseSource(table), Metric.NORMALIZED_COSINE, queries,
                                    MERGE_CAP, HOP_BEAM, 1 << 20, all_done=all_done)[1]
    if fused:
        return build()
    rule = hop_graph.fuses
    hop_graph.fuses = lambda device_type, kind: False
    try:
        return build()
    finally:
        hop_graph.fuses = rule


def _plain_hop_body(layer, table, queries):
    """The hop by the plain versions of its two kernels,
    ``cuda_gather.plain_hop_expand`` and ``cuda_queues.plain_hop_update``,
    into new tensors."""
    def hop(state: LayerSearchState) -> LayerSearchState:
        ids, dists, expanded, probes, done, hops, evals, improve_hop, frontier, ok = state
        expanded, cand_ids, cand_dists, evals = cuda_gather.plain_hop_expand(
            queries, table, layer.nodes, layer.neighbors, ids, expanded, frontier, ok, done, evals,
            Metric.NORMALIZED_COSINE)
        ids, dists, expanded, frontier, ok, probes, done, improve_hop = cuda_queues.plain_hop_update(
            ids, dists, expanded, cand_ids, cand_dists, done, frontier, ok, probes, improve_hop,
            hops + 1)
        return LayerSearchState(ids, dists, expanded, probes, done, hops + 1, evals, improve_hop,
                                frontier, ok)
    return hop


def _clone_state(state: LayerSearchState) -> LayerSearchState:
    return LayerSearchState(*(v.clone() if isinstance(v, torch.Tensor) else v for v in state))


def _same_bits(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if want.is_floating_point():
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want), what


def _hop_kernels_against_plain(layer, table, queries, state: LayerSearchState, where: str):
    """One hop from ``state`` by ``cuda_hop_expand`` and ``cuda_hop_update``
    and by their plain versions on the same CUDA tensors: the expanded
    flags, candidate ids and ``evals`` bit for bit and the distances within
    ``GATHER_DISTANCE_ATOL``, then the update of the kernel's candidates bit
    for bit (queues, flags, frontier, probes, ``done``, improvement hops).
    Returns the distances' largest gap, the candidates and the distinct
    table rows they read."""
    metric = Metric.NORMALIZED_COSINE
    k, p = _clone_state(state), _clone_state(state)
    p_flags, p_ids, p_d, p_evals = cuda_gather.plain_hop_expand(
        queries, table, layer.nodes, layer.neighbors, p.ids, p.expanded, p.frontier,
        p.frontier_ok, p.done, p.evals, metric)
    k_flags, k_ids, k_d, k_evals = cuda_gather.cuda_hop_expand(
        queries, table, layer.nodes, layer.neighbors, k.ids, k.expanded, k.frontier,
        k.frontier_ok, k.done, k.evals, metric)
    for what, g, w in (("expanded", k_flags, p_flags), ("candidate ids", k_ids, p_ids),
                       ("evals", k_evals, p_evals)):
        _same_bits(g, w, f"hop_expand's {what} differ from its plain version's {where}")
    assert torch.equal(torch.isinf(k_d), torch.isinf(p_d)), f"hop_expand's empty slots differ {where}"
    live = torch.isfinite(p_d)
    err = float((k_d[live] - p_d[live]).abs().max())
    assert err <= GATHER_DISTANCE_ATOL, f"hop_expand's distances differ by {err} {where}"
    args = (k.ids, k.dists, k_flags, k_ids, k_d, k.done, k.frontier, k.frontier_ok, k.probes,
            k.improve_hop, state.hops + 1)
    want = cuda_queues.plain_hop_update(*args)
    got = cuda_queues.cuda_hop_update(*args)
    names = ("ids", "dists", "expanded", "frontier", "frontier_ok", "probes", "done", "improve_hop")
    for what, g, w in zip(names, got, want):
        _same_bits(g, w, f"cuda_hop_update's {what} differ from its plain version's {where}")
    valid = k_ids != EMPTY_ID
    distinct = torch.unique(layer.nodes[k_ids[valid].long()]).numel()
    return err, int(valid.sum()), distinct


def _replayed_hop_ms(body, state: LayerSearchState, reps: int = 7) -> float:
    """Median device time of one hop: ``HOP_TIMED_HOPS`` hops of ``body``
    captured in one CUDA graph over buffers that are set to ``state``
    before each replay, outside the timed events."""
    work = LayerSearchState(*(v.clone() if isinstance(v, torch.Tensor) else v for v in state))

    def restore():
        for buf, value in zip(work, state):
            if isinstance(value, torch.Tensor):
                buf.copy_(value)

    def hops():
        s = work
        for _ in range(HOP_TIMED_HOPS):
            s = body(s)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        restore()
        hops()  # warm on the capture's stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        hops()
    times = []
    for _ in range(reps):
        restore()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / HOP_TIMED_HOPS)
    return float(np.median(times))


def _device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) of one call of ``fn``
    under ``torch.profiler``."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def check_two_launch_hop(device) -> dict:
    """The hop in two launches at the graph cells' shape, hop after hop for
    ``HOP_TIMED_HOPS`` hops: its kernels against their plain versions
    (``plain_hop_expand`` + ``plain_hop_update``) on the same CUDA tensors,
    and the whole hop against the torch hop, bit for bit in every field.
    Then the device time and operations of a hop of each, replayed from a
    CUDA graph over a device hop counter as a search replays it, beside the
    hop's bounds: the distinct table rows of a hop read once, and every
    gathered row read."""
    gen = torch.Generator().manual_seed(18)
    table = torch.nn.functional.normalize(
        torch.randn(HOP_LAYER_ROWS, HOP_DIM, generator=gen), dim=-1).to(device)
    neighbors = torch.randint(0, HOP_LAYER_ROWS, (HOP_LAYER_ROWS, HOP_M), generator=gen,
                              dtype=torch.int32)
    neighbors[torch.rand(HOP_LAYER_ROWS, HOP_M, generator=gen) < 0.1] = EMPTY_ID
    layer = Layer(torch.arange(HOP_LAYER_ROWS, dtype=torch.int32, device=device),
                  neighbors.to(device))
    c = HOP_BEAM * HOP_M
    out = {}
    for rows in MERGE_ROWS:
        queries = torch.nn.functional.normalize(torch.randn(rows, HOP_DIM, generator=gen),
                                                dim=-1).to(device)
        state = _hop_state(layer, table, queries, gen)
        flag = torch.zeros((), dtype=torch.bool, device=device)
        fused, torch_hop = _hop_body(layer, table, queries, True, flag), \
            _hop_body(layer, table, queries, False)
        plain = _plain_hop_body(layer, table, queries)
        got = want = state
        max_err, gathered, distinct = 0.0, [], []
        for hop in range(1, HOP_TIMED_HOPS + 1):
            where = f"at {rows} rows, hop {hop}"
            err, n_valid, n_distinct = _hop_kernels_against_plain(layer, table, queries, got, where)
            max_err = max(max_err, err)
            gathered.append(n_valid)
            distinct.append(n_distinct)
            got = fused(_clone_state(got))
            want = torch_hop(_clone_state(want))
            for field, g, w in zip(want._fields, got, want):
                if isinstance(w, torch.Tensor):
                    _same_bits(g, w, f"the two-launch hop's {field} differs from the torch hop's {where}")
                else:
                    assert g == w
        # as a search replays it: the hop number in a device counter
        counted = state._replace(hops=torch.zeros((), dtype=torch.int32, device=device))
        ops = {name: _device_ops(lambda body=body, s=_clone_state(counted): body(s))
               for name, body in (("fused", fused), ("torch", torch_hop), ("plain", plain))}
        f1, p1, p2, f2 = (_replayed_hop_ms(b, counted) for b in (fused, torch_hop, torch_hop, fused))
        plain_ms = _replayed_hop_ms(plain, counted)
        # a row's queue read and written, its neighbor ids and vector ids, its
        # query, frontier read and written, probes, done and improvement hop;
        # beside them the table's rows, each distinct row of a hop read once
        # (the mean over the checked hops) or every gathered row read
        io = rows * (MERGE_CAP * 12 * 2 + c * (4 + 4) + HOP_DIM * 4 + HOP_BEAM * 9 * 2 + 9)
        flops = 2.0 * rows * c * HOP_DIM
        rows_once = float(np.mean(distinct))
        bound = _bound(flops, PEAK_FP32_FLOPS, io + rows_once * HOP_DIM * 4)
        every_row = _bound(flops, PEAK_FP32_FLOPS, io + rows * c * HOP_DIM * 4)
        ms, torch_ms = min(f1, f2), min(p1, p2)
        print(f"two-launch hop at [{rows} x ({MERGE_CAP} + {c})] over [{HOP_LAYER_ROWS} x {HOP_DIM}] "
              f"f32, M {HOP_M}: over {HOP_TIMED_HOPS} hops its kernels match plain_hop_expand + "
              f"plain_hop_update (distances within {max_err:.3e}, the rest bit for bit) and the "
              f"hop matches the torch hop bit for bit; a hop {f1:.4f} / {f2:.4f} ms in "
              f"{ops['fused']} device operations; the torch hop {p1:.4f} / {p2:.4f} ms in "
              f"{ops['torch']} (the two launches {torch_ms / ms:.2f}x faster); the plain pair "
              f"{plain_ms:.4f} ms in {ops['plain']}; a hop gathers {np.mean(gathered):.0f} rows "
              f"({rows_once:.0f} distinct); bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
              f"with the distinct rows read once, {every_row['bound_ms']:.4f} ms by "
              f"{every_row['bound_by']} with every gathered row read; the hop at "
              f"{bound['bound_ms'] / ms:.1%} / {every_row['bound_ms'] / ms:.1%} of them")
        out[rows] = {"shape": f"{rows} x ({MERGE_CAP} + {c}) over [{HOP_LAYER_ROWS} x {HOP_DIM}]",
                     "ms": ms, "device_ops": ops["fused"], "torch_hop_ms": torch_ms,
                     "torch_hop_device_ops": ops["torch"], "plain_ms": plain_ms,
                     "plain_device_ops": ops["plain"], "max_abs_err": max_err,
                     "rows_gathered": float(np.mean(gathered)), "rows_read_once": rows_once,
                     **bound, "every_row_bound_ms": every_row["bound_ms"]}
    batch, online = (out[r] for r in MERGE_ROWS)
    return {**batch, "online": online}


def _timed_s(fn, reps: int = 3):
    """``(result, median seconds)`` of ``fn`` over ``reps`` runs after a warm-up."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        ts = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
    return out, float(np.median(times))


def _zero_launches() -> None:
    for counts in (cuda_distance.LAUNCHES, cuda_scan.LAUNCHES, cuda_gather.LAUNCHES,
                   cuda_queues.LAUNCHES):
        for key in counts:
            counts[key] = 0


def corpus_through_fvecs(drawn: np.ndarray) -> np.ndarray:
    """Phase 5's corpus through the reference's file format: ``drawn`` goes
    to an ``.fvecs`` file (404 bytes a row at D = 100) in a temporary
    directory and comes back through ``read_vecs`` (the native reader, 8
    threads), which must give it byte for byte, as must the numpy reader
    and ``vector_chunks``.  Returns the rows read."""
    n, d = drawn.shape
    tmp = tempfile.mkdtemp(prefix="hnsw_smoke_fvecs_")
    path = os.path.join(tmp, "corpus.fvecs")
    try:
        rows = np.empty((n, d + 1), np.int32)
        rows[:, 0] = d
        rows[:, 1:] = drawn.view(np.int32)
        tw = time.perf_counter()
        rows.tofile(path)
        write_s = time.perf_counter() - tw
        del rows
        size = os.path.getsize(path)
        assert size == n * (4 + 4 * d)
        tb = time.perf_counter()
        load_vecio()
        build_s = time.perf_counter() - tb
        tr = time.perf_counter()
        read = read_vecs(path, n_threads=8)
        read_s = time.perf_counter() - tr
        plain = _read_vecs_numpy(path, ".fvecs", 4, 0, -1)
        chunks = list(vector_chunks(path, 65536))
    finally:
        shutil.rmtree(tmp)
    bits = drawn.view(np.int32)
    assert read.dtype == np.float32 and read.shape == drawn.shape
    assert np.array_equal(read.view(np.int32), bits), "read_vecs changed the corpus"
    assert np.array_equal(plain.view(np.int32), bits), "the numpy reader changed the corpus"
    assert [len(c) for c in chunks] == [min(65536, n - s) for s in range(0, n, 65536)]
    assert np.array_equal(np.concatenate(chunks).view(np.int32), bits), "vector_chunks changed the corpus"
    print(f"fvecs: {n} x {d} rows, {size / 1e6:.2f} MB written in {write_s:.3f} s; vecio built "
          f"(g++) or loaded in {build_s:.3f} s; read_vecs on 8 threads {read_s:.4f} s = "
          f"{size / read_s / 1e9:.3f} GB/s from the page cache; byte-equal to the drawn rows, "
          f"to the numpy reader and to {len(chunks)} vector_chunks of 65,536")
    return read


class ScaledSource(NamedTuple):
    """A storage type of the user's (the JAX package's API test's): rows
    scaled on the way out.  It registers ``source_get`` and nothing else."""

    vectors: torch.Tensor
    scale: float

    @property
    def dim(self):
        return self.vectors.shape[1]

    @property
    def count(self):
        return self.vectors.shape[0]

    @property
    def device(self):
        return self.vectors.device


@source_get.register
def _(source: ScaledSource, ids):
    safe = torch.clamp(ids, 0, source.vectors.shape[0] - 1)
    return source.vectors[safe.long()] * source.scale


def flat_scan_phase(vecs: torch.Tensor) -> dict:
    """The flat-scan path at full width; returns each kernel's launch count
    in ONE pass of the path: one ``search_exact(fast=True)`` call per size
    for the scans, one ``search_exact`` call per size for the pairwise
    kernel, the counts set to 0 just before each call and read just after."""
    metric, k, oversample = Metric.NORMALIZED_COSINE, 10, 4
    queries = vecs[FLAT_SIZES[1][0] :]
    assert queries.shape == (QUERIES, FLAT_DIM)
    query_blocks = -(-QUERIES // SCAN_QUERY_BLOCK)
    launches = {"binned": 0, "folded": 0, "pairwise_distance": 0, "bf16_operand": 0}
    indexes = []
    for rows, want_mode in FLAT_SIZES:
        index = Hnsw([], DenseSource(vecs[:rows]), metric)
        indexes.append(index)
        mode = select_scan_mode(rows)
        assert mode == want_mode, f"auto mode at {rows} rows is {mode}, not {want_mode}"
        other = "folded" if want_mode == "binned" else "binned"
        _zero_launches()
        index.search_exact(queries, k=k)
        assert not any(cuda_scan.LAUNCHES.values()), "the exact scan must not run the scan kernels"
        assert cuda_distance.LAUNCHES["fast"] == cuda_distance.LAUNCHES["operand"] == 0
        launches["pairwise_distance"] += cuda_distance.LAUNCHES["exact"]
        _zero_launches()
        index.search_exact(queries, k=k, fast=True, oversample=oversample)
        ran = dict(cuda_scan.LAUNCHES)
        assert ran == {want_mode: query_blocks, other: 0}, (
            f"auto mode at {rows} rows launched {ran}, not {query_blocks} {want_mode} scans")
        assert cuda_distance.LAUNCHES["exact"] == cuda_distance.LAUNCHES["fast"] == 0, (
            "the fast scan ran the pairwise kernel")
        # the corpus once and each query block once
        assert cuda_distance.LAUNCHES["operand"] == 1 + query_blocks
        launches["bf16_operand"] += cuda_distance.LAUNCHES["operand"]
        launches[want_mode] += ran[want_mode]
        (gt_ids, gt_d), exact_s = _timed_s(lambda: index.search_exact(queries, k=k))
        (ids, dists), fast_s = _timed_s(
            lambda: index.search_exact(queries, k=k, fast=True, oversample=oversample))
        assert ids.shape == (QUERIES, k) and ids.dtype == torch.int32
        assert bool(torch.isfinite(dists).all()), "non-finite flat-scan distances"
        assert bool((dists[:, 1:] >= dists[:, :-1]).all()), "flat-scan distances not ascending"
        assert int(ids.min()) >= 0 and int(ids.max()) < rows
        recall = _recall_at_10(ids, gt_ids)
        # a survivor's reranked distance is the exact scan's distance to that row
        hit = ids == gt_ids
        drift = float((dists - gt_d)[hit].abs().max())
        print(f"flat scan {rows} x {FLAT_DIM}, auto mode {mode}: recall@10 {recall:.5f}, fast "
              f"{QUERIES / fast_s:.1f} QPS ({fast_s:.4f} s), exact {QUERIES / exact_s:.1f} QPS "
              f"({exact_s:.4f} s), launches of one call {ran}, distance drift on shared ids "
              f"{drift:.2e}")
        assert recall >= FLAT_RECALL_FLOOR, f"flat-scan recall@10 {recall} below {FLAT_RECALL_FLOOR}"
        assert drift <= 1e-5, f"reranked distances differ from the exact scan's: {drift}"
    print(f"launches in one pass of the flat-scan path: {launches}")

    # the modes that auto did not pick, forced, for the record of the cut-offs
    for index, (rows, auto_mode) in zip(indexes, FLAT_SIZES):
        gt_ids = index.search_exact(queries, k=k)[0]
        for mode in ("exhaustive", "binned", "folded"):
            (ids, _), secs = _timed_s(lambda: fast_flat_knn(
                index.source, queries, metric, k, oversample, scan_mode=mode))
            print(f"flat scan {rows} x {FLAT_DIM} forced {mode}{' (auto)' if mode == auto_mode else ''}: "
                  f"{QUERIES / secs:.1f} QPS ({secs:.4f} s), recall@10 {_recall_at_10(ids, gt_ids):.5f}")
    return launches


def traversal_phase(hnsw: Hnsw, queries: torch.Tensor, gt_ids: torch.Tensor,
                    ids: torch.Tensor, dists: torch.Tensor) -> float:
    """The traversals that share the hop with ``search``, on the main index:
    instrumented, adaptive, f32 slabs, cast-only and projected routing, with
    the plain search timed again before and after them (a shared host's load
    moves every QPS here; compare within this phase).  Returns the plain
    search's QPS, the better of the two."""
    plain_recall = _recall_at_10(ids, gt_ids)
    plain_qps = QUERIES / _timed_s(lambda: hnsw.search(queries))[1]
    print(f"plain search, before the other traversals: {plain_qps:.1f} QPS")

    def timed(label, search=hnsw.search):
        (r_ids, r_d), secs = _timed_s(lambda: search(queries))
        recall = _recall_at_10(r_ids, gt_ids)
        print(f"{label}: recall@10 {recall:.5f}, {QUERIES / secs:.1f} QPS ({secs:.4f} s; "
              f"plain search {plain_qps:.1f} QPS, recall@10 {plain_recall:.5f})")
        return r_ids, r_d, recall

    # instrumented: all queries as one block, so held against a one-block search
    one_ids, one_d = hnsw.search(queries, query_block=QUERIES)
    i_ids, i_d, stats = hnsw.search_instrumented(queries)
    torch.cuda.synchronize()
    assert torch.equal(i_ids, one_ids) and torch.equal(i_d, one_d), (
        "search_instrumented answers differently from search")
    improve = stats["last_improvement_hop"].float()
    print(f"search_instrumented: ids and distances equal to search's (one block of {QUERIES}); "
          f"equal to the default blocks' too: {bool(torch.equal(i_ids, ids) and torch.equal(i_d, dists))}; "
          f"hops {stats['hops']}, distance evaluations {stats['distance_evaluations']}, "
          f"last-improvement hop mean {float(improve.mean()):.2f} max {int(improve.max())}")
    assert stats["hops"] > 0 and stats["distance_evaluations"] > 0

    # adaptive: the same traversal on a shrinking batch.  The hop's distances
    # are summed in an order set by D alone (the gather-and-distance kernel),
    # so the batch a query sits in changes nothing: ids and distances identical
    a_ids, a_d, a_recall = timed("search(adaptive=True)", lambda q: graph_search(
        hnsw.layers, hnsw.compute_source, hnsw.metric, q,
        hnsw.build_parameters.optimization.search, adaptive=True))
    same_top10 = float((a_ids[:, :10] == ids[:, :10]).all(-1).float().mean())
    print(f"search(adaptive=True): top-10 ids identical to the lockstep search's for "
          f"{same_top10:.5f} of the queries, all {ids.shape[1]} ids for "
          f"{float((a_ids == ids).all(-1).float().mean()):.5f}, distances identical: "
          f"{bool(torch.equal(a_d, dists))}")
    assert torch.equal(a_ids, ids) and torch.equal(a_d, dists), (
        f"adaptive search differs from the lockstep search on {1 - same_top10:.4f} of the queries")
    assert abs(a_recall - plain_recall) <= 0.002, "adaptive search moved recall@10"

    hnsw.enable_hop_slabs()
    slab_bytes = sum(t.numel() * t.element_size() for t in hnsw._hop_slabs.slabs)
    print(f"f32 hop slabs: {slab_bytes} bytes in {len(hnsw._hop_slabs.slabs)} layers "
          f"(bottom {tuple(hnsw._hop_slabs.slabs[-1].shape)})")
    s_ids, s_d, _ = timed("slab search (f32)")
    assert torch.equal(s_ids, ids) and torch.equal(s_d, dists), (
        "f32 slab search is not identical to the plain hop")
    hnsw.disable_hop_slabs()

    hnsw.enable_routing(dr=None)
    for slabs in (False, True):
        if slabs:
            hnsw.enable_hop_slabs()
            assert hnsw._hop_slabs.routed and hnsw._hop_slabs.slabs[-1].dtype == torch.bfloat16
        r_ids, r_d, recall = timed(f"routed search (bf16 cast{', bf16 slabs' if slabs else ''})")
        assert recall >= plain_recall - ROUTED_RECALL_SLACK, (
            f"cast-only routed recall@10 {recall} more than {ROUTED_RECALL_SLACK} under {plain_recall}")
        assert bool(torch.isfinite(r_d[:, :10]).all()), "non-finite reranked distances"
        assert bool((r_d[:, 1:] >= r_d[:, :-1]).all()), "reranked distances not ascending"
    hnsw.disable_hop_slabs()
    f_ids, f_d = hnsw.search(queries, routed=False)
    assert torch.equal(f_ids, ids) and torch.equal(f_d, dists), "routed=False is not the plain search"

    hnsw.enable_routing(dr=64)
    assert hnsw._routing.rows.shape == (hnsw.source.count, 64)
    timed("routed search (dr=64 projection)")
    self_ids, _ = hnsw.search(hnsw.source.vectors[:1000])
    found = float((self_ids[:, 0] == torch.arange(1000, device=self_ids.device)).float().mean())
    print(f"routed search (dr=64): {found:.4f} of 1000 corpus rows find themselves first")
    assert found >= 0.999, f"self-queries lost under dr=64 routing: {found}"
    hnsw.disable_routing()
    after_qps = QUERIES / _timed_s(lambda: hnsw.search(queries))[1]
    print(f"plain search, after the other traversals: {after_qps:.1f} QPS")
    return max(plain_qps, after_qps)


def _device_profile(label: str, fn, wall_ms=None) -> None:
    """One call of ``fn`` under ``torch.profiler``: the device time by kernel
    and its share of the call's wall time WITHOUT the profiler where the
    caller knows it (the profiler slows a host loop, not the kernels), else
    of the profiled wall time.  A record, not a check: nothing is asserted."""
    torch.cuda.synchronize()
    # device activity only: host-side operator events would triple the trace
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - ts) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        print(f"{label}: the profiler recorded no device time (not measured)")
        return
    busy_ms = sum(ms for _, ms, _ in rows)
    against = (f"{busy_ms / wall_ms:.1%} of the {wall_ms:.1f} ms it takes unprofiled "
               f"({profiled_ms:.1f} ms profiled)" if wall_ms else
               f"{busy_ms / profiled_ms:.1%} of the {profiled_ms:.1f} ms it took under the profiler")
    print(f"{label} under torch.profiler: device busy {busy_ms:.1f} ms in "
          f"{sum(n for _, _, n in rows)} kernels, {against}; by kernel:")
    rows.sort(key=lambda r: -r[1])
    # the twelve largest, and the port's own kernels wherever they stand
    own = ("pairwise_kernel", "operand_kernel", "scan_kernel", "row_sq_norms", "row_gather_kernel",
           "gather_distance_kernel", "queue_merge_kernel")
    for key, ms, count in rows[:12] + [r for r in rows[12:] if any(name in r[0] for name in own)]:
        print(f"  {ms:9.2f} ms {count:7d} x  {key[:100]}")
    for name in ("gather_distance_kernel", "row_gather_kernel"):
        mine = [(ms, n) for key, ms, n in rows if name in key]
        print(f"{label}: {name} {sum(ms for ms, _ in mine):.2f} ms of device time in "
              f"{sum(n for _, n in mine)} launches")


def profile_phase(hnsw: Hnsw, queries: torch.Tensor, plain_qps: float) -> None:
    """Device profiles of one plain search pass and of one fast-tier relink of
    the bottom layer (the brute-force tier that launches the pairwise kernel's
    fast mode; idempotent on a finished index, its result is dropped)."""
    _device_profile(f"search profile, one pass of {queries.shape[0]} queries",
                    lambda: hnsw.search(queries), queries.shape[0] / plain_qps * 1e3)
    bottom = len(hnsw.layers) - 1
    tiers = []

    def relink():
        tiers.append(link_layer_to_better_neighbors(
            hnsw.layers, bottom, hnsw.source, hnsw.metric,
            hnsw.build_parameters.optimization.search)[1:])

    before = dict(cuda_distance.LAUNCHES)
    _device_profile(f"relink profile, bottom layer of {hnsw.layers[bottom].node_count} nodes", relink)
    ran = {k: cuda_distance.LAUNCHES[k] - before[k] for k in before}
    print(f"relink profile: tier {tiers[0][1]}, {tiers[0][0]} rows changed, pairwise launches {ran}")


def small_index_phase(vecs: torch.Tensor) -> None:
    """On a 10,000 x 100 index: a mutation drops the slabs, ``knn(10)``, and a
    build that resumes from its own finished checkpoint."""
    source = DenseSource(vecs[:SMALL_COUNT].contiguous())
    tmp = tempfile.mkdtemp(prefix="hnsw_smoke_ckpt_")
    try:
        tb = time.perf_counter()
        small = Hnsw.generate(source, metric=Metric.NORMALIZED_COSINE, seed=0, checkpoint_dir=tmp)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - tb
        assert os.path.exists(os.path.join(tmp, "meta"))
        tb = time.perf_counter()
        again = Hnsw.generate(source, metric=Metric.NORMALIZED_COSINE, seed=0, checkpoint_dir=tmp)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - tb
    finally:
        shutil.rmtree(tmp)
    assert [l.node_count for l in again.layers] == [l.node_count for l in small.layers]
    for a, b in zip(small.layers, again.layers):
        assert torch.equal(a.nodes, b.nodes), "the resumed build has other layers"
    print(f"checkpoint resume at {SMALL_COUNT} x {DIM}: built in {first_s:.3f} s, resumed from "
          f"the finished checkpoint in {resume_s:.3f} s, layers {[l.node_count for l in again.layers]}")

    small.enable_hop_slabs()
    assert small._hop_slabs is not None
    small.improve_neighbors()
    assert small._hop_slabs is None, "a mutation left the hop slabs in place"

    tk = time.perf_counter()
    vec_ids, nn_ids, nn_d = small.knn(10)
    knn_s = time.perf_counter() - tk
    assert nn_ids.shape == (SMALL_COUNT, 10) and nn_d.shape == (SMALL_COUNT, 10)
    assert not (nn_ids == vec_ids[:, None]).any(), "knn returned a row's own vector"
    assert np.isfinite(nn_d).all() and (np.diff(nn_d, axis=1) >= 0).all(), "knn distances not ascending"
    gt = small.search_exact(source.vectors, k=11)[0][:, 1:].cpu().numpy()
    hits = (nn_ids[:, :, None] == gt[:, None, :]).any(-1).mean()
    print(f"knn(10) over {SMALL_COUNT} rows: {knn_s:.3f} s, recall@10 against the exact scan {hits:.5f}; "
          f"improve_neighbors dropped the slabs")

    custom = ScaledSource(vectors=source.vectors, scale=1.0)
    tb = time.perf_counter()
    scaled = Hnsw.generate(custom, metric=Metric.NORMALIZED_COSINE, seed=3)
    torch.cuda.synchronize()
    custom_s = time.perf_counter() - tb
    assert scaled.layers[-1].neighbors.is_cuda
    c_ids, c_d = scaled.search(source.vectors)
    first = float((c_ids[:, 0] == torch.arange(SMALL_COUNT, device=c_ids.device)).float().mean())
    print(f"custom source (ScaledSource, source_get alone) at {SMALL_COUNT} x {DIM}: built in "
          f"{custom_s:.3f} s, layers {[l.node_count for l in scaled.layers]}; each row found first: "
          f"{first:.5f}")
    assert bool(torch.isfinite(c_d[:, :10]).all())
    assert first == 1.0, f"the custom source's index found {first} of its rows first"


def persistence_phase(hnsw: Hnsw, queries: torch.Tensor, device) -> None:
    """Serialize, read back onto the card, and search with both."""
    tmp = tempfile.mkdtemp(prefix="hnsw_smoke_")
    try:
        ts = time.perf_counter()
        serialize_hnsw(hnsw, tmp)
        tw = time.perf_counter()
        loaded = deserialize_hnsw(tmp)
        torch.cuda.synchronize()
        tr = time.perf_counter()
    finally:
        shutil.rmtree(tmp)
    assert loaded.source.device.type == "cuda" and loaded.layers[0].nodes.device.type == "cuda"
    assert loaded.metric == hnsw.metric and loaded.build_parameters == hnsw.build_parameters
    assert torch.equal(loaded.source.vectors, hnsw.source.vectors)
    for a, b in zip(hnsw.layers, loaded.layers):
        assert torch.equal(a.nodes, b.nodes) and torch.equal(a.neighbors, b.neighbors)
    (i1, d1), (i2, d2) = hnsw.search(queries), loaded.search(queries)
    assert torch.equal(i1, i2) and torch.equal(d1, d2), "the loaded index answers differently"
    print(f"persistence: wrote in {tw - ts:.3f} s, read in {tr - tw:.3f} s; "
          f"{queries.shape[0]} queries identical in ids and distances")


# -- phase 10: product quantization -------------------------------------------

# 10a, the reference's PQ gate (src/pq.rs:956-978; scripts/pq_gate.py is the
# JAX run of it): unit vectors, euclidean, 65,535 shared centroids of 16 values
# (96 subspaces, uint16 codes), the binned quantize route
PQ_GATE_COUNT, PQ_GATE_DIM, PQ_GATE_SEED = 100_000, 1536, 3
PQ_GATE_CENTROIDS, PQ_GATE_DSUB = 65_535, 16
PQ_AGREE_SUBS = 65_536
PQ_RECALL_ROWS = 10_000
PQ_GRAPH_QUANTIZER_ROWS = 1_000
# floors: the reference's gate is 1.0 for the flat scan (the JAX package
# reached 1.0000, and 0.9955-0.9966 for the code graph, on a TPU); binned
# codes against the exact argmin
PQ_AGREE_FLOOR = 0.999
PQ_FLAT_RECALL_FLOOR = 0.999
PQ_GRAPH_RECALL_FLOOR = 0.99
# 10b, config4's shapes (BENCH_NOTES.md:445-487, scripts/c4_capacity.py):
# a clustered 96-d corpus, normalized cosine, per-subspace k-means codebooks
# of 4096 x 4 values; 200,000 rows (10M in config4: the depth is cut, the
# widths are kept; 200k is where search_exact takes the binned route)
PQ_C4_COUNT, PQ_C4_DIM, PQ_C4_CENTERS, PQ_C4_NOISE = 200_000, 96, 1024, 0.35
PQ_C4_CENTROIDS, PQ_C4_DSUB, PQ_C4_QUERIES, PQ_C4_OVERSAMPLE = 4096, 4, 2048, 32
PQ_C4_RECALL_FLOOR = 0.95  # BASELINE's floor
PQ_ADC_QUERIES, PQ_ADC_ATOL = 256, 1e-4
PQ_NON_DENSE_ROWS, PQ_NON_DENSE_QUERIES = 10_000, 2_000
# the quantize block of quantize_binned, QuantizedHnsw.new's chunk_size and
# the scans' tile
PQ_QUANTIZE_BLOCK = 1 << 18
PQ_CHUNK = 100_000
PQ_TILE_C = 4096
# The exact pairwise kernel at D = 1536 on unit rows: partial sums within
# [0, 4], two fp32 summation orders ~sqrt(1536) ulps of 4 apart (the bound
# of gather_distance at this width)
PQ_WIDE_ATOL = 4e-5


def clustered_corpus(count: int, dim: int, seed: int, device) -> torch.Tensor:
    """config4's recipe (scripts/c4_capacity.py:53-67) drawn with numpy: 1024
    unit centers, each row a center plus 0.35 N(0, 1) noise, normalized."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((PQ_C4_CENTERS, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = rng.integers(0, PQ_C4_CENTERS, count)
    pts = centers[which] + PQ_C4_NOISE * rng.standard_normal((count, dim)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    return torch.from_numpy(pts).to(device)


def _launch_counts() -> dict:
    return {"pairwise_distance": cuda_distance.LAUNCHES["exact"] + cuda_distance.LAUNCHES["fast"],
            "bf16_operand": cuda_distance.LAUNCHES["operand"],
            "binned_scan": cuda_scan.LAUNCHES["binned"], "folded_scan": cuda_scan.LAUNCHES["folded"],
            "row_gather": cuda_gather.LAUNCHES["row_gather"],
            "gather_distance": cuda_gather.LAUNCHES["gather_distance"]}


def _counted(fn):
    """``(fn(), launches of each kernel in that call)``: the counts set to 0
    just before the call and read just after."""
    _zero_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, _launch_counts()


def _pq_binned_case(label: str, xs: torch.Tensor, ys: torch.Tensor, metric: Metric,
                    value_metric: Metric) -> dict:
    """The fast binned scan at one launch shape of the PQ path: the first
    512 rows and the last 512 rows of the whole launch against the plain
    version by value in ``value_metric``, the last rows' columns in
    ``metric``; then the time beside the plain version's and the bound."""
    scan = lambda a, m=metric: cuda_scan.cuda_binned_scan(a, ys, m, tile_c=PQ_TILE_C, exact=False)
    plain = lambda a, m=metric: cuda_scan.plain_binned_scan(a, ys, m, tile_c=PQ_TILE_C, exact=False)
    head, tail, vm = xs[:SCAN_CHECK_ROWS], xs[-SCAN_CHECK_ROWS:], value_metric
    err = _check_by_value("binned_scan", scan(head, vm), plain(head, vm), head, ys, vm,
                          f"{vm.value} {label}")
    full = scan(xs, vm)
    err = max(err, _check_by_value(
        "binned_scan", (full[0][-SCAN_CHECK_ROWS:], full[1][-SCAN_CHECK_ROWS:]),
        plain(tail, vm), tail, ys, vm, f"{vm.value} {label}, last rows of the launch"))
    del full
    same = float((scan(tail)[1] == plain(tail)[1]).float().mean())
    print(f"binned_scan {label} {metric.value}: columns identical to the plain version's for "
          f"{same:.6f} of the last rows' bins")
    assert same >= 0.999, f"binned_scan {label} {metric.value} columns differ: {same}"
    q, (c, d) = xs.shape[0], ys.shape
    dpad = d + -d % 8
    bins = -(-c // PQ_TILE_C) * 128
    k1 = _median_ms(lambda: scan(xs), reps=5)
    p1 = _median_ms(lambda: plain(xs), reps=3)
    k2 = _median_ms(lambda: scan(xs), reps=5)
    bound = _bound(2.0 * q * c * dpad, PEAK_BF16_FLOPS, 2.0 * (q + c) * dpad + 8.0 * q * bins)
    ms = min(k1, k2)
    print(f"binned_scan at {label} [{q} x {c} x {d}] (rows padded to {dpad}), {metric.value}: "
          f"kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} ms, bound {bound['bound_ms']:.3f} ms by "
          f"{bound['bound_by']} ({bound['bound_ms'] / ms:.1%}); max_abs_err {err:.3e}")
    return {"shape": f"{q} x {c} x {d}", "ms": ms, "plain_ms": p1, "max_abs_err": err, **bound}


def pq_kernel_checks(device, gate_vecs: torch.Tensor, c4_vecs: torch.Tensor) -> dict:
    """Each kernel of the PQ path at the shapes the path gives it, against
    its plain version, then its time beside the plain version's, a library
    call's where there is one, and the bound."""
    out = {}
    gen = torch.Generator(device=device).manual_seed(11)
    # centroids as the path makes them: sub-vectors of the corpus
    gate_subs = gate_vecs.reshape(-1, PQ_GATE_DSUB)
    cents = gate_subs[torch.randperm(gate_subs.shape[0], generator=gen, device=device)[
        :PQ_GATE_CENTROIDS]].contiguous()
    c4_subs = c4_vecs[:PQ_CHUNK, :PQ_C4_DSUB].contiguous()
    c4_book = c4_subs[torch.randperm(c4_subs.shape[0], generator=gen, device=device)[
        :PQ_C4_CENTROIDS]].contiguous()

    # binned scan: the quantize block (fast mode) at D = 16 over 65,535
    # centroids (a partial last tile) and at D = 4 (padded to 8) over 4096, at
    # 10b's chunk of 100,000 rows.  Bins are held by value in squared
    # euclidean, whose surrogate and epilogue the euclidean scan shares up to
    # a final square root: near 0 (a sub-vector that is itself a centroid)
    # that root turns one ulp of a squared distance into ~3e-5; the euclidean
    # scan's columns are held too
    sq = Metric.SQUARED_EUCLIDEAN
    binned = {
        "gate": _pq_binned_case("PQ quantize (gate)", gate_subs[:PQ_QUANTIZE_BLOCK].to(torch.bfloat16),
                                cents.to(torch.bfloat16), Metric.EUCLIDEAN, sq),
        "c4": _pq_binned_case("PQ quantize (c4)", c4_subs.to(torch.bfloat16),
                              c4_book.to(torch.bfloat16), sq, sq),
    }
    out["binned_scan"] = binned

    # pairwise distance: the exact quantize route's block at D = 16 ([2048 x
    # 65,535], blocked_topk_pairwise's row block at this width), and the
    # fast mode at D = 1536 (search_exact below 200k codes: a 4096-query block
    # against a 65,536-code block)
    # (held by value in squared euclidean, as the scan above: some of these
    # sub-vectors are centroids, and the root near 0 would amplify an ulp)
    x = gate_subs[:2048].contiguous()
    want = pairwise_distance(x, cents, Metric.SQUARED_EUCLIDEAN)
    got = cuda_distance.cuda_pairwise_distance(x, cents, Metric.SQUARED_EUCLIDEAN)
    exact_err = float((got - want).abs().max())
    assert exact_err <= BLOCK_ATOL, f"pairwise exact at D = 16 disagrees: {exact_err}"
    kx = lambda: cuda_distance.cuda_pairwise_distance(x, cents, Metric.EUCLIDEAN)
    k1, p1 = _median_ms(kx), _median_ms(lambda: pairwise_distance(x, cents, Metric.EUCLIDEAN))
    k2, lib = _median_ms(kx), _median_ms(lambda: torch.cdist(x, cents))
    q, c, d = 2048, cents.shape[0], PQ_GATE_DSUB
    exact_bound = _bound(2.0 * q * c * d, PEAK_FP32_FLOPS, 4.0 * (q * d + c * d + q * c))
    print(f"pairwise_distance exact at the exact quantize block [{q} x {c} x {d}] euclidean: "
          f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} ms, torch.cdist {lib:.4f} ms, bound "
          f"{exact_bound['bound_ms']:.4f} ms by {exact_bound['bound_by']}; max_abs_err {exact_err:.3e}")
    pair = {"exact_shape": f"{q} x {c} x {d}", "exact_ms": min(k1, k2), "exact_plain_ms": p1,
            "exact_library_ms": lib, "exact_library": "torch.cdist",
            "exact_bound_ms": exact_bound["bound_ms"], "exact_bound_by": exact_bound["bound_by"],
            "exact_max_abs_err": exact_err}
    # exact mode at D = 1536: the code graph (100,000 nodes, within the exact
    # seed and relink tiers) runs it on the dense copy; this is the relink's
    # first block [2048 x 65,536], whose diagonal holds the rows themselves,
    # so values are held in squared euclidean as above
    x, y = gate_vecs[:2048].contiguous(), gate_vecs[:65_536].contiguous()
    want = pairwise_distance(x, y, Metric.SQUARED_EUCLIDEAN)
    got = cuda_distance.cuda_pairwise_distance(x, y, Metric.SQUARED_EUCLIDEAN)
    wide_err = float((got - want).abs().max())
    del got, want
    assert wide_err <= PQ_WIDE_ATOL, f"pairwise exact at D = 1536 disagrees: {wide_err}"
    # torch.addmm with a broadcast 0.5 is normalized cosine in one cuBLAS call
    # (as in phase 2), torch.cdist the euclidean distance
    half = torch.full((), 0.5, device=device)
    addmm = lambda: torch.addmm(half, x, y.T, beta=1.0, alpha=-0.5)
    addmm_err = float((addmm() - pairwise_distance(x, y, Metric.NORMALIZED_COSINE)).abs().max())
    assert addmm_err <= PQ_WIDE_ATOL, f"torch.addmm is not the same function: {addmm_err}"
    kw = lambda m: (lambda: cuda_distance.cuda_pairwise_distance(x, y, m))
    k1 = _median_ms(kw(Metric.EUCLIDEAN), reps=5)
    p1 = _median_ms(lambda: pairwise_distance(x, y, Metric.EUCLIDEAN), reps=5)
    k2 = _median_ms(kw(Metric.EUCLIDEAN), reps=5)
    cdist = _median_ms(lambda: torch.cdist(x, y), reps=5)
    kc = _median_ms(kw(Metric.NORMALIZED_COSINE), reps=5)
    lib = _median_ms(addmm, reps=5)
    q, c, d = 2048, 65_536, PQ_GATE_DIM
    wide_bound = _bound(2.0 * q * c * d, PEAK_FP32_FLOPS, 4.0 * (q * d + c * d + q * c))
    print(f"pairwise_distance exact at the code graph's relink block [{q} x {c} x {d}]: euclidean "
          f"kernel {k1:.4f} / {k2:.4f} ms ({2.0 * q * c * d / min(k1, k2) / 1e9:.2f} TFLOP/s), "
          f"plain {p1:.4f} ms, torch.cdist {cdist:.4f} ms; normalized cosine kernel {kc:.4f} ms, "
          f"torch.addmm {lib:.4f} ms (kernel / library {kc / lib:.3f}); bound "
          f"{wide_bound['bound_ms']:.4f} ms by {wide_bound['bound_by']}; max_abs_err "
          f"{wide_err:.3e} (atol {PQ_WIDE_ATOL:.0e})")
    pair.update({"exact_wide_shape": f"{q} x {c} x {d}", "exact_wide_ms": min(k1, k2),
                 "exact_wide_plain_ms": p1, "exact_wide_cdist_ms": cdist,
                 "exact_wide_cosine_ms": kc, "exact_wide_library_ms": lib,
                 "exact_wide_library": "torch.addmm (normalized cosine)",
                 "exact_wide_bound_ms": wide_bound["bound_ms"],
                 "exact_wide_bound_by": wide_bound["bound_by"], "exact_wide_max_abs_err": wide_err})
    xq = gate_vecs[-4096:].contiguous()
    yc = gate_vecs[:65_536].contiguous()
    xo = cuda_distance.prepare_operand(xq, Metric.EUCLIDEAN, exact=False)
    yo = cuda_distance.prepare_operand(yc, Metric.EUCLIDEAN, exact=False)
    fast = lambda: cuda_distance.cuda_pairwise_distance(xo, yo, Metric.EUCLIDEAN, exact=False)
    want = pairwise_distance_bf16_dots(xq[:512], yc, Metric.EUCLIDEAN)
    fast_err = float((fast()[:512] - want).abs().max())
    del want
    # unit vectors of D = 1536: |x|^2 + |y|^2 - 2 x.y sums to ~2, the bf16
    # products summed in two orders differ by ~sqrt(D) ulps of 2
    assert fast_err <= 1e-4, f"pairwise fast at D = 1536 disagrees: {fast_err}"
    k1, p1 = _median_ms(fast, reps=5), _median_ms(
        lambda: pairwise_distance_bf16_dots(xq, yc, Metric.EUCLIDEAN), reps=3)
    k2 = _median_ms(fast, reps=5)
    xb, yb = xq.to(torch.bfloat16), yc.to(torch.bfloat16)
    lib = _median_ms(lambda: torch.matmul(xb, yb.T), reps=5)
    q, c, d = 4096, 65_536, PQ_GATE_DIM
    fast_bound = _bound(2.0 * q * c * d, PEAK_BF16_FLOPS, 2.0 * (q + c) * d + 4.0 * q * c)
    print(f"pairwise_distance fast at the PQ flat scan's block [{q} x {c} x {d}] euclidean: kernel "
          f"{k1:.4f} / {k2:.4f} ms ({2.0 * q * c * d / min(k1, k2) / 1e9:.2f} TFLOP/s), plain "
          f"{p1:.4f} ms, torch.matmul of the bf16 operands {lib:.4f} ms, bound "
          f"{fast_bound['bound_ms']:.4f} ms by {fast_bound['bound_by']}; max_abs_err {fast_err:.3e}")
    pair.update({"fast_shape": f"{q} x {c} x {d}", "fast_ms": min(k1, k2), "fast_plain_ms": p1,
                 "fast_library_ms": lib, "fast_library": "torch.matmul (bf16)",
                 "fast_bound_ms": fast_bound["bound_ms"], "fast_bound_by": fast_bound["bound_by"],
                 "fast_max_abs_err": fast_err})
    out["pairwise_distance"] = pair
    del xo, yo, xb, yb

    # gather-and-distance at D = 1536 (the code graph's hop on the densified
    # codes): the block that search's query-block formula gives (227 queries)
    # and 8192 queries, 4 x 48 candidates each
    table = gate_vecs
    eff = PQ_GATE_DIM // PQ_GATE_DSUB * 128
    hop_q = max(64, min(8192, (2 << 30) // (4 * 48 * eff * 4)))
    gd = {}
    for q in (hop_q, HOP_QUERIES):
        queries = gate_vecs[-q:].contiguous()
        idx = torch.randint(0, table.shape[0], (q, HOP_CANDIDATES), generator=gen, device=device,
                            dtype=torch.int32)
        idx[0, :2] = EMPTY_ID
        fused = lambda: cuda_gather.cuda_gather_distance(queries, table, idx, Metric.EUCLIDEAN)
        plain = lambda: cuda_gather.plain_gather_distance(queries, table, idx, Metric.EUCLIDEAN)
        got, want = fused(), plain()
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max())
        # unit rows: partial sums within [0, 4]; ~sqrt(1536) ulps of 4 apart
        assert err <= 4e-5, f"gather_distance at D = 1536 disagrees: {err}"
        k1, p1, k2 = _median_ms(fused), _median_ms(plain, reps=3), _median_ms(fused)
        rows_read = float(torch.unique(idx[idx < table.shape[0]]).numel())
        io = 4.0 * (2 * idx.numel() + q * PQ_GATE_DIM)
        flops = 3.0 * idx.numel() * PQ_GATE_DIM
        bound = _bound(flops, PEAK_FP32_FLOPS, io + rows_read * PQ_GATE_DIM * 4.0)
        ms = min(k1, k2)
        print(f"gather_distance at the PQ hop ({q} x {HOP_CANDIDATES} over [{table.shape[0]} x "
              f"{PQ_GATE_DIM}] f32, euclidean): kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} ms, "
              f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} with the "
              f"{int(rows_read)} distinct rows read once ({bound['bound_ms'] / ms:.1%}); "
              f"max_abs_err {err:.3e}")
        gd[q] = {"shape": f"{q} x {HOP_CANDIDATES} over [{table.shape[0]} x {PQ_GATE_DIM}]",
                 "ms": ms, "plain_ms": p1, "max_abs_err": err, **bound}
    out["gather_distance"] = {"path": gd[hop_q], "block_8192": gd[HOP_QUERIES]}

    # row gather as reconstruct uses it: uint16 code rows, then centroid rows
    # by j*K + code; the card's result against the CPU's, bit for bit
    rng = np.random.default_rng(12)
    codes = torch.from_numpy(rng.integers(0, PQ_GATE_CENTROIDS, (PQ_QUANTIZE_BLOCK // 4, 96))
                             .astype(np.int32)).to(device)
    codes[0] = PQ_GATE_CENTROIDS - 1
    codes16 = narrow_codes(codes)
    src = PqSource(codes=codes16, codebook=cents)
    ids = torch.randint(0, codes.shape[0], (65_536,), generator=gen, device=device,
                        dtype=torch.int32)
    got = source_get(src, ids)
    cpu_src = PqSource(codes=codes16.view(torch.int16).cpu().view(torch.uint16),
                       codebook=cents.cpu())
    assert torch.equal(got.cpu(), source_get(cpu_src, ids.cpu())), "reconstruct differs from the CPU's"
    flat = widen_codes(codes16[:16_384]).reshape(-1)
    k1 = _median_ms(lambda: cuda_gather.cuda_row_gather(cents, flat))
    lib = _median_ms(lambda: torch.index_select(cents, 0, flat))
    p1 = _median_ms(lambda: cuda_gather.plain_row_gather(cents, flat))
    rg_bound = _bound(0.0, PEAK_FP32_FLOPS, 4.0 * flat.numel() + 64.0 * flat.numel()
                      + min(64.0 * flat.numel(), cents.numel() * 4.0))
    print(f"row_gather as reconstruct uses it: {ids.numel()} uint16 code rows of 96 and their "
          f"centroids, bit-identical to the CPU's; centroid rows ({flat.numel()} of 64 bytes from "
          f"[{PQ_GATE_CENTROIDS} x 16] f32): kernel {k1:.4f} ms, plain {p1:.4f} ms, "
          f"torch.index_select {lib:.4f} ms, bound {rg_bound['bound_ms']:.4f} ms by "
          f"{rg_bound['bound_by']}")
    out["row_gather"] = {"shape": f"R={flat.numel()}, table [{PQ_GATE_CENTROIDS} x 16] f32",
                         "ms": k1, "plain_ms": p1, "library_ms": lib, **rg_bound}
    return out


def _recall_at_1(ids: torch.Tensor) -> float:
    return float((ids[:, 0] == torch.arange(ids.shape[0], device=ids.device)).float().mean())


def _qps(label, fn, n) -> float:
    """Queries per second of ``fn``: median of 3 timed calls, host clock with
    synchronize (the caller's counted call before it is the warm-up)."""
    times = []
    for _ in range(3):
        ts = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
    secs = float(np.median(times))
    print(f"{label}: {n / secs:.1f} QPS ({secs:.4f} s for {n} queries, median of 3)")
    return n / secs


def _span_summary() -> dict:
    return {name: round(row["seconds"], 3) for name, row in TRACER.summary().items()}


def pq_gate_phase(gate_vecs: torch.Tensor) -> tuple:
    """10a: the reference's PQ gate at full scale.  Returns the index, the
    launches of the PQ path (the build plus one search of each kind, counts
    zeroed before the build) and the numbers to keep."""
    source = DenseSource(vectors=gate_vecs)
    TRACER.events.clear()
    tb = time.perf_counter()
    q, build_launches = _counted(lambda: QuantizedHnsw.new(
        PQ_GATE_CENTROIDS, source, PQ_GATE_DSUB, Metric.EUCLIDEAN, pqp=PqBuildParams(), seed=0,
        fast_quantize=True))
    build_s = time.perf_counter() - tb
    spans = _span_summary()
    pq_src = q.hnsw.source
    nsub = PQ_GATE_DIM // PQ_GATE_DSUB
    assert pq_src.codes.dtype == torch.uint16 and pq_src.codes.shape == (PQ_GATE_COUNT, nsub)
    assert pq_src.codebook.shape == (PQ_GATE_CENTROIDS, PQ_GATE_DSUB)
    print(f"PQ gate build ({PQ_GATE_COUNT} x {PQ_GATE_DIM}, {PQ_GATE_CENTROIDS} centroids x "
          f"{PQ_GATE_DSUB}, {nsub} uint16 codes, binned quantize): {build_s:.3f} s; spans {spans}; "
          f"code graph {[l.node_count for l in q.hnsw.layers]}, centroid graph "
          f"{[l.node_count for l in q.quantizer.hnsw.layers]}; launches {build_launches}")
    assert build_launches["binned_scan"] > 0, "the quantize did not run the binned kernel"

    # binned codes against the exact argmin
    subs = gate_vecs.reshape(-1, PQ_GATE_DSUB)[:PQ_AGREE_SUBS]
    fast = quantize_binned(subs, q.quantizer.centroids, Metric.EUCLIDEAN)
    exact = blocked_topk_pairwise(subs, q.quantizer.centroids, Metric.EUCLIDEAN, 1,
                                  row_block=8192)[0][:, 0]
    agree = float((fast == exact).float().mean())
    print(f"PQ gate: binned codes equal the exact argmin for {agree:.6f} of {PQ_AGREE_SUBS} "
          f"sub-vectors (floor {PQ_AGREE_FLOOR})")
    assert agree >= PQ_AGREE_FLOOR, f"binned quantize agreement {agree} below {PQ_AGREE_FLOOR}"

    rows = gate_vecs[:PQ_RECALL_ROWS]
    (flat_ids, flat_d), flat_launches = _counted(lambda: q.search_exact(rows, k=10, rerank=True))
    flat_recall = _recall_at_1(flat_ids)
    flat_qps = _qps("PQ gate search_exact(k=10, rerank=True)",
                       lambda: q.search_exact(rows, k=10, rerank=True), PQ_RECALL_ROWS)
    print(f"PQ gate flat scan: self-query recall@1 {flat_recall} (floor {PQ_FLAT_RECALL_FLOOR}); "
          f"launches of one call {flat_launches}")
    assert flat_ids.shape == (PQ_RECALL_ROWS, 10) and bool(torch.isfinite(flat_d).all())
    assert flat_recall >= PQ_FLAT_RECALL_FLOOR, f"PQ flat-scan recall@1 {flat_recall}"

    (g_ids, g_d), graph_launches = _counted(
        lambda: q.search(rows, rerank=True, exact_quantize=True))
    graph_recall = _recall_at_1(g_ids)
    graph_qps = _qps("PQ gate search(rerank=True, exact_quantize=True)",
                        lambda: q.search(rows, rerank=True, exact_quantize=True), PQ_RECALL_ROWS)
    print(f"PQ gate code graph: self-query recall@1 {graph_recall} (floor {PQ_GRAPH_RECALL_FLOOR}); "
          f"launches of one call {graph_launches}")
    assert bool(torch.isfinite(g_d[:, 0]).all())
    assert graph_recall >= PQ_GRAPH_RECALL_FLOOR, f"PQ code-graph recall@1 {graph_recall}"

    sample = gate_vecs[:PQ_GRAPH_QUANTIZER_ROWS]
    (s_ids, _), sample_launches = _counted(lambda: q.search(sample, rerank=True))
    sample_qps = _qps("PQ gate search(rerank=True) with the centroid-graph quantizer",
                         lambda: q.search(sample, rerank=True), PQ_GRAPH_QUANTIZER_ROWS)
    sample_recall = _recall_at_1(s_ids)
    print(f"PQ gate, centroid-graph quantizer (the default): recall@1 {sample_recall} on "
          f"{PQ_GRAPH_QUANTIZER_ROWS} rows; launches of one call {sample_launches}")

    path = {k: build_launches[k] + flat_launches[k] + graph_launches[k] for k in build_launches}
    print(f"launches in one pass of the PQ path (the build, one search_exact, one code-graph "
          f"search): {path}")
    return q, path, {"build_s": build_s, "spans": spans, "agree": agree,
                     "flat_recall_at_1": flat_recall, "flat_qps": flat_qps,
                     "graph_recall_at_1": graph_recall, "graph_qps": graph_qps,
                     "graph_quantizer_recall_at_1": sample_recall, "graph_quantizer_qps": sample_qps}


def pq_c4_phase(vecs: torch.Tensor) -> tuple:
    """10b: per-subspace k-means codebooks on config4's shapes, 200,000 rows
    (``vecs``: the corpus, then the held-out queries).  Returns the index,
    the numbers to keep and the binned scan's check at its search block."""
    source, queries = DenseSource(vectors=vecs[:PQ_C4_COUNT]), vecs[PQ_C4_COUNT:]
    metric = Metric.NORMALIZED_COSINE
    TRACER.events.clear()
    tb = time.perf_counter()
    q, launches = _counted(lambda: QuantizedHnsw.new(
        PQ_C4_CENTROIDS, source, PQ_C4_DSUB, metric, pqp=PqBuildParams(), seed=0,
        per_subspace=True, use_kmeans=True, fast_quantize=True))
    build_s = time.perf_counter() - tb
    spans = _span_summary()
    assert q.centroid_hnsw() is None
    assert q.hnsw.source.codebook.shape == (PQ_C4_DIM // PQ_C4_DSUB, PQ_C4_CENTROIDS, PQ_C4_DSUB)
    print(f"PQ c4 build ({PQ_C4_COUNT} x {PQ_C4_DIM}, per-subspace k-means {PQ_C4_CENTROIDS} x "
          f"{PQ_C4_DSUB}, binned quantize): {build_s:.3f} s; spans {spans}; launches {launches}")
    gt_ids, _ = brute_force_knn(source, queries, metric, 10)
    (ids, d), flat_launches = _counted(
        lambda: q.search_exact(queries, k=10, oversample=PQ_C4_OVERSAMPLE))
    flat_recall = _recall_at_10(ids, gt_ids)
    flat_qps = _qps(f"PQ c4 search_exact(k=10, oversample={PQ_C4_OVERSAMPLE})",
                       lambda: q.search_exact(queries, k=10, oversample=PQ_C4_OVERSAMPLE),
                       PQ_C4_QUERIES)
    print(f"PQ c4 flat scan (binned route): recall@10 {flat_recall:.5f} against the exact "
          f"full-precision scan (floor {PQ_C4_RECALL_FLOOR}); launches of one call {flat_launches}")
    assert flat_launches["binned_scan"] > 0, "search_exact at 200k codes did not take the binned route"
    assert flat_recall >= PQ_C4_RECALL_FLOOR, f"PQ c4 recall@10 {flat_recall}"

    # the binned scan at the launch shape of that search_exact: the query
    # block against the 200,000 decoded codes, as the path reconstructs and
    # casts them
    pq_src = q.hnsw.source
    feats = cuda_scan.scan_operand(reconstruct(pq_src.codebook, pq_src.codes))
    search_scan = _pq_binned_case("10b's search_exact block", cuda_scan.scan_operand(queries),
                                  feats, metric, metric)
    del feats

    # ADC tables against the reconstruct-then-distance product
    q_adc = queries[:PQ_ADC_QUERIES]
    scores = adc_scan(adc_lut(q_adc, q.hnsw.source.codebook, metric), q.hnsw.source.codes, metric)
    recon = q.hnsw.compute_source.vectors
    want = cuda_distance.best_pairwise_distance(q_adc, recon, metric)
    adc_err = float((scores - want).abs().max())
    print(f"PQ c4 adc_scan over {PQ_C4_COUNT} codes for {PQ_ADC_QUERIES} queries: max_abs_err "
          f"{adc_err:.3e} against the pairwise kernel on the decoded codes (atol {PQ_ADC_ATOL:.0e})")
    assert adc_err <= PQ_ADC_ATOL, f"adc_scan disagrees: {adc_err}"

    (g_ids, _), graph_launches = _counted(lambda: q.search(queries))
    g_recall = _recall_at_10(g_ids, gt_ids)
    g_qps = _qps("PQ c4 code-graph search", lambda: q.search(queries), PQ_C4_QUERIES)
    q.enable_routing(dr=None)
    q.enable_hop_slabs()
    (r_ids, r_d), routed_launches = _counted(lambda: q.search(queries))
    r_recall = _recall_at_10(r_ids, gt_ids)
    r_qps = _qps("PQ c4 code-graph search, routed (bf16 cast) over bf16 slabs",
                    lambda: q.search(queries), PQ_C4_QUERIES)
    print(f"PQ c4 code graph: recall@10 {g_recall:.5f} plain, {r_recall:.5f} routed over slabs "
          f"(within {ROUTED_RECALL_SLACK}); launches {graph_launches}, routed {routed_launches}")
    assert r_recall >= g_recall - ROUTED_RECALL_SLACK, "routed slab search lost recall"
    assert bool((r_d[:, 1:10] >= r_d[:, :9]).all()), "reranked distances not ascending"
    q.hnsw.disable_hop_slabs()
    q.hnsw.disable_routing()
    return q, {"build_s": build_s, "spans": spans, "flat_recall_at_10": flat_recall,
               "flat_qps": flat_qps, "adc_max_abs_err": adc_err, "graph_recall_at_10": g_recall,
               "graph_qps": g_qps, "routed_slab_recall_at_10": r_recall,
               "routed_slab_qps": r_qps}, search_scan


def _same_codes(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(a.view(torch.int16), b.view(torch.int16))


def pq_rest_phase(gate: QuantizedHnsw, c4: QuantizedHnsw, gate_vecs: torch.Tensor) -> dict:
    """10c: both indexes through ``io`` and back onto the card; then the
    hop over codes that are not densified, against the densified hop."""
    out = {}
    for name, q in (("gate", gate), ("c4", c4)):
        queries = q.full_source.vectors[:PERSIST_QUERIES]
        tmp = tempfile.mkdtemp(prefix="hnsw_smoke_pq_")
        try:
            ts = time.perf_counter()
            serialize_quantized_hnsw(q, tmp)
            tw = time.perf_counter()
            loaded = deserialize_quantized_hnsw(tmp)
            torch.cuda.synchronize()
            tr = time.perf_counter()
        finally:
            shutil.rmtree(tmp)
        # read back onto the card by default, where the index lives
        assert loaded.hnsw.source.codes.device == q.hnsw.source.codes.device
        assert _same_codes(loaded.hnsw.source.codes, q.hnsw.source.codes)
        assert torch.equal(loaded.full_source.vectors, q.full_source.vectors)
        (i1, d1), (i2, d2) = q.search(queries), loaded.search(queries)
        assert torch.equal(i1, i2) and torch.equal(d1, d2), f"the loaded {name} index answers differently"
        print(f"PQ persistence ({name}): wrote in {tw - ts:.3f} s, read in {tr - tw:.3f} s; "
              f"{PERSIST_QUERIES} queries identical in ids and distances")
        out[name] = {"write_s": tw - ts, "read_s": tr - tw}

    # the non-dense route: the first 10,000 codes of the gate under a graph of
    # their own, searched densified and with DENSIFY_BUDGET_BYTES = 0
    codes = PqSource(codes=gate.hnsw.source.codes[:PQ_NON_DENSE_ROWS],
                     codebook=gate.hnsw.source.codebook)
    graph = Hnsw.generate(codes, None, PqBuildParams().hnsw, Metric.EUCLIDEAN, seed=0)
    full = DenseSource(vectors=gate_vecs[:PQ_NON_DENSE_ROWS])
    dense = QuantizedHnsw(gate.quantizer, graph, full)
    codes_only = Hnsw(graph.layers, codes, Metric.EUCLIDEAN, graph.build_parameters)
    codes_only.DENSIFY_BUDGET_BYTES = 0
    sparse = QuantizedHnsw(gate.quantizer, codes_only, full)
    assert isinstance(codes_only.compute_source, PqSource)
    # held-out rows of the gate's corpus: a corpus row's own code would be
    # its top-1 at distance 0 on both routes
    queries = gate_vecs[PQ_NON_DENSE_ROWS : PQ_NON_DENSE_ROWS + PQ_NON_DENSE_QUERIES]
    (d_ids, d_d), d_s = _timed_s(lambda: dense.search(queries, rerank=False), reps=1)
    (s_ids, s_d), s_s = _timed_s(lambda: sparse.search(queries, rerank=False), reps=1)
    same = d_ids[:, 0] == s_ids[:, 0]
    top1 = float(same.float().mean())
    drift = float((d_d[same, 0] - s_d[same, 0]).abs().max())
    shared = d_ids == s_ids
    print(f"PQ non-dense route ({PQ_NON_DENSE_ROWS} codes, {PQ_NON_DENSE_QUERIES} held-out "
          f"queries, no rerank): top-1 identical for {top1:.5f}, top-1 distances within "
          f"{drift:.3e}, at every shared slot within "
          f"{float((d_d - s_d)[shared].abs().max()):.3e}; all {d_ids.shape[1]} ids identical for "
          f"{float(shared.all(-1).float().mean()):.5f}; densified {d_s:.3f} s, reconstructing "
          f"{s_s:.3f} s")
    assert top1 >= 0.999 and drift <= 1e-5, "the non-dense route answers differently"
    out["non_dense"] = {"top1_identical": top1, "distance_drift": drift,
                        "densified_s": d_s, "reconstructing_s": s_s}
    return out


# -- phase 11: out-of-core sources and the sharded indexes --------------------

# The shards of phase 11: four on the one card (a Mesh that names it 4 times).
SHARDS = 4
# 11b, config 5 (BASELINE.md:30, BENCH_NOTES.md:519-556; scripts/ingest_bench.py
# is the JAX run of its ingest): 768-d unit embeddings, 96 uint16 codes of 8
# values over one shared 65,535 x 8 codebook, binned quantize, scan-only
# shards served by search_exact, the f32 corpus on disk and read back only for
# the final rerank.  Cuts of scale: 2,097,152 rows of 100M, 4 shards on one
# card (16 chips in config 5), 6.44 GB on disk (307 GB).  The rows follow
# clustered_corpus's recipe (10b), drawn and written 131,072 rows at a time.
# Euclidean: on unit rows it ranks as (normalized) cosine does, and it makes
# the sub-vector quantize a nearest-centroid assignment; the JAX scripts' normalized
# cosine assigns sub-vectors by largest dot and builds the centroid graph under
# a metric that cannot tell them apart (PERF.md, Findings).
C5_COUNT, C5_DIM, C5_CENTROIDS, C5_DSUB = 1 << 21, 768, 65_535, 8
C5_QUERIES, C5_WRITE_ROWS, C5_SEED = 1024, 131_072, 5
C5_METRIC = Metric.EUCLIDEAN
# Catches a broken path, not a target: recall@10 against the exact f32 scan
# was 0.62061 out of core and 0.85879 in core on an NVIDIA H100 80GB HBM3 at
# 700 W (the two modes rerank 40 and 4 x 40 candidates)
C5_RECALL_FLOOR = 0.5
# The rerank recomputes f32 distances of unit rows of D = 768 (partial sums
# within [-1, 1]; two summation orders ~sqrt(768) half-ulps of 1 apart)
C5_DIST_ATOL = 1e-5
SHARDED_RECALL_FLOOR = 0.80  # phase 6's floor for the single index


def write_clustered_corpus(path: str, count: int, dim: int, seed: int) -> np.ndarray:
    """clustered_corpus's recipe (1024 unit centers, each row a center plus
    0.35 N(0, 1) noise, normalized) drawn with numpy in chunks of
    ``C5_WRITE_ROWS`` rows, each from its own stream of ``seed``, on one host
    thread per core, and appended to the raw f32 file ``path`` in order: host
    memory holds one chunk a thread, never the corpus.  Returns
    ``C5_QUERIES`` held-out rows from a stream of their own."""
    n_chunks = -(-count // C5_WRITE_ROWS)
    streams = np.random.SeedSequence(seed).spawn(n_chunks + 2)
    rng = np.random.default_rng(streams[0])
    centers = rng.standard_normal((PQ_C4_CENTERS, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)

    def draw(i: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(streams[1 + i])
        pts = centers[rng.integers(0, PQ_C4_CENTERS, n)]
        pts += PQ_C4_NOISE * rng.standard_normal((n, dim), dtype=np.float32)
        pts /= np.sqrt(np.einsum("ij,ij->i", pts, pts))[:, None]
        return pts

    sizes = [min(C5_WRITE_ROWS, count - i * C5_WRITE_ROWS) for i in range(n_chunks)]
    workers = os.cpu_count() or 1
    with open(path, "wb") as f, ThreadPoolExecutor(max_workers=workers) as ex:
        for wave in range(0, n_chunks, workers):
            ids = range(wave, min(wave + workers, n_chunks))
            for pts in ex.map(draw, ids, [sizes[i] for i in ids]):
                pts.tofile(f)
    return draw(n_chunks, C5_QUERIES)


def memmap_ground_truth(mm: MemmapSource, queries: torch.Tensor, metric: Metric, k: int):
    """Exact f32 top-``k`` over the memmap's chunks, each moved to the card
    and scanned by the exact pairwise kernel."""
    best_i = best_d = None
    for n, chunk in enumerate(mm.chunks(C5_WRITE_ROWS)):
        rows = host_rows(chunk, queries.device)
        ids, d = blocked_topk_pairwise(queries, rows, metric, k)
        ids = ids + n * C5_WRITE_ROWS
        if best_i is not None:
            ids, d = sort_queue(torch.cat([best_i, ids], -1), torch.cat([best_d, d], -1))
        best_i, best_d = ids[:, :k], d[:, :k]
    return best_i, best_d


def _true_distance_err(mm: MemmapSource, queries, ids, dists, metric) -> float:
    """How far returned distances are from f32 distances recomputed from
    the memmap's rows."""
    want = batched_distance(queries, source_get(mm, ids, device=queries.device), metric)
    return float((dists - want).abs().max())


def _same_answer(i1, d1, i2, d2) -> torch.Tensor:
    """Per query: the same ids as sets, at equal distance (within
    ``C5_DIST_ATOL``)."""
    same_d = (d1 - d2).abs().max(dim=1).values <= C5_DIST_ATOL
    same_i = (torch.sort(i1, dim=1).values == torch.sort(i2, dim=1).values).all(dim=1)
    return same_d & same_i


def sharded_kernel_checks(device, vecs: torch.Tensor, queries: torch.Tensor) -> dict:
    """11a's new launch shapes: the pairwise kernel (both modes) as
    ``_shard_flat_scan`` calls it below 200k rows a shard (all the queries
    against one 50,000-row shard), and gather_distance at the in-shard
    rerank (each query's 40 survivors); against the plain versions, timed
    beside them, a library call and the bound."""
    metric = Metric.NORMALIZED_COSINE
    y = vecs[: vecs.shape[0] // SHARDS].contiguous()
    x = queries.contiguous()
    q, c, d = x.shape[0], y.shape[0], y.shape[1]
    out = {}
    for exact in (True, False):
        xo = cuda_distance.prepare_operand(x, metric, exact=exact)
        yo = cuda_distance.prepare_operand(y, metric, exact=exact)
        kern = lambda: cuda_distance.cuda_pairwise_distance(xo, yo, metric, exact=exact)
        plain = (lambda a=x: pairwise_distance(a, y, metric)) if exact else (
            lambda a=x: pairwise_distance_bf16_dots(a, y, metric))
        head = SCAN_CHECK_ROWS
        err = float((kern()[:head] - plain(x[:head])).abs().max())
        atol = BLOCK_ATOL if exact else FAST_BLOCK_ATOL
        assert err <= atol, f"pairwise exact={exact} at the shard scan disagrees: {err}"
        if exact:
            half = torch.full((), 0.5, device=device)
            library = lambda: torch.addmm(half, x, y.T, beta=1.0, alpha=-0.5)
        else:
            xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
            library = lambda: torch.matmul(xb, yb.T)
        p1, k1, k2 = _median_ms(plain, reps=3), _median_ms(kern, reps=5), _median_ms(kern, reps=5)
        lib = _median_ms(library, reps=5)
        elem = 4.0 if exact else 2.0
        bound = _bound(2.0 * q * c * d, PEAK_FP32_FLOPS if exact else PEAK_BF16_FLOPS,
                       elem * (q + c) * d + 4.0 * q * c)
        ms = min(k1, k2)
        print(f"pairwise_distance exact={exact} at 11a's shard scan [{q} x {c} x {d}]: kernel "
              f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} ms, library {lib:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({bound['bound_ms'] / ms:.1%}); "
              f"max_abs_err {err:.3e}")
        out["exact" if exact else "fast"] = {"shape": f"{q} x {c} x {d}", "ms": ms, "plain_ms": p1,
                                             "library_ms": lib, "max_abs_err": err, **bound}
    gen = torch.Generator(device=device).manual_seed(21)
    idx = torch.randint(0, c, (q, 40), generator=gen, device=device, dtype=torch.int32)
    fused = lambda: cuda_gather.cuda_gather_distance(x, y, idx, metric)
    plain = lambda: cuda_gather.plain_gather_distance(x, y, idx, metric)
    err = float((fused() - plain()).abs().max())
    assert err <= GATHER_DISTANCE_ATOL, f"gather_distance at the shard rerank disagrees: {err}"
    k1, p1, k2 = _median_ms(fused), _median_ms(plain, reps=3), _median_ms(fused)
    rows_read = float(torch.unique(idx).numel())
    bound = _bound(3.0 * idx.numel() * d, PEAK_FP32_FLOPS,
                   4.0 * (2 * idx.numel() + q * d + rows_read * d))
    ms = min(k1, k2)
    print(f"gather_distance at 11a's in-shard rerank ({q} x 40 over [{c} x {d}]): kernel "
          f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} ms, bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']} ({bound['bound_ms'] / ms:.1%}); max_abs_err {err:.3e}")
    out["gather_distance"] = {"shape": f"{q} x 40 over [{c} x {d}]", "ms": ms, "plain_ms": p1,
                              "library_ms": None, "max_abs_err": err, **bound}
    return out


def sharded_dense_phase(device, source: DenseSource, queries: torch.Tensor, gt_ids: torch.Tensor,
                        single: dict) -> tuple:
    """11a: a 4-shard ``ShardedHnsw`` over phase 5's corpus on the card:
    build with improve, search against phase 6's ground truth beside the
    single index, both flat scans, stochastic recall, improve_index, and a
    round trip through ``io``.  Returns the launches of the path (the build,
    one search, one scan of each mode) and the numbers to keep."""
    metric = Metric.NORMALIZED_COSINE
    mesh = Mesh([device] * SHARDS)
    tb = time.perf_counter()
    sh, build_launches = _counted(lambda: ShardedHnsw.generate(
        source, mesh, BuildParams(), metric, seed=0, improve=True))
    build_s = time.perf_counter() - tb
    print(f"11a build ({SHARDS} shards of {source.count // SHARDS} x {source.dim} on {device}): "
          f"{build_s:.3f} s; levels {[tuple(l.nodes.shape) for l in sh.layers_stacked]}; "
          f"launches {build_launches}")
    (ids, dists), search_launches = _counted(lambda: sh.search(queries, k=10))
    recall = _recall_at_10(ids, gt_ids)
    qps = _qps("11a ShardedHnsw.search(k=10)", lambda: sh.search(queries, k=10), queries.shape[0])
    print(f"11a search: held-out recall@10 {recall:.5f} at {qps:.1f} QPS; the single index "
          f"{single['recall']:.5f} at {single['qps']:.1f} QPS (phase 6); launches {search_launches}")
    assert ids.device == mesh.first and bool(torch.isfinite(dists).all())
    assert recall >= SHARDED_RECALL_FLOOR, f"sharded recall@10 {recall}"
    flat = {}
    scan_launches = {}
    for fast in (False, True):
        (f_ids, _), scan_launches[fast] = _counted(
            lambda: sh.search_exact(queries, k=10, fast=fast))
        f_recall = _recall_at_10(f_ids, gt_ids)
        f_qps = _qps(f"11a ShardedHnsw.search_exact(k=10, fast={fast})",
                     lambda: sh.search_exact(queries, k=10, fast=fast), queries.shape[0])
        print(f"11a search_exact(fast={fast}): recall@10 {f_recall:.5f}; launches "
              f"{scan_launches[fast]}")
        assert f_recall >= (0.999 if not fast else 0.99), f"sharded flat recall {f_recall}"
        flat[fast] = {"recall_at_10": f_recall, "qps": f_qps}
    stochastic = sh.stochastic_recall()
    ti = time.perf_counter()
    improved = sh.improve_index()
    improve_s = time.perf_counter() - ti
    print(f"11a stochastic_recall {stochastic}; improve_index {improved} in {improve_s:.3f} s")
    assert stochastic >= STOCHASTIC_RECALL_FLOOR, f"sharded stochastic recall {stochastic}"
    i1, d1 = sh.search(queries[:PERSIST_QUERIES], k=10)
    tmp = tempfile.mkdtemp(prefix="hnsw_smoke_sharded_")
    try:
        serialize_sharded_hnsw(sh, tmp)
        back = deserialize_sharded_hnsw(tmp, mesh)
    finally:
        shutil.rmtree(tmp)
    i2, d2 = back.search(queries[:PERSIST_QUERIES], k=10)
    assert torch.equal(i1, i2) and torch.equal(d1, d2), "the reloaded sharded index answers differently"
    print(f"11a persistence: {PERSIST_QUERIES} queries identical in ids and distances")
    path = {k: build_launches[k] + search_launches[k] + scan_launches[False][k]
            + scan_launches[True][k] for k in build_launches}
    return path, {"build_s": build_s, "recall_at_10": recall, "qps": qps,
                  "single_recall_at_10": single["recall"], "single_qps": single["qps"],
                  "exact_scan": flat[False], "fast_scan": flat[True],
                  "stochastic_recall": stochastic, "improve_index": improved,
                  "improve_s": improve_s}


def _ingest_summary() -> dict:
    spans = [e for e in TRACER.events if e.name == "ooc_ingest_shard"]
    secs = sum(e.seconds for e in spans)
    rows = sum(e.counters["rows"] for e in spans)
    nbytes = sum(e.counters["bytes"] for e in spans)
    return {"shards": len(spans), "seconds": secs, "rows": rows, "bytes": nbytes,
            "rows_per_s": rows / secs, "gb_per_s": nbytes / secs / 1e9}


def config5_kernel_checks(ooc: ShardedQuantizedHnsw, mm: MemmapSource,
                          queries: torch.Tensor) -> dict:
    """11b's new launch shapes against the plain versions, timed: the binned
    scan at one shard's block ``[1024 x 524,288 x 768]`` and at the quantize
    block ``[262,144 x 65,535 x 8]``, and the row gather of ``reconstruct``
    over that block (50,331,648 centroid rows of 32 bytes, bit for bit).
    The quantize block's bins are held by value in squared euclidean, as in
    phase 10 (sub-vectors that are centroids sit at distance ~0, where the
    root turns an ulp into ~3e-5), its columns in euclidean."""
    local = ooc.sharded.shard_source(0)
    block = reconstruct(local.codebook, local.codes)
    out = {"binned_scan": {
        "shard_block": _pq_binned_case("11b's shard scan block", cuda_scan.scan_operand(queries),
                                       cuda_scan.scan_operand(block), C5_METRIC, C5_METRIC)}}
    del block
    subs = host_rows(next(mm.chunks(PQ_QUANTIZE_BLOCK // (C5_DIM // C5_DSUB) + 1)),
                     queries.device).reshape(-1, C5_DSUB)[:PQ_QUANTIZE_BLOCK]
    out["binned_scan"]["quantize_block"] = _pq_binned_case(
        "11b's quantize block", subs.to(torch.bfloat16), local.codebook.to(torch.bfloat16),
        C5_METRIC, Metric.SQUARED_EUCLIDEAN)
    idx = widen_codes(local.codes).reshape(-1)
    table = local.codebook.contiguous()
    assert torch.equal(cuda_gather.cuda_row_gather(table, idx),
                       cuda_gather.plain_row_gather(table, idx)), "reconstruct's gather differs"
    k1 = _median_ms(lambda: cuda_gather.cuda_row_gather(table, idx), reps=5)
    p1 = _median_ms(lambda: cuda_gather.plain_row_gather(table, idx), reps=3)
    lib = _median_ms(lambda: torch.index_select(table, 0, idx), reps=5)
    k2 = _median_ms(lambda: cuda_gather.cuda_row_gather(table, idx), reps=5)
    r = float(idx.numel())
    bound = _bound(0.0, PEAK_FP32_FLOPS, 4.0 * r + 32.0 * r + table.numel() * 4.0)
    ms = min(k1, k2)
    print(f"row_gather as 11b's reconstruct uses it: {idx.numel()} centroid rows of 32 bytes from "
          f"[{table.shape[0]} x {table.shape[1]}] f32, bit-identical to the plain version: kernel "
          f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} ms, torch.index_select {lib:.4f} ms, bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({bound['bound_ms'] / ms:.1%})")
    out["row_gather"] = {"shape": f"R={idx.numel()}, table [{table.shape[0]} x {table.shape[1]}] f32",
                         "ms": ms, "plain_ms": p1, "library_ms": lib, "max_abs_err": 0.0, **bound}
    return out


def config5_phase(device) -> tuple:
    """11b: the out-of-core ShardedQuantizedHnsw at config 5's code layout.
    Returns the launches of the path (the build and one search), the kernel
    checks at its shapes and the numbers to keep."""
    metric = C5_METRIC
    mesh = Mesh([device] * SHARDS)
    tmp = tempfile.mkdtemp(prefix="hnsw_smoke_c5_")
    try:
        path = os.path.join(tmp, "corpus.f32")
        tw = time.perf_counter()
        held_out = write_clustered_corpus(path, C5_COUNT, C5_DIM, C5_SEED)
        write_s = time.perf_counter() - tw
        mm = open_memmap_source(path, C5_DIM)
        corpus_bytes = mm.count * mm.dim * 4
        assert mm.count == C5_COUNT and os.path.getsize(path) == corpus_bytes
        queries = torch.from_numpy(held_out).to(device)
        gt_ids, _ = memmap_ground_truth(mm, queries, metric, 10)
        print(f"11b corpus: {C5_COUNT} x {C5_DIM} f32 ({corpus_bytes / 1e9:.2f} GB) written in "
              f"{write_s:.3f} s; exact ground truth of {C5_QUERIES} held-out queries over its "
              f"chunks")

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        TRACER.events.clear()
        tb = time.perf_counter()
        ooc, build_launches = _counted(lambda: ShardedQuantizedHnsw.new(
            C5_CENTROIDS, mm, C5_DSUB, metric, mesh, pqp=PqBuildParams(), seed=0,
            fast_quantize=True, build_graphs=False))
        build_s = time.perf_counter() - tb
        ingest = _ingest_summary()
        (ids, dists), search_launches = _counted(lambda: ooc.search_exact(queries, k=10, fast=True))
        peak = torch.cuda.max_memory_allocated()
        print(f"11b out-of-core build ({SHARDS} scan-only shards of {C5_COUNT // SHARDS} rows, "
              f"{C5_DIM // C5_DSUB} uint16 codes of {C5_DSUB} over {C5_CENTROIDS} centroids): "
              f"{build_s:.3f} s; ingest {ingest['seconds']:.3f} s for {ingest['rows']} rows, "
              f"{ingest['rows_per_s']:.1f} rows/s, {ingest['gb_per_s']:.3f} GB/s from the memmap; "
              f"launches {build_launches}")
        print(f"11b peak device memory from the build to the search: {peak / 1e9:.3f} GB "
              f"({(peak - base) / 1e9:.3f} GB above the {base / 1e9:.3f} GB held before), "
              f"below the corpus's {corpus_bytes / 1e9:.2f} GB")
        assert ooc.full_stacked is None and ooc.full_host is mm
        for s in range(SHARDS):
            codes = ooc.sharded.shard_source(s).codes
            assert codes.device == mesh.first and codes.dtype == torch.uint16
            assert tuple(codes.shape) == (C5_COUNT // SHARDS, C5_DIM // C5_DSUB)
        assert peak < corpus_bytes, f"out-of-core peak {peak} reaches the corpus's {corpus_bytes}"
        assert build_launches["binned_scan"] > 0 and search_launches["binned_scan"] > 0

        recall = _recall_at_10(ids, gt_ids)
        dist_err = _true_distance_err(mm, queries, ids, dists, metric)
        qps = _qps("11b out-of-core search_exact(k=10, fast=True)",
                   lambda: ooc.search_exact(queries, k=10, fast=True), C5_QUERIES)
        print(f"11b out-of-core search_exact: recall@10 {recall:.5f} against the exact f32 scan "
              f"(floor {C5_RECALL_FLOOR}); distances within {dist_err:.3e} of f32 recomputed from "
              f"the memmap; launches {search_launches}")
        assert dist_err <= C5_DIST_ATOL, f"out-of-core distances are not the f32 ones: {dist_err}"
        assert recall >= C5_RECALL_FLOOR, f"out-of-core recall@10 {recall}"

        kernels = config5_kernel_checks(ooc, mm, queries)

        # persistence against the external memmap
        pdir = os.path.join(tmp, "index")
        serialize_sharded_quantized_hnsw(ooc, pdir)
        back = deserialize_sharded_quantized_hnsw(pdir, mesh, full_source=mm)
        b_ids, b_d = back.search_exact(queries, k=10, fast=True)
        assert torch.equal(b_ids, ids) and torch.equal(b_d, dists), "the reloaded index differs"
        del back
        print(f"11b persistence against the external memmap: {C5_QUERIES} queries identical")

        # the in-core twin from the same rows, full_stacked on the card.  The
        # two modes rerank different candidates (in core each shard's top
        # k * oversample before the merge, out of core the merged top
        # k * oversample), so their answers are held where they must agree:
        # the codes, the code scan, and the rerank of the same candidates by
        # the host gather and by the card's
        full = materialize_source(mm, block=C5_WRITE_ROWS, device=device)
        inc = ShardedQuantizedHnsw.new(
            C5_CENTROIDS, DenseSource(vectors=full), C5_DSUB, metric, mesh, pqp=PqBuildParams(),
            seed=0, fast_quantize=True, build_graphs=False)
        same_codes = all(_same_codes(inc.sharded.shard_source(s).codes,
                                     ooc.sharded.shard_source(s).codes) for s in range(SHARDS))
        assert same_codes, "in-core codes differ from the out-of-core ones"
        cand, cand_d = ooc.sharded.search_exact(queries, k=40, fast=True)
        in_cand, in_cand_d = inc.sharded.search_exact(queries, k=40, fast=True)
        assert torch.equal(cand, in_cand) and torch.equal(cand_d, in_cand_d), "code scans differ"
        h_ids, h_d = exact_rerank(mm, metric, queries, cand)
        d_ids, d_d = exact_rerank(DenseSource(vectors=full), metric, queries, cand)
        assert torch.equal(h_ids, d_ids) and torch.equal(h_d, d_d), "host and card reranks differ"
        assert torch.equal(h_ids[:, :10], ids) and torch.equal(h_d[:, :10], dists)
        del full
        i_in, d_in = inc.search_exact(queries, k=10, fast=True)
        in_recall = _recall_at_10(i_in, gt_ids)
        in_err = _true_distance_err(mm, queries, i_in, d_in, metric)
        agree = float(_same_answer(i_in, d_in, ids, dists).float().mean())
        overlap = _recall_at_10(i_in, ids)
        print(f"11b in-core twin: codes byte-identical to the out-of-core ones, the same code "
              f"scan, and the host rerank of its candidates equals the card's bit for bit; its "
              f"search_exact recall@10 {in_recall:.5f} (distances within {in_err:.3e} of f32); "
              f"top-10 overlap with the out-of-core answer {overlap:.5f}, the same ids as sets "
              f"at equal distance for {agree:.5f} of the queries")
        assert in_err <= C5_DIST_ATOL and in_recall >= C5_RECALL_FLOOR
        del inc
    finally:
        shutil.rmtree(tmp)
    path = {k: build_launches[k] + search_launches[k] for k in build_launches}
    return path, kernels, {"write_s": write_s, "build_s": build_s, "ingest": ingest,
                           "peak_gb": peak / 1e9, "peak_above_base_gb": (peak - base) / 1e9,
                           "corpus_gb": corpus_bytes / 1e9, "recall_at_10": recall, "qps": qps,
                           "in_core_recall_at_10": in_recall, "in_core_overlap_at_10": overlap,
                           "in_core_same_answer": agree}


def sharded_pq_phase(device, vecs: torch.Tensor, c4: dict) -> tuple:
    """11c: an in-core ShardedQuantizedHnsw with code graphs on 10b's corpus
    (per-subspace k-means codebooks of 4096 x 4) over 4 shards: the code
    graphs' search with the in-shard rerank and the flat scan, recall@10
    beside 10b's."""
    metric = Metric.NORMALIZED_COSINE
    source, queries = DenseSource(vectors=vecs[:PQ_C4_COUNT]), vecs[PQ_C4_COUNT:]
    mesh = Mesh([device] * SHARDS)
    tb = time.perf_counter()
    sq, build_launches = _counted(lambda: ShardedQuantizedHnsw.new(
        PQ_C4_CENTROIDS, source, PQ_C4_DSUB, metric, mesh, pqp=PqBuildParams(), seed=0,
        per_subspace=True, use_kmeans=True, fast_quantize=True))
    build_s = time.perf_counter() - tb
    gt_ids, _ = brute_force_knn(source, queries, metric, 10)
    (ids, _), search_launches = _counted(lambda: sq.search(queries, k=10))
    recall = _recall_at_10(ids, gt_ids)
    qps = _qps("11c ShardedQuantizedHnsw.search(k=10)", lambda: sq.search(queries, k=10),
               PQ_C4_QUERIES)
    (f_ids, _), flat_launches = _counted(
        lambda: sq.search_exact(queries, k=10, oversample=PQ_C4_OVERSAMPLE))
    f_recall = _recall_at_10(f_ids, gt_ids)
    print(f"11c in-core sharded PQ ({SHARDS} shards, per-subspace {PQ_C4_CENTROIDS} x "
          f"{PQ_C4_DSUB}, code graphs): build {build_s:.3f} s; code-graph search recall@10 "
          f"{recall:.5f} at {qps:.1f} QPS (10b's single index {c4['graph_recall_at_10']:.5f}); "
          f"search_exact(oversample={PQ_C4_OVERSAMPLE}) recall@10 {f_recall:.5f} (10b "
          f"{c4['flat_recall_at_10']:.5f}); launches {build_launches} {search_launches}")
    assert recall >= c4["graph_recall_at_10"] - ROUTED_RECALL_SLACK, f"11c recall@10 {recall}"
    assert f_recall >= PQ_C4_RECALL_FLOOR, f"11c flat recall@10 {f_recall}"
    path = {k: build_launches[k] + search_launches[k] + flat_launches[k] for k in build_launches}
    return path, {"build_s": build_s, "graph_recall_at_10": recall, "graph_qps": qps,
                  "flat_recall_at_10": f_recall}


# -- phase 12: graph diagnostics ----------------------------------------------

INF_I32 = analysis.INF_I32
# Supers whose BFS tables the CPU recomputes on layer 1 (two chunks of 64):
# the CPU's fixpoint takes ~1.6 s a chunk there, the 22 chunks ~36 s a call.
CPU_CHECK_SUPERS = 128
# Closest supers found by the card's and the CPU's fp32 products may differ
# where two supers lie within a few ulps of a node (distances ~1, ulp 6e-8).
PARTITION_TIE_ATOL = 1e-6


def _ms(fn):
    """``(fn(), host-clock ms)``: the diagnostics return numpy arrays, so the
    card's work and the copy to the host are inside."""
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _bfs_iterations(since: int) -> list:
    """Iterations of each BFS fixpoint traced since event ``since``."""
    return [int(e.counters["iterations"]) for e in TRACER.events[since:] if e.name == "bfs_fixpoint"]


def dijkstra_reference(layer: Layer, supers: np.ndarray):
    """``(hops, index_sum)`` of every node from its nearest super by scipy's
    Dijkstra over the layer's edges, unit weights and then weight slot + 1:
    an independent reference for ``analysis.node_distances``.  A CSR matrix
    sums duplicate entries, so a ``(src, dst)`` pair that a row holds twice
    keeps its smallest slot first."""
    import scipy.sparse
    import scipy.sparse.csgraph

    nodes = layer.nodes.cpu().numpy()
    nb = layer.neighbors.cpu().numpy()
    n, m = nb.shape
    src = np.repeat(np.arange(n), m)
    dst = nb.reshape(-1).astype(np.int64)
    cost = np.tile(np.arange(1, m + 1), n)
    ok = (dst >= 0) & (dst < n)
    src, dst, cost = src[ok], dst[ok], cost[ok]
    order = np.lexsort((cost, dst, src))
    src, dst, cost = src[order], dst[order], cost[order]
    first = np.ones(len(src), bool)
    first[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
    src, dst, cost = src[first], dst[first], cost[first]
    pos = np.searchsorted(nodes, supers)
    found = (pos < n) & (nodes[np.minimum(pos, n - 1)] == supers)
    out = []
    for w in (np.ones_like(cost), cost):
        graph = scipy.sparse.csr_matrix((w.astype(np.float64), (src, dst)), shape=(n, n))
        d = scipy.sparse.csgraph.dijkstra(graph, directed=True, indices=pos[found], min_only=True)
        out.append(np.where(np.isinf(d), INF_I32, d).astype(np.int64))
    return out, int(first.sum()), int(len(first) - first.sum())


def _cpu_layer(layer: Layer) -> Layer:
    return Layer(nodes=layer.nodes.cpu(), neighbors=layer.neighbors.cpu())


def _node_distances_checked(label: str, layer: Layer, supers: np.ndarray) -> tuple:
    """``node_distances`` on the card, twice (bit for bit), against the CPU
    run of the same code and scipy's Dijkstra; prints iterations and ms."""
    since = len(TRACER.events)
    (hops, isum), card_ms = _ms(lambda: analysis.node_distances(layer, supers))
    (hops2, isum2), again_ms = _ms(lambda: analysis.node_distances(layer, supers))
    iterations = _bfs_iterations(since)
    assert np.array_equal(hops, hops2) and np.array_equal(isum, isum2), "node_distances moved between runs"
    (c_hops, c_isum), cpu_ms = _ms(lambda: analysis.node_distances(_cpu_layer(layer), supers))
    assert np.array_equal(hops, c_hops) and np.array_equal(isum, c_isum), "card and CPU BFS differ"
    ts = time.perf_counter()
    (want_h, want_s), edges, dups = dijkstra_reference(layer, supers)
    scipy_ms = (time.perf_counter() - ts) * 1e3
    assert np.array_equal(hops, want_h), "hops differ from scipy's Dijkstra"
    assert np.array_equal(isum, want_s), "index_sum differs from scipy's Dijkstra"
    unreachable = int((hops == INF_I32).sum())
    print(f"{label}: node_distances over {layer.node_count} nodes x {layer.neighborhood_size} slots "
          f"({edges} distinct edges, {dups} repeated), {len(supers)} supers: {iterations[0]} iterations, "
          f"{card_ms:.3f} ms on the card ({again_ms:.3f} ms again, equal bit for bit), {cpu_ms:.3f} ms "
          f"on the CPU (equal); scipy dijkstra {scipy_ms:.1f} ms, equal in hops and index_sum; "
          f"max hops {int(hops[hops < INF_I32].max())}, unreachable {unreachable}")
    return hops, isum, {"iterations": iterations[0], "card_ms": card_ms, "cpu_ms": cpu_ms,
                        "unreachable": unreachable}


def _check_partition(card: np.ndarray, cpu: np.ndarray, layer: Layer, source, metric, vectors) -> int:
    """The closest supers found on the card and on the CPU agree but where a
    node lies within ``PARTITION_TIE_ATOL`` of both (float64 distances).
    Returns the count of such nodes."""
    differ = np.nonzero(card != cpu)[0]
    if len(differ):
        feats = source_get(source, layer.nodes[torch.from_numpy(differ).to(layer.nodes.device)])
        sup = source_get(source, torch.from_numpy(np.asarray(vectors, np.int32)).to(feats.device))
        d = pairwise_distance(feats.double(), sup.double(), metric).cpu().numpy()
        rows = np.arange(len(differ))
        gap = np.abs(d[rows, card[differ]] - d[rows, cpu[differ]])
        assert gap.max() <= PARTITION_TIE_ATOL, f"closest supers differ beyond a tie: {gap.max()}"
    return len(differ)


def diagnostics_phase(hnsw: Hnsw) -> dict:
    """Phase 12: the BFS diagnostics on phase 5's index (see the module's
    docstring).  Returns the numbers for the summary line."""
    numbers = {}
    bottom, supers0 = hnsw.get_layer(0), hnsw.supers_for_layer(0)
    (hops, isum), method_ms = _ms(lambda: hnsw.node_distances_for_layer(0))
    _, _, numbers["layer0"] = _node_distances_checked("layer 0", bottom, supers0)
    assert np.array_equal(hops, analysis.node_distances(bottom, supers0)[0])
    promote, promote_ms = _ms(lambda: hnsw.discover_nodes_to_promote(0))
    assert np.array_equal(promote, np.nonzero(hops == INF_I32)[0]), (
        "discover_nodes_to_promote is not the unreachable nodes, worst first")
    print(f"node_distances_for_layer(0) {method_ms:.3f} ms; discover_nodes_to_promote(0) "
          f"{promote_ms:.3f} ms: {len(promote)} nodes, the unreachable ones")

    chunk = supers0[:64]
    since = len(TRACER.events)
    (c_h, c_s), chunk_ms = _ms(lambda: analysis.per_super_node_distances(bottom, chunk))
    chunk_iters = _bfs_iterations(since)[0]
    assert np.array_equal(c_h.min(0), analysis.node_distances(bottom, chunk)[0])
    n_chunks = -(-len(supers0) // 64)
    print(f"per_super_node_distances over layer 0, one chunk of 64 supers ([64 x "
          f"{bottom.node_count * bottom.neighborhood_size}] int32 temporaries): {chunk_iters} iterations, "
          f"{chunk_ms:.3f} ms; all {n_chunks} chunks would take ~{chunk_ms * n_chunks / 1e3:.1f} s")
    numbers["layer0_chunk_ms"] = chunk_ms

    layer1, supers1 = hnsw.get_layer(1), hnsw.supers_for_layer(1)
    cpu1 = _cpu_layer(layer1)
    hops1, isum1, numbers["layer1"] = _node_distances_checked("layer 1", layer1, supers1)
    source, metric = hnsw.compute_source, hnsw.metric
    cpu_source = DenseSource(source.vectors.cpu())
    few = supers1[:CPU_CHECK_SUPERS]

    since = len(TRACER.events)
    (t_h, t_s), ps_ms = _ms(lambda: analysis.per_super_node_distances(layer1, supers1))
    ps_iters = _bfs_iterations(since)
    assert t_h.shape == (len(supers1), layer1.node_count)
    assert np.array_equal(t_h.min(0), hops1) and np.array_equal(t_s.min(0), isum1), (
        "the per-super tables' minimum is not node_distances")
    (f_h, f_s), f_ms = _ms(lambda: analysis.per_super_node_distances(cpu1, few))
    assert np.array_equal(t_h[:len(few)], f_h) and np.array_equal(t_s[:len(few)], f_s)

    (mn, mn_ms) = _ms(lambda: analysis.multi_node_distances(layer1, supers1, k=5))
    assert mn[0].shape == (layer1.node_count, 5) and np.array_equal(mn[1][:, 0], hops1)
    want = analysis.multi_node_distances(cpu1, few, k=5)
    for g, w in zip(analysis.multi_node_distances(layer1, few, k=5), want):
        assert np.array_equal(g, w), "multi_node_distances: card and CPU differ"

    part, part_ms = _ms(lambda: analysis.group_nodes_by_vectors(layer1, source, metric, supers1))
    c_part, c_part_ms = _ms(lambda: analysis.group_nodes_by_vectors(cpu1, cpu_source, metric, supers1))
    ties = _check_partition(part, c_part, layer1, source, metric, supers1)

    (cs_h, cs_s), cs_ms = _ms(lambda: analysis.node_distances_from_closest_super(
        layer1, source, metric, supers1))
    rows = np.arange(layer1.node_count)
    assert np.array_equal(cs_h, t_h[part, rows]) and np.array_equal(cs_s, t_s[part, rows])
    nc, nc_ms = _ms(lambda: analysis.nodes_not_connected_to_super(layer1, source, metric, supers1))
    assert np.array_equal(nc, np.nonzero(cs_h == INF_I32)[0])
    # the same two on the CPU, on the first supers only
    g_few = analysis.group_nodes_by_vectors(layer1, source, metric, few)
    c_few = analysis.group_nodes_by_vectors(cpu1, cpu_source, metric, few)
    ties += _check_partition(g_few, c_few, layer1, source, metric, few)
    same = g_few == c_few
    (k_h, k_s) = analysis.node_distances_from_closest_super(layer1, source, metric, few)
    (w_h, w_s), cs_cpu_ms = _ms(lambda: analysis.node_distances_from_closest_super(
        cpu1, cpu_source, metric, few))
    assert np.array_equal(k_h[same], w_h[same]) and np.array_equal(k_s[same], w_s[same])
    assert np.array_equal(k_h, f_h[g_few, rows]) and np.array_equal(k_s, f_s[g_few, rows])
    nc_few = analysis.nodes_not_connected_to_super(layer1, source, metric, few)
    nc_cpu = analysis.nodes_not_connected_to_super(cpu1, cpu_source, metric, few)
    assert set(np.setxor1d(nc_few, nc_cpu)) <= set(np.nonzero(~same)[0])
    print(f"layer 1 ({layer1.node_count} nodes, {len(supers1)} supers, {len(ps_iters)} chunks of 64, "
          f"{min(ps_iters)}-{max(ps_iters)} iterations a chunk): per_super_node_distances "
          f"{ps_ms:.3f} ms (its minimum is node_distances; the CPU's first {len(few)} supers: "
          f"{f_ms:.3f} ms, equal); multi_node_distances(k=5) {mn_ms:.3f} ms; "
          f"group_nodes_by_vectors {part_ms:.3f} ms (CPU {c_part_ms:.3f} ms; {ties} near-ties "
          f"within {PARTITION_TIE_ATOL}); node_distances_from_closest_super {cs_ms:.3f} ms "
          f"(CPU, first {len(few)} supers, {cs_cpu_ms:.3f} ms); nodes_not_connected_to_super "
          f"{nc_ms:.3f} ms: {len(nc)} nodes; each equal to the CPU run")
    numbers.update({"per_super_ms": ps_ms, "multi_node_ms": mn_ms, "group_ms": part_ms,
                    "closest_super_ms": cs_ms, "not_connected_ms": nc_ms,
                    "not_connected": int(len(nc)), "partition_ties": ties})

    # from the entry (node 0 of the top layer) to the top layer's other nodes
    check = list(range(1, hnsw.layers[0].node_count))
    reach, reach_ms = _ms(lambda: hnsw.reachables_from_node_for_layer(0, 0, check))
    assert reach == analysis.reachables_from(_cpu_layer(hnsw.layers[0]), 0, check)
    assert reach[0] == (0, 0) and sorted(n for n, _ in reach[1:]) == sorted(set(n for n, _ in reach[1:]))
    print(f"reachables_from_node_for_layer(top, entry): {len(reach) - 1} of the top layer's "
          f"{len(check)} other nodes in {reach_ms:.3f} ms")
    return numbers


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--count", type=int, default=200_000)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port has no CPU path to check here")
    device = torch.device("cuda:0")
    t0 = time.perf_counter()

    # 0. environment
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off on the exact paths"
    t = _phase("0 environment", t0)

    # 1. kernel build
    _native.load()
    print(_native.build_log.strip() or "(library already built)")
    t = _phase("1 kernel build", t)

    # 2. pairwise-distance kernel against its plain version
    operand, kernel = check_kernel(device)
    t = _phase("2 pairwise kernel check", t)

    # 3. scan kernels against their plain versions
    flat_vecs = random_unit_corpus(FLAT_SIZES[1][0] + QUERIES, FLAT_DIM, seed=42).vectors
    assert flat_vecs.device.type == "cuda", "the default device is not the card"
    scans = check_scan_kernels(device, flat_vecs)
    t = _phase("3 scan kernel check", t)

    # 4. row-gather and gather-and-distance kernels against their plain versions
    gather = check_gather_kernel(device)
    gather_distance = check_gather_distance_kernel(device)
    queue_merge = check_queue_merge_kernel(device)
    two_launch_hop = check_two_launch_hop(device)
    t = _phase("4 gather, queue-merge and two-launch hop checks", t)

    # 5. the corpus through the reference's file format, then the build
    drawn = random_unit_corpus(args.count + QUERIES, DIM, seed=42, device="cpu").vectors.numpy()
    vecs = torch.from_numpy(corpus_through_fvecs(drawn)).to(device)
    del drawn
    source = DenseSource(vectors=vecs[: args.count])
    queries = vecs[args.count :]
    enable_tracing(log=None)
    _zero_launches()
    tb = time.perf_counter()
    hnsw = Hnsw.generate(source, bp=BuildParams(), metric=Metric.NORMALIZED_COSINE, seed=0, improve=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    print(f"build: {build_s:.3f} s, {args.count / build_s:.1f} vec/s")
    print(f"layers: {[l.node_count for l in hnsw.layers]}")
    print(TRACER.format_summary())
    print(f"launches after build: {cuda_distance.LAUNCHES} {cuda_gather.LAUNCHES}")
    assert all(n > 0 for n in cuda_distance.LAUNCHES.values()), (
        "the build did not run the kernel in both modes, or not the operand kernel"
    )
    build_launches = dict(cuda_distance.LAUNCHES)
    stochastic = hnsw.stochastic_recall()
    print(f"stochastic recall: {stochastic}")
    hnsw.assert_invariants()
    t = _phase("5 build", t)

    # 6. search
    gt_ids, gt_d = hnsw.search_exact(queries, k=10)
    assert gt_ids.shape == (QUERIES, 10) and bool(torch.isfinite(gt_d).all())
    ids, dists = hnsw.search(queries)  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        ts = time.perf_counter()
        ids, dists = hnsw.search(queries)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
    qps = QUERIES / float(np.median(times))
    recall = _recall_at_10(ids, gt_ids)
    print(f"search: held-out recall@10 {recall:.5f}, {qps:.1f} QPS "
          f"(median of {[round(x, 4) for x in times]} s; {SEARCH_QPS_BEFORE_GATHER_KERNEL} QPS "
          f"with torch indexing in place of the row-gather kernel, H100 at 700 W)")
    assert bool(torch.isfinite(dists[:, :10]).all()), "non-finite search distances"
    assert recall >= HELD_OUT_RECALL_FLOOR, f"held-out recall@10 {recall} below {HELD_OUT_RECALL_FLOOR}"
    rows = source.vectors[:QUERIES]
    in_corpus = _recall_at_10(hnsw.search(rows)[0], hnsw.search_exact(rows, k=10)[0])
    print(f"search: in-corpus recall@10 {in_corpus:.5f}")
    assert in_corpus >= IN_CORPUS_RECALL_FLOOR, f"in-corpus recall@10 {in_corpus} below {IN_CORPUS_RECALL_FLOOR}"
    print(f"stochastic_recall(): {stochastic}")
    assert stochastic >= STOCHASTIC_RECALL_FLOOR, f"stochastic recall {stochastic} below {STOCHASTIC_RECALL_FLOOR}"
    launches = cuda_distance.LAUNCHES["exact"] + cuda_distance.LAUNCHES["fast"]
    operand_launches = cuda_distance.LAUNCHES["operand"]
    print(f"launches in the main path: {cuda_distance.LAUNCHES} {cuda_gather.LAUNCHES} "
          f"(of them in the build: {build_launches}; the rest are the exact scans of this phase)")
    build_and_search = dict(cuda_gather.LAUNCHES)
    # the gather kernels' counts: ONE search pass, zeroed just before it
    _zero_launches()
    one_ids, _ = hnsw.search(queries)
    torch.cuda.synchronize()
    hop_launches = dict(cuda_gather.LAUNCHES, **cuda_queues.LAUNCHES)
    block = auto_query_block(hnsw.compute_source, hnsw.build_parameters.optimization.search,
                             max(layer.neighborhood_size for layer in hnsw.layers))
    blocks = -(-QUERIES // block)
    print(f"launches in one search pass of {QUERIES} queries ({blocks} query blocks): "
          f"hop_expand {hop_launches['hop_expand']} (the hop's frontier, neighbor rows and "
          f"distances), queue_merge {hop_launches['queue_merge']} (the hop's queue update and "
          f"termination accounting), row_gather {hop_launches['row_gather']} (the entry vector "
          f"once per block), gather_distance {hop_launches['gather_distance']}")
    assert torch.equal(one_ids, ids), "a second search pass answered differently"
    # every hop is the two launches; the gather kernels only fetch the entry vector
    assert hop_launches["hop_expand"] > 0, "the search did not run the hop's expand kernel"
    assert hop_launches["queue_merge"] == hop_launches["hop_expand"], (
        "a hop did not run as the two launches")
    assert hop_launches["row_gather"] == blocks and hop_launches["gather_distance"] == 0, (
        "the hop ran a gather kernel besides its two launches")
    t = _phase("6 search", t)

    # 7. the other traversals
    phase_qps = traversal_phase(hnsw, queries, gt_ids, ids, dists)
    profile_phase(hnsw, queries, phase_qps)
    small_index_phase(vecs)
    t = _phase("7 routed, slab, instrumented and adaptive search", t)

    # 8. persistence
    persistence_phase(hnsw, queries[:PERSIST_QUERIES], device)
    t = _phase("8 persistence", t)

    # 9. flat scan
    flat_launches = flat_scan_phase(flat_vecs)
    del flat_vecs
    t = _phase("9 flat scan", t)

    # 10. product quantization: the kernels at the PQ path's shapes, the
    # reference's PQ gate, config4's per-subspace shapes, persistence and the
    # non-dense hop
    gate_vecs = random_unit_corpus(PQ_GATE_COUNT, PQ_GATE_DIM, seed=PQ_GATE_SEED).vectors
    c4_vecs = clustered_corpus(PQ_C4_COUNT + PQ_C4_QUERIES, PQ_C4_DIM, seed=7, device=device)
    pq_kernels = pq_kernel_checks(device, gate_vecs, c4_vecs)
    t = _phase("10 PQ kernel check", t)
    gate, pq_launches, gate_numbers = pq_gate_phase(gate_vecs)
    t = _phase("10a PQ gate", t)
    c4, c4_numbers, pq_kernels["binned_scan"]["c4_search"] = pq_c4_phase(c4_vecs)
    t = _phase("10b PQ per-subspace", t)
    rest = pq_rest_phase(gate, c4, gate_vecs)
    del gate, c4, gate_vecs
    t = _phase("10c PQ persistence and non-dense route", t)
    print("PQ summary: " + json.dumps({"gate": gate_numbers, "c4": c4_numbers, **rest}))

    # 11. out-of-core sources and the sharded indexes, 4 shards on the card:
    # the kernels at the sharded path's new shapes, then the dense index over
    # phase 5's corpus, the out-of-core PQ index at config 5's code layout and
    # the in-core PQ index with code graphs over 10b's corpus; each path's
    # launches counted from 0
    sharded_kernels = sharded_kernel_checks(device, source.vectors, queries)
    sharded_launches, dense_numbers = sharded_dense_phase(
        device, source, queries, gt_ids, {"recall": recall, "qps": qps})
    t = _phase("11a sharded dense index", t)
    c5_launches, c5_kernels, c5_numbers = config5_phase(device)
    t = _phase("11b out-of-core sharded PQ at config 5's code layout", t)
    pq_sharded_launches, pq_sharded_numbers = sharded_pq_phase(device, c4_vecs, c4_numbers)
    t = _phase("11c in-core sharded PQ with code graphs", t)
    sharded_path = {k: sharded_launches[k] + c5_launches[k] + pq_sharded_launches[k]
                    for k in sharded_launches}
    print(f"launches in one pass of the sharded path (11a-11c): {sharded_path}")
    for name in ("pairwise_distance", "binned_scan", "row_gather", "gather_distance"):
        assert sharded_path[name] > 0, f"the sharded path did not launch {name}"
    print("sharded summary: " + json.dumps({"11a": dense_numbers, "11b": c5_numbers,
                                            "11c": pq_sharded_numbers}))

    # 12. graph diagnostics on phase 5's index, which is still alive
    diagnostics, diagnostics_launches = _counted(lambda: diagnostics_phase(hnsw))
    print(f"launches in phase 12: {diagnostics_launches} (the row gathers of group_nodes_by_vectors)")
    print(f"{smi}; graph diagnostics summary: " + json.dumps(diagnostics))
    del hnsw
    t = _phase("12 graph diagnostics", t)
    _phase("total", t0)

    print(json.dumps({"kernels": [
        {
            "name": "pairwise_distance",
            "route": "cuda",
            "source": "parallel_hnsw_tpu_torch/csrc/pairwise_distance.cu",
            "replaces": "parallel_hnsw_tpu/ops/pallas_distance.py:29",
            "launches": launches,
            "launches_flat_scan_path": flat_launches["pairwise_distance"],
            "launches_pq_path": pq_launches["pairwise_distance"],
            **kernel,
            "pq": pq_kernels["pairwise_distance"],
            "launches_sharded_path": sharded_path["pairwise_distance"],
            "sharded": {"exact": sharded_kernels["exact"], "fast": sharded_kernels["fast"]},
        },
        {
            "name": "bf16_operand",
            "route": "cuda",
            "source": "parallel_hnsw_tpu_torch/csrc/pairwise_distance.cu",
            "replaces": "parallel_hnsw_tpu/ops/pallas_distance.py:46",
            "launches": operand_launches,
            "launches_flat_scan_path": flat_launches["bf16_operand"],
            "launches_pq_path": pq_launches["bf16_operand"],
            "launches_sharded_path": sharded_path["bf16_operand"],
            **operand,
        },
        {
            "name": "binned_scan",
            "route": "cuda",
            "source": "parallel_hnsw_tpu_torch/csrc/binned_scan.cu",
            "replaces": "parallel_hnsw_tpu/ops/pallas_scan.py:42",
            "launches": flat_launches["binned"],
            "launches_pq_path": pq_launches["binned_scan"],
            **scans["binned_scan"],
            "pq": pq_kernels["binned_scan"],
            "launches_sharded_path": sharded_path["binned_scan"],
            "sharded": c5_kernels["binned_scan"],
        },
        {
            "name": "folded_scan",
            "route": "cuda",
            "source": "parallel_hnsw_tpu_torch/csrc/binned_scan.cu",
            "replaces": "parallel_hnsw_tpu/ops/pallas_scan.py:161",
            "launches": flat_launches["folded"],
            "launches_pq_path": pq_launches["folded_scan"],
            "launches_sharded_path": sharded_path["folded_scan"],
            **scans["folded_scan"],
        },
        {
            "name": "row_gather",
            "route": "cuda",
            "source": "parallel_hnsw_tpu_torch/csrc/row_gather.cu",
            "replaces": "scripts/gather_kernel_study.py:34",
            "launches": hop_launches["row_gather"],
            "launches_build_and_search": build_and_search["row_gather"],
            "launches_pq_path": pq_launches["row_gather"],
            **gather,
            "pq": pq_kernels["row_gather"],
            "launches_sharded_path": sharded_path["row_gather"],
            "sharded": c5_kernels["row_gather"],
        },
        {
            "name": "gather_distance",
            "route": "cuda",
            "source": "parallel_hnsw_tpu_torch/csrc/gather_distance.cu",
            "replaces": "scripts/gather_kernel_study.py:34",
            "launches": hop_launches["gather_distance"],
            "launches_build_and_search": build_and_search["gather_distance"],
            "launches_pq_path": pq_launches["gather_distance"],
            **gather_distance,
            "pq": pq_kernels["gather_distance"],
            "launches_sharded_path": sharded_path["gather_distance"],
            "sharded": sharded_kernels["gather_distance"],
        },
        {
            "name": "queue_merge",
            "route": "cuda",
            "source": "parallel_hnsw_tpu_torch/csrc/queue_merge.cu",
            "replaces": None,
            "launches": hop_launches["queue_merge"],
            **queue_merge,
        },
        {
            "name": "two_launch_hop",
            "route": "cuda",
            "source": "parallel_hnsw_tpu_torch/csrc/gather_distance.cu (hop_expand) and "
                      "parallel_hnsw_tpu_torch/csrc/queue_merge.cu",
            "replaces": "scripts/gather_kernel_study.py:34",
            "launches": hop_launches["hop_expand"] + hop_launches["queue_merge"],
            **two_launch_hop,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
