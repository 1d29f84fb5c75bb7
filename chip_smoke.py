"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--count 200000]

Phases, each printed as it ends:

0. environment: torch / CUDA versions, the card, ``nvidia-smi``'s name and
   power limit, and the TF32 switch (which must be off);
1. build of the CUDA pairwise-distance kernel from ``csrc/`` (nvcc);
2. the kernel against its plain PyTorch version on the card, for every metric
   and both modes, at the JAX kernel test's shapes and at the main-path block
   ``[2048 x 65536 x 100]``, with the median time of both at that block;
3. ``Hnsw.generate`` over ``--count`` random 100-d unit vectors (numpy seed
   42, normalized cosine, default ``BuildParams``, seed 0): build time, layer
   sizes, stochastic recall, the trace summary and the kernel launch counts;
4. ``Hnsw.search`` of 10,000 held-out vectors at the default
   ``SearchParams``: recall@10 against ``Hnsw.search_exact`` and QPS; then
   recall@10 of as many corpus rows as queries (``bench.py``'s measure).

The second-to-last line is a JSON object describing the kernel; the last is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
there is no CPU path.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from parallel_hnsw_tpu_torch import BuildParams, DenseSource, Hnsw, Metric
from parallel_hnsw_tpu_torch.ops import _native, cuda_distance
from parallel_hnsw_tpu_torch.ops.distance import pairwise_distance
from parallel_hnsw_tpu_torch.utils.data import random_unit_corpus
from parallel_hnsw_tpu_torch.utils.trace import TRACER, enable_tracing

DIM = 100
# The JAX kernel test's bound (tests/test_pallas_distance.py), at its shapes.
SMALL_ATOL = 2e-5
# Main-path block of unit vectors: every partial sum of the 100-term dot and
# norms stays within [-1, 1], so two fp32 summation orders differ by at most
# ~100 half-ulps of 1 (6e-6).
BLOCK_ATOL = 1e-5
MAIN_BLOCK = (2048, 65536)
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


def _phase(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"== phase {name}: {now - t0:.3f} s", flush=True)
    return now


def _median_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _recall_at_10(ids: torch.Tensor, gt_ids: torch.Tensor) -> float:
    hits = (ids[:, :10, None] == gt_ids[:, None, :]).any(-1).sum()
    return float(hits) / gt_ids.numel()


def check_kernel(device) -> dict:
    rng = np.random.default_rng(3)

    def unit(n):
        a = rng.uniform(-1.0, 1.0, (n, DIM)).astype(np.float32)
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    cases = [
        ("70x32/130x32", rng.normal(size=(70, 32)), rng.normal(size=(130, 32)), SMALL_ATOL),
        ("1x7/3x7", rng.normal(size=(1, 7)), rng.normal(size=(3, 7)), SMALL_ATOL),
        ("2048x100/65536x100", unit(MAIN_BLOCK[0]), unit(MAIN_BLOCK[1]), BLOCK_ATOL),
    ]
    max_err = 0.0
    for name, xa, ya, atol in cases:
        x = torch.as_tensor(xa, dtype=torch.float32, device=device)
        y = torch.as_tensor(ya, dtype=torch.float32, device=device)
        for metric in Metric:
            want = pairwise_distance(x, y, metric)
            for exact in (True, False):
                got = cuda_distance.cuda_pairwise_distance(x, y, metric, exact=exact)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                max_err = max(max_err, err)
                print(f"kernel {name} {metric.value} exact={exact}: max_abs_err={err:.3e} (atol {atol:.0e})")
                assert err <= atol, f"kernel disagrees with plain version: {name} {metric.value} {err}"
    x = torch.as_tensor(cases[2][1], device=device)
    y = torch.as_tensor(cases[2][2], device=device)
    timing = {}
    for metric in (Metric.NORMALIZED_COSINE, Metric.EUCLIDEAN):
        # alternate plain, kernel, kernel, plain
        p1 = _median_ms(lambda: pairwise_distance(x, y, metric))
        k1 = _median_ms(lambda: cuda_distance.cuda_pairwise_distance(x, y, metric))
        k2 = _median_ms(lambda: cuda_distance.cuda_pairwise_distance(x, y, metric))
        p2 = _median_ms(lambda: pairwise_distance(x, y, metric))
        timing[metric] = (min(k1, k2), min(p1, p2))
        print(f"time at main-path block {metric.value}: kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.4f} / {p2:.4f} ms")
    ms, plain_ms = timing[Metric.NORMALIZED_COSINE]
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


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

    # 2. kernel against its plain version
    kernel = check_kernel(device)
    t = _phase("2 kernel check", t)

    # 3. build
    vecs = random_unit_corpus(args.count + QUERIES, DIM, seed=42, device=device).vectors
    source = DenseSource(vectors=vecs[: args.count])
    queries = vecs[args.count :]
    enable_tracing(log=None)
    for mode in cuda_distance.LAUNCHES:
        cuda_distance.LAUNCHES[mode] = 0
    tb = time.perf_counter()
    hnsw = Hnsw.generate(source, bp=BuildParams(), metric=Metric.NORMALIZED_COSINE, seed=0, improve=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - tb
    print(f"build: {build_s:.3f} s, {args.count / build_s:.1f} vec/s")
    print(f"layers: {[l.node_count for l in hnsw.layers]}")
    print(TRACER.format_summary())
    print(f"launches after build: {cuda_distance.LAUNCHES}")
    assert cuda_distance.LAUNCHES["exact"] > 0 and cuda_distance.LAUNCHES["fast"] > 0, (
        "the build did not run the kernel in both modes"
    )
    stochastic = hnsw.stochastic_recall()
    print(f"stochastic recall: {stochastic}")
    hnsw.assert_invariants()
    t = _phase("3 build", t)

    # 4. search
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
          f"(median of {[round(x, 4) for x in times]} s)")
    assert bool(torch.isfinite(dists[:, :10]).all()), "non-finite search distances"
    assert recall >= HELD_OUT_RECALL_FLOOR, f"held-out recall@10 {recall} below {HELD_OUT_RECALL_FLOOR}"
    rows = source.vectors[:QUERIES]
    in_corpus = _recall_at_10(hnsw.search(rows)[0], hnsw.search_exact(rows, k=10)[0])
    print(f"search: in-corpus recall@10 {in_corpus:.5f}")
    assert in_corpus >= IN_CORPUS_RECALL_FLOOR, f"in-corpus recall@10 {in_corpus} below {IN_CORPUS_RECALL_FLOOR}"
    print(f"stochastic_recall(): {stochastic}")
    assert stochastic >= STOCHASTIC_RECALL_FLOOR, f"stochastic recall {stochastic} below {STOCHASTIC_RECALL_FLOOR}"
    launches = sum(cuda_distance.LAUNCHES.values())
    print(f"launches in the main path: {cuda_distance.LAUNCHES}")
    _phase("4 search", t)
    _phase("total", t0)

    print(json.dumps({"kernels": [{
        "name": "pairwise_distance",
        "route": "cuda",
        "source": "parallel_hnsw_tpu_torch/csrc/pairwise_distance.cu",
        "replaces": "parallel_hnsw_tpu/ops/pallas_distance.py:29",
        "launches": launches,
        **kernel,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
