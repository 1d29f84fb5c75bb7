"""The control of ``correct`` for a product-quantized cell: the plain PQ
reference put in the program's place, computed one precision below the
configuration's float32 (every operand rounded to TF32, the products in
TF32 on the card), and judged exactly as a run's answers are.  The cell's
limits must fail it.

    python3 benchmark/control_pq.py --workload deep-pq-batch --seeds 1 2 3

prints one JSON line per seed with the compared numbers and the cell's
limits, and exits with 1 if any seed's control passed them.

Its index, all of it in TF32: codebooks trained by ``reference_pq.train``
(the configuration's centroids, sample, iterations and seed), the corpus
encoded by ``reference_pq.encode``, and the answers of
``reference_pq.pq_flat_search`` over those codes.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent


def control_numbers(name: str, seed: int, device: str, config_overrides: Optional[dict] = None) -> dict:
    """The control's compared numbers for one seed, beside the cell's limits."""
    import torch

    from benchmark import data, harness, judge, judge_pq, reference, reference_pq

    _, config, traffic, limits = harness.cell_files(harness.manifest(), name, config_overrides)
    corpus, queries = data.draw(config, seed, torch.device(device))
    metric, k, oversample, pq = config["metric"], config["k"], traffic["oversample"], config["pq"]
    books, _ = reference_pq.train(corpus, pq["centroids"], pq["dsub"], pq["iters"],
                                  pq["kmeans_sample"], pq["seed"], tf32=True)
    codes = reference_pq.encode(corpus, books, tf32=True)
    ids, dists = reference_pq.pq_flat_search(corpus, books, codes, queries, metric, k, oversample, tf32=True)
    log = judge.AnswerLog()
    log.add(0, queries.shape[0], ids.cpu(), dists.cpu())
    with reference.matmul_precision(False):
        ref_ids, ref_dists = reference.exact_topk(corpus, queries, metric, k)
        numbers = judge.judge(log, corpus, queries, ref_ids, ref_dists, metric, k)
    numbers.update(judge_pq.numbers(log, corpus, queries, books, codes, metric, k, oversample, pq))
    checks = judge.verdict(numbers, limits)
    return {"workload": name, "seed": seed, "correct": judge.is_correct(checks),
            "recall_at_10": numbers["recall_at_10"], "checks": checks}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    passed = False
    for seed in args.seeds:
        out = control_numbers(args.workload, seed, args.device)
        passed |= out["correct"]
        print(json.dumps(out), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
