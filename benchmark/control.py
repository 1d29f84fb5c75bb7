"""The control of ``correct``: the plain reference put in the program's
place, computed one precision below the configuration's float32 (TF32 for
the products), and judged exactly as a run's answers are.  Every cell's
limits must fail it.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

prints one JSON line per seed with the compared numbers and the cell's
limits, and exits with 1 if any seed's control passed them.
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

    from benchmark import data, harness, judge, reference

    _, config, _, limits = harness.cell_files(harness.manifest(), name, config_overrides)
    corpus, queries = data.draw(config, seed, torch.device(device))
    metric, k = config["metric"], config["k"]
    ids, dists = reference.exact_topk(corpus, queries, metric, k, tf32=True)
    log = judge.AnswerLog()
    log.add(0, queries.shape[0], ids.cpu(), dists.cpu())
    with reference.matmul_precision(False):
        ref_ids, ref_dists = reference.exact_topk(corpus, queries, metric, k)
        numbers = judge.judge(log, corpus, queries, ref_ids, ref_dists, metric, k)
    numbers.setdefault("missing_rows", 0.0)  # the control holds every row
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
