"""What ``deep-pq-batch``'s compared numbers read at the cell's full size
when the PQ path is broken: each fault of ``benchmark/pq_faults.py``
planted in turn (k-means iterations skipped, the first codebook fitted on
the next columns, the training sample drawn from half the rows, the first
subspace's codes off by one, a code block dropped from the scan, codes
decoded against the next subspace's codebook, survivors cut at ``k``), one
short run of the cell each (``--seconds``, default 5), judged by the
benchmark's own harness.
Prints one JSON line a fault with every compared number beside its limit.
Run on a CUDA machine from the repo root::

    python3 studies/pq_scan_faults.py --seed 2147483659
"""

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import harness, pq_faults  # noqa: E402

CELL = "deep-pq-batch"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--faults", nargs="*", choices=sorted(pq_faults.FAULTS),
                        help="these faults alone (default: every one)")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in args.faults or sorted(pq_faults.FAULTS):
        with pq_faults.planted(name):
            result = harness.run_cell(CELL, args.seed, args.seconds, False)
        print(json.dumps({"fault": name, "correct": result["correct"], "checks": result["checks"],
                          "recall_at_10": result["metrics"]["recall_at_10"]["value"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
