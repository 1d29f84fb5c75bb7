"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program
(``parallel_hnsw_tpu_torch``) beside ``BENCHMARK.json``, on a machine with
as many CUDA devices as the cell asks for.  ``--trace 0`` measures the
cell's end-to-end metrics over a window of ``--seconds``; ``--trace 1``
reads its per-layer metrics from a shorter traced window.  Either way every
answer is judged against the plain reference, and the compared numbers are
printed beside their limits on the last lines of standard error and under
``checks`` in the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: what must not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "parallel_hnsw_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    # the program builds its kernels into parallel_hnsw_tpu_torch/_build/,
    # a fixed path inside the checkout
    sys.path.insert(0, str(ROOT))

    import torch

    import parallel_hnsw_tpu_torch  # noqa: F401  (the program: without it, no run)
    from benchmark import harness

    chips = next((w["chips"] for w in harness.manifest()["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START, log=log)
    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, check in result["checks"].items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
