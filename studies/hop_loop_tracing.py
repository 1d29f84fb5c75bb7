"""What the hop loop's tracing costs when it is on, and what its spans say.

Builds the index of the benchmark's ``nytimes-256-angular`` configuration
(290,000 x 256 angular, ``BuildParams()``, drawn from ``--seed`` as the
benchmark draws it) and times ``Hnsw.search`` at the two batch sizes of the
graph cells, with ``TRACER`` disabled and enabled in turns (off, on, on,
off): ``--online`` calls of 100 queries and ``--batch-calls`` calls of
10,000 queries a turn, each call ending with its ids on the host.  Prints
the medians of each, the ``search_layer`` spans of the enabled calls per
call (hops, blocks, dispatch and wait seconds, host microseconds a hop),
and checks that the hop loops' host seconds fit inside every call.

Run on a CUDA machine from the repo root::

    python3 studies/hop_loop_tracing.py --seed 2147483659
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import data, harness  # noqa: E402
from benchmark.drivers import build_params, search_params  # noqa: E402
from parallel_hnsw_tpu_torch import DenseSource, Hnsw, Metric  # noqa: E402
from parallel_hnsw_tpu_torch.utils.trace import TRACER  # noqa: E402


def _timed_calls(index, queries, batch, calls, sp, start):
    """Per call: (seconds, search_layer events of the call)."""
    out = []
    for i in range(calls):
        offset = ((start + i) * batch) % queries.shape[0]
        TRACER.events.clear()
        t0 = time.perf_counter()
        ids, _ = index.search(queries[offset : offset + batch], sp)
        ids[:, :10].cpu()
        seconds = time.perf_counter() - t0
        out.append((seconds, [e for e in TRACER.events if e.name == "search_layer"]))
    TRACER.events.clear()
    return out


def _spans_per_call(calls):
    hops = [sum(e.counters["hops"] for e in ev) for _, ev in calls]
    dispatch = [sum(e.counters["dispatch_s"] for e in ev) for _, ev in calls]
    wait = [sum(e.counters["wait_s"] for e in ev) for _, ev in calls]
    total_hops = sum(hops)
    return {
        "hops_per_call": statistics.median(hops),
        "blocks": sorted({int(e.counters["queries"]) for _, ev in calls for e in ev}, reverse=True),
        "hops_per_block_layer": [[int(e.counters["queries"]), int(e.counters["layer"]), int(e.counters["hops"])]
                                 for e in calls[0][1]],
        "dispatch_us_per_hop": 1e6 * sum(dispatch) / total_hops,
        "wait_us_per_hop": 1e6 * sum(wait) / total_hops,
        "call_us_per_hop": 1e6 * sum(s for s, _ in calls) / total_hops,
        "loop_share_of_call_pct": 100.0 * (sum(dispatch) + sum(wait)) / sum(s for s, _ in calls),
        "loop_within_every_call": all(d + w <= s for (s, _), d, w in zip(calls, dispatch, wait)),
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--online", type=int, default=40)
    parser.add_argument("--batch-calls", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("hop_loop_tracing: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = harness.manifest()
    config = harness.load_json(ROOT / next(c["file"] for c in bench["configs"]
                                           if c["name"] == "nytimes-256-angular"))
    dev = torch.device("cuda:0")
    corpus, queries = data.draw(config, args.seed, dev)
    t0 = time.perf_counter()
    index = Hnsw.generate(DenseSource(vectors=corpus), None, build_params(config), Metric(config["metric"]))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sp = search_params(config)
    for batch in (100, 10_000):  # warm both shapes
        _timed_calls(index, queries, batch, 2, sp, 0)

    runs = {(batch, on): [] for batch in (100, 10_000) for on in (False, True)}
    try:
        for turn, on in enumerate((False, True, True, False)):
            TRACER.enabled, TRACER.log = on, None
            runs[(100, on)] += _timed_calls(index, queries, 100, args.online, sp, turn * args.online)
            runs[(10_000, on)] += _timed_calls(index, queries, 10_000, args.batch_calls, sp, turn)
    finally:
        TRACER.enabled = False
    result = {"device": card, "torch": torch.__version__, "seed": args.seed, "build_s": build_s}
    for batch in (100, 10_000):
        off_ms = [1e3 * s for s, _ in runs[(batch, False)]]
        on_ms = [1e3 * s for s, _ in runs[(batch, True)]]
        result[f"batch_{batch}"] = {
            "calls_each": len(off_ms),
            "median_ms_off": statistics.median(off_ms),
            "median_ms_on": statistics.median(on_ms),
            "tracing_cost_pct": 100.0 * (statistics.median(on_ms) / statistics.median(off_ms) - 1.0),
            "spans": _spans_per_call(runs[(batch, True)]),
            "search_instrumented_hops": index.search_instrumented(queries[:batch], sp)[2]["hops"],
        }
    line = json.dumps(result)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"hop_loop_tracing_{args.seed}.json").write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
