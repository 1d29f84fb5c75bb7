"""What replaying the hop from a CUDA graph costs and saves, a hop.

Builds the index of the benchmark's ``nytimes-256-angular`` configuration
(290,000 x 256 angular, ``BuildParams()``, drawn from ``--seed`` as the
benchmark draws it), then, at 100 and 8,192 queries a call:

* the hops of each layer search on the eager loop (what
  ``hop_graph.CAPTURE_AFTER_HOPS`` is chosen from);
* the cost of one capture (host milliseconds, from an empty cache) and the
  device memory the graphs hold after the build, after an online call and
  after a batch call (10,000 queries: blocks of 8,192 and 1,808);
* that the replayed and the eager loop answer alike, bit for bit;
* calls on the eager and the replayed loop in turns (eager, replayed,
  replayed, eager) with ``TRACER`` on: wall milliseconds a call, and host
  microseconds a hop of dispatch and of wait (the ``search_layer`` spans);
* device microseconds a hop on both loops (``torch.profiler``, device busy
  time over the hops), and of a replay alone (CUDA events around replays
  of the bottom layer's graph, back to back); the host microseconds of one
  ``replay()`` call with and without the profiler.

The eager loop is reached through ``hop_graph``'s rule, patched to refuse
every hop.  Run on a CUDA machine from the repo root::

    python3 studies/hop_graph.py --seed 2147483659
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

from benchmark import data, harness, profiling  # noqa: E402
from benchmark.drivers import build_params, search_params  # noqa: E402
from parallel_hnsw_tpu_torch import DenseSource, Hnsw, Metric, hop_graph  # noqa: E402
from parallel_hnsw_tpu_torch.utils.trace import TRACER  # noqa: E402

BATCHES = (100, 8192)


class _Eager:
    """Inside it, ``hop_graph``'s rule refuses every hop."""

    def __enter__(self):
        self.rule = hop_graph.should_capture
        hop_graph.should_capture = lambda device_type, kind, rows, hops_run: False

    def __exit__(self, *exc):
        hop_graph.should_capture = self.rule


def _call(index, queries, batch, i, sp):
    offset = (i * batch) % (queries.shape[0] - batch + 1)
    ids, dists = index.search(queries[offset : offset + batch], sp)
    return ids[:, :10].cpu(), dists[:, :10].cpu()


def _timed_calls(index, queries, batch, calls, sp, start):
    """Per call: (seconds, search_layer counters of the call)."""
    out = []
    for i in range(start, start + calls):
        TRACER.events.clear()
        t0 = time.perf_counter()
        _call(index, queries, batch, i, sp)
        out.append((time.perf_counter() - t0,
                    [e.counters for e in TRACER.events if e.name == "search_layer"]))
    TRACER.events.clear()
    return out


def _per_hop(calls):
    hops = sum(c["hops"] for _, ev in calls for c in ev)
    return {
        "call_ms_median": 1e3 * statistics.median(s for s, _ in calls),
        "hops_per_call": hops / len(calls),
        "graph_hop_share_pct": 100.0 * sum(c["graph_hops"] for _, ev in calls for c in ev) / hops,
        "captures": sum(c["captures"] for _, ev in calls for c in ev),
        "dispatch_us_per_hop": 1e6 * sum(c["dispatch_s"] for _, ev in calls for c in ev) / hops,
        "wait_us_per_hop": 1e6 * sum(c["wait_s"] for _, ev in calls for c in ev) / hops,
    }


def _layer_hops(index, queries, batch, calls, sp):
    """Eager hops of each layer (from the top) over ``calls`` calls."""
    with _Eager():
        runs = _timed_calls(index, queries, batch, calls, sp, 0)
    layers = {}
    for _, ev in runs:
        for c in ev:
            layers.setdefault(int(c["layer"]), []).append(int(c["hops"]))
    return {layer: {"min": min(h), "median": statistics.median(h), "max": max(h)}
            for layer, h in sorted(layers.items())}


def _device_us_per_hop(index, queries, batch, calls, sp):
    """Device busy microseconds a hop over ``calls`` calls under the profiler."""
    hops = []

    def run():
        TRACER.events.clear()
        for i in range(calls):
            _call(index, queries, batch, i, sp)
        hops.append(sum(e.counters["hops"] for e in TRACER.events if e.name == "search_layer"))
        return calls

    trace = profiling.traced(run, profiling.HostSpans())
    return {"busy_us_per_hop": 1e6 * trace.busy_s / hops[0],
            "kernel_us_per_hop": 1e6 * trace.kernel_s / hops[0]}


def _graph_memory():
    """The cached graphs: how many, the bytes of their static buffers, and
    the bytes of the segments of their memory pools."""
    graphs = list(hop_graph.HOP_GRAPHS._graphs.values())
    pools = set(hop_graph.HOP_GRAPHS._pools.values())
    return {
        "graphs": len(graphs),
        "buffer_bytes": sum(t.numel() * t.element_size()
                            for g in graphs for t in (g.queries, g.all_done) + g.buffers),
        "pool_bytes": sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                          if tuple(seg.get("segment_pool_id", ())) in pools),
    }


def _replay_us(graph, replays=200):
    """Device microseconds of one replay, back to back (the state runs on
    past convergence: every update is masked by ``done``, the work is not),
    and host microseconds of one ``replay()`` call, each replay waited for,
    without and with ``torch.profiler`` tracing device activity as the
    benchmark's traced window does."""
    with hop_graph.HOP_GRAPHS.on_stream(graph.queries.device):  # where a search replays it
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        graph.replay()
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        out = {"replay_alone_us": 1e3 * start.elapsed_time(end) / replays}

        def host_us():
            seconds = 0.0
            for _ in range(replays):
                t = time.perf_counter()
                graph.replay()
                seconds += time.perf_counter() - t
                torch.cuda.synchronize()
            return 1e6 * seconds / replays

        out["replay_call_host_us"] = host_us()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            out["replay_call_host_us_profiled"] = host_us()
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--online", type=int, default=40)
    parser.add_argument("--batch-calls", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("hop_graph: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = harness.manifest()
    config = harness.load_json(ROOT / next(c["file"] for c in bench["configs"]
                                           if c["name"] == "nytimes-256-angular"))
    dev = torch.device("cuda:0")
    corpus, queries = data.draw(config, args.seed, dev)
    # the captures, each timed alone: the build's, then from an empty cache
    captures = []
    capture = hop_graph.HopGraph.capture

    def timed_capture(self, pool):
        torch.cuda.synchronize()
        t = time.perf_counter()
        capture(self, pool)
        torch.cuda.synchronize()
        captures.append((self.queries.shape[0], 1e3 * (time.perf_counter() - t)))

    hop_graph.HopGraph.capture = timed_capture
    t0 = time.perf_counter()
    try:
        index = Hnsw.generate(DenseSource(vectors=corpus), None, build_params(config),
                              Metric(config["metric"]))
        torch.cuda.synchronize()
    finally:
        hop_graph.HopGraph.capture = capture
    build_captures = {"count": len(captures), "ms": sum(ms for _, ms in captures),
                      "rows": sorted({q for q, _ in captures})}
    captures.clear()
    result = {"device": card, "torch": torch.__version__, "seed": args.seed,
              "build_s": time.perf_counter() - t0, "build_captures": build_captures,
              "layers": [layer.node_count for layer in index.layers],
              "capture_after_hops": hop_graph.CAPTURE_AFTER_HOPS}
    sp = search_params(config)
    TRACER.enabled, TRACER.log = True, None
    calls_of = {100: args.online, 8192: args.batch_calls}

    result["graph_memory"] = {"build": _graph_memory()}  # the build's own searches
    with _Eager():  # the eager calls' own memory, reserved before the count
        for batch in (100, 10_000):
            _call(index, queries, batch, 0, sp)
    hop_graph.HopGraph.capture = timed_capture
    try:
        for cell, batch in (("online", 100), ("batch", 10_000)):
            hop_graph.HOP_GRAPHS.clear()
            _call(index, queries, batch, 0, sp)
            torch.cuda.synchronize()
            result["graph_memory"][cell] = _graph_memory()
    finally:
        hop_graph.HopGraph.capture = capture
    result["captures_ms"] = captures
    hop_graph.HOP_GRAPHS.clear()

    for batch in BATCHES:
        row = {"layer_hops_eager": _layer_hops(index, queries, batch, min(calls_of[batch], 20), sp)}
        # the same answers, call by call
        same = True
        for i in range(3):
            with _Eager():
                want = _call(index, queries, batch, i, sp)
            got = _call(index, queries, batch, i, sp)
            same &= all(torch.equal(a, b) for a, b in zip(want, got))
        row["bit_identical"] = same
        runs = {False: [], True: []}
        for turn, graphs in enumerate((False, True, True, False)):
            start = turn * calls_of[batch]
            if graphs:
                runs[True] += _timed_calls(index, queries, batch, calls_of[batch], sp, start)
            else:
                with _Eager():
                    runs[False] += _timed_calls(index, queries, batch, calls_of[batch], sp, start)
        row["eager"] = _per_hop(runs[False])
        row["replayed"] = _per_hop(runs[True])
        n = min(calls_of[batch], 10)
        with _Eager():
            row["eager"].update(_device_us_per_hop(index, queries, batch, n, sp))
        row["replayed"].update(_device_us_per_hop(index, queries, batch, n, sp))
        bottom = [g for key, g in hop_graph.HOP_GRAPHS._graphs.items() if key[1][0] == batch]
        if bottom:
            row["replayed"].update(_replay_us(bottom[-1]))
        result[f"batch_{batch}"] = row
    TRACER.enabled = False
    result["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
    line = json.dumps(result)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"hop_graph_{args.seed}.json").write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
