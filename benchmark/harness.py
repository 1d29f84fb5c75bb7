"""One run of one cell: set-up, the measured window, the reading of the
trace, and the judgement of every answer against the plain reference.

Everything that belongs to one configuration, traffic mix, driver or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

* ``configs/<config>.json``: sizes, metric, parameters, the data drawn;
* ``traffic/<traffic>.json``: the mix's parameters and the driver it runs;
* ``drivers/<driver>.py``: a class ``Driver`` that calls the program;
* ``metrics/<metric>.py``: a function ``read(ctx)`` for a per-layer metric;
* ``workloads/<cell>.json``: the limits of the numbers that decide ``correct``.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import data, judge, profiling, reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path) -> ModuleType:
    """The module at ``path``, loaded by its file (metric files have dots in
    their names)."""
    name = "benchmark_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """What a driver and a metric reader are handed: the cell's files, its
    data on the device, and the log of its answers."""

    name: str
    config: dict
    traffic: dict
    device: torch.device
    corpus: torch.Tensor
    queries: torch.Tensor
    spans: profiling.HostSpans = field(default_factory=profiling.HostSpans)
    log: judge.AnswerLog = field(default_factory=judge.AnswerLog)

    @property
    def k(self) -> int:
        return self.config["k"]

    @property
    def metric(self) -> str:
        return self.config["metric"]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclass
class Window:
    seconds: float
    latencies: List[float]
    units: int

    @property
    def calls(self) -> int:
        return len(self.latencies)


def closed_loop(call: Callable[[int], int], seconds: float, max_calls: Optional[int] = None) -> Window:
    """One client, each call sent when the last has returned, every call
    begun within ``seconds`` run to its end; the window closes with the last."""
    latencies: List[float] = []
    units = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds and (max_calls is None or len(latencies) < max_calls):
        ts = time.perf_counter()
        units += call(len(latencies))
        latencies.append(time.perf_counter() - ts)
    return Window(time.perf_counter() - t0, latencies, units)


def _rate(run: SimpleNamespace) -> float:
    return run.window.units / run.window.seconds


#: the end-to-end metrics, each read from the run by the benchmark itself
END_TO_END: Dict[str, Callable[[SimpleNamespace], float]] = {
    "qps": _rate,
    "build_vps": _rate,
    "latency_p90_ms": lambda run: float(np.percentile(run.window.latencies, 90)) * 1e3,
    "recall_at_10": lambda run: run.numbers["recall_at_10"],
    "setup_s": lambda run: run.setup_s,
}


def _for_cell(entries: List[dict], cell: str, reported: Optional[set] = None) -> List[dict]:
    """The metrics of ``entries`` that ``cell`` reports."""
    out = []
    for m in entries:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif reported is None or m["moves"] in reported:
            out.append(m)
    return out


def _power_limit() -> Optional[str]:
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return got.stdout.strip() or None


def cell_files(
    bench: dict, name: str, config_overrides: Optional[dict] = None, traffic_overrides: Optional[dict] = None
):
    """``(workload entry, configuration, traffic mix, limits)`` of the cell ``name``."""
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = {**load_json(ROOT / conf_entry["file"]), **(config_overrides or {})}
    traffic = {**load_json(HERE / "traffic" / f"{work['traffic']}.json"), **(traffic_overrides or {})}
    limits = load_json(HERE / "workloads" / f"{name}.json")["limits"]
    return work, config, traffic, limits


def run_cell(
    name: str,
    seed: int,
    seconds: float,
    trace: bool,
    device: str = "cuda",
    t_start: Optional[float] = None,
    config_overrides: Optional[dict] = None,
    traffic_overrides: Optional[dict] = None,
    log: Callable[[str], None] = lambda s: None,
) -> dict:
    """The result line's object for one run.  ``t_start`` is when the
    process began (``setup_s`` counts from it); the overrides shrink a cell
    for the CPU tests and are never given on the chip."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = manifest()
    work, config, traffic, limits = cell_files(bench, name, config_overrides, traffic_overrides)
    end_to_end = _for_cell(bench["end_to_end"], name)
    per_layer = _for_cell(bench["per_layer"], name, {m["name"] for m in end_to_end})
    dev = torch.device(device)

    corpus, queries = data.draw(config, seed, dev)
    cell = Cell(name, config, traffic, dev, corpus, queries)
    driver = load_module(HERE / "drivers" / f"{traffic['driver']}.py").Driver(cell)
    driver.setup()
    cell.sync()
    cell.log = judge.AnswerLog()  # the warm call's answers are not the window's
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    # --trace 1: a shorter window under the profiler, with the program's spans on
    max_calls = traffic["trace_calls"] if trace else None
    if trace:
        from parallel_hnsw_tpu_torch.utils.trace import TRACER as tracer

        tracer.events.clear()
        tracer.enabled, tracer.log = True, None
    tr = None
    if trace and dev.type == "cuda":
        box = {}

        def traced_calls() -> int:
            box["window"] = closed_loop(driver.call, seconds, max_calls)
            return box["window"].calls

        tr = profiling.traced(traced_calls, cell.spans)
        window = box["window"]
    else:
        window = closed_loop(driver.call, seconds, max_calls)
    if trace:
        tracer.enabled = False
    cell.sync()
    log(f"window {window.seconds:.3f} s, {window.calls} calls")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    extra = driver.finish()
    per_layer_values = {}
    if trace:
        ctx = SimpleNamespace(cell=cell, driver=driver, trace=tr, spans=tracer.summary())
        for m in per_layer:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(ctx)
            if value is not None:
                per_layer_values[m["name"]] = {"value": value, "unit": m["unit"]}
    driver.free()
    del driver
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    with reference.matmul_precision(False):
        ref_ids, ref_dists = reference.exact_topk(corpus, queries, cell.metric, cell.k)
        numbers = judge.judge(cell.log, corpus, queries, ref_ids, ref_dists, cell.metric, cell.k)
    numbers.update(extra)
    log(f"reference and judgement {time.perf_counter() - t_ref:.3f} s")
    checks = judge.verdict(numbers, limits)
    run = SimpleNamespace(window=window, numbers=numbers, setup_s=setup_s)
    if trace:
        metrics = per_layer_values
    else:
        metrics = {m["name"]: {"value": END_TO_END[m["name"]](run), "unit": m["unit"]}
                   for m in end_to_end}
    result = {
        "correct": judge.is_correct(checks),
        "attempted": window.calls,
        "failed": int(numbers["failed_calls"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": work["chips"],
            "memory_peak_bytes": int(peak),
        },
    }
    if dev.type == "cuda":
        result["device"]["power_limit"] = _power_limit()
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": [list(o) for o in tr.ops],
                               "idle_gaps": [list(g) for g in tr.gaps]}
    result["checks"] = checks
    return result
