"""Host spans around the benchmark's calls into the program, and the
reduction of a ``torch.profiler`` trace of the traced window to the device's
busy time, its kernels by name and its idle gaps.

Host spans are stamped with ``time.time_ns()``, the clock the profiler's
events are stamped with, so an idle gap on the device is labelled by the
span the host was in at the gap's middle.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

#: the labels a gap gets where the host was in none of the spans
OUTSIDE = "between_calls"
#: a kernel's name in the breakdown is cut to this many characters
NAME_CHARS = 160


class HostSpans:
    """Named host intervals, recorded only while ``enabled``."""

    def __init__(self) -> None:
        self.enabled = False
        self.spans: List[Tuple[int, int, str]] = []

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), name))

    def label(self, t_ns: float) -> str:
        """The innermost span open at ``t_ns``."""
        best = None
        for t0, t1, name in self.spans:
            if t0 <= t_ns <= t1 and (best is None or t0 >= best[0]):
                best = (t0, name)
        return best[1] if best else OUTSIDE


@dataclass
class Trace:
    """The traced window, reduced."""

    window_s: float
    busy_s: float
    kernel_s: float  # the kernels alone: no copies or fills
    calls: int
    ops: List[Tuple[str, float]] = field(default_factory=list)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def idle_share(self) -> float:
        """Share of the window, in %, in which nothing ran on the device."""
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def traced(run: Callable[[], int], spans: HostSpans) -> Trace:
    """Run ``run`` (which returns the number of calls it made) under the
    profiler, device activity only, with ``spans`` recording; the window is
    from the moment the profiler runs to the end of ``run``'s device work."""
    torch.cuda.synchronize()
    spans.enabled = True
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.time_ns()
        calls = run()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    spans.enabled = False
    events = [
        (e.name(), e.start_ns(), e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0
    ]
    if not events:
        raise RuntimeError("the profiler recorded no device activity in the traced window")
    return reduce(events, t0, t1, spans, calls)


def reduce(
    events: List[Tuple[str, int, int]], t0: int, t1: int, spans: HostSpans, calls: int
) -> Trace:
    """The window ``[t0, t1]`` (ns) from its device events ``(name, start_ns,
    duration_ns)``: busy time (the union of the events' intervals), the
    kernels' own time, the ten largest operations by name, and the idle
    gaps summed by the host span each fell in."""
    by_name: Dict[str, float] = defaultdict(float)
    intervals = []
    kernel_ns = 0
    for name, start, dur in events:
        by_name[name] += dur * 1e-9
        if not _is_copy(name):
            kernel_ns += dur
        intervals.append((max(start, t0), min(start + dur, t1)))
    intervals.sort()
    busy = 0
    gaps_by_label: Dict[str, List[float]] = defaultdict(list)
    cursor = t0
    for start, end in intervals:
        if end <= cursor:
            continue
        if start > cursor:
            gaps_by_label[spans.label((cursor + start) / 2)].append((start - cursor) * 1e-9)
            cursor = start
        busy += end - cursor
        cursor = end
    if t1 > cursor:
        gaps_by_label[spans.label((cursor + t1) / 2)].append((t1 - cursor) * 1e-9)
    ops = [(name[:NAME_CHARS], secs) for name, secs in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    # per label: its idle seconds in all, and how many gaps they came in
    gaps = sorted(
        ((f"{label} ({len(g)} gaps)", sum(g)) for label, g in gaps_by_label.items()),
        key=lambda kv: -kv[1],
    )[:10]
    return Trace(
        window_s=(t1 - t0) * 1e-9,
        busy_s=busy * 1e-9,
        kernel_s=kernel_ns * 1e-9,
        calls=calls,
        ops=ops,
        gaps=gaps,
    )


def idle_share(trace: Optional[Trace]) -> Optional[float]:
    return None if trace is None else trace.idle_share
