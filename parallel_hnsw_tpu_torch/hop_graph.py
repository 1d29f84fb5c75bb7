"""One hop of the lockstep layer search, replayed from a CUDA graph.

On the card a hop of :func:`~parallel_hnsw_tpu_torch.search.search_one_layer`
over a dense source or a hop slab (:func:`fuses`) is two hand-written
launches, the expand and the queue merge, each of which the host dispatches
in 15-20 us.  A CUDA graph captures the hop once and replays it with one
launch.

:class:`HopGraph` holds the state the hop reads and writes in static
buffers, a ``LayerSearchState`` whose ``hops`` is a device counter: the
queues, expanded flags, probes, ``done``, the evaluation count, the
improvement hops, the frontier, and beside them the layer's queries.  Its hop
(:meth:`HopGraph.step`) is the eager hop's body, the same kernels in the same
order, which updates every buffer in place (the expand advances the counter),
so every replay advances the state and the state after ``n`` replays is the
eager loop's after ``n`` hops, bit for bit.  The same hop keeps one flag of
whether every row is done (the expand sets it, the merge clears it where a
row is still going), so the host's termination read is one small copy and no
extra launch.

A layer search captures (:func:`should_capture`) where the hop runs wholly on
a CUDA device (a dense source, a hop slab or the routing rows; a memmap or PQ
source, a CPU tensor and the adaptive compacting path stay eager), the block
holds at most ``MAX_GRAPH_ROWS`` rows, and the search has run
``CAPTURE_AFTER_HOPS`` eager hops without converging, so a layer that
converges in a few hops never pays for a capture.

Graphs live in a bounded cache (:class:`HopGraphCache`) keyed by everything
the hop reads by address (each tensor's data pointer, shape, strides and
type) and its static sizes.  An entry holds none of those tensors: it is
dropped when any of them is freed, so a dropped index takes its graphs with
it and no address can be reused under a graph.  An in-place edit of a cached
tensor is seen at the next replay; a replaced tensor is a new key.  The
graphs of a device share one memory pool and one stream, and one search at a
time holds them (:meth:`HopGraphCache.lock`): every capture and replay of a
device runs in turn on that stream, and a search that finds the device's
graphs in use runs its hops eagerly.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, Hashable, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch

from parallel_hnsw_tpu_torch.graph import DenseSource, Layer, MemmapSource, PqSource
from parallel_hnsw_tpu_torch.ops import cuda_distance, cuda_gather, cuda_queues, cuda_scan
from parallel_hnsw_tpu_torch.ops.distance import Metric

#: the largest block captured: ``search.auto_query_block``'s cap, so every
#: block the default blocking makes may capture.  A graph's scratch pool grows
#: with its rows (333 MB for the 8,192 and 1,808-row graphs of a 290k x 256
#: index at ef 300 on an H100); blocks above the cap stay eager to bound it
MAX_GRAPH_ROWS = 8192
#: eager hops a layer search runs before it captures its hop
CAPTURE_AFTER_HOPS = 8
#: graphs kept; the least recently used goes first
CACHE_ENTRIES = 16
#: the sources whose hop runs wholly on the device
GRAPH_KINDS = ("dense", "slab")
#: the kernel launch counters: a capture adds nothing to them (it runs
#: nothing on the card) and each replay adds what its capture launched
_LAUNCH_COUNTERS = (cuda_distance.LAUNCHES, cuda_scan.LAUNCHES, cuda_queues.LAUNCHES,
                    cuda_gather.LAUNCHES)


def source_kind(source, slab: Optional[torch.Tensor]) -> str:
    """What the hop's distances read: ``"slab"``, ``"dense"`` (a
    :class:`DenseSource`: full rows or routing rows), ``"memmap"``, ``"pq"``
    or ``"other"`` (a source type of the user's)."""
    if slab is not None:
        return "slab"
    if isinstance(source, DenseSource):
        return "dense"
    if isinstance(source, MemmapSource):
        return "memmap"
    if isinstance(source, PqSource):
        return "pq"
    return "other"


def fuses(device_type: str, kind: str) -> bool:
    """Whether a hop on ``device_type`` reading a ``kind`` source runs as the
    two hop launches (``search._layer_step_fns``)."""
    return device_type == "cuda" and kind in GRAPH_KINDS


def should_capture(device_type: str, kind: str, rows: int, hops_run: int) -> bool:
    """Whether a layer search over ``rows`` queries on ``device_type``,
    reading a ``kind`` source, that has run ``hops_run`` eager hops without
    converging captures its hop: a hop of two launches, at most
    ``MAX_GRAPH_ROWS`` rows."""
    return (fuses(device_type, kind) and 0 < rows <= MAX_GRAPH_ROWS
            and hops_run >= CAPTURE_AFTER_HOPS)


def _address(t: torch.Tensor) -> Tuple:
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)


def graph_key(
    layer: Layer,
    source,
    slab: Optional[torch.Tensor],
    queries: torch.Tensor,
    cap: int,
    beam_width: int,
    metric: Metric,
    probe_depth: int,
) -> Optional[Hashable]:
    """The cache key of a layer search's hop, or ``None`` where it stays
    eager: a hop that :func:`should_capture` refuses however many hops it
    runs, or a neighbor table that is not contiguous (the hop reads a fresh
    copy of it each search)."""
    if not should_capture(queries.device.type, source_kind(source, slab), queries.shape[0],
                          CAPTURE_AFTER_HOPS):
        return None
    if not layer.neighbors.is_contiguous():
        return None
    return (str(queries.device), tuple(queries.shape), queries.dtype, cap, beam_width,
            Metric(metric), probe_depth) + tuple(_address(t) for t in key_tensors(layer, source, slab))


def key_tensors(layer: Layer, source, slab: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The tensors a graphed hop reads by address: the layer's nodes and
    neighbors, and the hop slab or the dense source's rows."""
    return (layer.nodes, layer.neighbors, slab if slab is not None else source.vectors)


class HopGraph:
    """A layer search's state in static buffers and the hop that advances it
    in place, replayed from a CUDA graph once :meth:`capture` has run.

    ``make_body(all_done)`` builds the eager hop over the static ``queries``
    buffer: a function that advances a ``LayerSearchState`` in place (its
    ``hops`` here is the device counter) and returns it, and which leaves
    ``all_done`` reading whether every row is done.  It is called once, inside the
    capture, so whatever it allocates lives in the graph's pool, and dropped
    after it, so the graph holds none of the tensors it reads.  ``like`` is a
    ``LayerSearchState`` whose tensors give the buffers' shapes and types."""

    def __init__(self, make_body: Callable[[torch.Tensor], Callable], like: NamedTuple,
                 queries: torch.Tensor):
        dev = queries.device
        self.queries = queries
        self.buffers = type(like)(*(
            torch.zeros((), dtype=torch.int32, device=dev) if field == "hops" else torch.empty_like(value)
            for field, value in zip(like._fields, like)))
        self.all_done = torch.zeros((), dtype=torch.bool, device=dev)
        self._make_body = make_body
        self._body = None
        self.graph = None
        #: kernel launches of one hop, as the capture counted them
        self.launches = [{} for _ in _LAUNCH_COUNTERS]

    def load(self, state: NamedTuple, queries: torch.Tensor) -> None:
        """Copy a layer search's state, its host hop count into the device
        counter, and its queries into the buffers."""
        self.queries.copy_(queries)
        for buf, value in zip(self.buffers, state):
            if isinstance(value, torch.Tensor):
                buf.copy_(value)
            else:
                buf.fill_(value)
        torch.all(self.buffers.done, out=self.all_done)

    def step(self) -> None:
        """One hop: the eager hop's kernels on the buffers and on
        :attr:`all_done`, all of them updated in place, so a replay copies
        nothing."""
        if self._body is None:
            self._body = self._make_body(self.all_done)
        out = self._body(self.buffers)
        if not all(value is buf for buf, value in zip(self.buffers, out)):
            raise RuntimeError("the hop did not update its buffers in place")

    def capture(self, pool) -> None:
        """Capture :meth:`step` into a graph on the current stream (not the
        device's default stream), with its scratch from ``pool`` (a new pool
        where ``None``).  Nothing runs: the buffers are left as they were, and
        the launch counters too."""
        before = [dict(counts) for counts in _LAUNCH_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        try:
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.step()
            finally:
                graph.capture_end()
        finally:
            self._make_body = self._body = None
            for counts, was, launched in zip(_LAUNCH_COUNTERS, before, self.launches):
                launched.update({k: n - was[k] for k, n in counts.items() if n != was[k]})
                counts.update(was)
        self.graph = graph

    def replay(self) -> None:
        """One hop, one graph launch on the current stream."""
        self.graph.replay()
        for counts, launched in zip(_LAUNCH_COUNTERS, self.launches):
            for name, n in launched.items():
                counts[name] += n

    def state(self, hops: int) -> NamedTuple:
        """The state after ``hops`` hops, copied out of the buffers (the next
        layer search of this key overwrites them)."""
        return self.buffers._replace(hops=hops, **{
            field: value.clone() for field, value in zip(self.buffers._fields, self.buffers)
            if field != "hops"})


class HopGraphCache:
    """At most ``capacity`` captured hops by key, the least recently used
    dropped first, and any whose watched tensors are freed.  On each device
    the first graph's memory pool holds every later graph's scratch too, for
    as long as a graph holds it (a pool no graph holds cannot take another
    capture); the device's graphs are captured and replayed on one stream, by
    one search at a time (:meth:`lock`, :meth:`on_stream`)."""

    def __init__(self, capacity: int = CACHE_ENTRIES):
        self.capacity = capacity
        self._graphs: "OrderedDict[Hashable, HopGraph]" = OrderedDict()
        self._finalizers = {}
        self._pools = {}
        self._streams = {}
        self._locks = {}
        self._mutex = threading.RLock()

    def lock(self, device: torch.device) -> threading.Lock:
        """The lock a search holds while it captures or replays the graphs of
        ``device``."""
        with self._mutex:
            return self._locks.setdefault(device, threading.Lock())

    @contextmanager
    def on_stream(self, device: torch.device) -> Iterator[Optional[torch.cuda.Stream]]:
        """Run the block on ``device``'s graph stream, after the work queued
        on the current stream, and queue the current stream's later work
        after it; yields the current stream (``None``, and nothing to do, off
        the card)."""
        if device.type != "cuda":
            yield None
            return
        with self._mutex:
            # one stream a device: the caching allocator hands a freed block
            # only to the stream it was allocated on, so captures into one
            # pool reuse each other's scratch only on one stream
            if device not in self._streams:
                self._streams[device] = torch.cuda.Stream(device)
            stream = self._streams[device]
        caller = torch.cuda.current_stream(device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            yield caller
        caller.wait_stream(stream)

    def get(self, key: Hashable) -> Optional[HopGraph]:
        with self._mutex:
            graph = self._graphs.get(key)
            if graph is not None:
                self._graphs.move_to_end(key)
            return graph

    def add(self, key: Hashable, graph: HopGraph, watch: Sequence[torch.Tensor] = ()) -> HopGraph:
        """Capture ``graph`` and keep it under ``key`` until it is the least
        recently used of too many, or a tensor of ``watch`` is freed."""
        dev = graph.queries.device
        with self._mutex, self.on_stream(dev):
            graph.capture(self._pools.get(dev))
            self._pools.setdefault(dev, graph.graph.pool())
            self._graphs[key] = graph
            self._finalizers[key] = [weakref.finalize(t, self._drop, key, graph) for t in watch]
            while len(self._graphs) > self.capacity:
                self._drop(next(iter(self._graphs)))
        return graph

    def _drop(self, key: Hashable, graph: Optional[HopGraph] = None) -> None:
        """Drop the graph under ``key`` (only if it is ``graph``, when given),
        and its device's pool with its device's last graph."""
        with self._mutex:
            old = self._graphs.get(key)
            if old is None or (graph is not None and old is not graph):
                return
            del self._graphs[key]
            for fin in self._finalizers.pop(key, ()):
                fin.detach()
            dev = old.queries.device
            if all(g.queries.device != dev for g in self._graphs.values()):
                self._pools.pop(dev, None)

    def clear(self) -> None:
        """Drop every graph."""
        with self._mutex:
            for key in list(self._graphs):
                self._drop(key)

    def __len__(self) -> int:
        return len(self._graphs)


#: the process's captured hops
HOP_GRAPHS = HopGraphCache()
