"""API-surface smoke test of the port: every public method of the parity
surface runs (mirrors tests/test_api_surface.py, and the interrupt case of
tests/test_optimize.py).  Deep semantics are covered by the dedicated suites.
On the CPU: the entry points that create tensors are given ``device="cpu"``."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from parallel_hnsw_tpu_torch import (
    BuildParams,
    DenseSource,
    Hnsw,
    Metric,
    OptimizationParams,
    SearchParams,
)
from parallel_hnsw_tpu_torch.utils.data import make_random_hnsw, random_unit_corpus

BP = BuildParams(
    order=6,
    neighborhood_size=4,
    zero_layer_neighborhood_size=8,
    optimization=OptimizationParams(recall_proportion=1.0),
)


@pytest.fixture(scope="module")
def hnsw():
    source = random_unit_corpus(120, 16, seed=2, device="cpu")
    return Hnsw.generate(source, None, BP, Metric.NORMALIZED_COSINE, seed=2)


def test_accessors(hnsw):
    assert hnsw.layer_count >= 1
    assert hnsw.vector_count == 120
    assert len(hnsw) == 120
    assert 0 <= hnsw.entry_vector < 120
    assert hnsw.get_layer(0) is hnsw.layers[-1]
    assert hnsw.get_layer_from_top(0) is hnsw.layers[0]
    assert hnsw.get_layer_from_top(99) is None
    assert len(hnsw.all_vectors()) == 120
    assert len(hnsw.supers_for_layer(0)) >= 1


def test_search_variants(hnsw):
    q = hnsw.source.vectors[:5]
    ids, dists = hnsw.search(q)
    assert ids.shape == dists.shape
    ids2, d2, stats = hnsw.search_instrumented(q)
    assert stats["hops"] > 0 and stats["distance_evaluations"] > 0
    assert stats["last_improvement_hop"].shape == (5,)
    np.testing.assert_array_equal(ids.numpy(), ids2.numpy())
    su_ids, _ = hnsw.search_upto(q, upto_layer_from_top=1)
    assert su_ids.shape[0] == 5
    # default = full depth: same results as search() (src/lib.rs:654-665:
    # search() IS search_layers over the whole stack)
    full_ids, _ = hnsw.search_upto(q)
    np.testing.assert_array_equal(ids.numpy(), full_ids.numpy())
    # 0 layers has no entry point; the reference panics (src/search.rs:9-11),
    # the port raises
    with pytest.raises(ValueError):
        hnsw.search_upto(q, upto_layer_from_top=0)
    with pytest.raises(ValueError):
        hnsw.search_upto(q, upto_layer_from_top=hnsw.layer_count + 1)
    si_ids, _ = hnsw.search_ids(torch.arange(5), exclude_self=True)
    for i in range(5):
        assert i not in si_ids[i].numpy()
    ex_ids, ex_d = hnsw.search_exact(q, k=3)
    np.testing.assert_array_equal(ex_ids[:, 0].numpy(), np.arange(5))


def test_quality_and_repair(hnsw):
    assert 0.0 <= hnsw.stochastic_recall() <= 1.0
    assert 0.0 <= hnsw.stochastic_recall_at(0) <= 1.0
    unreachable = hnsw.discover_unreachable_vectors(hnsw.layer_count - 1)
    assert isinstance(unreachable, np.ndarray)
    hops, isum = hnsw.node_distances_for_layer(0)
    assert hops.shape == (120,)
    promote = hnsw.discover_nodes_to_promote(0)
    assert isinstance(promote, np.ndarray)
    reach = hnsw.reachables_from_node_for_layer(hnsw.layer_count - 1, 0, [0, 1, 2])
    assert reach[0][0] == 0
    hnsw.assert_invariants()


def test_selfsim(hnsw):
    vec_ids, nn_ids, nn_d = hnsw.knn(3, probe_depth=1)
    assert nn_ids.shape == (120, 3)
    vec_ids, nn_ids, nn_d = hnsw.threshold_nn(0.4, probe_depth=1)
    assert nn_ids.shape[0] == 120


def test_make_random_hnsw():
    h = make_random_hnsw(60, 8, bp=BP, seed=1, device="cpu")
    assert h.vector_count == 60
    assert h.metric == Metric.NORMALIZED_COSINE and h.source.device.type == "cpu"


def test_progress_events_and_checkpoint(tmp_path):
    from parallel_hnsw_tpu_torch import CallbackProgressMonitor
    from parallel_hnsw_tpu_torch.io import deserialize_hnsw

    events = []
    mon = CallbackProgressMonitor(on_update=events.append)
    source = random_unit_corpus(80, 8, seed=5, device="cpu")
    h = Hnsw.generate(
        source, None, BP, Metric.NORMALIZED_COSINE, seed=5,
        progress=mon, checkpoint_dir=str(tmp_path / "ckpt"),
    )
    kinds = {e["type"] for e in events}
    assert "layer_built" in kinds and "improved" in kinds
    loaded = deserialize_hnsw(tmp_path / "ckpt", source=source)
    assert loaded.layer_count == h.layer_count


def test_cancellation():
    from parallel_hnsw_tpu_torch import CallbackProgressMonitor, Interrupt

    mon = CallbackProgressMonitor(is_cancelled=lambda: True)
    source = random_unit_corpus(80, 8, seed=5, device="cpu")
    with pytest.raises(Interrupt):
        Hnsw.generate(source, None, BP, Metric.NORMALIZED_COSINE, progress=mon)


def test_interrupt_cancels_improve_index():
    """A monitor raising Interrupt stops improve_index mid-loop (reference
    threads &mut dyn ProgressMonitor through, src/lib.rs:1551-1554)."""
    from parallel_hnsw_tpu_torch.progress import Interrupt, ProgressMonitor

    class CountdownMonitor(ProgressMonitor):
        def __init__(self, n):
            self.n = n
            self.calls = 0

        def alive(self):
            self.calls += 1
            if self.calls > self.n:
                raise Interrupt()

    src = random_unit_corpus(120, 8, seed=3, device="cpu")
    hnsw = Hnsw.generate(src, None, BP, Metric.COSINE, seed=0, improve=False)
    mon = CountdownMonitor(1)
    with pytest.raises(Interrupt):
        hnsw.improve_index(progress=mon)
    assert mon.calls == 2


class ScaledSource(NamedTuple):
    """A storage type of the user's: rows scaled on the way out."""

    vectors: torch.Tensor
    scale: float

    @property
    def dim(self):
        return self.vectors.shape[1]

    @property
    def count(self):
        return self.vectors.shape[0]

    @property
    def device(self):
        return self.vectors.device


def test_custom_source_registration():
    # the Comparator-trait seam: user storage via @source_get.register alone
    from parallel_hnsw_tpu_torch import analysis, graph
    from parallel_hnsw_tpu_torch.graph import source_get

    @source_get.register
    def _(source: ScaledSource, ids):
        safe = torch.clamp(ids, 0, source.vectors.shape[0] - 1)
        return source.vectors[safe.long()] * source.scale

    base = random_unit_corpus(90, 8, seed=3, device="cpu")
    src = ScaledSource(vectors=base.vectors, scale=1.0)
    h = Hnsw.generate(src, None, BP, Metric.NORMALIZED_COSINE, seed=3)
    ids, _ = h.search(base.vectors[:4])
    np.testing.assert_array_equal(ids[:, 0].numpy(), np.arange(4))
    # the dispatchers' defaults, built on source_get
    assert graph.source_effective_width(src) == 128
    assert torch.equal(graph.materialize_source(src), base.vectors)
    cand = torch.tensor([[0, 5, 2**31 - 1], [89, 90, -1]], dtype=torch.int32)
    got = graph.source_distance(src, base.vectors[:2], cand, Metric.NORMALIZED_COSINE)
    want = graph.source_distance(base, base.vectors[:2], cand, Metric.NORMALIZED_COSINE)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert torch.isinf(got[0, 2]) and torch.isinf(got[1, 1:]).all()
    f_ids, _ = analysis.fast_flat_knn(src, base.vectors[:4], Metric.NORMALIZED_COSINE, 3)
    np.testing.assert_array_equal(f_ids[:, 0].numpy(), np.arange(4))
    # an unregistered type still raises where the JAX package's does
    with pytest.raises(TypeError):
        source_get(object(), torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("fn", ["source_distance", "source_effective_width", "materialize_source"])
def test_unknown_source_type_raises(fn):
    """A type that registered nothing with ``source_get`` raises in each
    dispatcher, as the JAX package's path raises once it reaches source_get."""
    from parallel_hnsw_tpu_torch import graph

    q = torch.zeros(1, 4)
    args = {"source_distance": (q, torch.zeros(1, 2, dtype=torch.int32), Metric.DOT)}.get(fn, ())
    with pytest.raises(TypeError, match="unknown source type"):
        getattr(graph, fn)(object(), *args)
