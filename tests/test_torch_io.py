"""The port's persistence against the JAX package's (mirrors the dense and
quantized cases of tests/test_serialize.py): either package reads what the
other wrote, and both write the same bytes.  Also where the port's entry points place
their tensors when no device is named."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_hnsw_tpu import io as jio
from parallel_hnsw_tpu.graph import DenseSource as JDenseSource, Layer as JLayer
from parallel_hnsw_tpu.graph import PqSource as JPqSource
from parallel_hnsw_tpu.index import Hnsw as JHnsw
from parallel_hnsw_tpu.params import build_params_from_dict as j_build_params_from_dict
from parallel_hnsw_tpu_torch import (
    BuildParams,
    DenseSource,
    Hnsw,
    Metric,
    OptimizationParams,
    PqBuildParams,
    PqSource,
    QuantizedHnsw,
)
from parallel_hnsw_tpu_torch import io as tio
from parallel_hnsw_tpu_torch.convert import (
    hnsw_from_numpy,
    hnsw_to_numpy,
    quantized_from_numpy,
    quantized_to_numpy,
)
from parallel_hnsw_tpu_torch.params import params_to_dict
from parallel_hnsw_tpu_torch.utils import data as tdata
from parallel_hnsw_tpu_torch.utils import device as tdevice

# one intra-op thread: torch's and XLA's CPU pools contend for the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def built():
    """One small index, built by the port, as both packages' objects."""
    source = tdata.random_unit_corpus(120, 8, device="cpu")
    bp = BuildParams(order=6, neighborhood_size=4, zero_layer_neighborhood_size=8,
                     optimization=OptimizationParams(recall_proportion=1.0))
    th = Hnsw.generate(source, None, bp, Metric.NORMALIZED_COSINE, seed=2)
    layers, vectors, metric, bp_dict = hnsw_to_numpy(th)
    jh = JHnsw(
        [JLayer(nodes=jnp.asarray(n), neighbors=jnp.asarray(nb)) for n, nb in layers],
        JDenseSource(vectors=jnp.asarray(vectors)), metric, j_build_params_from_dict(bp_dict),
    )
    assert th.layer_count >= 2
    return th, jh


def _assert_same_layers(a: Hnsw, b: Hnsw):
    assert a.layer_count == b.layer_count and a.metric == b.metric
    assert a.build_parameters == b.build_parameters
    for la, lb in zip(a.layers, b.layers):
        assert la.nodes.dtype == lb.nodes.dtype == torch.int32
        assert torch.equal(la.nodes, lb.nodes) and torch.equal(la.neighbors, lb.neighbors)


def _assert_same_index(a: Hnsw, b: Hnsw):
    _assert_same_layers(a, b)
    assert torch.equal(a.source.vectors, b.source.vectors)


def test_round_trip(built, tmp_path):
    th, _ = built
    tio.serialize_hnsw(th, tmp_path / "idx")
    loaded = tio.deserialize_hnsw(tmp_path / "idx", device="cpu")
    _assert_same_index(th, loaded)
    q = th.source.vectors[:5]
    (i1, d1), (i2, d2) = th.search(q), loaded.search(q)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    assert tio.read_index_meta(tmp_path / "idx")["format_version"] == tio.FORMAT_VERSION
    src = tio.deserialize_source(tmp_path / "idx" / "comparator", device="cpu")
    assert torch.equal(src.vectors, th.source.vectors)


def test_jax_writes_port_reads(built, tmp_path):
    th, jh = built
    jio.serialize_hnsw(jh, tmp_path / "idx", extra_meta={"build_seed": 2})
    loaded = tio.deserialize_hnsw(tmp_path / "idx", device="cpu")
    _assert_same_index(th, loaded)
    assert tio.read_index_meta(tmp_path / "idx")["build_seed"] == 2


def test_port_writes_jax_reads(built, tmp_path):
    th, jh = built
    tio.serialize_hnsw(th, tmp_path / "idx")
    loaded = jio.deserialize_hnsw(tmp_path / "idx")
    assert loaded.layer_count == jh.layer_count and loaded.metric == jh.metric
    assert loaded.build_parameters == jh.build_parameters
    for a, b in zip(jh.layers, loaded.layers):
        np.testing.assert_array_equal(np.asarray(a.nodes), np.asarray(b.nodes))
        np.testing.assert_array_equal(np.asarray(a.neighbors), np.asarray(b.neighbors))
    np.testing.assert_array_equal(np.asarray(jh.source.vectors), np.asarray(loaded.source.vectors))


def test_both_packages_write_the_same_bytes(built, tmp_path):
    th, jh = built
    tio.serialize_hnsw(th, tmp_path / "port", extra_meta={"corpus_count": 120})
    jio.serialize_hnsw(jh, tmp_path / "jax", extra_meta={"corpus_count": 120})
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert len(files) == 3 * th.layer_count + 3
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_layer_files_numbered_from_bottom(built, tmp_path):
    th, _ = built
    tio.serialize_hnsw(th, tmp_path / "idx")
    meta0 = json.loads((tmp_path / "idx" / "layer.meta.0").read_text())
    assert meta0["node_count"] == th.vector_count == 120


def test_missing_comparator(built, tmp_path):
    th, _ = built
    tio.serialize_hnsw(th, tmp_path / "idx", store_source=False)
    with pytest.raises(tio.IndexNotFound):
        tio.deserialize_hnsw(tmp_path / "idx", device="cpu")
    assert issubclass(tio.IndexNotFound, tio.SerializationError)
    # but works with an externally supplied source, on that source's device
    loaded = tio.deserialize_hnsw(tmp_path / "idx", source=th.source)
    _assert_same_index(th, loaded)
    assert loaded.layers[0].nodes.device == th.source.device


def test_meta_is_written_last_and_stale_meta_goes_first(built, tmp_path, monkeypatch):
    """An overwrite that dies mid-layer leaves no meta behind, so the
    directory never passes for a complete index."""
    th, _ = built
    tio.serialize_hnsw(th, tmp_path / "idx")
    assert (tmp_path / "idx" / "meta").exists()
    real, calls = tio._write_array, []

    def dying(path, arr, dtype):
        calls.append(path.name)
        if path.name.startswith("layer.neighbors"):
            raise OSError("disk full")
        real(path, arr, dtype)

    monkeypatch.setattr(tio, "_write_array", dying)
    with pytest.raises(OSError):
        tio.serialize_hnsw(th, tmp_path / "idx")
    assert calls[0] == "vectors" and not (tmp_path / "idx" / "meta").exists()
    with pytest.raises(FileNotFoundError):
        tio.read_index_meta(tmp_path / "idx")


@pytest.fixture(scope="module")
def resume_case():
    """A corpus, its parameters and an uninterrupted build of it."""
    source = tdata.random_unit_corpus(300, 8, device="cpu")
    bp = BuildParams(order=6, neighborhood_size=4, zero_layer_neighborhood_size=8,
                     optimization=OptimizationParams(recall_proportion=1.0))
    full = Hnsw.generate(source, None, bp, Metric.NORMALIZED_COSINE, seed=2)
    assert full.layer_count >= 2
    return source, bp, full


def test_generate_resumes_from_partial_checkpoint(resume_case, tmp_path):
    """A mid-build ladder checkpoint (upper rungs only) is resumed: the
    stored stack becomes the ladder prefix and only larger rungs are built
    (mirror of the JAX package's test).  The checkpoint here is written by
    the JAX package: the format is shared."""
    source, bp, full = resume_case
    layers, vectors, metric, bp_dict = hnsw_to_numpy(full)
    partial = JHnsw(
        [JLayer(nodes=jnp.asarray(n), neighbors=jnp.asarray(nb)) for n, nb in layers[:-1]],
        JDenseSource(vectors=jnp.asarray(vectors)), metric, j_build_params_from_dict(bp_dict),
    )
    ckpt = tmp_path / "ckpt"
    # simulate a crash after the first rungs: checkpoint only the upper stack
    # (with the build-identity meta a real mid-build checkpoint carries)
    jio.serialize_hnsw(partial, ckpt, store_source=False,
                       extra_meta={"build_seed": 2, "corpus_count": 300})
    resumed = Hnsw.generate(source, None, bp, Metric.NORMALIZED_COSINE, seed=2,
                            checkpoint_dir=str(ckpt))
    # the checkpointed prefix is preserved as ladder rungs and the bottom
    # rung covers the whole corpus
    assert resumed.layer_count >= full.layer_count
    assert resumed.layers[-1].node_count == 300
    counts = [l.node_count for l in resumed.layers]
    assert counts[: partial.layer_count] == [l.node_count for l in full.layers[:-1]]
    for a, b in zip(resumed.layers, full.layers[:-1]):
        assert torch.equal(a.nodes, b.nodes)
    # the resumed bottom rung draws what the uninterrupted build drew
    assert torch.equal(resumed.layers[-1].nodes, full.layers[-1].nodes)
    # and the resumed index searches fine
    ids, _ = resumed.search(source.vectors[:16])
    assert (ids[:, 0].numpy() == np.arange(16)).mean() >= 0.9
    # the finished build left a whole checkpoint behind, without the vectors
    meta = tio.read_index_meta(ckpt)
    assert meta["layer_count"] == resumed.layer_count and meta["build_seed"] == 2
    assert not (ckpt / "comparator").exists()
    _assert_same_layers(tio.deserialize_hnsw(ckpt, source=source), resumed)


@pytest.mark.parametrize("wrong", ["build_seed", "corpus_count", "metric", "build_parameters"])
def test_resume_rejects_mismatched_checkpoint(resume_case, tmp_path, wrong):
    """A checkpoint from a different seed/corpus/metric/parameters must NOT
    be spliced in: generate ignores it and rebuilds (guard against silently
    resuming the wrong build)."""
    source, bp, full = resume_case
    ckpt = tmp_path / "ckpt"
    meta = {"build_seed": 2, "corpus_count": 300}
    partial = Hnsw(full.layers[:-1], source, full.metric, bp)
    if wrong in meta:
        meta[wrong] = 99
    elif wrong == "metric":
        partial.metric = Metric.COSINE
    else:
        partial.build_parameters = BuildParams()
    tio.serialize_hnsw(partial, ckpt, store_source=False, extra_meta=meta)
    rebuilt = Hnsw.generate(source, None, bp, Metric.NORMALIZED_COSINE, seed=2,
                            checkpoint_dir=str(ckpt))
    # rebuilt from scratch: same result as an uninterrupted same-seed build
    _assert_same_layers(rebuilt, full)


def test_generate_rejects_a_checkpoint_larger_than_the_corpus(resume_case):
    from parallel_hnsw_tpu_torch import build as tbuild

    source, bp, full = resume_case
    with pytest.raises(ValueError, match="exceeds the corpus"):
        tbuild.generate(source, np.arange(100), bp, Metric.NORMALIZED_COSINE, seed=2,
                        initial_layers=full.layers)


def test_pq_and_unknown_sources_are_refused(tmp_path):
    """A PQ source whose codes are of no type the format knows, an unknown
    source kind and an unknown source type are refused."""
    (tmp_path / "pq").mkdir()
    (tmp_path / "pq" / "meta").write_text(json.dumps(
        {"kind": "pq", "count": 3, "nsub": 2, "code_dtype": "float16", "codebook_shape": [4, 2]}))
    with pytest.raises(tio.SerializationError, match="PQ code dtype"):
        tio.deserialize_source(tmp_path / "pq", device="cpu")
    (tmp_path / "pq" / "meta").write_text(json.dumps({"kind": "sparse"}))
    with pytest.raises(tio.SerializationError, match="unknown source kind"):
        tio.deserialize_source(tmp_path / "pq", device="cpu")
    with pytest.raises(tio.SerializationError, match="unknown source type"):
        tio.serialize_source(object(), tmp_path / "other")


@pytest.mark.parametrize("code_dtype", ["uint16", "int32"])
@pytest.mark.parametrize("kind", ["shared", "per_subspace"])
def test_pq_source_round_trip(tmp_path, code_dtype, kind):
    """A PqSource goes to disk and back with its codes' type; the JAX package
    writes the same bytes and reads the same arrays."""
    rng = np.random.default_rng(3)
    book = rng.normal(size=(40, 4) if kind == "shared" else (3, 40, 4)).astype(np.float32)
    codes = rng.integers(0, 40, (25, 3)).astype(code_dtype)
    t_codes = torch.from_numpy(codes.view(np.int16)).view(torch.uint16) if code_dtype == "uint16" \
        else torch.from_numpy(codes)
    src = PqSource(codes=t_codes, codebook=torch.from_numpy(book))
    tio.serialize_source(src, tmp_path / "t")
    back = tio.deserialize_source(tmp_path / "t", device="cpu")
    assert isinstance(back, PqSource) and back.codes.dtype == src.codes.dtype
    assert torch.equal(back.codes.view(torch.int16) if code_dtype == "uint16" else back.codes,
                       src.codes.view(torch.int16) if code_dtype == "uint16" else src.codes)
    assert torch.equal(back.codebook, src.codebook)
    jio.serialize_source(JPqSource(codes=jnp.asarray(codes), codebook=jnp.asarray(book)),
                         tmp_path / "j")
    for name in ("meta", "codes", "codebook"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    j_back = jio.deserialize_source(tmp_path / "t")
    np.testing.assert_array_equal(np.asarray(j_back.codes), codes)


@pytest.fixture(scope="module")
def quantized():
    """A small quantized index of each quantizer kind, built by the port, and
    the same index as the JAX package's objects."""
    from tests.test_torch_pq_index import _jax_from_numpy

    source = tdata.random_unit_corpus(120, 8, device="cpu")
    bp = BuildParams(order=6, neighborhood_size=4, zero_layer_neighborhood_size=8,
                     optimization=OptimizationParams(recall_proportion=1.0))
    pqp = PqBuildParams(centroids=bp, hnsw=bp)
    out = {}
    for kind, kw in (("shared", {"exact_quantize": True}),
                     ("per_subspace", {"per_subspace": True, "use_kmeans": True})):
        tq = QuantizedHnsw.new(16, source, 2, Metric.EUCLIDEAN, pqp=pqp, seed=1, **kw)
        out[kind] = tq, _jax_from_numpy(quantized_to_numpy(tq))
    return out


def _assert_same_quantized(a, b):
    sa, sb = quantized_to_numpy(a), quantized_to_numpy(b)
    assert sa.keys() == sb.keys()
    for key, va in sa.items():
        if key.endswith("layers") and va is not None:
            for (n1, nb1), (n2, nb2) in zip(va, sb[key]):
                np.testing.assert_array_equal(n1, n2)
                np.testing.assert_array_equal(nb1, nb2)
        elif isinstance(va, np.ndarray):
            assert va.dtype == sb[key].dtype
            np.testing.assert_array_equal(va, sb[key])
        else:
            assert va == sb[key], key


def _tree_bytes(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("kind", ["shared", "per_subspace"])
def test_quantized_index_files_are_byte_identical_both_ways(quantized, kind, tmp_path):
    """Both packages write the same files for one quantized index; each reads
    what the other wrote, and the port's read-back answers as the original."""
    tq, jq = quantized[kind]
    tio.serialize_quantized_hnsw(tq, tmp_path / "t")
    jio.serialize_quantized_hnsw(jq, tmp_path / "j")
    t_files, j_files = _tree_bytes(tmp_path / "t"), _tree_bytes(tmp_path / "j")
    assert t_files.keys() == j_files.keys() and "hnsw/comparator/codes" in t_files
    for name in t_files:
        assert t_files[name] == j_files[name], name
    from_jax = tio.deserialize_quantized_hnsw(tmp_path / "j", device="cpu")
    _assert_same_quantized(from_jax, tq)
    _assert_same_quantized(jio.deserialize_quantized_hnsw(tmp_path / "t"), jq)
    q = tq.full_source.vectors[:20]
    for a, b in zip(from_jax.search(q), tq.search(q)):
        assert torch.equal(a, b)


def test_quantized_index_lands_on_the_card_by_default(quantized, tmp_path, monkeypatch):
    tq, _ = quantized["shared"]
    tio.serialize_quantized_hnsw(tq, tmp_path / "q")
    monkeypatch.setattr(tdevice, "default_device", lambda: torch.device("meta"))
    loaded = tio.deserialize_quantized_hnsw(tmp_path / "q")
    moved = quantized_from_numpy(quantized_to_numpy(tq))
    for q in (loaded, moved):
        assert q.hnsw.source.codes.device.type == "meta" and q.full_source.device.type == "meta"
        assert q.quantizer.centroids.device.type == "meta"
        assert q.quantizer.hnsw.layers[0].nodes.device.type == "meta"


def test_default_device_is_the_card(built, tmp_path, monkeypatch):
    """Entry points that create tensors place them on the card unless told
    otherwise.  No card is needed to see it: the default compares equal to
    ``torch.device("cuda")``, and with the default redirected to the meta
    device every such entry point lands there."""
    assert tdevice.default_device() == torch.device("cuda")
    assert tdevice.resolve_device(None) == torch.device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    th, _ = built
    tio.serialize_hnsw(th, tmp_path / "idx")
    monkeypatch.setattr(tdevice, "default_device", lambda: torch.device("meta"))
    assert tdata.random_corpus(4, 2).vectors.device.type == "meta"
    assert tdata.random_unit_corpus(4, 2).vectors.device.type == "meta"
    moved = hnsw_from_numpy(*hnsw_to_numpy(th))
    assert moved.source.device.type == "meta" and moved.layers[0].neighbors.device.type == "meta"
    assert tio.deserialize_source(tmp_path / "idx" / "comparator").vectors.device.type == "meta"
    loaded = tio.deserialize_hnsw(tmp_path / "idx")
    assert loaded.source.device.type == "meta" and loaded.layers[-1].nodes.device.type == "meta"
    assert tdata.random_corpus(4, 2, device="cpu").vectors.device.type == "cpu"
