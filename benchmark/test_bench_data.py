"""The generator: one seed gives the same data, another seed other data,
and the published shapes hold."""

from __future__ import annotations

import torch

from benchmark import data, harness

SMALL = {"rows": 600, "queries": 40}


def _config(name: str) -> dict:
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


def test_same_seed_same_data_other_seed_other_data():
    config = _config("nytimes-256-angular")
    a = data.draw(config, 2**31 + 11, "cpu", **SMALL)
    b = data.draw(config, 2**31 + 11, "cpu", **SMALL)
    c = data.draw(config, 2**31 + 12, "cpu", **SMALL)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[1], c[1])


def test_shapes_metric_and_rows():
    for name, rows, dim, unit in (("nytimes-256-angular", 290_000, 256, True),
                                  ("sift-128-euclidean", 1_000_000, 128, False)):
        config = _config(name)
        assert (config["rows"], config["dim"], config["queries"], config["k"]) == (rows, dim, 10_000, 10)
        assert config["reduced"] == []
        corpus, queries = data.draw(config, 7, "cpu", **SMALL)
        assert corpus.shape == (SMALL["rows"], dim) and queries.shape == (SMALL["queries"], dim)
        assert corpus.dtype == queries.dtype == torch.float32
        norms = torch.linalg.vector_norm(corpus, dim=1)
        assert bool(torch.allclose(norms, torch.ones_like(norms), atol=1e-5)) == unit


def test_every_seed_gives_clusters_of_one_size():
    config = _config("sift-128-euclidean")
    centres = config["assumed"]["data"]["centres"]
    corpus, _ = data.draw(config, 3, "cpu", rows=4 * centres, queries=1)
    # each row is nearest to its own centre; every centre has 4 rows
    gen = data.generator(3, "cpu")
    c = torch.randn(centres, config["dim"], generator=gen)
    nearest = torch.cdist(corpus, c).argmin(1)
    assert torch.equal(torch.bincount(nearest, minlength=centres), torch.full((centres,), 4))


def test_seeds_past_32_bits():
    config = _config("sift-128-euclidean")
    a = data.draw(config, 2**31 + 2**20, "cpu", **SMALL)[0]
    b = data.draw(config, 2**20, "cpu", **SMALL)[0]
    assert not torch.equal(a, b)
