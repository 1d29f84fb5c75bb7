"""The cells' corpora and queries, drawn on the device from the run's seed.

The published vectors cannot be fetched, so each configuration names a
Gaussian mixture under ``assumed.data`` at the published row count, width
and metric: ``centres`` centres with N(0, 1) coordinates, each row a centre
plus ``spread`` N(0, 1) noise, scaled to unit length where ``unit_rows`` is
set (angular data).  Rows go to the centres in turn and are then shuffled,
so every seed gives clusters of the same sizes: a seed changes the values,
not the amount of work.  Queries are further draws of the same mixture,
never rows of the corpus.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return gen


def draw(
    config: dict,
    seed: int,
    device,
    rows: Optional[int] = None,
    queries: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(corpus [rows, dim], queries [queries, dim])`` in float32 on
    ``device``; ``rows`` and ``queries`` default to the configuration's."""
    mix = config["assumed"]["data"]
    dim = config["dim"]
    rows = config["rows"] if rows is None else rows
    queries = config["queries"] if queries is None else queries
    gen = generator(seed, device)
    centres = torch.randn(mix["centres"], dim, generator=gen, device=device)

    def sample(count: int) -> torch.Tensor:
        which = torch.arange(count, device=device) % mix["centres"]
        which = which[torch.randperm(count, generator=gen, device=device)]
        x = centres[which]
        x.add_(torch.randn(count, dim, generator=gen, device=device), alpha=mix["spread"])
        if mix["unit_rows"]:
            x.div_(torch.linalg.vector_norm(x, dim=1, keepdim=True))
        return x

    corpus = sample(rows)
    return corpus, sample(queries)
