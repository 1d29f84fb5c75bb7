"""The drivers: one module per way of calling the program, each a class
``Driver(cell)`` with ``setup()``, ``call(i) -> units of work``,
``finish() -> extra compared numbers`` and ``free()``."""

from __future__ import annotations

from parallel_hnsw_tpu_torch.params import (
    BuildParams,
    SearchParams,
    build_params_from_dict,
    params_to_dict,
)


def build_params(config: dict) -> BuildParams:
    """``BuildParams()`` with the fields the configuration's ``build`` names."""
    return build_params_from_dict({**params_to_dict(BuildParams()), **config["build"]})


def search_params(config: dict) -> SearchParams:
    """``SearchParams()`` with the fields the configuration's ``search`` names."""
    return SearchParams(**config["search"])
