"""Shared pieces of the benchmark's CPU tests: a cell run at a size the
CPU holds, through the same harness as on the chip."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

CELLS = ("nytimes-graph-batch", "sift-flat-batch", "nytimes-build", "nytimes-graph-online")
TINY_CONFIG = {"rows": 2000, "queries": 200}
TINY_TRAFFIC = {
    "nytimes-graph-batch": {"batch": 100},
    "sift-flat-batch": {"batch": 100},
    "nytimes-build": {"check_batch": 100},
    "nytimes-graph-online": {"batch": 20},
}


def tiny_run(cell: str, seed: int = 2**31 + 5, trace: bool = False, seconds: float = 0.3) -> dict:
    """One run of ``cell`` on the CPU at ``TINY_CONFIG``'s sizes."""
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            config_overrides=TINY_CONFIG, traffic_overrides=TINY_TRAFFIC[cell])
