"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level names (``parallel_hnsw_tpu_torch`` passes), and the plain
reference loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.test_bench_support import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "parallel_hnsw_tpu"}

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from benchmark import control, data, harness, judge, profiling, reference
from benchmark.test_bench_support import CELLS, tiny_run
for cell in CELLS:
    for trace in (False, True):
        assert tiny_run(cell, trace=trace, seconds=0.1)["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import data, judge, reference
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_names(script: str) -> set:
    out = subprocess.run([sys.executable, "-c", script.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_driver_loads_no_jax():
    names = _top_level_names(SCRIPT)
    assert "parallel_hnsw_tpu_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_names(REFERENCE_ONLY)
    assert "torch" in names
    assert not names & (FORBIDDEN | {"parallel_hnsw_tpu_torch"})


def test_the_run_refuses_forbidden_modules():
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        import run
    finally:
        sys.path.remove(str(ROOT / "benchmark"))
    assert set(run.FORBIDDEN) == FORBIDDEN
    sys.modules["jaxlib.fake_probe"] = sys.modules["json"]
    try:
        assert run.forbidden_modules() == ["jaxlib"]
    finally:
        del sys.modules["jaxlib.fake_probe"]
