"""The control (the plain reference in the program's place, its products
in TF32) fails every cell's limits.  On the CPU TF32 is emulated by
rounding the operands; on the card the same function switches TF32 on."""

from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.test_bench_support import CELLS

# large enough that a max over its pairs reads as the cell's does (tiny sizes read
# 9e-5, the full cells 6.6e-4 to 8.7e-4, 20,000 x 1,000 4.3e-4 to 6.0e-4)
CONTROL_SIZE = {"rows": 20_000, "queries": 1000}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_cpu(cell):
    for seed in (1, 2, 3):
        out = control.control_numbers(cell, seed, "cpu", CONTROL_SIZE)
        assert not out["correct"], out
        gap = out["checks"]["dist_gap"]
        assert gap["value"] > 3 * gap["limit"], out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    for seed in (1, 2, 3):
        out = control.control_numbers(cell, seed, "cuda", {"rows": 50_000, "queries": 1000})
        assert not out["correct"], out
