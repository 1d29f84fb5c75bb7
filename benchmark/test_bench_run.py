"""The command itself: no result without a card, and none in a directory
that holds only ``BENCHMARK.json`` and the benchmark's files."""

from __future__ import annotations

import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.test_bench_support import ROOT

ARGS = ["--workload", "sift-flat-batch", "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]


def _run(cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=str(cwd),
                          capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "parallel_hnsw_tpu_torch" in out.stderr
