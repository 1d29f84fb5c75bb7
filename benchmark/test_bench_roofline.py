"""The flat scan's roofline arithmetic at ``sift-flat-batch``'s shapes."""

from __future__ import annotations

import pytest

from benchmark import harness, peaks

roofline = harness.load_module(harness.HERE / "metrics" / "kernel.flat_scan_roofline.py")


def test_operations_and_bytes_at_the_cell():
    q, n, d, k = 10_000, 1_000_000, 128, 10
    assert roofline.flops(q, n, d) == 2.56e12
    # the f32 corpus once, the queries once, int32 ids and f32 distances once
    assert roofline.nbytes(q, n, d, k) == 512_000_000 + 5_120_000 + 800_000
    least = roofline.least_seconds(q, n, d, k)
    assert least == pytest.approx(2.56e12 / peaks.BF16_FLOPS)  # bound by operations
    assert least == pytest.approx(2.5885e-3, rel=1e-4)


def test_cell_shapes_come_from_its_files():
    bench = harness.manifest()
    work = next(w for w in bench["workloads"] if w["name"] == "sift-flat-batch")
    traffic = harness.load_json(harness.HERE / "traffic" / f"{work['traffic']}.json")
    config = harness.load_json(harness.ROOT / f"benchmark/configs/{work['config']}.json")
    assert (traffic["batch"], config["rows"], config["dim"], config["k"]) == (10_000, 1_000_000, 128, 10)


def test_share_reads_nothing_without_a_trace():
    from types import SimpleNamespace

    assert roofline.read(SimpleNamespace(trace=None)) is None
