"""``BENCHMARK.json`` against the contract's shape, and every name in it
found as a file of its own under ``benchmark/``."""

from __future__ import annotations

import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

bench = harness.manifest()
E2E = {m["name"]: m for m in bench["end_to_end"]}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_limits():
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"] and all(PATH.match(p) for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert all(_line(w) for w in bench["command"])
    cells = len(bench["workloads"])
    # 2 + 14 runs a cell, each run_seconds + 60, 2 x 90 s a cell to compile, 1200 s spare, at 24 cells
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, cells // 4)


def test_names_units_and_keys():
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for group in ("configs", "workloads"):
        got = [e["name"] for e in bench[group]]
        assert len(got) == len(set(got))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(r) for r in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/") and (harness.ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] == 0.25 and "workloads" not in E2E["setup_s"]
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for name in names:
        if name.endswith("_roofline") or "mfu" in name:
            assert next(m for m in bench["per_layer"] if m["name"] == name)["unit"] == "%"


def test_every_metric_moves_a_metric_its_cells_report():
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in E2E, m["name"]
        listed = m.get("workloads", cells)
        assert set(listed) <= cells
        for cell in listed:
            assert _reports(E2E[m["moves"]], cell), (m["name"], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in bench["workloads"]])
def test_every_cell_is_whole(cell):
    work = next(w for w in bench["workloads"] if w["name"] == cell)
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert harness._for_cell(bench["per_layer"], cell, {m["name"] for m in e2e})
    traffic = harness.load_json(harness.HERE / "traffic" / f"{work['traffic']}.json")
    assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").is_file()
    limits = harness.load_json(harness.HERE / "workloads" / f"{cell}.json")["limits"]
    assert {"dist_gap", "bad_rows", "unanswered"} <= set(limits)
    assert limits["bad_rows"] == limits["unanswered"] == 0
    for m in harness._for_cell(bench["per_layer"], cell, {m["name"] for m in e2e}):
        assert hasattr(harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py"), "read")
    assert any(c["name"] == work["config"] for c in bench["configs"])


def test_every_configuration_is_used_and_states_its_data():
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        config = harness.load_json(harness.ROOT / c["file"])
        assert config["name"] == c["name"] and config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
        assert {"centres", "spread", "unit_rows"} <= set(config["assumed"]["data"])
