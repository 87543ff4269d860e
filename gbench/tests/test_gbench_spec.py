"""``BENCHMARK.json``: every name resolves to its file, and names, units and
keys keep to the benchmark's contract."""
from __future__ import annotations

import json
import re

import pytest

from gbench import spec

NAME = re.compile(r"[0-9A-Za-z_][0-9A-Za-z_.-]{0,63}")
UNIT = re.compile(r"[0-9A-Za-z_/%.-]{1,16}")
PATH = re.compile(r"[0-9A-Za-z_./-]{1,200}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = spec.benchmark()
E2E = {m["name"] for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == TOP_KEYS
    assert spec.BENCHMARK.stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (spec.ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    named = [w for w in BENCH["command"] if "/" in w]
    assert all(any(w.startswith(p + "/") for p in BENCH["paths"]) for w in named)
    assert (spec.ROOT / named[0]).is_file()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.fullmatch(entry["name"]) and line(entry["source"]) and line(entry["why"])
    assert entry["file"].startswith("gbench/configs/")
    cfg = spec.config(BENCH, entry["name"])
    assert cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"]) and len(entry["reduced"]) <= 16
    assert all(NAME.fullmatch(k) for k in entry["reduced"])
    assert "assumed" in cfg and cfg["dtype"] == "float32"
    spec.module("generators", cfg["generator"])
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.fullmatch(cell["name"]) and NAME.fullmatch(cell["traffic"])
    assert cell["chips"] in (1, 4) and line(cell["why"])
    spec.config(BENCH, cell["config"])
    app = spec.module("apps", spec.traffic(cell["traffic"])["app"])
    for attr in ("App", "WEIGHTED", "EDGE_BYTES"):
        assert hasattr(app, attr)
    limits = spec.limits(cell["name"])
    assert limits and all(NAME.fullmatch(k) for k in limits)
    assert {"setup_s"} < {m["name"] for m in spec.end_to_end(BENCH, cell["name"])}
    assert spec.per_layer(BENCH, cell["name"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in {"host_clock", "device_trace"}
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_resolves(m):
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"]) and line(m["layer"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert m["moves"] in E2E and set(m["workloads"]) <= set(CELLS)
    assert callable(spec.module("metrics", m["name"]).read)
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


def test_missing_names_fail_loudly():
    with pytest.raises(FileNotFoundError, match="nope.json"):
        spec.traffic("nope")
    with pytest.raises(FileNotFoundError, match="nope.py"):
        spec.module("metrics", "nope")
    with pytest.raises(KeyError):
        spec.cell(BENCH, "nope.prd")


def test_four_chip_share():
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


def test_config_files_are_json_objects():
    for entry in BENCH["configs"]:
        with open(spec.ROOT / entry["file"]) as f:
            assert isinstance(json.load(f), dict)
