"""Find what a cell's names stand for.

``BENCHMARK.json`` names a cell's configuration, traffic mix and metrics;
each name resolves to a file of its own, so a later cell, mix or metric is
one new file and new entries, with no edit to a file that is there:

- configuration ``<c>``: the ``file`` of its entry in ``configs``, whose
  ``generator`` key names ``gbench/generators/<generator>.py``;
- traffic mix ``<t>``: ``gbench/traffic/<t>.json``, whose ``app`` key names
  ``gbench/apps/<app>.py``;
- per-layer metric ``<m>``: ``gbench/metrics/<m>.py``;
- the correctness limits of cell ``<w>``: ``gbench/limits/<w>.json``.

A name without its file raises ``FileNotFoundError`` naming the path.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

GBENCH = Path(__file__).resolve().parent
ROOT = GBENCH.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def _need(path: Path) -> Path:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return path


def read_json(path: Path) -> dict:
    with open(_need(path)) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(BENCHMARK)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {BENCHMARK.name}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return read_json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in {BENCHMARK.name}")


def traffic(name: str) -> dict:
    return read_json(GBENCH / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return read_json(GBENCH / "limits" / f"{cell_name}.json")


def module(kind: str, name: str) -> ModuleType:
    """``gbench/<kind>/<name>.py``, imported once under its own module name."""
    path = _need(GBENCH / kind / f"{name}.py")
    mod_name = f"gbench.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics that cell ``cell_name`` reports."""
    return [m for m in bench["per_layer"] if cell_name in m.get("workloads", [cell_name])]


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
