"""A run of the harness on the CPU at a small scale (the look for a GPU
skipped), the result's schema, the trace reduction, and the ways a run
refuses to give a result."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from gbench import run, spec
from gbench import trace as tr

SMALL = {"scale": 11}
E2E = {"gteps", "peak_gib", "setup_s"}


def cpu_run(workload: str, trace: bool = False, **kw) -> dict:
    return run.run_cell(workload, 2**31 + 3, 0.2, trace, device="cpu", t0=time.perf_counter(),
                        overrides=SMALL, log=lambda s: None, **kw)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal without one cannot be shown")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("workload", [w["name"] for w in spec.benchmark()["workloads"]])
def test_result_schema(workload):
    res = cpu_run(workload)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == E2E
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == set(spec.limits(workload))
    json.dumps(res)


def test_traced_schema():
    res = cpu_run("kron25.prd", trace=True)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert not set(res["metrics"]) & E2E  # the traced run reports per-layer metrics only
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in res["breakdown"].values())


def synthetic_trace() -> list[dict]:
    """Two trials: kernels of 10 + 30 us and 25 us, idle between them."""
    def x(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    return [
        x("kernel", "spin_kernel", 0, 50, 7),
        x("user_annotation", "gbench.trial.0", 100, 100),
        x("cpu_op", "aten::index_add_", 102, 10),
        x("kernel", "indexFuncLargeIndex<float>", 110, 10, 7),
        x("kernel", "gather_col_kernel<unsigned int>", 120, 30, 7),
        x("cpu_op", "aten::_local_scalar_dense", 150, 40),
        x("user_annotation", "gbench.trial.1", 200, 50),
        x("kernel", "indexFuncLargeIndex<float>", 220, 25, 7),
        x("kernel", "spin_kernel", 260, 50, 7),
    ]


def test_trace_reduction():
    t = tr.reduce(synthetic_trace())
    assert t.window_s == pytest.approx(150e-6) and t.busy_s == pytest.approx(65e-6)
    assert t.trial_busy_s == {0: pytest.approx(40e-6), 1: pytest.approx(25e-6)}
    assert [op.trial for op in t.ops] == [0, 0, 1]
    assert [name for name, _ in t.device_ops()] == ["indexFuncLargeIndex<float>",
                                                    "gather_col_kernel<unsigned int>"]
    assert dict(t.idle_gaps) == {"aten::index_add_": pytest.approx(10e-6),
                                 "aten::_local_scalar_dense": pytest.approx(70e-6),
                                 "python between ops": pytest.approx(5e-6)}
    reading = tr.Reading(trace=t, iters=[2, 1], checked={0: [(4, 100), (2, 10)]}, num_nodes=4,
                         num_edges=100, distinct_rows=4, edge_bytes=4)
    read = {name: spec.module("metrics", name).read(reading)
            for name in ("idle_share", "reduce_ms_per_iter", "k1_roofline", "sweep_roofline")}
    assert read["idle_share"] == pytest.approx(100 * (1 - 65 / 150))
    assert read["reduce_ms_per_iter"] == pytest.approx(35e-3 / 3)
    assert read["k1_roofline"] == pytest.approx(100 * 816 / 3.35e12 / 30e-6)
    least = 4 * 100 + 8 * 4 + 4 * 10 + 8 * 2 + 4 * 4
    assert read["sweep_roofline"] == pytest.approx(100 * least / 3.35e12 / 40e-6)


def test_no_k1_reading_without_k1():
    t = tr.reduce([e for e in synthetic_trace() if "gather_col" not in e["name"]])
    reading = tr.Reading(trace=t, iters=[1], checked={}, num_nodes=4, num_edges=100,
                         distinct_rows=4, edge_bytes=8)
    assert spec.module("metrics", "k1_roofline").read(reading) is None
    assert spec.module("metrics", "sweep_roofline").read(reading) is None


def test_jax_loaded_in_the_run_refuses(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit, match="jax"):
        cpu_run("kron25.prd")


def test_no_gpu_no_result(no_card):
    proc = subprocess.run([sys.executable, str(spec.GBENCH / "run.py"), "--workload",
                           "kron25.prd", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=spec.ROOT, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert "CUDA is not available" in proc.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with only BENCHMARK.json and gbench/ lacks the program."""
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.GBENCH, tmp_path / "gbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "gbench/run.py", "--workload", "kron25.prd",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode != 0
    assert not any(ln.startswith("{") for ln in proc.stdout.splitlines())


@pytest.mark.cuda
def test_card_run_small(card):
    """On a GPU: a traced run at scale 16 reads every per-layer metric of its cell."""
    res = run.run_cell("kron25.prd", 5, 1.0, True, overrides={"scale": 16},
                       t0=time.perf_counter(), log=lambda s: None)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {m["name"] for m in spec.per_layer(spec.benchmark(),
                                                                     "kron25.prd")}
    assert 0 < res["metrics"]["k1_roofline"]["value"] <= 100
