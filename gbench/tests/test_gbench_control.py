"""The check that decides ``correct`` fails what it must: the control (the
plain reference in bfloat16 in the program's place) and the faults a
single-chip graph app can have, each planted under an otherwise whole run
on the CPU at a small scale. (The exchange between chips is no fault of a
one-chip cell.)"""
from __future__ import annotations

import sys
import time

import pytest
import torch

import repro_torch.apps
from gbench import run

SCALE = {"scale": 12}
PRD = "repro_torch.apps.prdelta"
SSSP = "repro_torch.apps.sssp"


def cpu_run(workload: str, **kw) -> dict:
    return run.run_cell(workload, 2**31 + 29, 0.2, False, device="cpu", t0=time.perf_counter(),
                        overrides=SCALE, log=lambda s: None, **kw)


@pytest.mark.parametrize("workload", ["kron25.prd", "urand25.prd", "kron25.sssp"])
def test_control_is_not_correct(workload):
    res = cpu_run(workload, control="bfloat16")
    assert res["correct"] is False
    assert all(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def test_bfloat16_is_exact_up_to_256():
    """bfloat16 holds every integer up to 256, and urand's distances stay
    below that at test scales, so there its control reads what float32
    reads: it fails only at the cell's own scale (the next test; PERF.md
    gives the chip's readings). float32 in the program's place passes."""
    assert cpu_run("urand25.sssp", control="bfloat16")["correct"] is True
    assert cpu_run("kron25.sssp", control="float32")["correct"] is True


@pytest.mark.cuda
def test_urand_sssp_control_at_its_scale(card):
    res = run.run_cell("urand25.sssp", 2**31 + 31, 4.0, False, t0=time.perf_counter(),
                       control="bfloat16", log=lambda s: None)
    assert res["correct"] is False and res["checks"]["dist_mismatches"]["value"] > 0


def unchanged_pull(g, prop, **kw):
    return torch.zeros(g.num_nodes, dtype=prop.dtype, device=prop.device)


def half_pull(g, prop, reduce_fn, **kw):
    """The gather and sum over every other edge, doubled: half the batch
    left out, the mean taken over the rest."""
    keep = slice(0, None, 2)
    msgs = prop.index_select(0, g.indices[keep])
    return 2 * reduce_fn(msgs, g.dst[keep], g.num_nodes)


def unchanged_min(data, seg, n):
    return torch.full((n,), float("inf"), dtype=data.dtype, device=data.device)


def half_min(data, seg, n):
    half = data.shape[0] // 2
    out = torch.full((n,), float("inf"), dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, seg[:half].long(), data[:half], "amin")


def altered(app):
    """The app with one vertex's answer altered where it is produced."""
    def wrapper(*args, **kw):
        out = app(*args, **kw)
        v = int(torch.nonzero(torch.isfinite(out) & (out > 0))[-1])
        out[v] = out[v] * 1.5
        return out
    return wrapper


FAULTS = {
    "kron25.prd": [(PRD, "edge_map_pull", unchanged_pull), (PRD, "edge_map_pull", half_pull)],
    "kron25.sssp": [(SSSP, "min_reduce", unchanged_min), (SSSP, "min_reduce", half_min)],
}
FAULTS["urand25.prd"] = FAULTS["kron25.prd"]
FAULTS["urand25.sssp"] = FAULTS["kron25.sssp"]


@pytest.mark.parametrize("workload,module,name,fault",
                         [(w, *f) for w, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", str(x)))
def test_fault_is_not_correct(monkeypatch, workload, module, name, fault):
    monkeypatch.setattr(sys.modules[module], name, fault)
    assert cpu_run(workload)["correct"] is False


@pytest.mark.parametrize("workload,app", [("kron25.prd", "pagerank_delta"),
                                          ("urand25.prd", "pagerank_delta"),
                                          ("kron25.sssp", "sssp"), ("urand25.sssp", "sssp")])
def test_altered_answer_is_not_correct(monkeypatch, workload, app):
    monkeypatch.setattr(repro_torch.apps, app, altered(getattr(repro_torch.apps, app)))
    res = cpu_run(workload)
    assert res["correct"] is False and res["failed"] >= 1
