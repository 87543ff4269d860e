"""The kron21.pna cell on the CPU at a small scale: a whole run is correct,
the check fails the control and a planted fault, and the cell's three
per-layer metrics read what their docstrings say from a hand-made trace."""
from __future__ import annotations

import time

import pytest
import torch

import repro_torch.nn.gnn as gnn
from gbench import run, spec
from gbench import trace as tr

CELL = "kron21.pna"
SMALL = {"scale": 8}
MODEL = spec.traffic("pna")


def cpu_run(**kw) -> dict:
    return run.run_cell(CELL, 2**31 + 41, 0.2, False, device="cpu", t0=time.perf_counter(),
                        overrides=SMALL, log=lambda s: None, **kw)


@pytest.fixture(params=[gnn.BLOCK_EDGES, 300], ids=["one_block", "blocks_of_300"])
def blocks(request, monkeypatch):
    """The program's budget (one block at this scale), and a budget that
    cuts the graph into blocks and its hubs' rows into blocks of their own."""
    monkeypatch.setattr(gnn, "BLOCK_EDGES", request.param)


def test_run_is_correct(blocks):
    res = cpu_run()
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["logit_err"]["value"] < res["checks"]["logit_err"]["limit"]


def test_control_is_not_correct():
    res = cpu_run(control="bfloat16")
    assert res["correct"] is False
    assert res["checks"]["logit_err"]["value"] > res["checks"]["logit_err"]["limit"]


def without_min(x, offsets, reduce):
    """The min aggregator dropped: zeros where the minimum would be."""
    if reduce == "amin":
        return x.new_zeros((offsets.shape[0] - 1, x.shape[1]))
    return real_extreme(x, offsets, reduce)


real_extreme = gnn._seg_extreme_sorted


def one_block_skipped(indptr, block_edges):
    """A block's rows never written: the graph's second block dropped."""
    blocks = real_blocks(indptr, block_edges)
    return blocks[:1] + blocks[2:]


real_blocks = gnn.pna_blocks


@pytest.mark.parametrize("name,fault", [("_seg_extreme_sorted", without_min),
                                        ("pna_blocks", one_block_skipped)])
def test_fault_is_not_correct(monkeypatch, name, fault):
    monkeypatch.setattr(gnn, "BLOCK_EDGES", 300)
    monkeypatch.setattr(gnn, name, fault)
    res = cpu_run()
    assert res["correct"] is False and res["failed"] >= 1


def synthetic_trace() -> list[dict]:
    """One traced trial: K1 40 us, the reductions 30 us (an index_select
    of 5 us by the gather-like scatter kernel left out), GEMMs 50 us."""
    def x(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    return [
        x("user_annotation", "gbench.trial.0", 100, 300),
        x("kernel", "void gather_scalar_kernel<unsigned int>", 110, 25, 7),
        x("kernel", "void gather_rows_kernel<5>", 140, 15, 7),
        x("kernel", "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>", 160, 40, 7),
        x("kernel", "void splitKreduce_kernel<32, 16, int, float>", 200, 10, 7),
        x("kernel", "void at::native::indexFuncLargeIndex<float>", 215, 10, 7),
        x("kernel", "void at::native::segment_reduce_forward_kernel<float, int>", 230, 12, 7),
        x("kernel", "void at::native::_scatter_gather_elementwise_kernel<128, 8, at::native::"
                    "_cuda_scatter_gather_internal_kernel<true, float, long>>", 243, 8, 7),
        x("kernel", "void at::native::_scatter_gather_elementwise_kernel<128, 8, at::native::"
                    "_cuda_scatter_gather_internal_kernel<false, OpaqueType<4>, int>>", 252, 5, 7),
        x("kernel", "void at::native::vectorized_elementwise_kernel<4>", 260, 30, 7),
    ]


def reading(events, iters=(4,)):
    return tr.Reading(trace=tr.reduce(events), iters=list(iters), checked={0: None},
                      num_nodes=1000, num_edges=30000, distinct_rows=900, edge_bytes=4)


def test_metrics_from_a_hand_made_trace():
    r = reading(synthetic_trace())
    read = {m: spec.module("metrics", m).read(r)
            for m in ("pna_gather_roofline", "pna_reduce_ms_per_layer", "pna_gemm_flops_share")}
    e, n, rows = 30000, 1000, 900
    widths = [100, 75, 75, 75]
    least = sum(4 * e + 4 * d * e + 4 * d * rows for d in widths)
    assert read["pna_gather_roofline"] == pytest.approx(100 * least / 3.35e12 / 40e-6)
    assert read["pna_reduce_ms_per_layer"] == pytest.approx(30e-3 / 4)
    flops = sum(2 * e * 2 * d * 75 + 2 * n * (12 * 75 + d) * 75 + 2 * n * 75 * 75
                for d in widths) + 2 * n * 75 * 16
    assert read["pna_gemm_flops_share"] == pytest.approx(100 * flops / 67e12 / 50e-6)


def test_metrics_read_nothing_without_their_kernels():
    events = [e for e in synthetic_trace()
              if e["cat"] == "user_annotation" or "elementwise_kernel<4>" in e["name"]]
    r = reading(events)
    for m in ("pna_gather_roofline", "pna_reduce_ms_per_layer", "pna_gemm_flops_share"):
        assert spec.module("metrics", m).read(r) is None


def test_the_cell_reports_its_metrics():
    bench = spec.benchmark()
    assert {m["name"] for m in spec.per_layer(bench, CELL)} == {
        "pna_gather_roofline", "pna_reduce_ms_per_layer", "pna_gemm_flops_share"}
    assert {m["name"] for m in spec.end_to_end(bench, CELL)} == {"gteps", "peak_gib", "setup_s"}


def test_mix_is_the_registered_model():
    from repro_torch.configs.base import GNN_SHAPES, get_arch
    cfg = get_arch("pna")
    assert (MODEL["n_layers"], MODEL["d_hidden"], MODEL["d_out"]) == (
        cfg.n_layers, cfg.d_hidden, cfg.d_out)
    assert tuple(MODEL["aggregators"]) == cfg.aggregators
    assert tuple(MODEL["scalers"]) == cfg.scalers
    assert MODEL["d_feat"] == GNN_SHAPES["ogb_products"].d_feat and MODEL["reduced"] == {}


def test_inputs_come_from_the_seed():
    """The same seed draws the same features and weights; another does not."""
    from gbench import graphs
    from gbench.apps import pna
    cfg = {**spec.config(spec.benchmark(), "kron21"), **SMALL}

    def features(seed):
        g = graphs.make(cfg, seed, torch.device("cpu"), weighted=False)
        return pna.App(g, MODEL, torch.device("cpu")).x

    assert torch.equal(features(2**31 + 5), features(2**31 + 5))
    assert not torch.equal(features(2**31 + 5), features(2**31 + 6))


@pytest.mark.cuda
def test_card_run_small():
    """On a GPU: a traced run at scale 14 reads the cell's three metrics,
    each share at most 100%."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = run.run_cell(CELL, 2**31 + 43, 1.0, True, overrides={"scale": 14},
                       t0=time.perf_counter(), log=lambda s: None)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == {"pna_gather_roofline", "pna_reduce_ms_per_layer",
                        "pna_gemm_flops_share"}
    assert 0 < got["pna_gather_roofline"] <= 100 and 0 < got["pna_gemm_flops_share"] <= 100
    assert got["pna_reduce_ms_per_layer"] > 0
