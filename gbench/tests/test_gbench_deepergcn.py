"""The kron21.deepergcn cell on the CPU at a small scale: a whole run is
correct, the check fails the control and planted faults, and the cell's two
per-layer metrics read what their docstrings say from a hand-made trace."""
from __future__ import annotations

import time

import pytest
import torch

import repro_torch.nn.gnn as gnn
from gbench import run, spec
from gbench import trace as tr
from repro_torch.kernels.softmax_aggr import ref
from repro_torch.train.tree import tree_leaves

CELL = "kron21.deepergcn"
SMALL = {"scale": 8}
MODEL = spec.traffic("deepergcn")
METRICS = ("deepergcn_aggr_roofline", "deepergcn_gemm_flops_share")


def cpu_run(**kw) -> dict:
    return run.run_cell(CELL, 2**31 + 41, 0.2, False, device="cpu", t0=time.perf_counter(),
                        overrides=SMALL, log=lambda s: None, **kw)


@pytest.fixture(params=[ref.BLOCK_ITEMS, 300], ids=["one_block", "blocks_of_300"])
def blocks(request, monkeypatch):
    """The plain aggregation in one block of rows, and in blocks that cut
    the graph and give its hubs' rows blocks of their own."""
    monkeypatch.setattr(ref, "BLOCK_ITEMS", request.param)


def test_run_is_correct(blocks):
    res = cpu_run()
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["logit_err"]["value"] < res["checks"]["logit_err"]["limit"]


def test_control_is_not_correct():
    res = cpu_run(control="bfloat16")
    assert res["correct"] is False
    assert res["checks"]["logit_err"]["value"] > res["checks"]["logit_err"]["limit"]


real_aggr = gnn.softmax_aggr


def ids_off_by_one(indptr, src, u, hot_size, t, eps):
    """Each edge given the id of the edge before it."""
    return real_aggr(indptr, src.roll(1), u, hot_size, t, eps)


def mean_not_softmax(indptr, src, u, hot_size, t, eps):
    """t = 0: the plain mean of the messages, the softmax left out."""
    return real_aggr(indptr, src, u, hot_size, 0.0, eps)


def no_self_loop_term(indptr, src, u, hot_size, t, eps):
    """u_i + m_i without its u_i."""
    return real_aggr(indptr, src, u, hot_size, t, eps) - u


@pytest.mark.parametrize("fault", [ids_off_by_one, mean_not_softmax, no_self_loop_term])
def test_fault_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(gnn, "softmax_aggr", fault)
    res = cpu_run()
    assert res["correct"] is False and res["failed"] >= 1


def synthetic_trace() -> list[dict]:
    """One traced trial: the aggregation 60 us over three kernels, GEMMs
    50 us, elementwise 20 us."""
    def x(cat, name, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    return [
        x("user_annotation", "gbench.trial.0", 100, 300),
        x("kernel", "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>", 110, 40, 7),
        x("kernel", "void splitKreduce_kernel<32, 16, int, float>", 150, 10, 7),
        x("kernel", "(anonymous namespace)::softmax_aggr_partition_kernel(Args)", 165, 2, 7),
        x("kernel", "(anonymous namespace)::softmax_aggr_kernel(Args)", 170, 55, 7),
        x("kernel", "(anonymous namespace)::softmax_aggr_merge_kernel(Args)", 226, 3, 7),
        x("kernel", "void at::native::vectorized_elementwise_kernel<4>", 240, 20, 7),
    ]


def reading(events, iters=(14,)):
    return tr.Reading(trace=tr.reduce(events), iters=list(iters), checked={0: None},
                      num_nodes=1000, num_edges=30000, distinct_rows=900, edge_bytes=4)


def test_metrics_from_a_hand_made_trace():
    r = reading(synthetic_trace())
    read = {m: spec.module("metrics", m).read(r) for m in METRICS}
    n, e = 1000, 30000
    least = 14 * (4 * (n + 1) + 4 * e + 4 * 128 * n + 4 * 128 * n)
    assert read["deepergcn_aggr_roofline"] == pytest.approx(100 * least / 3.35e12 / 60e-6)
    flops = 2 * n * (100 * 128 + 14 * 128 * 128 + 128 * 47)
    assert read["deepergcn_gemm_flops_share"] == pytest.approx(100 * flops / 67e12 / 50e-6)


def test_metric_formulas_at_kron21():
    """At kron21's N and E: 33.74 GB a trial (10.07 ms at 3.35e12 B/s) and
    1.041e12 FLOP a trial."""
    aggr = spec.module("metrics", "deepergcn_aggr_roofline")
    gemm = spec.module("metrics", "deepergcn_gemm_flops_share")
    n, e = 2_097_152, 63_541_722
    assert aggr.least_bytes(MODEL, n, e) / 1e9 == pytest.approx(33.74, abs=0.005)
    assert aggr.least_bytes(MODEL, n, e) / 3.35e12 * 1e3 == pytest.approx(10.07, abs=0.005)
    assert gemm.trial_flops(MODEL, n) / 1e12 == pytest.approx(1.041, abs=0.0005)


def test_metrics_read_nothing_without_their_kernels():
    events = [e for e in synthetic_trace()
              if e["cat"] == "user_annotation" or "elementwise_kernel<4>" in e["name"]]
    r = reading(events)
    for m in METRICS:
        assert spec.module("metrics", m).read(r) is None


def test_names_resolve_and_the_cell_reports_its_metrics():
    bench = spec.benchmark()
    cell = spec.cell(bench, CELL)
    assert {m["name"] for m in spec.per_layer(bench, CELL)} == set(METRICS)
    assert {m["name"] for m in spec.end_to_end(bench, CELL)} == {"gteps", "peak_gib", "setup_s"}
    assert cell["chips"] == 1 and cell["traffic"] == "deepergcn"
    assert spec.limits(CELL) == {"logit_err": spec.limits(CELL)["logit_err"]}
    assert spec.module("apps", MODEL["app"]).EDGE_BYTES == 4
    for m in METRICS:
        assert callable(spec.module("metrics", m).read)


def test_mix_is_the_configs_model():
    from repro_torch.configs.deepergcn import CONFIG
    assert (MODEL["n_layers"], MODEL["d_hidden"], MODEL["d_out"]) == (
        CONFIG.n_layers, CONFIG.d_hidden, CONFIG.d_out)
    assert (MODEL["t"], MODEL["eps"], MODEL["bn_eps"]) == (CONFIG.t, CONFIG.eps, CONFIG.bn_eps)
    assert MODEL["d_feat"] == 100 and MODEL["reduced"] == {}


# Keys of the cell's configuration that are not the graph's recipe.
NOT_RECIPE = {"name", "source", "why", "model", "guarantees", "reduced", "assumed"}


def test_config_graph_is_kron21s():
    """The cell's configuration makes kron21's graph, key for key, so the
    limit's readings on that graph hold; only its source and model differ."""
    bench = spec.benchmark()
    cfg = spec.config(bench, spec.cell(bench, CELL)["config"])
    kron21 = spec.config(bench, "kron21")
    assert {k: v for k, v in cfg.items() if k not in NOT_RECIPE} == {
        k: v for k, v in kron21.items() if k not in NOT_RECIPE}
    assert cfg["reduced"]["scale"]["to"] == cfg["scale"] == 21
    assert cfg["source"] != kron21["source"] and set(cfg["guarantees"]) == {"deepergcn"}


def test_config_model_is_the_mix():
    """The widths the configuration states are the mix's, which the app
    runs, and give the published parameter count."""
    bench = spec.benchmark()
    model = spec.config(bench, spec.cell(bench, CELL)["config"])["model"]
    assert model["traffic"] == spec.cell(bench, CELL)["traffic"]
    assert {k: v for k, v in model.items() if k not in ("traffic", "parameters")} == {
        k: MODEL[k] for k in model if k not in ("traffic", "parameters")}
    from repro_torch.configs.deepergcn import CONFIG
    params = gnn.init(torch.Generator().manual_seed(0), CONFIG, model["d_feat"], "cpu")
    assert sum(t.numel() for k, v in params.items() if k != "stats"
               for t in tree_leaves(v)) == model["parameters"]


def test_inputs_come_from_the_seed():
    """The same seed draws the same features and weights; another does not."""
    from gbench import graphs
    from gbench.apps import deepergcn
    bench = spec.benchmark()
    cfg = {**spec.config(bench, spec.cell(bench, CELL)["config"]), **SMALL}

    def inputs(seed):
        g = graphs.make(cfg, seed, torch.device("cpu"), weighted=False)
        app = deepergcn.App(g, MODEL, torch.device("cpu"))
        return app.x, app.params["stats"][13]["var"]

    (xa, va), (xb, vb) = inputs(2**31 + 5), inputs(2**31 + 5)
    assert torch.equal(xa, xb) and torch.equal(va, vb)
    xc, vc = inputs(2**31 + 6)
    assert not torch.equal(xa, xc) and not torch.equal(va, vc)


def test_norms_are_fitted_to_the_streams_they_normalise():
    """The app's running statistics are the moments of the streams the
    norms see: a second fitting forward finds them again bit for bit, and
    gives the check's answer. Fitted, every layer's input stays near unit
    scale, so the logits do too."""
    from gbench import graphs
    from gbench.apps import deepergcn
    from gbench.reference import deepergcn as reference
    bench = spec.benchmark()
    cfg = {**spec.config(bench, spec.cell(bench, CELL)["config"]), **SMALL}
    g = graphs.make(cfg, 2**31 + 7, torch.device("cpu"), weighted=False)
    app = deepergcn.App(g, MODEL, torch.device("cpu"))
    fitted = [dict(s) for s in app.params["stats"]]
    assert len(fitted) == MODEL["n_layers"]
    again = reference.deepergcn_forward(app.params, app.x, g.indptr, g.indices, MODEL["t"],
                                        MODEL["eps"], MODEL["bn_eps"], fit_stats=True)
    for a, b in zip(fitted, app.params["stats"]):
        assert a["mean"].dtype == torch.float32
        assert torch.equal(a["mean"], b["mean"]) and torch.equal(a["var"], b["var"])
    assert torch.equal(again, app.answer)
    assert 0.1 < float(app.answer.pow(2).mean().sqrt()) < 10


@pytest.mark.cuda
def test_card_run_small():
    """On a GPU: a traced run at scale 14 reads the cell's two metrics,
    each share at most 100%."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = run.run_cell(CELL, 2**31 + 43, 1.0, True, overrides={"scale": 14},
                       t0=time.perf_counter(), log=lambda s: None)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == set(METRICS)
    assert all(0 < v <= 100 for v in got.values())
