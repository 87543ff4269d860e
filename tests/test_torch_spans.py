"""The graph apps' spans (``repro_torch.spans``, ``apps/engine.py``'s edge
maps, the PRD and SSSP loops): answers unchanged under a profiler, no span
and no extra ``stats`` without one, and the spans each iteration opens and
how they nest, on the CPU."""
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import apps, spans
from repro_torch.graph import generate
from repro_torch.graph.csr import CSR, symmetrize, transpose

MAX_ITERS = 4  # a cap below both apps' iteration counts on this graph


@pytest.fixture(scope="module")
def graph():
    g = symmetrize(generate.rmat(10, 8, seed=3))  # SSSP reaches all but a few vertices
    w = np.random.default_rng(5).integers(1, 64, g.num_edges).astype(np.float32)
    g_out = transpose(CSR(indptr=g.indptr, indices=g.indices, num_nodes=g.num_nodes, weights=w))
    return {"in": g.device("cpu"), "out": g_out.device("cpu"),
            "source": int(np.argmax(g.out_degree))}


def run(graph, app: str, stats: dict, max_iters: int | None = None):
    if app == "sssp":
        return apps.sssp(graph["out"], graph["source"], max_iters or 10_000, stats=stats)
    impl = app.split("-")[1]
    return apps.pagerank_delta(graph["in"], max_iters=max_iters or 100, gather_impl=impl,
                               stats=stats)


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


APPS = ["prd-hot", "prd-plain", "sssp"]


@pytest.mark.parametrize("app", APPS)
def test_answers_identical_under_a_profiler(graph, app):
    plain = run(graph, app, {})
    (answer, _) = traced(lambda: run(graph, app, {}))
    assert torch.equal(plain.view(torch.int32), answer.view(torch.int32))


@pytest.mark.parametrize("app", APPS)
def test_untraced_spans_are_one_null_context(graph, app):
    assert not spans.enabled()
    assert spans.span("apps.iter") is spans.span("engine.reduce")
    assert isinstance(spans.span("apps.flag"), contextlib.nullcontext)
    stats = {}
    run(graph, app, stats)
    assert list(stats) == (["iters", "edges_relaxed"] if app == "sssp" else ["iters"])
    assert stats["iters"] > MAX_ITERS


def inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("capped", [False, True], ids=["converged", "max_iters"])
@pytest.mark.parametrize("app", APPS)
def test_spans_an_iteration(graph, app, capped):
    stats = {}
    _, events = traced(lambda: run(graph, app, stats, MAX_ITERS if capped else None))
    by_name = {name: [ev for ev in events if ev.name == name]
               for name in ("apps.iter", "apps.flag", "engine.gather", "engine.reduce",
                            "aten::_local_scalar_dense")}
    iters = stats["iters"]
    assert iters == MAX_ITERS if capped else iters > MAX_ITERS
    assert len(by_name["apps.iter"]) == iters
    assert len(by_name["apps.flag"]) == iters + (0 if capped else 1)
    for name in ("engine.gather", "engine.reduce"):
        assert len(by_name[name]) == iters
        assert all(any(inside(ev, it) for it in by_name["apps.iter"]) for ev in by_name[name])
    assert not any(inside(f, it) for f in by_name["apps.flag"] for it in by_name["apps.iter"])
    # the host reads the device once an iteration, the flag, and the spans add
    # no read; after its loop SSSP reads its count of relaxed edges once, and
    # PRD reads nothing
    reads = by_name["aten::_local_scalar_dense"]
    in_flags = [r for r in reads if any(inside(r, f) for f in by_name["apps.flag"])]
    assert len(in_flags) == len(by_name["apps.flag"])
    after = [r for r in reads if r not in in_flags]
    assert len(after) == (1 if app == "sssp" else 0)
    assert all(r.time_range.start >= f.time_range.end for r in after
               for f in by_name["apps.flag"])


def test_pagerank_gets_the_engine_spans(graph):
    """``pagerank``'s edge map opens the engine's spans an iteration; its
    one-off out-degree sum lies outside every ``engine.reduce``."""
    stats = {}
    plain = apps.pagerank(graph["in"])
    ranks, events = traced(lambda: apps.pagerank(graph["in"], stats=stats))
    assert torch.equal(plain.view(torch.int32), ranks.view(torch.int32))
    for name in ("engine.gather", "engine.reduce"):
        assert sum(ev.name == name for ev in events) == stats["iters"] > 1
    reduces = [ev for ev in events if ev.name == "engine.reduce"]
    first_add = min((ev for ev in events if ev.name == "aten::index_add_"),
                    key=lambda ev: ev.time_range.start)
    assert not any(inside(first_add, r) for r in reduces)
