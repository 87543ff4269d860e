"""The paper's application suite in repro_torch (PageRank-Delta, SSSP, BC,
Radii) and examples/graph_suite_torch.py, against the JAX package
(``gather_impl="jnp"``) and independent references (networkx, a hand
Brandes), on the CPU."""
import collections
import os
import sys

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from repro import apps as j_apps
from repro.apps import engine as j_engine
from repro.core import cachesim as j_cachesim
from repro.core.reorder import reorder_ranks
from repro.graph import datasets as j_datasets
from repro.graph import generate as j_generate
from repro.graph import traces as j_traces
from repro.graph.csr import apply_reorder, transpose
from repro_torch import apps as t_apps
from repro_torch import convert
from repro_torch.apps import engine as t_engine

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

# summation order differs (index_add_ vs segment_sum); one vertex's active
# flag can flip on it, moving its rank by about epsilon of itself
PRD_TOL = dict(rtol=1e-4, atol=1e-7)
DELTA_TOL = dict(rtol=1e-5, atol=1e-6)


def port(c):
    return convert.csr_from_numpy(c.indptr, c.indices, c.num_nodes, c.weights)


@pytest.fixture(scope="module")
def g():
    return j_generate.rmat(9, 8, seed=3)


@pytest.fixture(scope="module")
def nxg(g):
    G = nx.DiGraph()
    G.add_nodes_from(range(g.num_nodes))
    G.add_edges_from(zip(g.indices.tolist(), g.dst_ids().tolist()))
    return G


def source_id(g, which: str) -> int:
    """Vertex 0 (the JAX package's tests' root, which reaches little of
    this graph), or the vertex of most out-edges (which reaches a fifth)."""
    return 0 if which == "zero" else int(np.argmax(g.out_degree))


@pytest.mark.parametrize("impl", ["hot", "plain"])
@pytest.mark.parametrize("epsilon,max_iters", [(1e-5, 100), (1e-9, 300), (0.0, 3)])
def test_pagerank_delta_matches_reference(g, impl, epsilon, max_iters):
    want = np.asarray(j_apps.pagerank_delta(g.device(), epsilon=epsilon, max_iters=max_iters,
                                            gather_impl="jnp"))
    stats = {}
    got = t_apps.pagerank_delta(port(g).device("cpu"), epsilon=epsilon, max_iters=max_iters,
                                gather_impl=impl, stats=stats)
    assert got.dtype == torch.float32 and got.shape == (g.num_nodes,)
    np.testing.assert_allclose(got.numpy(), want, **PRD_TOL)
    assert 1 <= stats["iters"] <= max_iters
    if epsilon == 0.0:
        assert stats["iters"] == max_iters  # every vertex with a change stays active


def test_pagerank_delta_approximates_pagerank(g):
    tg = port(g).device("cpu")
    pr = t_apps.pagerank(tg, tol=1e-9, max_iters=200).numpy()
    prd = t_apps.pagerank_delta(tg, epsilon=1e-9, max_iters=300).numpy()
    # PRD is an approximation (no dangling redistribution): rankings agree
    k = 50
    top_pr = set(np.argsort(-pr)[:k].tolist())
    top_prd = set(np.argsort(-prd)[:k].tolist())
    assert len(top_pr & top_prd) >= int(0.8 * k)


@pytest.mark.parametrize("source", ["zero", "hub"])
@pytest.mark.parametrize("weighted", [True, False])
def test_sssp_matches_reference_and_dijkstra(g, weighted, source):
    gw = j_generate.add_uniform_weights(g, seed=1) if weighted else g
    gout = transpose(gw)
    s = source_id(g, source)
    want = np.asarray(j_apps.sssp(gout.device(), s))
    stats = {}
    got = t_apps.sssp(port(gout).device("cpu"), s, stats=stats).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert stats["iters"] >= 1

    GW = nx.DiGraph()
    GW.add_nodes_from(range(g.num_nodes))
    w = gw.weights if weighted else np.ones(gw.num_edges, np.float32)
    for a, b, wt in zip(gw.indices.tolist(), gw.dst_ids().tolist(), w.tolist()):
        GW.add_edge(a, b, weight=wt)
    ref = nx.single_source_dijkstra_path_length(GW, s)
    for v in range(g.num_nodes):
        if v in ref:
            assert got[v] == pytest.approx(ref[v], abs=1e-3)
        else:
            assert np.isinf(got[v])
    if source == "hub":
        assert len(ref) > 100


def _brandes_ref(G, s):
    S, P = [], collections.defaultdict(list)
    sigma = collections.defaultdict(float)
    dist = {s: 0}
    sigma[s] = 1.0
    Q = collections.deque([s])
    while Q:
        v = Q.popleft()
        S.append(v)
        for w in G.successors(v):
            if w not in dist:
                dist[w] = dist[v] + 1
                Q.append(w)
            if dist[w] == dist[v] + 1:
                sigma[w] += sigma[v]
                P[w].append(v)
    delta = collections.defaultdict(float)
    while S:
        w = S.pop()
        for v in P[w]:
            delta[v] += sigma[v] / sigma[w] * (1 + delta[w])
    return delta, sigma, dist


@pytest.mark.parametrize("source", ["zero", "hub"])
@pytest.mark.parametrize("max_levels", [64, 2])
def test_bc_matches_reference_and_brandes(g, nxg, max_levels, source):
    gout = transpose(g)
    s = source_id(g, source)
    wd, ws, wl = map(np.asarray, j_apps.bc_single_source(gout.device(), s,
                                                         max_levels=max_levels))
    stats = {}
    delta, sigma, level = (x.numpy() for x in t_apps.bc_single_source(
        port(gout).device("cpu"), s, max_levels=max_levels, stats=stats))
    assert (delta.dtype, sigma.dtype, level.dtype) == (np.float32, np.float32, np.int32)
    np.testing.assert_array_equal(level, wl)
    np.testing.assert_array_equal(sigma, ws)
    np.testing.assert_allclose(delta, wd, **DELTA_TOL)
    assert stats["iters"] <= max_levels
    if max_levels < 64:
        assert level.max() <= max_levels
        return
    dref, sgref, distref = _brandes_ref(nxg, s)
    assert (level >= 0).sum() == len(distref)
    for v, d in distref.items():
        assert level[v] == d
        assert sigma[v] == pytest.approx(sgref[v], rel=1e-4)
    for v, dd in dref.items():
        assert delta[v] == pytest.approx(dd, rel=1e-2, abs=1e-2)


@pytest.mark.parametrize("max_iters", [64, 2])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_radii_matches_reference(g, k, max_iters):
    want_r, want_m = map(np.asarray, j_apps.radii_estimate(
        g.device(), jnp.arange(k, dtype=jnp.int32), max_iters=max_iters))
    stats = {}
    radii, mask = t_apps.radii_estimate(port(g).device("cpu"), torch.arange(k),
                                        max_iters=max_iters, stats=stats)
    assert radii.dtype == torch.int32 and mask.dtype == torch.uint32
    radii, mask = radii.numpy(), mask.numpy()
    np.testing.assert_array_equal(radii, want_r)
    np.testing.assert_array_equal(mask, want_m)
    assert stats["iters"] <= max_iters
    if k == 32:
        assert (mask >> 31).any()  # bit 31 survives the int64 arithmetic


def test_engine_pull_push_consistency(g):
    """Pull over in-CSR == push over out-CSR for a linear reduction, and the
    pull equals the JAX package's."""
    prop = np.random.default_rng(0).random(g.num_nodes).astype(np.float32)
    pull = t_engine.edge_map_pull(port(g).device("cpu"), torch.as_tensor(prop),
                                  reduce_fn=t_engine.sum_reduce).numpy()
    push = t_engine.edge_map_push(port(transpose(g)).device("cpu"), torch.as_tensor(prop),
                                  reduce_fn=t_engine.sum_reduce, identity=0.0).numpy()
    assert np.allclose(pull, push, atol=1e-3)
    want = np.asarray(j_engine.edge_map_pull(g.device(), jnp.asarray(prop),
                                             reduce_fn=j_engine.sum_reduce))
    np.testing.assert_allclose(pull, want, rtol=1e-6, atol=1e-6)


def test_graph_suite_matches_reference():
    """The slice as a whole: examples/graph_suite_torch.main on the CPU
    against the JAX package's steps of examples/graph_suite.py on the same
    graphs, and the same RRIP and GRASP counts on each app's trace."""
    import graph_suite_torch

    out = graph_suite_torch.main("tw", 10, device="cpu")
    g = j_datasets.load("tw", scale=10)
    g2 = apply_reorder(g, reorder_ranks(g, "dbg"))
    for label, jg in (("original", g), ("dbg", g2)):
        got = {k: (v.numpy() if torch.is_tensor(v) else [x.numpy() for x in v])
               for k, v in out["outputs"][label].items()}
        dg = jg.device()
        np.testing.assert_allclose(got["pr"], np.asarray(j_apps.pagerank(dg)),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got["prd"], np.asarray(j_apps.pagerank_delta(dg)),
                                   **PRD_TOL)
        out_csr = transpose(j_generate.add_uniform_weights(jg, seed=1)).device()
        np.testing.assert_array_equal(got["sssp"], np.asarray(j_apps.sssp(out_csr, 0)))
        wd, ws, wl = map(np.asarray, j_apps.bc_single_source(transpose(jg).device(), 0))
        np.testing.assert_array_equal(got["bc"][2], wl)
        np.testing.assert_array_equal(got["bc"][1], ws)
        np.testing.assert_allclose(got["bc"][0], wd, **DELTA_TOL)
        wr, wm = map(np.asarray, j_apps.radii_estimate(dg, jnp.arange(8, dtype=jnp.int32)))
        np.testing.assert_array_equal(got["radii"][0], wr)
        np.testing.assert_array_equal(got["radii"][1], wm)
        assert set(out["iters"][label]) == set(graph_suite_torch.APPS)

    llc = j_datasets.scaled_llc_bytes("tw", g2, elem_bytes=16)
    assert out["llc_bytes"] == llc
    pm = j_cachesim.PerfModel()
    for app in graph_suite_torch.APPS:
        tr, _ = j_traces.generate_trace(g2, app, llc, max_records=600_000)
        want = {p: j_cachesim.simulate(tr, p, llc) for p in ("rrip", "grasp")}
        for p, res in out["results"][app].items():
            np.testing.assert_array_equal(res.hits_by_hint, want[p].hits_by_hint)
        assert out["speedups"][app] == pm.speedup(want["rrip"], want["grasp"])
    jax.clear_caches()
