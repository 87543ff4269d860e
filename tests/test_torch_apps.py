"""repro_torch.apps vs the JAX package (``gather_impl="jnp"``) and networkx,
plus the quickstart pipeline as a whole, on the CPU."""
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
from repro.graph.csr import apply_reorder
from repro_torch import apps as t_apps
from repro_torch import convert
from repro_torch.apps import engine as t_engine

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))


@pytest.fixture(scope="module")
def graphs():
    g = j_generate.rmat(9, 8, seed=3)
    return g, convert.csr_from_numpy(g.indptr, g.indices, g.num_nodes)


@pytest.mark.parametrize("impl", ["hot", "plain"])
@pytest.mark.parametrize("tol,max_iters", [(1e-6, 100), (1e-9, 200), (0.0, 7)])
def test_pagerank_matches_reference(graphs, impl, tol, max_iters):
    jg, tg = graphs
    want = np.asarray(j_apps.pagerank(jg.device(), tol=tol, max_iters=max_iters,
                                      gather_impl="jnp"))
    got = t_apps.pagerank(tg.device("cpu"), tol=tol, max_iters=max_iters, gather_impl=impl)
    assert got.dtype == torch.float32 and got.shape == (jg.num_nodes,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_pagerank_matches_networkx(graphs):
    jg, tg = graphs
    G = nx.DiGraph()
    G.add_nodes_from(range(jg.num_nodes))
    G.add_edges_from(zip(jg.indices.tolist(), jg.dst_ids().tolist()))
    pr = t_apps.pagerank(tg.device("cpu"), tol=1e-9, max_iters=200).numpy()
    ref = nx.pagerank(G, alpha=0.85, tol=1e-10)
    ref = np.array([ref[i] for i in range(jg.num_nodes)])
    assert pr.sum() == pytest.approx(1.0, abs=1e-3)
    assert np.abs(pr - ref).max() < 1e-4


REDUCERS = ["sum_reduce", "min_reduce", "max_reduce", "or_reduce"]


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("name", REDUCERS)
def test_reducers_match_segment_ops(name, dtype):
    """Empty segments keep jax.ops.segment_*'s values (+inf / -inf / dtype
    extremes / 0 for the uint32 or-reduce)."""
    rng = np.random.default_rng(5)
    seg = np.sort(rng.integers(0, 40, 200)).astype(np.int32)
    seg[seg % 7 == 3] = 0  # leave some segments empty
    data = (rng.standard_normal((200, 3)) * 100).astype(dtype)
    if name == "or_reduce":
        data = np.abs(data).astype(np.int32)
    want = np.asarray(getattr(j_engine, name)(jnp.asarray(data), jnp.asarray(seg), 50))
    got = getattr(t_engine, name)(torch.as_tensor(data), torch.as_tensor(seg), 50).numpy()
    assert got.dtype == want.dtype
    if dtype == "float32" and name == "sum_reduce":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)  # summation order
    else:
        np.testing.assert_array_equal(got, want)


def test_edge_maps_match_reference(graphs):
    jg, tg = graphs
    jd, td = jg.device(), tg.device("cpu")
    rng = np.random.default_rng(6)
    prop = rng.standard_normal((jg.num_nodes, 4)).astype(np.float32)
    active = rng.random(jg.num_nodes) < 0.5
    edge_fn_j = lambda m, g: m * 2.0 + 1.0  # noqa: E731
    edge_fn_t = lambda m, g: m * 2.0 + 1.0  # noqa: E731
    want = j_engine.edge_map_pull(jd, jnp.asarray(prop), jnp.asarray(active), edge_fn_j,
                                  j_engine.max_reduce, identity=-jnp.inf)
    for impl in ("hot", "plain"):
        got = t_engine.edge_map_pull(td, torch.as_tensor(prop), torch.as_tensor(active),
                                     edge_fn_t, t_engine.max_reduce, identity=float("-inf"),
                                     gather_impl=impl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jo = j_generate.rmat(9, 8, seed=3)
    from repro.graph.csr import transpose
    jout = transpose(jo)
    tout = convert.csr_from_numpy(jout.indptr, jout.indices, jout.num_nodes)
    want = j_engine.edge_map_push(jout.device(), jnp.asarray(prop[:, 0]), jnp.asarray(active))
    got = t_engine.edge_map_push(tout.device("cpu"), torch.as_tensor(prop[:, 0]),
                                 torch.as_tensor(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        t_engine.gather_src(td, torch.as_tensor(prop), "pallas_hot")


def test_gather_src_routes_agree(graphs):
    jg, tg = graphs
    td = tg.device("cpu")
    prop = np.random.default_rng(7).standard_normal(jg.num_nodes).astype(np.float32)
    want = np.asarray(j_engine.gather_src(jg.device(), jnp.asarray(prop)))
    for impl in ("hot", "plain"):
        np.testing.assert_array_equal(
            t_engine.gather_src(td, torch.as_tensor(prop), impl).numpy(), want)
        np.testing.assert_array_equal(
            t_engine.gather_src(td, torch.as_tensor(prop[:, None]), impl).numpy()[:, 0], want)


def test_choose_direction_matches_reference(graphs):
    jg, tg = graphs
    rng = np.random.default_rng(8)
    for frac in (0.001, 0.05, 0.5):
        active = rng.random(jg.num_nodes) < frac
        for sf in (0.01, 0.05, 0.2):
            want = bool(j_engine.choose_direction(jg.device(), jnp.asarray(active),
                                                  j_engine.EngineConfig(switch_fraction=sf)))
            got = bool(t_engine.choose_direction(tg.device("cpu"), torch.as_tensor(active),
                                                 t_engine.EngineConfig(switch_fraction=sf)))
            assert got == want


def test_quickstart_pipeline_matches_reference():
    """The slice as a whole: examples/quickstart_torch.main("cpu") against the
    JAX package's steps of examples/quickstart.py on the same graph."""
    import quickstart_torch

    out = quickstart_torch.main("cpu")
    g = j_datasets.load("tw", scale=13)
    g2 = apply_reorder(g, reorder_ranks(g, "dbg"))
    pr = np.asarray(j_apps.pagerank(g2.device()))
    np.testing.assert_allclose(out["pagerank"], pr, rtol=1e-5, atol=1e-7)
    llc = j_datasets.scaled_llc_bytes("tw", g2, elem_bytes=16)
    tr, _ = j_traces.generate_trace(g2, "pr", llc)
    assert out["trace_length"] == tr.length
    for policy, res in out["results"].items():
        want = j_cachesim.simulate(tr, policy, llc)
        np.testing.assert_array_equal(res.hits_by_hint, want.hits_by_hint)
    want_speedup = j_cachesim.PerfModel().speedup(
        j_cachesim.simulate(tr, "rrip", llc), j_cachesim.simulate(tr, "grasp", llc))
    assert out["speedup"] == want_speedup > 1.0
    assert out["gather_err"] == 0.0
    jax.clear_caches()
