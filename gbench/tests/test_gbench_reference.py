"""The plain references against the port's CPU path and against textbook
versions, on small graphs of both configurations."""
from __future__ import annotations

import heapq

import numpy as np
import pytest
import torch

from gbench import graphs, spec
from gbench.apps.sssp import pick_sources
from gbench.reference import prd as ref_prd
from gbench.reference import sssp as ref_sssp
from repro_torch import apps
from repro_torch.graph.csr import DeviceCSR

CPU = torch.device("cpu")
PRD = spec.traffic("prd")["params"]
# float32 sums over 60 iterations against float64: a few ulps a step
PRD_REL = 1e-5


def make(name: str, scale: int) -> graphs.Graph:
    cfg = {**spec.config(spec.benchmark(), name), "scale": scale}
    return graphs.make(cfg, 7, CPU, weighted=True)


def csr(g: graphs.Graph) -> DeviceCSR:
    return DeviceCSR(indptr=g.indptr, indices=g.indices, dst=g.dst, weights=g.weights,
                     num_nodes=g.num_nodes)


@pytest.fixture(scope="module", params=["kron25", "urand25"])
def graph(request):
    return make(request.param, 12)


def test_prd_reference_matches_the_port(graph):
    stats = {}
    got = apps.pagerank_delta(csr(graph), PRD["damping"], PRD["epsilon"], PRD["max_iters"],
                              stats=stats)
    want, frontier = ref_prd.pagerank_delta(graph.indptr, graph.indices, graph.dst,
                                            PRD["damping"], PRD["epsilon"], PRD["max_iters"])
    assert want.dtype == torch.float64
    assert float(((got.double() - want).abs() / want).max()) < PRD_REL
    assert abs(len(frontier) - stats["iters"]) <= 1
    n, e = graph.num_nodes, graph.num_edges
    assert frontier[0] == (n, e)  # all vertices active at first
    assert all(f <= e and a <= n for a, f in frontier)


def dijkstra(g: graphs.Graph, source: int) -> np.ndarray:
    indptr, src, w = g.indptr.numpy(), g.indices.numpy(), g.weights.numpy()
    dist = np.full(g.num_nodes, np.inf)
    dist[source] = 0
    heap = [(0.0, source)]
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        # the graph is symmetric: v's in-edges are its out-edges
        for u, wt in zip(src[indptr[v]:indptr[v + 1]], w[indptr[v]:indptr[v + 1]]):
            if d + wt < dist[u]:
                dist[u] = d + wt
                heapq.heappush(heap, (d + wt, u))
    return dist


def test_sssp_reference_matches_the_port_and_dijkstra(graph):
    for source in pick_sources(graph, 3, 27491095):
        want, frontier = ref_sssp.sssp(graph.indptr, graph.indices, graph.dst, graph.weights,
                                       source)
        far = want == torch.iinfo(torch.int64).max
        want = torch.where(far, float("inf"), want.double())
        stats = {}
        got = apps.sssp(csr(graph), source, stats=stats)
        assert torch.equal(got.double(), want)
        assert len(frontier) == stats["iters"]
        np.testing.assert_array_equal(want.numpy(), dijkstra(graph, source))


def test_controls_are_lower_precision(graph):
    """The controls run the same references in bfloat16."""
    rank, _ = ref_prd.pagerank_delta(graph.indptr, graph.indices, graph.dst, PRD["damping"],
                                     PRD["epsilon"], 3, dtype=torch.bfloat16)
    assert rank.dtype == torch.bfloat16
    dist, _ = ref_sssp.sssp(graph.indptr, graph.indices, graph.dst, graph.weights, 0,
                            dtype=torch.bfloat16)
    assert dist.dtype == torch.bfloat16
