"""The benchmark's graphs at small scales on the CPU: GAP's recipe (symmetric,
no self-loops or duplicates, one weight per undirected edge), the edge
count, and DBG's order."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gbench import graphs, spec
from repro_torch.core.reorder import dbg_order

CPU = torch.device("cpu")
# E / (32 N) at scale 16: fewer duplicates than at small scales for kron
# (0.939 at scale 18, 0.959 at 20, measured with the port's CPU path);
# uniform graphs lose almost none
RATIO = {"kron25": (0.85, 0.96), "urand25": (0.999, 1.0)}


def make(name: str, scale: int, seed: int, weighted: bool = True) -> graphs.Graph:
    cfg = {**spec.config(spec.benchmark(), name), "scale": scale}
    return graphs.make(cfg, seed, CPU, weighted=weighted)


@pytest.fixture(scope="module", params=["kron25", "urand25"])
def graph(request):
    return request.param, make(request.param, 16, 2**31 + 11)


def test_symmetric_simple_and_weighted(graph):
    name, g = graph
    n = g.num_nodes
    src, dst = g.indices.long(), g.dst.long()
    assert bool((src != dst).all()), "self-loop"
    key = dst * n + src
    assert bool((key[1:] > key[:-1]).all()), "rows not sorted, or a duplicate edge"
    rev = src * n + dst
    pos = torch.searchsorted(key, rev)
    assert bool((key[pos] == rev).all()), "an edge without its reverse"
    w = g.weights
    assert bool((w[pos] == w).all()), "the two directions of an edge weigh differently"
    assert bool((w == w.round()).all()) and int(w.min()) >= 1 and int(w.max()) <= 255
    counts = torch.bincount(dst, minlength=n)
    assert torch.equal(g.indptr.long(), torch.cat([torch.zeros(1, dtype=torch.long),
                                                   counts.cumsum(0)]))


def test_edge_count(graph):
    name, g = graph
    lo, hi = RATIO[name]
    assert lo <= g.num_edges / (32 * g.num_nodes) <= hi
    assert g.num_edges < 2**31


def test_dbg_groups_non_increasing(graph):
    """Along the new ids, each vertex's DBG group (0 hottest) never falls."""
    _, g = graph
    deg = (g.indptr[1:] - g.indptr[:-1]).double()
    level = torch.floor(torch.log2(torch.clamp(deg / deg.mean(), min=1e-9)))
    group = torch.clamp(6 - level, 0, 7)
    assert bool((group[1:] >= group[:-1]).all())
    assert int(group[0]) < int(group[-1])  # more than one group in use


@pytest.mark.parametrize("name", ["kron25", "urand25"])
def test_dbg_rank_is_the_port_rule(name):
    g = make(name, 12, 5, weighted=False)
    degree = (g.indptr[1:] - g.indptr[:-1]).long()
    perm = torch.randperm(g.num_nodes, generator=torch.Generator().manual_seed(3))
    shuffled = degree[perm]
    np.testing.assert_array_equal(graphs.dbg_rank(shuffled).numpy(),
                                  dbg_order(shuffled.numpy()))


@pytest.mark.parametrize("name", ["kron25", "urand25"])
def test_seed_relabels_the_same_graph(name):
    """One seed gives one graph; another seed the same graph under other labels."""
    a, b = make(name, 12, 1), make(name, 12, 1)
    c = make(name, 12, 2)
    for x, y in ((a.indices, b.indices), (a.dst, b.dst), (a.weights, b.weights)):
        assert torch.equal(x, y)
    assert not torch.equal(a.indices, c.indices)
    # map c's labels back to a's through the generated ids: the same weighted edge set
    a_of_c = torch.empty_like(c.final_of_orig)
    a_of_c[c.final_of_orig] = a.final_of_orig
    n = a.num_nodes
    key_a = a.dst.long() * n + a.indices.long()
    key_c = a_of_c[c.dst.long()] * n + a_of_c[c.indices.long()]
    order = torch.argsort(key_c)
    assert torch.equal(key_c[order], key_a)
    assert torch.equal(c.weights[order], a.weights)
