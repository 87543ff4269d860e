"""repro_torch.kernels.segment_sum and the pull sum through it.

On the CPU the wrapper computes its plain version, ``index_add_`` over the
rows' ids; the CPU tests hold it bit for bit to ``index_add_`` over a
CSR's ``dst``, and ``edge_map_pull``, PageRank-Delta and PageRank to the
bits they had with ``index_add_`` alone. The card tests hold the CUDA
kernel to a float64 sum within its error bound, a launch to a repeat of
itself bit for bit, and PageRank-Delta's pull to one launch an iteration.
This file imports only the port, so the card tests run without the
repository's conftest:

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda tests/test_torch_segment_sum.py
"""
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import apps
from repro_torch.apps import engine
from repro_torch.graph import generate
from repro_torch.graph.csr import DeviceCSR, transpose
from repro_torch.kernels.segment_sum import ref
from repro_torch.kernels.segment_sum import segment_sum as kernel

U = 2.0 ** -24  # float32's unit roundoff


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def csr_of(counts, seed=0, signed=True):
    """A ``DeviceCSR`` on the CPU whose row r has ``counts[r]`` in-edges
    from random sources, and one float32 message an edge (both signs, or
    positive as PageRank's are)."""
    counts = np.asarray(counts, dtype=np.int64)
    n, e = len(counts), int(counts.sum())
    rng = np.random.default_rng(seed)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    g = DeviceCSR(indptr=torch.as_tensor(indptr.astype(np.int32)),
                  indices=torch.as_tensor(rng.integers(0, n, e).astype(np.int32)),
                  dst=torch.as_tensor(np.repeat(np.arange(n, dtype=np.int32), counts)),
                  weights=None, num_nodes=n)
    msgs = rng.standard_normal(e) if signed else rng.random(e)
    return g, torch.as_tensor(msgs.astype(np.float32))


# row lengths of the CPU cases; the last three rows of "hub" hold one
# neighbour each beside a row with most of the edges
SHAPES = {
    "empty_rows": [3, 0, 5, 0, 0, 1, 7, 0, 2, 9, 0, 4],
    "empty_tail": [6, 2, 9, 1] + [0] * 40,
    "hub": [1, 0, 2] + [5000] + [1, 1, 1],
    "no_edges": [0, 0, 0, 0, 0],
    "one_row": [4099],
    "ragged": [5, 3, 2, 7, 1, 3, 2],  # E = 23, not a multiple of 4
}


def same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# --- the CPU's plain path ---------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_path_matches_index_add_over_dst(shape):
    g, msgs = csr_of(SHAPES[shape])
    got = kernel.segment_sum(msgs, g.indptr, g.num_nodes)
    assert got.dtype == torch.float32 and got.shape == (g.num_nodes,)
    assert same_bits(got, engine.sum_reduce(msgs, g.dst, g.num_nodes))
    assert same_bits(ref.segment_sum_ref(msgs, g.indptr, g.num_nodes),
                     msgs.new_zeros(g.num_nodes).index_add_(0, g.dst, msgs))


def test_row_ids_are_the_csrs_dst():
    g, _ = csr_of(SHAPES["empty_rows"])
    assert torch.equal(ref.row_ids(g.indptr, g.num_nodes), g.dst.long())


def test_rows_with_no_messages_hold_zero():
    g, msgs = csr_of(SHAPES["empty_rows"])
    got = kernel.segment_sum(msgs, g.indptr, g.num_nodes)
    empty = g.indptr[1:] == g.indptr[:-1]
    assert same_bits(got[empty], torch.zeros(int(empty.sum())))


@pytest.mark.parametrize("data,indptr,n,error", [
    (torch.zeros(4, dtype=torch.int64), torch.tensor([0, 4], dtype=torch.int32), 1, TypeError),
    (torch.zeros(4, dtype=torch.float64), torch.tensor([0, 4], dtype=torch.int32), 1,
     TypeError),
    (torch.zeros(4), torch.tensor([0, 4]), 1, TypeError),  # int64 offsets
    (torch.zeros(4, 2), torch.tensor([0, 4], dtype=torch.int32), 1, ValueError),
    (torch.zeros(4), torch.tensor([0, 2, 4], dtype=torch.int32), 1, ValueError),
    (torch.zeros(4), torch.tensor([0, 4], dtype=torch.int32), 2, ValueError),
    (torch.zeros(4), torch.tensor([0, 3], dtype=torch.int32), 1, ValueError),
    (torch.zeros(4), torch.tensor([0, 4], dtype=torch.int32), -1, ValueError),
    (torch.zeros(4), torch.tensor([0, 4], dtype=torch.int32, device="meta"), 1, ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(data, indptr, n, error):
    with pytest.raises(error):
        kernel.segment_sum(data, indptr, n)


def today_pull(g, prop, active_dst=None, edge_fn=None, reduce_fn=engine.sum_reduce,
               identity=0.0, gather_impl="hot"):
    """``edge_map_pull`` as it was with ``index_add_`` alone: the engine's
    gather, then ``reduce_fn`` over ``g.dst``."""
    msgs = engine.gather_src(g, prop, gather_impl)
    if edge_fn is not None:
        msgs = edge_fn(msgs, g)
    if active_dst is not None:
        msgs = torch.where(active_dst[g.dst], msgs, identity)
    return reduce_fn(msgs, g.dst, g.num_nodes)


def csr_route_pull(g, prop, active_dst=None, edge_fn=None, reduce_fn=engine.sum_reduce,
                   identity=0.0, gather_impl="hot"):
    """``edge_map_pull`` with its sums sent to the segment-sum wrapper on
    the CPU too: the route the card takes, with the plain version."""
    assert reduce_fn is engine.sum_reduce
    msgs = engine.gather_src(g, prop, gather_impl)
    if active_dst is not None:
        msgs = torch.where(active_dst[g.dst], msgs, identity)
    return kernel.segment_sum(msgs, g.indptr, g.num_nodes)


def rmat_csr(scale=10, seed=3):
    return generate.rmat(scale, 8, seed=seed).device("cpu")


@pytest.mark.parametrize("gather_impl", ["hot", "plain"])
@pytest.mark.parametrize("masked", [False, True])
def test_edge_map_pull_on_cpu_keeps_index_add(monkeypatch, gather_impl, masked):
    """On the CPU the pull's sum stays ``index_add_``: today's bits, and
    the wrapper is not called; the CSR route's plain version gives the same
    bits."""
    g = rmat_csr()
    rng = np.random.default_rng(1)
    prop = torch.as_tensor(rng.random(g.num_nodes).astype(np.float32))
    active = torch.as_tensor(rng.random(g.num_nodes) < 0.5) if masked else None
    calls = []
    monkeypatch.setattr(engine, "segment_sum",
                        lambda *a: calls.append(1) or kernel.segment_sum(*a))
    got = engine.edge_map_pull(g, prop, active, reduce_fn=engine.sum_reduce,
                               gather_impl=gather_impl)
    assert not calls
    assert same_bits(got, today_pull(g, prop, active, gather_impl=gather_impl))
    assert same_bits(got, csr_route_pull(g, prop, active, gather_impl=gather_impl))


@pytest.mark.parametrize("app", ["pagerank_delta", "pagerank"])
@pytest.mark.parametrize("pull", ["today", "csr_route"])
def test_apps_on_cpu_keep_their_bits(monkeypatch, app, pull):
    """PageRank-Delta and PageRank on the CPU give the bits of the pull
    with ``index_add_`` alone, and of the pull through the CSR route's plain
    version."""
    g = rmat_csr()
    run = getattr(apps, app)
    stats = {}
    got = run(g, stats=stats)
    # apps.pagerank is the function; its module is apps/pagerank.py
    module = importlib.import_module(
        "repro_torch.apps." + ("prdelta" if app == "pagerank_delta" else "pagerank"))
    monkeypatch.setattr(module, "edge_map_pull",
                        today_pull if pull == "today" else csr_route_pull)
    want_stats = {}
    want = run(g, stats=want_stats)
    assert stats["iters"] == want_stats["iters"] >= 2
    assert same_bits(got, want)


# --- the kernel on the card -------------------------------------------------

# row lengths around a warp, a block's tile and a 2^20-edge hub that spans
# hundreds of tiles, between rows without edges
CARD_ROWS = [0, 1, 31, 32, 33, 0, 4095, 4096, 4097, 0, 0, 1 << 20, 0, 7, 4096 * 3 + 5, 0]


def card_case(seed=0, signed=True, tail_rows=200_000):
    """``CARD_ROWS``, then ``tail_rows`` rows of 0-40 edges (a third of
    them empty), then 5,000 empty rows."""
    rng = np.random.default_rng(seed)
    tail = rng.integers(0, 41, tail_rows)
    tail[rng.random(tail_rows) < 1 / 3] = 0
    counts = np.concatenate([CARD_ROWS, tail, np.zeros(5000, dtype=np.int64)])
    return csr_of(counts, seed, signed)


def within_bound(got, msgs, indptr, n):
    """Each row against its float64 sum: within (64 + its length / 1024)
    float32 roundings of its sum of magnitudes, above the kernel's bound of
    (30 + tiles the row spans) for tiles of 1,024 items or more."""
    ids = ref.row_ids(indptr.cpu(), n)
    m = msgs.cpu().double()
    exact = torch.zeros(n, dtype=torch.float64).index_add_(0, ids, m)
    mags = torch.zeros(n, dtype=torch.float64).index_add_(0, ids, m.abs())
    lengths = (indptr[1:] - indptr[:-1]).cpu().double()
    err = (got.cpu().double() - exact).abs()
    return bool((err <= (64 + lengths / 1024) * U * mags).all()), float((err / mags.clamp(
        min=1e-300)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("signed", [True, False])
def test_kernel_within_bound_of_float64(cuda, signed, offset):
    """Hub, tile-edge and empty rows; ``offset`` 1 drops the first message
    and shifts every offset, so the messages start off 16-byte alignment
    (the first tile's first quad reaches before the array and is read an
    element at a time) and E is odd."""
    g, msgs = card_case(seed=2, signed=signed)
    indptr = g.indptr.to(cuda)
    data = msgs.to(cuda)
    if offset:
        data, indptr = data[1:], (indptr - 1).clamp(min=0).to(torch.int32)
    before = kernel.segment_sum.launches
    got = kernel.segment_sum(data, indptr, g.num_nodes)
    torch.cuda.synchronize()
    assert kernel.segment_sum.launches == before + 1
    ok, worst = within_bound(got, data, indptr, g.num_nodes)
    assert ok, worst
    empty = (indptr[1:] == indptr[:-1]).cpu()
    assert same_bits(got.cpu()[empty], torch.zeros(int(empty.sum())))


@pytest.mark.cuda
def test_kernel_rows_across_the_carry_groups(cuda):
    """A row of 2^22 messages spans more than the carry pass's group of
    1,024 tiles; a row of 3 * 2^20 follows, and one message a row after."""
    g, msgs = csr_of([3, 1 << 22, 0, 5, 3 << 20] + [1] * 1000 + [0] * 10, seed=6)
    got = kernel.segment_sum(msgs.to(cuda), g.indptr.to(cuda), g.num_nodes)
    ok, worst = within_bound(got, msgs, g.indptr, g.num_nodes)
    assert ok, worst


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_on_the_cpu_shapes(cuda, shape):
    g, msgs = csr_of(SHAPES[shape], seed=4)
    got = kernel.segment_sum(msgs.to(cuda), g.indptr.to(cuda), g.num_nodes)
    ok, worst = within_bound(got, msgs, g.indptr, g.num_nodes)
    assert got.shape == (g.num_nodes,) and ok, worst


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit(cuda):
    g, msgs = card_case(seed=5)
    data, indptr = msgs.to(cuda), g.indptr.to(cuda)
    first = kernel.segment_sum(data, indptr, g.num_nodes)
    for _ in range(3):
        assert same_bits(kernel.segment_sum(data, indptr, g.num_nodes), first)


@pytest.mark.cuda
def test_kernel_fails_on_offsets_that_do_not_end_at_e(cuda):
    """``indptr[n] != E`` fails a device-side assert at the next wait for
    the device. It leaves the process's CUDA context unusable, so it runs
    in a process of its own."""
    code = (
        "import torch\n"
        "from repro_torch.kernels.segment_sum.segment_sum import segment_sum\n"
        "data = torch.ones(1001, device='cuda')\n"
        "indptr = torch.tensor([0, 500, 1000], dtype=torch.int32, device='cuda')\n"
        "segment_sum(data, indptr, 2)\n"
        "torch.cuda.synchronize()\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode != 0
    assert "device-side assert" in proc.stderr, proc.stderr[-2000:]


@pytest.mark.cuda
def test_launches_once_per_prd_iteration_and_never_for_sssp_or_pna(cuda):
    """PageRank-Delta's pull launches the kernel once an iteration and
    keeps the CPU's ranks within the card tests' PRD tolerance; SSSP and
    the blocked PNA layer never launch it."""
    from repro_torch.configs import base
    from repro_torch.nn import gnn

    g = generate.rmat(12, 16, seed=7)
    stats = {}
    before = kernel.segment_sum.launches
    ranks = apps.pagerank_delta(g.device(cuda), stats=stats)
    assert kernel.segment_sum.launches - before == stats["iters"] >= 2
    torch.testing.assert_close(ranks.cpu(), apps.pagerank_delta(g.device("cpu")), rtol=1e-4,
                               atol=1e-7)

    before = kernel.segment_sum.launches
    gout = transpose(generate.add_uniform_weights(g, seed=1))
    apps.sssp(gout.device(cuda), 0)
    cfg = base.get_arch("pna")
    gen = torch.Generator().manual_seed(0)
    params = gnn.to_device(gnn.init(gen, cfg, 100, device="cpu"), cuda)
    batch = {"x": torch.randn(g.num_nodes, 100, generator=gen).to(cuda),
             "indptr": torch.as_tensor(g.indptr.astype(np.int32)).to(cuda),
             "src": torch.as_tensor(g.indices.astype(np.int32)).to(cuda),
             "dst": torch.as_tensor(g.dst_ids()).to(cuda)}
    with torch.no_grad():
        gnn.apply(params, cfg, batch)
    torch.cuda.synchronize()
    assert kernel.segment_sum.launches == before
