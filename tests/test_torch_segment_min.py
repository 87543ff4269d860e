"""repro_torch.kernels.segment_min and the SSSP paths through it.

On the CPU the wrappers compute their plain versions: ``scatter_reduce_``
amin over a +inf base, and the relaxation over the active rows' out-edges
(``ref.relax_min_ref``). The CPU tests hold those, ``engine.min_reduce``'s
routing (int64 ids go to ``scatter_reduce_``), the relaxation against
SSSP's ``where`` + ``min_reduce`` iteration, and SSSP against the
benchmark's plain reference. The card tests hold the CUDA kernels bit for
bit against the plain versions, and SSSP on the card, through the
relaxation kernels, against the CPU and the benchmark's plain reference.
This file imports only the
port and the benchmark's reference, so the card tests run without the
repository's conftest:

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda tests/test_torch_segment_min.py
"""
import dataclasses
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
from repro_torch.kernels.segment_min import ref, relax
from repro_torch.kernels.segment_min import segment_min as kernel

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from gbench import graphs, spec  # noqa: E402
from gbench.reference import sssp as gbench_sssp  # noqa: E402

INF = float("inf")
IDS = [torch.int32, torch.int64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def messages(e, n, id_dtype, targets="uniform", live=0.2, seed=0):
    """``e`` float32 messages, a share ``live`` of them finite (negative
    ones too) and the rest +inf, with their ids: uniform over ``[0, n)``,
    or with half the messages on four hub targets."""
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal(e) * 100).astype(np.float32)
    data[rng.random(e) >= live] = np.inf
    seg = rng.integers(0, n, e)
    if targets == "hubs":
        hub = rng.random(e) < 0.5
        seg[hub] = rng.integers(0, 4, int(hub.sum())) * (n // 4)
    return torch.as_tensor(data), torch.as_tensor(seg).to(id_dtype)


def library_min(data, seg, n):
    out = torch.full((n,), INF, dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, seg.long(), data, "amin", include_self=True)


def same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def route(id_dtype):
    """What reduces float32 messages with ``id_dtype`` ids: the wrapper for
    int32; for int64, which it refuses, ``engine.min_reduce``, which sends
    them to ``scatter_reduce_``."""
    return kernel.segment_min if id_dtype == torch.int32 else engine.min_reduce


# --- the CPU's plain path ---------------------------------------------------

@pytest.mark.parametrize("targets", ["uniform", "hubs"])
@pytest.mark.parametrize("id_dtype", IDS)
def test_plain_path_matches_scatter_reduce(id_dtype, targets):
    data, seg = messages(5003, 700, id_dtype, targets)
    got = route(id_dtype)(data, seg, 700)
    assert got.dtype == torch.float32 and got.shape == (700,)
    assert same_bits(got, library_min(data, seg, 700))


@pytest.mark.parametrize("id_dtype", IDS)
def test_empty_segments_hold_inf(id_dtype):
    data = torch.tensor([3.0, -1.0, 2.5, -0.5])
    seg = torch.tensor([1, 1, 4, 4], dtype=id_dtype)
    got = route(id_dtype)(data, seg, 6)
    assert same_bits(got, torch.tensor([INF, -1.0, INF, INF, -0.5, INF]))


@pytest.mark.parametrize("e", [0, 1, 1001])
def test_all_identity_input(e):
    data, seg = torch.full((e,), INF), torch.zeros(e, dtype=torch.int32)
    assert same_bits(kernel.segment_min(data, seg, 5), torch.full((5,), INF))


def test_nan_message_makes_its_segment_nan():
    data = torch.tensor([1.0, float("nan"), -3.0, INF, 2.0])
    seg = torch.tensor([0, 0, 0, 1, 2], dtype=torch.int32)
    got = kernel.segment_min(data, seg, 3)
    assert torch.isnan(got[0]) and got[1] == INF and got[2] == 2.0
    assert torch.isnan(library_min(data, seg, 3)[0])


@pytest.mark.parametrize("bad", [-1, 300])
@pytest.mark.parametrize("id_dtype", IDS)
def test_plain_path_raises_on_an_id_out_of_range(id_dtype, bad):
    data, seg = messages(64, 300, id_dtype, live=1.0)
    seg[7] = bad
    with pytest.raises(RuntimeError):
        route(id_dtype)(data, seg, 300)


@pytest.mark.parametrize("data,seg,error", [
    (torch.zeros(4, dtype=torch.float64), torch.zeros(4, dtype=torch.int32), TypeError),
    (torch.zeros(4), torch.zeros(4, dtype=torch.int16), TypeError),
    (torch.zeros(4), torch.zeros(4, dtype=torch.int64), TypeError),
    (torch.zeros(4, 2), torch.zeros(4, dtype=torch.int32), ValueError),
    (torch.zeros(4), torch.zeros(3, dtype=torch.int32), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(data, seg, error):
    with pytest.raises(error):
        kernel.segment_min(data, seg, 4)


@pytest.mark.parametrize("reducer,data,seg,path", [
    ("min_reduce", torch.ones(6), torch.zeros(6, dtype=torch.int32), "kernel"),
    ("min_reduce", torch.ones(6), torch.zeros(6, dtype=torch.int64), "scatter"),
    ("min_reduce", torch.ones(6, dtype=torch.int32), torch.zeros(6, dtype=torch.int32), "scatter"),
    ("min_reduce", torch.ones(6, dtype=torch.float64), torch.zeros(6, dtype=torch.int32),
     "scatter"),
    ("min_reduce", torch.ones(6, 2), torch.zeros(6, dtype=torch.int32), "scatter"),
    ("max_reduce", torch.ones(6), torch.zeros(6, dtype=torch.int32), "scatter"),
    ("or_reduce", torch.ones(6, dtype=torch.int32), torch.zeros(6, dtype=torch.int32),
     "scatter"),
])
def test_min_reduce_routes_by_dtype_and_shape(monkeypatch, reducer, data, seg, path):
    """(E,) float32 messages with int32 ids take the segment-min kernel;
    int64 ids, other dtypes, multi-column messages and the max and or
    reductions keep ``scatter_reduce_``."""
    taken = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            taken.append(name)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(engine, "segment_min", spy("kernel", engine.segment_min))
    monkeypatch.setattr(engine, "_scatter_reduce", spy("scatter", engine._scatter_reduce))
    getattr(engine, reducer)(data, seg, 3)
    assert taken == [path]


def gbench_graph(config, scale, device):
    """The benchmark's weighted graph ``config`` at a small ``scale``."""
    cfg = {**spec.config(spec.benchmark(), config), "scale": scale}
    return graphs.make(cfg, 2**31 + 11, torch.device(device), weighted=True)


def sssp_against_reference(g, source, weights=None):
    """``apps.sssp`` with stats, over ``g`` or its edges with ``weights``,
    and the benchmark's int64 reference in the dtype of its distances."""
    weights = g.weights if weights is None else weights
    csr = DeviceCSR(indptr=g.indptr, indices=g.indices, dst=g.dst, weights=weights,
                    num_nodes=g.num_nodes)
    stats = {}
    dist = apps.sssp(csr, source, stats=stats)
    want, frontier = gbench_sssp.sssp(g.indptr, g.indices, g.dst, g.weights, source)
    unreached = want == torch.iinfo(want.dtype).max
    return dist, torch.where(unreached, INF, want.to(dist.dtype)), frontier, stats


def scatter_min(data, seg, n):
    """``min_reduce`` without the engine's routing: what a caller that
    stands in for it computes."""
    return engine._scatter_reduce(data, seg, n, "amin", INF)


@pytest.mark.parametrize("off_path", ["replaced_reducer", "float64_weights"])
def test_sssp_off_the_kernel_path_matches_the_reference(monkeypatch, off_path):
    """Where a reduction does not take the segment-min kernel's route (a
    replaced ``min_reduce``, as the benchmark's planted faults make, or
    float64 candidates), SSSP still equals the reference: its distances
    and one iteration for each of the reference's frontiers."""
    g = gbench_graph("kron25", 8, "cpu")
    weights = g.weights
    if off_path == "replaced_reducer":
        monkeypatch.setattr(sys.modules["repro_torch.apps.sssp"], "min_reduce", scatter_min)
    else:
        weights = weights.double()
    source = int(torch.argmax(g.indptr[1:] - g.indptr[:-1]))
    dist, want, frontier, stats = sssp_against_reference(g, source, weights)
    assert dist.dtype == weights.dtype and torch.equal(dist, want)
    assert stats["iters"] == len(frontier) >= 2


@pytest.mark.parametrize("config", ["kron25", "urand25"])
def test_sssp_iterations_and_distances_equal_the_reference_frontier(config):
    """SSSP's distances equal the benchmark's plain reference, in one
    iteration for each of its frontiers."""
    g = gbench_graph(config, 10, "cpu")
    source = int(torch.argmax(g.indptr[1:] - g.indptr[:-1]))
    dist, want, frontier, stats = sssp_against_reference(g, source)
    assert torch.equal(dist, want)
    assert stats["iters"] == len(frontier) >= 2


# --- the relaxation's plain version on the CPU ------------------------------

def fresh_state(n, source, device="cpu"):
    """SSSP's state before its first iteration: (dist, active, keys, flag,
    relaxed) as ``apps.sssp`` makes them for the relaxation."""
    dist = torch.full((n,), INF, device=device)
    dist[source] = 0.0
    active = torch.zeros(n, dtype=torch.bool, device=device)
    active[source] = True
    keys = torch.full((n,), INF, device=device).view(torch.int32)
    return (dist, active, keys, torch.ones(1, dtype=torch.int32, device=device),
            torch.zeros(1, dtype=torch.int64, device=device))


def where_and_min_reduce(g, weights, dist, active):
    """SSSP's iteration before the relaxation: (E,) candidates through the
    int64 sources, ``where``, then ``min_reduce`` over the targets."""
    src = g.dst.long()
    w = weights if weights is not None else torch.ones(g.indices.shape, device=dist.device)
    cand = torch.where(active[src], dist[src] + w, INF)
    return engine.min_reduce(cand, g.indices, dist.shape[0])


def hub_source(g):
    return int(torch.argmax(g.indptr[1:] - g.indptr[:-1]))


@pytest.mark.parametrize("scale", [8, 10])
@pytest.mark.parametrize("config", ["kron25", "urand25"])
def test_relax_plain_matches_where_and_min_reduce(config, scale):
    """At every iteration of SSSP from the hub, the plain relaxation's
    minima equal the ``where`` + ``min_reduce`` iteration's bit for bit,
    and the binding on the CPU leaves the distances and frontier that
    iteration leaves."""
    g = gbench_graph(config, scale, "cpu")
    dist, active, keys, flag, relaxed = fresh_state(g.num_nodes, hub_source(g))
    iters = 0
    while bool(flag):
        want = where_and_min_reduce(g, g.weights, dist, active)
        got = ref.relax_min_ref(g.indptr, g.indices, g.weights, dist, active)
        assert same_bits(got, want)
        next_active, next_dist = want < dist, torch.minimum(dist, want)
        relax.relax_min(g.indptr, g.indices, g.weights, dist, active, keys, flag, relaxed)
        assert torch.equal(active, next_active) and same_bits(dist, next_dist)
        assert int(flag[0]) == int(bool(next_active.any()))
        iters += 1
    assert iters >= 2 and same_bits(keys, torch.full((g.num_nodes,), INF).view(torch.int32))


def test_relax_unit_weights_equal_ones():
    """``weights`` None relaxes with weights of 1: the same bits as a
    weights array of ones, in the plain version and in SSSP."""
    g = gbench_graph("kron25", 9, "cpu")
    source = hub_source(g)
    dist, active, *_ = fresh_state(g.num_nodes, source)
    dist[g.indices[:50].long()] = 3.0
    active[g.indices[:50].long()] = True
    ones = torch.ones(g.indices.shape)
    assert same_bits(ref.relax_min_ref(g.indptr, g.indices, None, dist, active),
                     ref.relax_min_ref(g.indptr, g.indices, ones, dist, active))
    csr = DeviceCSR(indptr=g.indptr, indices=g.indices, dst=g.dst, weights=None,
                    num_nodes=g.num_nodes)
    hops = apps.sssp(csr, source)
    assert same_bits(hops, apps.sssp(dataclasses.replace(csr, weights=ones), source))
    reached = hops[torch.isfinite(hops)]
    assert reached.numel() > 1 and torch.equal(reached, reached.round())


def small_csr():
    """Six rows, two of them empty (1 and 4), as an out-CSR with weights."""
    indptr = torch.tensor([0, 3, 3, 5, 7, 7, 9], dtype=torch.int32)
    indices = torch.tensor([1, 2, 3, 0, 5, 2, 4, 0, 3], dtype=torch.int32)
    weights = torch.tensor([1.0, 4.0, 2.0, 1.5, 0.5, 1.0, 3.0, 2.0, 0.25])
    return indptr, indices, weights


def test_relax_empty_rows_and_the_binding_on_cpu():
    """Active rows with no edges relax nothing; the rest relax their edges;
    ``relaxed`` grows by the active rows' out-degrees."""
    indptr, indices, weights = small_csr()
    dist = torch.tensor([0.0, 1.0, 2.0, INF, 5.0, 7.0])
    active = torch.tensor([True, True, False, True, True, False])
    keys = torch.full((6,), INF).view(torch.int32)
    flag, relaxed = torch.ones(1, dtype=torch.int32), torch.tensor([5])
    relax.relax_min(indptr, indices, weights, dist, active, keys, flag, relaxed)
    # rows 0 (0 -> 1: 1, 2: 4, 3: 2) and 3 (inf -> 2, 4), row 1 and 4 are empty
    assert same_bits(dist, torch.tensor([0.0, 1.0, 2.0, 2.0, 5.0, 7.0]))
    assert active.tolist() == [False, False, False, True, False, False]
    assert int(flag[0]) == 1 and int(relaxed[0]) == 5 + 3 + 2


@pytest.mark.parametrize("weighted", [True, False])
def test_relax_all_inactive_frontier(weighted):
    """No active row: every minimum is +inf, nothing moves, the flag goes
    down and no edge counts."""
    indptr, indices, weights = small_csr()
    weights = weights if weighted else None
    dist = torch.tensor([0.0, 1.0, 2.0, INF, 5.0, 7.0])
    active = torch.zeros(6, dtype=torch.bool)
    assert same_bits(ref.relax_min_ref(indptr, indices, weights, dist, active),
                     torch.full((6,), INF))
    keys = torch.full((6,), INF).view(torch.int32)
    before = dist.clone()
    flag, relaxed = torch.ones(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int64)
    relax.relax_min(indptr, indices, weights, dist, active, keys, flag, relaxed)
    assert same_bits(dist, before) and not active.any()
    assert int(flag[0]) == 0 and int(relaxed[0]) == 0
    assert same_bits(keys, torch.full((6,), INF).view(torch.int32))


def test_relax_nan_weight_makes_its_target_nan():
    """A NaN candidate makes its target's minimum NaN: the distance becomes
    NaN and the vertex is not active, as with ``where`` + ``min_reduce``."""
    indptr, indices, weights = small_csr()
    weights[1] = float("nan")  # edge 0 -> 2
    dist = torch.tensor([0.0, 1.0, 2.0, INF, 5.0, 7.0])
    active = torch.tensor([True, False, False, False, False, False])
    best = ref.relax_min_ref(indptr, indices, weights, dist, active)
    g = DeviceCSR(indptr=indptr, indices=indices, dst=torch.repeat_interleave(
        torch.arange(6, dtype=torch.int32), (indptr[1:] - indptr[:-1]).long()), weights=weights,
        num_nodes=6)
    want = where_and_min_reduce(g, weights, dist, active)
    assert torch.equal(torch.isnan(best), torch.isnan(want)) and bool(torch.isnan(best[2]))
    assert same_bits(best.nan_to_num(0.0), want.nan_to_num(0.0))
    keys, flag = torch.full((6,), INF).view(torch.int32), torch.ones(1, dtype=torch.int32)
    relax.relax_min(indptr, indices, weights, dist, active, keys, flag,
                    torch.zeros(1, dtype=torch.int64))
    assert bool(torch.isnan(dist[2])) and not bool(active[2])
    assert active.tolist() == [False, False, False, True, False, False]


@pytest.mark.parametrize("args,error", [
    (dict(indptr=torch.zeros(7, dtype=torch.int64)), TypeError),
    (dict(indices=torch.zeros(9, dtype=torch.int64)), TypeError),
    (dict(weights=torch.zeros(9, dtype=torch.float64)), TypeError),
    (dict(dist=torch.zeros(6, dtype=torch.float64)), TypeError),
    (dict(active=torch.zeros(6, dtype=torch.uint8)), TypeError),
    (dict(weights=torch.zeros(8)), ValueError),
    (dict(indptr=torch.zeros(6, dtype=torch.int32)), ValueError),
    (dict(flag=torch.zeros(2, dtype=torch.int32)), ValueError),
    (dict(dist=torch.zeros(12)[::2]), ValueError),
])
def test_relax_binding_rejects_what_the_kernel_does_not_take(args, error):
    indptr, indices, weights = small_csr()
    call = dict(indptr=indptr, indices=indices, weights=weights, dist=torch.zeros(6),
                active=torch.zeros(6, dtype=torch.bool),
                keys=torch.full((6,), INF).view(torch.int32),
                flag=torch.ones(1, dtype=torch.int32), relaxed=torch.zeros(1, dtype=torch.int64))
    with pytest.raises(error):
        relax.relax_min(**{**call, **args})


def test_relax_binding_refuses_a_device_without_a_kernel():
    def meta(t):
        return torch.empty_like(t, device="meta")

    indptr, indices, weights = small_csr()
    with pytest.raises(RuntimeError, match="no relaxation kernel"):
        relax.relax_min(meta(indptr), meta(indices), meta(weights), meta(torch.zeros(6)),
                        meta(torch.zeros(6, dtype=torch.bool)),
                        meta(torch.zeros(6, dtype=torch.int32)),
                        meta(torch.zeros(1, dtype=torch.int32)),
                        meta(torch.zeros(1, dtype=torch.int64)))


@pytest.mark.parametrize("config", ["kron25", "urand25"])
def test_sssp_counts_the_reference_frontier_edges(config):
    """``stats["edges_relaxed"]`` is the sum of the reference frontiers'
    edges, in one iteration for each frontier."""
    g = gbench_graph(config, 10, "cpu")
    dist, want, frontier, stats = sssp_against_reference(g, hub_source(g))
    assert torch.equal(dist, want)
    assert stats["iters"] == len(frontier) >= 2
    assert stats["edges_relaxed"] == sum(f for _, f in frontier)


# --- the kernel on the card -------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("targets", ["uniform", "hubs"])
def test_kernel_matches_plain_bit_for_bit(cuda, targets, offset):
    """80% +inf messages, uniform targets or half of them on four hubs;
    E is off a multiple of four, and ``offset`` 1 starts the arrays off
    16-byte alignment (the kernel's scalar loop)."""
    data, seg = messages(1_000_003 + offset, 100_000, torch.int32, targets, seed=3)
    data, seg = data.to(cuda)[offset:], seg.to(cuda)[offset:]
    before = kernel.segment_min.launches
    got = kernel.segment_min(data, seg, 100_000)
    torch.cuda.synchronize()
    assert kernel.segment_min.launches == before + 1
    assert same_bits(got, ref.segment_min_ref(data, seg, 100_000))


@pytest.mark.cuda
def test_kernel_nan_and_empty_segments(cuda):
    data = torch.tensor([1.0, float("nan"), -3.0, INF, 2.0, -0.0, float("nan")] * 3)
    seg = torch.tensor([0, 0, 0, 1, 2, 4, 6] * 3, dtype=torch.int32)
    got = kernel.segment_min(data.to(cuda), seg.to(cuda), 8).cpu()
    want = ref.segment_min_ref(data, seg, 8)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert same_bits(got.nan_to_num(0.0), want.nan_to_num(0.0))
    assert torch.equal(got[[1, 3, 5, 7]], torch.full((4,), INF))


@pytest.mark.cuda
def test_kernel_counts_launches(cuda):
    data, seg = messages(10_000, 500, torch.int32, live=0.25, seed=5)
    data, seg = data.to(cuda), seg.to(cuda)
    before = kernel.segment_min.launches
    for _ in range(3):
        kernel.segment_min(data, seg, 500)
    kernel.segment_min(data[:0], seg[:0], 500)  # nothing to reduce: no launch
    assert kernel.segment_min.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [-1, 500])
def test_kernel_fails_on_an_id_out_of_range(cuda, bad):
    """A live message's id outside ``[0, n)`` fails a device-side assert,
    raised at the next wait for the device, as ``scatter_reduce_``'s index
    check does. It leaves the process's CUDA context unusable, so it runs
    in a process of its own."""
    code = (
        "import torch\n"
        "from repro_torch.kernels.segment_min.segment_min import segment_min\n"
        f"data = torch.ones(1001, device='cuda')\n"
        "seg = torch.zeros(1001, dtype=torch.int32, device='cuda')\n"
        f"seg[700] = {bad}\n"
        "segment_min(data, seg, 500)\n"
        "torch.cuda.synchronize()\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={**os.environ, "PYTHONPATH": src})
    assert proc.returncode != 0
    assert "device-side assert" in proc.stderr, proc.stderr[-2000:]


def device_kernels(fn):
    """Names of the kernels ``fn`` launches, read with torch.profiler. The
    call sits between runs of spin kernels, which are left out: on the card
    the profiler loses a few kernels at the edge of a window."""
    from torch.profiler import ProfilerActivity, profile

    def pad():
        for _ in range(8):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad()
        fn()
        pad()
    return {ev.name for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in ev.name}


@pytest.mark.cuda
def test_sssp_on_card_matches_cpu(cuda):
    """SSSP on a generated weighted graph on the card against the CPU, whose
    distances tests/test_torch_graph_suite.py holds to the JAX package's."""
    gout = transpose(generate.add_uniform_weights(generate.rmat(9, 8, seed=3), seed=1))
    source = int(np.argmax(np.diff(gout.indptr)))
    for s in (0, source):
        assert torch.equal(apps.sssp(gout.device(cuda), s).cpu(), apps.sssp(gout.device("cpu"), s))


@pytest.mark.cuda
def test_sssp_on_card_through_the_kernel(cuda):
    """A benchmark graph on the card: distances equal the int64 reference,
    one relaxation an iteration, one for each of the reference's frontiers;
    neither the segment-min kernel nor a ``scatter_reduce_`` or gather
    kernel runs."""
    g = gbench_graph("kron25", 14, cuda)
    source = hub_source(g)
    before, sm_before = relax.relax_min.launches, kernel.segment_min.launches
    dist, want, frontier, stats = sssp_against_reference(g, source)
    assert torch.equal(dist, want)
    assert relax.relax_min.launches - before == stats["iters"] == len(frontier)
    assert kernel.segment_min.launches == sm_before
    csr = DeviceCSR(indptr=g.indptr, indices=g.indices, dst=g.dst, weights=g.weights,
                    num_nodes=g.num_nodes)
    names = device_kernels(lambda: apps.sssp(csr, source))
    assert any("relax_min_kernel" in k for k in names) and any("settle_kernel" in k for k in names)
    assert not any(part in k for k in names
                   for part in ("segment_min_kernel", "scatter_gather", "index_elementwise"))


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["kron25", "urand25"])
def test_sssp_relaxation_on_card_equals_the_cpu_path(cuda, config):
    """SSSP on the card through the relaxation equals the CPU's ``where`` +
    ``min_reduce`` path bit for bit, in the same iterations, and counts
    the reference frontiers' edges."""
    g = gbench_graph(config, 12, "cpu")
    source = hub_source(g)
    csr = DeviceCSR(indptr=g.indptr, indices=g.indices, dst=g.dst, weights=g.weights,
                    num_nodes=g.num_nodes)
    on_card = DeviceCSR(indptr=g.indptr.to(cuda), indices=g.indices.to(cuda),
                        dst=g.dst.to(cuda), weights=g.weights.to(cuda), num_nodes=g.num_nodes)
    cpu_stats, card_stats = {}, {}
    want = apps.sssp(csr, source, stats=cpu_stats)
    before = relax.relax_min.launches
    got = apps.sssp(on_card, source, stats=card_stats).cpu()
    assert same_bits(got, want) and card_stats == cpu_stats
    assert relax.relax_min.launches - before == card_stats["iters"] >= 2
    _, frontier = gbench_sssp.sssp(g.indptr, g.indices, g.dst, g.weights, source)
    assert card_stats["edges_relaxed"] == sum(f for _, f in frontier)
    hops = apps.sssp(dataclasses.replace(on_card, weights=None), source).cpu()
    assert same_bits(hops, apps.sssp(dataclasses.replace(csr, weights=None), source))


def replay_on_card(cuda, indptr, indices, weights, dist, active, offset=0):
    """One relaxation on the card and one on the CPU from the same state;
    ``offset`` puts the card's edge arrays that many elements off their
    allocation's start. Returns the card's state and the CPU's, on the CPU."""
    cpu = [dist.clone(), active.clone(), torch.full(dist.shape, INF).view(torch.int32),
           torch.ones(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int64)]
    relax.relax_min(indptr, indices, weights, *cpu)

    def shifted(t):
        return None if t is None else torch.cat([t[:offset], t]).to(cuda)[offset:]

    card = [dist.to(cuda), active.to(cuda),
            torch.full(dist.shape, INF, device=cuda).view(torch.int32),
            torch.ones(1, dtype=torch.int32, device=cuda),
            torch.zeros(1, dtype=torch.int64, device=cuda)]
    before = relax.relax_min.launches
    relax.relax_min(indptr.to(cuda), shifted(indices), shifted(weights), *card)
    torch.cuda.synchronize()
    assert relax.relax_min.launches == before + 1
    return [t.cpu() for t in card], cpu


def assert_same_state(card, cpu):
    for a, b in zip(card, cpu):
        assert same_bits(a, b) if a.dtype == torch.float32 else torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("weighted", [True, False])
def test_relax_kernel_hub_rows_split_across_blocks(cuda, weighted, offset):
    """A row of 200,003 edges (52 tiles of 3,840 items), rows of one tile's
    length and empty rows, every other row active; edge arrays 0, 4 and 12
    bytes off 16-byte alignment. The card's state after one relaxation is
    the CPU's bit for bit, ``keys`` back at +inf, and ``relaxed`` the active
    rows' edges."""
    rng = np.random.default_rng(11)
    degrees = np.concatenate([[200_003], [3_840, 3_839, 0, 0, 1], rng.integers(0, 40, 4_000)])
    n = degrees.shape[0]
    indptr = torch.as_tensor(np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32))
    e = int(indptr[-1])
    indices = torch.as_tensor(rng.integers(0, n, e).astype(np.int32))
    weights = torch.as_tensor(rng.integers(1, 100, e).astype(np.float32)) if weighted else None
    dist = torch.as_tensor(rng.integers(0, 1000, n).astype(np.float32))
    active = torch.as_tensor(np.arange(n) % 2 == 0)
    card, cpu = replay_on_card(cuda, indptr, indices, weights, dist, active, offset)
    assert_same_state(card, cpu)
    assert same_bits(card[2], torch.full((n,), INF).view(torch.int32))
    assert int(card[4][0]) == int(torch.as_tensor(degrees)[active].sum())


@pytest.mark.cuda
def test_relax_kernel_never_reads_an_inactive_rows_edges(cuda):
    """The inactive rows' targets are ids out of range and their weights
    NaN: a read of either would fire the device-side assert or make a
    minimum NaN. The result equals the plain version's, which reads only
    the active rows."""
    g = gbench_graph("kron25", 12, "cpu")
    n = g.num_nodes
    rng = np.random.default_rng(5)
    active = torch.as_tensor(rng.random(n) < 0.2)
    dist = torch.as_tensor(rng.integers(0, 500, n).astype(np.float32))
    dead = torch.repeat_interleave(~active, (g.indptr[1:] - g.indptr[:-1]).long())
    indices, weights = g.indices.clone(), g.weights.clone()
    indices[dead] = n + 7
    weights[dead] = float("nan")
    card, cpu = replay_on_card(cuda, g.indptr, indices, weights, dist, active)
    assert_same_state(card, cpu)
    assert not torch.isnan(card[0]).any()


@pytest.mark.cuda
def test_relax_kernel_all_inactive_and_nan(cuda):
    """No active row: nothing moves and the flag goes down. A NaN weight
    makes its target NaN and leaves it inactive, as on the CPU."""
    indptr, indices, weights = small_csr()
    dist = torch.tensor([0.0, 1.0, 2.0, INF, 5.0, 7.0])
    card, cpu = replay_on_card(cuda, indptr, indices, weights, dist, torch.zeros(6, dtype=torch.bool))
    assert_same_state(card, cpu)
    assert int(card[3][0]) == 0 and same_bits(card[0], dist)
    weights[1] = float("nan")
    active = torch.tensor([True, False, False, True, False, False])
    card, cpu = replay_on_card(cuda, indptr, indices, weights, dist, active)
    assert torch.equal(torch.isnan(card[0]), torch.isnan(cpu[0])) and bool(torch.isnan(card[0][2]))
    assert same_bits(card[0].nan_to_num(0.0), cpu[0].nan_to_num(0.0))
    assert all(torch.equal(a, b) for a, b in zip(card[1:], cpu[1:]))
