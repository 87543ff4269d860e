"""repro_torch.kernels.segment_min and the SSSP path through it.

On the CPU the wrapper computes its plain version, ``scatter_reduce_`` amin
over a +inf base; the CPU tests hold that path, ``engine.min_reduce``'s
routing (int64 ids go to ``scatter_reduce_``) and SSSP against the
benchmark's plain reference. The card tests hold the CUDA kernel bit for
bit against the plain version, and SSSP on the card against the CPU and
the benchmark's plain reference. This file imports only the
port and the benchmark's reference, so the card tests run without the
repository's conftest:

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda tests/test_torch_segment_min.py
"""
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
from repro_torch.kernels.segment_min import ref
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
    one kernel launch an iteration, and no ``scatter_reduce_`` kernel runs."""
    g = gbench_graph("kron25", 14, cuda)
    source = int(torch.argmax(g.indptr[1:] - g.indptr[:-1]))
    before = kernel.segment_min.launches
    dist, want, frontier, stats = sssp_against_reference(g, source)
    assert torch.equal(dist, want)
    assert kernel.segment_min.launches - before == stats["iters"] == len(frontier)
    csr = DeviceCSR(indptr=g.indptr, indices=g.indices, dst=g.dst, weights=g.weights,
                    num_nodes=g.num_nodes)
    names = device_kernels(lambda: apps.sssp(csr, source))
    assert any("segment_min_kernel" in k for k in names)
    assert not any("scatter_gather" in k for k in names)
