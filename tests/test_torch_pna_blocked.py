"""PNA's blocked inference layer (``nn.gnn``'s path for a batch with a
destination-sorted CSR) against the batch-dict ``pna_apply`` and the plain
reference ``gbench/reference/pna.py`` in float64, on small Kronecker
graphs with seeded weights, on the CPU.

Tolerance: ``test_torch_gnn.TOL["pna"]`` (rtol = atol = 5e-5), whose
docstring gives the reason: PNA's ``std`` is ``sqrt(var + 1e-5)`` over a
variance that cancels to ~0 for a vertex of degree 1, so an ulp in a
message moves it by ~1e-5. The blocked path and the batch-dict path differ
only in how the matrix products are split into blocks.
"""
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import base
from repro_torch.core import plan
from repro_torch.graph import generate
from repro_torch.nn import gnn
from repro_torch.train.tree import tree_leaves

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from gbench.reference import pna as pna_ref  # noqa: E402

TOL = dict(rtol=5e-5, atol=5e-5)  # test_torch_gnn.TOL["pna"]
D_FEAT = 12


def kron(scale=9, degree=8, seed=3):
    g = generate.rmat(scale, degree, seed=seed)
    indptr = torch.as_tensor(g.indptr.astype(np.int32))
    src = torch.as_tensor(g.indices.astype(np.int32))
    dst = torch.as_tensor(g.dst_ids())
    return indptr, src, dst


def setup(seed=0, scale=9, d_feat=D_FEAT, cfg=None):
    cfg = cfg or base.reduced(base.get_arch("pna"))
    gen = torch.Generator().manual_seed(seed)
    params = gnn.init(gen, cfg, d_feat, "cpu")
    indptr, src, dst = kron(scale, seed=seed + 3)
    x = torch.randn(indptr.shape[0] - 1, d_feat, generator=gen)
    deg = (indptr[1:] - indptr[:-1]).double()
    batch = {"x": x, "indptr": indptr, "src": src, "dst": dst}
    return cfg, params, batch


def delta(batch) -> float:
    """The graph's mean log(deg + 1), δ for the dict path and the reference."""
    deg = (batch["indptr"][1:] - batch["indptr"][:-1]).double()
    return float(torch.log1p(deg).mean())


def blocked(params, cfg, batch, block_edges, monkeypatch, **kw):
    monkeypatch.setattr(gnn, "BLOCK_EDGES", block_edges)
    with torch.no_grad():
        return gnn.pna_apply(params, cfg, batch, **kw)


def dict_path(params, cfg, batch):
    b = {"x": batch["x"], "src": batch["src"], "dst": batch["dst"],
         "emask": torch.ones(batch["src"].shape[0], dtype=torch.bool)}
    with torch.no_grad():
        return gnn.pna_apply(params, cfg, b, mean_log_deg=delta(batch))


def reference(params, cfg, batch, dtype=torch.float64):
    return pna_ref.pna_forward(params, batch["x"], batch["indptr"], batch["src"],
                               delta(batch), cfg.aggregators, cfg.scalers,
                               dtype=dtype, block_edges=1000)


def test_the_case_has_hubs_and_isolated_vertices():
    indptr, _, _ = kron()
    deg = indptr[1:] - indptr[:-1]
    assert int((deg == 0).sum()) > 0 and int(deg.max()) > 64


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("block_edges", [1 << 22, 500, 64, 7])
def test_blocked_matches_dict_path_and_reference(monkeypatch, seed, block_edges):
    """One block, blocks that split the graph between rows, and budgets
    below the hubs' degrees (a row longer than the budget is a block)."""
    cfg, params, batch = setup(seed)
    got = blocked(params, cfg, batch, block_edges, monkeypatch)
    assert got.shape == (batch["x"].shape[0], cfg.d_out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), dict_path(params, cfg, batch).numpy(), **TOL)
    np.testing.assert_allclose(got.double().numpy(), reference(params, cfg, batch).numpy(), **TOL)


def test_published_widths_match_reference(monkeypatch):
    """The registered model (d = 75, 100 input features) on a small graph."""
    cfg, params, batch = setup(5, scale=8, d_feat=100, cfg=base.get_arch("pna"))
    assert (cfg.n_layers, cfg.d_hidden, cfg.d_out) == (4, 75, 16)
    got = blocked(params, cfg, batch, 300, monkeypatch)
    np.testing.assert_allclose(got.double().numpy(), reference(params, cfg, batch).numpy(), **TOL)


@pytest.mark.parametrize("hot", ["zero", "mid", "all"])
def test_k1_route_equals_index_select_bit_for_bit(monkeypatch, hot):
    """The GRASP route gathers through ``ops.hot_gather`` with the High
    Reuse Region at 0 rows, a third of the rows, or all of them."""
    cfg, params, batch = setup(1)
    n = batch["x"].shape[0]
    rows = {"zero": 0, "mid": n // 3, "all": n}[hot]
    seen = []

    def sized(num_elems, elem_bytes):
        p = plan.make_plan(num_elems, elem_bytes, budget_bytes=rows * elem_bytes)
        seen.append(p.hot_size)
        return p

    monkeypatch.setattr(gnn, "make_plan", sized)
    grasp = blocked(params, cfg, batch, 200, monkeypatch)
    plain = blocked(params, dataclasses.replace(cfg, grasp=False), batch, 200, monkeypatch)
    assert seen == [rows] * cfg.n_layers
    assert torch.equal(grasp, plain)


def test_k1_route_is_taken(monkeypatch):
    calls = []
    real = gnn.hot_ops.hot_gather

    def counting(prop, idx, hot_size=None):
        calls.append((idx.dtype, hot_size))
        return real(prop, idx, hot_size)

    monkeypatch.setattr(gnn.hot_ops, "hot_gather", counting)
    cfg, params, batch = setup(0)
    blocked(params, cfg, batch, 500, monkeypatch)
    n_blocks = len(gnn.pna_blocks(batch["indptr"], 500))
    assert len(calls) == cfg.n_layers * n_blocks
    assert all(dt == torch.int32 for dt, _ in calls)
    # the plan's rows at 4·d bytes a row, the L2 budget without a card
    widths = [D_FEAT] + [cfg.d_hidden] * (cfg.n_layers - 1)
    n = batch["x"].shape[0]
    want = [plan.make_plan(n, 4 * d).hot_size for d in widths]
    assert [h for _, h in calls[::n_blocks]] == want


@pytest.mark.parametrize("block_edges", [1, 5, 64, 1 << 20])
def test_blocks_cover_whole_rows(block_edges):
    indptr, _, _ = kron()
    ptr = indptr.long()
    blocks = gnn.pna_blocks(indptr, block_edges)
    assert blocks[0][0] == 0 and blocks[-1][1] == ptr.shape[0] - 1
    for (v0, v1, e0, e1), nxt in zip(blocks, blocks[1:] + [None]):
        assert v0 < v1 and (e0, e1) == (int(ptr[v0]), int(ptr[v1]))
        assert v1 - v0 <= block_edges
        assert e1 - e0 <= block_edges or v1 - v0 == 1  # a longer row is a block alone
        if nxt is not None:
            assert nxt[0] == v1
            # greedy: the next row would not have fitted
            assert (int(ptr[v1 + 1]) - e0 > block_edges or v1 + 1 - v0 > block_edges)


def test_blocks_reject_an_empty_budget():
    with pytest.raises(ValueError, match="block_edges"):
        gnn.pna_blocks(torch.tensor([0, 1]), 0)


class _Shapes(TorchDispatchMode):
    """The first dimension of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.rows = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else [out]:
            if isinstance(t, torch.Tensor) and t.dim():
                self.rows.append((str(func), t.shape[0]))
        return out


def test_no_tensor_spans_all_edges(monkeypatch):
    cfg, params, batch = setup(0)
    n, e = batch["x"].shape[0], batch["src"].shape[0]
    budget = e // 4
    assert e > 2 * (n + 1) and e > 2 * budget
    with _Shapes() as shapes:
        blocked(params, cfg, batch, budget, monkeypatch)
    assert shapes.rows and max(r for _, r in shapes.rows) <= max(n + 1, budget)


def test_autograd_call_raises_and_names_the_dict_path():
    cfg, params, batch = setup(0)
    for t in tree_leaves(params):
        if t is not None:
            t.requires_grad_(True)
    with pytest.raises(RuntimeError, match="batch dict"):
        gnn.apply(params, cfg, batch)
    with torch.no_grad():
        assert gnn.apply(params, cfg, batch).shape[1] == cfg.d_out


def test_ids_must_be_int32(monkeypatch):
    cfg, params, batch = setup(0)
    with pytest.raises(ValueError, match="int32"):
        blocked(params, cfg, {**batch, "src": batch["src"].long()}, 500, monkeypatch)


def test_spans_under_the_profiler(monkeypatch):
    cfg, params, batch = setup(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        blocked(params, cfg, batch, 500, monkeypatch)
    names = {ev.name for ev in prof.events()}
    assert {"gnn.block", "gnn.gather", "gnn.message", "gnn.reduce", "gnn.update"} <= names
    n_blocks = len(gnn.pna_blocks(batch["indptr"], 500))
    assert sum(ev.name == "gnn.block" for ev in prof.events()) == cfg.n_layers * n_blocks


def test_delta_from_the_batch(monkeypatch):
    """δ comes from the batch's graph: its mean log(deg + 1), bit for bit,
    unless ``mean_log_deg`` replaces it, which moves the logits."""
    cfg, params, batch = setup(0)
    a = blocked(params, cfg, batch, 500, monkeypatch)
    assert torch.equal(a, blocked(params, cfg, batch, 500, monkeypatch,
                                  mean_log_deg=delta(batch)))
    b = blocked(params, cfg, batch, 500, monkeypatch, mean_log_deg=2 * delta(batch))
    assert not torch.allclose(a, b)


def test_bfloat16_reference_is_far_from_float64(monkeypatch):
    """The control of the benchmark's check: the reference in bfloat16 is
    far outside the tolerance that the float32 program meets."""
    cfg, params, batch = setup(0, d_feat=100, cfg=base.get_arch("pna"))
    want = reference(params, cfg, batch)
    rms = float(want.pow(2).mean().sqrt())
    err = float((reference(params, cfg, batch, torch.bfloat16).double() - want).abs().max())
    ok = float((blocked(params, cfg, batch, 500, monkeypatch).double() - want).abs().max())
    assert err / rms > 100 * ok / rms


def test_reference_imports_only_torch():
    import ast
    tree = ast.parse(Path(pna_ref.__file__).read_text())
    names = {a.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)}
    assert names <= {"__future__", "torch"}, names


def test_cpu_route_reduces_through_seg_extreme_sorted(monkeypatch):
    """On the CPU the blocked layer keeps its four library calls and looks
    ``_seg_extreme_sorted`` up in ``nn.gnn`` at call time: patching it moves
    the logits, and the wrapper of the card's kernel is never called."""
    cfg, params, batch = setup(0)
    want = blocked(params, cfg, batch, 500, monkeypatch)
    real = gnn._seg_extreme_sorted
    calls = []

    def without_min(x, offsets, reduce):
        calls.append(reduce)
        if reduce == "amin":
            return x.new_zeros((offsets.shape[0] - 1, x.shape[1]))
        return real(x, offsets, reduce)

    monkeypatch.setattr(gnn, "_seg_extreme_sorted", without_min)
    monkeypatch.setattr(gnn, "segment_stats", lambda *a: pytest.fail("kernel on the CPU"))
    got = blocked(params, cfg, batch, 500, monkeypatch)
    n_blocks = len(gnn.pna_blocks(batch["indptr"], 500))
    assert calls == ["amax", "amin"] * (cfg.n_layers * n_blocks)
    assert not torch.allclose(got, want)


class _Ops(TorchDispatchMode):
    """The name of every aten op called."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_route_reduces_in_one_launch_a_block(monkeypatch, cuda):
    """On the card one forward makes n_layers x blocks ``segment_stats``
    launches, calls no ``index_add_`` or ``segment_reduce`` of torch, and
    keeps to the float64 reference within the PNA tolerance, as the CPU
    route does."""
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_stats

    cfg, params, batch = setup(0, d_feat=100, cfg=base.get_arch("pna"))
    card = {k: v.to(cuda) for k, v in batch.items()}
    before = segment_stats.launches
    with _Ops() as ops:
        got = blocked(gnn.to_device(params, cuda), cfg, card, 500, monkeypatch)
    torch.cuda.synchronize()
    blocks = gnn.pna_blocks(batch["indptr"], 500)
    assert all(e1 > e0 for _, _, e0, e1 in blocks)
    assert segment_stats.launches - before == cfg.n_layers * len(blocks)
    assert not [n for n in ops.names if "index_add" in n or "segment_reduce" in n]
    np.testing.assert_allclose(got.double().cpu().numpy(), reference(params, cfg, batch).numpy(),
                               **TOL)
