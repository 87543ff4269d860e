"""DeeperGCN (``configs/deepergcn.py``) through ``nn.gnn``: the batch-dict
route and the CSR route (the softmax-aggregation kernel's plain version on
the CPU) against the plain reference ``gbench/reference/deepergcn.py`` in
float64, on small Kronecker graphs with seeded weights, on the CPU.

Tolerance: 2e-5 of the reference logits' RMS (and rtol 2e-5). The program
is float32 throughout, and its logits grow with depth (each res+ block adds
to the residual stream: an RMS of ~4e3 after 14 layers here), so the
absolute error is taken against their scale. Each layer's product sums 128
terms and each softmax at most the largest in-degree plus one (under 400
here), each sum a chain of float32 roundings (2^-24 each) over 4 to 14
layers; the worst case here was 3e-6 of the RMS. On the CPU both routes
aggregate with the kernel's plain version and differ from each other only
in where the biases enter the residual stream (the CSR route adds them
through the norms' shifts), so they are held to each other at the same
tolerance.
"""
import ast
import dataclasses
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import base
from repro_torch.configs.deepergcn import CONFIG, DeeperGCNConfig
from repro_torch.core import plan
from repro_torch.graph import generate
from repro_torch.kernels.softmax_aggr import ref
from repro_torch.kernels.softmax_aggr import softmax_aggr as kernel
from repro_torch.nn import gnn
from repro_torch.train.tree import tree_leaves

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from gbench.reference import deepergcn as deepergcn_ref  # noqa: E402

TOL = 2e-5
SMALL = dataclasses.replace(CONFIG, d_hidden=16, d_out=5, n_layers=4)
D_FEAT = 12


def kron(scale=9, degree=8, seed=3):
    g = generate.rmat(scale, degree, seed=seed)
    indptr = torch.as_tensor(g.indptr.astype(np.int32))
    src = torch.as_tensor(g.indices.astype(np.int32))
    dst = torch.as_tensor(g.dst_ids())
    return indptr, src, dst


def setup(seed=0, scale=9, d_feat=D_FEAT, cfg=SMALL):
    gen = torch.Generator().manual_seed(seed)
    params = gnn.init(gen, cfg, d_feat, "cpu")
    indptr, src, dst = kron(scale, seed=seed + 3)
    x = torch.randn(indptr.shape[0] - 1, d_feat, generator=gen)
    return params, {"x": x, "indptr": indptr, "src": src, "dst": dst}


def csr_route(params, batch, cfg=SMALL):
    with torch.no_grad():
        return gnn.apply(params, cfg, {k: batch[k] for k in ("x", "indptr", "src")})


def dict_batch(batch, emask=None):
    e = batch["src"].shape[0]
    return {"x": batch["x"], "src": batch["src"], "dst": batch["dst"],
            "emask": torch.ones(e, dtype=torch.bool) if emask is None else emask}


def dict_route(params, batch, cfg=SMALL):
    with torch.no_grad():
        return gnn.apply(params, cfg, dict_batch(batch))


def reference(params, batch, dtype=torch.float64, cfg=SMALL):
    return deepergcn_ref.deepergcn_forward(params, batch["x"], batch["indptr"], batch["src"],
                                           cfg.t, cfg.eps, cfg.bn_eps, dtype=dtype,
                                           block_items=700)


def close(got, want, tol=TOL):
    """``got`` within ``tol`` of ``want``'s RMS (and ``tol`` relative)."""
    want = want.double()
    rms = float(want.pow(2).mean().sqrt())
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=tol, atol=tol * rms)


def n_params(params) -> int:
    """Parameters, without the norms' running statistics (buffers)."""
    return sum(t.numel() for k, v in params.items() if k != "stats" for t in tree_leaves(v))


def test_published_widths_give_the_leaderboards_parameter_count():
    params = gnn.init(torch.Generator().manual_seed(0), CONFIG, 100, "cpu")
    assert n_params(params) == 253_743
    assert params["enc"]["w"].shape == (100, 128) and params["out"]["w"].shape == (128, 47)
    assert len(params["layers"]) == len(params["norms"]) == len(params["stats"]) == 14
    assert CONFIG.family == "gnn" and CONFIG.kind == "deepergcn"


def test_the_count_formula_gives_the_arxiv_entry():
    """The same layout at 28 layers, 128 inputs and 40 classes gives OGB's
    ogbn-arxiv "DeeperGCN" count, which cross-checks the reading."""
    cfg = dataclasses.replace(CONFIG, n_layers=28, d_out=40)
    assert n_params(gnn.init(torch.Generator().manual_seed(0), cfg, 128, "cpu")) == 491_176


def test_not_in_the_registry():
    """The registry stays equal to the JAX package's, which has no DeeperGCN."""
    assert CONFIG.name not in base.ARCHS and "deepergcn" not in base.ARCHS


def test_the_case_has_hubs_and_isolated_vertices():
    indptr, _, _ = kron()
    deg = indptr[1:] - indptr[:-1]
    assert int((deg == 0).sum()) > 0 and int(deg.max()) > 64


@pytest.fixture(autouse=True)
def one_thread():
    """Each test here on one intra-op thread: its tensors are small, and the
    plain version's blocks are many small operations, which other
    processes' threads on a busy machine would otherwise hold up."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("block_items", [ref.BLOCK_ITEMS, 500])
def test_csr_route_matches_reference(monkeypatch, seed, block_items):
    """The CSR route in one block of rows, and in blocks that split the
    graph between rows."""
    monkeypatch.setattr(ref, "BLOCK_ITEMS", block_items)
    params, batch = setup(seed)
    got = csr_route(params, batch)
    assert got.shape == (batch["x"].shape[0], SMALL.d_out) and got.dtype == torch.float32
    close(got, reference(params, batch))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_version_in_blocks_below_every_hub(monkeypatch, seed):
    """A budget of 7 items, below every hub's degree, makes each such row a
    block alone: the same sums, item for item, as one block."""
    indptr, src, _ = kron(seed=seed + 3)
    u = torch.randn(indptr.shape[0] - 1, 16, generator=torch.Generator().manual_seed(seed))
    whole = ref.softmax_aggr_ref(indptr, src, u, SMALL.t, SMALL.eps)
    monkeypatch.setattr(ref, "BLOCK_ITEMS", 7)
    assert len(ref.row_blocks(indptr, 7)) > indptr.shape[0] // 2
    torch.testing.assert_close(ref.softmax_aggr_ref(indptr, src, u, SMALL.t, SMALL.eps), whole,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dict_route_matches_reference_and_csr_route(seed):
    params, batch = setup(seed)
    got = dict_route(params, batch)
    close(got, reference(params, batch))
    close(got, csr_route(params, batch))


@pytest.mark.parametrize("route", ["csr", "dict"])
def test_published_widths_match_reference(route):
    """14 layers of 128 on 100 features, then 47 classes, on a small graph."""
    params, batch = setup(5, scale=8, d_feat=100, cfg=CONFIG)
    got = (csr_route if route == "csr" else dict_route)(params, batch, CONFIG)
    assert got.shape == (batch["x"].shape[0], 47)
    close(got, reference(params, batch, cfg=CONFIG))


def test_kernels_plain_version_is_the_references_aggregation():
    """``ref.softmax_aggr_ref`` in float64 equals one GENConv of the plain
    reference whose encoder, Linear and head are identities and whose norm
    only shifts by 1e3 (which the head's bias takes back), so that its
    logits are u + m."""
    indptr, src, _ = kron(8, seed=4)
    n, d = indptr.shape[0] - 1, 8
    u = torch.randn(n, d, generator=torch.Generator().manual_seed(4), dtype=torch.float64) * 3
    eye = {"w": torch.eye(d, dtype=torch.float64), "b": torch.zeros(d, dtype=torch.float64)}
    params = {"enc": eye, "layers": [eye],
              "norms": [{"g": torch.ones(d, dtype=torch.float64),
                         "b": torch.full((d,), 1e3, dtype=torch.float64)}],
              "stats": [{"mean": torch.zeros(d, dtype=torch.float64),
                         "var": torch.full((d,), 1 - CONFIG.bn_eps, dtype=torch.float64)}],
              "out": {"w": torch.eye(d, dtype=torch.float64),
                      "b": torch.full((d,), -1e3, dtype=torch.float64)}}
    want = deepergcn_ref.deepergcn_forward(params, u, indptr, src, CONFIG.t, CONFIG.eps,
                                           CONFIG.bn_eps, block_items=300)
    got = ref.softmax_aggr_ref(indptr, src, u, CONFIG.t, CONFIG.eps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-11, atol=1e-11)


def test_float32_plain_version_within_the_kernels_bound():
    """The plain version in float32 keeps inside ``ref.error_bound``, the
    bound the card's kernel is held to (a check of the bound's form)."""
    indptr, src, _ = kron(9, seed=5)
    u = torch.randn(indptr.shape[0] - 1, 16, generator=torch.Generator().manual_seed(5)) * 10
    want = ref.softmax_aggr_ref(indptr, src, u.double(), CONFIG.t, CONFIG.eps)
    got = ref.softmax_aggr_ref(indptr, src, u, CONFIG.t, CONFIG.eps)
    bound = ref.error_bound(indptr, src, u, CONFIG.t, CONFIG.eps)
    assert ((got.double() - want).abs() <= bound).all()


@pytest.mark.parametrize("route", ["csr", "dict"])
def test_large_inputs_stay_finite_and_match(route):
    """Features scaled so that the first layer's scores t·q reach ~1e3:
    without the row's maximum taken out, exp would overflow. A float32
    score of 1e3 carries an error of ~1e3 · 2^-24, which the softmax turns
    into a relative error of that size in the weights."""
    params, batch = setup(1)
    batch = {**batch, "x": batch["x"] * 3e3}
    with torch.no_grad():
        h0 = gnn._affine(params["enc"], batch["x"])
    assert float(h0.max()) * SMALL.t > 500
    want = reference(params, batch)
    got = (csr_route if route == "csr" else dict_route)(params, batch)
    assert torch.isfinite(got).all()
    close(got, want, tol=1e-3)


def test_isolated_vertex_attends_to_itself():
    """A row without in-edges gives u + ReLU(u) + eps (within two float32
    roundings: the sums are taken in another order)."""
    indptr = torch.tensor([0, 0, 2, 2], dtype=torch.int32)
    src = torch.tensor([0, 2], dtype=torch.int32)
    u = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    out = kernel.softmax_aggr(indptr, src, u, 0, 0.1, 1e-7)
    for i in (0, 2):
        torch.testing.assert_close(out[i], u[i] + torch.relu(u[i]) + 1e-7, rtol=2.4e-7, atol=1e-7)


def test_aggregation_is_a_per_channel_softmax_over_in_edges_and_self_loop():
    """One row, two in-edges and its self loop, written out by hand."""
    indptr = torch.tensor([0, 0, 0, 2], dtype=torch.int32)
    src = torch.tensor([0, 1], dtype=torch.int32)
    u = torch.tensor([[1.0, -2.0], [3.0, 5.0], [-0.5, 4.0]], dtype=torch.float64)
    t, eps = 0.7, 1e-7
    q = torch.relu(u) + eps
    alpha = torch.softmax(t * q, 0)  # per channel, over the three items
    want = u[2] + (alpha * q).sum(0)
    got = ref.softmax_aggr_ref(indptr, src, u, t, eps)
    assert torch.allclose(got[2], want, rtol=1e-12, atol=1e-12)


def test_a_nan_makes_its_channel_nan():
    indptr, src, _ = kron(7, seed=1)
    n = indptr.shape[0] - 1
    u = torch.randn(n, 8, generator=torch.Generator().manual_seed(2))
    hub = int(torch.argmax(indptr[1:] - indptr[:-1]))
    j = int(src[int(indptr[hub])])
    u[j, 3] = math.nan
    out = ref.softmax_aggr_ref(indptr, src, u, 0.1, 1e-7)
    assert torch.isnan(out[hub, 3]) and torch.isfinite(out[hub, :3]).all()
    assert torch.isfinite(out[hub, 4:]).all()


def test_dict_route_takes_edges_in_any_order():
    """The dict route sorts its edges by destination itself: shuffled, they
    give the logits of the sorted batch (within float32 roundings: a row's
    in-edges are summed in their shuffled order)."""
    params, batch = setup(3)
    perm = torch.randperm(batch["src"].shape[0], generator=torch.Generator().manual_seed(3))
    shuffled = {**batch, "src": batch["src"][perm], "dst": batch["dst"][perm]}
    close(dict_route(params, shuffled), dict_route(params, batch), tol=1e-6)


def test_masked_edges_are_left_out_of_the_softmax():
    """The dict route with some edges masked equals it on the graph
    without them."""
    params, batch = setup(2)
    e = batch["src"].shape[0]
    keep = torch.rand(e, generator=torch.Generator().manual_seed(9)) < 0.6
    with torch.no_grad():
        masked = gnn.apply(params, SMALL, dict_batch(batch, keep))
        pruned = gnn.apply(params, SMALL, {"x": batch["x"], "src": batch["src"][keep],
                                           "dst": batch["dst"][keep],
                                           "emask": torch.ones(int(keep.sum()), dtype=torch.bool)})
    close(masked, pruned, tol=1e-6)


def test_dict_route_is_differentiable():
    params, batch = setup(0)
    leaves = [t.requires_grad_(True) for k, v in params.items() if k != "stats"
              for t in tree_leaves(v)]
    loss = gnn.apply(params, SMALL, dict_batch(batch)).pow(2).mean()
    grads = torch.autograd.grad(loss, leaves)
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


def test_one_aggregation_call_a_layer_with_the_plans_hot_rows(monkeypatch):
    calls = []
    real = gnn.softmax_aggr

    def counting(indptr, src, u, hot_size, t, eps):
        calls.append((u.shape, hot_size, t, eps, src.dtype))
        return real(indptr, src, u, hot_size, t, eps)

    monkeypatch.setattr(gnn, "softmax_aggr", counting)
    params, batch = setup(0)
    csr_route(params, batch)
    n = batch["x"].shape[0]
    hot = plan.make_plan(n, 4 * SMALL.d_hidden).hot_size
    assert hot > 0
    assert calls == [((n, SMALL.d_hidden), hot, SMALL.t, SMALL.eps, torch.int32)] * SMALL.n_layers


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


def test_csr_route_allocates_no_tensor_with_e_rows(monkeypatch):
    params, batch = setup(0)
    n, e = batch["x"].shape[0], batch["src"].shape[0]
    budget = e // 4
    monkeypatch.setattr(ref, "BLOCK_ITEMS", budget)
    assert e > 2 * (n + 1) and e > 2 * budget
    with _Shapes() as shapes:
        csr_route(params, batch)
    assert shapes.rows and max(r for _, r in shapes.rows) <= max(n + 1, budget)


def test_autograd_call_raises_and_names_the_dict_route():
    params, batch = setup(0)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    with pytest.raises(RuntimeError, match="batch dict"):
        gnn.apply(params, SMALL, batch)
    with torch.no_grad():
        assert gnn.apply(params, SMALL, batch).shape[1] == SMALL.d_out


@pytest.mark.parametrize("key", ["src", "indptr"])
def test_ids_must_be_int32(key):
    params, batch = setup(0)
    with pytest.raises(TypeError, match="int32"):
        csr_route(params, {**batch, key: batch[key].long()})


def test_binding_checks_its_inputs():
    indptr, src, _ = kron(6)
    n = indptr.shape[0] - 1
    u = torch.randn(n, 8)
    with pytest.raises(TypeError, match="int32"):
        kernel.softmax_aggr(indptr.long(), src, u, 0, 0.1, 1e-7)
    with pytest.raises(TypeError, match="float32"):
        kernel.softmax_aggr(indptr, src, u.double(), 0, 0.1, 1e-7)
    with pytest.raises(ValueError, match=r"\(n \+ 1,\)"):
        kernel.softmax_aggr(indptr[:, None], src, u, 0, 0.1, 1e-7)
    with pytest.raises(ValueError):
        kernel.softmax_aggr(indptr, src, u[:-1], 0, 0.1, 1e-7)


def test_spans_under_the_profiler():
    params, batch = setup(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        csr_route(params, batch)
    names = [ev.name for ev in prof.events()]
    assert names.count("gnn.aggregate") == SMALL.n_layers
    assert names.count("gnn.norm") == SMALL.n_layers  # before layers 1 .. L - 1 and the head
    assert names.count("gnn.transform") == SMALL.n_layers + 2  # the encoder, each layer, the head


def test_bfloat16_reference_is_far_from_float64():
    """The control of the benchmark's check: the reference in bfloat16 is
    far outside the tolerance that the float32 program meets."""
    params, batch = setup(0, d_feat=100, cfg=CONFIG)
    want = reference(params, batch, cfg=CONFIG)
    rms = float(want.pow(2).mean().sqrt())
    err = float((reference(params, batch, torch.bfloat16, CONFIG).double() - want).abs().max())
    ok = float((csr_route(params, batch, CONFIG).double() - want).abs().max())
    assert err / rms > 100 * ok / rms and err / rms > 100 * TOL


def test_reference_imports_only_torch():
    tree = ast.parse(Path(deepergcn_ref.__file__).read_text())
    names = {a.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)}
    assert names <= {"__future__", "torch"}, names


def test_config_is_frozen_and_holds_the_published_values():
    with pytest.raises(dataclasses.FrozenInstanceError):
        CONFIG.t = 1.0
    assert DeeperGCNConfig() == CONFIG
    assert (CONFIG.n_layers, CONFIG.d_hidden, CONFIG.d_out) == (14, 128, 47)
    assert (CONFIG.t, CONFIG.eps, CONFIG.bn_eps) == (0.1, 1e-7, 1e-5)
    assert {f.name for f in dataclasses.fields(CONFIG)} == {
        "name", "kind", "n_layers", "d_hidden", "d_out", "t", "eps", "bn_eps"}


def test_binding_refuses_a_device_without_the_kernel():
    n = 16
    indptr = torch.zeros(n + 1, dtype=torch.int32, device="meta")
    src = torch.empty(0, dtype=torch.int32, device="meta")
    u = torch.empty((n, 128), device="meta")
    with pytest.raises(RuntimeError, match="no softmax aggregation kernel for device meta"):
        kernel.softmax_aggr(indptr, src, u, 0, 0.1, 1e-7)
