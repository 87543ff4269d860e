"""GAT (``configs/gat.py``) through ``nn.gnn``: the batch-dict route and the
CSR route (the attention kernel's plain version on the CPU) against the
plain reference ``gbench/reference/gat.py`` in float64, on small Kronecker
graphs with seeded weights, on the CPU.

Tolerance: rtol = atol = 2e-5 against the float64 reference. The program
is float32 throughout: a layer's products sum at most 512 terms and its
softmax at most the largest in-degree plus one (under 400 here), each sum
a chain of float32 roundings (2^-24 each) of terms of about the output's
size, over three layers; the worst case here was 2.6e-6. The two routes
differ from each other only in the order of those sums and in where the
scores are formed (the CSR route folds the attention vectors into the
weights), so they are held to each other at the same tolerance.
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
from repro_torch.configs.gat import CONFIG, GATConfig
from repro_torch.core import plan
from repro_torch.graph import generate
from repro_torch.kernels.gat_attend import gat_attend as kernel
from repro_torch.kernels.gat_attend import ops as gat_ops
from repro_torch.kernels.gat_attend import ref
from repro_torch.nn import gnn
from repro_torch.train.tree import tree_leaves

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from gbench.reference import gat as gat_ref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
SMALL = dataclasses.replace(CONFIG, d_head=8, d_out=5)
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
        return gnn.apply(params, cfg, batch)


def dict_batch(batch, emask=None):
    e = batch["src"].shape[0]
    return {"x": batch["x"], "src": batch["src"], "dst": batch["dst"],
            "emask": torch.ones(e, dtype=torch.bool) if emask is None else emask}


def dict_route(params, batch, cfg=SMALL):
    with torch.no_grad():
        return gnn.apply(params, cfg, dict_batch(batch))


def reference(params, batch, dtype=torch.float64, cfg=SMALL):
    return gat_ref.gat_forward(params, batch["x"], batch["indptr"], batch["src"],
                               cfg.negative_slope, dtype=dtype, block_items=700)


def close(got, want, **tol):
    np.testing.assert_allclose(got.double().numpy(), want.double().numpy(), **(tol or TOL))


def test_published_widths_give_the_leaderboards_parameter_count():
    params = gnn.init(torch.Generator().manual_seed(0), CONFIG, 100, "cpu")
    assert sum(t.numel() for t in tree_leaves(params)) == 751_574
    first, _, last = params["layers"]
    assert first["lin"]["w"].shape == (100, 512) and first["skip"]["w"].shape == (100, 512)
    assert last["att_src"].shape == (4, 47) and last["bias"].shape == (47,)
    assert CONFIG.family == "gnn" and CONFIG.kind == "gat"


def test_not_in_the_registry():
    """The registry stays equal to the JAX package's, which has no GAT."""
    assert CONFIG.name not in base.ARCHS and "gat" not in base.ARCHS


def test_the_case_has_hubs_and_isolated_vertices():
    indptr, _, _ = kron()
    deg = indptr[1:] - indptr[:-1]
    assert int((deg == 0).sum()) > 0 and int(deg.max()) > 64


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("block_items", [ref.BLOCK_ITEMS, 500, 7])
def test_csr_route_matches_reference(monkeypatch, seed, block_items):
    """The CSR route in one block of rows, blocks that split the graph
    between rows, and a budget below every hub's degree (such a row is a
    block alone)."""
    monkeypatch.setattr(ref, "BLOCK_ITEMS", block_items)
    params, batch = setup(seed)
    got = csr_route(params, batch)
    assert got.shape == (batch["x"].shape[0], SMALL.d_out) and got.dtype == torch.float32
    close(got, reference(params, batch))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dict_route_matches_reference_and_csr_route(seed):
    params, batch = setup(seed)
    got = dict_route(params, batch)
    close(got, reference(params, batch))
    close(got, csr_route(params, batch))


@pytest.mark.parametrize("route", ["csr", "dict"])
def test_published_widths_match_reference(route):
    """4 heads of 128 on 100 features, then 4 of 47 averaged, on a small graph."""
    params, batch = setup(5, scale=8, d_feat=100, cfg=CONFIG)
    got = (csr_route if route == "csr" else dict_route)(params, batch, CONFIG)
    assert got.shape == (batch["x"].shape[0], 47)
    close(got, reference(params, batch, cfg=CONFIG), rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("route", ["csr", "dict"])
def test_large_scores_stay_finite_and_match(route):
    """Attention vectors scaled so that scores reach ~1e3: without the
    row's maximum taken out, exp would overflow. A float32 score of 1e3
    carries an error of ~1e3 · 2^-24 · 512, which the softmax turns into a
    relative error of that size in the weights: 1e-3 of the output's scale."""
    params, batch = setup(1)
    for lp in params["layers"]:
        lp["att_src"] *= 300.0
        lp["att_dst"] *= 300.0
    want = reference(params, batch)
    got = (csr_route if route == "csr" else dict_route)(params, batch)
    assert torch.isfinite(got).all()
    scores = []
    for lp in params["layers"][:1]:
        z, s_src, _, _ = gat_ops.project(batch["x"], lp)
        scores.append(float(s_src.abs().max()))
    assert max(scores) > 500
    scale = float(want.abs().max())
    close(got, want, rtol=0, atol=1e-3 * scale)


def test_isolated_vertex_attends_to_itself():
    """A row without in-edges gives its own row of z."""
    indptr = torch.tensor([0, 0, 2, 2], dtype=torch.int32)
    src = torch.tensor([0, 2], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    z, s = torch.randn(3, 8, generator=gen), torch.randn(3, 4, generator=gen)
    out = kernel.gat_attend(indptr, src, z, s[:, :2], s[:, 2:], 0, 0.2, False)
    assert torch.equal(out[0], z[0]) and torch.equal(out[2], z[2])
    mean = kernel.gat_attend(indptr, src, z, s[:, :2], s[:, 2:], 0, 0.2, True)
    assert torch.allclose(mean[0], z[0].view(2, 4).mean(0))


def test_attention_is_a_softmax_over_in_edges_and_self_loop():
    """One row, two in-edges and its self loop, written out by hand."""
    indptr = torch.tensor([0, 0, 0, 2], dtype=torch.int32)
    src = torch.tensor([0, 1], dtype=torch.int32)
    z = torch.tensor([[1.0, 2.0], [3.0, -1.0], [0.5, 4.0]], dtype=torch.float64)
    s_src = torch.tensor([[0.3], [-2.0], [1.0]], dtype=torch.float64)
    s_dst = torch.tensor([[0.0], [0.0], [0.5]], dtype=torch.float64)
    e = torch.tensor([0.8, -1.5 * 0.2, 1.5], dtype=torch.float64)
    alpha = torch.softmax(e, 0)
    want = alpha[0] * z[0] + alpha[1] * z[1] + alpha[2] * z[2]
    got = ref.gat_attend_ref(indptr, src, z, s_src, s_dst, 0.2, False)
    assert torch.allclose(got[2], want, rtol=1e-12, atol=1e-12)


def test_a_nan_score_makes_its_rows_head_nan():
    indptr, src, _ = kron(7, seed=1)
    n = indptr.shape[0] - 1
    gen = torch.Generator().manual_seed(2)
    z, s = torch.randn(n, 8, generator=gen), torch.randn(n, 4, generator=gen)
    hub = int(torch.argmax(indptr[1:] - indptr[:-1]))
    j = int(src[int(indptr[hub])])
    s[j, 0] = math.nan
    out = ref.gat_attend_ref(indptr, src, z, s[:, :2], s[:, 2:], 0.2, False)
    assert torch.isnan(out[hub, :4]).all() and torch.isfinite(out[hub, 4:]).all()


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
    close(masked, pruned, rtol=1e-6, atol=1e-6)


def test_dict_route_without_self_loops():
    """``self_loops=False`` on the dict route: a row without in-edges sums
    to 0, so its logits are the bias and the skip alone."""
    cfg = dataclasses.replace(SMALL, self_loops=False, n_layers=1)
    params, batch = setup(0, cfg=cfg)
    out = dict_route(params, batch, cfg)
    lp = params["layers"][0]
    iso = (batch["indptr"][1:] - batch["indptr"][:-1]) == 0
    want = lp["bias"] + batch["x"][iso] @ lp["skip"]["w"] + lp["skip"]["b"]
    close(out[iso], want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="self_loops"):
        csr_route(params, batch, cfg)


def test_dict_route_is_differentiable():
    params, batch = setup(0)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss = gnn.apply(params, SMALL, dict_batch(batch)).pow(2).mean()
    grads = torch.autograd.grad(loss, leaves)
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


@pytest.mark.parametrize("grasp", [True, False])
def test_one_attention_call_a_layer_with_the_plans_hot_rows(monkeypatch, grasp):
    calls = []
    real = gnn.gat_attend

    def counting(indptr, src, z, s_src, s_dst, hot_size, slope, mean):
        calls.append((z.shape[1], hot_size, mean, src.dtype))
        return real(indptr, src, z, s_src, s_dst, hot_size, slope, mean)

    monkeypatch.setattr(gnn, "gat_attend", counting)
    params, batch = setup(0)
    cfg = dataclasses.replace(SMALL, grasp=grasp)
    csr_route(params, batch, cfg)
    n = batch["x"].shape[0]
    widths = [SMALL.heads * SMALL.d_head] * 2 + [SMALL.heads * SMALL.d_out]
    want = [plan.make_plan(n, 4 * w).hot_size if grasp else 0 for w in widths]
    assert calls == [(w, h, i == 2, torch.int32) for i, (w, h) in enumerate(zip(widths, want))]


def test_project_is_one_product_of_rows_scores_and_skip():
    params, batch = setup(0)
    lp = params["layers"][0]
    x = batch["x"]
    z, s_src, s_dst, skip = gat_ops.project(x, lp)
    assert z.data_ptr() == z.untyped_storage().data_ptr()  # all four views of one tensor
    assert z.stride(0) % 4 == 0 and z.stride(0) == s_src.stride(0) == skip.stride(0)
    heads, c = lp["att_src"].shape
    zz = (x @ lp["lin"]["w"]).view(-1, heads, c)
    close(z, zz.reshape(z.shape), rtol=1e-6, atol=1e-6)
    close(s_src, (zz * lp["att_src"]).sum(-1), rtol=1e-5, atol=1e-5)
    close(s_dst, (zz * lp["att_dst"]).sum(-1), rtol=1e-5, atol=1e-5)
    close(skip, x @ lp["skip"]["w"], rtol=1e-6, atol=1e-6)


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
    z, s = torch.randn(n, 8), torch.randn(n, 2)
    with pytest.raises(TypeError, match="int32"):
        kernel.gat_attend(indptr.long(), src, z, s, s, 0, 0.2, False)
    with pytest.raises(TypeError, match="float32"):
        kernel.gat_attend(indptr, src, z.double(), s, s, 0, 0.2, False)
    with pytest.raises(ValueError, match="dividing"):
        kernel.gat_attend(indptr, src, torch.randn(n, 9), s, s, 0, 0.2, False)
    with pytest.raises(ValueError, match="unit column stride"):
        kernel.gat_attend(indptr, src, torch.randn(8, n).t(), s, s, 0, 0.2, False)
    with pytest.raises(ValueError):
        kernel.gat_attend(indptr, src, z[:-1], s, s, 0, 0.2, False)


def test_spans_under_the_profiler():
    params, batch = setup(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        csr_route(params, batch)
    names = [ev.name for ev in prof.events()]
    for span in ("gnn.transform", "gnn.attend", "gnn.update"):
        assert names.count(span) == SMALL.n_layers


def test_bfloat16_reference_is_far_from_float64():
    """The control of the benchmark's check: the reference in bfloat16 is
    far outside the tolerance that the float32 program meets."""
    params, batch = setup(0, d_feat=100, cfg=CONFIG)
    want = reference(params, batch, cfg=CONFIG)
    rms = float(want.pow(2).mean().sqrt())
    err = float((reference(params, batch, torch.bfloat16, CONFIG).double() - want).abs().max())
    ok = float((csr_route(params, batch, CONFIG).double() - want).abs().max())
    assert err / rms > 100 * ok / rms


def test_reference_imports_only_torch():
    tree = ast.parse(Path(gat_ref.__file__).read_text())
    names = {a.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names}
    names |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)}
    assert names <= {"__future__", "torch"}, names


def test_config_is_frozen_and_unregistered_fields_are_its_own():
    with pytest.raises(dataclasses.FrozenInstanceError):
        CONFIG.heads = 8
    assert GATConfig() == CONFIG
    assert (CONFIG.n_layers, CONFIG.heads, CONFIG.d_head, CONFIG.d_out) == (3, 4, 128, 47)
    assert (CONFIG.negative_slope, CONFIG.self_loops, CONFIG.grasp) == (0.2, True, True)


def test_binding_refuses_a_device_without_the_kernel():
    n = 16
    indptr = torch.zeros(n + 1, dtype=torch.int32, device="meta")
    src = torch.empty(0, dtype=torch.int32, device="meta")
    z, s = torch.empty((n, 8), device="meta"), torch.empty((n, 2), device="meta")
    with pytest.raises(RuntimeError, match="no GAT attention kernel for device meta"):
        kernel.gat_attend(indptr, src, z, s, s, 0, 0.2, False)
