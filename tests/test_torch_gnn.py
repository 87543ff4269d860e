"""repro_torch's GNNs (GIN, PNA, EGNN, NequIP), their configs, batches and
the fanout sampler against the JAX package's, on the CPU.

Parameters come from the JAX ``init`` and reach the port through
``convert.gnn_params_from_numpy``; batches are built by both packages'
pipelines from one numpy seed and must be equal array for array, as must
the sampler's blocks. Tolerances (``|port - jax| <= atol + rtol * |jax|``):

- GIN: rtol = atol = 1e-5 (float32 throughout).
- PNA and EGNN: rtol = atol = 5e-5. Float32 throughout too, but torch's
  CPU matrix products round differently from XLA's in the last bit (most
  entries of a narrow product differ by an ulp), and each model amplifies
  that: PNA's ``std`` is ``sqrt(var + 1e-5)`` over a variance that cancels
  to ~0, so an ulp in a message moves it by ~1e-5; EGNN's features reach
  ~200. The worst case over 12 seeds and the three batch kinds was 1.45e-5.
- NequIP: rtol = atol = 2e-3. Its ``self0`` and ``gate`` products run in
  bfloat16 (``dense``'s default, as in the JAX package), so a product that
  rounds to the neighbouring bfloat16 value (2^-8 relative) in one package
  and not the other carries through the layers; the worst case measured at
  the molecule shape (128 x 30 nodes) was 4.0e-4 against energies of 0.45.
  At the reduced sizes below it was 1.2e-7.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_cfgs
from repro.data import pipeline as j_pipe
from repro.graph import generate as j_gen
from repro.graph import sampler as j_sampler
from repro.launch import steps as j_steps
from repro.nn import gnn as j_gnn
from repro.nn import layers as j_layers
from repro.train import optimizer as j_opt
from repro_torch import convert
from repro_torch.configs import base as t_cfgs
from repro_torch.data import pipeline as t_pipe
from repro_torch.graph import generate as t_gen
from repro_torch.graph import sampler as t_sampler
from repro_torch.launch import steps as t_steps
from repro_torch.nn import gnn as t_gnn
from repro_torch.nn import layers as t_layers
from repro_torch.train.trainer import value_and_grad
from repro_torch.train.tree import tree_leaves

ARCHS = ["gin-tu", "pna", "egnn", "nequip"]
KINDS = ["full_graph", "molecule", "minibatch"]
TOL = {"gin": dict(rtol=1e-5, atol=1e-5), "pna": dict(rtol=5e-5, atol=5e-5),
       "egnn": dict(rtol=5e-5, atol=5e-5), "nequip": dict(rtol=2e-3, atol=2e-3)}


def cfg_pair(arch, **changes):
    j = dataclasses.replace(j_cfgs.reduced(j_cfgs.get_arch(arch)), **changes)
    t = dataclasses.replace(t_cfgs.reduced(t_cfgs.get_arch(arch)), **changes)
    return j, t


def params_pair(jcfg, d_feat=16, seed=0):
    jp = j_gnn.init(jax.random.PRNGKey(seed), jcfg, d_feat)
    return jp, convert.gnn_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def batch_pair(kind, seed=0, d_feat=16):
    """The same batch from both packages' pipelines (and their shapes)."""
    if kind == "full_graph":
        args = ("s", "full_graph", 256, 1024)
        kw = dict(d_feat=d_feat)
        return (j_pipe.gnn_full_graph_batch(np.random.default_rng(seed), j_cfgs.GNNShape(
                    *args, **kw), scale_override=8),
                t_pipe.gnn_full_graph_batch(np.random.default_rng(seed), t_cfgs.GNNShape(
                    *args, **kw), scale_override=8))
    if kind == "molecule":
        args = ("s", "molecule", 10, 20)
        kw = dict(d_feat=d_feat, batch_graphs=4)
        return (j_pipe.gnn_molecule_batch(np.random.default_rng(seed), j_cfgs.GNNShape(*args, **kw)),
                t_pipe.gnn_molecule_batch(np.random.default_rng(seed), t_cfgs.GNNShape(*args, **kw)))
    jg, tg = j_gen.rmat(8, 8, seed=0), t_gen.rmat(8, 8, seed=0)
    args = ("s", "minibatch", jg.num_nodes, jg.num_edges)
    kw = dict(d_feat=d_feat, batch_nodes=8, fanout=(3, 2))
    return (j_pipe.gnn_minibatch(np.random.default_rng(seed), jg, j_cfgs.GNNShape(*args, **kw),
                                 d_feat=d_feat),
            t_pipe.gnn_minibatch(np.random.default_rng(seed), tg, t_cfgs.GNNShape(*args, **kw),
                                 d_feat=d_feat))


def outputs(out):
    """Model outputs as a tuple of float32 numpy arrays (EGNN gives two)."""
    out = out if isinstance(out, tuple) else (out,)
    return tuple(np.asarray(o.float() if isinstance(o, torch.Tensor) else o, np.float32)
                 for o in out)


def assert_same_outputs(jcfg, jp, tp, jb, tb):
    want = outputs(j_gnn.apply(jp, jcfg, {k: jnp.asarray(v) for k, v in jb.items()}))
    got = outputs(t_gnn.apply(tp, jcfg, tb))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL[jcfg.kind])
    return got


# ---------------------------------------------------------------------------
# configs, layers, parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_reduced_match(arch):
    j, t = j_cfgs.get_arch(arch), t_cfgs.get_arch(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t_cfgs.reduced(t)) == dataclasses.asdict(j_cfgs.reduced(j))
    assert t.family == "gnn"


def test_gnn_shapes_match():
    assert {k: dataclasses.asdict(v) for k, v in t_cfgs.GNN_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in j_cfgs.GNN_SHAPES.items()}
    assert t_cfgs.SHAPES["gnn"] is t_cfgs.GNN_SHAPES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 24)) * 3 + 1).astype(np.float32)
    g, b = rng.standard_normal(24).astype(np.float32), rng.standard_normal(24).astype(np.float32)
    want = j_layers.layernorm({"g": jnp.asarray(g), "b": jnp.asarray(b)},
                              jnp.asarray(x).astype(dtype))
    got = t_layers.layernorm({"g": torch.tensor(g), "b": torch.tensor(b)},
                             torch.tensor(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-5, atol=1e-5)
    init = t_layers.layernorm_init(24)
    assert torch.equal(init["g"], torch.ones(24)) and torch.equal(init["b"], torch.zeros(24))


def tree_shapes(tree):
    """The tree's structure with each leaf replaced by (shape, dtype)."""
    if isinstance(tree, dict):
        return {k: tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_shapes(v) for v in tree]
    if tree is None:
        return None
    return (tuple(tree.shape), str(np.asarray(tree).dtype) if not isinstance(
        tree, torch.Tensor) else str(tree.dtype).removeprefix("torch."))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("changes", [{}, {"eps_learnable": False, "l_max": 1}],
                         ids=["default", "no-eps-lmax1"])
def test_init_and_convert_keep_the_reference_tree(arch, changes):
    """The port's init gives the JAX init's tree (shapes, dtypes, Nones);
    converting the JAX parameters keeps it too, values exactly."""
    jcfg, tcfg = cfg_pair(arch, **changes)
    jp = j_gnn.init(jax.random.PRNGKey(0), jcfg, 12)
    tp = t_gnn.init(torch.Generator().manual_seed(0), tcfg, 12, device="cpu")
    assert tree_shapes(tp) == tree_shapes(jp)
    conv = convert.gnn_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tree_shapes(conv) == tree_shapes(jp)
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(
            t_gnn.tree_map(lambda t: t.numpy(), conv))):
        np.testing.assert_array_equal(b, np.asarray(a))
    if arch == "gin-tu":
        assert (conv["layers"][0]["eps"] is None) == (not jcfg.eps_learnable)
    if arch == "nequip":
        assert (conv["layers"][0]["r02"] is None) == (jcfg.l_max < 2)


# ---------------------------------------------------------------------------
# batches and the sampler: exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_batch_builders_match_exactly(kind):
    jb, tb = batch_pair(kind, seed=3)
    assert sorted(tb) == sorted(jb)
    for k in jb:
        assert tb[k].dtype == jb[k].dtype, k
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


@pytest.mark.parametrize("batch_nodes,fanout", [(1024, (15, 10)), (16, (5, 3)), (7, ()),
                                                (3, (2, 2, 2))])
def test_subgraph_shape_matches(batch_nodes, fanout):
    assert t_sampler.subgraph_shape(batch_nodes, fanout) == j_sampler.subgraph_shape(
        batch_nodes, fanout)


@pytest.mark.parametrize("scale,degree,fanout", [(8, 4, (3, 3)), (10, 8, (5, 3)),
                                                 (6, 1, (4, 2, 2))])
def test_sample_blocks_matches_exactly(scale, degree, fanout):
    """Same graph, seeds and generator state: the same blocks, and the
    generators end in the same state. Sparse graphs have nodes with no
    in-neighbours, whose samples are masked."""
    jg, tg = j_gen.rmat(scale, degree, seed=1), t_gen.rmat(scale, degree, seed=1)
    seeds = np.random.default_rng(0).integers(0, jg.num_nodes, 32)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    want = j_sampler.sample_blocks(jg, seeds, fanout, jr)
    got = t_sampler.sample_blocks(tg, seeds, fanout, tr)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert got.n_sub == want.n_sub
    assert tr.bit_generator.state == jr.bit_generator.state
    if degree == 1:
        assert not got.emask.all()


def test_sampler_shapes_and_validity():
    """tests/test_smoke_archs.py's sampler check on the port."""
    g = t_gen.rmat(10, 8, seed=0)
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, g.num_nodes, 16)
    blocks = t_sampler.sample_blocks(g, seeds, (5, 3), rng)
    n_sub, e_sub = t_sampler.subgraph_shape(16, (5, 3))
    assert blocks.node_ids.shape == (n_sub,)
    assert blocks.src.shape == (e_sub,)
    # every valid edge's sampled neighbour is a true in-neighbour
    indptr, indices = g.indptr, g.indices
    for k in rng.integers(0, e_sub, 50):
        if not blocks.emask[k]:
            continue
        dst_g = blocks.node_ids[blocks.dst[k]]
        src_g = blocks.node_ids[blocks.src[k]]
        nbrs = indices[indptr[dst_g]:indptr[dst_g + 1]]
        assert src_g in nbrs


# ---------------------------------------------------------------------------
# the four models against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_models_match_jax(arch, kind, seed):
    jcfg, _ = cfg_pair(arch)
    jp, tp = params_pair(jcfg, seed=seed)
    jb, tb = batch_pair(kind, seed=seed)
    got = assert_same_outputs(jcfg, jp, tp, jb, tb)
    assert all(np.isfinite(g).all() for g in got)


def test_gin_without_learnable_eps_matches_jax():
    jcfg, _ = cfg_pair("gin-tu", eps_learnable=False)
    jp, tp = params_pair(jcfg)
    assert all(layer["eps"] is None for layer in tp["layers"])
    jb, tb = batch_pair("full_graph")
    assert_same_outputs(jcfg, jp, tp, jb, tb)
    # eps = 0 learnable and no eps agree: (1 + 0) * h == h
    jl = dataclasses.replace(jcfg, eps_learnable=True)
    tp_eps = convert.gnn_params_from_numpy(jax.tree_util.tree_map(np.asarray, j_gnn.init(
        jax.random.PRNGKey(0), jl, 16)), "cpu")
    np.testing.assert_array_equal(t_gnn.apply(tp_eps, jl, tb).numpy(),
                                  t_gnn.apply(tp, jcfg, tb).numpy())


def isolated_and_masked_batch():
    """Nodes 0-3 receive edges; 4 and 5 receive only masked edges; 6 and 7
    receive none. Messages include large negative and positive values."""
    rng = np.random.default_rng(4)
    dst = np.array([0, 0, 1, 2, 2, 2, 3, 4, 4, 5], np.int32)
    src = np.array([1, 6, 7, 0, 5, 6, 3, 0, 1, 7], np.int32)
    emask = np.array([1, 1, 1, 1, 0, 1, 1, 0, 0, 0], bool)
    return {"x": (rng.standard_normal((8, 16)) * 4).astype(np.float32), "src": src,
            "dst": dst, "emask": emask}


def test_pna_isolated_and_fully_masked_destinations():
    jcfg, _ = cfg_pair("pna")
    jp, tp = params_pair(jcfg)
    batch = isolated_and_masked_batch()
    assert_same_outputs(jcfg, jp, tp, batch, batch)
    # the segment extremes themselves: zero where the JAX package's are not finite
    m = np.random.default_rng(5).standard_normal((10, 3)).astype(np.float32)
    em = batch["emask"][:, None]
    for sign, j_op, reduce in ((-1, jax.ops.segment_max, "amax"),
                               (1, jax.ops.segment_min, "amin")):
        want = j_op(jnp.where(em, m, sign * jnp.inf), jnp.asarray(batch["dst"]), num_segments=8)
        want = np.asarray(jnp.where(jnp.isfinite(want), want, 0.0))
        got = t_gnn._seg_extreme(torch.where(torch.tensor(em), torch.tensor(m), sign * np.inf),
                                 torch.tensor(batch["dst"]).long(), 8, reduce)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want[4:] == 0).all()


def test_egnn_masked_degree_and_coords_match():
    """EGNN's coordinate update divides by the masked degree; the isolated
    and fully-masked nodes keep their coordinates."""
    jcfg, _ = cfg_pair("egnn")
    jp, tp = params_pair(jcfg)
    batch = dict(isolated_and_masked_batch(),
                 coords=np.random.default_rng(6).standard_normal((8, 3)).astype(np.float32))
    _, coords = assert_same_outputs(jcfg, jp, tp, batch, batch)
    np.testing.assert_array_equal(coords[4:], batch["coords"][4:])


# ---------------------------------------------------------------------------
# the reference's own model checks (tests/test_nn.py, tests/test_smoke_archs.py)
# ---------------------------------------------------------------------------
def _rot():
    a, b, c = 0.3, 1.1, -0.7
    rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
    return (rx @ ry @ rz).astype(np.float32)


def _mol_batch(rng, n=20, e=60, d=8):
    return {
        "x": rng.standard_normal((n, d)).astype(np.float32),
        "src": rng.integers(0, n, e).astype(np.int32),
        "dst": rng.integers(0, n, e).astype(np.int32),
        "emask": np.ones(e, bool),
        "coords": rng.standard_normal((n, 3)).astype(np.float32),
        "species": rng.integers(0, 8, n).astype(np.int32),
    }


def _init(cfg, d_feat=8):
    return t_gnn.init(torch.Generator().manual_seed(0), cfg, d_feat, device="cpu")


def test_egnn_equivariance():
    cfg = t_cfgs.GNNConfig(name="t", kind="egnn", n_layers=2, d_hidden=16)
    batch = _mol_batch(np.random.default_rng(0))
    params = _init(cfg)
    h1, c1 = t_gnn.apply(params, cfg, batch)
    R = _rot()
    h2, c2 = t_gnn.apply(params, cfg, dict(batch, coords=batch["coords"] @ R.T))
    # invariant features, equivariant coordinates
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=2e-4)
    np.testing.assert_allclose(c1.numpy() @ R.T, c2.numpy(), atol=2e-4)


def test_egnn_translation_equivariance():
    cfg = t_cfgs.GNNConfig(name="t", kind="egnn", n_layers=2, d_hidden=16)
    batch = _mol_batch(np.random.default_rng(1))
    params = _init(cfg)
    h1, c1 = t_gnn.apply(params, cfg, batch)
    shift = np.array([5.0, -3.0, 2.0], np.float32)
    h2, c2 = t_gnn.apply(params, cfg, dict(batch, coords=batch["coords"] + shift))
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=2e-4)
    np.testing.assert_allclose(c1.numpy() + shift, c2.numpy(), atol=2e-4)


def test_nequip_rotation_invariance():
    cfg = t_cfgs.GNNConfig(name="t", kind="nequip", n_layers=2, d_hidden=8,
                           l_max=2, n_rbf=4, cutoff=5.0)
    batch = _mol_batch(np.random.default_rng(2))
    params = _init(cfg)
    e1 = t_gnn.apply(params, cfg, batch)
    e2 = t_gnn.apply(params, cfg, dict(batch, coords=batch["coords"] @ _rot().T))
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), atol=1e-4)


def test_gin_isomorphism_sum_agg():
    """GIN with sum aggregation distinguishes multisets: doubling an edge
    changes the target's embedding (mean-agg would not for equal msgs)."""
    cfg = t_cfgs.GNNConfig(name="t", kind="gin", n_layers=1, d_hidden=8)
    params = _init(cfg, d_feat=4)
    x = np.ones((3, 4), np.float32)
    b1 = {"x": x, "src": np.array([1], np.int32), "dst": np.array([0], np.int32),
          "emask": np.ones(1, bool)}
    b2 = {"x": x, "src": np.array([1, 2], np.int32),
          "dst": np.array([0, 0], np.int32), "emask": np.ones(2, bool)}
    o1, o2 = t_gnn.apply(params, cfg, b1).numpy(), t_gnn.apply(params, cfg, b2).numpy()
    assert np.abs(o1[0] - o2[0]).max() > 1e-5


def test_pna_aggregators_shapes():
    cfg = t_cfgs.GNNConfig(name="t", kind="pna", n_layers=2, d_hidden=16)
    batch = _mol_batch(np.random.default_rng(3), n=30, e=100, d=8)
    out = t_gnn.apply(_init(cfg), cfg, batch)
    assert out.shape == (30, cfg.d_out)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", KINDS)
def test_gnn_smoke_all_shapes(arch, kind):
    """Every kind on every batch kind: finite outputs of the right shape."""
    cfg = t_cfgs.reduced(t_cfgs.get_arch(arch))
    _, batch = batch_pair(kind)
    params = t_gnn.init(torch.Generator().manual_seed(0), cfg, 16, device="cpu")
    out = t_gnn.apply(params, cfg, batch)
    out = out[0] if isinstance(out, tuple) else out
    assert torch.isfinite(out).all()
    n_nodes = batch["x"].shape[0]
    assert out.shape == ((n_nodes,) if cfg.kind == "nequip" else (n_nodes, cfg.d_out))
    assert out.dtype == torch.float32


# ---------------------------------------------------------------------------
# training: the cells' loss and its gradients against jax.value_and_grad
# (launch/steps.py), and one composed AdamW step
# ---------------------------------------------------------------------------


def train_batch_pair(arch, kind, seed=0):
    """Both packages' batch; GIN and PNA get molecule labels in [0, d_out),
    as the JAX package's own smoke test draws them."""
    jcfg, _ = cfg_pair(arch)
    jb, tb = batch_pair(kind, seed=seed)
    if kind == "molecule" and jcfg.kind in ("gin", "pna"):
        labels = np.random.default_rng(seed + 100).integers(0, jcfg.d_out, 4).astype(np.int32)
        jb, tb = dict(jb, labels=labels), dict(tb, labels=labels)
    return jcfg, jb, tb


# NequIP's gradients run back through its two bfloat16 products and the
# bfloat16 features between its layers, in both packages: an input that
# rounds to the neighbouring bfloat16 value in one package moves a weight
# gradient by that ulp times its cotangent, whatever the gradient's own
# size. They are held to 2^-5 (four bfloat16 ulps) of each leaf's largest
# entry; the worst measured over 24 batches (the three kinds x 8 seeds,
# reduced NequIP) was 1.69e-2 of it, on ``embed`` at the molecule batch.
NEQUIP_GRAD_SCALE = 2.0 ** -5


def assert_loss_and_grads(jcfg, jp, tp, jb, tb):
    want_loss, want_grads = jax.value_and_grad(j_steps._gnn_loss)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in jb.items()})
    loss, grads = value_and_grad(t_steps.gnn_loss, tp, jcfg, tb)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL[jcfg.kind])
    t_leaves, j_leaves = tree_leaves(grads), jax.tree_util.tree_leaves(want_grads)
    assert len(t_leaves) == len(j_leaves)
    for i, (t, j) in enumerate(zip(t_leaves, j_leaves)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32, i
        j = np.asarray(j)
        if jcfg.kind == "nequip":
            bound = NEQUIP_GRAD_SCALE * np.abs(j).max()
            assert np.abs(t.numpy() - j).max() <= bound, f"grad leaf {i}"
        else:
            np.testing.assert_allclose(t.numpy(), j, err_msg=f"grad leaf {i}", **TOL[jcfg.kind])
    return float(loss), t_leaves


@pytest.mark.parametrize("kind", ["molecule", "minibatch", "full_graph"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_loss_and_every_gradient_match_jax(arch, kind):
    """On the minibatch and full-graph batches GIN's and PNA's labels come
    from 47 classes against 16 logits: both packages give a NaN loss (the
    rows past the logits) and the same finite gradients."""
    jcfg, jb, tb = train_batch_pair(arch, kind)
    jp, tp = params_pair(jcfg)
    loss, grads = assert_loss_and_grads(jcfg, jp, tp, jb, tb)
    assert all(torch.isfinite(g).all() for g in grads)
    out_of_range = jcfg.kind in ("gin", "pna") and kind != "molecule"
    if out_of_range:
        assert (tb["labels"] >= jcfg.d_out).any()
    assert np.isnan(loss) == out_of_range
    assert sum(float(g.abs().sum()) for g in grads) > 0


def test_pna_ties_split_the_gradient_as_jax():
    """Duplicate edges give equal messages, so segment max and min tie;
    JAX averages the tangent over tied entries, torch's scatter_reduce
    splits the gradient evenly: the same gradients."""
    jcfg, _ = cfg_pair("pna")
    jp, tp = params_pair(jcfg, d_feat=8)
    rng = np.random.default_rng(9)
    src = np.array([1, 1, 1, 2, 3, 3, 0, 0, 4, 4], np.int32)
    dst = np.array([0, 0, 0, 0, 1, 1, 2, 2, 3, 3], np.int32)   # every edge doubled or tripled
    batch = {"x": rng.standard_normal((6, 8)).astype(np.float32), "src": src, "dst": dst,
             "emask": np.ones(10, bool), "labels": rng.integers(0, 16, 6).astype(np.int32)}
    assert_loss_and_grads(jcfg, jp, tp, batch, batch)
    # the scatter itself: [0, .5, .5, 1] in both
    x = jnp.array([1.0, 3.0, 3.0, 2.0])
    ids = jnp.array([0, 0, 0, 1])
    want = jax.grad(lambda v: jax.ops.segment_max(v, ids, num_segments=2).sum())(x)
    xt = torch.tensor([[1.0], [3.0], [3.0], [2.0]], requires_grad=True)
    t_gnn._seg_extreme(xt, torch.tensor([0, 0, 0, 1]), 2, "amax").sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy()[:, 0], np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy()[:, 0], [0.0, 0.5, 0.5, 1.0])


def test_take_along_last_matches_jax():
    logp = np.log(np.arange(1, 7, dtype=np.float32) / 21).reshape(2, 3)
    labels = np.array([-1, 5], np.int32)
    want = jnp.take_along_axis(jnp.asarray(logp), jnp.asarray(labels)[..., None], axis=-1)[..., 0]
    got = t_steps.take_along_last(torch.as_tensor(logp), torch.as_tensor(labels))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isnan(got[1]) and float(got[0]) == logp[0, 2]
    with pytest.raises(TypeError):
        t_steps.take_along_last(torch.as_tensor(logp), torch.zeros(2))
    assert t_steps.N_CLASSES == j_steps.N_CLASSES


@pytest.mark.parametrize("arch", ARCHS)
def test_gnn_train_step_matches_the_jax_composition(arch):
    """One AdamW (lr 1e-3) step as the JAX package's GNN train cell composes
    it (value_and_grad of _gnn_loss, then opt_update), from a state two
    steps in."""
    jcfg, jb, tb = train_batch_pair(arch, "molecule")
    jp, _ = params_pair(jcfg)
    j_init, j_update = j_opt.make(j_opt.OptConfig(name="adamw", lr=1e-3))
    js, jbatch = j_init(jp), {k: jnp.asarray(v) for k, v in jb.items()}
    for _ in range(2):
        _, g = jax.value_and_grad(j_steps._gnn_loss)(jp, jcfg, jbatch)
        jp, js = j_update(g, js, jp)
    tp = convert.gnn_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    ts = convert.opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, js), "cpu")
    want_loss, g = jax.value_and_grad(j_steps._gnn_loss)(jp, jcfg, jbatch)
    jp, js = j_update(g, js, jp)
    _, step = t_steps.gnn_train_step(jcfg, t_cfgs.GNN_SHAPES["molecule"], device="cpu")
    tp, ts, metrics = step(tp, ts, tb)
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), **TOL[jcfg.kind])
    for t, j in zip(tree_leaves((tp, ts)), jax.tree_util.tree_leaves((jp, js))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL[jcfg.kind])
    assert int(ts["step"]) == 3


def test_grasp_gin_cell_waits_for_dist():
    """gin + grasp on ogb_products is the GRASP-partitioned cell: it waits
    for a torch.distributed process group (tests/test_torch_dist.py builds
    and trains it over one) and raises without one."""
    gin = t_cfgs.get_arch("gin-tu")
    with pytest.raises(RuntimeError, match="process group"):
        t_steps.gnn_train_step(gin, t_cfgs.GNN_SHAPES["ogb_products"], device="cpu")
    # without GRASP, or on another shape, the plain step is built
    t_steps.gnn_train_step(dataclasses.replace(gin, grasp=False),
                           t_cfgs.GNN_SHAPES["ogb_products"], device="cpu")
    t_steps.gnn_train_step(gin, t_cfgs.GNN_SHAPES["minibatch_lg"], device="cpu")


def test_gnn_smoke_train_step_loss():
    """tests/test_smoke_archs.py's train-step check on the port: the cell
    loss of each kind is finite with finite, non-zero gradients."""
    rng = np.random.default_rng(1)
    for arch in ARCHS:
        cfg = t_cfgs.reduced(t_cfgs.get_arch(arch))
        shape = t_cfgs.GNNShape("s", "molecule", 10, 20, d_feat=16, batch_graphs=4)
        batch = t_pipe.gnn_molecule_batch(rng, shape)
        if cfg.kind in ("gin", "pna"):
            batch["labels"] = rng.integers(0, cfg.d_out, 4).astype(np.int32)
        params = t_gnn.init(torch.Generator().manual_seed(0), cfg, 16, device="cpu")
        loss, grads = value_and_grad(t_steps.gnn_loss, params, cfg, batch)
        assert np.isfinite(float(loss)), arch
        gn = sum(float(g.abs().sum()) for g in tree_leaves(grads))
        assert np.isfinite(gn) and gn > 0, arch
