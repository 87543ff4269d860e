"""repro_torch.dist (the GRASP partition and the partitioned GIN train step
over torch.distributed) against the JAX package's ``dist.collectives``, on
the CPU over gloo.

- The partition: ``partition_spec_for``'s fields and ``grasp_partition``'s
  arrays equal the JAX package's exactly, on the reference's own cases.
- P = 1 in process: the port's step on a world-size-1 gloo group against
  the JAX step with ``overlap=False`` on a one-device mesh, 3 steps, the
  loss and every parameter and moment to GIN's tolerance of
  tests/test_torch_gnn.py (rtol = atol = 1e-5). The JAX package's own
  pipelined schedule is not bit-exact against its sequential one on this
  JAX (tests/test_dist_collectives.py::test_pipelined_step_*), so the
  port is held to ``overlap=False`` and to the unpartitioned model.
- P = 4 over gloo in spawned ranks: the loss against the JAX package's
  unpartitioned ``_gnn_loss`` on the same weights to 1e-6 relative, the
  parameters after one step against ``jax.value_and_grad`` + AdamW to
  1e-5, every rank holding the same parameters.
- Both schedules of the port (``overlap`` True and False) bit for bit, at
  P = 1 and P = 4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dist  # noqa: F401  (jax.set_mesh and jax.shard_map on this JAX)
import torch_dist_worker as workers
from repro.configs import base as j_cfgs
from repro.core.reorder import reorder_ranks as j_reorder
from repro.dist import collectives as j_coll
from repro.graph import generate as j_gen
from repro.graph.csr import apply_reorder as j_apply, from_edges as j_from_edges
from repro.launch import steps as j_steps
from repro.launch.mesh import make_debug_mesh
from repro.nn import gnn as j_gnn
from repro.train import optimizer as j_opt
from repro_torch import convert
from repro_torch.configs import base as t_cfgs
from repro_torch.core.reorder import reorder_ranks as t_reorder
from repro_torch.dist import collectives as t_coll
from repro_torch.graph import generate as t_gen
from repro_torch.graph.csr import apply_reorder as t_apply, from_edges as t_from_edges
from repro_torch.launch import steps as t_steps
from repro_torch.nn import gnn as t_gnn
from repro_torch.train import optimizer as t_opt
from repro_torch.train.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)   # GIN's, tests/test_torch_gnn.py


def graph_pair(kind, *args):
    """The same graph from both packages: ``rmat``/``uniform`` (DBG-ordered
    for ``rmat``, as the reference's tests order it) or random edges."""
    if kind == "edges":
        n, m, seed = args
        rng = np.random.default_rng(seed)
        src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
        return j_from_edges(src, dst, n), t_from_edges(src, dst, n)
    scale, degree, seed = args
    jg = getattr(j_gen, kind)(scale, degree, seed=seed)
    tg = getattr(t_gen, kind)(scale, degree, seed=seed)
    if kind == "rmat":
        jg, tg = j_apply(jg, j_reorder(jg, "dbg")), t_apply(tg, t_reorder(tg, "dbg"))
    np.testing.assert_array_equal(jg.indices, tg.indices)
    return jg, tg


# (graph, P, spec keywords): tests/test_dist_collectives.py:13-52 and
# tests/test_dist_partition_edges.py, then hot prefixes sized from a budget
PARTITIONS = {
    "generous caps": (("rmat", 8, 6, 1), 4, dict(hot=64, pub_frac=1.0, edge_slack=3.0)),
    "halo bounded by skew": (("rmat", 10, 10, 2), 8,
                             dict(hot=1024 // 8, pub_frac=1.0, edge_slack=3.0)),
    "no skew, hot 0": (("uniform", 8, 4, 3), 4, dict(hot=0, pub_frac=1.0, edge_slack=4.0)),
    "single device": (("rmat", 7, 5, 4), 1, dict(hot=32, pub_frac=0.01, edge_slack=1.0)),
    "pads a node count P does not divide": (("edges", 1013, 6000, 0), 8,
                                            dict(hot=64, pub_frac=1.0, edge_slack=4.0)),
    "tight caps": (("rmat", 8, 8, 5), 4, dict(hot=32, pub_frac=0.05, edge_slack=0.5)),
    "budget-sized hot prefix": (("rmat", 9, 8, 6), 4, dict(hot_budget_bytes=4096, elem_bytes=40)),
    "default budget, default caps": (("rmat", 8, 6, 7), 3, dict()),
}


@pytest.mark.parametrize("case", sorted(PARTITIONS))
def test_partition_matches_jax_exactly(case):
    (kind, *args), P, kw = PARTITIONS[case]
    jg, tg = graph_pair(kind, *args)
    j_spec = j_coll.partition_spec_for(jg.num_nodes, jg.num_edges, P, **kw)
    t_spec = t_coll.partition_spec_for(tg.num_nodes, tg.num_edges, P, **kw)
    assert dataclasses.asdict(t_spec) == dataclasses.asdict(j_spec)
    want, got = j_coll.grasp_partition(jg, j_spec), t_coll.grasp_partition(tg, t_spec)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    # the reference's invariants, on the port's arrays
    kept = got["esrc"][got["emask"]]
    assert (kept >= 0).all() and (kept < t_spec.table_len).all()
    assert (got["edst"][got["emask"]] < t_spec.n_own).all()
    assert got["dropped"] == tg.num_edges - int(got["emask"].sum())
    assert int((got["pub"] > 0).sum()) <= P * t_spec.c_pub
    if case == "tight caps":
        assert got["dropped"] > 0
    elif case not in ("budget-sized hot prefix", "default budget, default caps"):
        assert got["dropped"] == 0


@pytest.mark.parametrize("P", [1, 4, 8])
def test_cell_spec_matches_jax(P):
    """The GRASP cell's spec at ogb_products (HOT_REPLICA_BUDGET_BYTES over
    100 float32 features a row)."""
    shape = t_cfgs.GNN_SHAPES["ogb_products"]
    assert t_coll.HOT_REPLICA_BUDGET_BYTES == j_coll.HOT_REPLICA_BUDGET_BYTES
    kw = dict(hot_budget_bytes=t_coll.HOT_REPLICA_BUDGET_BYTES, elem_bytes=shape.d_feat * 4)
    assert dataclasses.asdict(t_coll.partition_spec_for(shape.n_nodes, shape.n_edges, P, **kw)) \
        == dataclasses.asdict(j_coll.partition_spec_for(shape.n_nodes, shape.n_edges, P, **kw))
    with pytest.raises(ValueError):
        t_coll.partition_spec_for(10, 10, 0)


def make_case(graph, P, spec_kw, cfg_kw, d_feat, n_classes, seed=0):
    """Both packages' spec, the JAX-layout batch (numpy) and the JAX
    parameters, from one numpy seed."""
    jg, tg = graph_pair(*graph)
    j_spec = j_coll.partition_spec_for(jg.num_nodes, jg.num_edges, P, **spec_kw)
    t_spec = t_coll.partition_spec_for(tg.num_nodes, tg.num_edges, P, **spec_kw)
    part = t_coll.grasp_partition(tg, t_spec)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t_spec.num_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, t_spec.num_nodes).astype(np.int32)
    cfg = j_cfgs.GNNConfig(name="t", kind="gin", **cfg_kw)
    params = jax.tree_util.tree_map(
        np.asarray, j_gnn.init(jax.random.PRNGKey(seed), cfg, d_feat=d_feat))
    return dict(jg=jg, j_spec=j_spec, t_spec=t_spec, part=part, x=x, labels=labels, cfg=cfg,
                params=params, batch=t_coll.grasp_batch(x, labels, part, t_spec))


def jax_steps(s, n_steps):
    """The JAX package's GRASP step on a one-device mesh: each step's loss,
    and the final parameters and optimizer state."""
    mesh = make_debug_mesh(1, 1)
    opt_init, opt_update = j_opt.make(j_opt.OptConfig(lr=1e-3))
    step, _ = j_coll.make_grasp_gin_step(s["j_spec"], s["cfg"], s["x"].shape[1], 5, mesh,
                                         opt_update, overlap=False)
    p, o = s["params"], opt_init(s["params"])
    losses = []
    with jax.set_mesh(mesh):
        jstep = jax.jit(step)
        for _ in range(n_steps):
            p, o, m = jstep(p, o, {k: jnp.asarray(v) for k, v in s["batch"].items()})
            losses.append(float(m["loss"]))
    return losses, p, o


P1_CASES = {
    "generous caps": dict(hot=32, pub_frac=1.0, edge_slack=3.0),
    "tight caps": dict(hot=32, pub_frac=0.05, edge_slack=0.5),
}


@pytest.fixture(scope="module")
def p1_runs(tmp_path_factory):
    """Each P = 1 case through the JAX step (``overlap=False``) and through
    the port's step in both schedules on one world-size-1 gloo group."""
    runs = {}
    with workers.gloo_group(str(tmp_path_factory.mktemp("p1"))):
        for case, kw in P1_CASES.items():
            s = make_case(("rmat", 7, 5, 4), 1, kw, dict(n_layers=3, d_hidden=8), 6, 4)
            port = {}
            for overlap in (False, True):
                t_init, t_update = t_opt.make(t_opt.OptConfig(lr=1e-3))
                p = convert.gnn_params_from_numpy(s["params"], "cpu")
                o = t_init(p)
                step = t_coll.make_grasp_gin_step(s["t_spec"], s["cfg"], 6, 4, None, t_update,
                                                  overlap=overlap, device="cpu")
                block = convert.grasp_batch_from_numpy(s["batch"], 0, "cpu")
                losses = []
                for _ in range(3):
                    p, o, m = step(p, o, block)
                    losses.append(m["loss"])
                port[overlap] = (losses, p, o)
            runs[case] = (s, jax_steps(s, 3), port)
    return runs


@pytest.mark.parametrize("overlap", [False, True], ids=["sequential", "pipelined"])
@pytest.mark.parametrize("case", sorted(P1_CASES))
def test_p1_step_matches_jax_sequential_step(p1_runs, case, overlap):
    s, (j_losses, j_params, j_state), port = p1_runs[case]
    losses, params, state = port[overlap]
    assert (s["part"]["dropped"] > 0) == (case == "tight caps")
    np.testing.assert_allclose([float(v) for v in losses], j_losses, **TOL)
    t_leaves = tree_leaves((params, state))
    j_leaves = jax.tree_util.tree_leaves((j_params, j_state))
    assert len(t_leaves) == len(j_leaves)
    for i, (t, j) in enumerate(zip(t_leaves, j_leaves)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=f"leaf {i}", **TOL)
    assert int(state["step"]) == 3


@pytest.mark.parametrize("case", sorted(P1_CASES))
def test_p1_pipelined_equals_sequential_bit_for_bit(p1_runs, case):
    _, _, port = p1_runs[case]
    for a, b in zip(tree_leaves(port[False]), tree_leaves(port[True])):
        assert torch.equal(a, b)


P4 = dict(graph=("rmat", 8, 6, 0), spec=dict(hot=64, pub_frac=1.0, edge_slack=3.0),
          cfg=dict(n_layers=2, d_hidden=16), d_feat=8, n_classes=5)


@pytest.fixture(scope="module")
def p4_runs(tmp_path_factory):
    """The helper's 4-way case (tests/helpers/grasp_gnn_equivalence.py):
    both schedules, 3 steps, on 4 spawned gloo ranks."""
    s = make_case(P4["graph"], 4, P4["spec"], P4["cfg"], P4["d_feat"], P4["n_classes"])
    t_cfg = t_cfgs.GNNConfig(name="t", kind="gin", **P4["cfg"])
    ranks = workers.spawn(workers.grasp_steps, 4, str(tmp_path_factory.mktemp("p4")),
                          s["t_spec"], t_cfg, s["params"], s["batch"], 3)
    return s, ranks


def jax_unpartitioned(s):
    """The JAX package's unpartitioned GIN loss on the padded graph, and
    one AdamW step of it, on the same weights."""
    jg = s["jg"]
    batch = {"x": jnp.asarray(s["x"]), "src": jnp.asarray(jg.indices.astype(np.int32)),
             "dst": jnp.asarray(jg.dst_ids().astype(np.int32)),
             "emask": jnp.ones(jg.num_edges, bool), "labels": jnp.asarray(s["labels"])}
    loss, grads = jax.value_and_grad(j_steps._gnn_loss)(s["params"], s["cfg"], batch)
    opt_init, opt_update = j_opt.make(j_opt.OptConfig(name="adamw", lr=1e-3))
    new_params, _ = opt_update(grads, opt_init(s["params"]), s["params"])
    return float(loss), new_params


def test_p4_loss_and_step_match_unpartitioned_jax(p4_runs):
    s, ranks = p4_runs
    assert s["part"]["dropped"] == 0 and int((s["part"]["pub"] > 0).sum()) > 0  # a real halo
    want_loss, want_params = jax_unpartitioned(s)
    for overlap in (False, True):
        losses, trail = ranks[0][overlap]
        got = float(losses[0])
        # bit for bit on this input (the helper reports diff=0.00e+00 for JAX's)
        assert abs(got - want_loss) <= 1e-6 * abs(want_loss), (got, want_loss)
        for t, j in zip(tree_leaves(trail[0]), jax.tree_util.tree_leaves(want_params)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    for r in ranks[1:]:  # every rank holds the replicated result
        for overlap in (False, True):
            assert [float(v) for v in r[overlap][0]] == [float(v) for v in ranks[0][overlap][0]]
            for a, b in zip(tree_leaves(r[overlap][1]), tree_leaves(ranks[0][overlap][1])):
                assert torch.equal(a, b)


def test_p4_pipelined_equals_sequential_bit_for_bit(p4_runs):
    _, ranks = p4_runs
    for r in ranks:
        (l_seq, p_seq), (l_pipe, p_pipe) = r[False], r[True]
        assert [float(v) for v in l_seq] == [float(v) for v in l_pipe]
        for a, b in zip(tree_leaves(p_seq), tree_leaves(p_pipe)):
            assert torch.equal(a, b)


def test_grasp_batch_layout_and_rank_blocks():
    """``grasp_batch`` is the reference helper's layout: x_hot the hot
    prefix, x_cold each rank's cold slice, labels in own-table order; a
    rank's block is row ``rank`` of every entry but x_hot."""
    s = make_case(P4["graph"], 4, P4["spec"], P4["cfg"], P4["d_feat"], P4["n_classes"])
    spec, b = s["t_spec"], s["batch"]
    np.testing.assert_array_equal(b["x_hot"], s["x"][:spec.hot])
    for p in range(4):
        hot_ids = np.arange(p * spec.hot_per_dev, (p + 1) * spec.hot_per_dev)
        cold_ids = spec.hot + np.arange(p * spec.cold_per_dev, (p + 1) * spec.cold_per_dev)
        np.testing.assert_array_equal(b["x_cold"][p], s["x"][cold_ids])
        np.testing.assert_array_equal(b["labels"][p],
                                      s["labels"][np.concatenate([hot_ids, cold_ids])])
        block = convert.grasp_batch_from_numpy(b, p, "cpu")
        assert block["esrc"].dtype == torch.int32 and block["emask"].dtype == torch.bool
        np.testing.assert_array_equal(block["pub"].numpy(), b["pub"][p])
    with pytest.raises(ValueError):
        convert.grasp_batch_from_numpy(b, 4, "cpu")
    with pytest.raises(ValueError):
        t_coll.grasp_batch(s["x"][:-1], s["labels"], s["part"], spec)


def test_step_refuses_wrong_groups_and_blocks(tmp_path):
    """Without a process group the step is not built (nor run); a group of
    another size than the spec's, a non-GIN config or a block of the wrong
    shape is refused."""
    s = make_case(("rmat", 7, 5, 4), 1, P1_CASES["generous caps"], dict(n_layers=2, d_hidden=8),
                  6, 4)
    _, update = t_opt.make(t_opt.OptConfig(lr=1e-3))
    args = (s["t_spec"], s["cfg"], 6, 4, None, update)
    with pytest.raises(RuntimeError, match="process group"):
        t_coll.make_grasp_gin_step(*args, device="cpu")
    with workers.gloo_group(str(tmp_path)):
        step = t_coll.make_grasp_gin_step(*args, device="cpu")
        four = t_coll.partition_spec_for(100, 100, 4)
        with pytest.raises(ValueError, match="4"):
            t_coll.make_grasp_gin_step(four, *args[1:], device="cpu")
        with pytest.raises(ValueError, match="gin"):
            t_coll.make_grasp_gin_step(s["t_spec"], dataclasses.replace(s["cfg"], kind="pna"),
                                       *args[2:], device="cpu")
        params = convert.gnn_params_from_numpy(s["params"], "cpu")
        init, _ = t_opt.make(t_opt.OptConfig(lr=1e-3))
        with pytest.raises(ValueError, match="block"):
            step(params, init(params), {k: v for k, v in s["batch"].items()})  # (P, ...) layout
    with pytest.raises(RuntimeError, match="process group"):
        step(params, init(params), convert.grasp_batch_from_numpy(s["batch"], 0, "cpu"))


def test_gnn_train_step_builds_the_grasp_cell_over_a_group(tmp_path):
    """``gnn_train_step`` on gin + grasp + ogb_products: the cell's spec
    for the group's size (the JAX ``_gnn_grasp_cell``'s), and a step that
    trains on a graph partitioned with it (here a small graph under the
    cell's name and the real d_feat)."""
    gin = t_cfgs.get_arch("gin-tu")
    products = t_cfgs.GNN_SHAPES["ogb_products"]
    with workers.gloo_group(str(tmp_path)):
        opt_init, step, spec = t_steps.gnn_train_step(gin, products, device="cpu")
        want = j_coll.partition_spec_for(products.n_nodes, products.n_edges, 1,
                                         hot_budget_bytes=j_coll.HOT_REPLICA_BUDGET_BYTES,
                                         elem_bytes=products.d_feat * 4)
        assert dataclasses.asdict(spec) == dataclasses.asdict(want)
        _, tg = graph_pair("rmat", 8, 6, 1)
        small = dataclasses.replace(products, n_nodes=tg.num_nodes, n_edges=tg.num_edges)
        opt_init, step, spec = t_steps.gnn_train_step(
            dataclasses.replace(gin, n_layers=2), small, device="cpu")
        assert spec.hot == tg.num_nodes  # 64 MiB of 400-byte rows covers this graph
        part = t_coll.grasp_partition(tg, spec)
        rng = np.random.default_rng(3)
        x = rng.standard_normal((spec.num_nodes, products.d_feat)).astype(np.float32)
        labels = rng.integers(0, gin.d_out, spec.num_nodes).astype(np.int32)
        block = convert.grasp_batch_from_numpy(t_coll.grasp_batch(x, labels, part, spec), 0, "cpu")
        params = t_gnn.init(torch.Generator().manual_seed(0), dataclasses.replace(gin, n_layers=2),
                          products.d_feat, device="cpu")
        state = opt_init(params)
        first = None
        for _ in range(3):
            params, state, m = step(params, state, block)
            first = float(m["loss"]) if first is None else first
        assert np.isfinite(first) and float(m["loss"]) < first
