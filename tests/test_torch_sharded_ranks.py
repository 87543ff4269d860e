"""4-rank checks of the mesh layer on the CPU over gloo (spawned ranks, as
tests/torch_dist_worker.py spawns them, over a (2, 2) debug mesh):

- the hand-written backward rules of ``dist.sharding`` (``LocalRows``,
  ``local_segment_sum``, ``LocalSegmentExtreme``) against the same
  functions unsharded and against JAX's segment max and min;
- ``Trainer(mesh=)`` with checkpoints in one directory and injected
  failures: rank 0 alone writes, every rank restores, and the restarted
  fit keeps the bits of a clean one.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as workers
from repro_torch.configs import base as t_cfgs
from repro_torch.train.tree import tree_map
from test_torch_lm_train import LOSS_ATOL, assert_params_close, same_bits
from test_torch_sharded_train import SHAPE, _lm_trainer, make_case


def _nequip_cases(rng, n, e):
    """The reduced NequIP's per-edge work on random edges: its geometry
    (rows out) and one layer's messages (node tables out), each a case of
    ``torch_dist_worker._edge_case``."""
    import functools

    from repro_torch.nn import gnn

    cfg = t_cfgs.reduced(t_cfgs.get_arch("nequip"))
    d = cfg.d_hidden

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))

    ids = torch.from_numpy(rng.integers(0, n, e))
    geometry = {"fn": functools.partial(gnn._nequip_geometry, cfg), "ids": ids,
                "rows": [normal(e, 3), normal(e, 3), torch.from_numpy(rng.random(e) < 0.8)],
                "weights": None, "reduced": False,
                "cotangents": [normal(e, cfg.n_rbf), normal(e, 3), normal(e, 5), None]}
    layer = gnn.nequip_init(torch.Generator().manual_seed(3), cfg)["layers"][0]
    messages = {"fn": functools.partial(gnn._nequip_messages, cfg, n), "ids": ids,
                "rows": [ids, normal(e, d), normal(e, d, 3), normal(e, d, 5), normal(e, cfg.n_rbf),
                         normal(e, 3), normal(e, 5), torch.from_numpy(rng.random(e) < 0.8)],
                "weights": {k: layer[k] for k in gnn.RADIAL}, "reduced": True,
                "cotangents": [normal(n, d), normal(n, d, 3), normal(n, d, 5)]}
    return {"edge_rows": ("edge_map", geometry), "edge_map": ("edge_map", messages)}


def _decode_case(rng, kv):
    b, s, h, hd = 4, 11, 4, 8  # 11 keys: 6 and 5 a device over "model"
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               for shape in ((b, 1, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    return ("decode", {"q": q, "k": k, "v": v, "kv_len": 9})


@pytest.fixture(scope="module")
def rules(tmp_path_factory):
    """One 4-rank run over (2, 2) of every local rule's case, and its
    inputs. 38 edge rows, 37 table rows and 11 keys split unevenly."""
    rng = np.random.default_rng(22)
    n, e, d = 7, 38, 3
    ids = torch.from_numpy(rng.integers(0, n - 1, e))  # segment n - 1 stays empty
    table = torch.from_numpy(rng.standard_normal((n, d), np.float32))
    x = torch.from_numpy(rng.integers(0, 3, (e, d)).astype(np.float32))
    weights = {k: torch.from_numpy(rng.standard_normal(shape, np.float32))
               for k, shape in (("rows", (e, d)), ("segment_sum", (n, d)),
                                ("segment_max", (n, d)), ("segment_min", (n, d)))}
    v = 37
    take = {"table": torch.from_numpy(rng.standard_normal((v, d), np.float32)),
            # ids in [-V - 8, V + 8): negative ones count from the end, 16
            # of the 90 fall outside [-V, V) and give NaN rows
            "ids": torch.from_numpy(rng.integers(-v - 8, v + 8, (6, 5))),
            "weight": torch.from_numpy(rng.standard_normal((6, 5, d), np.float32))}
    more = {"take": ("take", take), **_nequip_cases(rng, n, e),
            "decode": _decode_case(rng, 4), "decode_gqa": _decode_case(rng, 2)}
    got = workers.spawn(workers.local_rule_grads, 4, str(tmp_path_factory.mktemp("rules")),
                        table, x, ids, weights, (2, 2), more)[0]
    return {"n": n, "ids": ids, "table": table, "x": x, "weights": weights, "more": more}, got


def test_local_rules_gradients_on_4_ranks(rules):
    """The hand-written backward rules of ``dist.sharding`` on 4 ranks over
    (2, 2), 38 rows split unevenly: ``LocalRows`` (``nn.gnn._rows``),
    ``local_segment_sum`` (``nn.gnn._seg_sum``) and ``LocalSegmentExtreme``
    (``nn.gnn._seg_extreme``, rows drawn from {0, 1, 2} so that most
    segments tie across devices, some at 0, and one segment empty) against
    the same functions unsharded, and the extremes' gradients against
    ``jax.ops.segment_max``/``segment_min``'s: outputs and gradients to
    1e-6 (float32 sums in another order; a tie's share is 1 / count)."""
    from repro_torch.nn import gnn

    inputs, got = rules
    n, ids, table, x, weights = (inputs[k] for k in ("n", "ids", "table", "x", "weights"))
    plain = {"rows": lambda t: gnn._rows(t, ids),
             "segment_sum": lambda r: gnn._seg_sum(r, ids, n),
             "segment_max": lambda r: gnn._seg_extreme(r, ids, n, "amax"),
             "segment_min": lambda r: gnn._seg_extreme(r, ids, n, "amin")}
    ties = 0
    for name, fn in plain.items():
        arg = (table if name == "rows" else x).clone().requires_grad_(True)
        want = fn(arg)
        (want * weights[name]).sum().backward()
        out, grad = got[name]
        np.testing.assert_allclose(out.numpy(), want.detach().numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(grad.numpy(), arg.grad.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        if name in ("segment_max", "segment_min"):
            hit = (x == want.detach()[ids]).float()
            ties += int((torch.zeros(n, d := x.shape[1]).index_add_(0, ids, hit) > 1).sum())
            seg = jax.ops.segment_max if name == "segment_max" else jax.ops.segment_min

            def jax_loss(v, seg=seg, w=jnp.asarray(weights[name].numpy())):
                out = seg(v, jnp.asarray(ids.numpy()), num_segments=n)
                return (jnp.where(jnp.isfinite(out), out, 0.0) * w).sum()
            np.testing.assert_allclose(grad.numpy(), np.asarray(jax.grad(jax_loss)(
                jnp.asarray(x.numpy()))), rtol=1e-6, atol=1e-6, err_msg=f"{name} against JAX")
    assert ties > 0


def test_take_rule_on_4_ranks(rules):
    """``LocalTake`` (``nn.recsys._take``), the vocab-parallel lookup: a
    37-row table sharded on its rows over both mesh axes, (6, 5) ids over
    "data" with negative and out-of-range ids, against ``lookup_ref``
    unsharded: the same rows and NaN rows, the table's gradient to 1e-6,
    the output in the ids' placements and the gradient in the table's."""
    from repro_torch.kernels.embedding_bag.ref import lookup_ref

    case = rules[0]["more"]["take"][1]
    table = case["table"].clone().requires_grad_(True)
    want = lookup_ref(table, case["ids"])
    (want * case["weight"]).sum().backward()
    out, grad, out_pl, grad_pl = rules[1]["take"]
    assert torch.isnan(want).any() and not torch.isnan(table.grad).any()
    np.testing.assert_allclose(out.numpy(), want.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), table.grad.numpy(), rtol=1e-6, atol=1e-6)
    assert out_pl == "(Shard(dim=0), Replicate())"
    assert grad_pl == "(Shard(dim=0), Shard(dim=0))"


@pytest.mark.parametrize("name", ["edge_rows", "edge_map"])
def test_edge_map_rule_on_4_ranks(rules, name):
    """``local_edge_map`` (``nn.gnn._on_edges``) over 38 edges split
    unevenly, on the reduced NequIP's geometry (rows out) and one layer's
    messages (node tables out, partial sums): outputs and the gradients of
    every float row and of the radial weights against the same function
    unsharded, to 1e-5 (float32 sums over edges in another order)."""
    from repro_torch.train.tree import tree_leaves, tree_map

    case = rules[0]["more"][name][1]
    rows = [r.clone().requires_grad_(r.is_floating_point()) for r in case["rows"]]
    w = tree_map(lambda t: t.clone().requires_grad_(True), case["weights"])
    want = case["fn"](*rows, w)
    sum((o * c).sum() for o, c in zip(want, case["cotangents"]) if c is not None).backward()
    outs, row_grads, w_grads, placements = rules[1][name]
    for i, (a, b) in enumerate(zip(outs, want, strict=True)):
        np.testing.assert_allclose(a.float().numpy(), b.detach().float().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{name} output {i}")
    for i, (a, r) in enumerate(zip(row_grads, rows, strict=True)):
        assert (a is None) == (r.grad is None), (name, i)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), r.grad.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} row {i}")
    leaves = tree_leaves(w)
    assert len(w_grads) == len(leaves) == (0 if name == "edge_rows" else 12)
    for i, (a, x) in enumerate(zip(w_grads, leaves)):
        np.testing.assert_allclose(a.numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} weight {i}")
    pl = "(Partial(sum), Partial(sum))" if name == "edge_map" else "(Shard(dim=0), Shard(dim=0))"
    assert all(p == pl for p in placements), placements


@pytest.mark.parametrize("name", ["decode", "decode_gqa"])
def test_decode_rule_on_4_ranks(rules, name):
    """``local_decode`` (``nn.layers.attention`` of one query a row): q on
    its batch over "data" and its heads over "model", the 11-key cache on
    its batch and its sequence (6 and 5 keys), 9 keys valid, with KV = H
    and with grouped heads, against the attention unsharded to 1e-6: the
    softmax over keys across the two devices that split them."""
    from repro_torch.nn import layers

    case = rules[0]["more"][name][1]
    want = layers.attention(case["q"], case["k"], case["v"], causal=False,
                            kv_len=case["kv_len"])
    out, placements = rules[1][name]
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert placements == "(Shard(dim=0), Shard(dim=2))"


def test_trainer_with_a_mesh_restarts_on_4_ranks(tmp_path):
    """``Trainer(mesh=)`` on 4 ranks over (2, 2) with checkpoints in one
    directory and two injected failures: rank 0 alone writes each
    checkpoint, and every rank restores it; the restarted fit has the
    bits of the clean 4-rank fit, and both are within the LM cell test's
    tolerances of the unsharded fit."""
    from repro_torch.data import pipeline as t_pipe

    case = make_case("minitron-8b")
    shape = t_cfgs.LMShape(*SHAPE)
    clean = _lm_trainer(case)
    want = clean.fit(t_pipe.make_batch_fn("lm", case["tcfg"], shape, seed=5))
    ranks = workers.spawn(workers.lm_trainer_fits, 4, str(tmp_path), case["tcfg"], shape, (2, 2),
                          case["host"], 4, str(tmp_path / "ck"))
    def by_step(history):
        return {h["step"]: h for h in history}

    for r in ranks:
        assert r["restarted"]["restarts"] == 2
        assert by_step(r["restarted"]["history"]) == by_step(r["clean"]["history"]) == by_step(
            ranks[0]["clean"]["history"])
        assert same_bits(r["restarted"]["state"], ranks[0]["clean"]["state"])
    assert sorted(os.listdir(tmp_path / "ck")) == ["LATEST", "step_2", "step_4"]
    got = ranks[0]["clean"]
    assert [h["step"] for h in got["history"]] == [h["step"] for h in clean.history] == [1, 2, 3, 4]
    for a, b in zip(got["history"], clean.history):
        assert abs(a["loss"] - b["loss"]) <= LOSS_ATOL, (a, b)
    assert_params_close(got["state"]["params"], tree_map(lambda x: x.numpy(), want["params"]),
                        lr=1e-3, steps=4)
