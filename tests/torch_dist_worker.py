"""Process groups for the port's distributed CPU tests
(tests/test_torch_dist.py, tests/test_torch_compression.py).

``gloo_group`` opens a group in the calling process; ``spawn`` runs one of
the rank functions below in ``world`` spawned processes over gloo, each
writing its results to ``<out_dir>/<name>_<rank>.pt``. The rank functions
import only the port (no jax, no repro), and the groups meet through a
``file://`` store under the test's temporary directory, so xdist workers
never contend for a port.
"""
import contextlib
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@contextlib.contextmanager
def gloo_group(store_dir, rank=0, world=1):
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(store_dir, 'store')}",
                            rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def spawn(fn, world, out_dir, *args):
    """Run ``fn(rank, world, out_dir, *args)`` on ``world`` spawned ranks;
    raises if any rank fails. Returns each rank's saved results."""
    os.makedirs(os.path.join(out_dir, "store_dir"), exist_ok=True)
    mp.spawn(fn, args=(world, out_dir) + args, nprocs=world, join=True)
    return [torch.load(os.path.join(out_dir, f"{fn.__name__}_{r}.pt")) for r in range(world)]


def _save(out_dir, name, rank, result):
    torch.save(result, os.path.join(out_dir, f"{name}_{rank}.pt"))


@contextlib.contextmanager
def recording_grads():
    """Steps built inside keep, at each optimizer update, the whole
    gradients they hand it (a DTensor leaf gathered with ``full_tensor``,
    a tensor copied): yields the list they are appended to, one tree a
    step. It wraps ``train.optimizer.make``, which the steps of
    ``launch.steps`` call when they are built."""
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.tree import tree_map

    make, kept = opt_mod.make, []

    def whole(g):
        return g.full_tensor() if hasattr(g, "full_tensor") else g.detach().clone()

    def recording_make(cfg):
        init, update = make(cfg)

        def update_recording(grads, state, params, donate=False):
            kept.append(tree_map(whole, grads))
            return update(grads, state, params, donate=donate)
        return init, update_recording

    opt_mod.make = recording_make
    try:
        yield kept
    finally:
        opt_mod.make = make


def grasp_steps(rank, world, out_dir, spec, cfg, params, batch, steps):
    """The GRASP GIN step with both schedules from the same parameters on
    this rank's block of ``batch`` (the JAX package's layout): each step's
    loss and the parameters after every step."""
    from repro_torch import convert
    from repro_torch.dist import collectives as coll
    from repro_torch.train import optimizer

    torch.set_num_threads(1)
    with gloo_group(os.path.join(out_dir, "store_dir"), rank, world):
        block = convert.grasp_batch_from_numpy(batch, rank, "cpu")
        out = {}
        for overlap in (False, True):
            opt_init, opt_update = optimizer.make(optimizer.OptConfig(name="adamw", lr=1e-3))
            p = convert.gnn_params_from_numpy(params, "cpu")
            s = opt_init(p)
            step = coll.make_grasp_gin_step(spec, cfg, block["x_hot"].shape[1], cfg.d_out, None,
                                            opt_update, overlap=overlap, device="cpu")
            losses, trail = [], []
            for _ in range(steps):
                p, s, m = step(p, s, block)
                losses.append(m["loss"])
                trail.append(p)
            out[overlap] = (losses, trail)
    _save(out_dir, "grasp_steps", rank, out)


def compressed_psums(rank, world, out_dir, grads_by_rank, rounds):
    """``compressed_psum`` of this rank's gradients, ``rounds`` times with
    the error carried: each round's mean and new error."""
    from repro_torch.train import compression
    from repro_torch.train.tree import tree_map

    torch.set_num_threads(1)
    with gloo_group(os.path.join(out_dir, "store_dir"), rank, world):
        grads = tree_map(torch.as_tensor, grads_by_rank[rank])
        err = compression.init_error(grads)
        out = []
        for _ in range(rounds):
            mean, err = compression.compressed_psum(grads, err)
            out.append((mean, err))
    _save(out_dir, "compressed_psums", rank, out)


def lm_cell_steps(rank, world, out_dir, cfg, shape, mesh_shape, params, batches):
    """The LM train cell (``launch.steps._lm_train_cell``) on a
    ``mesh_shape`` debug mesh of this group, from the parameters
    ``params`` (the JAX package's, as numpy) and the optimizer's zeros:
    one step a batch. Each step's loss and the whole parameters and
    optimizer state after the last step (gathered from every rank's
    shards), with the whole gradients each step handed its optimizer."""
    from repro_torch import convert
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train.tree import tree_map

    torch.set_num_threads(1)
    with gloo_group(os.path.join(out_dir, "store_dir"), rank, world):
        mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
        with recording_grads() as grads:
            cell = steps._lm_train_cell(cfg, shape, mesh)
        opt_init = steps.lm_train_step(cfg, shape, device="cpu")[0]
        p = shd.place(convert.lm_params_from_numpy(params, "cpu"), cell.in_shardings[0])
        s = shd.place(opt_init(convert.lm_params_from_numpy(params, "cpu")), cell.in_shardings[1])
        losses = []
        for b in batches:
            p, s, m = cell.step_fn(p, s, shd.place(b, cell.in_shardings[2]))
            losses.append(m["loss"].full_tensor())
        whole = tree_map(lambda x: x.full_tensor(), {"params": p, "opt": s})
        placements = [repr(x.placements) for x in tree_leaves_of(p)]
    _save(out_dir, "lm_cell_steps", rank, {"losses": losses, **whole, "placements": placements,
                                           "grads": grads})


def recsys_cell_steps(rank, world, out_dir, cfg, shape, mesh_shape, params, batches):
    """The MIND train cell (``launch.steps._recsys_cell``: the item table
    sharded on its rows over every mesh axis, the batch over "data") on a
    ``mesh_shape`` debug mesh of this group, from ``params`` and AdamW's
    zeros: one step a batch. Each step's loss, the whole gradients each
    step handed its optimizer, the whole parameters after the last step
    and the table's placements."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train.tree import tree_map

    torch.set_num_threads(1)
    with gloo_group(os.path.join(out_dir, "store_dir"), rank, world):
        mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
        with recording_grads() as grads:
            cell = steps._recsys_cell(cfg, shape, mesh)
        # a copy: spawned ranks share the caller's tensors, and the step
        # updates replicated leaves in place
        params = tree_map(torch.clone, params)
        p = shd.place(params, cell.in_shardings[0])
        s = shd.place(steps._adamw()[0](params), cell.in_shardings[1])
        losses = []
        for b in batches:
            p, s, m = cell.step_fn(p, s, shd.place(b, cell.in_shardings[2]))
            losses.append(m["loss"].full_tensor())
        out = {"losses": losses, "grads": grads, "placements": repr(p["items"].placements),
               "params": tree_map(lambda x: x.full_tensor(), p)}
    _save(out_dir, "recsys_cell_steps", rank, out)


def tree_leaves_of(tree):
    from repro_torch.train.tree import tree_leaves

    return tree_leaves(tree)


def gnn_cell_steps(rank, world, out_dir, cases, mesh_shape):
    """One step of each GNN train cell (``launch.steps._gnn_train_cell``) on
    a ``mesh_shape`` debug mesh of this group: ``cases`` maps a name to
    ``(cfg, shape, params, batch)`` (the JAX package's parameters and
    batch, as numpy). The loss, the whole gradients handed the optimizer
    and the whole new parameters of each."""
    from repro_torch import convert
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.train.tree import tree_map

    torch.set_num_threads(1)
    out = {}
    with gloo_group(os.path.join(out_dir, "store_dir"), rank, world):
        mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
        for name, (cfg, shape, params, batch) in cases.items():
            with recording_grads() as grads:
                cell = steps._gnn_train_cell(cfg, shape, mesh)
            p = convert.gnn_params_from_numpy(params, "cpu")
            s = steps._adamw()[0](p)
            p, s, m = cell.step_fn(shd.place(p, cell.in_shardings[0]),
                                   shd.place(s, cell.in_shardings[1]),
                                   shd.place(batch, cell.in_shardings[2]))
            out[name] = {"loss": m["loss"].full_tensor(), "grads": grads[0],
                         "params": tree_map(lambda x: x.full_tensor(), p)}
    _save(out_dir, "gnn_cell_steps", rank, out)


def lm_serving_cells(rank, world, out_dir, cfg, batch, seq, length, mesh_shape, seed):
    """The LM prefill and decode cells on a ``mesh_shape`` debug mesh of
    this group, with bfloat16 parameters from ``tfm.init(seed)``: the
    prefill cell on ``length`` prompt tokens, then one step of the decode
    cell on a cache of ``seq`` positions holding that prefill (the cache
    sharded on its sequence axis over "model"). The whole logits and
    caches, and the same through ``tfm.prefill`` / ``tfm.decode_step``
    unsharded."""
    import numpy as np

    from repro_torch.configs.base import LMShape
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.nn import transformer as tfm
    from repro_torch.train.tree import tree_map

    torch.set_num_threads(1)
    with gloo_group(os.path.join(out_dir, "store_dir"), rank, world):
        mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
        params = tree_map(lambda t: t.to(torch.bfloat16),
                          tfm.init(torch.Generator().manual_seed(seed), cfg, device="cpu"))
        rng = np.random.default_rng(seed)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, length)).astype(np.int32))
        token = torch.from_numpy(rng.integers(0, cfg.vocab, (batch,)).astype(np.int32))
        pc = steps._lm_prefill_cell(cfg, LMShape("p", "prefill", length, batch), mesh)
        dc = steps._lm_decode_cell(cfg, LMShape("d", "decode", seq, batch), mesh)
        plg, pcache = pc.step_fn(shd.place(params, pc.in_shardings[0]),
                                 shd.place(tokens, pc.in_shardings[1]))
        want_plg, want_cache = tfm.prefill(params, cfg, tokens, max_len=seq)
        cache = tfm.KVCache(k=want_cache.k.clone(), v=want_cache.v.clone(),
                            length=torch.tensor(length, dtype=torch.int32))
        dlg, dcache = dc.step_fn(shd.place(params, dc.in_shardings[0]),
                                 shd.place(cache, dc.in_shardings[1]),
                                 shd.place(token, dc.in_shardings[2]))
        want_dlg, want_dcache = tfm.decode_step(params, cfg, want_cache, token)
        out = {"prefill": (plg.full_tensor(), pcache.k.full_tensor(), pcache.v.full_tensor()),
               "decode": (dlg.full_tensor(), dcache.k.full_tensor(), dcache.v.full_tensor(),
                          int(dcache.length)),
               "cache_placements": repr(dcache.k.placements),
               "want_prefill": (want_plg, want_cache.k[:, :, :length], want_cache.v[:, :, :length]),
               "want_decode": (want_dlg, want_dcache.k, want_dcache.v, want_dcache.length)}
    _save(out_dir, "lm_serving_cells", rank, out)


def local_rule_grads(rank, world, out_dir, table, x, ids, weights, mesh_shape, more):
    """``dist.sharding``'s local rules on a ``mesh_shape`` debug mesh, with
    the (E,) ids sharded on their rows over every mesh axis, as a GNN
    cell's edges: ``nn.gnn``'s row gather of the replicated (n, d)
    ``table`` by ``ids``, and its segment sum, max and min of the (E, d)
    rows ``x`` (placed as the ids) into n segments. For each, the whole
    output and the whole gradient of ``(out * weights[name]).sum()``.
    Then each case ``name: (kind, arguments)`` of ``more``, run by
    ``local_rule_cases[kind]``: the outputs and gradients it returns."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.nn import gnn

    torch.set_num_threads(1)
    n = table.shape[0]
    rules = {"rows": lambda t, i: gnn._rows(t, i),
             "segment_sum": lambda r, i: gnn._seg_sum(r, i, n),
             "segment_max": lambda r, i: gnn._seg_extreme(r, i, n, "amax"),
             "segment_min": lambda r, i: gnn._seg_extreme(r, i, n, "amin")}
    out = {}
    with gloo_group(os.path.join(out_dir, "store_dir"), rank, world):
        mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
        edges = shd.ns(mesh, tuple(mesh.mesh_dim_names))
        with shd.on_mesh(mesh):
            for name, rule in rules.items():
                src = table if name == "rows" else x
                arg = shd.place(src.clone(), edges if name != "rows" else shd.ns(mesh))
                arg.requires_grad_(True)
                got = shd.redistribute(rule(arg, shd.place(ids, edges)), shd.ns(mesh))
                (got * shd.place(weights[name], shd.ns(mesh))).sum().backward()
                out[name] = (got.full_tensor().detach(), arg.grad.full_tensor())
            for name, (kind, case) in more.items():
                out[name] = local_rule_cases[kind](mesh, **case)
    _save(out_dir, "local_rule_grads", rank, out)


def _take_case(mesh, table, ids, weight):
    """``nn.recsys._take`` (``LocalTake``): the (V, d) table sharded on its
    rows over every mesh axis, the ids on their rows over "data"; the
    output and the table's gradient of ``(out * weight).sum()``."""
    from repro_torch.dist import sharding as shd
    from repro_torch.nn import recsys

    t = shd.place(table.clone(), shd.ns(mesh, tuple(mesh.mesh_dim_names), None))
    t.requires_grad_(True)
    got = recsys._take(t, shd.place(ids, shd.ns(mesh, "data", None)))
    placements = repr(got.placements)
    got = shd.redistribute(got, shd.ns(mesh))
    (got * shd.place(weight, shd.ns(mesh))).sum().backward()
    return got.full_tensor().detach(), t.grad.full_tensor(), placements, repr(t.grad.placements)


def _edge_case(mesh, fn, ids, rows, weights, reduced, cotangents):
    """``nn.gnn._on_edges(fn, ...)`` over ``ids`` sharded on their rows over
    every mesh axis, the (E, ...) ``rows`` placed as the ids and the weight
    tree replicated; the whole outputs and the whole gradients of
    ``sum(out * cotangent)`` (a None cotangent: that output left out) for
    the rows and the weights, and the outputs' placements."""
    from repro_torch.dist import sharding as shd
    from repro_torch.nn import gnn
    from repro_torch.train.tree import tree_leaves, tree_map

    edges = shd.ns(mesh, tuple(mesh.mesh_dim_names))
    placed = [shd.place(r.clone(), edges).requires_grad_(r.is_floating_point()) for r in rows]
    w = tree_map(lambda t: shd.place(t.clone(), shd.ns(mesh)).requires_grad_(True), weights)
    outs = gnn._on_edges(fn, shd.place(ids, edges), placed, w, reduced=reduced)
    whole = [shd.redistribute(o, shd.ns(mesh)) for o in outs]
    sum((o * shd.place(c, shd.ns(mesh))).sum() for o, c in zip(whole, cotangents)
        if c is not None).backward()
    return ([o.full_tensor().detach() for o in whole],
            [r.grad.full_tensor() if r.grad is not None else None for r in placed],
            [x.grad.full_tensor() for x in tree_leaves(w)], [repr(o.placements) for o in outs])


def _decode_case(mesh, q, k, v, kv_len):
    """``nn.layers.attention`` of one query a row: q sharded on its batch
    over "data" and its heads over "model", the (B, S, KV, hd) cache on
    its batch over "data" and its sequence over "model"; the whole
    output."""
    from repro_torch.dist import sharding as shd
    from repro_torch.nn import layers

    cache = shd.ns(mesh, "data", "model", None, None)
    out = layers.attention(shd.place(q, shd.ns(mesh, "data", None, "model", None)),
                           shd.place(k, cache), shd.place(v, cache), causal=False,
                           kv_len=kv_len)
    return out.full_tensor(), repr(out.placements)


local_rule_cases = {"take": _take_case, "edge_map": _edge_case, "decode": _decode_case}


def lm_trainer_fits(rank, world, out_dir, cfg, shape, mesh_shape, params, steps, ckpt_dir):
    """``Trainer(mesh=, in_shardings=, out_shardings=)`` with the LM train
    cell's shardings on a ``mesh_shape`` debug mesh of this group, from the
    parameters ``params`` (numpy), 2 microbatches, ``steps`` steps of the
    port's seeded LM batches: a clean fit, then a fit that checkpoints every
    2 steps into ``ckpt_dir`` (shared by the ranks) with failures injected
    at steps 1 and 3. Each fit's history and whole final state, and the
    restarts of the second."""
    from repro_torch import convert
    from repro_torch.data import pipeline
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.nn import transformer as tfm
    from repro_torch.train import ft, optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.train.tree import tree_map

    torch.set_num_threads(1)
    out = {}
    with gloo_group(os.path.join(out_dir, "store_dir"), rank, world):
        mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
        cell = steps_mod._lm_train_cell(cfg, shape, mesh)
        batch_fn = pipeline.make_batch_fn("lm", cfg, shape, seed=5)
        for name, ckpt, injector in (("clean", None, None),
                                     ("restarted", ckpt_dir, ft.FailureInjector(fail_at=(1, 3)))):
            tr = Trainer(lambda p, b: tfm.loss_fn(p, cfg, b),
                         lambda: convert.lm_params_from_numpy(params, "cpu"),
                         optimizer.OptConfig(name="adamw", lr=1e-3),
                         TrainerConfig(num_steps=steps, microbatches=2, log_every=1,
                                       ckpt_dir=ckpt, ckpt_every=2), device="cpu", mesh=mesh,
                         in_shardings=cell.in_shardings,
                         out_shardings=(cell.out_shardings[0], cell.out_shardings[1],
                                        shd.ns(mesh)))
            state = tr.fit(batch_fn, injector=injector)
            out[name] = {"history": tr.history, "restarts": tr.restarts,
                         "state": tree_map(lambda x: x.full_tensor(), state)}
    _save(out_dir, "lm_trainer_fits", rank, out)
