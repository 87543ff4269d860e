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
