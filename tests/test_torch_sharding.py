"""repro_torch.dist.sharding (the sharding vocabulary as DTensor
placements) and repro_torch.launch.mesh against the JAX package's.

- Every spec tree of the vocabulary equals the JAX package's, entry tuple
  for entry tuple: ``lm_param_spec`` for the five LM archs (fsdp on and
  off), ``opt_state_spec`` for sgd, adamw and adafactor, ``recsys_param_spec``
  with GRASP on and off, and the batch specs on both production meshes.
- ``ns`` and ``constrain`` filter axes as the JAX package's
  ``_filter_entry`` and ``constrain`` do (absent axis names dropped, an
  entry whose mesh size does not divide its dimension dropped), on
  ``AbstractMesh`` there and the port's meshes over the ``fake`` backend
  here; the placements a spec implies are ``Shard(d)`` on each mesh dim an
  entry names, ``Replicate()`` elsewhere.

The port's meshes live in a subprocess (tests/torch_mesh_worker.py): the
``fake`` group is its own, never a pytest worker's.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as JP

from repro.configs import base as j_cfgs
from repro.dist import sharding as j_shd
from repro_torch.configs import base as t_cfgs
from repro_torch.dist import sharding as t_shd

LM_ARCHS = ["minitron-8b", "starcoder2-7b", "phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b",
            "nemotron-4-340b"]
WORKER = os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py")
J_MESHES = {"single": AbstractMesh((16, 16), ("data", "model")),
            "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def run_worker(job, arg, tmp_path):
    src, dst = tmp_path / f"{job}_in.json", tmp_path / f"{job}_out.json"
    src.write_text(json.dumps(arg))
    r = subprocess.run([sys.executable, WORKER, job, str(src), str(dst)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(dst.read_text())


def plain(tree):
    """A spec tree with each spec (either package's) as a list of entries,
    each entry a list of names, a name or None (JSON's view of a tuple)."""
    if isinstance(tree, (JP, t_shd.PartitionSpec)):
        return [list(e) if isinstance(e, tuple) else e for e in tree]
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [plain(v) for v in tree]
    return tree


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_spec_matches_jax(arch, fsdp):
    got = t_shd.lm_param_spec(t_cfgs.get_arch(arch), fsdp=fsdp)
    want = j_shd.lm_param_spec(j_cfgs.get_arch(arch), fsdp=fsdp)
    assert plain(got) == plain(want)
    assert all(isinstance(s, t_shd.PartitionSpec) for s in (got["embed"], got["ln_f"]))


@pytest.mark.parametrize("opt", ["sgd", "adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["minitron-8b", "nemotron-4-340b"])
def test_opt_state_spec_matches_jax(arch, opt):
    got = t_shd.opt_state_spec(t_shd.lm_param_spec(t_cfgs.get_arch(arch)), opt)
    want = j_shd.opt_state_spec(j_shd.lm_param_spec(j_cfgs.get_arch(arch)), opt)
    assert plain(got) == plain(want)
    with pytest.raises(ValueError, match="unknown optimizer"):
        t_shd.opt_state_spec(got, "lion")


@pytest.mark.parametrize("grasp", [True, False])
def test_recsys_param_spec_matches_jax(grasp):
    got = t_shd.recsys_param_spec(t_cfgs.get_arch("mind"), grasp=grasp)
    want = j_shd.recsys_param_spec(j_cfgs.get_arch("mind"), grasp=grasp)
    assert plain(got) == plain(want)


def test_batch_specs_match_jax_on_both_meshes(tmp_path):
    got = run_worker("specs", None, tmp_path)
    for name, mesh in J_MESHES.items():
        want = {
            "batch_axes": list(j_shd.batch_axes(mesh)),
            "lm_batch": plain(j_shd.lm_batch_spec(mesh)),
            "gnn_batch": {k: plain(j_shd.gnn_batch_spec(mesh, k))
                          for k in ("full_graph", "molecule", "minibatch")},
            "recsys_batch": {k: plain(j_shd.recsys_batch_spec(mesh, k))
                             for k in ("train", "serve", "retrieval")},
        }
        assert got[name] == json.loads(json.dumps(want)), name


ENTRIES = [None, "data", "model", "pod", ("pod", "data"), ("pod", "data", "model"),
           ("data", "model"), ("pod",), ("model",)]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_filter_entry_matches_jax(mesh):
    names = set(J_MESHES[mesh].axis_names)
    for e in ENTRIES:
        assert t_shd._filter_entry(names, e) == j_shd._filter_entry(names, e)


def _jax_constrain_entries(mesh, shape, axes, monkeypatch):
    """The spec the JAX package's ``constrain`` asks for: its
    ``with_sharding_constraint`` call captured."""
    seen = []
    monkeypatch.setattr(j_shd.jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s) or x)
    j_shd.set_active_mesh(mesh)
    try:
        j_shd.constrain(jax.ShapeDtypeStruct(shape, np.float32), *axes)
    finally:
        j_shd.set_active_mesh(None)
    return list(seen[0].spec)


CONSTRAIN_CASES = [
    ((256, 4096), (("pod", "data"), None)),
    ((8, 4096), (("pod", "data"), None)),                 # batch smaller than the data axes
    ((32, 4096, 48, 128), (("pod", "data"), None, "model", None)),
    ((32, 4096, 8, 128), (("pod", "data"), None, "model", None)),  # 8 heads on 16 ways
    ((4, 512, 4096), (("pod", "data"), "model", None)),
    ((1024,), (("pod", "data", "model"),)),
    ((1000,), (("pod", "data", "model"),)),
    ((64, 64), ("absent", "model")),
    ((64, 64, 3), (None, None)),
]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_ns_and_constrain_filter_as_jax(mesh, tmp_path, monkeypatch):
    cases = [{"mesh": mesh, "shape": list(shape), "axes": list(axes),
              "entries": _jax_constrain_entries(J_MESHES[mesh], shape, axes, monkeypatch)}
             for shape, axes in CONSTRAIN_CASES]
    got = run_worker("constrain", json.loads(json.dumps(cases)), tmp_path)
    names = set(J_MESHES[mesh].axis_names)
    for case, (shape, axes), g in zip(cases, CONSTRAIN_CASES, got):
        assert g["got"] == g["want"], (shape, axes, case["entries"], g)
        ns_want = [j_shd._filter_entry(names, a) for a in axes]
        assert g["ns"] == json.loads(json.dumps(ns_want)), (shape, axes)


def test_placements_of_a_spec():
    """One placement a mesh dim: Shard(d) where dim d's entry names the
    mesh dim, Replicate() elsewhere; an entry out of the mesh's order
    raises (DTensor would shard it in another order than JAX)."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:  # the only things placements read of a mesh
        mesh_dim_names = ("pod", "data", "model")

        def __init__(self, sizes):
            self.sizes = sizes

        def size(self, i):
            return self.sizes[i]

    s = t_shd.NamedSharding(Mesh((2, 4, 4)), t_shd.P(None, ("pod", "data"), "model"))
    assert s.placements == (Shard(1), Shard(1), Shard(2))
    assert s.shard_shape((3, 16, 8)) == (3, 2, 2)
    assert t_shd.NamedSharding(Mesh((2, 4, 4)), t_shd.P()).placements == (Replicate(),) * 3
    # a mesh dim of one device splits nothing: replicated there
    s = t_shd.NamedSharding(Mesh((2, 1, 4)), t_shd.P(None, ("pod", "data"), "model"))
    assert s.placements == (Shard(1), Replicate(), Shard(2))
    with pytest.raises(ValueError, match="mesh's order"):
        t_shd.NamedSharding(Mesh((2, 4, 4)), t_shd.P(("model", "data"))).placements


def test_constrain_is_identity_off_a_mesh():
    import torch

    x = torch.arange(6.0).reshape(2, 3)
    assert t_shd.constrain(x, "data", "model") is x
    t_shd.set_active_mesh(None)
    assert t_shd.constrain(x, ("pod", "data"), None) is x
