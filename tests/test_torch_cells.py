"""repro_torch.launch.steps' cells (``build_cell``, ``all_cells``) against
the JAX package's, on both production meshes.

For each (arch, shape) of ``all_cells()`` on (16, 16) and (2, 16, 16): the
argument trees leaf for leaf in JAX's flatten order, every leaf's global
shape and dtype, ``donate``, and every leaf's local shard shape (the
port's placements on its mesh against ``NamedSharding.shard_shape`` on the
JAX package's ``AbstractMesh``). ``nemotron-4-340b:train_4k`` fails to
build in both packages, with the same ``KeyError: 'g'``: the reference's
``opt_state_spec("adafactor")`` maps the norms' ``P()`` to a
``{"v", "vr", "vc"}`` dict where the value tree holds ``{"g": ...}``.

The port's cells are built in a subprocess over the ``fake`` backend
(tests/torch_mesh_worker.py).
"""
import json

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.launch import steps as j_steps
from repro_torch.launch import steps as t_steps
from test_torch_sharding import J_MESHES, run_worker


@pytest.fixture(scope="module")
def port_cells(tmp_path_factory):
    return run_worker("cells", None, tmp_path_factory.mktemp("cells"))


def jax_cell(mesh: AbstractMesh, arch: str, shape: str):
    try:
        cell = j_steps.build_cell(arch, shape, mesh)
    except Exception as e:  # noqa: BLE001 -- compared with the port's failure
        return {"error": [type(e).__name__, str(e)]}
    args = []
    for a, s in zip(cell.args, cell.in_shardings):
        leaves = jax.tree_util.tree_leaves(a)
        shards = jax.tree_util.tree_structure(a).flatten_up_to(s)
        args.append([[list(x.shape), np.dtype(x.dtype).name, list(sh.shard_shape(x.shape))]
                     for x, sh in zip(leaves, shards)])
    return {"donate": list(cell.donate), "args": args}


def test_all_cells_match_jax():
    assert t_steps.all_cells() == j_steps.all_cells()
    assert len(t_steps.all_cells()) == 40


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_every_cell_matches_jax(mesh, port_cells):
    failed = []
    for arch, shape in j_steps.all_cells():
        got = port_cells[f"{mesh}/{arch}:{shape}"]
        want = jax_cell(J_MESHES[mesh], arch, shape)
        if "error" in want:
            failed.append(f"{arch}:{shape}")
            assert got["error"] == want["error"], (arch, shape)
            continue
        assert got["donate"] == want["donate"], (arch, shape)
        assert len(got["args"]) == len(want["args"]), (arch, shape)
        for i, (g, w) in enumerate(zip(got["args"], want["args"])):
            assert g == w, (arch, shape, i)
    assert failed == ["nemotron-4-340b:train_4k"]


def test_nemotron_train_cell_keyerror_is_the_references(port_cells):
    for mesh in ("single", "multi"):
        assert port_cells[f"{mesh}/nemotron-4-340b:train_4k"]["error"] == ["KeyError", "'g'"]
    with pytest.raises(KeyError, match="'g'"):
        j_steps.build_cell("nemotron-4-340b", "train_4k", J_MESHES["single"])


def test_cells_are_counted_per_family(port_cells):
    """Every LM, GNN and recsys cell builds on both meshes but the one the
    reference cannot build: 39 of 40 a mesh."""
    for mesh in ("single", "multi"):
        ok = [k for k, v in port_cells.items() if k.startswith(mesh + "/") and "error" not in v]
        assert len(ok) == 39
    assert json.dumps(port_cells)  # plain JSON all through
