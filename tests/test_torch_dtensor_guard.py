"""The three published cells whose DTensor rules a torch release refuses
(torch 2.11 on an H100 machine, where the dry-run recorded these
operations) trace through the port's local rules instead, on both
production meshes over the ``fake`` backend (tests/torch_mesh_worker.py's
``dryrun`` job; the LM cell at 1 and 2 layers, as the dry-run traces it):

- ``mind:train_batch``: no ``aten.index_select`` or ``aten.index_add``
  receives a DTensor (2.11's ``index_add`` decomposition of the row-sharded
  table's lookup gradient raised; ``dist.sharding.LocalTake``);
- ``nequip:ogb_products``: no ``aten.stack`` receives a DTensor (2.11's
  rule stacked the (E,) edge DTensors of the l=2 harmonics as
  ``Shard(1)``, a local block of the wrong shape;
  ``dist.sharding.local_edge_map``);
- ``moonshot-v1-16b-a3b:decode_32k``: no view merges a sharded dim into
  the one before it (2.11 refused the decode products' flatten of the
  batch and the 16 sharded heads; ``dist.sharding.local_decode``).

The guard is a ``TorchDispatchMode`` that raises on those operations
(``torch_mesh_worker.DTensorGuard``), so the test bites on a release that
accepts DTensor's own rules. Each cell's record is "ok", and its bytes a
device are the JAX package's shard sizes: the arguments' from the JAX
cell's shardings on ``AbstractMesh``, the outputs' the new state's (train)
or the cache's and the logits' (decode): no table, weight or cache is
replicated to make a cell trace.
"""
import numpy as np
import pytest

from repro_torch.configs import base as t_cfgs
from test_torch_cells import jax_cell
from test_torch_sharding import J_MESHES, run_worker

GUARDS = {"mind:train_batch": ["aten.index_select", "aten.index_add"],
          "nequip:ogb_products": ["aten.stack"],
          "moonshot-v1-16b-a3b:decode_32k": ["aten.view", "aten._unsafe_view"]}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    cases = [{"cell": c, "mesh": m, "guard": g} for m in J_MESHES for c, g in GUARDS.items()]
    got = run_worker("dryrun", cases, tmp_path_factory.mktemp("guard"))
    return {(r["arch"] + ":" + r["shape"], r["mesh"]): r for r in got}


def _bytes(args) -> int:
    return sum(int(np.prod(shard)) * np.dtype(dtype).itemsize
               for leaves in args for _, dtype, shard in leaves)


@pytest.mark.parametrize("mesh", list(J_MESHES))
@pytest.mark.parametrize("cell", list(GUARDS))
def test_cell_traces_without_the_refused_dtensor_rules(records, cell, mesh):
    rec = records[(cell, mesh)]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["devices"] == {"single": 256, "multi": 512}[mesh]
    want = jax_cell(J_MESHES[mesh], *cell.split(":"))["args"]
    assert rec["argument_bytes"] == _bytes(want)
    if cell.endswith("decode_32k"):  # the new cache and (B, vocab) float32 logits, batch-sharded
        arch, shape = cell.split(":")
        batch = t_cfgs.LM_SHAPES[shape].global_batch // {"single": 16, "multi": 32}[mesh]
        logits = batch * t_cfgs.get_arch(arch).vocab * 4
        assert rec["output_bytes"] == _bytes(want[1:2]) + logits
    else:  # the new parameters and optimizer state, and the loss
        assert rec["output_bytes"] == _bytes(want[:2]) + 4
