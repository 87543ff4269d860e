"""Sharding vocabulary for the launch layer, as DTensor placements.

Specs are written as in the JAX package: a ``PartitionSpec`` is a tuple of
per-dimension entries (``None``, a mesh-axis name, or a tuple of names),
over the mesh axes ``"pod"`` and ``"data"`` (batch/fsdp) and ``"model"``
(tensor parallelism), against the *largest* mesh (pod x data x model).
``ns`` turns entries into a ``NamedSharding``: one DTensor placement a mesh
dimension, ``Shard(d)`` on each mesh dimension named in tensor dim ``d``'s
entry and ``Replicate()`` elsewhere. Axis names the concrete mesh lacks
are dropped, so one spec tree serves debug meshes too. The names of one
entry must come in the mesh's major-to-minor order: then DTensor's nested
sharding of one tensor dim (mesh dims left to right) is the JAX package's.

``constrain`` needs an active mesh to do anything: model code
(``nn/transformer.py``) calls it unconditionally, including in
single-process tests with no mesh, so it is identity unless a mesh is
active (``set_active_mesh``, or ``on_mesh`` around a cell's step), and
identity on a tensor that is not a DTensor.

Below the specs: trees of DTensors (``place`` real values by a sharding
tree, ``abstract`` meta ones, ``redistribute``, FSDP's ``gather_fsdp``),
and local rules for what DTensor has no rule for, or one that a torch
release refuses: segment sums, maxima and minima over sharded rows, row
gathers by sharded ids, a lookup in a row-sharded table, per-edge work on
each device's edges, attention on each device's block, decode attention
over a sequence-sharded cache, a write into a sharded KV cache, uneven
splits, stacking, merging a sharded dim with a whole one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

_ACTIVE_MESH: Optional[DeviceMesh] = None


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: a tuple of per-dimension entries,
    normalised as JAX normalises them (a list is a tuple, a one-name tuple
    is the name, an empty one None). A spec is a leaf of a spec tree, not a
    sequence node."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _canonical(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` (its absent axes filtered) on a mesh, with the
    DTensor placements it implies. A mesh dim of one device splits
    nothing, so it is ``Replicate()`` whatever the spec names there (the
    same layout; DTensor refuses to flatten a dim it holds as sharded,
    even one way)."""

    mesh: DeviceMesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        names = self.mesh.mesh_dim_names
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            ax = _axes(entry)
            if [names.index(a) for a in ax] != sorted(names.index(a) for a in ax):
                raise ValueError(f"entry {entry!r} is not in the mesh's order {names}")
            for a in ax:
                if self.mesh.size(names.index(a)) > 1:
                    out[names.index(a)] = Shard(d)
        return tuple(out)

    def shard_shape(self, global_shape) -> tuple:
        """Each device's block of ``global_shape`` (the sizes must divide,
        as the JAX package's ``NamedSharding.shard_shape`` requires)."""
        shape = list(global_shape)
        for d, entry in enumerate(self.spec):
            n = _size(self.mesh, entry)
            if shape[d] % n:
                raise ValueError(f"dimension {d} of {tuple(global_shape)} does not split "
                                 f"{n} ways under {self.spec!r}")
            shape[d] //= n
        return tuple(shape)


def set_active_mesh(mesh: Optional[DeviceMesh]) -> None:
    """Make ``constrain`` redistribute against ``mesh`` (None disables it
    again)."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


@contextlib.contextmanager
def on_mesh(mesh: DeviceMesh):
    """``mesh`` active for ``constrain``, and plain tensors mixed with
    DTensors (positions, masks a step makes itself) read as replicated;
    the previous active mesh comes back on exit."""
    global _ACTIVE_MESH
    prev, _ACTIVE_MESH = _ACTIVE_MESH, mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _ACTIVE_MESH = prev


def batch_axes(mesh: DeviceMesh) -> tuple:
    """The data-parallel axes present on this mesh, outermost first."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _size(mesh: DeviceMesh, entry) -> int:
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) for a in _axes(entry))


def _filter_entry(names, entry):
    """Drop mesh-axis names not present on this mesh from one spec entry."""
    if entry is None:
        return None
    if isinstance(entry, (tuple, list)):
        kept = tuple(a for a in entry if a in names)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return entry if entry in names else None


def ns(mesh: DeviceMesh, *axes) -> NamedSharding:
    """``NamedSharding`` over ``mesh`` from spec entries, filtering absent
    axes. ``ns(mesh)`` is fully replicated; entries may be axis names,
    tuples of axis names, or None, exactly as in a PartitionSpec."""
    names = set(mesh.mesh_dim_names)
    return NamedSharding(mesh, P(*(_filter_entry(names, a) for a in axes)))


def constrain(x, *axes):
    """Redistribute a DTensor to the spec against the active mesh (and its
    gradient back to the same placements); identity with no active mesh or
    on a plain tensor.

    Besides filtering absent axis names, entries whose combined mesh-axis
    size does not divide the corresponding dim of ``x`` are dropped (the
    debug meshes are frequently larger than a smoke-test batch dim)."""
    mesh = _ACTIVE_MESH
    if mesh is None or not isinstance(x, DTensor):
        return x
    names = set(mesh.mesh_dim_names)
    entries = []
    for dim, entry in zip(x.shape, axes):
        entry = _filter_entry(names, entry)
        if entry is not None and dim % _size(mesh, entry) != 0:
            entry = None
        entries.append(entry)
    # redistributed even when the placements already match: the autograd
    # node moves the gradient back to them, as JAX constrains the cotangent
    return x.redistribute(mesh, NamedSharding(mesh, P(*entries)).placements)


def unflatten(x, dim: int, sizes: tuple):
    """``x.unflatten(dim, sizes)``. A DTensor whose dim ``dim`` is sharded
    more ways than ``sizes[0]`` splits evenly (8 KV heads on 16-way tensor
    parallelism) is first replicated on those mesh dims, as GSPMD does
    implicitly."""
    dim = dim % x.dim()
    if isinstance(x, DTensor):
        cut = [isinstance(p, Shard) and p.dim == dim for p in x.placements]
        ways = math.prod(x.device_mesh.size(i) for i, c in enumerate(cut) if c)
        if sizes[0] % ways:
            x = x.redistribute(x.device_mesh, [Replicate() if c else p
                                               for c, p in zip(cut, x.placements)])
    return x.reshape(tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:]))


def flatten(x, start: int, end: int):
    """``x.flatten(start, end)``, the inverse of ``unflatten``. On a DTensor
    whose dims ``start + 1 .. end`` are whole on every device (``start``
    itself may be sharded, as heads are) it is a block-local reshape: each
    device merges its own block, which is exact under that condition.
    DTensor's own view rule for such a merge differs between torch
    releases."""
    if not isinstance(x, DTensor):
        return x.flatten(start, end)
    start, end = start % x.dim(), end % x.dim()
    pl = []
    for p in x.placements:
        if isinstance(p, Shard) and start < p.dim <= end:
            raise ValueError(f"flatten({start}, {end}) of {tuple(x.shape)} placed {x.placements}: "
                             "only the leading dim may be sharded")
        pl.append(Shard(p.dim - (end - start)) if isinstance(p, Shard) and p.dim > end else p)
    shape = tuple(x.shape[:start]) + (math.prod(x.shape[start:end + 1]),) + tuple(x.shape[end + 1:])
    return _wrap(x.to_local().flatten(start, end), x.device_mesh, pl, shape)


def write_at(buf, index: tuple, value) -> None:
    """``buf[index] = value`` in place, ``index`` a tuple of ints and full
    slices over ``buf``'s leading dims. On a DTensor ``buf`` (a KV cache
    sharded on its sequence axis) each device writes the block of
    ``value`` that its shard holds: DTensor's own indexing would move a
    copy of a sharded dim and write into that."""
    if not isinstance(buf, DTensor):
        buf[index] = value
        return
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = buf.device_mesh
    ints = [d for d, i in enumerate(index) if not isinstance(i, slice)]
    # the value's placements: buf's, less the dims the ints take away
    pl = []
    for p in buf.placements:
        if isinstance(p, Shard) and p.dim in ints:
            pl.append(Replicate())
        elif isinstance(p, Shard):
            pl.append(Shard(p.dim - sum(d < p.dim for d in ints)))
        else:
            pl.append(p)
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim, run_check=False)
    block = value.redistribute(mesh, pl).to_local()  # on every device: a collective
    shape, offset = compute_local_shape_and_global_offset(buf.shape, mesh, buf.placements)
    local = []
    for d, i in enumerate(index):
        if isinstance(i, slice):
            local.append(i)
        elif not offset[d] <= i < offset[d] + shape[d]:
            return  # this device's shard does not hold the position
        else:
            local.append(i - offset[d])
    buf.to_local()[tuple(local)] = block



# --------------------------------------------------------------------------
# LM (transformer) specs
# --------------------------------------------------------------------------

def lm_param_spec(cfg, fsdp: bool = True):
    """PartitionSpec tree matching the transformer param tree.

    Megatron-style: column-parallel in-projections, row-parallel
    out-projections over "model"; the non-TP dim is FSDP-sharded over the
    batch axes when ``fsdp``. Layer params are stacked over a leading L dim
    (replicated). The tree may carry keys absent from a given config
    (e.g. "wg" on non-gated FFNs): the launch layer broadcasts spec trees
    against value trees and ignores extras."""
    F = ("pod", "data") if fsdp else None
    col = P(None, F, "model")   # (L, d_in, d_out/TP)
    row = P(None, "model", F)   # (L, d_in/TP, d_out)
    layer = {
        "attn": {"wq": {"w": col}, "wk": {"w": col}, "wv": {"w": col},
                 "wo": {"w": row}},
        "ln1": P(),
        "ln2": P(),
        "ffn": {"wi": {"w": col}, "wg": {"w": col}, "wo": {"w": row}},
        "moe": {
            "router": {"w": P(None, F)},
            # raw stacked arrays (L, E, d_in, d_out)
            "wi": P(None, None, F, "model"),
            "wg": P(None, None, F, "model"),
            "wo": P(None, None, "model", F),
        },
    }
    return {
        "embed": P("model", F),
        "layers": layer,
        "ln_f": P(),
        "lm_head": {"w": P(F, "model")},
    }


def map_specs(fn, tree):
    """``fn`` at every ``PartitionSpec`` of a spec tree (dicts, lists)."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return type(tree)(map_specs(fn, v) for v in tree)


def opt_state_spec(pspec, opt_name: str):
    """Optimizer-state spec tree from a param spec tree.

    Momentum-like slots shard exactly as the param; adafactor's factored
    second moment drops the corresponding reduced dim from the spec."""
    if opt_name == "sgd":
        return {"mu": pspec, "step": P()}
    if opt_name == "adamw":
        return {"m": pspec, "v": pspec, "step": P()}
    if opt_name == "adafactor":
        def second_moment(p):
            if len(p) < 2:
                # non-factored (vectors / scalars) -> {"v": ...} only; the
                # extra keys are harmless: spec trees are broadcast against
                # value trees key by key
                return {"v": P(*p), "vr": P(), "vc": P()}
            return {
                "vr": P(*p[:-1]),                      # row stats: drop last dim
                "vc": P(*(tuple(p[:-2]) + (p[-1],))),  # col stats: drop 2nd-last
                "v": P(*p),
            }
        return {"v": map_specs(second_moment, pspec), "step": P()}
    raise ValueError(f"unknown optimizer {opt_name!r}")


def lm_batch_spec(mesh):
    """Token batches shard over the data axes on dim 0."""
    b = batch_axes(mesh)
    return {"tokens": P(b, None), "labels": P(b, None)}


# --------------------------------------------------------------------------
# GNN / recsys batch & param specs
# --------------------------------------------------------------------------

def gnn_batch_spec(mesh, kind: str):
    """Spec-entry tuples (splatted into ``ns``) for sharded GNN batch keys.

    Edge arrays shard over every mesh axis; node arrays stay replicated
    (the segment sum pulls messages back to replicated node tables), so
    they are omitted: the launch layer replicates unlisted keys. ``kind``
    (full_graph / molecule / minibatch) shares one layout."""
    A = tuple(mesh.mesh_dim_names)
    return {"src": (A,), "dst": (A,), "emask": (A,)}


def recsys_param_spec(cfg, grasp: bool = False):
    """MIND param specs: the item table is the only big tensor.

    With ``grasp``, the hot rows are replicated (they serve most lookups:
    the same skew the cache policy exploits) and only the cold table is
    sharded."""
    A = ("pod", "data", "model")
    spec = {"s_mat": P(), "mlp": P()}
    if grasp:
        spec["items_hot"] = P()
        spec["items_cold"] = P(A, None)
    else:
        spec["items"] = P(A, None)
    return spec


def recsys_batch_spec(mesh, kind: str):
    b = batch_axes(mesh)
    A = tuple(mesh.mesh_dim_names)
    if kind == "train":
        return {"hist": P(b, None), "hist_mask": P(b, None),
                "target": P(b), "negatives": P()}
    if kind == "serve":
        return {"hist": P(b, None), "hist_mask": P(b, None),
                "candidates": P(b, None)}
    if kind == "retrieval":
        return {"hist": P(), "hist_mask": P(), "candidates": P(A)}
    raise ValueError(f"unknown recsys shape kind {kind!r}")


# --------------------------------------------------------------------------
# Trees of DTensors
# --------------------------------------------------------------------------

def map_placed(fn: Callable, tree: Any, shardings: Any) -> Any:
    """``fn(leaf, sharding)`` at every leaf of ``tree``, with ``shardings``
    a tree of ``NamedSharding`` of the same structure (dicts, lists,
    tuples, dataclasses such as the KV cache); ``None`` stays ``None``."""
    if tree is None:
        return None
    one = isinstance(shardings, NamedSharding)  # a prefix: one sharding for a subtree
    if isinstance(tree, dict):
        return {k: map_placed(fn, v, shardings if one else shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_placed(fn, v, shardings if one else s)
                          for v, s in zip(tree, [shardings] * len(tree) if one else shardings))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_placed(fn, getattr(tree, f.name),
                               shardings if one else getattr(shardings, f.name))
            for f in dataclasses.fields(tree)})
    return fn(tree, shardings)


def place(tree: Any, shardings: Any) -> Any:
    """Every leaf (a tensor, or an array or number made one) distributed on
    its sharding's mesh by its placements: each device keeps its block. A
    DTensor leaf is redistributed."""
    def one(x, s: NamedSharding):
        if isinstance(x, DTensor):
            return x if tuple(x.placements) == s.placements else x.redistribute(s.mesh,
                                                                                s.placements)
        t = torch.as_tensor(x).to(s.mesh.device_type)
        return distribute_tensor(t, s.mesh, s.placements)
    return map_placed(one, tree, shardings)


def abstract(tree: Any, shardings: Any) -> Any:
    """Meta tensors of global shapes -> meta DTensors whose local blocks
    are each device's shard shape: what a step sees on a mesh, with no
    storage anywhere."""
    def one(t: torch.Tensor, s: NamedSharding):
        local = torch.empty(s.shard_shape(t.shape), dtype=t.dtype, device="meta")
        return DTensor.from_local(local, s.mesh, s.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return map_placed(one, tree, shardings)


def gather_fsdp(tree: Any) -> Any:
    """Each DTensor leaf replicated over the batch axes ("pod", "data")
    that shard it, its tensor-parallel ("model") sharding kept: FSDP's
    gather of a weight at its use (GSPMD's choice for the JAX package's
    fsdp specs). Its backward reduce-scatters the gradient back to the
    leaf's placements. Plain leaves pass as they are, and with no active
    mesh the tree itself does (one device: no walk of the tree)."""
    if _ACTIVE_MESH is None:
        return tree

    def one(x, _):
        if not isinstance(x, DTensor):
            return x
        names = x.device_mesh.mesh_dim_names
        pl = tuple(Replicate() if names[i] in ("pod", "data") and isinstance(p, Shard) else p
                   for i, p in enumerate(x.placements))
        return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)
    return map_placed(one, tree, tree)


def to_local(tree: Any) -> Any:
    """Each DTensor leaf's local block (other leaves as they are)."""
    return map_placed(lambda x, _: x.to_local() if isinstance(x, DTensor) else x, tree, tree)


def from_local(tree: Any, shardings: Any) -> Any:
    """Local blocks -> DTensors with the shardings' placements."""
    return map_placed(lambda t, s: DTensor.from_local(t, s.mesh, s.placements, run_check=False),
                      tree, shardings)


def redistribute(tree: Any, shardings: Any) -> Any:
    """Each DTensor leaf moved to its sharding's placements."""
    def one(x, s: NamedSharding):
        if isinstance(x, DTensor) and tuple(x.placements) != s.placements:
            return x.redistribute(s.mesh, s.placements)
        return x
    return map_placed(one, tree, shardings)


def _edge_layout(x: DTensor, ids: DTensor, partial):
    """``x`` laid out as the segment ids (rows sharded where they are) and
    the placements of the (n, ...) table a local reduction gives: ``partial``
    on the mesh dims that shard the rows, ``x``'s replicated or
    feature-sharded layout elsewhere."""
    x_pl, out_pl = [], []
    for ip, xp in zip(ids.placements, x.placements):
        if isinstance(ip, Shard) and ip.dim == 0:
            x_pl.append(Shard(0))
            out_pl.append(partial)
        elif isinstance(ip, Replicate):
            keep = isinstance(xp, Shard) and xp.dim > 0
            x_pl.append(xp if keep else Replicate())
            out_pl.append(xp if keep else Replicate())
        else:
            raise ValueError(f"segment ids placed {ids.placements}: rows must be sharded on dim 0")
    if tuple(x.placements) != tuple(x_pl):
        x = x.redistribute(ids.device_mesh, x_pl)
    return x, x_pl, out_pl


def _wrap(local: torch.Tensor, mesh: DeviceMesh, placements, shape) -> DTensor:
    """A local block as a DTensor of global ``shape`` (DTensor would infer
    an even split, which an edge count the mesh does not divide is not)."""
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=stride)


def stack(tensors: list, dim: int = 0):
    """``torch.stack(tensors, dim)``; DTensors of one layout are stacked
    block by block (a local rule: the new dim is whole on every device,
    the others keep their placements), which every torch release takes."""
    first = tensors[0]
    if not isinstance(first, DTensor):
        return torch.stack(tensors, dim)
    dim = dim % (first.dim() + 1)
    pl = tuple(first.placements)
    if any(tuple(t.placements) != pl for t in tensors):
        raise ValueError("stack: the tensors are placed differently")
    shifted = [Shard(p.dim + (p.dim >= dim)) if isinstance(p, Shard) else p for p in pl]
    shape = tuple(first.shape[:dim]) + (len(tensors),) + tuple(first.shape[dim:])
    return _wrap(torch.stack([t.to_local() for t in tensors], dim), first.device_mesh, shifted,
                 shape)


def local_segment_sum(x: DTensor, ids: DTensor, n: int) -> DTensor:
    """``segment_sum(x, ids, n)`` over rows of DTensors, by a local rule
    (DTensor has none for ``index_add_``): on each mesh dim where ``ids``
    is sharded on its rows (edges) ``x`` is too, and each device sums its
    local rows into an (n, ...) table that is ``Partial(sum)`` there, which
    is what GSPMD makes of a segment sum over sharded edges; elsewhere
    ``x`` keeps a replicated or feature-sharded layout, which the table
    inherits. Call it inside ``torch.no_grad`` (a custom autograd
    function's forward)."""
    x, _, out_pl = _edge_layout(x, ids, Partial())
    xl = x.to_local()
    out = xl.new_zeros((n,) + tuple(xl.shape[1:])).index_add_(0, ids.to_local(), xl)
    return _wrap(out, ids.device_mesh, out_pl, (n,) + tuple(x.shape[1:]))


class LocalRows(torch.autograd.Function):
    """``table.index_select(0, idx)`` for DTensors (a plain operand read as
    replicated), by a local rule (the gather of a message pass, and its
    transpose): on each mesh dim where
    ``idx`` is sharded on its rows the table is replicated and each device
    takes the rows of its local indices (the result is sharded there);
    elsewhere the table keeps a replicated or feature-sharded layout. Its
    backward sums each device's row gradients into a ``Partial(sum)``
    table, a local ``index_add_``, as ``local_segment_sum`` does. DTensor's
    own rules for ``index_select`` and its backward differ between torch
    releases."""

    @staticmethod
    def forward(ctx, table, idx):
        mesh = (idx if isinstance(idx, DTensor) else table).device_mesh
        whole = [Replicate()] * mesh.ndim  # a plain operand is replicated
        table, idx = (x if isinstance(x, DTensor) else
                      DTensor.from_local(x, mesh, whole, run_check=False) for x in (table, idx))
        t_pl, out_pl, grad_pl = [], [], []
        for ip, tp in zip(idx.placements, table.placements):
            cut = isinstance(ip, Shard) and ip.dim == 0
            if not cut and not isinstance(ip, Replicate):
                raise ValueError(f"row ids placed {idx.placements}: rows must be sharded on dim 0")
            keep = isinstance(tp, Shard) and tp.dim > 0 and not cut
            t_pl.append(tp if keep else Replicate())
            out_pl.append(Shard(0) if cut else t_pl[-1])
            grad_pl.append(Partial() if cut else t_pl[-1])
        if tuple(table.placements) != tuple(t_pl):
            table = table.redistribute(mesh, t_pl)
        il = idx.to_local()
        ctx.save_for_backward(il)
        ctx.layout = (mesh, tuple(table.shape), out_pl, grad_pl)
        ctx.set_materialize_grads(False)  # rows no loss reaches get no gradient
        return _wrap(table.to_local().index_select(0, il), mesh, out_pl,
                     (idx.shape[0],) + tuple(table.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        (il,) = ctx.saved_tensors
        mesh, shape, out_pl, grad_pl = ctx.layout
        if g is None:
            return None, None
        if tuple(g.placements) != tuple(out_pl):
            g = g.redistribute(mesh, out_pl)
        gl = g.to_local()
        out = gl.new_zeros((shape[0],) + tuple(gl.shape[1:])).index_add_(0, il, gl)
        return _wrap(out, mesh, grad_pl, shape), None


def local_attention(attention, q: DTensor, k: DTensor, v: DTensor, **kw) -> DTensor:
    """``attention(q, k, v, **kw)`` (a (B, S, H, hd) attention whose heads
    and batch rows are independent) on each device's block: ``k`` and
    ``v`` (heads already repeated to q's) take ``q``'s placements, which may
    shard the batch (dim 0) and the heads (dim 2) only, and each device
    attends its own rows and heads. DTensor's own dispatch of the chunked
    attention flattens a sharded head dim (refused by some torch releases)
    and pays its host cost on every small operation of the chunk loops."""
    mesh, pl = q.device_mesh, tuple(q.placements)
    if any(isinstance(p, Shard) and p.dim not in (0, 2) or isinstance(p, Partial) for p in pl):
        raise ValueError(f"attention over q placed {pl}: only batch and heads may be sharded")
    k = k.redistribute(mesh, pl) if tuple(k.placements) != pl else k
    v = v.redistribute(mesh, pl) if tuple(v.placements) != pl else v
    out = attention(q.to_local(), k.to_local(), v.to_local(), **kw)
    return _wrap(out, mesh, pl, tuple(q.shape))


class LocalSegmentExtreme(torch.autograd.Function):
    """``segment_max``/``segment_min`` of DTensor rows by DTensor segment
    ids, by a local rule: each device reduces its local rows into an
    (n, ...) table based at -inf (+inf), the tables are reduced over the
    mesh dims that shard the rows (an all-reduce of max or min), and the
    result is replicated there (-inf/+inf where a segment has no row).
    The gradient is ``scatter_reduce``'s: each row equal to its segment's
    result takes the segment's gradient over the number of such rows, here
    counted over every device."""

    @staticmethod
    def forward(ctx, x, ids, n, reduce):
        mesh = ids.device_mesh
        op = {"amax": "max", "amin": "min"}[reduce]
        x, x_pl, part_pl = _edge_layout(x, ids, Partial(op))
        out_pl = [Replicate() if isinstance(p, Partial) else p for p in part_pl]
        xl, il = x.to_local(), ids.to_local()
        base = xl.new_full((n,) + tuple(xl.shape[1:]), -torch.inf if op == "max" else torch.inf)
        local = base.scatter_reduce(0, il[:, None].expand_as(xl) if xl.dim() > 1 else il, xl,
                                    reduce, include_self=True)
        shape = (n,) + tuple(x.shape[1:])
        out = _wrap(local, mesh, part_pl, shape).redistribute(mesh, out_pl)
        ctx.save_for_backward(xl, il, out.to_local())
        ctx.layout = (mesh, x_pl, part_pl, out_pl, tuple(x.shape))
        return out

    @staticmethod
    def backward(ctx, g):
        xl, il, result = ctx.saved_tensors
        mesh, x_pl, part_pl, out_pl, x_shape = ctx.layout
        if tuple(g.placements) != tuple(out_pl):
            g = g.redistribute(mesh, out_pl)
        hit = xl == result.index_select(0, il)
        ties = torch.zeros_like(result).index_add_(0, il, hit.to(result.dtype))
        ties = _wrap(ties, mesh, [Partial() if isinstance(p, Partial) else p for p in part_pl],
                     (result.shape[0],) + x_shape[1:])
        ties = ties.redistribute(mesh, out_pl).to_local().index_select(0, il)
        gx = torch.where(hit, g.to_local().index_select(0, il) / ties, 0.0)
        return _wrap(gx, mesh, x_pl, x_shape), None, None, None


class LocalTake(torch.autograd.Function):
    """``lookup_ref(table, ids)`` (``jnp.take(table, ids, axis=0)``) for a
    DTensor ``table``, by a local rule: a vocab-parallel lookup. On each
    mesh dim that shards the table's rows the ids are replicated (the ids
    are gathered, never the table), each device takes the rows of the ids
    that fall in its own row block (by the block's global offset) and
    zeroes the others, and the result is ``Partial(sum)`` there, which is
    what GSPMD makes of ``jnp.take`` on a row-sharded table; it is reduced
    to the ids' own placements before it is returned. On a mesh dim where
    the table is replicated the ids keep their layout. An id in [-V, 0)
    counts from the end and one outside [-V, V) gives a NaN row on every
    device, so a NaN row in the sum. The backward adds each row gradient
    whose id a device holds into its own row block (a local
    ``index_add_``): the gradient is sharded as the table (and
    ``Partial(sum)`` where the table is replicated and the ids are not).
    DTensor's own rules for ``index_select`` on a row-sharded table and
    its backward differ between torch releases."""

    @staticmethod
    def forward(ctx, table, ids):
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        mesh = table.device_mesh
        if not isinstance(ids, DTensor):
            ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
        id_pl, part_pl, grad_pl = [], [], []
        for tp, ip in zip(table.placements, ids.placements):
            rows = isinstance(tp, Shard) and tp.dim == 0
            if not rows and not isinstance(tp, Replicate):
                raise ValueError(f"table placed {table.placements}: only rows may be sharded")
            id_pl.append(Replicate() if rows else ip)
            part_pl.append(Partial() if rows else ip)
            grad_pl.append(tp if rows else Partial() if isinstance(ip, Shard) else Replicate())
        out_pl = tuple(ids.placements)
        if out_pl != tuple(id_pl):
            ids = ids.redistribute(mesh, id_pl)
        il, tl = ids.to_local(), table.to_local()
        n, lo = (x[0] for x in compute_local_shape_and_global_offset(table.shape, mesh,
                                                                      table.placements))
        v = table.shape[0]
        wrapped = torch.where(il < 0, il + v, il)
        local = wrapped - lo
        mine = (local >= 0) & (local < n)
        safe = local.clamp(0, max(n - 1, 0))
        feat = tuple(tl.shape[1:])
        lift = tuple(il.shape) + (1,) * len(feat)
        got = (tl.index_select(0, safe.reshape(-1)).reshape(tuple(il.shape) + feat) if n
               else tl.new_zeros(tuple(il.shape) + feat))
        got = torch.where(mine.reshape(lift), got, got.new_zeros(()))
        ok = (wrapped >= 0) & (wrapped < v)
        got = torch.where(ok.reshape(lift), got, got.new_full((), float("nan")))
        ctx.save_for_backward(safe, mine)
        ctx.layout = (mesh, tuple(table.shape), n, part_pl, grad_pl)
        shape = tuple(ids.shape) + tuple(table.shape[1:])
        return _wrap(got, mesh, part_pl, shape).redistribute(mesh, out_pl)

    @staticmethod
    def backward(ctx, g):
        safe, mine = ctx.saved_tensors
        mesh, shape, n, part_pl, grad_pl = ctx.layout
        whole = [Replicate() if isinstance(p, Partial) else p for p in part_pl]
        if tuple(g.placements) != tuple(whole):
            g = g.redistribute(mesh, whole)  # each device: the rows of every id it looked up
        gl = g.to_local()
        feat = tuple(gl.shape[safe.dim():])
        rows = torch.where(mine.reshape(tuple(mine.shape) + (1,) * len(feat)), gl, 0.0)
        out = gl.new_zeros((n,) + feat).index_add_(0, safe.reshape(-1), rows.reshape((-1,) + feat))
        return _wrap(out, mesh, grad_pl, shape), None


class _LocalEdgeMap(torch.autograd.Function):
    """``local_edge_map``'s autograd: the local function's own graph is
    built in the forward (on each device's blocks) and differentiated in
    the backward, and the gradients are wrapped with the placements their
    inputs had on the mesh."""

    @staticmethod
    def forward(ctx, fn, ids, reduced, n_rows, *args):
        ctx.set_materialize_grads(False)
        mesh = ids.device_mesh
        cut = [isinstance(p, Shard) for p in ids.placements]  # (E,) ids: Shard(0)
        row_pl = [Shard(0) if c else Replicate() for c in cut]
        whole = [Replicate()] * mesh.ndim
        part_pl = [Partial() if c else Replicate() for c in cut]
        locals_, grads_pl = [], []
        for i, a in enumerate(args):
            pl = row_pl if i < n_rows else whole
            if isinstance(a, DTensor):
                if tuple(a.placements) != tuple(pl):
                    a = a.redistribute(mesh, pl)
                a = a.to_local()
            locals_.append(a)
            # a row input's gradient is sharded as its rows; a weight that
            # meets every device's own edges gets a partial sum of its gradient
            grads_pl.append(row_pl if i < n_rows else part_pl)
        want = [isinstance(a, torch.Tensor) and ctx.needs_input_grad[4 + i]
                for i, a in enumerate(args)]
        with torch.enable_grad():
            live = [a.detach().requires_grad_() if w else a for a, w in zip(locals_, want)]
            outs = fn(*live)
        ctx.graph = ([x for x, w in zip(live, want) if w], outs)
        ctx.layout = (mesh, row_pl, whole, grads_pl, want,
                      [tuple(a.shape) if w else None for a, w in zip(args, want)])
        e = ids.shape[0]
        wrapped = []
        for o in outs:
            if o is None:
                wrapped.append(None)
            elif reduced:  # (n, ...) tables each device summed over its own edges
                wrapped.append(_wrap(o.detach(), mesh, part_pl, tuple(o.shape)))
            else:
                wrapped.append(_wrap(o.detach(), mesh, row_pl, (e,) + tuple(o.shape[1:])))
        ctx.mark_non_differentiable(*[w for w in wrapped
                                      if w is not None and not w.dtype.is_floating_point])
        ctx.reduced = reduced
        return tuple(wrapped)

    @staticmethod
    def backward(ctx, *grads):
        mesh, row_pl, whole, grads_pl, want, shapes = ctx.layout
        inputs, outs = ctx.graph
        ctx.graph = None
        pairs = []
        for o, g in zip(outs, grads):
            if o is None or g is None or not o.requires_grad:
                continue
            pl = whole if ctx.reduced else row_pl  # a partial sum's gradient is whole everywhere
            if tuple(g.placements) != tuple(pl):
                g = g.redistribute(mesh, pl)
            pairs.append((o, g.to_local()))
        got = iter(torch.autograd.grad([o for o, _ in pairs], inputs, [g for _, g in pairs],
                                       allow_unused=True) if pairs and inputs else ())
        out = []
        for w, pl, shape in zip(want, grads_pl, shapes):
            gl = next(got, None) if w else None
            out.append(None if gl is None else _wrap(gl, mesh, pl, shape))  # the input's shape
        return (None, None, None, None, *out)


def local_edge_map(fn, ids: DTensor, rows: list, shared: list, reduced: bool = False) -> tuple:
    """``fn(*rows, *shared)`` on each device's edges, by a local rule: the
    per-edge work of a message pass (geometry, radial nets, messages)
    without DTensor's dispatch of each small operation, whose broadcast
    and stacking rules differ between torch releases. ``rows`` are (E,
    ...) tensors laid out as the edge ids ``ids`` (sharded on their rows
    where ``ids`` is, whole elsewhere; None passes as None), ``shared``
    are weights, replicated on every device (tensors, None). ``fn``
    returns a tuple of tensors (or None): (E, ...) rows, sharded as the
    edges, or with ``reduced`` (n, ...) tables that each device summed
    over its own edges, ``Partial(sum)`` on the mesh dims that shard the
    edges. The gradient of a weight is such a partial sum too, and is
    declared so: read as replicated it would be each device's share
    alone."""
    return _LocalEdgeMap.apply(fn, ids, reduced, len(rows), *rows, *shared)


def local_decode(decode, q: DTensor, k: DTensor, v: DTensor, **kw) -> DTensor:
    """``decode(q, k, v, kpos, **kw)`` (one query position a row against a
    (B, S, KV, hd) cache; ``kpos`` the keys' positions) on each device's
    block, by a local rule. The cache may be sharded on its batch rows
    (dim 0) and its sequence (dim 1): ``q`` takes the cache's batch
    sharding and is whole elsewhere, so where the sequence is split each
    device attends every head against its own block of keys, and the
    softmax over keys is taken across the devices that split them (an
    all-reduce of each row's maximum and of its sum, the JAX package's
    cell's softmax over a sharded key axis); the product with the values
    is a partial sum there, reduced into ``q``'s placements. The cache is
    never gathered. On a mesh that splits no key, ``decode`` runs on the
    local blocks as it runs on one device. DTensor's own dispatch of the
    grouped products flattens a sharded head dim (refused by some torch
    releases)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, q_pl = q.device_mesh, tuple(q.placements)
    if tuple(v.placements) != tuple(k.placements):
        v = v.redistribute(mesh, k.placements)
    keys = [isinstance(p, Shard) and p.dim == 1 for p in k.placements]
    if any(isinstance(p, Shard) and p.dim > 1 or isinstance(p, Partial) for p in k.placements):
        raise ValueError(f"cache placed {k.placements}: only batch and sequence may be sharded")
    plan = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in k.placements]
    out_pl = [Partial() if c else p for c, p in zip(keys, plan)]
    if tuple(q.placements) != tuple(plan):
        q = q.redistribute(mesh, plan)
    shape, offset = compute_local_shape_and_global_offset(k.shape, mesh, k.placements)
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    kpos = torch.arange(offset[1], offset[1] + shape[1], device=kl.device)
    softmax = None
    if any(keys):
        def across(x, op):  # x reduced by ``op`` over the mesh dims that split the keys
            part = [Partial(op) if c else p for c, p in zip(keys, plan)]
            return _wrap(x, mesh, part, (q.shape[0],) + tuple(x.shape[1:])).redistribute(
                mesh, plan).to_local()

        def softmax(s):
            m = across(s.amax(dim=-1, keepdim=True), "max")
            e = torch.exp(s - m)
            return e / across(e.sum(dim=-1, keepdim=True), "sum")
    out = decode(ql, kl, vl, kpos, softmax=softmax, **kw)
    return _wrap(out, mesh, out_pl, tuple(q.shape)).redistribute(mesh, q_pl)
