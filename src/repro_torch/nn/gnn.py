"""GNN architectures: GIN, PNA, EGNN, NequIP-lite, GAT (forward).

Message passing is a gather (``index_select`` over edge endpoint indices)
and a segment reduction over ``dst`` (``index_add_``; PNA's max and min by
``scatter_reduce``), as the JAX package writes it with ``jnp.take`` and
``jax.ops.segment_*``. This is the Property-Array gather the paper
targets: with DBG reordering the hot (high-degree) node rows form a
prefix, which GNN serving reads through the GRASP feature cache and its
hot-gather kernel (K1).

Graph batch dict convention (numpy arrays or tensors; every function
computes on the device its parameters lie on):
  x      (N, F) float32 node features
  src    (E,)  int32 edge sources
  dst    (E,)  int32 edge destinations
  emask  (E,)  bool   valid-edge mask (padding)
  coords (N, 3) float32 (egnn / nequip)
  species(N,)  int32   (nequip)
  graph_id (N,) int32  molecule batching (segment readout)

PNA also takes a whole graph as a destination-sorted CSR: ``x``,
``indptr`` (N + 1,), ``src`` and ``dst`` (E,) int32 sorted by
destination, and no ``emask``. That batch takes a blocked inference path
that works one block of destination rows at a time, so that no tensor
spans all E edges (``_pna_blocked``; on the card its four statistics come
from one hand-written pass over each block's messages,
``kernels/segment_reduce``). GAT (``configs/gat.py``, not in the
registry) takes the same CSR batch through one hand-written attention pass
a layer (``_gat_csr``).

Parameters are nested dicts and lists of tensors, with ``None`` where the
JAX package has one (GIN's ``eps`` when it is not learnable, NequIP's
``r02``/``r22`` when ``l_max < 2``). ``dense`` computes in bfloat16 unless
told otherwise, as in the JAX package: every model passes float32 except
NequIP's ``self0`` and ``gate`` products, so NequIP's scalar features are
bfloat16 between layers there too.
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import devices, spans
from repro_torch.configs.base import GNNConfig
from repro_torch.core.plan import make_plan
from repro_torch.dist.sharding import (LocalRows, LocalSegmentExtreme, local_edge_map,
                                       local_segment_sum)
from repro_torch.kernels.gat_attend import ops as gat_ops
from repro_torch.kernels.gat_attend.gat_attend import gat_attend
from repro_torch.kernels.hot_gather import ops as hot_ops
from repro_torch.kernels.segment_reduce.segment_reduce import segment_stats
from repro_torch.nn import layers as L
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten


def to_device(params, device: torch.device):
    """The parameter tree with every tensor on ``device``."""
    return tree_map(lambda t: t.to(device), params)


def _device_of(params) -> torch.device:
    if isinstance(params, torch.Tensor):
        return params.device
    values = params.values() if isinstance(params, dict) else params
    for v in values:
        if v is not None:
            return _device_of(v)
    raise ValueError("parameter tree holds no tensor")


def _get(batch: Dict, key: str, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(batch[key], device=dev)


def _edges(batch: Dict, dev: torch.device):
    """(src, dst) as int64 (what ``scatter_reduce`` takes) and emask."""
    return (_get(batch, "src", dev).long(), _get(batch, "dst", dev).long(),
            _get(batch, "emask", dev).bool())


class _SegmentSum(torch.autograd.Function):
    """``jax.ops.segment_sum(x, dst, n)`` by ``index_add_`` (on DTensors,
    ``dist.sharding.local_segment_sum``), with its gradient ``g[dst]``. Autograd through ``index_add_`` itself would keep
    the (E, d) source alive for the backward (it reads the source's shape);
    this keeps only ``dst``: at 57M edges that is 13.65 GiB a layer."""

    @staticmethod
    def forward(ctx, x, dst, n):
        ctx.save_for_backward(dst)
        if isinstance(x, DTensor):
            return local_segment_sum(x, dst, n)
        return x.new_zeros((n,) + tuple(x.shape[1:])).index_add_(0, dst, x)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return _rows(g, dst), None, None


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table.index_select(0, idx)``; on DTensors (either operand) by
    ``dist.sharding.LocalRows``."""
    if isinstance(table, DTensor) or isinstance(idx, DTensor):
        return LocalRows.apply(table, idx)
    return table.index_select(0, idx)


def _seg_sum(x: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    return _SegmentSum.apply(x, dst, n)


def _seg_extreme(x: torch.Tensor, dst: torch.Tensor, n: int, reduce: str) -> torch.Tensor:
    """Segment ``amax``/``amin`` of (E, d) ``x`` over ``dst``, with 0 where
    the JAX package's ``segment_max``/``segment_min`` give a non-finite
    value: empty segments and segments whose every edge is masked to
    -inf/+inf reduce to the -inf/+inf base and are zeroed. The base is
    reduced with the rows (``include_self``): ``scatter_reduce``'s gradient
    counts a segment's ties with its base, which an empty segment alone
    equals, where a zero base would also count itself among the ties of a
    segment whose extreme is 0 (JAX's gradient splits evenly over the rows
    alone). On DTensors (a cell on a mesh) by
    ``dist.sharding.LocalSegmentExtreme``."""
    if isinstance(x, DTensor):
        out = LocalSegmentExtreme.apply(x, dst, n, reduce)
    else:
        out = x.new_full((n,) + tuple(x.shape[1:]), -torch.inf if reduce == "amax" else torch.inf)
        out = out.scatter_reduce(0, dst[:, None].expand_as(x), x, reduce, include_self=True)
    return torch.where(torch.isfinite(out), out, 0.0)


def _seg_extreme_sorted(x: torch.Tensor, offsets: torch.Tensor, reduce: str) -> torch.Tensor:
    """``_seg_extreme`` over destination-sorted rows: segment i of (E, d)
    ``x`` is the run ``offsets[i]:offsets[i + 1]``. A segmented reduction
    (``torch.segment_reduce``, no atomics); an empty segment reduces to the
    -inf/+inf base, and every non-finite extreme is zeroed, as there."""
    out = torch.segment_reduce(x, "max" if reduce == "amax" else "min", offsets=offsets,
                               axis=0, unsafe=True)
    return torch.where(torch.isfinite(out), out, 0.0)


def _mlp_init(gen: torch.Generator, dims):
    return [L.dense_init(gen, a, b) for a, b in zip(dims[:-1], dims[1:])]


def _mlp(params, x, act=L.silu, compute_dtype=torch.float32):
    for i, p in enumerate(params):
        x = L.dense(p, x, compute_dtype)
        if i < len(params) - 1:
            x = act(x)
    return x


def _deg(dst, n, emask):
    ones = torch.where(emask, 1.0, 0.0)
    return _seg_sum(ones, dst, n)


# ---------------------------------------------------------------------------
# GIN (Xu et al. 2019) — sum aggregator, learnable eps
# ---------------------------------------------------------------------------
def gin_init(gen: torch.Generator, cfg: GNNConfig, d_feat: int):
    d = cfg.d_hidden
    layers = []
    for i in range(cfg.n_layers):
        din = d_feat if i == 0 else d
        layers.append({
            "mlp": _mlp_init(gen, [din, d, d]),
            "eps": torch.zeros(()) if cfg.eps_learnable else None,
            "ln": L.layernorm_init(d),
        })
    return {"layers": layers, "out": L.dense_init(gen, d, cfg.d_out)}


def gin_apply(params, cfg: GNNConfig, batch: Dict):
    dev = _device_of(params)
    h = _get(batch, "x", dev)
    src, dst, emask = _edges(batch, dev)
    n = h.shape[0]
    for lp in params["layers"]:
        msg = _rows(h, src)
        msg = torch.where(emask[:, None], msg, 0.0)
        agg = _seg_sum(msg, dst, n)
        eps = lp["eps"] if lp["eps"] is not None else 0.0
        h = _mlp(lp["mlp"], (1.0 + eps) * h + agg)
        h = F.relu(L.layernorm(lp["ln"], h))
    return L.dense(params["out"], h, torch.float32)


# ---------------------------------------------------------------------------
# PNA (Corso et al. 2020) — multi-aggregator + degree scalers
# ---------------------------------------------------------------------------
def pna_init(gen: torch.Generator, cfg: GNNConfig, d_feat: int):
    d = cfg.d_hidden
    n_agg = len(cfg.aggregators) * len(cfg.scalers)
    layers = []
    for i in range(cfg.n_layers):
        din = d_feat if i == 0 else d
        layers.append({
            "pre": _mlp_init(gen, [2 * din, d]),
            "post": _mlp_init(gen, [n_agg * d + din, d, d]),
            "ln": L.layernorm_init(d),
        })
    return {"layers": layers, "out": L.dense_init(gen, d, cfg.d_out)}


def pna_apply(params, cfg: GNNConfig, batch: Dict, mean_log_deg: float | None = None):
    """PNA's logits (N, d_out). ``mean_log_deg`` is δ, the mean of
    log(deg + 1) over the training graph. A batch with a destination-sorted
    CSR (``indptr``) is a whole graph and takes the blocked inference path,
    ``_pna_blocked``, where δ defaults to that graph's own; a batch dict's
    defaults to 1.0."""
    if "indptr" in batch:
        return _pna_blocked(params, cfg, batch, mean_log_deg)
    if mean_log_deg is None:
        mean_log_deg = 1.0
    dev = _device_of(params)
    h = _get(batch, "x", dev)
    src, dst, emask = _edges(batch, dev)
    n = h.shape[0]
    deg = _deg(dst, n, emask)
    log_deg = torch.log1p(deg)
    delta = max(mean_log_deg, 1e-3)
    em = emask[:, None]

    for lp in params["layers"]:
        hi = _rows(h, dst)
        hj = _rows(h, src)
        m = _mlp(lp["pre"], torch.cat([hi, hj], dim=-1))
        m = torch.where(em, m, 0.0)
        s = _seg_sum(m, dst, n)
        mx = _seg_extreme(torch.where(em, m, -math.inf), dst, n, "amax")
        mn = _seg_extreme(torch.where(em, m, math.inf), dst, n, "amin")
        ss = _seg_sum(m * m, dst, n)
        h = _pna_update(lp, cfg, h, (s, ss, mx, mn), deg, log_deg, delta)
    return L.dense(params["out"], h, torch.float32)


def _pna_update(lp, cfg: GNNConfig, h, stats, deg, log_deg, delta: float):
    """One PNA layer's new rows from its rows ``h`` (R, d_in) and their
    edge statistics ``stats``: the sums of the messages and of their
    squares, and their maximum and minimum (0 for a row without edges),
    each (R, d), over rows of degree ``deg`` (R,) with ``log_deg`` =
    log(deg + 1): the aggregators times the degree scalers, then ``post``,
    LayerNorm and ReLU."""
    s, ss, mx, mn = stats
    cnt = torch.clamp(deg, min=1.0)[:, None]
    mean = s / cnt
    sq = ss / cnt
    # eps inside sqrt, as in the JAX package (its gradient at 0)
    std = torch.sqrt(torch.clamp(sq - mean * mean, min=0.0) + 1e-5)

    aggs = {"mean": mean, "max": mx, "min": mn, "std": std}
    scaled = []
    for a in cfg.aggregators:
        base = aggs[a]
        for sc in cfg.scalers:
            if sc == "identity":
                scaled.append(base)
            elif sc == "amplification":
                scaled.append(base * (log_deg / delta)[:, None])
            elif sc == "attenuation":
                scaled.append(base * (delta / torch.clamp(log_deg, min=1e-3))[:, None])
    z = torch.cat(scaled + [h], dim=-1)
    return F.relu(L.layernorm(lp["ln"], _mlp(lp["post"], z)))


def pna_blocks(indptr, block_edges: int) -> list:
    """Destination blocks ``[(v0, v1, e0, e1)]`` of a CSR: whole rows
    ``[v0, v1)``, whose edges are ``[e0, e1)``, at most ``block_edges`` rows
    and at most ``block_edges`` edges a block, except a row longer than that,
    which is a block of its own."""
    if block_edges < 1:
        raise ValueError(f"block_edges must be >= 1, got {block_edges}")
    ptr = torch.as_tensor(indptr).to("cpu", torch.int64)
    n = ptr.shape[0] - 1
    blocks, v0 = [], 0
    while v0 < n:
        e0 = int(ptr[v0])
        v1 = int(torch.searchsorted(ptr, e0 + block_edges, right=True)) - 1
        v1 = min(max(v1, v0 + 1), v0 + block_edges, n)
        blocks.append((v0, v1, e0, int(ptr[v1])))
        v0 = v1
    return blocks


# edges (and rows) a block of the blocked layer: the fastest budget measured for
# kron21 on an H100 80 GB (a forward 1.53 s, against 1.67 at 2^23 and 1.91 at 2^22),
# 4 blocks a layer and 31.6 GiB at peak (PERF.md, kron21.pna)
BLOCK_EDGES = 1 << 24


def _pna_blocked(params, cfg: GNNConfig, batch: Dict, mean_log_deg: float | None):
    """PNA inference over a whole graph, one block of destination rows at a
    time (``pna_blocks``), so that no tensor spans all E edges.

    The batch holds ``x`` (N, F), ``indptr`` (N + 1,), ``src`` (E,) int32
    sorted by destination and ``dst`` (E,) int32 (the rows' ids); δ is
    ``mean_log_deg``, else the graph's mean log(deg + 1). Blocks hold at
    most ``BLOCK_EDGES`` edges. Each block gathers its edges' source rows
    through K1 (``ops.hot_gather``, its High Reuse Region sized by
    ``core.plan.make_plan`` to the L2 at 4·d bytes a row) where
    ``cfg.grasp`` is set, else by ``index_select``; runs ``pre`` on
    ``[h_dst, h_src]``; reduces the four statistics over the block's rows
    (on the card in one pass over the messages, ``segment_stats``; on the
    CPU the sums by ``index_add_`` on int32 ids and the extremes by a
    segmented reduction over the block's CSR offsets); and writes the
    block's new rows. Inference only: a call that autograd would record
    raises."""
    dev = _device_of(params)
    h = _get(batch, "x", dev)
    if torch.is_grad_enabled() and (h.requires_grad or any(
            t.requires_grad for t in tree_leaves(params) if t is not None)):
        raise RuntimeError("the blocked PNA forward (a batch with indptr) is inference only: "
                           "run it under torch.no_grad(), or train on a batch dict with "
                           "src, dst and emask")
    with torch.no_grad():
        indptr = _get(batch, "indptr", dev)
        src, dst = _get(batch, "src", dev), _get(batch, "dst", dev)
        if src.dtype != torch.int32 or dst.dtype != torch.int32:
            raise ValueError(f"src and dst must be int32, got {src.dtype} and {dst.dtype}")
        n = h.shape[0]
        deg = (indptr[1:] - indptr[:-1]).to(torch.float32)
        log_deg = torch.log1p(deg)
        if mean_log_deg is None:
            mean_log_deg = float(torch.log1p(deg.double()).mean())
        delta = max(mean_log_deg, 1e-3)
        blocks = pna_blocks(indptr, BLOCK_EDGES)
        for lp in params["layers"]:
            d_in = h.shape[1]
            hot_size = make_plan(n, 4 * d_in).hot_size if cfg.grasp else None
            out = h.new_empty((n, lp["ln"]["g"].shape[-1]))
            for v0, v1, e0, e1 in blocks:
                with spans.span("gnn.block"):
                    src_b, dst_b = src[e0:e1], dst[e0:e1]
                    with spans.span("gnn.gather"):
                        hj = (hot_ops.hot_gather(h, src_b, hot_size) if cfg.grasp
                              else h.index_select(0, src_b))
                        hi = h.index_select(0, dst_b)
                    with spans.span("gnn.message"):
                        m = _mlp(lp["pre"], torch.cat([hi, hj], dim=-1))
                        del hi, hj
                    with spans.span("gnn.reduce"):
                        offsets = indptr[v0:v1 + 1] - e0
                        if m.is_cuda:
                            stats = segment_stats(m, offsets.to(torch.int32)).unbind()
                        else:
                            seg, rows = dst_b - v0, (v1 - v0, m.shape[1])
                            stats = (m.new_zeros(rows).index_add_(0, seg, m),
                                     m.new_zeros(rows).index_add_(0, seg, m * m),
                                     _seg_extreme_sorted(m, offsets, "amax"),
                                     _seg_extreme_sorted(m, offsets, "amin"))
                            del seg
                        del m
                    with spans.span("gnn.update"):
                        out[v0:v1] = _pna_update(lp, cfg, h[v0:v1], stats, deg[v0:v1],
                                                 log_deg[v0:v1], delta)
            h = out
        return L.dense(params["out"], h, torch.float32)


# ---------------------------------------------------------------------------
# EGNN (Satorras et al. 2021) — E(n)-equivariant, scalar-distance messages
# ---------------------------------------------------------------------------
def egnn_init(gen: torch.Generator, cfg: GNNConfig, d_feat: int):
    d = cfg.d_hidden
    layers = []
    for i in range(cfg.n_layers):
        din = d_feat if i == 0 else d
        layers.append({
            "phi_e": _mlp_init(gen, [2 * din + 1, d, d]),
            "phi_x": _mlp_init(gen, [d, d, 1]),
            "phi_h": _mlp_init(gen, [din + d, d, d]),
        })
    return {"layers": layers, "out": L.dense_init(gen, d, cfg.d_out)}


def egnn_apply(params, cfg: GNNConfig, batch: Dict):
    """Returns (node features (N, d_out), updated coordinates (N, 3))."""
    dev = _device_of(params)
    h = _get(batch, "x", dev)
    coords = _get(batch, "coords", dev)
    src, dst, emask = _edges(batch, dev)
    n = h.shape[0]
    for lp in params["layers"]:
        xi, xj = _rows(coords, dst), _rows(coords, src)
        diff = xi - xj
        d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        hi, hj = _rows(h, dst), _rows(h, src)
        m = _mlp(lp["phi_e"], torch.cat([hi, hj, d2], dim=-1))
        m = L.silu(m)
        m = torch.where(emask[:, None], m, 0.0)
        # coordinate update (equivariant), divided by the masked degree
        w = _mlp(lp["phi_x"], m)
        xupd = _seg_sum(diff * w, dst, n)
        cnt = torch.clamp(_deg(dst, n, emask), min=1.0)[:, None]
        coords = coords + xupd / cnt
        # feature update
        magg = _seg_sum(m, dst, n)
        h = _mlp(lp["phi_h"], torch.cat([h, magg], dim=-1))
    return L.dense(params["out"], h, torch.float32), coords


# ---------------------------------------------------------------------------
# NequIP-lite — O(3)-equivariant with restricted tensor-product paths
# (the restricted path set {0⊗Yl→l, l⊗Y0→l, 1⊗Y1→0} is individually
#  equivariant; full e3nn CG products are out of scope, as in the JAX package)
# ---------------------------------------------------------------------------
def _bessel_rbf(r, n_rbf, cutoff):
    # Bessel radial basis with smooth polynomial cutoff (NequIP defaults)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    rr = torch.clamp(r, min=1e-6)
    rbf = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * rr[..., None] / cutoff) / rr[..., None]
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1.0 - 10.0 * x**3 + 15.0 * x**4 - 6.0 * x**5  # C2-smooth cutoff
    return rbf * env[..., None]


def _y2(u):
    """5 real l=2 spherical-harmonic components of unit vector u (N,3)."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    c = math.sqrt(3.0)
    return torch.stack(
        [c * x * y, c * y * z, 0.5 * (3 * z * z - 1.0), c * x * z,
         0.5 * c * (x * x - y * y)],
        dim=-1,
    )


def nequip_init(gen: torch.Generator, cfg: GNNConfig, n_species: int = 8):
    d = cfg.d_hidden
    layers = []
    for _ in range(cfg.n_layers):
        radial = {k: _mlp_init(gen, [cfg.n_rbf, d, d]) for k in ("r00", "r01", "r11", "r110")}
        for k in ("r02", "r22"):
            radial[k] = _mlp_init(gen, [cfg.n_rbf, d, d]) if cfg.l_max >= 2 else None
        layers.append({
            # radial nets: rbf -> per-channel weights for each TP path
            **radial,
            "self0": L.dense_init(gen, d, d),
            "self1": L.dense_init(gen, d, d),
            "self2": L.dense_init(gen, d, d),
            "gate": L.dense_init(gen, d, 2 * d),
        })
    embed = torch.randn((n_species, d), generator=gen, dtype=torch.float32, device=gen.device)
    return {"embed": embed * 0.5, "layers": layers, "out": _mlp_init(gen, [d, d, 1])}


RADIAL = ("r00", "r01", "r11", "r110", "r02", "r22")


def _on_edges(fn, ids, rows, shared=None, reduced=False):
    """``fn(*rows, shared)``: per-edge work over (E, ...) ``rows`` laid out
    as the edge ids ``ids``, with the weight tree ``shared``. On DTensors (a
    cell on a mesh) on each device's own edges by
    ``dist.sharding.local_edge_map`` (``reduced``: ``fn`` returns node
    tables summed over the edges, partial sums there)."""
    if not isinstance(ids, DTensor):
        return fn(*rows, shared)
    leaves = tree_leaves(shared)
    return local_edge_map(lambda *a: fn(*a[:len(rows)], tree_unflatten(shared, a[len(rows):])),
                          ids, rows, leaves, reduced)


def _nequip_geometry(cfg: GNNConfig, ci, cj, emask, _):
    """Per edge: the radial basis, the l=1 and l=2 harmonics of the unit
    vector and the valid mask (unmasked and inside the cutoff)."""
    rij = ci - cj
    r = torch.sqrt(torch.clamp(torch.sum(rij * rij, dim=-1), min=1e-12))
    u = rij / r[:, None]
    rbf = _bessel_rbf(r, cfg.n_rbf, cfg.cutoff)          # (E, n_rbf)
    y2 = _y2(u) if cfg.l_max >= 2 else None               # (E, 5)
    valid = emask & (r < cfg.cutoff)
    return rbf, u, y2, valid


def _nequip_messages(cfg: GNNConfig, n: int, dst, sj, vj, tj, rbf, y1, y2, valid, radial):
    """One layer's messages, weighted by the radial nets and summed into
    their destinations: the (N, d), (N, d, 3) and (N, d, 5) updates."""
    def seg(x, w):
        x = torch.where(valid.reshape((-1,) + (1,) * (x.ndim - 1)), x * w, 0.0)
        return _seg_sum(x, dst, n)

    w00 = _mlp(radial["r00"], rbf)                        # (E, d)
    w01 = _mlp(radial["r01"], rbf)
    w11 = _mlp(radial["r11"], rbf)
    w110 = _mlp(radial["r110"], rbf)

    # l=0 out: 0⊗Y0→0 and 1⊗Y1→0 (dot product path)
    s_new = seg(sj, w00) + seg(torch.einsum("edk,ek->ed", vj, y1), w110)
    # l=1 out: 0⊗Y1→1 and 1⊗Y0→1
    v_new = seg(sj[:, :, None] * y1[:, None, :], w01[:, :, None]) + seg(
        vj, w11[:, :, None]
    )
    t_new = None
    if cfg.l_max >= 2:
        w02 = _mlp(radial["r02"], rbf)
        w22 = _mlp(radial["r22"], rbf)
        t_new = seg(sj[:, :, None] * y2[:, None, :], w02[:, :, None]) + seg(
            tj, w22[:, :, None]
        )
    return s_new, v_new, t_new


def nequip_apply(params, cfg: GNNConfig, batch: Dict):
    """Returns per-node energy (N,). Features: s (N,d), v (N,d,3), t (N,d,5);
    all channel-major. The per-edge work (geometry, radial nets, messages
    and their sums) runs through ``_on_edges``: on a mesh, on each
    device's own edges."""
    dev = _device_of(params)
    src, dst, emask = _edges(batch, dev)
    coords = _get(batch, "coords", dev)
    species = _get(batch, "species", dev).long()
    n = coords.shape[0]
    d = cfg.d_hidden

    rbf, y1, y2, valid = _on_edges(functools.partial(_nequip_geometry, cfg), dst,
                                   (_rows(coords, dst), _rows(coords, src), emask))

    s = _rows(params["embed"], species)                   # (N, d)
    v = torch.zeros((n, d, 3), device=dev)
    t = torch.zeros((n, d, 5), device=dev) if cfg.l_max >= 2 else None

    for lp in params["layers"]:
        sj = _rows(s, src)                                # (E, d)
        vj = _rows(v, src)                                # (E, d, 3)
        tj = _rows(t, src) if cfg.l_max >= 2 else None
        s_new, v_new, t_new = _on_edges(
            functools.partial(_nequip_messages, cfg, n), dst,
            (dst, sj, vj, tj, rbf, y1, y2, valid), {k: lp[k] for k in RADIAL}, reduced=True)
        # self-interaction (channel mixing) + gated nonlinearity; self0 and
        # gate take dense's bfloat16 default, as in the JAX package
        s_mix = L.dense(lp["self0"], s + s_new)
        v_mix = torch.einsum("ndk,do->nok", v + v_new, lp["self1"]["w"])
        gates = L.dense(lp["gate"], L.silu(s_mix))
        g1, g0 = gates[:, :d], gates[:, d:]
        s = L.silu(s_mix + g0)
        v = v_mix * L.sigmoid(g1)[:, :, None]
        if cfg.l_max >= 2:
            t_mix = torch.einsum("ndk,do->nok", t + t_new, lp["self2"]["w"])
            t = t_mix * L.sigmoid(g1)[:, :, None]

    energy = _mlp(params["out"], s)[:, 0]                 # invariant readout
    return energy


# ---------------------------------------------------------------------------
# GAT (Veličković et al. 2018) — multi-head edge-softmax attention
# ---------------------------------------------------------------------------
def gat_init(gen: torch.Generator, cfg, d_feat: int):
    """PyG's ``GATConv`` layout a layer, with a linear skip: ``lin`` (d_in,
    H·C) without a bias, ``att_src`` and ``att_dst`` (H, C), ``bias`` (H·C,
    or C on the last layer, whose heads are averaged) and ``skip`` (d_in,
    width) with its bias. Weights N(0, 1/d_in), attention vectors N(0,
    1/C), biases N(0, 0.1²)."""
    layers, d_in = [], d_feat
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        c = cfg.d_out if last else cfg.d_head
        width = c if last else cfg.heads * c
        layers.append({
            "lin": L.dense_init(gen, d_in, cfg.heads * c),
            "att_src": L.normal(gen, (cfg.heads, c), 1 / math.sqrt(c)),
            "att_dst": L.normal(gen, (cfg.heads, c), 1 / math.sqrt(c)),
            "bias": L.normal(gen, (width,), 0.1),
            "skip": {**L.dense_init(gen, d_in, width), "b": L.normal(gen, (width,), 0.1)},
        })
        d_in = width
    return {"layers": layers}


def gat_apply(params, cfg, batch: Dict):
    """GAT's node logits (N, d_out). A batch with a destination-sorted CSR
    (``indptr``) takes the inference route through the attention kernel,
    ``_gat_csr``; a batch dict (``src``, ``dst``, ``emask``) is plain torch
    operations, which autograd can differentiate."""
    if "indptr" in batch:
        return _gat_csr(params, cfg, batch)
    dev = _device_of(params)
    h = _get(batch, "x", dev)
    src, dst, emask = _edges(batch, dev)
    n = h.shape[0]
    if cfg.self_loops:
        own = torch.arange(n, device=dev)
        src, dst = torch.cat([src, own]), torch.cat([dst, own])
        emask = torch.cat([emask, torch.ones(n, dtype=torch.bool, device=dev)])
    for i, lp in enumerate(params["layers"]):
        last = i == len(params["layers"]) - 1
        heads, c = lp["att_src"].shape
        z = L.dense(lp["lin"], h, torch.float32).view(n, heads, c)
        e = F.leaky_relu(_rows((z * lp["att_src"]).sum(-1), src)
                         + _rows((z * lp["att_dst"]).sum(-1), dst), cfg.negative_slope)
        e = torch.where(emask[:, None], e, -math.inf)
        top = e.new_full((n, heads), -math.inf).scatter_reduce(
            0, dst[:, None].expand_as(e), e, "amax", include_self=True).detach()
        p = torch.where(emask[:, None], torch.exp(e - _rows(top, dst)), 0.0)
        den = _seg_sum(p, dst, n)
        o = _seg_sum(_rows(z, src) * p[:, :, None], dst, n) / torch.where(
            den > 0, den, 1.0)[:, :, None]  # a row without items sums to 0, as PyG's
        o = o.mean(1) if last else o.reshape(n, heads * c)
        h = o + L.dense(lp["skip"], h, torch.float32) + (lp["bias"] + lp["skip"]["b"])
        h = h if last else F.elu(h)
    return h


def _gat_csr(params, cfg, batch: Dict):
    """GAT inference over a whole graph. The batch holds ``x`` (N, F) and
    the in-CSR: ``indptr`` (N + 1,) and ``src`` (E,), int32, sorted by
    destination (``gat_attend`` checks them). Each layer is one SGEMM for its rows, scores and
    skip (``gat_ops.project``), one ``gat_attend`` call over the CSR and
    its self loops (rows below ``make_plan(N, 4·H·C).hot_size`` held in L2
    where ``cfg.grasp`` is set), then the bias, the skip and ELU, in place.
    No tensor spans the E edges. Inference only: a call that autograd
    would record raises."""
    dev = _device_of(params)
    h = _get(batch, "x", dev)
    if torch.is_grad_enabled() and (h.requires_grad or any(
            t.requires_grad for t in tree_leaves(params) if t is not None)):
        raise RuntimeError("the GAT forward over a CSR (a batch with indptr) is inference only: "
                           "run it under torch.no_grad(), or train on a batch dict with "
                           "src, dst and emask")
    if not cfg.self_loops:
        raise ValueError("the GAT attention kernel adds a self loop to every row: "
                         "cfg.self_loops must be set on a batch with indptr")
    with torch.no_grad():
        indptr, src = _get(batch, "indptr", dev), _get(batch, "src", dev)
        n = h.shape[0]
        for i, lp in enumerate(params["layers"]):
            last = i == len(params["layers"]) - 1
            heads, c = lp["att_src"].shape
            with spans.span("gnn.transform"):
                z, s_src, s_dst, skip = gat_ops.project(h, lp)
            del h
            hot_size = make_plan(n, 4 * heads * c).hot_size if cfg.grasp else 0
            with spans.span("gnn.attend"):
                h = gat_attend(indptr, src, z, s_src, s_dst, hot_size, cfg.negative_slope,
                               mean=last)
            with spans.span("gnn.update"):
                h += skip
                h += lp["bias"] + lp["skip"]["b"]
                if not last:
                    F.elu(h, inplace=True)
            del z, s_src, s_dst, skip
        return h


KINDS = {
    "gin": (gin_init, gin_apply),
    "pna": (pna_init, pna_apply),
    "egnn": (egnn_init, egnn_apply),
    "nequip": (nequip_init, nequip_apply),
    "gat": (gat_init, gat_apply),
}


def init(gen: torch.Generator, cfg: GNNConfig, d_feat: int,
         device: str | torch.device = devices.DEFAULT_DEVICE):
    """Random parameters of ``cfg.kind`` drawn from ``gen`` (on its own
    device, so one seed gives the same parameters on every device), placed
    on ``device``. NequIP embeds species and ignores ``d_feat``."""
    dev = devices.resolve(device)
    if cfg.kind == "nequip":
        params = nequip_init(gen, cfg)
    else:
        params = KINDS[cfg.kind][0](gen, cfg, d_feat)
    return to_device(params, dev)


def apply(params, cfg: GNNConfig, batch: Dict):
    return KINDS[cfg.kind][1](params, cfg, batch)
