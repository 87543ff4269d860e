"""Roofline terms of a step: its compute, memory and collective times at
the card's peak rates.

    compute    = HLO_FLOPs / (chips * peak_FLOP/s)
    memory     = HLO_bytes / (chips * HBM_bw)
    collective = collective_bytes / (chips * link_bw)

The JAX package's formulas over configs (``model_flops_for``,
``analytic_lm_terms``), its ``Roofline`` record and its ``analyze`` /
``collective_bytes`` over a cost dict and XLA HLO text (operand sizes of
all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute, scaled by a per-op traffic factor: ring-algorithm
bytes actually crossing links), with one NVIDIA H100 SXM5's peak rates in
place of the TPU's. Counting a torch program's collectives waits for the
mesh slice.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

# NVIDIA H100 SXM5 (NVIDIA's H100 data sheet, SXM5 column, at its 700 W limit)
PEAK_FLOPS = 989.4e12      # bf16 dense tensor-core FLOP/s (1,979 with sparsity)
HBM_BW = 3.35e12           # bytes/s of HBM3
# NVLink 4: the 900 GB/s a GPU is both directions together (18 links of
# 25 GB/s each way); collective_bytes counts the bytes each card sends (or
# receives), so the rate is one direction's
LINK_BW = 450e9            # bytes/s per direction per GPU

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVE_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|[\w\[\],{}]+)\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(",
)
_GROUPS_RE = re.compile(r"replica_groups=\{([^}]*)\}|replica_groups=\[\d+,(\d+)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_RE.search(line)
    if not m:
        return default
    if m.group(2):  # iota form replica_groups=[G,S] -> group size S
        return int(m.group(2))
    first = m.group(1).split("}")[0].lstrip("{")
    ids = [x for x in first.split(",") if x.strip() != ""]
    return max(len(ids), 1)


_OPNAME_RE = re.compile(r'op_name="([^"]*)"')


def collective_bytes(hlo_text: str, num_devices: int,
                     loop_trips: tuple = ()) -> Dict[str, float]:
    """Per-chip bytes crossing the links, by collective op type.

    Ring-algorithm factors for a group of size G over the *output/operand*
    size B (per-shard semantics follow the HLO result shapes):
      all-gather:        result is the gathered (full) buffer; each chip
                         receives (G-1)/G of it  -> B * (G-1)/G
      reduce-scatter:    same traffic as all-gather on the input side
      all-reduce:        2 * B * (G-1)/G (reduce-scatter + all-gather)
      all-to-all:        B * (G-1)/G leaves each chip
      collective-permute: B (point-to-point)

    XLA counts a while (jax.lax.scan) body ONCE in the HLO text, so
    collectives whose op_name metadata shows scan nesting are scaled by
    ``loop_trips``: a collective at while-depth k is multiplied by
    prod(loop_trips[:k]) (e.g. (n_layers, seq_chunks) for an LM step).
    """
    out = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0, "collective-permute": 0.0}
    for line in hlo_text.splitlines():
        m = _COLLECTIVE_RE.match(line)
        if not m:
            continue
        result_shape, op = m.group(1), m.group(2)
        b = _shape_bytes(result_shape)
        g = _group_size(line, num_devices)
        if g <= 1:
            continue
        if loop_trips:
            opname = _OPNAME_RE.search(line)
            depth = opname.group(1).count("while/body") if opname else 0
            for trip in loop_trips[: min(depth, len(loop_trips))]:
                b *= trip
        frac = (g - 1) / g
        if op == "all-gather":
            out[op] += b * frac
        elif op == "reduce-scatter":
            out[op] += b * frac * g  # result is 1/G of the reduced buffer
        elif op == "all-reduce":
            out[op] += 2 * b * frac
        elif op == "all-to-all":
            out[op] += b * frac
        elif op == "collective-permute":
            out[op] += b
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    num_devices: int
    hlo_gflops: float            # per device
    hlo_gbytes: float            # per device
    coll_gbytes: float           # per device
    compute_s: float
    memory_s: float
    collective_s: float
    model_gflops: float          # analytic 6*N*D (global, per step)
    bytes_per_device: Optional[float] = None
    coll_breakdown: Optional[dict] = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_ratio(self) -> float:
        total = self.hlo_gflops * self.num_devices
        return self.model_gflops / total if total > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """fraction of the ideal compute roofline achieved if the step runs
        at its dominant-term time: (model_flops/chips/peak) / bound_s."""
        ideal = self.model_gflops * 1e9 / self.num_devices / PEAK_FLOPS
        return ideal / self.bound_s if self.bound_s > 0 else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "devices": self.num_devices,
            "hlo_gflops_per_dev": round(self.hlo_gflops, 3),
            "hlo_gbytes_per_dev": round(self.hlo_gbytes, 3),
            "coll_gbytes_per_dev": round(self.coll_gbytes, 3),
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_gflops": round(self.model_gflops, 1),
            "useful_flop_ratio": round(self.useful_flop_ratio, 4),
            "roofline_fraction": round(self.roofline_fraction, 4),
            "bytes_per_device": self.bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
        }


def analyze(arch, shape, mesh_name, num_devices, cost, hlo_text,
            model_flops: float, memory_bytes: Optional[float] = None,
            loop_trips: tuple = (),
            analytic: Optional[dict] = None) -> Roofline:
    """``analytic`` (flops_per_dev, hbm_bytes_per_dev) overrides the HLO
    cost_analysis numbers for scan-over-layers programs, where XLA counts
    the loop body once. The HLO-parsed
    collective bytes always come from the compiled text, with while-depth
    trip scaling."""
    per_dev_flops = float(cost.get("flops", 0.0))
    raw_bytes = float(cost.get("bytes accessed", 0.0))
    if analytic is not None:
        per_dev_flops = analytic["flops_per_dev"]
        raw_bytes = analytic["hbm_bytes_per_dev"]
    coll = collective_bytes(hlo_text, num_devices, loop_trips)
    coll_total = sum(coll.values())
    compute_s = per_dev_flops / PEAK_FLOPS
    memory_s = raw_bytes / HBM_BW
    collective_s = coll_total / LINK_BW
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, num_devices=num_devices,
        hlo_gflops=per_dev_flops / 1e9, hlo_gbytes=raw_bytes / 1e9,
        coll_gbytes=coll_total / 1e9,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_gflops=model_flops / 1e9,
        bytes_per_device=memory_bytes,
        coll_breakdown={k: round(v / 1e9, 3) for k, v in coll.items()},
    )


# ---------------------------------------------------------------------------
# Analytic per-device compute/memory terms for scan-over-layers LM programs
# ---------------------------------------------------------------------------
def analytic_lm_terms(cfg, shape, num_devices: int, n_model: int = 16,
                      n_batch_shards: Optional[int] = None) -> dict:
    """Napkin-math FLOPs and HBM bytes per device for one step.

    Conventions: params stored fp32, matmuls in bf16; remat recomputes the
    forward in the backward (trunk factor 8ND/6ND = 4/3); microbatching
    re-reads weights once per microbatch; loss CE is sequence-chunked (its
    logits traffic counted explicitly)."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    H, hd, kv = cfg.n_heads, cfg.head_dim, cfg.n_kv
    if n_batch_shards is None:
        n_batch_shards = num_devices // n_model
    tokens = shape.global_batch * shape.seq_len
    tokens_dev = tokens / n_batch_shards
    S = shape.seq_len
    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    p_local = n_total / num_devices  # FSDP: weights sharded over all chips
    mb = max(getattr(cfg, "microbatches", 1), 1)
    mb = max(min(mb, shape.global_batch // n_batch_shards), 1)

    # ---- FLOPs ----
    if shape.kind == "train":
        trunk = 8.0 * n_active * tokens          # 2 fwd + 4 bwd + 2 remat
        attn = 4.0 * 2.0 * shape.global_batch * S * S * H * hd * L / 2.0
        flops = (trunk + attn) / num_devices
        passes = 3.0 * mb                        # fwd + bwd + remat, per mb
    elif shape.kind == "prefill":
        trunk = 2.0 * n_active * tokens
        attn = 2.0 * shape.global_batch * S * S * H * hd * L  # qk+av, causal/2*2
        flops = (trunk + attn) / num_devices
        passes = 1.0
    else:  # decode
        trunk = 2.0 * n_active * shape.global_batch
        attn = 2.0 * 2.0 * shape.global_batch * S * kv * hd * L
        flops = (trunk + attn) / num_devices
        passes = 1.0

    # ---- HBM bytes ----
    w_read = p_local * 4.0 * passes              # weights re-read per pass
    if shape.kind == "train":
        opt = p_local * 4.0 * 4.0                # grad w + opt read/update
        act = 3.0 * 2.0 * tokens_dev * d * 2.0 * L / (
            n_model if getattr(cfg, "seq_shard", False) else 1.0
        )
        logits_traffic = 2.0 * tokens_dev * (V / n_model) * 4.0
        hbm = w_read + opt + act + logits_traffic
    elif shape.kind == "prefill":
        act = 2.0 * tokens_dev * d * 2.0 * L
        kv_write = 2.0 * tokens_dev * kv * hd * 2.0 * L
        hbm = w_read + act + kv_write
    else:  # decode: the whole (fully sharded) KV cache is read once per step
        kv_bytes = 2.0 * shape.global_batch * S * kv * hd * 2.0 * L / num_devices
        hbm = w_read + kv_bytes
    return {"flops_per_dev": flops, "hbm_bytes_per_dev": hbm}


def model_flops_for(arch_cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D for LM train (N=active params, D=tokens);
    2*N*D for inference; GNN/recsys analogues documented inline."""
    fam = arch_cfg.family
    if fam == "lm":
        n_active = arch_cfg.active_param_count()
        if shape.kind == "train":
            tokens = shape.global_batch * shape.seq_len
            return 6.0 * n_active * tokens
        if shape.kind == "prefill":
            tokens = shape.global_batch * shape.seq_len
            return 2.0 * n_active * tokens
        # decode: one token per sequence + attention over the KV cache
        attn = (
            2.0 * 2.0 * arch_cfg.n_layers * arch_cfg.n_kv * arch_cfg.head_dim
            * shape.seq_len * shape.global_batch
        )
        return 2.0 * n_active * shape.global_batch + attn
    if fam == "gnn":
        d = arch_cfg.d_hidden
        # message MLPs dominate: ~2 * E * (mats per layer) * d^2 per layer
        mats = {"gin": 2, "pna": 14, "egnn": 6, "nequip": 12}[arch_cfg.kind]
        if shape.kind == "minibatch":
            from repro_torch.graph.sampler import subgraph_shape

            _, e = subgraph_shape(shape.batch_nodes, tuple(shape.fanout))
        elif shape.kind == "molecule":
            e = shape.batch_graphs * shape.n_edges
        else:
            e = shape.n_edges
        fwd = 2.0 * e * mats * d * d * arch_cfg.n_layers
        return 3.0 * fwd if shape.kind != "serve" else fwd
    if fam == "recsys":
        d = arch_cfg.embed_dim
        if shape.kind == "train":
            lookup = 2.0 * shape.batch * arch_cfg.hist_len * d
            routing = (
                2.0 * shape.batch * arch_cfg.hist_len * arch_cfg.n_interests
                * d * arch_cfg.capsule_iters * 2
            )
            neg = 2.0 * shape.batch * arch_cfg.n_negatives * d
            return 3.0 * (lookup + routing + neg)
        if shape.kind == "serve":
            return 2.0 * shape.batch * (
                arch_cfg.hist_len * d
                + arch_cfg.n_interests * 64 * d
            )
        return 2.0 * shape.n_candidates * arch_cfg.n_interests * d
    raise ValueError(fam)
