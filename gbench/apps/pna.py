"""PNA inference trials: ``repro_torch.nn.gnn.apply`` on the whole graph, the
port's GNN forward, with the mix's model (``traffic/pna.json``). The batch
is the graph's destination-sorted CSR, so the port takes its blocked layer:
blocks of whole destination rows, each gathering its edges' source rows
through K1. One trial is one whole forward (``n_layers`` layers, the count
in ``stats["iters"]``) to the node logits.

The features and weights are drawn on the device from a generator seeded
by the run's first vertex labels (the App is handed the graph, whose
labels the run's seed permutes), so a seed gives the same inputs. Every
trial computes the same logits, so one reference run serves every checked
trial.
"""
from __future__ import annotations

import math

import torch

from gbench.reference import pna as ref
from repro_torch.configs.base import GNNConfig
from repro_torch.core.plan import make_plan
from repro_torch.nn import gnn

WEIGHTED = False
EDGE_BYTES = 4  # the source id of each edge; the rows it gathers are counted by pna_gather_roofline


def input_seed(graph) -> int:
    """A seed from the first three vertex labels the run's seed drew."""
    a, b, c = graph.final_of_orig[:3].tolist()
    n = graph.num_nodes
    return ((a * n + b) * n + c) % (1 << 63)


def draw(traffic: dict, n: int, gen: torch.Generator):
    """``(x, params)``: (n, d_feat) features and the weights in
    ``nn.gnn``'s layout, drawn from ``gen`` on its device."""
    dev = gen.device

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def dense(d_in, d_out):
        return {"w": normal(d_in, d_out, scale=1 / math.sqrt(d_in))}

    d, n_agg = traffic["d_hidden"], len(traffic["aggregators"]) * len(traffic["scalers"])
    x = normal(n, traffic["d_feat"])
    layers = []
    for i in range(traffic["n_layers"]):
        d_in = traffic["d_feat"] if i == 0 else d
        layers.append({"pre": [dense(2 * d_in, d)],
                       "post": [dense(n_agg * d + d_in, d), dense(d, d)],
                       "ln": {"g": 1 + normal(d, scale=0.1), "b": normal(d, scale=0.1)}})
    return x, {"layers": layers, "out": dense(d, traffic["d_out"])}


class App:
    def __init__(self, graph, traffic: dict, device: torch.device):
        self.graph, self.t = graph, traffic
        self.cfg = GNNConfig(name="pna", kind="pna", n_layers=traffic["n_layers"],
                             d_hidden=traffic["d_hidden"], d_out=traffic["d_out"],
                             aggregators=tuple(traffic["aggregators"]),
                             scalers=tuple(traffic["scalers"]), grasp=True)
        gen = torch.Generator(device=device).manual_seed(input_seed(graph))
        self.x, self.params = draw(traffic, graph.num_nodes, gen)
        # δ for the reference; the program takes the same graph's own
        deg = (graph.indptr[1:] - graph.indptr[:-1]).to(torch.float64)
        self.delta = float(torch.log1p(deg).mean())
        self.batch = {"x": self.x, "indptr": graph.indptr, "src": graph.indices,
                      "dst": graph.dst}

    def describe(self) -> str:
        n, src = self.graph.num_nodes, self.graph.indices
        hot = {w: make_plan(n, 4 * w).hot_size for w in (self.t["d_feat"], self.t["d_hidden"])}
        share = {w: int((src < h).sum()) / max(src.shape[0], 1) for w, h in hot.items()}
        budget = getattr(gnn, "BLOCK_EDGES", None)  # the program's own choice, printed only
        blocks = (f"; blocks of at most {budget} edges, "
                  f"{len(gnn.pna_blocks(self.graph.indptr, budget))} a layer" if budget else "")
        return (f"pna forward, {self.cfg.n_layers} layers, d {self.t['d_feat']} -> "
                f"{self.cfg.d_hidden} -> {self.cfg.d_out}, delta {self.delta:.6f}; K1 hot_size "
                + ", ".join(f"{h} at d {w} (share of gathers {share[w]:.6f})"
                            for w, h in hot.items())
                + blocks)

    def _forward(self) -> torch.Tensor:
        with torch.no_grad():
            return gnn.apply(self.params, self.cfg, self.batch)

    def warm_up(self) -> None:
        self._forward()

    def trial(self, k: int, stats: dict) -> torch.Tensor:
        out = self._forward()
        stats["iters"] = self.cfg.n_layers
        return out

    def _reference(self, dtype):
        g = self.graph
        return ref.pna_forward(self.params, self.x, g.indptr, g.indices, self.delta,
                               self.cfg.aggregators, self.cfg.scalers, dtype=dtype)

    def control(self, k: int, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return self._reference(dtype).to(torch.float32)

    def references(self, ks) -> dict:
        answer = self._reference(torch.float64)
        return {k: (answer, None) for k in ks}

    def compare(self, answer: torch.Tensor, reference) -> dict:
        want = reference[0]
        got = answer.to(want.device, torch.float64)
        rms = float(want.pow(2).mean().sqrt())
        err = torch.nan_to_num((got - want).abs(), nan=float("inf")).max()
        # a NaN logit is as wrong as can be
        return {"logit_err": float(err) / rms}
