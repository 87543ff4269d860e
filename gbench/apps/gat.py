"""GAT inference trials: ``repro_torch.nn.gnn.apply`` on the whole graph, the
port's GNN forward, with the mix's model (``traffic/gat.json``). The batch
is the graph's destination-sorted CSR, so the port takes its inference
route: each layer one matrix product for its rows, scores and skip, and one
attention pass over the in-edges and self loops. One trial is one whole
forward (``n_layers`` layers, the count in ``stats["iters"]``) to the node
logits.

The features and weights are drawn on the device from a generator seeded
by the run's first vertex labels, as the ``pna`` app draws them, so a seed
gives the same inputs. Every trial computes the same logits, so one
reference run serves every checked trial.
"""
from __future__ import annotations

import math

import torch

from gbench.apps.pna import input_seed
from gbench.reference import gat as ref
from repro_torch.configs.gat import GATConfig
from repro_torch.core.plan import make_plan
from repro_torch.nn import gnn

WEIGHTED = False
EDGE_BYTES = 4  # the source id of each edge; its rows are counted by gat_attend_roofline


def widths(traffic: dict) -> list:
    """``[(d_in, heads × channels, output width)]`` a layer."""
    h, out, d_in = traffic["heads"], [], traffic["d_feat"]
    for i in range(traffic["n_layers"]):
        last = i == traffic["n_layers"] - 1
        c = traffic["d_out"] if last else traffic["d_head"]
        out.append((d_in, h * c, c if last else h * c))
        d_in = out[-1][2]
    return out


def draw(traffic: dict, n: int, gen: torch.Generator):
    """``(x, params)``: (n, d_feat) features and the weights in
    ``nn.gnn``'s GAT layout, drawn from ``gen`` on its device."""
    dev = gen.device

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    heads = traffic["heads"]
    x = normal(n, traffic["d_feat"])
    layers = []
    for d_in, width, d_next in widths(traffic):
        c = width // heads
        layers.append({"lin": {"w": normal(d_in, width, scale=1 / math.sqrt(d_in))},
                       "att_src": normal(heads, c, scale=1 / math.sqrt(c)),
                       "att_dst": normal(heads, c, scale=1 / math.sqrt(c)),
                       "bias": normal(d_next, scale=0.1),
                       "skip": {"w": normal(d_in, d_next, scale=1 / math.sqrt(d_in)),
                                "b": normal(d_next, scale=0.1)}})
    return x, {"layers": layers}


class App:
    def __init__(self, graph, traffic: dict, device: torch.device):
        self.graph, self.t = graph, traffic
        self.cfg = GATConfig(n_layers=traffic["n_layers"], heads=traffic["heads"],
                             d_head=traffic["d_head"], d_out=traffic["d_out"],
                             negative_slope=traffic["negative_slope"],
                             self_loops=traffic["self_loops"], grasp=True)
        gen = torch.Generator(device=device).manual_seed(input_seed(graph))
        self.x, self.params = draw(traffic, graph.num_nodes, gen)
        self.batch = {"x": self.x, "indptr": graph.indptr, "src": graph.indices}

    def describe(self) -> str:
        n, src = self.graph.num_nodes, self.graph.indices
        items = src.shape[0] + n  # the in-edges and a self loop a row
        parts = []
        for width in sorted({w for _, w, _ in widths(self.t)}, reverse=True):
            hot = make_plan(n, 4 * width).hot_size
            share = (int((src < hot).sum()) + hot) / items
            parts.append(f"{hot} at {4 * width} B (share of row reads {share:.6f})")
        return (f"gat forward, {self.cfg.n_layers} layers of {self.cfg.heads} heads, d "
                f"{self.t['d_feat']} -> {self.cfg.heads}x{self.cfg.d_head} -> "
                f"{self.cfg.d_out}; hot rows " + ", ".join(parts))

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
        return ref.gat_forward(self.params, self.x, g.indptr, g.indices,
                               self.cfg.negative_slope, dtype=dtype)

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
