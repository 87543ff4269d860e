"""DeeperGCN inference trials: ``repro_torch.nn.gnn.apply`` on the whole graph,
the port's GNN forward, with the mix's model (``traffic/deepergcn.json``).
The batch is the graph's destination-sorted CSR, so the port takes its
inference route: each layer a pre-activation, one softmax-aggregation pass
over the in-edges and self loops, and one matrix product into the residual
stream. One trial is one whole forward (``n_layers`` layers, the count in
``stats["iters"]``) to the node logits.

The features and weights are drawn on the device from a generator seeded
by the run's first vertex labels, as the ``pna`` app draws them, so a seed
gives the same inputs. The norms' running means and variances are not
drawn: at set-up one forward of the float64 reference fits each to the
stream it normalises, as a trained model's are fitted to its activations,
so that each layer's input stays near unit scale. That forward's logits are
the check's answer: every trial computes the same logits, so it serves
every checked trial.
"""
from __future__ import annotations

import math

import torch

from gbench.apps.pna import input_seed
from gbench.reference import deepergcn as ref
from repro_torch.configs.deepergcn import DeeperGCNConfig
from repro_torch.core.plan import make_plan
from repro_torch.nn import gnn

WEIGHTED = False
EDGE_BYTES = 4  # the source id of each edge; its rows are counted by deepergcn_aggr_roofline


def draw(traffic: dict, n: int, gen: torch.Generator):
    """``(x, params)``: (n, d_feat) features and the weights in
    ``nn.gnn``'s DeeperGCN layout, drawn from ``gen`` on its device, with
    the norms' running statistics left to fit (``None``)."""
    dev = gen.device

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def linear(d_in, d_out):
        return {"w": normal(d_in, d_out, scale=1 / math.sqrt(d_in)), "b": normal(d_out, scale=0.1)}

    d = traffic["d_hidden"]
    x = normal(n, traffic["d_feat"])
    enc = linear(traffic["d_feat"], d)
    layers = [linear(d, d) for _ in range(traffic["n_layers"])]
    norms = [{"g": 1 + normal(d, scale=0.1), "b": normal(d, scale=0.1)}
             for _ in range(traffic["n_layers"])]
    return x, {"enc": enc, "layers": layers, "norms": norms,
               "stats": [None] * traffic["n_layers"], "out": linear(d, traffic["d_out"])}


class App:
    def __init__(self, graph, traffic: dict, device: torch.device):
        self.graph, self.t = graph, traffic
        self.cfg = DeeperGCNConfig(n_layers=traffic["n_layers"], d_hidden=traffic["d_hidden"],
                                   d_out=traffic["d_out"], t=traffic["t"], eps=traffic["eps"],
                                   bn_eps=traffic["bn_eps"])
        gen = torch.Generator(device=device).manual_seed(input_seed(graph))
        self.x, self.params = draw(traffic, graph.num_nodes, gen)
        self.answer = self._reference(torch.float64, fit_stats=True).cpu()
        self.batch = {"x": self.x, "indptr": graph.indptr, "src": graph.indices}

    def describe(self) -> str:
        n, src = self.graph.num_nodes, self.graph.indices
        hot = make_plan(n, 4 * self.cfg.d_hidden).hot_size
        share = (int((src < hot).sum()) + hot) / (src.shape[0] + n)  # in-edges and self loops
        return (f"deepergcn forward, {self.cfg.n_layers} layers, d {self.t['d_feat']} -> "
                f"{self.cfg.d_hidden} -> {self.cfg.d_out}, t {self.cfg.t}; hot rows {hot} at "
                f"{4 * self.cfg.d_hidden} B (share of row reads {share:.6f})")

    def _forward(self) -> torch.Tensor:
        with torch.no_grad():
            return gnn.apply(self.params, self.cfg, self.batch)

    def warm_up(self) -> None:
        self._forward()

    def trial(self, k: int, stats: dict) -> torch.Tensor:
        out = self._forward()
        stats["iters"] = self.cfg.n_layers
        return out

    def _reference(self, dtype, fit_stats=False):
        g, c = self.graph, self.cfg
        return ref.deepergcn_forward(self.params, self.x, g.indptr, g.indices, c.t, c.eps,
                                     c.bn_eps, dtype=dtype, fit_stats=fit_stats)

    def control(self, k: int, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return self._reference(dtype).to(torch.float32)

    def references(self, ks) -> dict:
        return {k: (self.answer, None) for k in ks}

    def compare(self, answer: torch.Tensor, reference) -> dict:
        want = reference[0]
        got = answer.to(want.device, torch.float64)
        rms = float(want.pow(2).mean().sqrt())
        err = torch.nan_to_num((got - want).abs(), nan=float("inf")).max()
        # a NaN logit is as wrong as can be
        return {"logit_err": float(err) / rms}
