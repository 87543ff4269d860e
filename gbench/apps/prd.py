"""PageRank-Delta trials: ``repro_torch.apps.pagerank_delta`` with the mix's
parameters, the GRASP route (each iteration one two-tier K1 gather and an
``index_add_``). Every trial computes the same ranks, so one reference run
serves every checked trial."""
from __future__ import annotations

import torch

from gbench.reference import prd as ref
from repro_torch import apps
from repro_torch.graph.csr import DeviceCSR

WEIGHTED = False
EDGE_BYTES = 4  # the source id of each edge out of an active vertex


class App:
    def __init__(self, graph, traffic: dict, device: torch.device):
        self.graph, self.p = graph, traffic["params"]
        self.warmup_iters = traffic["warmup_iters"]
        self.csr = DeviceCSR(indptr=graph.indptr, indices=graph.indices, dst=graph.dst,
                             weights=None, num_nodes=graph.num_nodes)

    def describe(self) -> str:
        return (f"pagerank_delta(damping={self.p['damping']}, epsilon={self.p['epsilon']}, "
                f"max_iters={self.p['max_iters']})")

    def warm_up(self) -> None:
        apps.pagerank_delta(self.csr, self.p["damping"], self.p["epsilon"], self.warmup_iters)

    def trial(self, k: int, stats: dict) -> torch.Tensor:
        return apps.pagerank_delta(self.csr, self.p["damping"], self.p["epsilon"],
                                   self.p["max_iters"], stats=stats)

    def _reference(self, dtype):
        g = self.graph
        return ref.pagerank_delta(g.indptr, g.indices, g.dst, self.p["damping"],
                                  self.p["epsilon"], self.p["max_iters"], dtype=dtype)

    def control(self, k: int, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return self._reference(dtype)[0].to(torch.float32)

    def references(self, ks) -> dict:
        answer = self._reference(torch.float64)
        return {k: answer for k in ks}

    def compare(self, answer: torch.Tensor, reference) -> dict:
        want = reference[0]
        got = answer.to(want.device, torch.float64)
        rel = (got - want).abs() / want.abs()
        # a NaN (or a rank that is not finite) is as wrong as can be
        return {"rank_max_rel": float(torch.nan_to_num(rel, nan=float("inf")).max())}
