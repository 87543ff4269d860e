"""SSSP trials: ``repro_torch.apps.sssp`` on the weighted graph, one source a
trial. The graph is symmetric, so its in-edge CSR is its out-edge CSR and
one ``DeviceCSR`` serves. The path never launches K1: plain gathers and
``scatter_reduce_`` amin.

The sources are GAP's: vertices drawn at random, a vertex of degree 0 drawn
again, from the mix's fixed ``source_seed`` (GAP's SourcePicker seed)
among the generated vertex ids, so every run's seed has the same sources
under its own labels. Trial ``k`` starts from source ``k`` of the list,
cyclically.
"""
from __future__ import annotations

import torch

from gbench.reference import sssp as ref
from repro_torch import apps
from repro_torch.graph.csr import DeviceCSR

WEIGHTED = True
EDGE_BYTES = 8  # the target id and the weight of each edge out of an active vertex


def pick_sources(graph, count: int, seed: int) -> list[int]:
    """``count`` sources of nonzero degree, as final vertex ids."""
    dev = graph.indices.device
    degree = graph.indptr[1:] - graph.indptr[:-1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    drawn = torch.randint(0, graph.num_nodes, (64 * count,), generator=gen, device=dev)
    final = graph.final_of_orig[drawn]
    final = final[degree[final] > 0]
    if final.shape[0] < count:
        raise RuntimeError(f"only {final.shape[0]} of {64 * count} drawn vertices have edges")
    return final[:count].tolist()


class App:
    def __init__(self, graph, traffic: dict, device: torch.device):
        if graph.weights is None:
            raise ValueError("the sssp mix needs a configuration with weights")
        self.graph, self.max_iters = graph, traffic["max_iters"]
        self.warmup_iters = traffic["warmup_iters"]
        self.sources = pick_sources(graph, traffic["sources"], traffic["source_seed"])
        self.csr = DeviceCSR(indptr=graph.indptr, indices=graph.indices, dst=graph.dst,
                             weights=graph.weights, num_nodes=graph.num_nodes)

    def source(self, k: int) -> int:
        return self.sources[k % len(self.sources)]

    def describe(self) -> str:
        return f"sssp from {len(self.sources)} sources in turn, first {self.sources[:4]}"

    def warm_up(self) -> None:
        apps.sssp(self.csr, self.source(0), self.warmup_iters)

    def trial(self, k: int, stats: dict) -> torch.Tensor:
        return apps.sssp(self.csr, self.source(k), self.max_iters, stats=stats)

    def _reference(self, k: int, dtype):
        g = self.graph
        return ref.sssp(g.indptr, g.indices, g.dst, g.weights, self.source(k), dtype=dtype)

    def control(self, k: int, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return self._reference(k, dtype)[0].to(torch.float32)

    def references(self, ks) -> dict:
        return {k: self._reference(k, torch.int64) for k in ks}

    def compare(self, answer: torch.Tensor, reference) -> dict:
        want = reference[0]
        unreached = want == torch.iinfo(want.dtype).max
        want = torch.where(unreached, float("inf"), want.to(torch.float64))
        got = answer.to(want.device, torch.float64)
        return {"dist_mismatches": int((got != want).sum())}
