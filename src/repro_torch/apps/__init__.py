"""Vertex-centric graph applications (paper Table III). Ported so far:
the engine and PageRank."""
from repro_torch.apps.engine import edge_map_pull, edge_map_push, EngineConfig  # noqa: F401
from repro_torch.apps.pagerank import pagerank  # noqa: F401
