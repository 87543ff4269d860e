"""Vertex-centric graph applications (paper Table III)."""
from repro_torch.apps.engine import edge_map_pull, edge_map_push, EngineConfig  # noqa: F401
from repro_torch.apps.pagerank import pagerank  # noqa: F401
from repro_torch.apps.prdelta import pagerank_delta  # noqa: F401
from repro_torch.apps.sssp import sssp  # noqa: F401
from repro_torch.apps.bc import bc_single_source  # noqa: F401
from repro_torch.apps.radii import radii_estimate  # noqa: F401
