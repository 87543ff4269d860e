"""GRASP core: the paper's contribution.

hotset  — hot-vertex identification (Table I statistics)
reorder — skew-aware reordering (Sort / HubSort / DBG / Gorder-lite)
regions — ABR interface + High/Moderate/Low classification (Sec. III-A/B)
plan    — GraspPlan, the residency plan sized from the L2
policies/cachesim — LLC replacement policies + trace-driven simulator
"""
from repro_torch.core.hotset import hot_mask, skew_stats, reuse_degree  # noqa: F401
from repro_torch.core.reorder import reorder_ranks, TECHNIQUES  # noqa: F401
from repro_torch.core.regions import make_regions, HIGH, MODERATE, LOW, DEFAULT  # noqa: F401
from repro_torch.core.plan import GraspPlan, make_plan  # noqa: F401
