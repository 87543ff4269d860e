"""repro_torch.chaos — deterministic fault injection for the serving stack.

``inject`` wraps a serve engine (forward exceptions, latency spikes,
``next_batch`` pump crashes) and the gateway client (connection resets)
behind a seeded, replayable ``FaultSchedule``: every injection decision
is a pure function of ``(seed, fault kind, call index)``, so the same
schedule driven through the same workload produces an identical
``InjectionLog``. The decision function and its kind numbering are the
JAX package's, so a seed fires the same faults in both packages.
``chip_smoke.py``'s phase 13 drives it over the recsys engine on the card.
"""
from repro_torch.chaos.inject import (
    ChaosClient,
    ChaosEngine,
    FaultSchedule,
    FaultSpec,
    InjectedFault,
    InjectionLog,
)

__all__ = [
    "ChaosClient",
    "ChaosEngine",
    "FaultSchedule",
    "FaultSpec",
    "InjectedFault",
    "InjectionLog",
]
