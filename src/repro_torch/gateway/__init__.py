"""repro_torch.gateway — async RPC serving front-end for the repro_torch.serve tier.

``pump`` runs one background thread per engine that continuously drains
the continuous batcher; ``supervisor`` is the watchdog that detects
dead/wedged pump threads and restarts them with backoff; ``breaker`` is
the per-route circuit breaker that sheds a persistently failing engine
fast; ``server`` is the stdlib ThreadingHTTPServer JSON-RPC front-end
(``/v1/generate``, ``/v1/score``, ``/healthz``, ``/metrics``) with
idempotency-key dedupe and warm-restart cache snapshots; ``client`` is
the urllib client with typed errors and bounded-backoff retries on 503;
``errors`` is the shared taxonomy. The modules are host Python (stdlib
threads, ``http.server``, ``urllib``, numpy); the card enters only
through an engine's ``forward``, which runs on the pump thread. The
kinds, HTTP codes, routes and wire format are the JAX package's, so
either package's client talks to the other's server.
"""
from repro_torch.gateway.breaker import CircuitBreaker
from repro_torch.gateway.client import GatewayClient
from repro_torch.gateway.errors import (
    Failed,
    GatewayError,
    Rejected,
    Shed,
    Timeout,
    Unavailable,
    error_for_status,
)
from repro_torch.gateway.pump import EnginePump
from repro_torch.gateway.server import GatewayServer, IdempotencyCache
from repro_torch.gateway.supervisor import PumpSupervisor

__all__ = [
    "EnginePump",
    "PumpSupervisor",
    "CircuitBreaker",
    "GatewayServer",
    "IdempotencyCache",
    "GatewayClient",
    "GatewayError",
    "Rejected",
    "Shed",
    "Unavailable",
    "Timeout",
    "Failed",
    "error_for_status",
]
