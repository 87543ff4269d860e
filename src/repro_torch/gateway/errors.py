"""Gateway error taxonomy, shared by pump, server, and client.

Each terminal ``Request`` status that is not ``done`` maps to exactly one
exception type, and each type maps to one HTTP status on the wire, so the
client can reconstruct server-side outcomes without parsing prose:

  ========== ===================================== ===========
  exception  meaning                               HTTP status
  ========== ===================================== ===========
  Rejected   admission control: queue full, or the 503
             server is draining — backpressure,
             retryable after backoff
  Shed       admitted but its deadline expired in  503
             queue — retryable (a retry re-enters
             with a fresh deadline)
  Unavailable the route's circuit breaker is open  503
             (persistent engine faults) or its
             pump is crash-looping — retryable
             after the breaker's cooldown
  Timeout    the caller's wait/deadline elapsed    504
             before the request resolved
  Failed     the engine forward raised — not       500
             retryable by default
  ========== ===================================== ===========

All 503 flavours are *transient*: the client's bounded exponential
backoff retries them. ``retry_after_s`` carries the server's Retry-After
hint when one was given (for ``Unavailable`` it is the breaker's
remaining cooldown — retrying sooner is guaranteed to shed again).
"""
from __future__ import annotations

from typing import Optional


class GatewayError(Exception):
    """Base class for every gateway-side request failure."""

    http_status = 500
    kind = "error"

    def __init__(self, message: str = "",
                 retry_after_s: Optional[float] = None) -> None:
        super().__init__(message or self.kind)
        self.retry_after_s = retry_after_s


class Rejected(GatewayError):
    """Admission control turned the request away (queue full / draining)."""

    http_status = 503
    kind = "rejected"


class Shed(GatewayError):
    """Admitted, but shed in queue when its deadline expired."""

    http_status = 503
    kind = "shed"


class Unavailable(GatewayError):
    """The route is shedding fast: circuit breaker open after persistent
    engine faults, or the pump is crash-looping beyond its restart budget."""

    http_status = 503
    kind = "unavailable"


class Timeout(GatewayError):
    """The caller's wait budget elapsed before the request resolved."""

    http_status = 504
    kind = "timeout"


class Failed(GatewayError):
    """The engine forward raised while serving this request's batch."""

    http_status = 500
    kind = "failed"


_BY_KIND = {c.kind: c for c in (Rejected, Shed, Unavailable, Timeout, Failed)}


def error_for_status(status: str, message: str = "",
                     retry_after_s: Optional[float] = None) -> GatewayError:
    """Map a terminal ``Request.status`` / wire ``error`` kind to its
    exception (unknown kinds degrade to the ``GatewayError`` base)."""
    cls = _BY_KIND.get(status, GatewayError)
    return cls(message or status, retry_after_s=retry_after_s)
