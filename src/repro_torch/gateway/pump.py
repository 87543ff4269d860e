"""Engine pump: the background thread that turns a serve engine into an
async component.

``repro_torch.serve`` engines are passive — someone must call ``step()`` to
drain the batcher. In ``serve.engine.run_recsys_stream`` that someone is
the stream loop on a virtual clock; behind a real RPC front-end it is this pump: one
daemon thread per engine that continuously claims the next batch, runs
the forward, and completes it, while HTTP handler threads block only on
their *own* request's completion event (``Request.done`` — no polling, no
global barrier).

Liveness invariants (what makes the gateway hang-free):

- every submitted request reaches a terminal status: rejects resolve
  synchronously in ``submit``, sheds resolve inside ``next_batch``, served
  requests resolve in ``complete``, and a forward that *raises* resolves
  its whole batch via ``ContinuousBatcher.fail`` — the exception is
  attached to the requests instead of killing the pump;
- ``result()`` converts terminal statuses to the typed taxonomy in
  ``gateway.errors`` and enforces the caller's wait budget (``Timeout``);
- graceful drain: ``drain()`` closes admissions (new submits raise
  ``Rejected``), lets queued work finish (expired entries shed as usual),
  and ``close()`` then stops and joins the thread. Shutdown can strand
  nothing: whatever is still queued when the drain budget runs out is
  failed out explicitly.

What the pump can NOT absorb on its own — the failure mode
``gateway.supervisor.PumpSupervisor`` exists for — is the loop itself
dying: a ``next_batch`` that raises (scheduler bug, injected chaos)
escapes the forward try/except and terminates the thread. The pump
records the cause in ``crash``/``crashes`` and exits cleanly instead of
dumping a traceback, and every loop iteration stamps ``last_beat`` so a
watchdog can tell *dead* (thread gone) from *wedged* (heartbeat stale
while a batch is in flight). Restart is generation-based: ``restart()``
bumps ``generation`` and spawns a fresh thread; a wedged predecessor that
eventually unwedges notices the stale generation and exits without
touching the batcher again (terminal statuses are idempotent in
``complete``/``fail``, so a late completion of a failed-out batch is a
no-op).

On the card: the engine's ``forward`` runs on the pump thread and
launches its work on the default CUDA stream. The port's engines end
their forward in a copy to host memory (``.cpu().numpy()``), so
``complete`` only ever sees finished results. A superseded generation
may still be inside ``forward`` when its successor starts its own; no
lock keeps them apart (the JAX package has none either): the device
serialises their launches on the default stream, and each waits for its
own results. A CUDA error raised by ``forward`` (an illegal address, an
out-of-memory) is resolved like any other forward exception: the batch
fails with it, callers get a typed 500, and the breaker counts it. A
caller that must tell such an error from an injected fault reads the
error each failed request carries.
"""
from __future__ import annotations

import threading
import time
from typing import Any, List, Optional

from repro_torch.gateway.errors import GatewayError, Rejected, Timeout, error_for_status
from repro_torch.serve.scheduler import Request

# idle pumps park on this wait; submits wake them immediately via the event
_IDLE_WAIT_S = 0.005


class EnginePump:
    """Background continuous-batching loop around one serve engine.

    ``engine`` needs the ``_EngineBase`` surface: ``.batcher`` and
    ``.forward(payloads)``. The pump is started explicitly (``start()`` or
    context manager) and runs until ``close()``.
    """

    def __init__(self, engine, name: str = "engine") -> None:
        self.engine = engine
        self.name = name
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._closed = False          # admissions closed (draining/stopped)
        self._busy = False            # a claimed batch is in flight
        self._busy_since: Optional[float] = None
        self._inflight: List[Request] = []
        self._gen = 0                 # bumped by every (re)spawn
        self._gen_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        # liveness/introspection, read by the supervisor and /healthz
        self.last_beat: float = 0.0   # monotonic stamp of the last loop tick
        self.crash: Optional[BaseException] = None   # last loop-killing error
        self.crashes: int = 0         # pump-thread deaths (next_batch raised)

    # -- lifecycle -------------------------------------------------------
    def _spawn(self) -> None:
        with self._gen_lock:
            self._gen += 1
            gen = self._gen
            self.last_beat = time.monotonic()
            self._thread = threading.Thread(
                target=self._run, args=(gen,),
                name=f"pump-{self.name}-g{gen}", daemon=True)
            self._thread.start()

    def start(self) -> "EnginePump":
        if self._thread is None and not self._stop.is_set():
            self._spawn()             # idempotent: first start only
        return self

    def restart(self) -> bool:
        """Abandon the current pump thread and spawn a fresh one (the
        supervisor's recovery action). The old thread — dead, or wedged in
        a forward that may never return — sees the stale generation on its
        next loop check and exits without re-entering the batcher. Returns
        False when the pump was never started or is already closed."""
        if self._thread is None or self._stop.is_set():
            return False
        self._busy = False
        self._busy_since = None
        self._spawn()
        return True

    @property
    def started(self) -> bool:
        return self._thread is not None

    @property
    def generation(self) -> int:
        return self._gen

    def __enter__(self) -> "EnginePump":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def draining(self) -> bool:
        return self._closed

    @property
    def busy_for_s(self) -> float:
        """Seconds the current batch has been in flight (0 when idle)."""
        since = self._busy_since
        return 0.0 if since is None else time.monotonic() - since

    def _run(self, gen: int) -> None:
        batcher = self.engine.batcher
        try:
            while not self._stop.is_set() and gen == self._gen:
                self.last_beat = time.monotonic()
                # busy is raised BEFORE the claim so drain() can never observe
                # "queue empty + not busy" between next_batch and complete
                self._busy = True
                self._busy_since = time.monotonic()
                batch = batcher.next_batch()
                if not batch:
                    self._busy = False
                    self._busy_since = None
                    self._wake.wait(_IDLE_WAIT_S)
                    self._wake.clear()
                    continue
                self._inflight = batch
                try:
                    results = self.engine.forward([r.payload for r in batch])
                    batcher.complete(batch, list(results))
                except Exception as exc:   # noqa: BLE001 — resolve, don't die
                    batcher.fail(batch, exc)
                finally:
                    if gen == self._gen:   # a superseded thread must not
                        self._inflight = []          # clobber its successor's
                        self._busy = False           # liveness state
                        self._busy_since = None
        except Exception as exc:  # noqa: BLE001 — next_batch raised: the loop
            # cannot continue. Record the cause and exit; the supervisor (if
            # any) detects the death and restarts a fresh generation.
            self.crash = exc
            self.crashes += 1
            if gen == self._gen:
                self._busy = False
                self._busy_since = None

    # -- request path ----------------------------------------------------
    def submit(self, payload: Any,
               deadline_s: Optional[float] = None) -> Request:
        """Enqueue one request; raises ``Rejected`` when admissions are
        closed (draining) or the queue is full."""
        if self._closed:
            raise Rejected(f"{self.name}: draining, admissions closed")
        req = self.engine.batcher.submit(payload, deadline_s)
        if req.status == "rejected":
            raise Rejected(f"{self.name}: queue full "
                           f"({self.engine.batcher.config.max_queue})")
        self._wake.set()
        return req

    def result(self, req: Request, timeout: Optional[float] = None) -> Any:
        """Block on ``req``'s completion event; return its result or raise
        the typed error for its terminal status."""
        if not req.wait(timeout):
            raise Timeout(f"{self.name}: request {req.rid} unresolved "
                          f"after {timeout}s")
        if req.status == "done":
            return req.result
        raise error_for_status(req.status, f"{self.name}: request {req.rid} "
                                           f"{req.status} ({req.error})")

    def call(self, payload: Any, deadline_s: Optional[float] = None,
             timeout: Optional[float] = None) -> Any:
        """submit + result — the synchronous convenience used by handlers."""
        return self.result(self.submit(payload, deadline_s), timeout)

    # -- drain / shutdown ------------------------------------------------
    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Stop admissions and wait for in-flight work to finish.

        Returns True when the queue emptied and the last batch completed
        within ``timeout``; on False the caller may still ``close()`` —
        leftovers are failed out rather than stranded. A dead pump cannot
        drain its queue: bail out immediately instead of burning the whole
        budget polling a thread that will never claim again.
        """
        self._closed = True
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.engine.batcher.depth > 0 or self._busy:
            if not self.running:
                return self.engine.batcher.depth == 0 and not self._busy
            if deadline is not None and time.monotonic() > deadline:
                return False
            self._wake.set()
            time.sleep(_IDLE_WAIT_S / 5)
        return True

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Graceful shutdown: drain, stop the loop, join the thread, and
        fail out anything the drain budget left behind."""
        self.drain(timeout)
        self._stop.set()
        self._wake.set()
        if self._thread is not None:   # never-started pumps have no thread
            self._thread.join(timeout)
        # a drain timeout (or a never-started/dead pump) can leave queued
        # requests behind — resolve them so no caller hangs. Claiming via
        # next_batch keeps the shed-vs-failed distinction for expired
        # entries, but the claim path itself may be what is broken (the
        # very next_batch crash that killed the pump): fall back to
        # failing the raw queue out directly.
        exc = GatewayError("pump closed before serving")
        try:
            leftovers = self.engine.batcher.next_batch()
            while leftovers:
                self.engine.batcher.fail(leftovers, exc)
                leftovers = self.engine.batcher.next_batch()
        except Exception:  # noqa: BLE001 — close() must never raise
            pass
        self.engine.batcher.fail_all(exc)
