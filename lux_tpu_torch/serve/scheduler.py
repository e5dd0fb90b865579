"""Dynamic micro-batching scheduler: the admission path between raw
requests and the warm batched engines.

Counterpart of ``lux_tpu.serve.scheduler``.  Pure-Python policy,
explicitly pumpable for tests (``step(now=...)`` with an injected clock)
and runnable as a background thread for a live service.  The policy:

  * **Coalesce** — pending requests accumulate until either the largest
    warm Q bucket fills or the oldest request has waited ``max_wait_ms``;
    then the batch dispatches into the smallest warm bucket that covers
    the pending count, padded with a repeat of the first query (padding
    answers are computed and discarded).
  * **Deadlines** — a request may carry ``timeout_ms``; a request whose
    deadline passes while queued resolves with ServeTimeoutError at the
    next pump, never hangs.  ``ServeFuture.result(timeout=...)`` takes
    an independent wall guard.
  * **Backpressure** — the queue is bounded; a submit beyond
    ``max_queue`` raises RejectedError carrying ``retry_after_ms``
    (estimated from the recent batch service time and the depth).
  * **Cold degradation** — when no warm engine exists for the app, the
    scheduler degrades to Q=1: it warms the cheapest engine shape once
    and serves requests singly rather than paying a large bucket's first
    launches on the request path.

The pump thread and the submitting threads share one CUDA stream: only
the pump touches the card (submit is host bookkeeping), and an engine's
answers reach the host after the batch completes (BatchedEngine.run).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

from lux_tpu_torch.serve.metrics import ServeMetrics
from lux_tpu_torch.serve.warm import WarmEngineCache


class ServeTimeoutError(TimeoutError):
    """The request's deadline expired before an answer was produced."""


class RejectedError(RuntimeError):
    """Bounded-queue backpressure: retry after ``retry_after_ms``."""

    def __init__(self, retry_after_ms: float):
        super().__init__(f"queue full; retry after {retry_after_ms:.0f} ms")
        self.retry_after_ms = retry_after_ms


@dataclasses.dataclass
class _Request:
    query: int
    enqueue_t: float
    deadline_t: Optional[float]
    event: threading.Event
    result: object = None
    error: Optional[BaseException] = None
    traversed: int = 0
    rounds: int = 0
    #: mutation generation of the overlay the answering batch ran with
    #: (None: the cache serves no overlay)
    generation: Optional[int] = None


class ServeFuture:
    """Handle to one submitted query."""

    def __init__(self, req: _Request):
        self._req = req

    def done(self) -> bool:
        return self._req.event.is_set()

    def result(self, timeout: Optional[float] = None):
        """The (nv,) answer vector; raises ServeTimeoutError on deadline
        expiry, or after ``timeout`` wall seconds without a resolution
        (``None`` blocks)."""
        if not self._req.event.wait(timeout):
            raise ServeTimeoutError("no result within wait timeout")
        if self._req.error is not None:
            raise self._req.error
        return self._req.result

    @property
    def traversed_edges(self) -> int:
        return self._req.traversed

    @property
    def rounds(self) -> int:
        return self._req.rounds

    @property
    def generation(self) -> Optional[int]:
        """Mutation generation the answer reflects (a LOWER bound: the
        overlay installed at dispatch)."""
        return self._req.generation


class MicroBatchScheduler:
    def __init__(self, cache: WarmEngineCache, app: str = "sssp",
                 max_wait_ms: float = 5.0, max_queue: int = 256,
                 default_timeout_ms: float = 0.0, clock=time.monotonic,
                 metrics: Optional[ServeMetrics] = None):
        self.cache = cache
        self.app = app
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.default_timeout_ms = float(default_timeout_ms)
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self._clock = clock
        self._queue: List[_Request] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._last_service_s = 0.0

    # -- admission -------------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def _retry_after_ms(self, depth: int) -> float:
        """Backpressure hint: the recent batch service time scaled by the
        backlog in max buckets, floored at one coalescing window."""
        per_batch = max(self._last_service_s * 1e3, self.max_wait_ms)
        buckets = max(depth // max(self._max_bucket(), 1), 1)
        return per_batch * buckets

    def submit(self, query: int, timeout_ms: Optional[float] = None) -> ServeFuture:
        now = self._clock()
        t = self.default_timeout_ms if timeout_ms is None else float(timeout_ms)
        deadline = now + t / 1e3 if t > 0 else None
        req = _Request(query=int(query), enqueue_t=now, deadline_t=deadline,
                       event=threading.Event())
        with self._wake:
            if len(self._queue) >= self.max_queue:
                self.metrics.record_rejected()
                raise RejectedError(self._retry_after_ms(len(self._queue)))
            self._queue.append(req)
            self.metrics.sample_queue_depth(len(self._queue))
            self._wake.notify()
        return ServeFuture(req)

    # -- batching policy -------------------------------------------------

    def _max_bucket(self) -> int:
        warm = self.cache.warm_buckets(self.app)
        return max(warm) if warm else 1

    def _pick_bucket(self, n: int) -> tuple:
        """(q, warm): the smallest warm bucket covering ``n`` real
        queries; the largest warm bucket when n overflows them all;
        (1, False), the cold Q=1 degradation, when nothing is warm."""
        warm = self.cache.warm_buckets(self.app)
        if not warm:
            return 1, False
        for q in warm:
            if q >= n:
                return q, True
        return max(warm), True

    def _expire(self, now: float) -> int:
        """Resolve queued requests whose deadline passed; returns count."""
        expired, kept = [], []
        with self._lock:
            for r in self._queue:
                (expired if r.deadline_t is not None and now >= r.deadline_t
                 else kept).append(r)
            self._queue = kept
        for r in expired:
            r.error = ServeTimeoutError(
                f"deadline expired after {(now - r.enqueue_t) * 1e3:.1f} ms in queue")
            self.metrics.record_timeout()
            r.event.set()
        return len(expired)

    def _ready(self, now: float) -> bool:
        with self._lock:
            if not self._queue:
                return False
            if len(self._queue) >= self._max_bucket():
                return True
            oldest = self._queue[0].enqueue_t
            # dispatch early when waiting out the window would blow a
            # queued deadline
            tightest = min((r.deadline_t for r in self._queue
                            if r.deadline_t is not None), default=None)
            if tightest is not None and tightest <= now + self.max_wait_ms / 1e3:
                return True
            return (now - oldest) * 1e3 >= self.max_wait_ms

    def _take(self, n: int) -> List[_Request]:
        with self._lock:
            batch, self._queue = self._queue[:n], self._queue[n:]
        return batch

    # -- dispatch --------------------------------------------------------

    def step(self, now: Optional[float] = None) -> int:
        """One pump: expire deadlines, then dispatch at most one batch.
        Returns the number of requests RESOLVED (answers + timeouts)."""
        now = self._clock() if now is None else now
        resolved = self._expire(now)
        if not self._ready(now):
            return resolved
        q, warm_bucket = self._pick_bucket(self.pending())
        batch = self._take(q)
        if not batch:
            return resolved
        queries = [r.query for r in batch]
        queries = queries + [queries[0]] * (q - len(queries))
        t0 = self._clock()
        try:
            # one read of self.cache for the whole dispatch, and one atomic
            # read of its overlay: the generation tag is the overlay this
            # batch runs with (a lower bound under a racing install)
            cache = self.cache
            engine, was_warm = cache.get(self.app, q)
            overlay = cache.current_overlay()
            if overlay is None:
                out = engine.run(queries)
                gen = None
            else:
                gen, oarr, deg = overlay
                out = engine.run(queries, oarrays=oarr, degree=deg)
        except Exception as e:  # noqa: BLE001 - a failed batch must resolve
            # its requests (a hung future is worse than any error)
            for r in batch:
                r.error = e
                r.event.set()
            return resolved + len(batch)
        service_s = self._clock() - t0
        with self._lock:
            self._last_service_s = service_s  # read by submitters
        self.metrics.record_batch(q=q, real=len(batch), warm=warm_bucket and was_warm,
                                  service_s=service_s)
        done_t = self._clock()
        for i, r in enumerate(batch):
            r.result = out.query_state(i)
            r.traversed = out.traversed[i]
            r.rounds = int(out.rounds[i])
            r.generation = gen
            self.metrics.record_done(latency_s=done_t - r.enqueue_t,
                                     wait_s=t0 - r.enqueue_t,
                                     traversed=out.traversed[i])
            r.event.set()
        return resolved + len(batch)

    def drain(self, max_steps: int = 10_000) -> int:
        """Pump until the queue is empty; returns requests resolved.  An
        idle pump (the queue waiting out the coalescing window) sleeps a
        quarter-window instead of spinning."""
        total = 0
        for _ in range(max_steps):
            if not self.pending():
                break
            did = self.step()
            total += did
            if not did and self.pending():
                time.sleep(max(self.max_wait_ms / 4e3, 1e-4))
        return total

    # -- background service loop -----------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._running = True

        def loop():
            while self._running:
                if self.step():
                    continue
                with self._wake:
                    if not self._queue and self._running:
                        self._wake.wait(timeout=self.max_wait_ms / 1e3)
                if self._queue:
                    # the coalescing deadline is observed to ~1/4 window
                    time.sleep(self.max_wait_ms / 4e3)

        self._thread = threading.Thread(target=loop, name="lux-serve-scheduler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True):
        if drain:
            self.drain()
        self._running = False
        with self._wake:
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
