"""Jittered exponential backoff — ONE retry-pacing policy for the fleet.

Counterpart of ``lux_tpu.utils.backoff`` (a copy: the port imports
nothing of the reference; one seed draws the same delays in both).

Before this module every retry loop in the serving stack paced itself
ad hoc: fixed ``time.sleep`` polls in the worker's drain loop, a bare
reconnect-and-hope in the bench clients, and no reconnect story at all
for controller failover.  Fixed sleeps synchronize: when a controller
dies, every client and every rejoining worker that sleeps exactly
``0.1 * attempt`` retries in lockstep and thunders the promoted
controller.  The standard fix (AWS architecture blog's "full jitter")
is to draw each delay uniformly from ``[0, min(cap, base * factor^n)]``
— decorrelated retries, same expected wait.

Everything is explicitly seeded (``random.Random(seed)`` per instance —
no process-global RNG), so a fault drill that logs its seed
replays the exact same pacing.

Knobs (read at construction, named in errors):

* ``LUX_BACKOFF_BASE_MS`` — first-retry ceiling (default 25 ms)
* ``LUX_BACKOFF_CAP_MS``  — per-retry ceiling (default 2000 ms)
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

from lux_tpu_torch.utils.config import env_float


class Backoff:
    """Full-jitter exponential backoff schedule.

    ``next_s()`` returns the next delay (seconds) and advances the
    attempt counter; ``sleep()`` draws and sleeps it.  ``reset()``
    returns to attempt 0 (call after a success so the NEXT failure
    starts cheap again).  Instances are not thread-safe — each retry
    loop owns its own (sharing one would couple unrelated schedules).
    """

    def __init__(self, base_ms: Optional[float] = None,
                 cap_ms: Optional[float] = None,
                 factor: float = 2.0, seed: int = 0):
        self.base_ms = float(
            env_float("LUX_BACKOFF_BASE_MS", 25.0, minimum=0.0)
            if base_ms is None else base_ms)
        self.cap_ms = float(
            env_float("LUX_BACKOFF_CAP_MS", 2000.0, minimum=0.0)
            if cap_ms is None else cap_ms)
        self.factor = float(factor)
        self._rng = random.Random(seed)
        self.attempt = 0

    def next_s(self) -> float:
        # exponent clamped: factor ** attempt overflows float past
        # ~1024 attempts (a long poll_until easily gets there), and by
        # 64 doublings the cap has won for ANY sane base/cap pair
        ceil_ms = min(self.cap_ms,
                      self.base_ms * (self.factor ** min(self.attempt, 64)))
        self.attempt += 1
        return self._rng.uniform(0.0, ceil_ms) / 1e3

    def sleep(self, floor_s: float = 0.0) -> float:
        """Sleep the next jittered delay (at least ``floor_s`` — pass a
        server's ``retry_after_ms`` hint here so the hint is honored and
        the jitter only ever ADDS decorrelation).  Returns the slept
        seconds."""
        d = max(self.next_s(), float(floor_s))
        if d > 0:
            time.sleep(d)
        return d

    def reset(self) -> None:
        self.attempt = 0


def retry_call(fn: Callable, *, retry_on: Tuple[Type[BaseException], ...],
               deadline_s: float, backoff: Optional[Backoff] = None,
               on_retry: Optional[Callable] = None):
    """Call ``fn()`` until it succeeds, an exception outside
    ``retry_on`` escapes, or ``deadline_s`` of wall time elapses (the
    LAST error re-raises at the deadline — never a synthetic one).
    A ``retry_after_ms`` attribute on the caught error (the fleet's
    shed hint) floors the jittered delay.  ``on_retry(exc, attempt)``
    observes each retry (counters)."""
    bo = backoff if backoff is not None else Backoff()
    deadline = time.monotonic() + float(deadline_s)
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            if on_retry is not None:
                on_retry(e, attempt)
            floor_s = float(getattr(e, "retry_after_ms", 0.0) or 0.0) / 1e3
            if time.monotonic() + floor_s >= deadline:
                raise
            bo.sleep(floor_s=floor_s)


def poll_until(pred: Callable[[], bool], timeout_s: float,
               base_ms: float = 2.0, cap_ms: float = 50.0,
               seed: int = 0) -> bool:
    """Poll ``pred`` with jittered growing intervals until it returns
    True or ``timeout_s`` elapses — the replacement for the fixed
    ``while: sleep(0.01)`` drain loops (fast first checks, backed-off
    tail).  Returns the final predicate value."""
    bo = Backoff(base_ms=base_ms, cap_ms=cap_ms, seed=seed)
    deadline = time.monotonic() + float(timeout_s)
    while True:
        if pred():
            return True
        if time.monotonic() >= deadline:
            return bool(pred())
        bo.sleep()
