"""Standing-query subscriptions: push, don't poll.

Counterpart of ``lux_tpu.serve.autopilot.subscribe``.  Every replica
keeps standing answers (``read_standing``) current through the warm
refresh; a client that wanted to FOLLOW one would have to poll the
controller and diff generation tags.  This module inverts it: register a :class:`Subscription` once, and the
:class:`SubscriptionHub` pushes every refreshed answer — on
write-commit and on fleet refresh — with the generation tag as the
cursor.

Design constraints, in order:

* **The write path never blocks on subscribers.**  ``notify()`` (called
  by ``admit_writes``/``refresh_fleet``) only folds the new generation
  into a pending slot under the hub lock; a single dispatcher thread
  does the ``read_standing`` fetches and queue pushes.  A burst of
  writes COALESCES: standing answers are absolute states, so an
  undelivered generation-5 update is strictly obsolete the moment
  generation 7 commits — superseded updates are counted
  (``lux_pilot_subscription_coalesced_total``), never delivered late.
* **Generation tags are the cursor.**  Every pushed update carries the
  served generation; a subscriber's ``cursor`` is the last generation
  it was handed, pushes are strictly cursor-monotonic, and the
  fleet-level ``lux_pilot_subscription_lag`` gauge is the max distance
  between the journal and any subscriber's cursor.
* **Subscriptions survive controller death.**  The hub holds the
  controller by reference; an elected successor ADOPTS the hub
  (``rebind``) and re-notifies at its recovered generation, so clients
  register once per fleet, not once per controller incarnation —
  ``close()`` on the controller (a clean shutdown) closes the hub,
  ``kill()`` (the death drill) deliberately does not.
* **Pushes are traced.**  Each dispatch emits a ``pilot.subscribe.push``
  span as a CHILD of the admitting write's (or refresh's) trace
  context, so a stitched write timeline ends with the fan-out to its
  subscribers.

Pure stdlib — the hub lives in the controller process.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from lux_tpu_torch.obs import dtrace


class SubscriptionClosed(RuntimeError):
    """get() on a subscription whose hub shut down or unsubscribed
    it."""


class Subscription:
    """One registered standing query.  ``get(timeout_s)`` blocks for
    the next pushed update — ``{app, generation, state, iters, worker,
    tolerance, refreshed}`` — strictly newer than ``cursor``; iteration
    yields updates until the subscription closes."""

    def __init__(self, sub_id: int, app: str, cursor: int = 0):
        self.sub_id = int(sub_id)
        self.app = str(app)
        self.cursor = int(cursor)  # last delivered generation
        self.delivered = 0
        self._cond = threading.Condition()
        self._latest: Optional[dict] = None
        self._closed = False

    def _push(self, update: dict) -> bool:
        """Hub-side: offer an update; False when it did not supersede
        (stale vs cursor) or the subscription closed."""
        with self._cond:
            if self._closed:
                return False
            if int(update["generation"]) <= self.cursor and \
                    not update.get("refreshed"):
                return False
            self._latest = update
            self._cond.notify_all()
            return True

    def _close(self) -> None:
        with self._cond:
            self._closed = True
            self._latest = None  # unsubscribed: drop, don't drain
            self._cond.notify_all()

    def get(self, timeout_s: Optional[float] = 30.0) -> dict:
        """The next undelivered update (the LATEST one — intermediate
        states superseded while waiting are never replayed).  Raises
        ``TimeoutError`` on timeout, :class:`SubscriptionClosed` once
        the hub closed this subscription."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + float(timeout_s))
        with self._cond:
            while self._latest is None:
                if self._closed:
                    raise SubscriptionClosed(
                        f"subscription {self.sub_id} closed")
                if deadline is None:
                    self._cond.wait()
                else:
                    left = deadline - time.monotonic()
                    if left <= 0 or not self._cond.wait(left):
                        if self._latest is not None:
                            break
                        raise TimeoutError(
                            f"no update for app {self.app!r} within "
                            f"{timeout_s}s (cursor {self.cursor})")
            update, self._latest = self._latest, None
            self.cursor = max(self.cursor, int(update["generation"]))
            self.delivered += 1
            return update

    def __iter__(self):
        while True:
            try:
                yield self.get(timeout_s=None)
            except SubscriptionClosed:
                return


class SubscriptionHub:
    """The controller-side registry + dispatcher.  Attach by
    construction (``LiveFleetController.subscribe`` builds one lazily
    and stores it as ``_sub_hub``); detach/adopt via ``rebind``."""

    def __init__(self, controller):
        self._ctl = controller
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._subs: Dict[int, Subscription] = {}
        self._next_id = 0
        #: the pending (coalesced) notification: highest generation +
        #: the trace context of the write/refresh that raised it
        self._pending_gen: Optional[int] = None
        self._pending_tc = None
        self._pending_refreshed = False
        self._push_errors = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # -- registration ---------------------------------------------------

    def subscribe(self, app: str, cursor: int = 0) -> Subscription:
        with self._lock:
            self._next_id += 1
            sub = Subscription(self._next_id, app, cursor=cursor)
            self._subs[sub.sub_id] = sub
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="lux-pilot-subs", daemon=True)
                self._thread.start()
        # seed the new subscriber with the CURRENT standing answer (if
        # any generation is committed past its cursor) — "register
        # once" must not mean "wait for the next write"
        try:
            gen = int(self._ctl.generation())
        except Exception:  # noqa: BLE001 — mid-failover registration
            gen = 0
        if gen > cursor:
            self.notify(gen)
        return sub

    def unsubscribe(self, sub) -> None:
        sub_id = sub.sub_id if isinstance(sub, Subscription) else int(sub)
        with self._lock:
            got = self._subs.pop(sub_id, None)
        if got is not None:
            got._close()

    def active(self) -> int:
        with self._lock:
            return len(self._subs)

    def max_lag(self) -> Optional[int]:
        """Max (journal generation - subscriber cursor) over active
        subscriptions; None with no subscribers or no controller."""
        with self._lock:
            subs = list(self._subs.values())
        if not subs:
            return None
        try:
            gen = int(self._ctl.generation())
        except Exception:  # noqa: BLE001 — dead incumbent, pre-rebind
            return None
        return max(max(gen - s.cursor, 0) for s in subs)

    # -- the push path --------------------------------------------------

    def notify(self, generation: int, tc=None,
               refreshed: bool = False) -> None:
        """Fold a committed generation into the pending slot (cheap —
        the write path calls this).  An undispatched older notification
        is superseded, counted as coalesced, and never fetched."""
        with self._cond:
            if self._stop:
                return
            if self._pending_gen is not None:
                if generation < self._pending_gen:
                    return  # late notify for an already-superseded gen
                self._count(self._ctl, "sub_coalesced")
            self._pending_gen = max(generation,
                                    self._pending_gen or 0)
            self._pending_tc = tc
            self._pending_refreshed = (refreshed
                                       or self._pending_refreshed)
            self._cond.notify()

    def rebind(self, controller) -> None:
        """Adopt this hub onto a NEW controller (the elected successor):
        subscribers keep their registrations and cursors, and a
        notification at the successor's recovered generation restarts
        delivery (any update the dead incumbent never dispatched is
        re-fetched from the recovered journal line)."""
        with self._cond:
            old = self._ctl
            self._ctl = controller
        if old is not None:
            with old._lock:
                if old._sub_hub is self:
                    old._sub_hub = None
        with controller._lock:
            displaced = getattr(controller, "_sub_hub", None)
            controller._sub_hub = self
        if displaced is not None and displaced is not self:
            # the successor's OWN lazily-built hub just lost its
            # controller binding: nothing would ever notify it again,
            # so its dispatcher thread idles forever and its
            # subscribers hang silently.  close() wakes them with
            # SubscriptionClosed and JOINS the dispatcher — a clean
            # end beats a leaked thread plus a silent hang.
            displaced.close()
        try:
            gen = int(controller.generation())
        except Exception:  # noqa: BLE001 — static controller adoption
            gen = 0
        self.notify(gen, refreshed=True)

    def _count(self, ctl, key: str, n: int = 1) -> None:
        """Route a counter increment to ``ctl`` — passed in, never read
        from ``self._ctl`` here: ``_cond``'s lock is non-reentrant, so a
        caller already under it reads the field itself, and the
        dispatcher passes the snapshot it took under the lock (the
        controller that actually served the dispatch, not whatever a
        concurrent ``rebind`` swapped in mid-push)."""
        if ctl is not None:
            try:
                ctl._pilot_count(key, n)
            except Exception:  # noqa: BLE001 — torn-down controller
                pass

    def _run(self) -> None:
        while True:
            with self._cond:
                while (self._pending_gen is None and not self._stop):
                    self._cond.wait()
                if self._stop:
                    return
                gen = self._pending_gen
                tc = self._pending_tc
                refreshed = self._pending_refreshed
                self._pending_gen = None
                self._pending_tc = None
                self._pending_refreshed = False
                ctl = self._ctl
                by_app: Dict[str, list] = {}
                for s in self._subs.values():
                    if s.cursor < gen or refreshed:
                        by_app.setdefault(s.app, []).append(s)
            for app in sorted(by_app):
                t0 = time.monotonic()
                ctx = tc.child() if tc is not None else None
                try:
                    ans = ctl.read_standing(app)
                except Exception as e:  # noqa: BLE001 — dead/failing ctl
                    # delivery stalls, registration survives: the next
                    # notify (a later write, or a successor's rebind)
                    # restarts it.  No retry loop here — a dead
                    # incumbent would make it a busy-wait.
                    with self._cond:
                        self._push_errors += 1
                    dtrace.emit_span("pilot.subscribe.push", ctx, t0,
                                     time.monotonic(), ok=False,
                                     app=app, err=str(e))
                    continue
                update = {"app": app,
                          "generation": int(ans["generation"]),
                          "state": ans["state"],
                          "iters": ans.get("iters"),
                          "worker": ans.get("worker"),
                          # the served-error contract of the pushed
                          # answer (the tolerance tag; 0.0 = exact)
                          "tolerance": float(ans.get("tolerance") or 0.0),
                          "refreshed": bool(refreshed)}
                pushed = 0
                for s in by_app[app]:
                    if s._push(dict(update)):
                        pushed += 1
                if pushed:
                    self._count(ctl, "sub_pushes", pushed)
                dtrace.emit_span("pilot.subscribe.push", ctx, t0,
                                 time.monotonic(), ok=True, app=app,
                                 generation=update["generation"],
                                 subscribers=pushed,
                                 refreshed=bool(refreshed))

    def stats(self) -> dict:
        with self._lock:
            return {"active": len(self._subs),
                    "push_errors": self._push_errors,
                    "pending_generation": self._pending_gen}

    def close(self) -> None:
        with self._cond:
            self._stop = True
            subs = list(self._subs.values())
            self._subs.clear()
            self._cond.notify_all()
        for s in subs:
            s._close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
