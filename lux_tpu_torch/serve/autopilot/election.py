"""Automatic controller election: standbys that promote themselves.

Counterpart of ``lux_tpu.serve.autopilot.election``.  Controller failover
is a LIBRARY call — ``promote_live_controller`` rebuilds a controller
from the journal and re-enrolls survivors with token-fenced re-hellos —
and this module is the noticing: each :class:`Standby` probes the incumbent on the fleet's
heartbeat cadence, declares death after ``death_after_s`` of silence
(with seeded jitter so standbys don't stampede), and runs a
deterministic election through the shared :class:`StandbyGroup`:

* **lowest live standby id wins** — no rounds, no randomized ballots:
  the group accepts a ``claim`` only from the smallest currently
  registered id, so every standby computes the same winner;
* **one election per incumbent incarnation** — claims are FENCED by
  the dead controller's incarnation token: the group refuses a second
  claim against an incarnation already claimed, so a slow standby that
  declares death late cannot start a rival promotion (split-brain
  guard on the election side; the journal-generation hello refusal
  guards the worker side);
* **losers adopt, retries survive winner death** — a losing standby
  waits on the group's promoted event and adopts the winner's
  controller; if the winner dies mid-promotion its claim is released
  and the next-lowest standby retries.

Every phase is traced onto ONE keyed incident
(``election:{incarnation}``): each standby's ``pilot.detect`` span,
the winner's ``pilot.elect`` and ``pilot.promote`` spans — because the
key is the dead incarnation, every standby independently mints the
SAME trace id and a stitched log renders detection, election and
promotion as a single causal timeline without any coordination.

Pure stdlib; a Standby is a thread in the controller process, not a
separate OS process — matching the repo's threads-as-processes fleet
idiom.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Optional

from lux_tpu_torch import fault
from lux_tpu_torch.obs import dtrace


class StandbyGroup:
    """The shared election state: the registered standby ids, the
    incarnation fence, and the promoted-controller slot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ids: set = set()
        self._claimed: Dict[str, int] = {}  # incarnation -> winner id
        self._promoted = None  # (ctl, report) once a winner finished
        self._event = threading.Event()
        self.elections = 0

    def register(self, standby_id: int) -> None:
        with self._lock:
            self._ids.add(int(standby_id))

    def deregister(self, standby_id: int) -> None:
        with self._lock:
            self._ids.discard(int(standby_id))

    def claim(self, standby_id: int, incarnation: str) -> bool:
        """Try to win the election for a dead incarnation.  True for
        exactly one caller: the LOWEST live standby id, first claim
        against this incarnation."""
        standby_id = int(standby_id)
        with self._lock:
            if incarnation in self._claimed:
                return False  # fenced: this death is already being
                # handled (or was); a late detector must adopt, not race
            if not self._ids or standby_id != min(self._ids):
                return False
            self._claimed[incarnation] = standby_id
            return True

    def release(self, standby_id: int, incarnation: str) -> None:
        """Winner died / promotion failed: lift the fence so the
        next-lowest standby can retry."""
        with self._lock:
            if self._claimed.get(incarnation) == int(standby_id):
                del self._claimed[incarnation]

    def claimed_by(self, incarnation: str) -> Optional[int]:
        with self._lock:
            return self._claimed.get(incarnation)

    def set_promoted(self, standby_id: int, ctl, report) -> None:
        with self._lock:
            self._promoted = (ctl, report)
            self.elections += 1
        self._event.set()

    @property
    def promoted(self):
        """(controller, takeover_report) once an election completed,
        else None."""
        with self._lock:
            return self._promoted

    def wait_promoted(self, timeout_s: Optional[float] = None):
        """Block until some standby finished promoting; returns the
        (controller, report) pair or None on timeout."""
        self._event.wait(timeout_s)
        return self.promoted


class Standby:
    """One standby controller candidate.

    ``promote(tc) -> (ctl, report)`` does the actual promotion — the
    live-fleet harnesses hand in a closure over
    ``promote_live_controller`` (see :func:`live_promoter`); the
    standby only decides WHEN to call it and fences WHO may.

    Timing defaults compose with the fleet knobs:
    the probe interval defaults to the incumbent's ``hb_interval_s``
    (itself ``LUX_FLEET_HEARTBEAT_S``) and the death threshold to its
    ``hb_timeout_s`` (``LUX_FLEET_DEATH_S``) — a standby declares
    death on the same clock the controller uses to declare workers
    dead.  Probe jitter is a seeded ``random.Random`` per standby
    (deterministic under test, desynchronized in a fleet).
    """

    def __init__(self, group: StandbyGroup, standby_id: int,
                 incumbent,
                 promote: Callable[[Optional[dtrace.TraceContext]],
                                   tuple],
                 on_promoted: Optional[Callable] = None,
                 hb_interval_s: Optional[float] = None,
                 death_after_s: Optional[float] = None,
                 seed: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.group = group
        self.standby_id = int(standby_id)
        self.incumbent = incumbent
        self.promote = promote
        self.on_promoted = on_promoted
        self.hb_interval_s = (float(incumbent.hb_interval_s)
                              if hb_interval_s is None
                              else float(hb_interval_s))
        self.death_after_s = (float(incumbent.hb_timeout_s)
                              if death_after_s is None
                              else float(death_after_s))
        self.incumbent_incarnation = str(incumbent.incarnation)
        self._rng = random.Random(int(seed) * 1000003
                                  + self.standby_id)
        self.clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.probes_ok = 0
        self.probes_failed = 0
        self.detected_at: Optional[float] = None
        self.outcome: Optional[str] = None  # "won" | "adopted" | None
        group.register(self.standby_id)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Standby":
        self._thread = threading.Thread(
            target=self._run, name=f"lux-standby-{self.standby_id}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.group.deregister(self.standby_id)
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    # -- the probe loop --------------------------------------------------

    def _probe_once(self) -> bool:
        try:
            self.incumbent.ping()
            return True
        except Exception:  # noqa: BLE001 — closed/errored == silent
            return False

    def _run(self) -> None:
        last_ok = self.clock()
        while not self._stop.is_set():
            # jittered probe interval: +-25% so standbys that started
            # together drift apart instead of probing in lockstep
            interval = self.hb_interval_s * (
                0.75 + 0.5 * self._rng.random())
            if self._stop.wait(interval):
                return
            now = self.clock()
            if self._probe_once():
                self.probes_ok += 1
                last_ok = now
                continue
            self.probes_failed += 1
            if now - last_ok < self.death_after_s:
                continue
            # -- death declared ------------------------------------------
            # named process point: a delay rule here makes THIS standby
            # a late detector (the TOCTOU schedule the election model of
            # analysis/proto explores); kill dies silently pre-claim
            fault.ppoint("election.detect",
                         owner=f"standby-{self.standby_id}",
                         incumbent=self.incumbent_incarnation)
            self.detected_at = now
            etc = dtrace.incident(
                f"election:{self.incumbent_incarnation}")
            dtrace.emit_span(
                "pilot.detect", etc, last_ok, now, ok=True,
                standby=self.standby_id,
                incumbent=self.incumbent_incarnation,
                silence_s=round(now - last_ok, 4))
            self._elect(etc)
            return

    def _elect(self, etc) -> None:
        deadline = self.clock() + max(self.death_after_s * 20, 30.0)
        while not self._stop.is_set() and self.clock() < deadline:
            if self.group.promoted is not None:
                self._adopt()
                return
            if not self.group.claim(self.standby_id,
                                    self.incumbent_incarnation):
                # lost (or fenced out): wait for the winner, then
                # re-check — if the winner released, claim again
                self.group.wait_promoted(self.death_after_s)
                continue
            # claim won, promotion not yet run: a delay rule holds the
            # promotion window open (the detached-promotion schedule);
            # kill dies HOLDING the claim — the fence then wedges the
            # election shut rather than admit a rival (by design)
            fault.ppoint("election.promote",
                         owner=f"standby-{self.standby_id}",
                         incumbent=self.incumbent_incarnation)
            t0 = self.clock()
            try:
                with dtrace.tspan(
                        "pilot.elect", etc, always=True,
                        winner=self.standby_id,
                        incumbent=self.incumbent_incarnation):
                    pass
                ctl, report = self.promote(etc)
            except Exception as e:  # noqa: BLE001 — failed promotion
                dtrace.emit_span(
                    "pilot.promote", etc, t0, self.clock(), ok=False,
                    standby=self.standby_id, err=str(e))
                self.group.release(self.standby_id,
                                   self.incumbent_incarnation)
                continue
            dtrace.emit_span(
                "pilot.promote", etc, t0, self.clock(), ok=True,
                standby=self.standby_id,
                incarnation=str(ctl.incarnation),
                joined=len(report.get("joined", ()))
                if isinstance(report, dict) else None)
            try:
                ctl._pilot_count("elections")
            except Exception:  # noqa: BLE001 — non-fleet test double
                pass
            self.outcome = "won"
            self.group.set_promoted(self.standby_id, ctl, report)
            if self.on_promoted is not None:
                self.on_promoted(ctl, report)
            return
        # stopped/deadlined while waiting: if some winner finished in
        # the meantime, that's an adoption, not a timeout (stop() races
        # the promoted event on the losing standbys)
        if self.outcome is None and self.group.promoted is not None:
            self._adopt()
        self.outcome = self.outcome or "timeout"

    def _adopt(self) -> None:
        self.outcome = "adopted"


class WireIncumbent:
    """A process-mode incumbent as a Standby sees it: dials
    the controller's ``serve_lease`` port and renews the lease with one
    RPC per probe.  Satisfies the Standby's incumbent duck type
    (``.ping()`` raising on death, ``.hb_interval_s``,
    ``.hb_timeout_s``, ``.incarnation``) — so the SAME fenced election
    that watches an in-process controller watches one across a process
    boundary, and the only out-of-band fact a standby needs is the
    lease address: the cadence and death threshold arrive IN the first
    grant.

    Death is SILENCE, in either of its wire shapes: a refused dial, a
    dropped connection, or a reply that doesn't start within the death
    threshold (``Conn.recv_wait``) all raise — which is exactly what
    ``Standby._probe_once`` counts as a failed probe.  A renewal that
    answers with a DIFFERENT incarnation also raises: that's a new
    controller at the old address, and the election against the one we
    were watching must still run (adoption handles the successor).
    """

    def __init__(self, host: str, port: int,
                 connect_timeout_s: float = 10.0):
        self.host = str(host)
        self.port = int(port)
        self.connect_timeout_s = float(connect_timeout_s)
        self._lock = threading.Lock()
        self._conn = None
        self._seq = 0
        self.incarnation: Optional[str] = None
        self.hb_interval_s = 0.25
        self.hb_timeout_s = 3.0
        grant = self.ping()  # first renewal: learn the lease terms
        self.incarnation = str(grant["incarnation"])
        self.hb_interval_s = float(grant.get("hb_interval_s",
                                             self.hb_interval_s))
        self.hb_timeout_s = float(grant.get("lease_s",
                                            self.hb_timeout_s))

    def _drop(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()

    def ping(self) -> dict:
        from lux_tpu_torch.serve.fleet.wire import Conn

        with self._lock:
            conn = self._conn
        if conn is None:
            # dial OUTSIDE the lock: a hung connect to a
            # dead address must not wedge close() behind the probe
            conn = Conn.connect(
                self.host, self.port,
                timeout_s=self.connect_timeout_s,
                peer=f"incumbent@{self.host}:{self.port}",
                owner="standby")
        with self._lock:
            if self._conn is None:
                # deliberate CAS: the dial ran unlocked (holding _lock
                # across connect() would wedge close()), and this second
                # acquisition RE-CHECKS before installing; the losing
                # racer is closed below
                self._conn = conn
            elif self._conn is not conn:
                # lost a dial race to another probe; keep the installed
                # connection (ONE renewal stream per incumbent)
                conn.close()
            try:
                conn = self._conn
                self._seq += 1
                conn.send({"op": "lease",
                           "req_id": f"l{self._seq}"})
                # the probe's own deadline: a grant that doesn't START
                # within the death threshold IS a missed renewal
                msg, _ = conn.recv_wait(
                    max(self.hb_timeout_s, self.connect_timeout_s))
            except Exception:
                self._drop()
                raise
            if not msg.get("ok"):
                self._drop()
                raise ConnectionError(
                    f"lease refused: {msg.get('err', msg)}")
            inc = str(msg.get("incarnation"))
            if self.incarnation is not None and inc != self.incarnation:
                self._drop()
                raise ConnectionError(
                    f"incumbent incarnation changed "
                    f"({self.incarnation} -> {inc}): the controller we "
                    "were watching is gone")
            return msg

    def close(self) -> None:
        with self._lock:
            self._drop()


def live_promoter(base, journal_dir: str, snapshot_path: Optional[str],
                  endpoints_fn: Callable[[], list], deadline_s: float = 30.0,
                  seed: int = 0, **kw) -> Callable:
    """Build the ``promote`` closure a live-fleet Standby needs:
    wraps ``promote_live_controller`` over the authoritative journal
    dir, resolving the surviving-worker endpoint list AT PROMOTION
    TIME (``endpoints_fn`` — workers may have scaled since the standby
    started).  Lazy import keeps this module import-light for the
    pure-policy callers."""
    def promote(tc=None):
        from lux_tpu_torch.serve.live.controller import promote_live_controller
        endpoints = list(endpoints_fn())
        return promote_live_controller(
            base, journal_dir, snapshot_path, endpoints,
            deadline_s=deadline_s, seed=seed, **kw)
    return promote
