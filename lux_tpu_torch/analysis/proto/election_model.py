"""Protocol model: controller election fencing
(``serve/autopilot/election.py``).

Counterpart of ``lux_tpu.analysis.proto.election_model``, over the
port's StandbyGroup.

The strongest possible conformance bridge: the model's transition
function IS the real code.  Every ``claim``/``release``/
``set_promoted``/``register``/``deregister`` transition rebuilds a real
:class:`~lux_tpu_torch.serve.autopilot.election.StandbyGroup` from the model
state and invokes the real method, then reads the resulting state back
— so the checker exhaustively explores every interleaving of the
actual election logic rather than a hand-copied approximation that
could drift.

Small-but-covering configuration: 2–3 standbys, one dead incumbent
incarnation, at most one standby restart.  Coverage deliberately
includes the two nastiest schedules:

* **detached promotion** — ``stop()`` on a standby whose ``promote()``
  is still running deregisters it but cannot un-run the promotion; the
  in-flight call still reaches ``set_promoted``.  Deregistration shifts
  ``min(live ids)``, so WITHOUT the fence the next standby would win a
  rival claim while the detached promotion completes → two promotions.
* **check-then-claim TOCTOU** — ``_elect`` reads ``group.promoted``
  (None) and only then claims; a winner can finish in the gap.  The
  fence (claims keyed by the dead incarnation, never released on
  success) is what makes the late claim lose.

The safety invariant is the split-brain guard: **at most one promotion
per incumbent incarnation** (``group.elections <= 1``); the fenced
model additionally asserts claim integrity (a promoting standby holds
the claim; at most one promotion in flight).

The broken twin (:class:`UnfencedStandbyGroup`, ``fenced=False``) drops
the incarnation fence from ``claim`` and the checker finds the
shortest schedule to a second completed promotion;
``proto/export.py`` turns that trace into a seeded FaultPlan that
``fault.chaos.election_drill`` replays against real Standby threads.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from lux_tpu_torch.analysis.proto.mc import Action, Model, State
from lux_tpu_torch.serve.autopilot.election import StandbyGroup

#: the one dead-incumbent incarnation the model elects over
INCARNATION = "inc-0"

# standby phases
IDLE = "idle"          # probing; death not yet declared
DETECTED = "detected"  # in the _elect loop
PROMOTING = "promoting"  # claim held, promote() running
ZOMBIE = "zombie"      # stop()ed (deregistered) mid-promote: the
#                        in-flight promote still completes or fails
WON = "won"            # set_promoted ran
ADOPTED = "adopted"    # observed a winner, outcome "adopted"
STOPPED = "stopped"    # stop() ran (deregistered) / standby crashed


class UnfencedStandbyGroup(StandbyGroup):
    """The deliberately broken twin: ``claim`` keeps the lowest-live-id
    rule but DROPS the incarnation fence — a late detector can start a
    rival election for an already-handled death.  Exists only for the
    checker's broken-twin run and the chaos replay drill."""

    def claim(self, standby_id: int, incarnation: str) -> bool:
        standby_id = int(standby_id)
        with self._lock:
            if not self._ids or standby_id != min(self._ids):
                return False
            self._claimed[incarnation] = standby_id
            return True


class ElectionModel(Model):
    """State: (phases, registered, claimed, elections, restarts_used).

    ``phases[i]``/``registered[i]`` per standby; ``claimed`` is the
    incarnation fence holder (or None); ``elections`` counts
    ``set_promoted`` calls — the real split-brain counter.
    """

    name = "election"

    def __init__(self, n_standbys: int = 2, fenced: bool = True,
                 max_restarts: int = 1):
        self.n = int(n_standbys)
        self.fenced = bool(fenced)
        self.max_restarts = int(max_restarts)
        self.group_cls = StandbyGroup if fenced else UnfencedStandbyGroup

    def config(self) -> Dict[str, object]:
        return {"standbys": self.n, "fenced": self.fenced,
                "max_restarts": self.max_restarts,
                "incarnation": INCARNATION}

    # -- the real-code bridge -------------------------------------------

    def _group(self, registered: Tuple[bool, ...],
               claimed: Optional[int]) -> StandbyGroup:
        """A real StandbyGroup rebuilt from model state (the `_claimed`
        seed reaches into the class on purpose: there is no public
        'resume mid-election' API, and the model must explore exactly
        those mid-election states)."""
        g = self.group_cls()
        for i, reg in enumerate(registered):
            if reg:
                g.register(i)
        if claimed is not None:
            g._claimed[INCARNATION] = claimed
        return g

    # -- transition system ----------------------------------------------

    def initial(self) -> Iterable[State]:
        yield ((IDLE,) * self.n, (True,) * self.n, None, 0, 0)

    def actions(self, state: State) -> Iterable[Action]:
        phases, registered, claimed, elections, restarts = state
        out = []
        for i in range(self.n):
            ph = phases[i]
            if ph == IDLE:
                out.append((f"detect(s{i})", (
                    _set(phases, i, DETECTED), registered, claimed,
                    elections, restarts)))
            if ph == DETECTED:
                if elections >= 1:
                    # the _elect loop head saw group.promoted set
                    out.append((f"adopt(s{i})", (
                        _set(phases, i, ADOPTED), registered, claimed,
                        elections, restarts)))
                # ... and the TOCTOU schedule: the promoted check read
                # None BEFORE a winner landed, so the claim still runs
                # — the REAL claim decides (the fence is what makes a
                # late claim lose here)
                g = self._group(registered, claimed)
                if g.claim(i, INCARNATION):
                    out.append((f"claim_win(s{i})", (
                        _set(phases, i, PROMOTING), registered,
                        g.claimed_by(INCARNATION), elections,
                        restarts)))
                # a refused claim is wait_promoted + retry: no state
                # change, so no transition emitted
            if ph in (PROMOTING, ZOMBIE):
                nxt_done = WON if ph == PROMOTING else STOPPED
                nxt_fail = DETECTED if ph == PROMOTING else STOPPED
                # promotion completes: the real set_promoted (a ZOMBIE's
                # in-flight promote completes the same way)
                g = self._group(registered, claimed)
                g.set_promoted(i, None, None)
                out.append((f"promote_ok(s{i})", (
                    _set(phases, i, nxt_done), registered, claimed,
                    elections + g.elections, restarts)))
                # ... or raises: the real release lifts the fence
                g2 = self._group(registered, claimed)
                g2.release(i, INCARNATION)
                out.append((f"promote_fail(s{i})", (
                    _set(phases, i, nxt_fail), registered,
                    g2.claimed_by(INCARNATION), elections, restarts)))
            if ph == PROMOTING:
                # stop() mid-promote: the real deregister shifts
                # min(live ids) while the promote call keeps running
                g = self._group(registered, claimed)
                g.deregister(i)
                out.append((f"stop_mid_promote(s{i})", (
                    _set(phases, i, ZOMBIE),
                    _set(registered, i, False), claimed, elections,
                    restarts)))
            if ph in (IDLE, DETECTED, WON, ADOPTED):
                # clean shutdown or crash-before-claim
                g = self._group(registered, claimed)
                g.deregister(i)
                out.append((f"stop(s{i})", (
                    _set(phases, i, STOPPED),
                    _set(registered, i, False), claimed, elections,
                    restarts)))
            if ph == STOPPED and restarts < self.max_restarts:
                # a replacement standby under the same id re-registers
                # mid-incident; the fence must force it to adopt (or
                # lose), never re-elect
                g = self._group(registered, claimed)
                g.register(i)
                out.append((f"restart(s{i})", (
                    _set(phases, i, IDLE), _set(registered, i, True),
                    claimed, elections, restarts + 1)))
        return out

    def invariant(self, state: State) -> Optional[str]:
        phases, registered, claimed, elections, _restarts = state
        if elections > 1:
            return (f"split brain: {elections} promotions for dead "
                    f"incarnation {INCARNATION!r} — the incarnation "
                    "fence admitted a second election")
        if not self.fenced:
            # the twin asks ONE question — can a second promotion
            # complete? — so claim-integrity (the fence's own
            # guarantee) is not asserted on it
            return None
        promoting = [i for i, p in enumerate(phases)
                     if p in (PROMOTING, ZOMBIE)]
        if len(promoting) > 1:
            return (f"standbys {promoting} promoting concurrently — "
                    "claim() returned True twice for one incarnation")
        for i in promoting:
            if claimed != i:
                return (f"standby s{i} promoting without holding the "
                        f"claim (fence holder: {claimed})")
        return None

    def accepting(self, state: State) -> bool:
        # action-less states are all-stopped with restarts exhausted:
        # nobody left to elect — acceptable (no liveness promise with
        # zero live standbys); any OTHER wedged state is a deadlock
        phases, _registered, _claimed, _elections, restarts = state
        return (all(p == STOPPED for p in phases)
                and restarts >= self.max_restarts)


def _set(tup: tuple, i: int, val) -> tuple:
    return tup[:i] + (val,) + tup[i + 1:]
