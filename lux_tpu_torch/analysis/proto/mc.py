"""The explicit-state model checker: exhaustive BFS over hashable
protocol states.

Counterpart of ``lux_tpu.analysis.proto.mc`` (a copy).  Pure stdlib, deliberately tiny: a :class:`Model` enumerates initial
states and per-state actions (crash/restart transitions are ordinary
actions, so every model interleaves them at every step), declares a
safety ``invariant`` and which action-less states are acceptable
(``accepting``).  :func:`check` explores the FULL reachable state space
breadth-first — BFS, not DFS, so the first violation found is a
SHORTEST counterexample trace — and reports exact state/transition
counts.

States must be hashable values built from primitives (nested tuples;
sort anything set-like so equal states hash equal).  Determinism is
part of the contract: two runs over the same model visit states in the
same order and return the same counterexample, which is what lets a
counterexample export as a seeded, reproducible FaultPlan
(``proto/export.py``).

A model stays *small-but-covering* (2–3 workers, 2 standbys, 1–2
in-flight writes): the protocols' guards are all pairwise (one fence,
one token comparison, one generation compare), so the classic
small-scope regime applies — every violation these protocols can
exhibit already shows up at these sizes.  ``max_states`` is a tripwire
against accidental state-space blowup, not a sampling knob: hitting it
FAILS the check (an unexplored space must never report clean).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import (
    Dict,
    Hashable,
    Iterable,
    List,
    Optional,
    Tuple,
)

State = Hashable
Action = Tuple[str, State]  # (label, successor)


class Model:
    """One protocol as a transition system.  Subclasses implement the
    four hooks; everything else (search, traces, counts) is generic."""

    #: registry/reporting name ("election", "publish", ...)
    name = "unset"

    def initial(self) -> Iterable[State]:
        raise NotImplementedError

    def actions(self, state: State) -> Iterable[Action]:
        """Enabled transitions, in a DETERMINISTIC order."""
        raise NotImplementedError

    def invariant(self, state: State) -> Optional[str]:
        """None when ``state`` is safe, else the violation message."""
        raise NotImplementedError

    def accepting(self, state: State) -> bool:
        """True when a state with NO enabled actions is an acceptable
        terminal (protocol ran to completion); False makes it a
        deadlock finding."""
        raise NotImplementedError

    def config(self) -> Dict[str, object]:
        """The small-scope configuration, for the report."""
        return {}


@dataclasses.dataclass(frozen=True)
class Violation:
    """A counterexample: what broke, and the shortest action trace
    from an initial state to the breaking state."""

    kind: str  # "invariant" | "deadlock" | "state_space"
    message: str
    trace: Tuple[str, ...]
    state: State

    def format(self) -> str:
        steps = "\n".join(
            f"    {i + 1}. {a}" for i, a in enumerate(self.trace))
        return (f"{self.kind}: {self.message}\n  trace "
                f"({len(self.trace)} steps):\n{steps or '    (initial)'}")


@dataclasses.dataclass(frozen=True)
class CheckResult:
    """One exhaustive run: clean iff ``violation is None``."""

    protocol: str
    states: int
    transitions: int
    depth: int
    config: Dict[str, object]
    violation: Optional[Violation] = None

    @property
    def ok(self) -> bool:
        return self.violation is None

    def summary(self) -> str:
        tail = ("clean" if self.ok
                else f"VIOLATION ({self.violation.kind})")
        return (f"{self.protocol}: {self.states} states / "
                f"{self.transitions} transitions / depth {self.depth} "
                f"— {tail}")


def _trace(parents: Dict[State, Optional[Tuple[State, str]]],
           state: State) -> Tuple[str, ...]:
    out: List[str] = []
    cur: Optional[State] = state
    while cur is not None:
        link = parents[cur]
        if link is None:
            break
        cur, label = link
        out.append(label)
    return tuple(reversed(out))


def check(model: Model, max_states: int = 1_000_000) -> CheckResult:
    """Exhaustive BFS.  Returns on the FIRST violation (shortest trace
    by BFS construction) or after the whole reachable space is clean."""
    parents: Dict[State, Optional[Tuple[State, str]]] = {}
    frontier: deque = deque()
    depth_of: Dict[State, int] = {}
    transitions = 0
    max_depth = 0

    def fail(kind: str, message: str, state: State) -> CheckResult:
        return CheckResult(
            protocol=model.name, states=len(parents),
            transitions=transitions, depth=max_depth,
            config=dict(model.config()),
            violation=Violation(kind=kind, message=message,
                                trace=_trace(parents, state),
                                state=state))

    for s0 in model.initial():
        if s0 not in parents:
            parents[s0] = None
            depth_of[s0] = 0
            frontier.append(s0)
    while frontier:
        state = frontier.popleft()
        d = depth_of[state]
        max_depth = max(max_depth, d)
        bad = model.invariant(state)
        if bad is not None:
            return fail("invariant", bad, state)
        succ = list(model.actions(state))
        if not succ and not model.accepting(state):
            return fail(
                "deadlock",
                "no enabled action in a non-accepting state "
                "(the protocol wedged short of completion)", state)
        for label, nxt in succ:
            transitions += 1
            if nxt not in parents:
                if len(parents) >= max_states:
                    return fail(
                        "state_space",
                        f"state space exceeds max_states={max_states} "
                        "— an unexplored space must never report "
                        "clean; shrink the model config or raise the "
                        "bound", state)
                parents[nxt] = (state, label)
                depth_of[nxt] = d + 1
                frontier.append(nxt)
    return CheckResult(protocol=model.name, states=len(parents),
                       transitions=transitions, depth=max_depth,
                       config=dict(model.config()))
