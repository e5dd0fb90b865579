"""FaultPlan: deterministic, seeded fault injection as DATA.

Counterpart of ``lux_tpu.fault.plan`` (a copy: the port imports nothing
of the reference; a plan's JSON is the same in both packages).

* a plan is a list of :class:`FaultRule` rows, each naming a SITE
  (``wire.send`` / ``wire.recv`` / ``proc``), a match (owner / peer /
  op / process-point / file globs), an ACTION (``kill`` / ``drop`` /
  ``delay`` / ``truncate`` / ``corrupt`` / ``reset`` / ``partial`` /
  ``torn``), and firing controls (``after`` skips the first N matches,
  ``count`` bounds total fires, ``prob`` draws from the plan's OWN
  seeded ``random.Random`` — never the process-global RNG);
* plans serialize to/from JSON (``to_json``/``from_json``) and install
  from the environment (``LUX_FAULT_PLAN`` = inline JSON or a path), so
  a failing drill's report IS its reproduction recipe;
* every fire logs a ``fault.inject`` recorder point and increments a
  per-(site, target, action) counter.

The sites are consulted by the production code itself
(``mutate/deltalog.py``'s npz+``.ok`` journal protocol and its named
``fault.ppoint(...)`` process points; the fleet's ``wire.send`` /
``wire.recv`` sites and its ``controller.heartbeat`` point), behind a single module-global fast path that costs one
attribute read when no plan is installed.
"""
from __future__ import annotations

import fnmatch
import json
import os
import random
import threading
from typing import Callable, Dict, List, Optional, Tuple

#: actions the engine knows; sites ignore actions they cannot express
#: (a ``torn`` rule matched at ``wire.send`` does nothing, loudly — see
#: FaultRule.validate)
ACTIONS = ("kill", "drop", "delay", "truncate", "corrupt", "reset",
           "partial", "torn", "noop")

#: which actions each site can express — validated at plan build so a
#: typo'd plan fails at install, not silently mid-drill
SITE_ACTIONS = {
    "wire.send": ("drop", "delay", "truncate", "corrupt", "reset",
                  "partial", "kill", "noop"),
    "wire.recv": ("drop", "delay", "corrupt", "reset", "kill", "noop"),
    "proc": ("kill", "delay", "torn", "noop"),
}

#: documented spellings mapped onto the placed process points
#: (``after_delta_before_marker`` is the kill drill's name for the
#: journal's marker window)
POINT_ALIASES = {
    "after_delta_before_marker": "journal.before_marker",
}


class InjectedKill(BaseException):
    """An injected crash.  BaseException on purpose: the worker code's
    blanket ``except Exception`` error-reply handlers must NOT convert
    an injected kill into a polite error frame — a killed process sends
    nothing, and the drills assert on exactly that silence."""


class FaultPlanError(ValueError):
    """Malformed plan/rule (unknown site/action, bad JSON, bad bounds)."""


_MATCH_FIELDS = ("owner", "peer", "op", "point", "file")
_RULE_FIELDS = _MATCH_FIELDS + (
    "site", "action", "after", "count", "prob", "delay_ms", "trunc_bytes",
    "callback", "note")


class FaultRule:
    """One schedulable fault.  Match fields are fnmatch globs (None =
    match anything); ``callback`` names a plan binding (``plan.bind``)
    invoked on fire — how a ``kill`` action reaches the right
    ``worker.kill`` without the plan holding object references in its
    JSON form."""

    def __init__(self, site: str, action: str, *,
                 owner: Optional[str] = None, peer: Optional[str] = None,
                 op: Optional[str] = None, point: Optional[str] = None,
                 file: Optional[str] = None, after: int = 0,
                 count: Optional[int] = None, prob: float = 1.0,
                 delay_ms: float = 0.0, trunc_bytes: int = 8,
                 callback: Optional[str] = None, note: str = ""):
        self.site = str(site)
        self.action = str(action)
        self.owner = owner
        self.peer = peer
        self.op = op
        self.point = (POINT_ALIASES.get(point, point)
                      if point is not None else None)
        self.file = file
        self.after = int(after)
        self.count = None if count is None else int(count)
        self.prob = float(prob)
        self.delay_ms = float(delay_ms)
        self.trunc_bytes = int(trunc_bytes)
        self.callback = callback
        self.note = str(note)
        self.seen = 0   # matches observed (pre-after/prob/count gates)
        self.fired = 0  # faults actually injected
        self.validate()

    def validate(self) -> None:
        if self.site not in SITE_ACTIONS:
            raise FaultPlanError(
                f"unknown site {self.site!r}; expected one of "
                f"{sorted(SITE_ACTIONS)}")
        if self.action not in SITE_ACTIONS[self.site]:
            raise FaultPlanError(
                f"action {self.action!r} is not expressible at site "
                f"{self.site!r} (allowed: {SITE_ACTIONS[self.site]})")
        if not (0.0 <= self.prob <= 1.0):
            raise FaultPlanError(f"prob must be in [0, 1], got {self.prob}")
        if self.after < 0 or (self.count is not None and self.count < 0):
            raise FaultPlanError("after/count must be >= 0")

    def matches(self, site: str, ctx: Dict[str, Optional[str]]) -> bool:
        if site != self.site:
            return False
        for field in _MATCH_FIELDS:
            pat = getattr(self, field)
            if pat is None:
                continue
            val = ctx.get(field)
            if val is None or not fnmatch.fnmatchcase(str(val), pat):
                return False
        return True

    def to_dict(self) -> dict:
        out = {"site": self.site, "action": self.action}
        for field in _RULE_FIELDS:
            if field in ("site", "action"):
                continue
            val = getattr(self, field)
            default = {"after": 0, "prob": 1.0, "delay_ms": 0.0,
                       "trunc_bytes": 8, "note": ""}.get(field)
            if val is not None and val != default:
                out[field] = val
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "FaultRule":
        unknown = set(d) - set(_RULE_FIELDS)
        if unknown:
            raise FaultPlanError(
                f"unknown rule fields {sorted(unknown)} (known: "
                f"{sorted(_RULE_FIELDS)})")
        if "site" not in d or "action" not in d:
            raise FaultPlanError(f"rule needs site + action: {d}")
        return cls(**d)


class FaultPlan:
    """A named, seeded schedule of FaultRules.

    ``fire(site, **ctx)`` is the single consultation point: the FIRST
    rule whose match fields accept the context is advanced through its
    ``after``/``count``/``prob`` gates; a passing rule is returned to
    the site (which interprets the action) after its callback ran and a
    ``fault.inject`` event hit the flight recorder.  Thread-safe: sites
    fire from connection readers, op threads, and the heartbeat loop
    concurrently."""

    def __init__(self, rules: List[FaultRule], seed: int = 0,
                 name: str = "plan"):
        self.rules = list(rules)
        self.seed = int(seed)
        self.name = str(name)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._callbacks: Dict[str, Callable] = {}
        self._counters: Dict[Tuple[str, str, str], int] = {}

    # -- construction ---------------------------------------------------

    def bind(self, name: str, fn: Callable) -> "FaultPlan":
        """Attach the callable a rule's ``callback`` field names (e.g.
        ``plan.bind("kill:w1", w1.kill)``).  Returns self for chaining."""
        with self._lock:
            self._callbacks[str(name)] = fn
        return self

    def add(self, rule: FaultRule) -> FaultRule:
        with self._lock:
            self.rules.append(rule)
        return rule

    def to_dict(self) -> dict:
        return {"name": self.name, "seed": self.seed,
                "rules": [r.to_dict() for r in self.rules]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        if not isinstance(d, dict) or "rules" not in d:
            raise FaultPlanError(
                f"plan must be an object with a 'rules' list, got {d!r}")
        rules = [FaultRule.from_dict(r) for r in d["rules"]]
        return cls(rules, seed=int(d.get("seed", 0)),
                   name=str(d.get("name", "plan")))

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        try:
            d = json.loads(text)
        except ValueError as e:
            raise FaultPlanError(f"bad plan JSON: {e}") from None
        return cls.from_dict(d)

    @classmethod
    def from_env(cls, var: str = "LUX_FAULT_PLAN"
                 ) -> Optional["FaultPlan"]:
        """``LUX_FAULT_PLAN`` holds inline JSON (starts with ``{``) or
        a path to a JSON file; unset/empty -> None."""
        raw = os.environ.get(var, "").strip()
        if not raw:
            return None
        if raw.startswith("{"):
            return cls.from_json(raw)
        with open(raw, "r", encoding="utf-8") as f:
            return cls.from_json(f.read())

    # -- firing ---------------------------------------------------------

    def fire(self, site: str, **ctx) -> Optional[FaultRule]:
        """Consult the plan at ``site``; returns the fired rule (the
        site interprets its action) or None."""
        rule = None
        with self._lock:
            for r in self.rules:
                if not r.matches(site, ctx):
                    continue
                r.seen += 1
                if r.seen <= r.after:
                    continue
                if r.count is not None and r.fired >= r.count:
                    continue
                if r.prob < 1.0 and self._rng.random() >= r.prob:
                    continue
                r.fired += 1
                key = (site, str(ctx.get("owner") or ctx.get("peer")
                                 or ctx.get("file") or ""), r.action)
                self._counters[key] = self._counters.get(key, 0) + 1
                rule = r
                break
            cb = (self._callbacks.get(rule.callback)
                  if rule is not None and rule.callback else None)
        if rule is None:
            return None
        from lux_tpu_torch import obs

        # plan name + SEED ride the event: a
        # stitched timeline showing an injected fault next to the spans
        # it perturbed must also name the exact reproduction recipe
        obs.point("fault.inject", plan=self.name, seed=self.seed,
                  site=site, action=rule.action, note=rule.note,
                  **{k: v for k, v in ctx.items() if v is not None})
        if cb is not None:
            cb()
        return rule

    # -- observability --------------------------------------------------

    def counters(self) -> List[dict]:
        """[{site, target, action, count}] — the prom_dump rows."""
        with self._lock:
            return [{"site": s, "target": t, "action": a, "count": n}
                    for (s, t, a), n in sorted(self._counters.items())]

    def total_fired(self) -> int:
        with self._lock:
            return sum(self._counters.values())

    def describe(self) -> str:
        """One line per rule with live seen/fired counts — printed by
        the chaos soak's failure report next to the seed."""
        lines = [f"FaultPlan {self.name!r} seed={self.seed}"]
        for i, r in enumerate(self.rules):
            lines.append(f"  [{i}] {json.dumps(r.to_dict(), sort_keys=True)}"
                         f" seen={r.seen} fired={r.fired}")
        return "\n".join(lines)
