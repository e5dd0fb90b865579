"""Degraded-mode admission policy as DATA.

Counterpart of ``lux_tpu.serve.autopilot.policy``: the same JSON, so a
policy written for either package loads in the other.  The fleet has
three degraded answers — shed at admission, serve-stale with an explicit
tag, queue behind saturated replicas — and the SLO engine's multiwindow
burn-rate verdicts say when each is warranted.  An
:class:`AdmissionPolicy` makes the choice a JSON-round-trip spec, like
FaultPlans and SLOSpecs:

    AdmissionPolicy([
        PolicyRule(slo="read_latency",      verdict="burning",
                   mode="shed"),
        PolicyRule(slo="read_freshness",    verdict="burning",
                   mode="stale_degrade"),
        PolicyRule(slo="*",                 verdict="warn",
                   mode="queue"),
    ], max_shed_frac=0.5)

Semantics: ``decide(status_rows)`` scans the rules IN ORDER against
the SLO engine's verdict rows (``slo`` is an fnmatch glob over spec
names, ``verdict`` matches that spec's current verdict); the first
rule whose (slo, verdict) pair is live wins and names the fleet's
admission mode.  No match -> ``default_mode`` (normally ``serve``).
The controller re-evaluates on its heartbeat cadence and gates
``_dispatch`` on the result; every mode SWITCH emits a
``pilot.policy.switch`` incident span and bumps
``lux_pilot_policy_switches_total``.

``max_shed_frac`` is the policy's load-shedding budget: a DOCUMENTED
bound on the shed fraction the operator accepts while the policy
holds the fleet in ``shed`` mode.  The autoscale bench records its
measured shed fraction against it — the acceptance criterion that
"shed stays bounded by the installed AdmissionPolicy".

Pure stdlib, importable by the controller process.
"""
from __future__ import annotations

import fnmatch
import json
from typing import Optional, Sequence, Tuple

#: admission modes, mildest first; must match the controller's prom
#: gauge coding (fleet/controller._POLICY_MODE_CODE — test-pinned)
MODES = ("serve", "queue", "stale_degrade", "shed")

#: verdicts a rule may match (obs/slo.py's vocabulary)
VERDICTS = ("no_data", "ok", "warn", "burning")


class PolicyError(ValueError):
    """Malformed policy/rule (unknown mode/verdict, bad bounds)."""


class PolicyRule:
    """One (slo glob, verdict) -> mode mapping.  ``slo`` is an fnmatch
    glob over SLO spec names (``"*"`` matches any); ``verdict`` is the
    exact verdict that arms the rule; ``note`` documents intent and
    rides the switch span as the reason."""

    def __init__(self, slo: str = "*", verdict: str = "burning",
                 mode: str = "shed", note: str = ""):
        self.slo = str(slo)
        self.verdict = str(verdict)
        self.mode = str(mode)
        self.note = str(note)
        self.validate()

    def validate(self) -> None:
        if self.mode not in MODES:
            raise PolicyError(
                f"unknown mode {self.mode!r}; expected one of {MODES}")
        if self.verdict not in VERDICTS:
            raise PolicyError(
                f"unknown verdict {self.verdict!r}; expected one of "
                f"{VERDICTS}")

    def matches(self, rows: Sequence[dict]) -> Optional[str]:
        """The name of the first status row arming this rule, or
        None."""
        for r in rows:
            if (fnmatch.fnmatchcase(str(r.get("name")), self.slo)
                    and str(r.get("verdict")) == self.verdict):
                return str(r.get("name"))
        return None

    def to_dict(self) -> dict:
        out = {"slo": self.slo, "verdict": self.verdict,
               "mode": self.mode}
        if self.note:
            out["note"] = self.note
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "PolicyRule":
        known = {"slo", "verdict", "mode", "note"}
        unknown = set(d) - known
        if unknown:
            raise PolicyError(
                f"unknown rule fields {sorted(unknown)} (known: "
                f"{sorted(known)})")
        return cls(**d)


class AdmissionPolicy:
    """An ordered rule list plus the defaults around it.

    ``decide(status_rows) -> (mode, reason)``: first armed rule wins;
    ``reason`` names the rule's slo/verdict (and note) for the switch
    span.  ``default_mode`` is the answer when nothing is armed —
    ``serve`` for production policies; tests and drills use it to
    force a mode without fabricating burn."""

    def __init__(self, rules: Sequence[PolicyRule] = (),
                 default_mode: str = "serve",
                 max_shed_frac: float = 1.0, name: str = "policy"):
        self.rules = list(rules)
        self.default_mode = str(default_mode)
        self.max_shed_frac = float(max_shed_frac)
        self.name = str(name)
        self.validate()

    def validate(self) -> None:
        if self.default_mode not in MODES:
            raise PolicyError(
                f"unknown default_mode {self.default_mode!r}; expected "
                f"one of {MODES}")
        if not (0.0 <= self.max_shed_frac <= 1.0):
            raise PolicyError(
                f"max_shed_frac must be in [0, 1], got "
                f"{self.max_shed_frac}")
        for r in self.rules:
            r.validate()

    def decide(self, status_rows: Sequence[dict]
               ) -> Tuple[str, str]:
        """The policy's answer for the CURRENT verdicts: first rule
        (in list order) whose (slo glob, verdict) pair is live."""
        for r in self.rules:
            hit = r.matches(status_rows)
            if hit is not None:
                reason = f"{hit}={r.verdict}"
                if r.note:
                    reason = f"{reason} ({r.note})"
                return r.mode, reason
        return self.default_mode, "default"

    # -- data form ------------------------------------------------------

    def to_dict(self) -> dict:
        return {"name": self.name, "default_mode": self.default_mode,
                "max_shed_frac": self.max_shed_frac,
                "rules": [r.to_dict() for r in self.rules]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: dict) -> "AdmissionPolicy":
        if not isinstance(d, dict) or "rules" not in d:
            raise PolicyError(
                f"policy must be an object with a 'rules' list, got "
                f"{d!r}")
        known = {"name", "default_mode", "max_shed_frac", "rules"}
        unknown = set(d) - known
        if unknown:
            raise PolicyError(
                f"unknown policy fields {sorted(unknown)} (known: "
                f"{sorted(known)})")
        return cls([PolicyRule.from_dict(r) for r in d["rules"]],
                   default_mode=str(d.get("default_mode", "serve")),
                   max_shed_frac=float(d.get("max_shed_frac", 1.0)),
                   name=str(d.get("name", "policy")))

    @classmethod
    def from_json(cls, text: str) -> "AdmissionPolicy":
        try:
            d = json.loads(text)
        except ValueError as e:
            raise PolicyError(f"bad policy JSON: {e}") from None
        return cls.from_dict(d)


def default_fleet_policy(max_shed_frac: float = 0.5
                         ) -> AdmissionPolicy:
    """The standing degrade ladder over ``default_fleet_slos``: shed
    only for burning availability/latency, serve-stale for burning
    freshness, queue through any warning — mildest sufficient answer
    first, shedding budget bounded."""
    return AdmissionPolicy([
        PolicyRule(slo="read_freshness", verdict="burning",
                   mode="stale_degrade",
                   note="stale beats absent for freshness burn"),
        PolicyRule(slo="read_availability", verdict="burning",
                   mode="shed", note="protect the survivors"),
        PolicyRule(slo="read_latency", verdict="burning", mode="shed",
                   note="latency burn means the queues are the problem"),
        PolicyRule(slo="*", verdict="warn", mode="queue",
                   note="absorb warns in the worker queues"),
    ], max_shed_frac=max_shed_frac, name="default_fleet_policy")
