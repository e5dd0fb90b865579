"""Counterexample -> FaultPlan export: a model checker trace becomes a
seeded, replayable fault schedule.

Counterpart of the election mapping of ``lux_tpu.analysis.proto.export``
(the same rules, seed and plan name, so both packages export the same
JSON for the same counterexample).  A broken-twin counterexample is a
SCHEDULE — an ordering of detect / claim / promote / crash steps that
breaks an invariant.  The fault engine (``lux_tpu_torch.fault.plan``)
imposes schedules on the real code: ``delay`` rules stretch a window
open at a named process point.  The first ``claim_win(sA)`` becomes a
``delay`` at ``election.promote`` for standby A (hold the promotion
window open); a later ``claim_win(sB)``/``detect(sB)`` becomes a
``delay`` at ``election.detect`` for standby B (make it the late TOCTOU
detector).  ``fault.chaos.election_drill`` replays it: unfenced group +
exported plan => a REAL second election; the real fenced group + the
same plan => one election.

The plan's seed is derived deterministically from the trace, so the
exported JSON is bit-stable for a given counterexample.
"""
from __future__ import annotations

import hashlib
import re
from typing import List

from lux_tpu_torch.analysis.proto.mc import CheckResult, Violation
from lux_tpu_torch.fault.plan import FaultPlan, FaultRule

#: how long the exported schedule holds the winner's promotion open /
#: stalls the late detector — generous multiples of the drill's probe
#: cadence (hb 10ms, death 30ms) so the replay is schedule-stable
PROMOTE_HOLD_MS = 1500.0
DETECT_STALL_MS = 500.0


def trace_seed(violation: Violation) -> int:
    """Deterministic plan seed from the counterexample trace."""
    digest = hashlib.sha256(
        "\n".join(violation.trace).encode()).hexdigest()
    return int(digest[:8], 16)


def _election_rules(trace: tuple) -> List[FaultRule]:
    wins = [m.group(1) for a in trace
            for m in [re.match(r"claim_win\(s(\d+)\)", a)] if m]
    first = wins[0] if wins else "0"
    late = next((w for w in wins[1:] if w != first), None)
    if late is None:
        # no second claimant in the trace: stall every OTHER detector
        late = "1" if first != "1" else "0"
    return [
        FaultRule("proc", "delay", point="election.promote",
                  owner=f"standby-{first}", count=1,
                  delay_ms=PROMOTE_HOLD_MS,
                  note=f"hold s{first}'s promotion window open "
                       f"(trace: claim_win(s{first}) first)"),
        FaultRule("proc", "delay", point="election.detect",
                  owner=f"standby-{late}", count=1,
                  delay_ms=DETECT_STALL_MS,
                  note=f"make s{late} the late detector (trace: its "
                       "claim lands after the first winner)"),
    ]


def export_faultplan(result: CheckResult) -> FaultPlan:
    """The FaultPlan whose schedule replays ``result``'s
    counterexample against the real implementation.  Raises
    ``ValueError`` for a clean result — there is nothing to export."""
    v = result.violation
    if v is None:
        raise ValueError(
            f"{result.protocol}: clean check has no counterexample "
            "to export")
    rules = {"election": _election_rules}.get(result.protocol)
    if rules is None:
        raise ValueError(
            f"no FaultPlan mapping for protocol {result.protocol!r}")
    return FaultPlan(
        rules(v.trace), seed=trace_seed(v),
        name=f"luxproto-{result.protocol}-counterexample")


def export_json(result: CheckResult) -> str:
    return export_faultplan(result).to_json()
