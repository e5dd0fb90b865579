"""Declarative SLOs evaluated as multi-window burn rates — the layer
that turns the serving metrics stream into a yes/no production answer.

Counterpart of ``lux_tpu.obs.slo`` (a copy: the port imports nothing of
the reference; over one sample stream both give the same verdicts).  A
spec is DATA (JSON round-trip, like FaultPlans and VertexProgramSpecs):

    SLOSpec(name="reads",   kind="availability",  objective=0.999)
    SLOSpec(name="read_p99", kind="latency",      objective=0.99,
            threshold_ms=250.0)
    SLOSpec(name="fresh",   kind="staleness",     objective=0.99)
    SLOSpec(name="write_ack", kind="write_latency", objective=0.99,
            threshold_ms=500.0)

Semantics (the Google-SRE multiwindow shape):

* every observed event is GOOD or BAD per spec — ``availability``: any
  errored/timed-out/shed query is bad; ``latency``: a query slower
  than ``threshold_ms``; ``staleness``: a read served below its
  ``min_generation`` bound (the explicit stale-degrade tag);
  ``write_latency``: an admit->acked write slower than ``threshold_ms``;
* **burn rate** over a window = (bad/total in the window) / (1 -
  objective) — burn 1.0 spends the error budget exactly at the rate
  the objective allows; burn 14.4 over an hour-class window is the
  classic page threshold;
* a spec is **burning** when EVERY one of its windows exceeds its burn
  threshold (the long window proves it is real, the short window
  proves it is still happening); the verdict is ``ok`` / ``warn``
  (some window hot) / ``burning`` / ``no_data``.

**Exemplars**: each observation may carry the request's distributed
trace id (``obs/dtrace.py``); the engine keeps the most recent BAD
traces per spec — plus the WORST (slowest) observed trace as a
fallback — so a burning SLO links directly to offending timelines a
``tools/luxstitch.py`` stitch can open.  That is the whole point of
co-designing the two layers: the verdict names the traces.

Implementation: the engine snapshots its cumulative (bad, total)
counters on a min-gap cadence into a bounded ring; a window's burn is
the delta against the newest snapshot at least ``window_s`` old (or
the oldest available — a young engine reports over the span it has).
Pure stdlib: a serving controller that never touches the card owns one.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

KINDS = ("availability", "latency", "staleness", "write_latency")

#: kinds whose good/bad split needs a latency threshold
_THRESHOLD_KINDS = ("latency", "write_latency")

#: default multiwindow burn thresholds: (window seconds, burn-rate
#: threshold).  Scaled-down analogs of the SRE 1h/6h pair — serving
#: windows here are minutes, not days, and tests drive them with a
#: fake clock anyway.
DEFAULT_WINDOWS: Tuple[Tuple[float, float], ...] = (
    (60.0, 14.4), (300.0, 6.0))

#: how many bad-event trace ids each spec retains
MAX_EXEMPLARS = 4


class SLOSpecError(ValueError):
    """Malformed spec (unknown kind, bad objective/threshold/windows)."""


class SLOSpec:
    """One declarative objective.  ``objective`` is the good fraction
    promised (0 < objective < 1); ``threshold_ms`` splits good from bad
    for the latency kinds; ``windows`` is a ((seconds, burn_threshold),
    ...) tuple — ALL windows must burn for the spec to page."""

    def __init__(self, name: str, kind: str, objective: float = 0.99,
                 threshold_ms: Optional[float] = None,
                 windows: Sequence[Sequence[float]] = DEFAULT_WINDOWS,
                 description: str = ""):
        self.name = str(name)
        self.kind = str(kind)
        self.objective = float(objective)
        self.threshold_ms = (None if threshold_ms is None
                             else float(threshold_ms))
        self.windows = tuple((float(w), float(b)) for w, b in windows)
        self.description = str(description)
        self.validate()

    def validate(self) -> None:
        if self.kind not in KINDS:
            raise SLOSpecError(
                f"unknown SLO kind {self.kind!r}; expected one of "
                f"{KINDS}")
        if not (0.0 < self.objective < 1.0):
            raise SLOSpecError(
                f"objective must be in (0, 1), got {self.objective} "
                f"(spec {self.name!r})")
        if self.kind in _THRESHOLD_KINDS and (
                self.threshold_ms is None or self.threshold_ms <= 0):
            raise SLOSpecError(
                f"{self.kind} spec {self.name!r} needs threshold_ms > 0")
        if not self.windows:
            raise SLOSpecError(f"spec {self.name!r} needs >= 1 window")
        for w, b in self.windows:
            if w <= 0 or b <= 0:
                raise SLOSpecError(
                    f"spec {self.name!r}: windows need positive "
                    f"(seconds, burn threshold), got ({w}, {b})")

    # -- data form ------------------------------------------------------

    def to_dict(self) -> dict:
        out = {"name": self.name, "kind": self.kind,
               "objective": self.objective,
               "windows": [list(w) for w in self.windows]}
        if self.threshold_ms is not None:
            out["threshold_ms"] = self.threshold_ms
        if self.description:
            out["description"] = self.description
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "SLOSpec":
        known = {"name", "kind", "objective", "threshold_ms", "windows",
                 "description"}
        unknown = set(d) - known
        if unknown:
            raise SLOSpecError(
                f"unknown spec fields {sorted(unknown)} (known: "
                f"{sorted(known)})")
        if "name" not in d or "kind" not in d:
            raise SLOSpecError(f"spec needs name + kind: {d}")
        return cls(**d)


def specs_from_json(text: str) -> List[SLOSpec]:
    """A JSON list of spec objects -> [SLOSpec] (the file/env form)."""
    try:
        data = json.loads(text)
    except ValueError as e:
        raise SLOSpecError(f"bad SLO JSON: {e}") from None
    if not isinstance(data, list):
        raise SLOSpecError(f"SLO JSON must be a list of specs: {data!r}")
    return [SLOSpec.from_dict(d) for d in data]


class _SpecState:
    __slots__ = ("spec", "bad", "total", "bad_traces", "worst")

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self.bad = 0
        self.total = 0
        #: most recent bad-event trace ids (the offending timelines)
        self.bad_traces: "collections.deque" = collections.deque(
            maxlen=MAX_EXEMPLARS)
        #: (value, trace_id) of the worst traced observation — the
        #: exemplar of last resort, so a green latency SLO still links
        #: SOMETHING a human can open
        self.worst: Optional[Tuple[float, str]] = None


class SLOEngine:
    """Evaluates a set of :class:`SLOSpec` over an observation stream.

    Observations arrive via ``observe_query`` / ``observe_write`` (the
    fleet controller calls these from its resolve paths); ``status()``
    returns one verdict row per spec.  Thread-safe; bounded memory
    (snapshot ring capped to the longest window, exemplar deques
    capped)."""

    #: minimum seconds between counter snapshots (bounds ring growth
    #: under a hot observe stream)
    SNAPSHOT_MIN_GAP_S = 0.05

    def __init__(self, specs: Sequence[SLOSpec], clock=time.monotonic):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise SLOSpecError(f"duplicate spec names: {names}")
        self.clock = clock
        self._lock = threading.Lock()
        self._states: Dict[str, _SpecState] = {
            s.name: _SpecState(s) for s in specs}
        self._horizon_s = max(
            (w for s in specs for w, _ in s.windows), default=60.0)
        #: (t, {name: (bad, total)}) ring; capacity sized so the oldest
        #: retained snapshot always predates the longest window
        cap = max(int(self._horizon_s / self.SNAPSHOT_MIN_GAP_S) + 8, 64)
        self._snaps: "collections.deque" = collections.deque(maxlen=cap)
        self._last_snap_t: Optional[float] = None

    @property
    def specs(self) -> List[SLOSpec]:
        with self._lock:
            return [st.spec for st in self._states.values()]

    # -- the observation stream ----------------------------------------

    def observe_query(self, latency_s: Optional[float], ok: bool = True,
                      stale: bool = False,
                      trace_id: Optional[str] = None) -> None:
        """One resolved fleet query: ``ok=False`` for errors/timeouts/
        sheds (availability-bad), ``stale`` for an answer served below
        its read bound (staleness-bad), ``latency_s`` scored against
        every ``latency`` spec."""
        self._observe(("availability", "latency", "staleness"),
                      latency_s, ok=ok, stale=stale, trace_id=trace_id)

    def observe_write(self, latency_s: Optional[float], ok: bool = True,
                      trace_id: Optional[str] = None) -> None:
        """One admitted write: admit->all-acked wall time vs the
        ``write_latency`` threshold; a failed admit is bad outright."""
        self._observe(("write_latency",), latency_s, ok=ok, stale=False,
                      trace_id=trace_id)

    def _observe(self, kinds, latency_s, ok, stale, trace_id) -> None:
        now = self.clock()
        with self._lock:
            for st in self._states.values():
                spec = st.spec
                if spec.kind not in kinds:
                    continue
                if spec.kind in ("availability", "write_latency") \
                        and not ok:
                    bad = True
                elif not ok:
                    # errored queries carry no meaningful latency/
                    # staleness signal; availability owns them
                    continue
                elif spec.kind == "staleness":
                    bad = bool(stale)
                elif spec.kind in _THRESHOLD_KINDS:
                    if latency_s is None:
                        continue
                    bad = latency_s * 1e3 > spec.threshold_ms
                else:  # availability, ok event
                    bad = False
                st.total += 1
                st.bad += int(bad)
                if trace_id is not None:
                    if bad:
                        st.bad_traces.append(str(trace_id))
                    v = latency_s if latency_s is not None else 0.0
                    if st.worst is None or v > st.worst[0]:
                        st.worst = (v, str(trace_id))
            self._maybe_snapshot(now)

    def _maybe_snapshot(self, now: float) -> None:
        if (self._last_snap_t is not None
                and now - self._last_snap_t < self.SNAPSHOT_MIN_GAP_S):
            return
        self._last_snap_t = now
        self._snaps.append((now, {n: (st.bad, st.total)
                                  for n, st in self._states.items()}))

    # -- evaluation -----------------------------------------------------

    def _window_base(self, now: float, window_s: float):
        """The newest snapshot at least ``window_s`` old (or the oldest
        we have — a young engine scores over its whole life)."""
        base = None
        for t, counts in self._snaps:
            if now - t >= window_s:
                base = (t, counts)
            else:
                break
        if base is None and self._snaps:
            base = self._snaps[0]
        return base

    def status(self, now: Optional[float] = None) -> List[dict]:
        """One verdict row per spec:

        ``{name, kind, objective, threshold_ms, total, bad, windows:
        {"60s": {burn, bad, total, burning}}, verdict, exemplar_traces}``

        ``verdict``: ``no_data`` (nothing observed), ``burning`` (every
        window over its threshold), ``warn`` (some window over), else
        ``ok``."""
        now = self.clock() if now is None else now
        out: List[dict] = []
        with self._lock:
            self._maybe_snapshot(now)
            for name, st in self._states.items():
                spec = st.spec
                budget = 1.0 - spec.objective
                windows = {}
                hot = 0
                for window_s, burn_thresh in spec.windows:
                    base = self._window_base(now, window_s)
                    b0, t0 = base[1].get(name, (0, 0)) if base else (0, 0)
                    dbad, dtot = st.bad - b0, st.total - t0
                    frac = (dbad / dtot) if dtot else 0.0
                    burn = frac / budget if budget > 0 else 0.0
                    burning = bool(dtot and burn > burn_thresh)
                    hot += int(burning)
                    windows[f"{window_s:g}s"] = {
                        "burn": round(burn, 3), "bad": dbad,
                        "total": dtot, "threshold": burn_thresh,
                        "burning": burning}
                if not st.total:
                    verdict = "no_data"
                elif hot == len(spec.windows):
                    verdict = "burning"
                elif hot:
                    verdict = "warn"
                else:
                    verdict = "ok"
                exemplars = list(st.bad_traces)
                if not exemplars and st.worst is not None:
                    exemplars = [st.worst[1]]
                row = {"name": name, "kind": spec.kind,
                       "objective": spec.objective,
                       "total": st.total, "bad": st.bad,
                       "windows": windows, "verdict": verdict,
                       "exemplar_traces": exemplars}
                if spec.threshold_ms is not None:
                    row["threshold_ms"] = spec.threshold_ms
                out.append(row)
        return out

    def verdicts(self, now: Optional[float] = None) -> Dict[str, str]:
        """``{spec name: verdict}`` — the compact form the autopilot
        policy/autoscaler layers match rules against."""
        return {r["name"]: r["verdict"] for r in self.status(now=now)}

    def prom_lines(self) -> List[str]:
        """The verdicts as Prometheus gauges (merged into the
        controller's own exposition): burn per (slo, window), and a
        0/1/2 verdict code (ok/warn/burning; no_data absent)."""
        rows = self.status()
        lines: List[str] = []
        burn_rows = [(r["name"], w, d["burn"]) for r in rows
                     for w, d in r["windows"].items() if r["total"]]
        if burn_rows:
            name = "lux_slo_burn_rate"
            lines.extend([f"# HELP {name} error-budget burn rate per "
                          "SLO window", f"# TYPE {name} gauge"])
            lines.extend(
                f'{name}{{slo="{s}",window="{w}"}} {v}'
                for s, w, v in burn_rows)
        code = {"ok": 0, "warn": 1, "burning": 2}
        verd = [(r["name"], code[r["verdict"]]) for r in rows
                if r["verdict"] in code]
        if verd:
            name = "lux_slo_verdict"
            lines.extend([f"# HELP {name} SLO verdict "
                          "(0 ok, 1 warn, 2 burning)",
                          f"# TYPE {name} gauge"])
            lines.extend(f'{name}{{slo="{s}"}} {v}' for s, v in verd)
        return lines


#: verdict severity order, mildest first — ``worst_verdict`` and the
#: autoscaler's hot/idle decision rank against this
VERDICT_ORDER = ("no_data", "ok", "warn", "burning")


def worst_verdict(rows) -> str:
    """The most severe verdict across status rows (``"no_data"`` for an
    empty set) — the one-word fleet health the autopilot layers key
    their decisions on."""
    worst = 0
    for r in rows:
        v = r.get("verdict") if isinstance(r, dict) else str(r)
        if v in VERDICT_ORDER:
            worst = max(worst, VERDICT_ORDER.index(v))
    return VERDICT_ORDER[worst]


def default_fleet_slos(read_p99_ms: float = 500.0,
                       write_ack_ms: float = 1000.0,
                       windows: Sequence[Sequence[float]] = (
                           (15.0, 10.0), (60.0, 2.0))) -> List[SLOSpec]:
    """The standing serving objectives: request availability, read
    latency, read freshness, write-ack latency.  Windows of seconds, not
    hours (a benchmark window must fit inside its own run)."""
    return [
        SLOSpec("read_availability", "availability", objective=0.99,
                windows=windows,
                description="queries answered (not shed/errored/"
                            "timed out)"),
        SLOSpec("read_latency", "latency", objective=0.95,
                threshold_ms=read_p99_ms, windows=windows,
                description="queries under the latency bound"),
        SLOSpec("read_freshness", "staleness", objective=0.99,
                windows=windows,
                description="bounded reads served at-or-above their "
                            "generation bound"),
        SLOSpec("write_ack", "write_latency", objective=0.95,
                threshold_ms=write_ack_ms, windows=windows,
                description="writes journaled + replica-acked under "
                            "the bound"),
    ]
