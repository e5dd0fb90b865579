"""Distributed request tracing (host half).

Counterpart of ``lux_tpu.obs.dtrace`` (a copy: the port imports nothing
of the reference).  A :class:`TraceContext` — ``(trace_id, span_id,
parent_span_id, flags)`` — is minted at a service's entry points and
carried on every frame as a compact ``tc`` header; every hop records
ordinary recorder spans INTO ITS OWN per-process event log with the
context as span attrs (``trace``/``span``/``parent_span``), so the logs
a run already writes are the trace store.

**Identity is deterministic where retries need it to be**: a context
minted from a key (a client ``request_id``, a write's ``write_id``)
derives its trace id and its ROOT span id from a keyed blake2b, so for
the same key the ids equal the reference's, and every retry of one
logical request lands in the same trace.

**Cost contract**: one ``None`` check when disabled (``LUX_DTRACE=0``);
a sampled context costs two hashes at mint plus a few JSONL lines per
hop.  ``LUX_DTRACE_SAMPLE`` (0..1) head-samples at the root — an
unsampled context still PROPAGATES (flags bit clear) so a downstream hop
never half-records a trace.  The sampling decision is derived from the
trace id, so every process agrees on it without coordination.

Pure stdlib, like the recorder.
"""
from __future__ import annotations

import hashlib
import itertools
import os
import threading
from typing import Optional

# NOTE: importing the ``recorder`` MODULE through the package would
# resolve to the package attribute of that name — the singleton
# accessor FUNCTION re-exported by __init__ — so pull the three
# needed symbols straight from the submodule instead
from lux_tpu_torch.obs.recorder import point as _point
from lux_tpu_torch.obs.recorder import recorder as _recorder_fn
from lux_tpu_torch.obs.recorder import span as _span

ENABLE_ENV = "LUX_DTRACE"
SAMPLE_ENV = "LUX_DTRACE_SAMPLE"

#: flags bit 0: this trace is sampled (hops record spans/points)
FLAG_SAMPLED = 1

_STATE_LOCK = threading.Lock()
#: tri-state override: None = follow the env, True/False = forced (the
#: trace-overhead probe flips this mid-run; tests scope it)
_FORCED: Optional[bool] = None


def enabled() -> bool:
    """Tracing master switch: ``LUX_DTRACE`` (default on; ``0``/``off``
    disables minting entirely — frames carry no header, hops cost one
    ``None`` check).  ``set_enabled`` overrides the env for the
    process (the overhead probe's A/B lever)."""
    with _STATE_LOCK:
        forced = _FORCED
    if forced is not None:
        return forced
    return os.environ.get(ENABLE_ENV, "1").strip().lower() not in (
        "0", "off", "false")


def set_enabled(value: Optional[bool]) -> None:
    """Force tracing on/off for this process (None = back to the env).
    Locked: a caller may flip it while worker threads are serving."""
    global _FORCED
    with _STATE_LOCK:
        _FORCED = value


def sample_rate() -> float:
    """Root head-sampling probability, ``LUX_DTRACE_SAMPLE`` in [0, 1]
    (default 1.0 — every request traced; a million-user fleet dials
    this down and keeps the deterministic keyed traces reproducible)."""
    from lux_tpu_torch.utils.config import env_float

    return env_float(SAMPLE_ENV, 1.0, minimum=0.0, maximum=1.0)


def _hex_hash(text: str, nbytes: int) -> str:
    return hashlib.blake2b(text.encode("utf-8"),
                           digest_size=nbytes).hexdigest()


#: unkeyed ids: a per-process random prefix + an atomic counter —
#: unique across the fleet's processes without an os.urandom syscall
#: per id (ids are metadata, like run ids; they never feed a result)
_ID_PREFIX = os.urandom(4).hex()
_ID_SEQ = itertools.count(1)


def _next_id() -> str:
    return f"{_ID_PREFIX}{next(_ID_SEQ) & 0xFFFFFFFF:08x}"


def _sampled_for(trace_id: str, rate: float) -> bool:
    """Deterministic per-trace sampling decision: hash the trace id
    into [0, 1) and compare — every process (and every RETRY of a
    keyed trace) agrees without coordination, and no process-global
    RNG is consulted."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    draw = int(hashlib.blake2b(trace_id.encode("utf-8"),
                               digest_size=8).hexdigest(), 16)
    return (draw / float(1 << 64)) < rate


class TraceContext:
    """One position in one trace: the header a fleet frame carries.

    ``trace_id`` names the logical request end to end; ``span_id``
    names THIS hop's span; ``parent_span_id`` is the causal link the
    stitcher follows.  Contexts are immutable — ``child()`` mints the
    next hop."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "flags")

    def __init__(self, trace_id: str, span_id: str,
                 parent_span_id: Optional[str] = None,
                 flags: int = FLAG_SAMPLED):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)
        self.parent_span_id = (None if parent_span_id is None
                               else str(parent_span_id))
        self.flags = int(flags)

    @property
    def sampled(self) -> bool:
        return bool(self.flags & FLAG_SAMPLED)

    def child(self) -> "TraceContext":
        """The next hop: fresh span id, this span as parent, same trace
        and flags."""
        return TraceContext(self.trace_id, _next_id(),
                            parent_span_id=self.span_id,
                            flags=self.flags)

    # -- wire form ------------------------------------------------------

    def to_wire(self) -> dict:
        out = {"t": self.trace_id, "s": self.span_id, "f": self.flags}
        if self.parent_span_id is not None:
            out["p"] = self.parent_span_id
        return out

    @classmethod
    def from_wire(cls, d) -> Optional["TraceContext"]:
        if not isinstance(d, dict) or "t" not in d or "s" not in d:
            return None
        return cls(d["t"], d["s"], d.get("p"), int(d.get("f", 0)))

    def attrs(self) -> dict:
        """The span-attr triple every traced hop records — what
        luxstitch keys the cross-process links on."""
        out = {"trace": self.trace_id, "span": self.span_id}
        if self.parent_span_id is not None:
            out["parent_span"] = self.parent_span_id
        return out

    def __repr__(self) -> str:  # drill failure reports print these
        return (f"TraceContext({self.trace_id}/{self.span_id}"
                f"<-{self.parent_span_id} f={self.flags})")


def mint(key: Optional[str] = None) -> Optional[TraceContext]:
    """A ROOT context, or None when tracing is disabled.

    ``key`` (a request_id / ``w:<write_id>``) derives trace AND root
    span ids deterministically, so every retry of one logical request —
    across attempts, envelopes, and controller incarnations — is ONE
    trace.  ``key=None`` mints random ids (an untraceable one-off)."""
    if not enabled():
        return None
    if key is not None:
        trace_id = _hex_hash(f"lux:{key}", 8)
        span_id = _hex_hash(f"lux:{key}/root", 6)
    else:
        trace_id = _next_id()
        span_id = _next_id()
    flags = FLAG_SAMPLED if _sampled_for(trace_id, sample_rate()) else 0
    return TraceContext(trace_id, span_id, flags=flags)


def incident(key: str) -> Optional[TraceContext]:
    """A keyed ROOT context for an operational INCIDENT: an
    autopilot scale action, a controller election, a policy-mode
    switch.  Identical to ``mint(key)`` except the head-sampling
    decision is forced ON: ``LUX_DTRACE_SAMPLE`` exists to thin the
    per-REQUEST trace store, and autonomous control actions are orders
    of magnitude rarer than requests — a fleet that scaled itself or
    elected a controller must ALWAYS be able to render that incident
    as one stitched timeline, whatever the request sampling dial says.
    Still None when tracing is disabled outright (``LUX_DTRACE=0``)."""
    if not enabled():
        return None
    return TraceContext(_hex_hash(f"lux:{key}", 8),
                        _hex_hash(f"lux:{key}/root", 6),
                        flags=FLAG_SAMPLED)


def wire_ctx(msg: dict) -> Optional[TraceContext]:
    """The context a received frame carries (``msg['tc']``), or None."""
    tc = msg.get("tc")
    return TraceContext.from_wire(tc) if tc is not None else None


def child_of(msg: dict) -> Optional[TraceContext]:
    """The context THIS hop should record under: a child of the frame's
    header (the sender's span is the causal parent)."""
    ctx = wire_ctx(msg)
    return ctx.child() if ctx is not None else None


class _NullSpan:
    """No-op stand-in so call sites write one line whether or not the
    request is traced."""

    __slots__ = ()
    dur = 0.0
    ok = True

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


def tspan(name: str, ctx: Optional[TraceContext], always: bool = False,
          **attrs):
    """An ordinary recorder span enriched with ``ctx``'s trace attrs.
    ``ctx=None`` records the plain span (existing single-process
    behavior); an UNSAMPLED context records nothing (the null span) —
    propagate silently, never half-trace.

    ``always=True`` is for OPERATIONAL spans (takeover, republish,
    delta install, hello) that predate tracing as unconditional
    recorder spans: sampling exists to thin the request-rate TRACE
    store, not the local flight recorder, so an unsampled operational
    span still records PLAIN (no trace attrs — the trace stays
    untouched) instead of vanishing from the post-mortem."""
    attrs = {k: v for k, v in attrs.items() if v is not None}
    if ctx is None:
        return _span(name, **attrs)
    if not ctx.sampled:
        return _span(name, **attrs) if always else _NULL
    return _span(name, **{**ctx.attrs(), **attrs})


def emit_span(name: str, ctx: Optional[TraceContext], t0: float,
              t1: float, ok: bool = True, **attrs) -> None:
    """Retroactive traced span (begin/end measured on different
    threads — the fleet request/attempt shape); see
    ``Recorder.emit_span`` for why this bypasses the nesting stack."""
    if ctx is None or not ctx.sampled:
        return
    attrs = {k: v for k, v in attrs.items() if v is not None}
    _recorder_fn().emit_span(name, t0, t1, ok=ok,
                             attrs={**ctx.attrs(), **attrs})


def wire_point(direction: str, tc: dict, op, peer, owner) -> None:
    """The skew-correction stamp the wire layer drops per traced frame:
    ``dtrace.send`` on the sender, ``dtrace.recv`` on the receiver,
    paired by the header's span id.  Only sampled frames stamp (bit
    check on the RAW wire dict — the hot path never builds a
    TraceContext)."""
    if not (int(tc.get("f", 0)) & FLAG_SAMPLED):
        return
    _point(f"dtrace.{direction}", trace=tc.get("t"),
           span=tc.get("s"), op=op, peer=peer, owner=owner)
