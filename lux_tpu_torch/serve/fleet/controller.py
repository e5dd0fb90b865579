"""Fleet controller: admission, routing, placement, republish.

Counterpart of ``lux_tpu.serve.fleet.controller`` (a copy: the port
imports nothing of the reference; the wire protocol is the same).

The controller half of the controller/worker split.  It owns:

* **Membership** — a registry of `ReplicaWorker` endpoints and a
  consistent-hash ring (``fleet/hashring.py``) over the live ones.
  Worker death is detected two ways: the connection reset a kill causes,
  and heartbeat staleness for wedged-but-connected workers.  Either way
  the worker leaves the ring (moving only its ~1/R of the key space) and
  its in-flight queries are transparently re-dispatched to ring
  successors.
* **Routing** — every query maps to a ``(app, graph_id, Q-slot)`` key
  (``route_key``); the owner is the first live, unsaturated worker on
  the ring walk from that key.  Slot affinity keeps repeat queries on
  the same replica's warm engines so its Q-bucket batches run full.
* **Backpressure + shedding** — each worker's queue-depth/shed
  heartbeat (``serve/metrics.py`` counters over the ``stats`` op) marks
  it saturated past ``sat_frac`` of its admission bound; saturated
  workers are skipped on the ring walk, and when EVERY live worker is
  saturated the controller sheds at admission with a ``retry_after_ms``
  hint — the fleet-level analog of the scheduler's bounded-queue reject.
  A worker-side shed reply (the race where a queue filled between
  heartbeats) is retried on the next ring successor before any caller
  sees an error: degraded, never wrong.
* **Republish** — ``republish(path)`` is a two-phase barrier: every
  worker ``prepare``s (loads + prewarms the new snapshot NEXT TO the
  serving engines), and only when all preparations succeed does the
  controller send ``commit`` (an atomic cache-pointer swap per worker).
  Admission never pauses, so zero requests are rejected because of the
  swap; a failed prepare on any worker aborts the whole republish with
  the old graph still serving everywhere.

Everything here is stdlib + numpy: the controller never imports torch
(graph math lives in the workers, each a CUDA process of its own), so it
stays responsive no matter what the engines are doing.  ``takeover``,
``serve_lease``, ``set_policy``/``policy_tick`` and ``rebalance_preview``
are the seams the autopilot (``serve/autopilot``: failover election,
admission policy, autoscaler) drives.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from lux_tpu_torch import fault
from lux_tpu_torch.obs import dtrace
from lux_tpu_torch.obs.slo import SLOEngine
from lux_tpu_torch.serve.fleet.hashring import (
    DEFAULT_SLOTS,
    DEFAULT_VNODES,
    EmptyRingError,
    HashRing,
    h64,
    route_key,
)
from lux_tpu_torch.serve.fleet.pubproto import publish_token
from lux_tpu_torch.serve.fleet.stream import negotiate_chunk_bytes, stream_file
from lux_tpu_torch.serve.fleet.wire import (
    Conn,
    ConnectionClosed,
    WireError,
    max_frame_bytes,
)
from lux_tpu_torch.utils.backoff import Backoff, retry_call
from lux_tpu_torch.utils.config import env_float

#: admission-policy modes and their prom gauge codes (in the order of
#: serve/autopilot/policy.MODES — test-pinned)
_POLICY_MODE_CODE = {"serve": 0, "queue": 1, "stale_degrade": 2,
                     "shed": 3}


class FleetError(RuntimeError):
    """Fleet-level request failure (no retry succeeded)."""


class WorkerRefusedError(FleetError):
    """A worker refused the handshake for a PERMANENT reason (e.g. the
    split-brain guard: its journal is ahead of this controller's) —
    retrying the same hello cannot succeed, so reconnect loops must
    surface this instead of backing off forever."""

    def __init__(self, kind: str, err: str):
        super().__init__(f"worker refused handshake ({kind}): {err}")
        self.kind = kind


class FleetRejectedError(FleetError):
    """Fleet-wide load shed: every live worker is saturated."""

    def __init__(self, retry_after_ms: float):
        super().__init__(
            f"fleet saturated; retry after {retry_after_ms:.0f} ms")
        self.retry_after_ms = retry_after_ms


class NoWorkersError(FleetError):
    """No live workers registered."""


class FleetTimeoutError(FleetError, TimeoutError):
    """The request's deadline expired (in a worker queue or on the wire)."""


class StaleReadError(FleetError):
    """A ``min_generation`` read bound no live worker currently
    satisfies (replication still in flight, or a recovering worker
    mid-catch-up).  Retry, or read without the bound and accept the
    generation tag the answer carries."""

    def __init__(self, min_generation: int, best: int):
        super().__init__(
            f"no live worker has replicated generation {min_generation} "
            f"yet (freshest replica serves {best}); retry or drop the "
            "min_generation bound")
        self.min_generation = int(min_generation)
        self.best = int(best)


class FleetFuture:
    """Handle to one fleet-routed query."""

    def __init__(self, app: str, source: int,
                 timeout_ms: Optional[float],
                 min_generation: Optional[int] = None,
                 stale_ok: bool = False,
                 request_id: Optional[str] = None):
        self.app = app
        self.source = int(source)
        self.timeout_ms = timeout_ms
        #: read-your-writes bound: only workers whose applied mutation
        #: generation is >= this may answer (None = any replica)
        self.min_generation = min_generation
        #: opt-in bounded-staleness degrade: when NO replica satisfies
        #: min_generation, serve from the freshest one anyway and tag
        #: the answer ``stale`` instead of raising StaleReadError — the
        #: caller inspects ``generation`` (always carried) to see HOW
        #: stale, which is the bound
        self.stale_ok = bool(stale_ok)
        #: True iff the answer's generation is below min_generation —
        #: the explicit degrade tag the stale_ok contract promises
        self.stale = False
        self._degrade_counted = False  # one counter bump per query
        #: idempotent client request id: ONE id across every retry /
        #: re-dispatch of this logical query (reads are idempotent, so
        #: replay is safe; the id keeps flight-recorder timelines and
        #: retry counters attributable to one logical request)
        self.request_id = request_id
        #: distributed trace context (obs/dtrace.py): the ROOT of this
        #: logical request's trace, minted by submit.  Derived from
        #: request_id when one exists, so envelope retries and replays
        #: against a promoted controller stay ONE trace.  None when
        #: tracing is disabled.
        self.tc: Optional[dtrace.TraceContext] = None
        #: mutation generation the ANSWER reflects (None on a
        #: static-snapshot fleet) — always >= min_generation when set
        #: unless ``stale`` is True
        self.generation: Optional[int] = None
        self.worker_id: Optional[str] = None  # who answered
        self.rounds = 0
        self.traversed = 0
        self.attempts = 0
        #: attempts already spent by the retry ENVELOPE on earlier
        #: futures of the same logical request — added to the wire
        #: ``attempt`` number (so replicas can count envelope retries)
        #: without consuming this future's own ring-walk retry budget
        self.attempt_base = 0
        self.t_submit = time.monotonic()
        self.t_done: Optional[float] = None
        #: controller-installed SLO observer, called INSIDE _resolve
        #: before waiters wake — a slo_status() right after result()
        #: must already include this request (done callbacks run after
        #: the event, which would race that read)
        self._slo_hook = None
        self._cb_lock = threading.Lock()
        self._event = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self._callbacks: List = []

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        """The resolution error (None while pending or on success) —
        the SLO engine's good/bad split reads this without racing
        ``result()``'s raise."""
        with self._cb_lock:
            return self._error if self._event.is_set() else None

    @property
    def trace_id(self) -> Optional[str]:
        """The distributed trace id this request records under (link
        into a luxstitch timeline); None when tracing is off."""
        return None if self.tc is None else self.tc.trace_id

    def add_done_callback(self, fn) -> None:
        """Call ``fn(self)`` when the future resolves (immediately if it
        already did).  Runs on the resolving thread — keep it O(1); it
        exists so closed-loop clients can track in-flight counts without
        scanning (a scanning client measures itself, not the fleet)."""
        run_now = False
        with self._cb_lock:
            if self._event.is_set():
                run_now = True
            else:
                self._callbacks.append(fn)
        if run_now:
            fn(self)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise FleetTimeoutError("no result within wait timeout")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency_s(self) -> Optional[float]:
        """Client-observed submit-to-resolve wall time (the number the
        saturation bench's percentiles are built from)."""
        return None if self.t_done is None else self.t_done - self.t_submit

    def _resolve(self, result=None, error=None) -> None:
        with self._cb_lock:
            if self._event.is_set():
                return  # first resolution wins — a racing duplicate
                # dispatch must never overwrite a result waiters saw
            self._result = result
            self._error = error
            self.t_done = time.monotonic()
            if self._slo_hook is not None:
                try:
                    # error passed explicitly: the hook runs under
                    # _cb_lock, and the .error property re-takes it
                    self._slo_hook(self, error)
                except Exception:  # noqa: BLE001 — scoring can never
                    pass           # fail a request
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        # the request's ROOT span, emitted retroactively (begin on the
        # submitting thread, end here on whichever thread resolved it
        # — emit_span bypasses the recorder's nesting stack on purpose)
        dtrace.emit_span(
            "fleet.request", self.tc, self.t_submit, self.t_done,
            ok=error is None, app=self.app, source=self.source,
            worker=self.worker_id, attempts=self.attempts,
            stale=self.stale or None,
            kind=None if error is None else type(error).__name__)
        for fn in cbs:
            fn(self)


class _HandedOff(Exception):
    """Internal: a send failed AND _retire had already harvested the
    pending — the future's ownership moved to the retire path, so the
    sender must NOT dispatch it again."""


class _Pending:
    """One outstanding frame awaiting a worker reply."""

    def __init__(self, kind: str, fut: Optional[FleetFuture] = None,
                 tc: Optional[dtrace.TraceContext] = None):
        self.kind = kind  # "query" | "rpc"
        self.fut = fut
        #: this ATTEMPT's trace context (a child of the future's root;
        #: the wire frame carried the same ids) — its span is emitted
        #: when the attempt concludes, on whichever path that happens
        self.tc = tc
        self.reply: Optional[dict] = None
        self.arr: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.event = threading.Event()
        self.t0 = time.monotonic()  # the abandoned-pending sweep key

    def end_span(self, name: str, ok: bool, **attrs) -> None:
        if self.tc is not None:
            dtrace.emit_span(name, self.tc, self.t0, time.monotonic(),
                             ok=ok, **attrs)


_INCARNATION_LOCK = threading.Lock()
_INCARNATION_SEQ = 0


def _next_incarnation() -> str:
    """Globally-unique controller incarnation tag (pid + a locked
    counter + an os.urandom token): two controllers — same process
    (tests), a restart (failover), a standby on ANOTHER host, or a
    successor that landed on a reused pid — can never mint colliding
    publish tokens.  pid+counter alone only holds within one process
    lifetime; the random token carries the guarantee across hosts and
    pid wraparound (a dead predecessor's staged cache must never
    exact-match a successor's commit)."""
    global _INCARNATION_SEQ
    with _INCARNATION_LOCK:
        _INCARNATION_SEQ += 1
        return (f"c{os.getpid()}x{_INCARNATION_SEQ}"
                f"-{os.urandom(6).hex()}")


class _WorkerHandle:
    def __init__(self, wid: str, conn: Conn, info: dict):
        self.wid = wid
        self.conn = conn
        self.info = info
        self.alive = True
        self.saturated = False
        self.last_hb: dict = {}
        #: when the oldest stats probe sent since the last frame from
        #: this worker went out (None: every probe was answered); a
        #: probe unanswered past the lease is the death verdict
        self.asked: Optional[float] = None
        self.pending: Dict[str, _Pending] = {}
        self.reader: Optional[threading.Thread] = None
        #: highest mutation generation this worker acknowledged as
        #: SERVABLE (delta acks + heartbeats keep it fresh); the
        #: min_generation routing bound filters on it.  0 on a
        #: static-snapshot fleet — min_generation=None ignores it.
        self.delta_gen = 0


class FleetController:
    def __init__(self, hb_interval_s: Optional[float] = None,
                 hb_timeout_s: Optional[float] = None,
                 sat_frac: float = 0.8,
                 retries: int = 3, slots: int = DEFAULT_SLOTS,
                 vnodes: int = DEFAULT_VNODES):
        # the heartbeat cadence and death threshold are env knobs,
        # resolved HERE in the constructing thread (never inside the
        # heartbeat loop), with bounds and errors that name the knob:
        # standby election timeouts must be a multiple of the death
        # threshold to avoid false promotions
        if hb_interval_s is None:
            hb_interval_s = env_float("LUX_FLEET_HEARTBEAT_S", 0.25,
                                      minimum=0.01, maximum=60.0)
        if hb_timeout_s is None:
            hb_timeout_s = env_float("LUX_FLEET_DEATH_S", 3.0,
                                     minimum=0.05, maximum=600.0)
        self.hb_interval_s = float(hb_interval_s)
        self.hb_timeout_s = float(hb_timeout_s)
        self.sat_frac = float(sat_frac)
        self.retries = int(retries)
        self.slots = int(slots)
        self._lock = threading.Lock()
        self._ring = HashRing(vnodes)
        self._workers: Dict[str, _WorkerHandle] = {}
        self._graph_id: Optional[str] = None
        self._seq = 0
        self._closed = False
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        # fleet-level counters (the controller's own observability row)
        self._counts = {"submitted": 0, "completed": 0, "shed": 0,
                        "rerouted": 0, "worker_deaths": 0,
                        "republishes": 0, "errors": 0, "retries": 0,
                        "timeouts": 0, "stale_degraded": 0,
                        "failovers": 0}
        #: per-worker retry/timeout/stale attribution (prom labels)
        self._per_worker: Dict[str, Dict[str, int]] = {}
        #: SLO burn-rate engine (obs/slo.py), installed via set_slos();
        #: fed from the resolve paths, read via slo_status()
        self._slo: Optional[SLOEngine] = None
        #: autopilot state: the installed AdmissionPolicy
        #: (serve/autopilot/policy.py — duck-typed: anything with
        #: .decide(status_rows) -> (mode, reason)), the mode it most
        #: recently chose, the pilot action counters the Prometheus
        #: surface exposes, and the SubscriptionHub attach point
        self._policy = None
        self._policy_mode = "serve"
        self._pilot_counts = {"scale_up": 0, "scale_down": 0,
                              "elections": 0, "policy_switches": 0,
                              "sub_pushes": 0, "sub_coalesced": 0}
        self._sub_hub = None
        #: lease listener: serve_lease() exposes ping() as a
        #: wire RPC so process-mode standbys can watch this incumbent
        self._lease_listener = None
        self._lease_conns: List[Conn] = []
        #: this controller incarnation's publish-token prefix: a
        #: PROMOTED controller restarts _seq at 0, and its tokens must
        #: never collide with a dead predecessor's still staged on a
        #: worker (the commit token check is exact-match)
        self._incarnation = _next_incarnation()

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------

    @property
    def graph_id(self) -> Optional[str]:
        with self._lock:
            return self._graph_id

    @property
    def incarnation(self) -> str:
        """This controller incarnation's fencing token: publish tokens
        carry it, takeover traces key on it, and a standby election is
        claimed AGAINST it (one election per dead incarnation)."""
        return self._incarnation

    def ping(self) -> dict:
        """Liveness probe for standby controllers: cheap,
        lock-only, and raising once the controller closed or was
        kill()ed — the in-process analog of a missed network heartbeat.
        Standbys probe on a jittered cadence and declare death only
        after the probe has failed for longer than the fleet's own
        worker death threshold (the knobs compose; see
        serve/autopilot/election.py).

        The reply IS a lease grant: it names this
        incarnation and the heartbeat/death intervals the prober should
        run at, so a WIRE standby (election.WireIncumbent over
        ``serve_lease``) needs no out-of-band agreement on cadence —
        the lease terms travel with every renewal."""
        with self._lock:
            if self._closed:
                raise FleetError("controller closed")
            return {"incarnation": self._incarnation,
                    "workers_alive": sum(
                        1 for h in self._workers.values() if h.alive),
                    "policy_mode": self._policy_mode,
                    "hb_interval_s": self.hb_interval_s,
                    "lease_s": self.hb_timeout_s}

    def serve_lease(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Expose ``ping()`` as a wire RPC so a standby in ANOTHER
        process can run the fenced election: a tiny listener
        answering ``{"op": "ping"|"lease"}`` frames with the lease
        grant.  Dies with the controller — ``kill()``/``close()`` drop
        the listener and every probe connection, which is exactly the
        death signal a wire standby watches for.  Returns the bound
        port (pass ``port=0`` for an ephemeral one)."""
        import socket as _socket

        with self._lock:
            if self._closed:
                raise FleetError("controller closed")
            if self._lease_listener is not None:
                return self._lease_listener.getsockname()[1]
            srv = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
            srv.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
            srv.bind((host, int(port)))
            srv.listen(8)
            self._lease_listener = srv
        t = threading.Thread(target=self._lease_accept_loop, args=(srv,),
                             name="lux-fleet-lease", daemon=True)
        t.start()
        return srv.getsockname()[1]

    def _lease_accept_loop(self, srv) -> None:
        while True:
            try:
                sock, _addr = srv.accept()
            except OSError:
                return  # listener closed: controller death
            conn = Conn(sock, peer="standby", owner="controller-lease")
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._lease_conns.append(conn)
            threading.Thread(
                target=self._lease_conn_loop, args=(conn,),
                name="lux-fleet-lease-conn", daemon=True).start()

    def _lease_conn_loop(self, conn: Conn) -> None:
        while True:
            try:
                msg, _arr = conn.recv()
            except (ConnectionClosed, WireError):
                break
            op = msg.get("op")
            if op not in ("ping", "lease"):
                try:
                    conn.send({"req_id": msg.get("req_id"), "ok": False,
                               "err": f"lease port speaks ping/lease "
                                      f"only, not {op!r}"})
                except ConnectionClosed:
                    break
                continue
            try:
                pong = self.ping()
            except FleetError:
                # closed: drop the connection — silence IS the death
                # signal; an "I'm dead" reply would be a live answer
                break
            try:
                conn.send({"req_id": msg.get("req_id"), "ok": True,
                           **pong})
            except ConnectionClosed:
                break
        conn.close()

    def _close_lease(self) -> None:
        import socket as _socket

        with self._lock:
            srv, self._lease_listener = self._lease_listener, None
            conns, self._lease_conns = self._lease_conns, []
        if srv is not None:
            # shutdown() first: close() alone does not wake the lease
            # accept thread parked in accept() on Linux — it would sit
            # on the dead fd forever, one leaked thread per controller
            # lifetime
            try:
                srv.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass  # never connected / already down
            try:
                srv.close()
            except OSError:
                pass
        for c in conns:
            c.close()

    def add_worker(self, host: str, port: int,
                   timeout_s: float = 60.0,
                   tc: Optional[dtrace.TraceContext] = None) -> str:
        """Connect + handshake a worker and put it on the ring.  The
        first worker pins the fleet's graph_id; later joins must serve
        the same graph (a mismatched replica would answer WRONG, which
        is worse than answering slow).  ``tc``: the trace context of
        the operation driving this join (a takeover's re-hello sweep),
        carried on the hello frame so the worker's hello span links
        causally."""
        from lux_tpu_torch import obs

        conn = Conn.connect(host, port, timeout_s=timeout_s,
                            owner="controller")
        handle = _WorkerHandle("?", conn, {})
        handle.reader = threading.Thread(
            target=self._read_loop, args=(handle,),
            name="lux-fleet-ctl-read", daemon=True)
        handle.reader.start()
        hello = {"op": "hello", **self._hello_info()}
        htc = tc.child() if tc is not None else None
        t_hello = time.monotonic()
        if htc is not None:
            hello["tc"] = htc.to_wire()
        p = self._send(handle, hello, _Pending("rpc"))
        if not p.event.wait(timeout_s) or p.error or not p.reply:
            conn.close()
            dtrace.emit_span("fleet.hello", htc, t_hello,
                             time.monotonic(), ok=False,
                             peer=f"{host}:{port}")
            raise FleetError(f"worker at {host}:{port} failed handshake: "
                             f"{p.error}")
        if not p.reply.get("ok", True):
            # the worker REFUSED (split-brain guard and friends):
            # permanent — surfaced as its own type so reconnect/
            # failover loops stop instead of backing off forever
            conn.close()
            dtrace.emit_span("fleet.hello", htc, t_hello,
                             time.monotonic(), ok=False,
                             peer=f"{host}:{port}",
                             kind=str(p.reply.get("kind")))
            raise WorkerRefusedError(str(p.reply.get("kind")),
                                     str(p.reply.get("err")))
        info = p.reply
        wid = str(info["worker_id"])
        w_bound = info.get("max_frame_bytes")
        if w_bound is not None and int(w_bound) != max_frame_bytes():
            # the other direction of the handshake guard: a worker
            # framing to a different bound would drop OUR oversized
            # frames mid-protocol instead of erroring
            conn.close()
            raise FleetError(
                f"worker {wid} at {host}:{port} frames at most "
                f"{int(w_bound)} payload bytes but this controller "
                f"frames {max_frame_bytes()} — set "
                "LUX_FLEET_MAX_FRAME_MB identically in both "
                "environments")
        conn.label(peer=wid)
        with self._lock:
            if self._closed:
                conn.close()
                raise FleetError("controller closed")
            if wid in self._workers and self._workers[wid].alive:
                conn.close()
                raise FleetError(f"worker id {wid!r} already registered")
            if self._graph_id is None:
                self._graph_id = str(info["graph_id"])
            elif str(info["graph_id"]) != self._graph_id:
                conn.close()
                raise FleetError(
                    f"worker {wid} serves graph {info['graph_id']!r}, "
                    f"fleet serves {self._graph_id!r}")
            handle.wid = wid
            handle.info = info
            self._workers[wid] = handle
            self._ring.add(wid)
        dtrace.emit_span("fleet.hello", htc, t_hello, time.monotonic(),
                         ok=True, worker=wid)
        obs.point("fleet.worker.join", worker=wid,
                  graph=str(info["graph_id"]), nv=info.get("nv"))
        self._ensure_heartbeat()
        return wid

    def _hello_info(self) -> dict:
        """Extra hello fields the worker validates us against: our
        payload frame bound (the worker refuses a mismatch — a frame
        one peer sends and the other refuses to receive is a dropped
        connection, not an error reply) and, for the live subclass, the
        journal generation the split-brain guard compares."""
        return {"max_frame_bytes": max_frame_bytes()}

    def remove_worker(self, wid: str, shutdown: bool = True) -> None:
        """Graceful leave: take the worker off the ring (its keys move to
        ring successors), optionally ask it to drain and exit."""
        with self._lock:
            handle = self._workers.get(wid)
            if handle is None or not handle.alive:
                return
        if shutdown:
            try:
                self._rpc(handle, {"op": "shutdown"}, timeout_s=10.0)
            except FleetError:
                pass  # it may already be gone; the goal is absence
        self._retire(handle, cause="leave")

    def takeover(self, endpoints: Sequence[Tuple[str, int]],
                 deadline_s: float = 30.0, seed: int = 0) -> dict:
        """Failover promotion: rebuild the ring on THIS
        (fresh/standby) controller from worker re-hellos.  Per
        endpoint, ``add_worker`` is retried with jittered exponential
        backoff until ``deadline_s`` — a worker mid-GC or mid-batch
        answers late, not never — EXCEPT a WorkerRefusedError
        (split-brain guard), which is permanent and recorded, not
        retried.  After the joins, every worker gets a ``discard``: a
        dead predecessor's aborted republish must not leave staged
        caches armed under tokens only it knew (this re-arms the
        publish-token state from zero).

        Returns {joined: [wid...], failed: {host:port: err}, refused:
        {host:port: err}}.  Subclasses recover their own state BEFORE
        calling this (the live controller replays its journal in
        __init__ and re-syncs behind workers inside add_worker)."""
        from lux_tpu_torch import obs

        joined: List[str] = []
        failed: Dict[str, str] = {}
        refused: Dict[str, str] = {}
        # the takeover trace: keyed on THIS incarnation, so the
        # re-hello spans every worker records parent into one
        # timeline entry next to the write trace the failover
        # interrupted (the kill-mid-write drill's stitched view)
        ttc = dtrace.mint(key=f"takeover:{self._incarnation}")
        with dtrace.tspan("fleet.takeover", ttc, always=True,
                          endpoints=[f"{h}:{p}" for h, p in endpoints]):
            for i, (host, port) in enumerate(endpoints):
                bo = Backoff(seed=seed + i)
                deadline = time.monotonic() + float(deadline_s)
                while True:
                    try:
                        joined.append(self.add_worker(host, port,
                                                      timeout_s=10.0,
                                                      tc=ttc))
                        break
                    except WorkerRefusedError as e:
                        refused[f"{host}:{port}"] = str(e)
                        break
                    except (FleetError, OSError) as e:
                        if time.monotonic() >= deadline:
                            failed[f"{host}:{port}"] = str(e)
                            break
                        bo.sleep()
            with self._lock:
                handles = [h for h in self._workers.values() if h.alive]
                self._counts["failovers"] += 1
            self._discard_staged(handles)
        obs.point("fleet.takeover.done", joined=joined,
                  failed=sorted(failed), refused=sorted(refused))
        return {"joined": joined, "failed": failed, "refused": refused}

    def kill(self) -> None:
        """Fault drill: the controller VANISHES — every worker
        connection drops with no shutdown, no drain, no goodbye (the
        peer-visible shape of a controller SIGKILL; workers keep
        serving and wait to be re-helloed by a successor).  In-process
        waiters differ from a real crash in one deliberate way: their
        futures resolve with a 'controller closed' error instead of
        dying with the process, so drill clients unblock and exercise
        their retry envelopes."""
        from lux_tpu_torch import obs

        obs.point("fleet.controller.kill")
        self._hb_stop.set()
        with self._lock:
            self._closed = True
            handles = list(self._workers.values())
        for h in handles:
            h.conn.close()
        self._close_lease()

    def workers(self) -> Dict[str, dict]:
        with self._lock:
            return {
                wid: {"alive": h.alive, "saturated": h.saturated,
                      "last_hb": dict(h.last_hb)}
                for wid, h in self._workers.items()
            }

    def live_workers(self) -> List[str]:
        with self._lock:
            return sorted(w for w, h in self._workers.items() if h.alive)

    # ------------------------------------------------------------------
    # wire plumbing
    # ------------------------------------------------------------------

    def _next_rid(self) -> str:
        with self._lock:
            self._seq += 1
            return f"r{self._seq}"

    def _send(self, handle: _WorkerHandle, msg: dict,
              pending: _Pending) -> _Pending:
        rid = self._next_rid()
        msg = {**msg, "req_id": rid}
        with self._lock:
            handle.pending[rid] = pending
        try:
            handle.conn.send(msg)
        except ConnectionClosed:
            with self._lock:
                still_mine = handle.pending.pop(rid, None) is not None
            if not still_mine:
                # the reader's _retire beat us to it: it already
                # harvested this pending as an orphan and re-dispatched
                # (query) or failed (rpc) it — dispatching again from
                # here would put the SAME future in flight twice
                raise _HandedOff() from None
            self._on_conn_lost(handle)
            raise
        return pending

    def _rpc(self, handle: _WorkerHandle, msg: dict,
             timeout_s: float) -> dict:
        try:
            p = self._send(handle, msg, _Pending("rpc"))
        except (ConnectionClosed, _HandedOff):
            raise FleetError(f"worker {handle.wid} unreachable") from None
        if not p.event.wait(timeout_s):
            raise FleetError(
                f"worker {handle.wid} did not answer {msg.get('op')!r} "
                f"within {timeout_s}s")
        if p.error is not None:
            raise FleetError(str(p.error))
        if not p.reply.get("ok"):
            raise FleetError(
                f"worker {handle.wid} {msg.get('op')}: "
                f"{p.reply.get('kind')}: {p.reply.get('err')}")
        return p.reply

    def _count_worker(self, wid: str, key: str, n: int = 1) -> None:
        """Per-worker counter bump (prom label attribution); caller
        must NOT hold self._lock."""
        with self._lock:
            d = self._per_worker.setdefault(
                wid, {"retries": 0, "timeouts": 0, "stale_served": 0})
            d[key] = d.get(key, 0) + n

    def _read_loop(self, handle: _WorkerHandle) -> None:
        while True:
            try:
                msg, arr = handle.conn.recv()
            except (ConnectionClosed, WireError, fault.InjectedKill):
                break
            rid = msg.get("req_id")
            with self._lock:
                p = handle.pending.pop(rid, None)
                handle.asked = None
            if p is None:
                continue  # late reply for a retried/abandoned request
            if p.kind == "query":
                self._resolve_query(handle, p, msg, arr)
            else:
                p.reply = msg
                p.arr = arr
                p.event.set()
        self._on_conn_lost(handle)

    def _on_conn_lost(self, handle: _WorkerHandle) -> None:
        if handle.wid == "?":  # handshake never completed
            return
        self._retire(handle, cause="death")

    def _retire(self, handle: _WorkerHandle, cause: str) -> None:
        """Take a worker out of service; re-dispatch its in-flight
        queries on the survivors and fail its in-flight rpcs."""
        from lux_tpu_torch import obs

        with self._lock:
            if not handle.alive:
                return
            if self._closed:
                # controller teardown closes every conn; the readers'
                # resulting ConnectionClosed is shutdown, not death —
                # a clean close must not mint worker_deaths or spray
                # fleet.worker.down events into the flight recorder.
                # In-flight work still RESOLVES (a dropped future hangs
                # its waiter forever; an error is strictly better)
                handle.alive = False
                leftovers = list(handle.pending.values())
                handle.pending.clear()
            else:
                leftovers = None
        if leftovers is not None:
            closed_err = FleetError("controller closed")
            for p in leftovers:
                if p.kind == "query":
                    p.fut._resolve(error=closed_err)
                else:
                    p.error = closed_err
                    p.event.set()
            return
        with self._lock:
            if not handle.alive:
                return
            handle.alive = False
            if handle.wid in self._ring.workers():
                self._ring.remove(handle.wid)
            orphans = list(handle.pending.values())
            handle.pending.clear()
            if cause == "death":
                self._counts["worker_deaths"] += 1
        obs.point("fleet.worker.down", worker=handle.wid, cause=cause,
                  orphans=len(orphans))
        handle.conn.close()
        for p in orphans:
            p.end_span("fleet.attempt", ok=False, worker=handle.wid,
                       kind=f"worker_{cause}")
            if p.kind == "query":
                with self._lock:
                    self._counts["rerouted"] += 1
                    self._counts["retries"] += 1
                self._count_worker(handle.wid, "retries")
                self._dispatch(p.fut, exclude={handle.wid})
            else:
                p.error = FleetError(f"worker {handle.wid} {cause}")
                p.event.set()

    # ------------------------------------------------------------------
    # admission + routing
    # ------------------------------------------------------------------

    def route(self, source: int, app: str = "sssp") -> str:
        """The ring OWNER of a query's (app, graph, Q-slot) key — where
        it lands when nothing is saturated (deterministic; tests replay
        this across processes)."""
        with self._lock:
            if self._graph_id is None:
                raise NoWorkersError("no workers registered")
            return self._ring.route(
                route_key(app, self._graph_id, source, self.slots))

    def _candidates(self, app: str, source: int,
                    exclude: Set[str]) -> List[_WorkerHandle]:
        with self._lock:
            if self._graph_id is None:
                return []
            try:
                order = self._ring.successors(
                    route_key(app, self._graph_id, source, self.slots),
                    len(self._ring))
            except EmptyRingError:
                return []
            return [self._workers[w] for w in order
                    if w not in exclude and self._workers[w].alive]

    def _retry_after_ms(self) -> float:
        hints = []
        with self._lock:
            for h in self._workers.values():
                if h.alive and h.last_hb:
                    hints.append(float(h.last_hb.get("queue_depth", 0)))
        # no service-time estimate fleet-wide: one coalescing window per
        # queued-batch of backlog is the same shape the scheduler uses
        return 10.0 * (1.0 + max(hints, default=0.0) / 8.0)

    def submit(self, source: int, app: str = "sssp",
               timeout_ms: Optional[float] = None,
               min_generation: Optional[int] = None,
               stale_ok: bool = False,
               request_id: Optional[str] = None,
               attempt_offset: int = 0) -> FleetFuture:
        """Route + dispatch one query; returns a FleetFuture.  Raises
        FleetRejectedError synchronously when the whole fleet is
        saturated (admission backpressure), NoWorkersError when empty,
        StaleReadError when ``min_generation`` (the read-your-writes
        bound: only replicas that have applied that mutation generation
        may answer) is ahead of every live replica — unless
        ``stale_ok``, which DEGRADES that case instead: the freshest
        live replica answers, and the future comes back with
        ``stale=True`` plus the generation it actually served (the
        explicit bounded-staleness tag)."""
        fut = FleetFuture(app, source, timeout_ms,
                          min_generation=min_generation,
                          stale_ok=stale_ok, request_id=request_id)
        fut.attempt_base = int(attempt_offset)
        # the trace root: keyed on the request id when one exists, so
        # every envelope retry (and a replay against a PROMOTED
        # controller) lands in the same trace (obs/dtrace.py)
        fut.tc = dtrace.mint(
            key=None if request_id is None else f"q:{request_id}")
        with self._lock:
            if self._slo is not None:
                fut._slo_hook = self._slo_observe
        with self._lock:
            self._counts["submitted"] += 1
        try:
            self._dispatch(fut, exclude=set(), sync_raise=True)
        except FleetError as e:
            # synchronous admission failures (shed / staleness miss /
            # empty fleet) still close the trace root and score the
            # SLO — resolving the future is harmless (the caller gets
            # the raise and drops it) and keeps the availability
            # numbers honest about sheds
            fut._resolve(error=e)
            raise
        return fut

    def submit_retrying(self, source: int, app: str = "sssp",
                        deadline_s: float = 30.0,
                        attempt_timeout_s: float = 5.0,
                        timeout_ms: Optional[float] = None,
                        min_generation: Optional[int] = None,
                        stale_ok: bool = False,
                        request_id: Optional[str] = None,
                        backoff: Optional[Backoff] = None) -> FleetFuture:
        """The hardened client envelope: submit + wait with
        a CLIENT deadline, retrying fleet sheds (honoring their
        ``retry_after_ms`` hint, jitter on top), staleness misses,
        worker timeouts and transient fleet errors until ``deadline_s``
        of wall time is spent — then the LAST error raises.

        Retried: sheds, staleness misses, timeouts, and empty-fleet
        windows (a failover in progress).  NOT retried: plain
        FleetError — a worker-reported op error ("app not served",
        an engine exception), retries-exhausted, or a closed
        controller is the same answer every time, and burning the
        whole client deadline re-asking would just delay it.

        ``attempt_timeout_s`` bounds each TRY separately from the
        overall deadline: a request frame lost on the wire (or a
        worker that died holding it) resolves nothing, and waiting the
        whole client deadline on one dead attempt would turn every
        lost frame into a full-deadline stall — the classic
        per-request-timeout vs end-to-end-deadline split.  One
        ``request_id`` spans every attempt (minted from the submit
        counter when not given), so retries stay one logical request
        in the flight recorder and the retry counters; queries are
        idempotent reads, so replay is safe.  Returns the RESOLVED
        future (``result()`` cannot block or raise)."""
        if request_id is None:
            request_id = f"q{self._next_rid()[1:]}"
        # jitter seeded per LOGICAL REQUEST (the unique request id), not
        # per source: N clients retrying the same source must draw
        # DIFFERENT delay sequences, or a fleet-wide shed wakes them in
        # lockstep every round — the herd full jitter exists to prevent
        bo = backoff if backoff is not None else Backoff(
            seed=h64(f"{request_id}/{source}"))
        deadline = time.monotonic() + float(deadline_s)
        state = {"attempts": 0, "last": None}

        def on_retry(exc, n):
            state["attempts"] = n
            state["last"] = exc
            with self._lock:
                self._counts["retries"] += 1

        def attempt() -> FleetFuture:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # our deadline and retry_call's are computed from two
                # monotonic() reads microseconds apart — at expiry,
                # re-raise the LAST REAL error (the documented
                # contract) rather than minting a synthetic timeout
                # that would mask it; retry_call's own expired
                # deadline then re-raises it unchanged
                last = state["last"]
                if last is not None:
                    raise last
                raise FleetTimeoutError(
                    f"client deadline of {deadline_s}s spent "
                    f"(request {request_id})")
            fut = self.submit(source, app=app, timeout_ms=timeout_ms,
                              min_generation=min_generation,
                              stale_ok=stale_ok, request_id=request_id,
                              attempt_offset=state["attempts"])
            # raises the worker/fleet error; an unresolved future past
            # the attempt timeout raises FleetTimeoutError -> retried
            fut.result(timeout=min(remaining, float(attempt_timeout_s)))
            return fut

        out = retry_call(
            attempt,
            retry_on=(FleetRejectedError, StaleReadError,
                      FleetTimeoutError, NoWorkersError),
            deadline_s=deadline_s, backoff=bo, on_retry=on_retry)
        out.attempts += state["attempts"]  # envelope attempts included
        return out

    def _dispatch(self, fut: FleetFuture, exclude: Set[str],
                  sync_raise: bool = False) -> None:
        """Send ``fut`` to the first usable candidate on its ring walk.
        Resolution failures surface as exceptions only on the synchronous
        admission path; retries resolve the future instead."""
        from lux_tpu_torch import obs

        with self._lock:
            mode = self._policy_mode
        if mode == "shed":
            # the AdmissionPolicy chose shed: reject at
            # admission before any routing work, exactly like the
            # all-saturated shed — degraded by POLICY, never wrong
            with self._lock:
                self._counts["shed"] += 1
            obs.point("fleet.shed", app=fut.app, source=fut.source,
                      policy="shed")
            err = FleetRejectedError(self._retry_after_ms())
            if sync_raise:
                raise err
            fut._resolve(error=err)
            return
        # stale_degrade mode widens EVERY bounded read to the stale_ok
        # contract (freshest replica + explicit stale tag) without the
        # caller opting in — the policy's answer to a burning
        # freshness/latency SLO is "serve stale rather than error"
        stale_ok = fut.stale_ok or (mode == "stale_degrade"
                                    and fut.min_generation is not None)
        exclude = set(exclude)
        while True:
            degraded = False
            cands = self._candidates(fut.app, fut.source, exclude)
            fresh = cands if fut.min_generation is None else [
                h for h in cands if h.delta_gen >= fut.min_generation]
            if cands and not fresh and stale_ok:
                degraded = True
                # bounded-staleness degrade (opt-in): no replica meets
                # the bound, so the FRESHEST one answers and the future
                # carries stale=True + the served generation — an
                # explicitly tagged stale read instead of an error
                fresh = sorted(cands, key=lambda h: -h.delta_gen)
                if not fut._degrade_counted:
                    # once per LOGICAL query: the ring walk can loop
                    # (dead candidate) and re-dispatch can re-enter —
                    # neither is a second degrade decision.  This event
                    # records the DECISION; the stale_degraded COUNTER
                    # bumps at resolve time from the answer's actual
                    # tag (a replica that catches up mid-flight serves
                    # fresh — the counter must not claim otherwise)
                    fut._degrade_counted = True
                    obs.point("fleet.stale_degrade", app=fut.app,
                              source=fut.source,
                              want=fut.min_generation,
                              best=fresh[0].delta_gen)
            usable = [h for h in fresh if not h.saturated]
            if not usable and fresh and mode == "queue":
                # queue mode: admit past the saturation skip
                # and let the workers' own bounded queues absorb the
                # burst — the policy prefers queueing delay over sheds
                # while the SLO is only warning, and the worker-side
                # admission bound still backstops it
                usable = fresh
            if not usable:
                if cands and not fresh:
                    # replicas exist but none has caught up to the read
                    # bound: a staleness miss, not load or absence
                    err = StaleReadError(
                        fut.min_generation,
                        max(h.delta_gen for h in cands))
                elif fresh:  # alive + fresh but saturated: fleet shed
                    with self._lock:
                        self._counts["shed"] += 1
                    err = FleetRejectedError(self._retry_after_ms())
                    obs.point("fleet.shed", app=fut.app, source=fut.source)
                else:
                    err = NoWorkersError(
                        "no live worker can take this query")
                if sync_raise:
                    raise err
                fut._resolve(error=err)
                return
            handle = usable[0]
            if fut.attempts > self.retries:
                fut._resolve(error=FleetError(
                    f"retries exhausted after {fut.attempts} attempts"))
                return
            fut.attempts += 1
            msg = {"op": "query", "app": fut.app, "source": fut.source,
                   "attempt": fut.attempt_base + fut.attempts}
            atc = None
            if fut.tc is not None:
                # one child context per ATTEMPT: the frame carries it,
                # the worker's span parents on it, and its span is
                # emitted when the attempt concludes — so a retried
                # request shows every attempt as a sibling under the
                # one fleet.request root
                atc = fut.tc.child()
                msg["tc"] = atc.to_wire()
            if fut.timeout_ms:
                msg["timeout_ms"] = float(fut.timeout_ms)
            if fut.request_id is not None:
                msg["client_rid"] = str(fut.request_id)
            if degraded:
                # carry the read bound itself, not a pre-judged hint:
                # the replica counts a stale SERVE from its answer's
                # ACTUAL generation vs this bound, so a replica that
                # catches up mid-flight serves fresh and counts nothing
                # — per-worker and fleet-level stale counters agree
                msg["stale_bound"] = int(fut.min_generation)
            try:
                self._send(handle, msg,
                           _Pending("query", fut, tc=atc))
                return
            except _HandedOff:
                return  # _retire owns this future now; it re-dispatched
            except ConnectionClosed:
                exclude.add(handle.wid)  # this future never left _send's
                continue                 # hands; keep walking the ring

    def _resolve_query(self, handle: _WorkerHandle, p: _Pending,
                       msg: dict, arr) -> None:
        fut = p.fut
        p.end_span("fleet.attempt", ok=bool(msg.get("ok")),
                   worker=handle.wid,
                   kind=None if msg.get("ok") else msg.get("kind"))
        if msg.get("ok"):
            fut.worker_id = handle.wid
            fut.rounds = int(msg.get("rounds", 0))
            fut.traversed = int(msg.get("traversed", 0))
            gen = msg.get("generation")
            fut.generation = None if gen is None else int(gen)
            if (fut.min_generation is not None
                    and fut.generation is not None
                    and fut.generation < fut.min_generation):
                # the stale_ok degrade actually happened: tag it and
                # count it HERE, from the answer's real generation —
                # the authoritative "stale reads served" number
                fut.stale = True
                with self._lock:
                    self._counts["stale_degraded"] += 1
                self._count_worker(handle.wid, "stale_served")
            with self._lock:
                self._counts["completed"] += 1
            fut._resolve(result=arr)
            return
        kind = msg.get("kind")
        if kind == "shed":
            # the between-heartbeats race: this worker's queue filled
            # before its saturation was visible — believe it immediately
            # and walk the ring before any caller sees an error
            with self._lock:
                handle.saturated = True
                self._counts["rerouted"] += 1
                self._counts["retries"] += 1
            self._count_worker(handle.wid, "retries")
            self._dispatch(fut, exclude={handle.wid})
            return
        with self._lock:
            self._counts["errors"] += 1
        if kind == "timeout":
            with self._lock:
                self._counts["timeouts"] += 1
            self._count_worker(handle.wid, "timeouts")
            fut._resolve(error=FleetTimeoutError(str(msg.get("err"))))
        else:
            fut._resolve(error=FleetError(
                f"worker {handle.wid}: {msg.get('err')}"))

    # ------------------------------------------------------------------
    # heartbeats
    # ------------------------------------------------------------------

    def _ensure_heartbeat(self) -> None:
        with self._lock:
            if self._hb_thread is not None or self._closed:
                return
            self._hb_thread = threading.Thread(
                target=self._hb_loop, name="lux-fleet-ctl-hb", daemon=True)
            self._hb_thread.start()

    #: a pending older than this is presumed unanswerable (a frame lost
    #: on the wire never gets a reply; the envelope abandoned its future
    #: long ago) — swept by the heartbeat loop so handle.pending cannot
    #: grow for the lifetime of a connection under a lossy-wire fault
    #: plan.  This is also a HARD CAP on unbounded queries: a swept
    #: future resolves with FleetTimeoutError (first resolution wins),
    #: so a genuine answer arriving later is dropped as a late reply.
    #: Generous on purpose — an engine run that legitimately needs
    #: longer than this should carry its own timeout_ms budget.
    PENDING_SWEEP_S = 600.0

    def _sweep_stale_pending(self, handle: _WorkerHandle,
                             now: float) -> None:
        with self._lock:
            stale = [rid for rid, p in handle.pending.items()
                     if now - p.t0 > self.PENDING_SWEEP_S]
            dead = [handle.pending.pop(rid) for rid in stale]
        for p in dead:
            err = FleetTimeoutError(
                f"request to worker {handle.wid} unanswered for "
                f"{self.PENDING_SWEEP_S:g}s (frame lost?)")
            p.end_span("fleet.attempt", ok=False, worker=handle.wid,
                       kind="swept")
            if p.kind == "query":
                p.fut._resolve(error=err)
            else:
                p.error = err
                p.event.set()

    def _hb_loop(self) -> None:
        from lux_tpu_torch import obs

        while True:
            t_wait = time.monotonic()
            if self._hb_stop.wait(self.hb_interval_s):
                return
            try:
                # the seeded controller-death drill fires here
                # (fault/drills.controller_kill_at_heartbeat): the
                # rule's callback ran kill() — every worker conn is
                # already down with no goodbye — so this sweep thread
                # just stops; standby detection takes it from there
                fault.ppoint("controller.heartbeat", owner="controller")
            except fault.InjectedKill:
                return
            now = time.monotonic()
            # this thread's own stall past its wake-up (the interpreter
            # lock, a garbage collection, a starved core): the readers
            # may not have run in that window either, so an outstanding
            # probe is credited with it
            stall = now - t_wait - self.hb_interval_s
            with self._lock:
                handles = [h for h in self._workers.values() if h.alive]
                if stall > self.hb_interval_s:
                    for h in handles:
                        if h.asked is not None:
                            h.asked = min(h.asked + stall, now)
            if stall > self.hb_interval_s:
                obs.point("fleet.heartbeat_stall", seconds=round(stall, 3))
            for h in handles:
                self._sweep_stale_pending(h, now)
            # a worker is dead when a probe has gone unanswered for the
            # lease, not when the controller merely heard nothing: no
            # frame comes unasked, so silence while unprobed (a slow
            # sweep, a stalled controller) convicts no one.  Every live
            # worker is probed before any reply is awaited.
            probes = []
            for h in handles:
                with self._lock:
                    stale = (h.asked is not None
                             and now - h.asked > self.hb_timeout_s)
                if stale:
                    self._retire(h, cause="death")
                    continue
                with self._lock:
                    if h.asked is None:  # before the send: a reply clears it
                        h.asked = time.monotonic()
                try:
                    probes.append(
                        (h, self._send(h, {"op": "stats"}, _Pending("rpc"))))
                except (ConnectionClosed, _HandedOff):
                    continue  # worker retired under us; next round
            deadline = time.monotonic() + self.hb_timeout_s
            for h, p in probes:
                if not p.event.wait(max(deadline - time.monotonic(), 0.0)):
                    continue  # staleness check next round settles it
                if p.error is not None or not p.reply:
                    continue
                hb = p.reply
                was = h.saturated
                sat = (hb.get("queue_depth", 0)
                       >= self.sat_frac * max(hb.get("max_queue", 1), 1))
                with self._lock:
                    h.last_hb = hb
                    h.saturated = sat
                    if "delta_generation" in hb:
                        # monotonic max: a heartbeat raced by a delta
                        # ack must never move the routing bound BACK
                        h.delta_gen = max(h.delta_gen,
                                          int(hb["delta_generation"]))
                if was != sat:
                    obs.point("fleet.saturation", worker=h.wid,
                              saturated=sat,
                              depth=hb.get("queue_depth"))
            # the admission policy rides the heartbeat cadence: one
            # burn-rate evaluation per sweep, mode switches spanned
            self.policy_tick()

    # ------------------------------------------------------------------
    # republish
    # ------------------------------------------------------------------

    def republish(self, path: str, graph_id: Optional[str] = None,
                  prepare_timeout_s: float = 600.0,
                  commit_timeout_s: float = 30.0,
                  base_generation: Optional[int] = None) -> dict:
        """Zero-downtime graph republish across the whole fleet.

        Two-phase: (1) every live worker prepares (load + prewarm the new
        snapshot while the old engines keep serving — long, parallel);
        (2) only if EVERY prepare succeeded, every worker commits (an
        atomic cache-pointer swap — instant).  A failed prepare anywhere
        aborts with the old graph still serving everywhere; admission is
        never paused, so no request is ever rejected because of the swap.

        ``base_generation``: for LIVE (mutation-aware) fleets, the
        mutation generation the new snapshot embeds — workers stage a
        fresh LiveReplica on that epoch base alongside the staged cache
        (serve/live); a plain snapshot republish leaves it None.
        """
        from lux_tpu_torch import obs

        gid = graph_id if graph_id is not None else os.path.basename(
            str(path))
        with self._lock:
            handles = [h for h in self._workers.values() if h.alive]
        if not handles:
            raise NoWorkersError("republish with no live workers")
        # the publish token ties each worker's staged cache to THIS
        # republish: a stale prepare from an aborted earlier republish
        # can neither re-stage after our discard nor be committed by us.
        # The incarnation prefix keeps tokens unique across controller
        # RESTARTS — a promoted controller's _seq starts over, and its
        # commit must never match a dead predecessor's staged cache
        token = publish_token(self._incarnation, self._next_rid())
        # the republish trace: two-phase barrier as one timeline —
        # every worker's prepare/commit spans parent into it
        rtc = dtrace.mint(key=f"republish:{token}")
        with dtrace.tspan("fleet.republish", rtc, always=True, graph=gid,
                          path=str(path), token=token,
                          workers=[h.wid for h in handles]):
            # wire distribution: the controller reads the
            # snapshot bytes LOCALLY and streams them to each worker
            # over the framed connection, so ``path`` only has to exist
            # HERE — workers reassemble into their own private tmpdirs
            # and no shared filesystem is assumed anywhere.  Chunk size
            # is negotiated down to the smallest frame bound any worker
            # advertised at hello (older workers advertise nothing and
            # are assumed to match — the hello guard enforced it).
            bounds = [h.info.get("max_frame_bytes") for h in handles]
            bounds = [b for b in bounds if b is not None]
            chunk = negotiate_chunk_bytes(
                max_frame_bytes(), min(bounds) if bounds else None)
            meta = None
            for h in handles:
                def _begin(m, _h=h):
                    if rtc is not None:
                        m = {**m, "tc": rtc.to_wire()}
                    return self._rpc(_h, m, timeout_s=60.0)

                try:
                    meta = stream_file(h.conn, str(path), token, chunk,
                                       rpc=_begin)
                except (ConnectionClosed, _HandedOff):
                    self._discard_staged(handles)
                    raise FleetError(
                        f"worker {h.wid} died mid snapshot stream; "
                        "republish aborted (old graph still serving)"
                    ) from None
                except (FleetError, OSError) as e:
                    self._discard_staged(handles)
                    raise FleetError(
                        f"snapshot stream to worker {h.wid} failed: {e};"
                        " republish aborted (old graph still serving)"
                    ) from None
            prep_msg = {"op": "prepare", "graph_id": gid, "token": token,
                        "stream": True, "sha256": meta["sha256"]}
            if base_generation is not None:
                prep_msg["base_generation"] = int(base_generation)
            pendings = []
            for h in handles:
                try:
                    msg = {**prep_msg}
                    if rtc is not None:
                        # the republish ROOT rides every frame: worker
                        # prepare/commit spans parent directly under
                        # fleet.republish (one barrier, one timeline)
                        msg["tc"] = rtc.to_wire()
                    pendings.append((h, self._send(
                        h, msg, _Pending("rpc"))))
                except (ConnectionClosed, _HandedOff):
                    self._discard_staged(handles)
                    raise FleetError(
                        f"worker {h.wid} died before prepare") from None
            deadline = time.monotonic() + prepare_timeout_s
            for h, p in pendings:
                err = None
                if not p.event.wait(max(deadline - time.monotonic(),
                                        0.001)):
                    err = "prepare timed out"
                elif p.error is not None or not p.reply.get("ok"):
                    err = f"prepare failed: {p.error or p.reply.get('err')}"
                if err is not None:
                    # abort BEFORE any commit: old graph still serves
                    # everywhere; tell the workers whose prepare DID
                    # succeed to drop the staged cache (a fully-warmed
                    # second engine set must not sit resident forever)
                    self._discard_staged(handles)
                    raise FleetError(
                        f"worker {h.wid} {err}; republish aborted "
                        "(old graph still serving)")
            gens = {}
            commit_failed = []
            for h in handles:
                try:
                    cmsg = {"op": "commit", "token": token}
                    if rtc is not None:
                        cmsg["tc"] = rtc.to_wire()
                    rep = self._rpc(h, cmsg,
                                    timeout_s=commit_timeout_s)
                    gens[h.wid] = int(rep["generation"])
                except FleetError as e:
                    commit_failed.append((h, e))
            if not gens:
                # nothing swapped anywhere: clean abort on the old graph
                self._discard_staged(handles)
                raise FleetError(
                    "every commit failed; republish aborted (old graph "
                    f"still serving): {[str(e) for _, e in commit_failed]}")
            # point of no return: at least one replica serves the NEW
            # graph, so the fleet's graph IS gid now.  A worker whose
            # commit failed would keep serving the OLD graph under the
            # new id — mixed generations answer differently for the
            # same query, which is wrong, not degraded — so retire it
            # (its keys move to committed successors).
            for h, e in commit_failed:
                obs.point("fleet.commit_failed", worker=h.wid,
                          err=str(e))
                self._retire(h, cause="commit_failed")
            with self._lock:
                self._graph_id = gid
                self._counts["republishes"] += 1
        return {"graph_id": gid, "generations": gens,
                "retired": sorted(h.wid for h, _ in commit_failed)}

    def _discard_staged(self, handles) -> None:
        """Best-effort ``discard`` to every live worker: an aborted
        republish must not leave prewarmed second engine caches (and a
        second copy of the O(E) graph arrays) resident on the workers
        whose prepare succeeded."""
        for h in handles:
            if not h.alive:
                continue
            try:
                self._rpc(h, {"op": "discard"}, timeout_s=10.0)
            except FleetError:
                continue  # dying worker: its memory goes with it

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counts)
            out["graph_id"] = self._graph_id
            out["workers_alive"] = sum(
                1 for h in self._workers.values() if h.alive)
            out["workers_total"] = len(self._workers)
            out["pilot"] = dict(self._pilot_counts)
            out["policy_mode"] = self._policy_mode
        return out

    # -- SLOs (obs/slo.py) -----------------------------------

    def set_slos(self, specs) -> SLOEngine:
        """Install declarative SLO specs; every resolved query (and,
        on the live controller, every admitted write) feeds the
        burn-rate engine from here on.  Returns the engine."""
        engine = SLOEngine(specs)
        with self._lock:
            self._slo = engine
        return engine

    def slo_status(self) -> List[dict]:
        """One verdict row per installed spec (empty when none):
        multi-window burn rates, ok/warn/burning verdict, and the
        exemplar trace ids linking a burning SLO to stitched
        timelines."""
        with self._lock:
            engine = self._slo
        return [] if engine is None else engine.status()

    # -- autopilot surface (serve/autopilot) -----------------

    def set_policy(self, policy) -> None:
        """Install an AdmissionPolicy (``None`` clears it back to plain
        serving).  The policy is re-evaluated against ``slo_status()``
        every heartbeat sweep (and once right here): its chosen mode
        gates ``_dispatch`` — ``shed`` rejects at admission, ``queue``
        admits past the saturation skip, ``stale_degrade`` serves
        bounded reads from the freshest replica with the explicit stale
        tag.  Mode switches emit a ``pilot.policy.switch`` incident
        span and bump the switch counter."""
        with self._lock:
            self._policy = policy
            if policy is None:
                self._policy_mode = "serve"
        if policy is not None:
            self.policy_tick()

    def policy_mode(self) -> str:
        with self._lock:
            return self._policy_mode

    def policy_tick(self) -> str:
        """One policy evaluation (the heartbeat loop's cadence; tests
        and the demo call it directly).  Returns the current mode."""
        with self._lock:
            policy = self._policy
        if policy is None:
            return "serve"
        mode, reason = policy.decide(self.slo_status())
        with self._lock:
            prev = self._policy_mode
            if mode == prev:
                return mode
            self._policy_mode = mode
            self._pilot_counts["policy_switches"] += 1
            seq = self._pilot_counts["policy_switches"]
        # a mode switch is an autonomous action: keyed incident trace,
        # always-recorded span — luxstitch renders the switch next to
        # the burning SLO windows that caused it
        ptc = dtrace.incident(f"policy:{self._incarnation}:{seq}")
        with dtrace.tspan("pilot.policy.switch", ptc, always=True,
                          prev=prev, mode=mode, reason=reason):
            pass
        return mode

    def _pilot_count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._pilot_counts[key] = self._pilot_counts.get(key, 0) + n

    def rebalance_preview(self, add: Sequence[str] = (),
                          remove: Sequence[str] = (),
                          app: str = "sssp") -> dict:
        """Dry-run a membership change over THIS fleet's routable key
        space (every Q-slot of ``app`` on the pinned graph) — the
        autoscaler's cost gate.  See ``HashRing.rebalance_preview``."""
        with self._lock:
            gid = self._graph_id if self._graph_id is not None else "g"
            keys = [f"{app}|{gid}|q{s}" for s in range(self.slots)]
            return self._ring.rebalance_preview(keys, add=add,
                                                remove=remove)

    def _slo_observe(self, fut: FleetFuture, error) -> None:
        """Resolve-time hook scoring one query: availability from the
        error class, latency from the future's own stamps, staleness
        from the explicit degrade tag — exemplar'd with the request's
        trace id.  Runs inside the future's resolve (before waiters
        wake), so a scrape right after ``result()`` already counts it."""
        with self._lock:
            engine = self._slo
        if engine is None:
            return
        engine.observe_query(fut.latency_s, ok=error is None,
                             stale=fut.stale, trace_id=fut.trace_id)

    def prom_dump(self) -> str:
        """One merged Prometheus exposition across the fleet: every
        series carries its ``replica`` label (serve/metrics.py), so the
        aggregate stays per-worker attributable.  ``# HELP``/``# TYPE``
        lines are emitted ONCE per metric name — the text format forbids
        repeating them, so a naive concatenation of per-worker dumps
        would not parse for any fleet wider than one worker."""
        texts = [self._own_prom_text()]
        with self._lock:
            handles = [h for h in self._workers.values() if h.alive]
        for h in handles:
            try:
                texts.append(self._rpc(h, {"op": "prom"},
                                       timeout_s=10.0)["text"])
            except FleetError:
                continue  # a dying worker's scrape is just absent
        order: List[str] = []          # families in first-appearance order
        meta: Dict[str, List[str]] = {}     # family -> [HELP, TYPE]
        samples: Dict[str, List[str]] = {}  # family -> sample lines
        for text in texts:
            fam = None
            for line in text.splitlines():
                if line.startswith(("# HELP ", "# TYPE ")):
                    fam = line.split(" ", 3)[2]
                    if fam not in meta:
                        order.append(fam)
                        meta[fam] = []
                        samples[fam] = []
                    if len(meta[fam]) < 2:  # HELP+TYPE once per family
                        meta[fam].append(line)
                elif line and fam is not None:
                    samples[fam].append(line)
        out: List[str] = []
        for fam in order:
            out.extend(meta[fam])
            out.extend(samples[fam])
        return "\n".join(out) + ("\n" if out else "")

    def _own_prom_text(self) -> str:
        """The controller's OWN exposition families:
        fleet-level counters, per-worker retry/timeout/stale
        attribution, and the installed fault plan's injection counts —
        merged ahead of the worker scrapes by prom_dump."""
        with self._lock:
            counts = dict(self._counts)
            per_worker = {w: dict(d) for w, d in self._per_worker.items()}
        lines: List[str] = []
        help_txt = {
            "retries": "queries re-dispatched or envelope-retried",
            "timeouts": "queries whose deadline expired fleet-wide",
            "failovers": "controller takeover promotions",
            "stale_degraded": "reads served under the bounded-staleness"
                              " degrade",
            "shed": "fleet-wide admission sheds",
            "worker_deaths": "workers retired by death detection",
        }
        for key, help_text in help_txt.items():
            name = f"lux_fleet_{key}_total"
            lines.extend([f"# HELP {name} {help_text}",
                          f"# TYPE {name} counter",
                          f"{name} {counts.get(key, 0)}"])
        wk_keys = (("retries", "lux_fleet_worker_retries_total",
                    "retries attributed to this worker"),
                   ("timeouts", "lux_fleet_worker_timeouts_total",
                    "timeouts attributed to this worker"),
                   ("stale_served", "lux_fleet_worker_stale_reads_total",
                    "stale-degraded reads this worker served"))
        for key, name, help_text in wk_keys:
            rows = [(w, d.get(key, 0)) for w, d in
                    sorted(per_worker.items()) if d.get(key, 0)]
            if not rows:
                continue
            lines.extend([f"# HELP {name} {help_text}",
                          f"# TYPE {name} counter"])
            lines.extend(f'{name}{{worker="{w}"}} {n}' for w, n in rows)
        # -- autopilot families -----------------------------
        with self._lock:
            pilot = dict(self._pilot_counts)
            mode = self._policy_mode
            has_policy = self._policy is not None
            hub = self._sub_hub
        if pilot["scale_up"] or pilot["scale_down"]:
            name = "lux_pilot_scale_actions_total"
            lines.extend([
                f"# HELP {name} autoscaler spawn/retire actions",
                f"# TYPE {name} counter"])
            lines.extend(
                f'{name}{{direction="{d}"}} {pilot[k]}'
                for d, k in (("up", "scale_up"), ("down", "scale_down"))
                if pilot[k])
        if pilot["elections"]:
            name = "lux_pilot_elections_total"
            lines.extend([
                f"# HELP {name} standby elections won by this "
                "controller", f"# TYPE {name} counter",
                f"{name} {pilot['elections']}"])
        if has_policy:
            name = "lux_pilot_policy_mode"
            lines.extend([
                f"# HELP {name} admission-policy mode (0 serve, 1 "
                "queue, 2 stale_degrade, 3 shed)",
                f"# TYPE {name} gauge",
                f"{name} {_POLICY_MODE_CODE.get(mode, 0)}"])
            name = "lux_pilot_policy_switches_total"
            lines.extend([
                f"# HELP {name} admission-policy mode switches",
                f"# TYPE {name} counter",
                f"{name} {pilot['policy_switches']}"])
        if pilot["sub_pushes"] or pilot["sub_coalesced"]:
            for key, name, help_text in (
                    ("sub_pushes", "lux_pilot_subscription_pushes_total",
                     "standing-query answers pushed to subscribers"),
                    ("sub_coalesced",
                     "lux_pilot_subscription_coalesced_total",
                     "subscription updates superseded before delivery")):
                lines.extend([f"# HELP {name} {help_text}",
                              f"# TYPE {name} counter",
                              f"{name} {pilot[key]}"])
        if hub is not None:
            name = "lux_pilot_subscriptions"
            lines.extend([
                f"# HELP {name} active standing-query subscriptions",
                f"# TYPE {name} gauge", f"{name} {hub.active()}"])
            lag = hub.max_lag()
            if lag is not None:
                name = "lux_pilot_subscription_lag"
                lines.extend([
                    f"# HELP {name} max generations between the journal "
                    "and a subscriber's delivered cursor",
                    f"# TYPE {name} gauge", f"{name} {lag}"])
        with self._lock:
            engine = self._slo
        if engine is not None:
            lines.extend(engine.prom_lines())
        plan = fault.active_plan()
        if plan is not None and plan.total_fired():
            name = "lux_fault_injected_total"
            lines.extend([
                f"# HELP {name} faults injected by the installed "
                f"FaultPlan ({plan.name})",
                f"# TYPE {name} counter"])
            lines.extend(
                f'{name}{{site="{r["site"]}",target="{r["target"]}",'
                f'action="{r["action"]}"}} {r["count"]}'
                for r in plan.counters())
        return "\n".join(lines) + ("\n" if lines else "")

    def close(self, shutdown_workers: bool = False) -> None:
        self._hb_stop.set()
        with self._lock:
            self._closed = True
            handles = list(self._workers.values())
            hub = self._sub_hub
            self._sub_hub = None
        if hub is not None:
            hub.close()
        for h in handles:
            if shutdown_workers and h.alive:
                try:
                    self._rpc(h, {"op": "shutdown"}, timeout_s=10.0)
                except FleetError:
                    pass
            h.conn.close()
        self._close_lease()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
