"""Replica worker: one shared-nothing serving process of the fleet.

Counterpart of ``lux_tpu.serve.fleet.worker`` on the port's engines: a
``WarmEngineCache`` (``serve/warm.py``) on the worker's device (default
``cuda``; a worker is one CUDA process with its own context) plus one
``MicroBatchScheduler`` per served app, exposed over the loopback wire
protocol (``fleet/wire.py``).  The controller owns everything the worker
deliberately does NOT: admission, routing, placement, and the republish
barrier.

Protocol (all frames are JSON dicts, answers carry one npy array)::

    hello                       -> worker identity + layout + warm buckets
    query    {app, source, ...} -> answer | shed | timeout | error
    stats                       -> queue depth / shed / completed heartbeat
                                   (+ the device's peak allocated bytes)
    prom                        -> Prometheus text (replica-labelled)
    stream_begin / stream_chunk -> a snapshot streamed over the wire
    prepare  {token, ...}       -> stage + prewarm a NEW engine cache
    commit   {token}            -> atomically swap the staged cache in
    discard                     -> drop a staged cache (aborted republish)
    delta    {generation} + arr -> (live) journal + install one mutation batch
    refresh                     -> (live) warm-refresh the standing states
    read     {app}              -> (live) one standing state + its tag
    shutdown                    -> drain and exit

**Zero-downtime republish** is the prepare/commit pair: ``prepare`` loads
the new ``.lux`` snapshot and prewarms a complete second
``WarmEngineCache`` on a background thread while the OLD cache keeps
serving every query; ``commit`` is a pointer swap under the worker lock
(the schedulers' ``cache`` attribute), so no request ever observes a
half-warm service.  The prepare thread and the schedulers issue work on
the device's default stream; ``commit`` synchronizes the device before
the swap, so no staged warm launch is still queued when the pointer
moves.

A worker never blocks its connection reader: queries are enqueued and
answered by the responder thread when their ``ServeFuture`` resolves;
``prepare`` runs on its own thread.  ``kill()`` exists for fault drills —
it drops the sockets without draining, which is what a SIGKILL'd worker
process looks like to the controller.

A LIVE worker (``live=`` a ``serve/live.LiveReplica``, ``--live`` on the
command line) serves a MUTATING graph: every engine is the overlay twin,
``delta`` batches install new overlays (never a snapshot swap),
``refresh`` warms the standing states, and answers carry generation tags.
``delta``, ``refresh`` and ``read`` run on op threads, serialized by
``_live_lock`` (taken before ``_lock`` on every path); queries and
``stats`` never take it, so a refresh that holds it for seconds delays
no heartbeat.  The process point ``worker.before_delta_ack`` fires
between a durable, installed delta and its ack.

Run standalone (the multi-process fleet)::

    python -m lux_tpu_torch.serve.fleet.worker --worker-id w0 --port 0 \\
        --graph g.lux [--device cuda|cpu] \\
        [--live --journal-dir d --standing sssp:0,components,pagerank]

It prints one READY JSON line with the bound port.  ``--device cuda``
(the default) without a card raises: there is no CPU fallback.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from lux_tpu_torch import fault
from lux_tpu_torch.obs import dtrace
from lux_tpu_torch.parallel.placement import PlacementTree
from lux_tpu_torch.serve.fleet.pubproto import (
    ERR_NOTHING_STAGED,
    ERR_PREPARE_SUPERSEDED,
    token_mismatch,
)
from lux_tpu_torch.serve.fleet.stream import StreamTable
from lux_tpu_torch.serve.fleet.wire import (
    Conn,
    ConnectionClosed,
    WireError,
    max_frame_bytes,
)
from lux_tpu_torch.serve.metrics import ServeMetrics
from lux_tpu_torch.serve.scheduler import (
    MicroBatchScheduler,
    RejectedError,
    ServeTimeoutError,
)
from lux_tpu_torch.serve.warm import WarmEngineCache


class ReplicaWorker:
    """One replica: engines + schedulers behind a loopback socket."""

    #: responder poll cadence while futures are outstanding (seconds);
    #: bounds added answer latency, not correctness
    POLL_S = 0.001

    def __init__(self, shards, worker_id: str, graph_id: str = "g",
                 apps: Tuple[str, ...] = ("sssp",),
                 q_buckets: Tuple[int, ...] = (1, 8),
                 host: str = "127.0.0.1", port: int = 0,
                 method: str = "auto", num_iters: int = 10,
                 max_iters: int = 10_000, max_wait_ms: float = 2.0,
                 max_queue: int = 256, max_engines: Optional[int] = None,
                 live=None, placement: Optional[PlacementTree] = None,
                 placement_host: int = 0, device="cuda"):
        self.worker_id = str(worker_id)
        self.host = host
        self._req_port = int(port)
        self.apps = tuple(apps)
        self.q_buckets = tuple(q_buckets)
        self._method = method
        self._num_iters = int(num_iters)
        self._max_iters = int(max_iters)
        self._max_wait_ms = float(max_wait_ms)
        self._max_queue = int(max_queue)
        self._max_engines = max_engines
        self._num_parts = shards.spec.num_parts
        self._device = device
        #: every worker carries its coordinates in the ONE placement
        #: tree; a replica owning the whole graph is the single-host tree
        self.placement = (placement if placement is not None
                          else PlacementTree.single_host(self._num_parts))
        self.placement_host = int(placement_host)
        #: wire-streamed snapshot reassembly (fleet/stream.py): token ->
        #: sink, spooled into this worker's PRIVATE tmpdir (no shared
        #: filesystem with the controller); _stream_lock serializes the
        #: conn-reader begin/chunk feed against the prepare thread's pop
        self._streams = StreamTable(prefix=f"lux-w-{worker_id}-")
        self._stream_lock = threading.Lock()
        self.metrics = ServeMetrics()
        self._lock = threading.Lock()
        self._graph_id = str(graph_id)
        self._generation = 0
        #: serve/live.LiveReplica -> this worker serves a MUTATING graph:
        #: the cache holds overlay twins, ``delta`` batches install new
        #: overlays, ``refresh`` warms the standing states, and answers
        #: carry generation tags.  _live_lock serializes the write path
        #: (delta apply, refresh, live commit) — queries never take it,
        #: they read the cache's atomic overlay tuple.  Acquisition order
        #: is _live_lock BEFORE _lock on every path
        self._live = live
        self._live_lock = threading.Lock()
        # (cache, graph_id, token, staged LiveReplica | None): the token
        # ties the staged cache to the ONE republish that requested it —
        # a slow prepare finishing after an abort/discard (or after a
        # newer prepare superseded it) must never stage, or a later
        # commit would swap in the WRONG graph
        self._staged: Optional[Tuple[WarmEngineCache, str, str, object]] = None
        self._publish_token: Optional[str] = None
        self._cache = self._make_cache(shards)
        self._scheds: Dict[str, MicroBatchScheduler] = {
            app: MicroBatchScheduler(
                self._cache, app=app, max_wait_ms=self._max_wait_ms,
                max_queue=self._max_queue, metrics=self.metrics)
            for app in self.apps
        }
        self._listener: Optional[socket.socket] = None
        self.port: Optional[int] = None
        self._threads: List[threading.Thread] = []
        self._conns: List[Conn] = []
        self._running = False
        # a shutdown op's stop thread and the entrypoint's SIGTERM stop
        # can overlap: the second waits for the first instead of racing
        # it through the schedulers' and sockets' teardown
        self._stop_lock = threading.Lock()
        self._stop_thread: Optional[threading.Thread] = None  # a shutdown op's
        # the connection and op threads (daemons): stop() joins them, so a
        # process that returns from main() after stop() leaves none of them
        # inside torch while the interpreter finalizes (a daemon thread that
        # comes back from native code then is ended by a forced unwind, which
        # aborts the process: -6 at exit)
        self._live_threads: set = set()
        # (conn, req_id, ServeFuture, ...) tuples the responder resolves
        self._resp_wake = threading.Condition(self._lock)
        self._unanswered: List[tuple] = []

    def _make_cache(self, shards, live=None) -> WarmEngineCache:
        live = live if live is not None else self._live
        cache = WarmEngineCache(
            shards, apps=self.apps, q_buckets=self.q_buckets,
            method=self._method, num_iters=self._num_iters,
            max_iters=self._max_iters, metrics=self.metrics,
            max_engines=self._max_engines, device=self._device,
            overlay_static=None if live is None else live.overlay_static)
        if live is not None:
            oarr, deg = live.serving_overlay()
            cache.set_overlay(live.servable_generation(), oarr, deg)
        return cache

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self, prewarm: bool = True) -> "ReplicaWorker":
        from lux_tpu_torch import obs

        with obs.span("fleet.worker.start", worker=self.worker_id,
                      graph=self._graph_id, apps=list(self.apps),
                      buckets=list(self.q_buckets)):
            if prewarm:
                self._cache.prewarm()
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind((self.host, self._req_port))
            self._listener.listen(32)
            self.port = self._listener.getsockname()[1]
            self._running = True
            for sched in self._scheds.values():
                sched.start()
            for fn, name in ((self._accept_loop, "accept"),
                             (self._respond_loop, "respond")):
                t = threading.Thread(
                    target=fn, name=f"lux-fleet-{self.worker_id}-{name}",
                    daemon=True)
                t.start()
                self._threads.append(t)
        return self

    def stop(self) -> None:
        """Graceful: drain schedulers, let the responder flush every
        resolved answer, then close."""
        from lux_tpu_torch.utils.backoff import poll_until

        def _flushed() -> bool:
            with self._resp_wake:
                return not self._unanswered

        with self._stop_lock:
            for sched in self._scheds.values():
                sched.stop(drain=True)
            poll_until(_flushed, timeout_s=2.0)
            with self._resp_wake:
                self._running = False
                self._resp_wake.notify_all()
            self._close_sockets()
            for t in self._threads:
                t.join(timeout=5.0)
            self._threads = []
            self._join_live_threads(timeout_s=10.0)
            with self._stream_lock:
                self._streams.clear()
        # a shutdown op stops the worker from a thread of its own: wait for
        # that thread to end too, so none runs past the caller (a daemon
        # thread still running when the interpreter finalizes is ended by a
        # forced unwind, which aborts the process)
        with self._lock:
            t = self._stop_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)

    def _track(self, fn):
        """``fn`` wrapped to register its thread in ``_live_threads`` while
        it runs (the op and connection threads)."""
        def run(*args):
            me = threading.current_thread()
            with self._lock:
                self._live_threads.add(me)
            try:
                fn(*args)
            finally:
                with self._lock:
                    self._live_threads.discard(me)
        return run

    def _join_live_threads(self, timeout_s: float) -> None:
        """Wait (up to ``timeout_s`` in all) for the connection and op
        threads other than this one to end: their sockets are closed, so
        each ends with the op it is running."""
        deadline = time.monotonic() + timeout_s
        me = threading.current_thread()
        while True:
            with self._lock:
                left = [t for t in self._live_threads if t is not me]
            if not left or time.monotonic() > deadline:
                return
            left[0].join(timeout=max(0.0, deadline - time.monotonic()))

    def kill(self) -> None:
        """Fault drill: vanish abruptly — close every socket WITHOUT
        draining, exactly the peer-visible shape of a SIGKILL.  The
        controller learns about it from the connection reset, not from
        any goodbye."""
        from lux_tpu_torch import obs

        obs.point("fleet.worker.kill", worker=self.worker_id)
        # sockets first: with _running cleared while a connection was
        # still open, the responder would answer the queued queries
        # "worker stopping" — a crashed worker says nothing
        self._close_sockets()
        with self._resp_wake:
            self._running = False
            self._resp_wake.notify_all()
        for sched in self._scheds.values():
            sched.stop(drain=False)
        with self._stream_lock:
            self._streams.clear()

    def kill_at(self, point: str, count: int = 1,
                after: int = 0) -> None:
        """Arm a fault-plan kill of THIS worker at a named process point
        (``lux_tpu_torch.fault.ppoint`` sites): when the point fires
        inside one of this worker's op threads, ``kill()`` drops the
        sockets first (the peer-visible SIGKILL shape) and the op aborts
        with InjectedKill — no ack, no reply, exactly a crash."""
        fault.arm_kill(point, self.kill, owner_id=self.worker_id,
                       count=count, after=after)

    def _close_sockets(self) -> None:
        with self._lock:
            listener, self._listener = self._listener, None
            conns, self._conns = self._conns, []
        if listener is not None:
            try:
                # shutdown() first: close() alone does not wake a
                # thread blocked in accept()
                listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                listener.close()
            except OSError:
                pass
        for c in conns:
            c.close()

    # ------------------------------------------------------------------
    # socket service
    # ------------------------------------------------------------------

    def _accept_loop(self) -> None:
        # _running is a monotonic shutdown latch: a stale True costs one
        # accept() that _close_sockets' shutdown() interrupts
        while self._running:
            listener = self._listener
            if listener is None:
                break
            try:
                sock, _addr = listener.accept()
            except OSError:
                break  # listener closed: stop()/kill()
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = Conn(sock, peer="controller", owner=self.worker_id)
            with self._lock:
                self._conns.append(conn)
            # daemon + untracked: stop()/kill() closes their sockets,
            # which ends their recv loops promptly
            threading.Thread(
                target=self._track(self._conn_loop), args=(conn,),
                name=f"lux-fleet-{self.worker_id}-conn",
                daemon=True).start()

    def _conn_loop(self, conn: Conn) -> None:
        with fault.owner(self.worker_id):
            while self._running:
                try:
                    msg, arr = conn.recv()
                except (ConnectionClosed, WireError):
                    break
                except fault.InjectedKill:
                    break  # drill: the rule's callback (kill()) already
                    # dropped every socket; this thread just ends
                try:
                    self._dispatch(conn, msg, arr)
                except ConnectionClosed:
                    break
                except fault.InjectedKill:
                    break  # as above — a killed worker answers nothing
                except Exception as e:  # noqa: BLE001 — a bad op must
                    # answer, not kill the connection serving every
                    # other request
                    self._reply_err(conn, msg, "error", err=repr(e))
        conn.close()

    def _reply_err(self, conn: Conn, msg: dict, kind: str, **extra) -> None:
        reply = {"req_id": msg.get("req_id"), "ok": False,
                 "kind": kind, **extra}
        ctx = dtrace.child_of(msg)
        if ctx is not None:
            # error replies ride the trace too: the reply frame pairs
            # its own send/recv skew points under a fresh span id
            reply["tc"] = ctx.to_wire()
        try:
            conn.send(reply)
        except ConnectionClosed:
            pass

    def _spawn_op(self, fn, args, name: str) -> None:
        """One op on its own daemon thread, carrying this worker's
        fault-owner identity (thread-locals do not cross threads)."""
        def run():
            with fault.owner(self.worker_id):
                try:
                    fn(*args)
                except fault.InjectedKill:
                    pass  # killed mid-op: a crashed worker says nothing
        threading.Thread(target=self._track(run), name=name, daemon=True).start()

    def _dispatch(self, conn: Conn, msg: dict, arr=None) -> None:
        op = msg.get("op")
        rid = msg.get("req_id")
        if op == "hello":
            # re-hellos are traced: a failover takeover's hello carries
            # its context, so the stitched timeline links takeover ->
            # this worker's re-enrollment causally
            with dtrace.tspan("worker.hello", dtrace.child_of(msg),
                              always=True,
                              worker=self.worker_id) as hsp:
                ctl_bound = msg.get("max_frame_bytes")
                mine = max_frame_bytes()
                if ctl_bound is not None and int(ctl_bound) != mine:
                    # a frame one peer can send and the other refuses to
                    # receive is a DROPPED CONNECTION mid-protocol, not an
                    # error reply — so mismatched bounds fail here, at
                    # the handshake, naming the knob on both sides
                    hsp.set(refused="frame_bound_mismatch")
                    self._reply_err(
                        conn, msg, "frame_bound_mismatch",
                        err=(f"worker {self.worker_id} frames at most "
                             f"{mine} payload bytes but the controller "
                             f"advertises {int(ctl_bound)} — set "
                             "LUX_FLEET_MAX_FRAME_MB identically in "
                             "both environments"),
                        max_frame_bytes=mine)
                    return
                ctl_gen = msg.get("journal_generation")
                if (self._live is not None and ctl_gen is not None
                        and self._live.generation() > int(ctl_gen)):
                    # SPLIT-BRAIN GUARD: this worker's local journal
                    # holds writes the hello'ing controller's journal
                    # does not.  Enrolling would let a stale / wiped
                    # controller re-sequence generations the fleet
                    # already acked — refuse from OUR side too (the
                    # controller-side add_worker check protects a good
                    # controller from a bad worker; this protects a good
                    # worker from a bad controller).
                    hsp.set(refused="stale_controller")
                    self._reply_err(
                        conn, msg, "stale_controller",
                        err=(f"worker {self.worker_id} is at journaled "
                             f"generation {self._live.generation()}, ahead "
                             f"of this controller's journal ({int(ctl_gen)})"
                             " — refusing a controller behind my own "
                             "journal; recover the controller from the "
                             "authoritative journal dir"),
                        journal_generation=self._live.generation())
                    return
                conn.send({"req_id": rid, "ok": True, **self.info()})
        elif op == "query":
            self._op_query(conn, msg)
        elif op in ("delta", "refresh", "read"):
            # every live op serializes on _live_lock, which a running
            # refresh holds for engine-loop seconds — so ALL of them run
            # off the connection reader: the reader keeps draining query
            # frames and the schedulers keep answering while the write
            # path waits its turn.  Ordering stays intact: the
            # controller's single-writer admission never has two deltas
            # in flight per worker.
            fn = {"delta": self._op_delta, "refresh": self._op_refresh,
                  "read": self._op_read}[op]
            args = (conn, msg, arr) if op == "delta" else (conn, msg)
            self._spawn_op(fn, args,
                           name=f"lux-fleet-{self.worker_id}-{op}")
        elif op == "stats":
            conn.send({"req_id": rid, "ok": True, **self.heartbeat()})
        elif op == "prom":
            conn.send({"req_id": rid, "ok": True,
                       "text": self.prom_text()})
        elif op == "stream_begin":
            # wire-streamed snapshot (fleet/stream.py): open a sink in
            # the private spool dir; cheap enough for the reader thread
            with self._stream_lock:
                self._streams.begin(str(msg.get("token")),
                                    int(msg.get("nbytes", 0)),
                                    int(msg.get("chunks", 0)))
            conn.send({"req_id": rid, "ok": True})
        elif op == "stream_chunk":
            # casts: no reply, errors latch in the sink and surface at
            # the final consumer op (prepare {stream: true})
            with self._stream_lock:
                self._streams.chunk(str(msg.get("token")),
                                    int(msg.get("seq", -1)), arr)
        elif op == "prepare":
            # daemon + untracked, like the conn threads: one per
            # republish, replies through the conn's send lock
            self._spawn_op(self._op_prepare, (conn, msg),
                           name=f"lux-fleet-{self.worker_id}-prepare")
        elif op == "commit":
            self._op_commit(conn, msg)
        elif op == "discard":
            # aborted republish: drop the staged cache (and its second
            # copy of the graph arrays) instead of holding it forever;
            # clearing the token also strands any still-running prepare
            # so it cannot re-stage after this
            with self._lock:
                had = self._staged is not None
                self._staged = None
                self._publish_token = None
            with self._stream_lock:
                self._streams.clear()
            conn.send({"req_id": rid, "ok": True, "discarded": had})
        elif op == "shutdown":
            conn.send({"req_id": rid, "ok": True})
            t = threading.Thread(target=self.stop, daemon=True,
                                 name=f"lux-fleet-{self.worker_id}-stop")
            with self._lock:
                self._stop_thread = t
            t.start()
        else:
            self._reply_err(conn, msg, "error", err=f"unknown op {op!r}")

    # ------------------------------------------------------------------
    # ops
    # ------------------------------------------------------------------

    def info(self) -> dict:
        with self._lock:
            cache, gid, gen = self._cache, self._graph_id, self._generation
            live = self._live
        spec = cache.shards.spec
        out = {
            "worker_id": self.worker_id,
            "graph_id": gid,
            "generation": gen,
            "nv": int(spec.nv),
            "ne": int(spec.ne),
            "num_parts": int(spec.num_parts),
            "apps": list(self.apps),
            "buckets": list(self.q_buckets),
            "max_queue": self._max_queue,
            "max_frame_bytes": max_frame_bytes(),
            "placement": self.placement.to_wire(),
            "placement_host": self.placement_host,
            "device": str(cache.device),
        }
        if live is not None:
            out["live"] = True
            out["delta_generation"] = live.servable_generation()
            out["journal_generation"] = live.generation()
            out["standing"] = [[a, s] for a, s in live.standing_spec]
        return out

    def heartbeat(self) -> dict:
        """The queue-depth/shed heartbeat the controller's backpressure
        and shedding decisions ride on (plus republish visibility, this
        process's kernel launch counts and, on a CUDA worker, the
        device's peak allocated bytes)."""
        with self._lock:
            gid, gen = self._graph_id, self._generation
            staged = self._staged is not None
            cache = self._cache
        counts = self.metrics.counters()
        shed, completed = counts["rejected"], counts["completed"]
        depth = sum(s.pending() for s in self._scheds.values())
        out = {
            "queue_depth": depth,
            "max_queue": self._max_queue,
            # queue occupancy as a ready-made fraction: the autoscaler's
            # hot/idle signal, precomputed here so every consumer divides
            # by the same admission bound
            "occupancy": round(depth / max(self._max_queue, 1), 4),
            "shed_total": int(shed),
            "completed": int(completed),
            "graph_id": gid,
            "generation": gen,
            "staged": staged,
            "warm_buckets": {app: list(cache.warm_buckets(app))
                             for app in self.apps},
            "launches": kernel_launches(),
            **device_memory(cache.device),
        }
        live = self._live
        if live is not None:
            # read without _live_lock: a running refresh holds it for
            # seconds, and a heartbeat that waited would convict us
            out["delta_generation"] = live.servable_generation()
        return out

    def prom_text(self) -> str:
        """This replica's scrape (the ``prom`` op): the full
        counter/histogram set via ``ServeMetrics.scrape`` plus the
        warm-engine-cache occupancy and, on a live worker, the live-path
        gauges (servable-vs-journaled generation lag, delta-overlay
        occupancy), replica-labelled."""
        depth = sum(s.pending() for s in self._scheds.values())
        with self._lock:
            cache = self._cache
            live = self._live
        stats = cache.stats()
        extra = [("lux_serve_engine_cache_occupancy",
                  stats.get("occupancy", 0.0),
                  "resident warm engines / LRU cap")]
        if live is not None:
            lag = max(live.generation() - live.servable_generation(), 0)
            extra.extend([
                ("lux_live_generation_lag", lag,
                 "journaled minus servable generations (nonzero only "
                 "in the overflow window)"),
                ("lux_live_servable_generation",
                 live.servable_generation(),
                 "mutation generation the installed overlay serves"),
                ("lux_live_delta_occupancy",
                 round(float(
                     live.stats()["delta_occupancy"]["frac"]), 4),
                 "fraction of the per-part insert capacity in use "
                 "(max part)"),
            ])
        return self.metrics.scrape(queue_depth=depth, cache_stats=stats,
                                   replica=self.worker_id,
                                   extra_gauges=extra)

    def _op_query(self, conn: Conn, msg: dict) -> None:
        rid = msg.get("req_id")
        app = msg.get("app", "sssp")
        # THIS hop's trace context: a child of the frame's header (the
        # controller's attempt span is the causal parent); the
        # worker.query span covers receipt -> answer sent
        wtc = dtrace.child_of(msg)
        t_recv = time.monotonic()
        if int(msg.get("attempt", 1) or 1) > 1:
            # a re-dispatched / envelope-retried query landing here
            self.metrics.record_retry()
        stale_bound = msg.get("stale_bound")
        sched = self._scheds.get(app)
        if sched is None:
            dtrace.emit_span("worker.query", wtc, t_recv,
                             time.monotonic(), ok=False,
                             worker=self.worker_id, kind="error")
            self._reply_err(conn, msg, "error",
                            err=f"app {app!r} not served here")
            return
        try:
            fut = sched.submit(
                int(msg["source"]), timeout_ms=msg.get("timeout_ms"),
                trace=(wtc.trace_id if wtc is not None and wtc.sampled
                       else None))
        except RejectedError as e:
            dtrace.emit_span("worker.query", wtc, t_recv,
                             time.monotonic(), ok=False,
                             worker=self.worker_id, kind="shed")
            self._reply_err(conn, msg, "shed",
                            retry_after_ms=e.retry_after_ms)
            return
        except (KeyError, TypeError, ValueError) as e:
            dtrace.emit_span("worker.query", wtc, t_recv,
                             time.monotonic(), ok=False,
                             worker=self.worker_id, kind="error")
            self._reply_err(conn, msg, "error", err=repr(e))
            return
        with self._resp_wake:
            self._unanswered.append((conn, rid, fut, stale_bound,
                                     wtc, t_recv))
            self._resp_wake.notify_all()

    def _respond_loop(self) -> None:
        """Single responder: answers resolve in scheduler batches, so one
        thread polling ``done()`` at POLL_S keeps up with any rate the
        engines themselves sustain (no thread-per-request)."""
        while True:
            with self._resp_wake:
                while self._running and not self._unanswered:
                    self._resp_wake.wait(timeout=0.1)
                if not self._running and not self._unanswered:
                    return
                pending, self._unanswered = self._unanswered, []
            still: List[tuple] = []
            for conn, rid, fut, bound, wtc, t_recv in pending:
                if not fut.done():
                    # a stale True re-queues the future for ONE extra
                    # poll; the locked re-read at the loop top settles it
                    if self._running:
                        still.append((conn, rid, fut, bound, wtc,
                                      t_recv))
                    else:  # shutting down: never leave a hung future
                        self._reply_err(conn, {"req_id": rid}, "error",
                                        err="worker stopping")
                    continue
                self._answer(conn, rid, fut, stale_bound=bound,
                             tc=wtc, t_recv=t_recv)
            if still:
                with self._resp_wake:
                    self._unanswered.extend(still)
                time.sleep(self.POLL_S)

    def _answer(self, conn: Conn, rid, fut,
                stale_bound: Optional[int] = None, tc=None,
                t_recv: Optional[float] = None) -> None:
        def span(ok: bool, **extra) -> None:
            if tc is not None and t_recv is not None:
                dtrace.emit_span("worker.query", tc, t_recv,
                                 time.monotonic(), ok=ok,
                                 worker=self.worker_id, **extra)

        try:
            state = fut.result(timeout=0)
        except ServeTimeoutError as e:
            span(False, kind="timeout")
            self._reply_err(conn, {"req_id": rid}, "timeout", err=str(e))
            return
        except Exception as e:  # noqa: BLE001 — engine errors travel to
            # the controller as answers, never as a dropped connection
            span(False, kind="error")
            self._reply_err(conn, {"req_id": rid}, "error", err=repr(e))
            return
        reply = {"req_id": rid, "ok": True,
                 "rounds": int(fut.rounds),
                 "traversed": int(fut.traversed_edges)}
        if tc is not None:
            # the reply frame carries the WORKER's context so its
            # send/recv skew points pair under a unique span id
            reply["tc"] = tc.to_wire()
        if fut.generation is not None:
            reply["generation"] = int(fut.generation)
            if stale_bound is not None and fut.generation < int(stale_bound):
                self.metrics.record_stale_read()
        span(True, generation=fut.generation)
        try:
            conn.send(reply, arr=state)
        except ConnectionClosed:
            pass  # controller went away; nothing to tell it

    # ------------------------------------------------------------------
    # live ops (mutation-aware serving, serve/live)
    # ------------------------------------------------------------------

    def _live_or_refuse(self, conn: Conn, msg: dict):
        """The CURRENT replica, read by the CALLER inside _live_lock —
        a capture taken before the lock could be a replica a concurrent
        commit already retired, and applying to it while installing
        into the new cache is the exact cross-epoch race the lock
        exists to prevent."""
        live = self._live
        if live is None:
            self._reply_err(conn, msg, "error",
                            err="worker is not live (start it with a "
                                "LiveReplica / --live)")
        return live

    def _op_delta(self, conn: Conn, msg: dict, arr) -> None:
        """Apply ONE replicated mutation batch: journal it durably,
        rebuild + install the serving overlay, ack the generation.
        O(delta) host work on its own op thread (the conn reader must
        keep draining query frames while this waits out a running
        refresh's _live_lock); ordering comes from the controller's
        single-writer admission, not the reader."""
        from lux_tpu_torch import obs
        from lux_tpu_torch.mutate.deltalog import DeltaOverflow
        from lux_tpu_torch.serve.live.errors import GenerationGap

        if arr is None:
            self._reply_err(conn, msg, "error",
                            err="delta op needs the (rows, 4) batch "
                                "payload")
            return
        gen = msg.get("generation")
        # the replication hop's span: child of the controller's replicate
        # context, covering journal append + overlay rebuild + install.
        # The fault points inside (torn writes, before-marker / before-ack
        # kills) land within its time range.
        ctx = dtrace.child_of(msg)
        with dtrace.tspan("worker.delta", ctx, always=True,
                          worker=self.worker_id,
                          generation=int(gen) if gen is not None else None,
                          rows=int(arr.shape[0])) as dsp:
            with self._live_lock:
                live = self._live_or_refuse(conn, msg)
                if live is None:
                    return
                try:
                    oarr, deg = live.apply_batch(arr, int(gen))
                except GenerationGap as e:
                    dsp.set(kind="gen_gap")
                    self._reply_err(conn, msg, "gen_gap", have=e.have,
                                    want=e.want)
                    return
                except DeltaOverflow as e:
                    # the batch IS journaled (durable) but exceeds the
                    # overlay capacity: escalate — the controller answers
                    # with a fleet-wide compaction + republish
                    obs.point("live.overflow", worker=self.worker_id,
                              generation=int(gen))
                    dsp.set(kind="overflow")
                    self._reply_err(
                        conn, msg, "overflow", err=str(e),
                        generation=live.servable_generation(),
                        journal_generation=live.generation())
                    return
                except ConnectionClosed:
                    return
                except Exception as e:  # noqa: BLE001 — an unanswered
                    # delta would stall the controller's write path for
                    # its full timeout
                    dsp.set(kind="error")
                    self._reply_err(conn, msg, "error", err=repr(e))
                    return
                with self._lock:
                    cache = self._cache
                cache.set_overlay(int(gen), oarr, deg)
            obs.point("live.delta", worker=self.worker_id,
                      generation=int(gen), rows=int(arr.shape[0]))
            # applied + journaled + overlay installed, ack not yet sent:
            # a kill here is the "durable but silent" window the
            # controller's gen_gap/rejoin machinery must absorb
            fault.ppoint("worker.before_delta_ack", generation=int(gen))
            ack = {"req_id": msg.get("req_id"), "ok": True,
                   "generation": int(gen)}
            if ctx is not None:
                ack["tc"] = ctx.to_wire()
            try:
                conn.send(ack)
            except ConnectionClosed:
                pass  # controller went away; the apply itself is durable

    def _op_refresh(self, conn: Conn, msg: dict) -> None:
        """Warm-refresh the standing states to the current servable
        generation — BETWEEN queries: the schedulers keep answering
        through the installed overlay while this runs."""
        try:
            with dtrace.tspan("worker.refresh", dtrace.child_of(msg),
                              always=True, worker=self.worker_id):
                with self._live_lock:
                    live = self._live_or_refuse(conn, msg)
                    if live is None:
                        return
                    res = live.refresh()
        except ConnectionClosed:
            return
        except Exception as e:  # noqa: BLE001 — a failed refresh is an
            # answer; the overlay path still serves every query
            self._reply_err(conn, msg, "error", err=repr(e))
            return
        try:
            conn.send({"req_id": msg.get("req_id"), "ok": True, **res})
        except ConnectionClosed:
            pass
        except Exception as e:  # noqa: BLE001 — e.g. an over-bound
            # frame: answer with the error, never hang the controller
            self._reply_err(conn, msg, "error", err=repr(e))

    def _op_read(self, conn: Conn, msg: dict) -> None:
        """Serve a STANDING state (O(1): the refreshed array + its
        generation tag)."""
        app = msg.get("app", "sssp")
        with dtrace.tspan("worker.read", dtrace.child_of(msg),
                          worker=self.worker_id, app=app), \
                self._live_lock:
            live = self._live_or_refuse(conn, msg)
            if live is None:
                return
            try:
                ent = live.standing(app)
            except KeyError:
                self._reply_err(
                    conn, msg, "error",
                    err=f"no refreshed standing state for {app!r} "
                        f"(configured: {[a for a, _ in live.standing_spec]};"
                        " send a refresh first)")
                return
            state = ent["state"]
            reply = {"req_id": msg.get("req_id"), "ok": True,
                     "generation": int(ent["generation"]),
                     "iters": int(ent["iters"]), "app": app,
                     "arg": ent.get("arg"),
                     # the tolerance tag: the declared served-error bound
                     # the refresh quiesced under — 0.0 means the exact
                     # fixpoint.  Rides every standing read, as the stale
                     # tag rides degraded queries.
                     "tolerance": float(ent.get("tolerance") or 0.0)}
        try:
            conn.send(reply, arr=state)
        except ConnectionClosed:
            pass

    # ------------------------------------------------------------------
    # republish (prepare / commit)
    # ------------------------------------------------------------------

    def _op_prepare(self, conn: Conn, msg: dict) -> None:
        import os

        rid = msg.get("req_id")
        token = str(msg.get("token") or rid)
        spooled = None
        if msg.get("stream"):
            # wire-distributed snapshot: resolve the token's reassembled
            # local copy (streamed into OUR tmpdir — no path the
            # controller and this worker both see is ever required)
            with self._stream_lock:
                sink = self._streams.pop(token)
            if sink is None:
                self._reply_err(
                    conn, msg, "error",
                    err=f"no snapshot stream staged for token {token!r}"
                        " (stream_begin/stream_chunk must precede a "
                        "stream prepare)")
                return
            try:
                spooled = sink.finalize(str(msg.get("sha256")))
            except ValueError as e:
                sink.abort()
                self._reply_err(conn, msg, "error", err=str(e))
                return
            path = spooled
        else:
            path = msg.get("path")
        gid = msg.get("graph_id") or str(msg.get("path") or path)
        base_gen = msg.get("base_generation")
        if self._live is not None and base_gen is None:
            # a live worker republished WITHOUT an epoch base would keep
            # an old-epoch delta log under a new base — wrong answers
            # forever after; refuse loudly (the live controller always
            # sends the base generation)
            if spooled is not None:
                try:
                    os.unlink(spooled)
                except OSError:
                    pass
            self._reply_err(
                conn, msg, "error",
                err="live worker needs base_generation in prepare "
                    "(republish through LiveFleetController.compact_fleet"
                    " / republish(base_generation=...))")
            return
        with self._lock:
            # latest prepare wins from the start: an older in-flight
            # prepare sees its token superseded and will not stage
            self._publish_token = token
        ctx = dtrace.child_of(msg)
        try:
            with dtrace.tspan("fleet.publish.prepare", ctx, always=True,
                              worker=self.worker_id, graph=gid):
                from lux_tpu_torch.graph.format import read_lux
                from lux_tpu_torch.graph.shards import build_pull_shards

                g = read_lux(str(path), mmap=False)
                shards = build_pull_shards(g, self._num_parts)
                live2 = None
                if self._live is not None:
                    from lux_tpu_torch.serve.live.replica import LiveReplica

                    # journal-less while staged: the dir still holds the
                    # OLD epoch; rebind_journal rotates it at commit
                    old = self._live
                    live2 = LiveReplica(
                        g, shards, cap=old.cap,
                        base_generation=int(base_gen),
                        standing=old.standing_spec, method=old.method,
                        max_iters=old.max_iters,
                        route_family=old.route_family,
                        tolerance=old.tolerance, device=old.device)
                del g
                cache = self._make_cache(shards, live=live2)
                cache.prewarm()  # old cache serves throughout this
                if spooled is not None:
                    try:
                        os.unlink(spooled)  # read without mmap: done
                    except OSError:
                        pass
            with self._lock:
                if self._publish_token != token:
                    # a discard (abort) or a newer prepare happened
                    # while we built: this cache must NOT stage — a
                    # later commit would swap in the wrong graph
                    stale = True
                else:
                    stale = False
                    self._staged = (cache, gid, token, live2)
                gen_next = self._generation + 1
            if stale:
                self._reply_err(conn, msg, "error",
                                err=ERR_PREPARE_SUPERSEDED)
                return
            conn.send({"req_id": rid, "ok": True, "staged": True,
                       "graph_id": gid, "generation_next": gen_next,
                       "token": token, **device_memory(cache.device)})
        except ConnectionClosed:
            raise
        except Exception as e:  # noqa: BLE001 — a failed prepare is an
            # answer (controller aborts the republish), not a dead worker
            if spooled is not None:
                try:
                    os.unlink(spooled)
                except OSError:
                    pass
            with self._lock:
                if self._publish_token == token:
                    self._publish_token = None
                    self._staged = None
            self._reply_err(conn, msg, "error", err=repr(e))

    def _op_commit(self, conn: Conn, msg: dict) -> None:
        rid = msg.get("req_id")
        want = msg.get("token")
        # the WHOLE swap (cache + schedulers + live replica) happens under
        # _live_lock so a racing delta can never apply to the old replica
        # and then install its overlay into the new cache (the old
        # epoch's edge slots under new engines = silent wrong answers).
        # Lock order _live_lock -> _lock, as in _op_delta.
        with self._live_lock:
            self._op_commit_locked(conn, msg, rid, want)

    def _op_commit_locked(self, conn: Conn, msg: dict, rid, want) -> None:
        from lux_tpu_torch import obs

        with self._lock:
            if self._staged is None:
                err = ERR_NOTHING_STAGED
                staged = None
            elif want is not None and self._staged[2] != str(want):
                # the staged cache belongs to a DIFFERENT republish than
                # the one committing — swapping it in would serve the
                # wrong graph under the committer's graph_id
                err = token_mismatch(self._staged[2], str(want))
                staged = None
            else:
                err = None
                staged = self._staged
        if staged is None:
            self._reply_err(conn, msg, "error", err=err)
            return
        cache = staged[0]
        if cache.device.type == "cuda":
            # the staged cache's warm launches were queued on the
            # prepare thread: all of them land before the swap
            import torch

            torch.cuda.synchronize(cache.device)
        with self._lock:
            if self._staged is not staged:
                err = ERR_NOTHING_STAGED  # a discard won the race
            else:
                self._staged = None
                _c, gid, _tok, live2 = staged
                self._publish_token = None
                self._cache = cache
                self._graph_id = gid
                self._generation += 1
                gen = self._generation
        if err is not None:
            self._reply_err(conn, msg, "error", err=err)
            return
        # the swap the schedulers observe: one attribute store per app.
        # A pump mid-step keeps the cache object it already grabbed —
        # both caches are fully warmed, so either answers correctly.
        for sched in self._scheds.values():
            sched.cache = cache
        if live2 is not None:
            # live epoch handover (caller holds _live_lock): the new base
            # embeds every batch up to its base_generation, so
            # epoch-boundary standing states carry over warm and the
            # local journal rotates (crash order matches
            # mutate/compact.py: the snapshot was durable first)
            old = self._live
            live2.inherit_standing(old)
            live2.rebind_journal(old.journal_dir, prior=old)
            self._live = live2
        ctx = dtrace.child_of(msg)
        obs.point("fleet.publish.commit", worker=self.worker_id,
                  graph=gid, generation=gen,
                  **(ctx.attrs() if ctx is not None and ctx.sampled
                     else {}))
        reply = {"req_id": rid, "ok": True, "generation": gen,
                 "graph_id": gid}
        if live2 is not None:
            reply["delta_generation"] = live2.servable_generation()
        conn.send(reply)


def kernel_launches() -> dict:
    """This process's launch count of every CUDA kernel wrapper, by
    kernel name (each wrapper counts its own launches; a CPU tensor runs
    the plain version and counts nothing)."""
    from lux_tpu_torch.ops import kernel_wrappers

    return {name: int(fn.launches) for name, fn in kernel_wrappers().items()}


def device_memory(device) -> dict:
    """``{"device": ..., "peak_bytes": ..., "allocated_bytes": ...}`` of a
    CUDA worker (torch.cuda.max_memory_allocated, memory_allocated); only
    the device name on the CPU."""
    out = {"device": str(device)}
    if getattr(device, "type", str(device)) == "cuda":
        import torch

        out["peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
        out["allocated_bytes"] = int(torch.cuda.memory_allocated(device))
    return out


# ----------------------------------------------------------------------
# standalone process entry
# ----------------------------------------------------------------------


def main(argv=None) -> int:
    """Worker process entry: build the graph + shards on ``--device``,
    start serving, print ONE ready line (JSON: worker_id/port/pid) and
    block until a ``shutdown`` op or SIGTERM."""
    import argparse
    import json
    import os
    import signal

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engines run (default cuda; without a "
                         "card, cuda raises — there is no CPU fallback)")
    ap.add_argument("--graph", default="",
                    help=".lux snapshot path (overrides --rmat)")
    ap.add_argument("--rmat", default="10,8",
                    help="scale,edge-factor synthetic graph")
    ap.add_argument("--graph-id", default="")
    ap.add_argument("--parts", type=int, default=1)
    ap.add_argument("--apps", default="sssp")
    ap.add_argument("--buckets", default="1,8")
    ap.add_argument("--method", default="auto")
    ap.add_argument("--num-iters", type=int, default=10)
    ap.add_argument("--max-iters", type=int, default=10_000)
    ap.add_argument("--wait-ms", type=float, default=2.0)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--live", action="store_true",
                    help="serve a MUTATING graph: overlay-twin engines, "
                         "delta/refresh/read ops, answers tagged with "
                         "mutation generations (serve/live)")
    ap.add_argument("--journal-dir", default="",
                    help="live mode: durable local delta journal "
                         "(npz+.ok; a killed worker recovers its exact "
                         "committed prefix and catches up on rejoin)")
    ap.add_argument("--delta-cap", type=int, default=0,
                    help="live mode: per-part insert capacity "
                         "(0 = LUX_DELTA_CAP/default)")
    ap.add_argument("--base-generation", type=int, default=0,
                    help="live mode: the mutation generation the loaded "
                         "snapshot embeds (the controller's epoch base)")
    ap.add_argument("--standing", default="sssp:0",
                    help="live mode: comma list of standing apps kept "
                         "warm by refresh ops — sssp:<start>, pagerank, "
                         "components")
    ap.add_argument("--route-gather", default="",
                    help="live mode: gather-plan family the standing "
                         "PageRank refresh rides (fused-pf/fused-mx/"
                         "fused/expand/expand-pf; 'none' = direct; "
                         "'' = LUX_LIVE_ROUTE env, default fused-pf). "
                         "All families are bitwise-equal — perf only")
    ap.add_argument("--tolerance", type=float, default=0.0,
                    help="live mode: frontier-tolerance band for the "
                         "standing PageRank refresh — declared per-entry "
                         "served-error bound, surfaced on every read as "
                         "the tolerance tag (0 = exact fixpoint)")
    ap.add_argument("--cpus", default="",
                    help="pin this replica's host threads to these cores "
                         "(comma list); the engines stay on --device")
    args = ap.parse_args(argv)

    from lux_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)  # raises before any work
    if args.cpus and hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(
            0, {int(c) for c in args.cpus.split(",") if c.strip()})

    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.format import read_lux
    from lux_tpu_torch.graph.shards import build_pull_shards

    if args.graph:
        g = read_lux(args.graph, mmap=False)
        gid = args.graph_id or os.path.basename(args.graph)
    else:
        scale, ef = (int(x) for x in args.rmat.split(","))
        g = generate.rmat(scale, ef, seed=0)
        gid = args.graph_id or f"rmat{scale}"
    shards = build_pull_shards(g, args.parts)
    live = None
    if args.live:
        from lux_tpu_torch.serve.live.replica import LiveReplica, parse_standing

        live = LiveReplica(
            g, shards, cap=args.delta_cap or None,
            journal_dir=args.journal_dir or None,
            base_generation=args.base_generation,
            standing=parse_standing(args.standing),
            method=args.method, max_iters=args.max_iters,
            route_family=args.route_gather or None,
            tolerance=args.tolerance, device=device)
    del g
    worker = ReplicaWorker(
        shards, worker_id=args.worker_id, graph_id=gid,
        apps=tuple(a for a in args.apps.split(",") if a),
        q_buckets=tuple(int(b) for b in args.buckets.split(",") if b),
        host=args.host, port=args.port, method=args.method,
        num_iters=args.num_iters, max_iters=args.max_iters,
        max_wait_ms=args.wait_ms, max_queue=args.max_queue,
        live=live, device=device,
    )
    plan = fault.active_plan()  # LUX_FAULT_PLAN, when the drill set it
    if plan is not None:
        # a drill's kill rule names "kill:<worker id>" (fault/drills.py):
        # in a worker process that is a real SIGKILL of this process,
        # at the rule's site — no drain, no goodbye
        plan.bind(f"kill:{worker.worker_id}",
                  lambda: os.kill(os.getpid(), signal.SIGKILL))
    worker.start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    ready = {"ready": True, "worker_id": worker.worker_id,
             "port": worker.port, "pid": os.getpid(), "device": str(device)}
    if live is not None:
        ready["delta_generation"] = live.servable_generation()
    print(json.dumps(ready), flush=True)
    try:
        while not stop.is_set() and worker._running:
            stop.wait(0.2)
    except KeyboardInterrupt:
        pass
    # always, also after a shutdown op: its stop thread holds the stop lock
    # until the worker is down, so this waits for it (a second stop finds
    # nothing left to do) and no worker thread runs past main()
    worker.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
