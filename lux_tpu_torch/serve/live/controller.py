"""LiveFleetController: the write path through the fleet.

Counterpart of ``lux_tpu.serve.live.controller`` over the port's
``FleetController`` (the same wire protocol, journal format and knobs).
Extends the fleet controller with the mutation-aware serving protocol:

* **admit_writes** — the ONE write order: each batch is sequenced into
  the authoritative LiveJournal (durably, when journaled) and only THEN
  replicated to every live worker as a ``delta`` op; the commit
  generation returns to the caller once every reachable replica
  acknowledged, so a subsequent ``submit(min_generation=gen)`` is
  read-your-writes end to end.  The write path is single-writer
  (``_write_lock``) — generations are total-ordered by construction.
* **replication faults** — a worker that dies mid-replication is
  retired by the base controller (its reads move to ring successors);
  a sequence gap (a recovered worker that lost its uncommitted tail)
  is answered with the catch-up stream from the journal; a rejoining
  worker is synced in ``add_worker`` (snapshot + journal replay on its
  side, ``batches_since`` from ours).
* **refresh_fleet** — fans the ``refresh`` op to every replica so
  the warm refresh (SSSP/CC bitwise, PageRank exact-fixpoint) runs
  fleet-wide between queries; standing reads (``read_standing``) serve
  the refreshed states O(1) with generation tags.
* **compaction escalation** — a ``DeltaOverflow`` on any replica
  escalates here: the journal compacts into a durable snapshot
  (``snapshot_path``), ``base_generation`` advances, and the fleet
  moves onto the new epoch through the token-guarded two-phase
  republish (old overlays serve until the atomic commit; zero shed).

The controller does no graph math — the journal is numpy, the engines
live in the workers (each a CUDA process of its own in a deployment).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.obs import dtrace
from lux_tpu_torch.serve.fleet.controller import (
    FleetController,
    FleetError,
    NoWorkersError,
    WorkerRefusedError,
    _Pending,
)
from lux_tpu_torch.serve.fleet.wire import ConnectionClosed
from lux_tpu_torch.serve.live.errors import (
    REFUSE_AHEAD,
    REFUSE_PRE_EPOCH,
    REFUSE_STATIC,
)
from lux_tpu_torch.serve.live.journal import LiveJournal, read_live_meta


class LiveFleetController(FleetController):
    """``base``: the controller's HostGraph copy of the CURRENT epoch
    snapshot (what every worker loaded).  ``journal_dir`` makes the
    write order durable; ``snapshot_path`` names where compactions
    write merged snapshots — REQUIRED before any overflow can be
    escalated (and for journaled compaction at all)."""

    def __init__(self, base: HostGraph,
                 journal_dir: Optional[str] = None,
                 snapshot_path: Optional[str] = None,
                 delta_timeout_s: float = 60.0,
                 refresh_timeout_s: float = 600.0, **kw):
        super().__init__(**kw)
        self.journal = LiveJournal(base, journal_dir=journal_dir)
        self.snapshot_path = snapshot_path
        self.delta_timeout_s = float(delta_timeout_s)
        self.refresh_timeout_s = float(refresh_timeout_s)
        #: single-writer sequencing: admits, republishes, and the
        #: compactions they escalate to are totally ordered; reads
        #: never take this.  Reentrant because compact_fleet (holding
        #: it) republishes through the serialized override below.
        #: Acquisition order is _write_lock BEFORE the base _lock on
        #: every path; the fine-grained
        #: _lock is never held across a send/wait — replication blocks
        #: under _write_lock ONLY, which is the point of the lock.
        self._write_lock = threading.RLock()
        self._live_counts = {"writes": 0, "write_rows": 0,
                             "compactions": 0, "resyncs": 0,
                             "overflow_compactions": 0,
                             "write_dedups": 0}

    def _hello_info(self) -> dict:
        """The live handshake extras: our journal generation, so the
        worker-side split-brain guard can refuse a controller whose
        journal is BEHIND the worker's own (a wiped/wrong-dir
        controller must not re-sequence generations the fleet already
        acked)."""
        return {**super()._hello_info(), "live": True,
                "journal_generation": self.journal.generation()}

    # ------------------------------------------------------------------
    # membership: live handshake + catch-up
    # ------------------------------------------------------------------

    def add_worker(self, host: str, port: int,
                   timeout_s: float = 60.0, tc=None) -> str:
        """Base handshake + the live catch-up: the worker must be live
        and at-or-behind the journal; behind means it recovered/joined
        from the epoch snapshot + its local committed prefix, and the
        missing batches stream to it before it serves a stale-bounded
        read."""
        wid = super().add_worker(host, port, timeout_s=timeout_s, tc=tc)
        with self._lock:
            handle = self._workers[wid]
        info = handle.info
        # the three PERMANENT rejections raise WorkerRefusedError, not
        # plain FleetError: takeover()'s per-endpoint retry loop treats
        # FleetError as transient and would re-hello a worker that can
        # never qualify for the full deadline — these cannot heal by
        # retrying the same handshake
        if not info.get("live"):
            self.remove_worker(wid, shutdown=False)
            raise WorkerRefusedError(
                REFUSE_STATIC,
                f"worker {wid} is not live (start it with --live / a "
                "LiveReplica); a static replica would serve writes-blind "
                "answers with no generation tag")
        have = int(info.get("delta_generation", 0))
        gen = self.journal.generation()
        if have > gen:
            self.remove_worker(wid, shutdown=False)
            raise WorkerRefusedError(
                REFUSE_AHEAD,
                f"worker {wid} is at generation {have}, ahead of the "
                f"journal ({gen}) — it belongs to a different write "
                "history (wrong journal dir or wiped controller state)")
        if have < self.journal.base_generation:
            self.remove_worker(wid, shutdown=False)
            raise WorkerRefusedError(
                REFUSE_PRE_EPOCH,
                f"worker {wid} is at generation {have}, before the "
                f"current epoch base {self.journal.base_generation}: its "
                "missing batches were compacted into the snapshot — "
                "restart it from the current snapshot")
        self._raise_delta_gen(handle, have)
        if have < gen:
            with self._lock:
                self._live_counts["resyncs"] += 1
            self._sync_worker(handle, tc=tc)
        return wid

    def _raise_delta_gen(self, handle, gen: int) -> None:
        """Monotonic, LOCKED delta_gen update: the heartbeat thread
        does its max() under self._lock, so an unlocked store here
        could be overwritten by a stale heartbeat read-modify-write —
        exactly the backslide that would make a just-acked
        min_generation read spuriously StaleReadError."""
        with self._lock:
            handle.delta_gen = max(handle.delta_gen, int(gen))

    def _sync_worker(self, handle, start: Optional[int] = None,
                     tc=None) -> None:
        """Stream the batches a behind worker is missing, in order.
        ``start`` overrides the tracked delta_gen — the gen_gap path
        passes the worker's OWN reported position instead of lowering
        the shared (heartbeat-raced) field.  ``tc``: the trace driving
        this catch-up (a takeover's re-hello, an admit's gen_gap
        answer) — each streamed batch rides as a traced delta frame,
        so recovery work is attributable in the stitched timeline."""
        if start is None:
            start = handle.delta_gen
        sctx = tc.child() if tc is not None else dtrace.mint()
        with dtrace.tspan("live.sync", sctx, always=True,
                          worker=handle.wid,
                          have=start, want=self.journal.generation()):
            for gen, arr in self.journal.batches_since(start):
                rep = self._delta_rpc(handle, gen, arr,
                                      self.delta_timeout_s, tc=sctx)
                if rep.get("kind") == "overflow":
                    raise FleetError(
                        f"worker {handle.wid} overflowed at generation "
                        f"{gen} during catch-up — compact the fleet "
                        "first (compact_fleet), then rejoin it")
                if not rep.get("ok"):
                    raise FleetError(
                        f"worker {handle.wid} failed catch-up at "
                        f"generation {gen}: {rep.get('err')}")
                self._raise_delta_gen(handle, gen)

    # ------------------------------------------------------------------
    # the write path
    # ------------------------------------------------------------------

    def admit_writes(self, src, dst, op, weight=None,
                     timeout_s: Optional[float] = None,
                     write_id: Optional[str] = None) -> dict:
        """Admit ONE edge-mutation batch: sequence it into the journal
        (durable before anything else sees it), replicate to every live
        worker, return the commit generation once all reachable
        replicas acknowledged.  An overflow anywhere escalates to a
        fleet-wide compaction (``snapshot_path`` required) before
        returning.  Raises like DeltaLog.apply on an invalid batch —
        nothing journaled, nothing replicated, no generation burned.

        ``write_id``: idempotence key for the retry
        envelope.  A client whose ack was lost (controller crash after
        journaling) retries the SAME id against the promoted
        controller and gets the already-committed generation back —
        ``deduped: True``, nothing re-applied, nothing re-replicated
        (the replicas were synced past it at re-hello)."""
        timeout_s = self.delta_timeout_s if timeout_s is None else timeout_s
        # the WRITE trace root: keyed on the idempotent
        # write_id, so a client retrying a lost ack against a PROMOTED
        # controller lands its replay — and its dedup answer — in the
        # SAME trace as the original attempt.  That identity is what
        # makes the kill-mid-write drill stitch into one timeline.
        wtc = dtrace.mint(
            key=None if write_id is None else f"w:{write_id}")
        t_admit = time.monotonic()
        try:
            return self._admit_writes_scored(src, dst, op, weight,
                                             write_id, timeout_s,
                                             wtc, t_admit)
        except Exception:
            # a failed admit (journal refusal, overflow-escalation
            # failure, replication FleetError) is write_ack-BAD — the
            # SLO must see it, like submit keeps availability honest
            # about sheds
            self._observe_write(t_admit, ok=False, tc=wtc)
            raise

    def _admit_writes_scored(self, src, dst, op, weight, write_id,
                             timeout_s, wtc, t_admit):
        from lux_tpu_torch import obs

        with self._write_lock:
            if write_id is not None:
                got = self.journal.lookup_write(write_id)
                if got is not None:
                    with self._lock:
                        self._live_counts["write_dedups"] += 1
                    obs.point("live.admit.dedup", write_id=str(write_id),
                              generation=got,
                              **(wtc.attrs() if wtc is not None
                                 and wtc.sampled else {}))
                    dtrace.emit_span("live.admit", wtc, t_admit,
                                     time.monotonic(), ok=True,
                                     deduped=True, generation=got)
                    self._observe_write(t_admit, ok=True, tc=wtc)
                    return {"generation": got,
                            "acked": self.live_workers(),
                            "compacted": False, "deduped": True}
            rows = int(np.size(np.atleast_1d(np.asarray(src))))
            with dtrace.tspan("live.admit", wtc, always=True,
                              rows=rows) as sp:
                gen = self.journal.admit(src, dst, op, weight,
                                         write_id=write_id)
                acked, overflow = self._replicate(gen, timeout_s,
                                                  tc=wtc)
                compacted = False
                if overflow:
                    # the overflow-escalated compaction gets its own span
                    # + counter, nested around the fold, so a chaos
                    # soak's latency spike has an escalation to
                    # attribute itself to in the flight recorder
                    with self._lock:
                        self._live_counts["overflow_compactions"] += 1
                    obs.point("live.overflow.escalated", generation=gen,
                              rows=rows)
                    with obs.span("live.overflow.compact",
                                  generation=gen, rows=rows):
                        self._compact_fleet_locked()
                    compacted = True
                    acked = self.live_workers()
                with self._lock:
                    self._live_counts["writes"] += 1
                    self._live_counts["write_rows"] += rows
                sp.set(generation=gen, acked=len(acked),
                       compacted=compacted, deduped=False)
        self._observe_write(t_admit, ok=True, tc=wtc)
        # standing-query subscribers: push, don't poll —
        # outside the write lock (the hub only coalesces a pending
        # generation here; its dispatcher thread does the reads)
        self._notify_subs(gen, tc=wtc)
        return {"generation": gen, "acked": acked,
                "compacted": compacted, "deduped": False}

    def _observe_write(self, t0: float, ok: bool, tc=None) -> None:
        """Score one admit against the write_latency SLO (admit ->
        every reachable replica acked)."""
        with self._lock:
            engine = self._slo
        if engine is None:
            return
        engine.observe_write(
            time.monotonic() - t0, ok=ok,
            trace_id=None if tc is None else tc.trace_id)

    def _delta_rpc(self, handle, gen: int, arr: np.ndarray,
                   timeout_s: float, tc=None) -> dict:
        """One delta frame to one worker; returns the reply dict (ok or
        kind=gen_gap/overflow/error) — NEVER raises for a worker-side
        refusal, only for transport loss (as FleetError).  Hand-rolled
        next to FleetController._send because a delta carries an array
        payload (the base _send is header-only).  ``tc``: the write/
        sync trace — each frame carries its own child, and the
        replication hop is emitted as a ``live.replicate`` span so the
        worker's ``worker.delta`` span has its controller-side
        parent."""
        ctx = tc.child() if tc is not None else None
        t0 = time.monotonic()

        def span(ok: bool, **extra) -> None:
            dtrace.emit_span("live.replicate", ctx, t0, time.monotonic(),
                             ok=ok, worker=handle.wid,
                             generation=int(gen), **extra)

        p = _Pending("rpc")
        rid = self._next_rid()
        with self._lock:
            handle.pending[rid] = p
        msg = {"op": "delta", "req_id": rid, "generation": int(gen)}
        if ctx is not None:
            msg["tc"] = ctx.to_wire()
        try:
            handle.conn.send(msg, arr=arr)
        except ConnectionClosed:
            with self._lock:
                still_mine = handle.pending.pop(rid, None) is not None
            if still_mine:
                # the reader's _retire did not harvest this pending:
                # book the death ourselves (same shape as base _send);
                # a harvested rpc already carries p.error — fall through
                self._on_conn_lost(handle)
                span(False, kind="died_mid_replication")
                raise FleetError(
                    f"worker {handle.wid} died mid-replication"
                ) from None
        if not p.event.wait(timeout_s):
            span(False, kind="ack_timeout")
            raise FleetError(
                f"worker {handle.wid} did not ack generation {gen} "
                f"within {timeout_s}s")
        if p.error is not None:
            span(False, kind="error")
            raise FleetError(str(p.error))
        span(bool(p.reply.get("ok")),
             kind=None if p.reply.get("ok") else p.reply.get("kind"))
        return p.reply

    def _replicate(self, gen: int, timeout_s: float, tc=None
                   ) -> Tuple[List[str], bool]:
        """Fan one committed batch to every live worker.  Returns
        (acked worker ids, overflow anywhere).  A worker lost mid-
        replication is simply absent from the ack list (the base
        controller retired it — its reads moved); a gen_gap worker gets
        the catch-up stream inline.  ``tc``: the admitting write's
        trace, carried on every replication frame."""
        arr = self.journal.payload(gen)
        with self._lock:
            handles = [h for h in self._workers.values() if h.alive]
        acked: List[str] = []
        overflow = False
        for h in handles:
            try:
                rep = self._delta_rpc(h, gen, arr, timeout_s, tc=tc)
            except FleetError:
                continue  # retired mid-replication; rejoin re-syncs it
            if rep.get("ok"):
                self._raise_delta_gen(h, gen)
                acked.append(h.wid)
            elif rep.get("kind") == "overflow":
                # durable on that worker, not servable: escalate
                overflow = True
            elif rep.get("kind") == "gen_gap":
                try:
                    with self._lock:
                        self._live_counts["resyncs"] += 1
                    self._sync_worker(h, start=int(rep.get("have", 0)),
                                      tc=tc)
                    acked.append(h.wid)
                except FleetError:
                    continue
        return acked, overflow

    def republish(self, path, graph_id=None,
                  prepare_timeout_s: float = 600.0,
                  commit_timeout_s: float = 30.0,
                  base_generation=None) -> dict:
        """The base two-phase republish, SERIALIZED against the write
        path: the live worker's prepare-refusal message points
        operators here, and a delta racing a worker's cache/replica
        commit swap would install an old-epoch overlay into new-base
        engines."""
        with self._write_lock:
            return super().republish(
                path, graph_id=graph_id,
                prepare_timeout_s=prepare_timeout_s,
                commit_timeout_s=commit_timeout_s,
                base_generation=base_generation)

    # ------------------------------------------------------------------
    # fleet-wide refresh + standing reads
    # ------------------------------------------------------------------

    def refresh_fleet(self, timeout_s: Optional[float] = None) -> dict:
        """Run the warm refresh on EVERY replica (parallel — each
        worker refreshes between its own queries).  Returns per-worker
        {generation, apps{...}} plus the fleet wall seconds (the bench
        row's ``fleet_refresh_s``)."""
        timeout_s = (self.refresh_timeout_s if timeout_s is None
                     else timeout_s)
        with self._lock:
            handles = [h for h in self._workers.values() if h.alive]
        if not handles:
            raise NoWorkersError("refresh with no live workers")
        t0 = time.perf_counter()
        rtc = dtrace.mint()
        with dtrace.tspan("live.refresh_fleet", rtc,
                          workers=[h.wid for h in handles]):
            from lux_tpu_torch.serve.fleet.controller import _HandedOff

            pendings = []
            for h in handles:
                try:
                    msg = {"op": "refresh"}
                    if rtc is not None:
                        msg["tc"] = rtc.to_wire()
                    pendings.append((h, self._send(
                        h, msg, _Pending("rpc"))))
                except (ConnectionClosed, _HandedOff):
                    continue  # a dying worker's refresh is just absent
            out: Dict[str, dict] = {}
            deadline = time.monotonic() + timeout_s
            for h, p in pendings:
                if not p.event.wait(max(deadline - time.monotonic(),
                                        0.001)):
                    raise FleetError(
                        f"worker {h.wid} did not finish refresh within "
                        f"{timeout_s}s")
                if p.error is not None or not p.reply.get("ok"):
                    raise FleetError(
                        f"worker {h.wid} refresh failed: "
                        f"{p.error or p.reply.get('err')}")
                out[h.wid] = {k: v for k, v in p.reply.items()
                              if k not in ("req_id", "ok")}
        # a refresh recomputes every standing answer: subscribers get
        # the refreshed states pushed under the refresh's own trace
        self._notify_subs(self.journal.generation(), tc=rtc,
                          refreshed=True)
        return {"workers": out,
                "seconds": round(time.perf_counter() - t0, 4)}

    # -- standing-query subscriptions (serve/autopilot) -----------------

    def subscribe(self, app: str = "sssp", min_generation: int = 0):
        """Register a standing-query subscription: the returned
        :class:`~lux_tpu_torch.serve.autopilot.subscribe.Subscription`
        receives every refreshed answer for ``app`` pushed on
        write-commit and fleet refresh, with the generation tag as the
        cursor — the push replacement for ``read_standing`` polling.
        The hub (and its subscribers) SURVIVES a controller death: an
        elected successor adopts it via ``SubscriptionHub.rebind``, so
        a client registers once per fleet, not once per incarnation."""
        from lux_tpu_torch.serve.autopilot.subscribe import SubscriptionHub

        with self._lock:
            if self._sub_hub is None:
                self._sub_hub = SubscriptionHub(self)
            hub = self._sub_hub
        return hub.subscribe(app, cursor=min_generation)

    def unsubscribe(self, sub) -> None:
        with self._lock:
            hub = self._sub_hub
        if hub is not None:
            hub.unsubscribe(sub)

    def _notify_subs(self, generation: int, tc=None,
                     refreshed: bool = False) -> None:
        with self._lock:
            hub = self._sub_hub
        if hub is not None:
            hub.notify(int(generation), tc=tc, refreshed=refreshed)

    def read_standing(self, app: str = "sssp",
                      worker: Optional[str] = None,
                      timeout_s: float = 30.0) -> dict:
        """One replica's refreshed standing state for ``app``:
        {state, generation, iters, worker, tolerance}.  ``worker=None``
        picks the freshest live replica.  ``tolerance`` is the declared
        served-error bound the answering refresh quiesced under
        (0.0 = exact fixpoint) — the twin of the stale tag."""
        with self._lock:
            handles = [h for h in self._workers.values() if h.alive
                       and (worker is None or h.wid == worker)]
        if not handles:
            raise NoWorkersError(f"no live worker matches {worker!r}")
        h = max(handles, key=lambda x: x.delta_gen)
        p = self._send(h, {"op": "read", "app": app}, _Pending("rpc"))
        if not p.event.wait(timeout_s):
            raise FleetError(f"worker {h.wid} read timed out")
        if p.error is not None or not p.reply.get("ok"):
            raise FleetError(f"worker {h.wid} read: "
                             f"{p.error or p.reply.get('err')}")
        return {"state": p.arr, "generation": int(p.reply["generation"]),
                "iters": int(p.reply["iters"]), "worker": h.wid,
                "arg": p.reply.get("arg"),
                "tolerance": float(p.reply.get("tolerance") or 0.0)}

    def read_standing_all(self, app: str = "sssp",
                          timeout_s: float = 30.0) -> Dict[str, dict]:
        """The standing state from EVERY live replica — the acceptance
        surface: after a refresh, all entries must agree bitwise
        (SSSP/CC) / to <= 1 ulp (PageRank) and carry tags >= the last
        admitted generation."""
        out = {}
        for wid in self.live_workers():
            out[wid] = self.read_standing(app, worker=wid,
                                          timeout_s=timeout_s)
        return out

    # ------------------------------------------------------------------
    # compaction escalation
    # ------------------------------------------------------------------

    def compact_fleet(self) -> dict:
        """Public entry: fold the journal epoch into a new snapshot and
        republish it fleet-wide (token-guarded two-phase; old overlays
        serve until the atomic commit)."""
        with self._write_lock:
            return self._compact_fleet_locked()

    def _compact_fleet_locked(self) -> dict:
        from lux_tpu_torch import obs

        if self.snapshot_path is None:
            raise FleetError(
                "fleet compaction needs LiveFleetController("
                "snapshot_path=...) — an overflowed delta log cannot "
                "fold into a base nobody persists")
        gen = self.journal.generation()
        with obs.span("live.compact_fleet", generation=gen):
            self.journal.compact(self.snapshot_path)
            rep = self.republish(self.snapshot_path,
                                 graph_id=self.graph_id,
                                 base_generation=gen)
            with self._lock:
                self._live_counts["compactions"] += 1
                for h in self._workers.values():
                    if h.alive:
                        h.delta_gen = gen
        return {"generation": gen, "republish": rep}

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def generation(self) -> int:
        return self.journal.generation()

    def worker_generations(self) -> Dict[str, int]:
        with self._lock:
            return {wid: h.delta_gen
                    for wid, h in self._workers.items() if h.alive}

    def stats(self) -> dict:
        out = super().stats()
        with self._lock:
            out.update(self._live_counts)
        out["journal"] = self.journal.stats()
        out["worker_generations"] = self.worker_generations()
        return out

    def _own_prom_text(self) -> str:
        """Base families + the journal/live-path gauges the Prometheus
        surface lacks otherwise: controller journal
        depth (epoch batches held for catch-up), and per-worker
        journal-vs-replicated generation lag — labelled per worker
        like every fleet series."""
        text = super()._own_prom_text()
        js = self.journal.stats()
        gen = self.journal.generation()
        lines = []
        for name, val, help_text in (
                ("lux_live_journal_depth", js["epoch_batches"],
                 "batches journaled since the epoch base (catch-up "
                 "stream length)"),
                ("lux_live_journal_generation", gen,
                 "the controller journal's commit generation"),
                ("lux_live_base_generation", js["base_generation"],
                 "the current epoch base (advances at compaction)")):
            lines.extend([f"# HELP {name} {help_text}",
                          f"# TYPE {name} gauge", f"{name} {val}"])
        gens = self.worker_generations()
        if gens:
            name = "lux_live_worker_generation_lag"
            lines.extend([
                f"# HELP {name} journal generation minus this worker's "
                "replicated generation",
                f"# TYPE {name} gauge"])
            lines.extend(
                f'{name}{{worker="{w}"}} {max(gen - g, 0)}'
                for w, g in sorted(gens.items()))
        return text + "\n".join(lines) + "\n"


def promote_live_controller(base: HostGraph, journal_dir: str,
                            snapshot_path: Optional[str],
                            endpoints, deadline_s: float = 30.0,
                            seed: int = 0, **kw):
    """Controller FAILOVER: build a fresh (restarted or
    standby-promoted) LiveFleetController on the authoritative journal
    dir and re-enroll the surviving workers.

    Recovery is exactly the durable state: ``live_meta.json`` carries
    the epoch base generation; when an epoch boundary passed (a
    compaction), the CURRENT base is the snapshot at ``snapshot_path``,
    not the original graph, so it is (re)loaded from there; the
    DeltaLog replay then restores this epoch's committed batches — the
    whole generation line, with the base-sha check refusing a journal
    against the wrong snapshot.  ``takeover`` rebuilds the ring from
    worker re-hellos with jittered backoff, re-arms the publish-token
    state (discard), and — through the live ``add_worker`` — streams
    catch-up batches to any replica the dead controller had not
    finished replicating to.  Workers whose journals are AHEAD of ours
    refuse us (split-brain guard) and are reported, not enrolled.

    Returns ``(controller, takeover_report)``."""
    from lux_tpu_torch import obs
    from lux_tpu_torch.graph.format import read_lux

    meta = read_live_meta(journal_dir)
    if meta is not None and int(meta["base_generation"]) > 0:
        if snapshot_path is None or not os.path.exists(snapshot_path):
            raise FleetError(
                f"journal {journal_dir} is on epoch base "
                f"{meta['base_generation']} but no snapshot exists at "
                f"{snapshot_path!r} — the epoch base graph is the "
                "compacted snapshot, not the original")
        base = read_lux(snapshot_path, mmap=False)
    with obs.span("live.promote", journal=journal_dir,
                  endpoints=[f"{h}:{p}" for h, p in endpoints]):
        ctl = LiveFleetController(
            base, journal_dir=journal_dir, snapshot_path=snapshot_path,
            **kw)
        rep = ctl.takeover(endpoints, deadline_s=deadline_s, seed=seed)
    return ctl, rep


def start_live_fleet(n_workers: int, g: HostGraph, parts: int = 2,
                     cap: Optional[int] = None,
                     buckets=(1, 4), graph_id: str = "live",
                     standing=(("sssp", 0),),
                     journal_root: Optional[str] = None,
                     snapshot_path: Optional[str] = None,
                     max_queue: int = 256, wait_ms: float = 2.0,
                     hb_interval_s: float = 0.25, method: str = "auto",
                     route_family: Optional[str] = None,
                     tolerance: float = 0.0, device="cuda"):
    """A thread-mode live fleet over one in-memory graph: ``n_workers``
    LiveReplica-backed ReplicaWorkers sharing the pull layout on
    ``device`` (default ``cuda``; ``cpu`` must be asked for), behind a
    LiveFleetController.  ``journal_root`` gives the controller
    (``<root>/controller``) and each worker (``<root>/<wid>``) durable
    journals — the replication-fault tests and any real deployment want
    this; None keeps everything in-memory.  Returns a fleet/bench.Fleet
    (``close()`` tears it all down)."""
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.serve.fleet.bench import Fleet
    from lux_tpu_torch.serve.fleet.worker import ReplicaWorker
    from lux_tpu_torch.serve.live.replica import LiveReplica

    shards = build_pull_shards(g, parts)
    ctl = LiveFleetController(
        g, journal_dir=(None if journal_root is None
                        else os.path.join(journal_root, "controller")),
        snapshot_path=snapshot_path, hb_interval_s=hb_interval_s)
    workers: list = []
    fleet = Fleet(ctl, workers, [])
    try:
        for i in range(n_workers):
            wid = f"w{i}"
            live = LiveReplica(
                g, shards, cap=cap,
                journal_dir=(None if journal_root is None
                             else os.path.join(journal_root, wid)),
                standing=standing, method=method,
                route_family=route_family, tolerance=tolerance,
                device=device)
            w = ReplicaWorker(
                shards, worker_id=wid, graph_id=graph_id,
                q_buckets=tuple(buckets), max_queue=max_queue,
                max_wait_ms=wait_ms, method=method, live=live,
                device=device).start()
            workers.append(w)
            ctl.add_worker("127.0.0.1", w.port)
    except BaseException:
        fleet.close()
        raise
    return fleet
