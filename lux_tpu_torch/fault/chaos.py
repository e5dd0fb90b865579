"""Chaos soak: a seeded randomized fault schedule over a live fleet.

Counterpart of ``lux_tpu.fault.chaos`` on the port's live fleet: the
replicas run on ``device`` (default ``cuda``; ``cpu`` must be asked
for).  One soak builds a 2-worker (default) mutation-aware fleet
(``serve/live``), installs a seeded wire-fault plan, and drives a
seeded event stream — edge-churn writes, bounded reads, stale-degrade
reads, fleet refreshes, worker kills + rejoins, optionally a
controller kill + promotion — asserting the STANDING INVARIANTS at
every step and again after recovery:

1. **No acked write lost** — every admit that returned is applied to
   an independent mirror DeltaLog; at the end the controller journal's
   merged graph must equal the mirror's bitwise (and after a failover,
   the promoted controller's generation line must cover every ack).
2. **Read-your-writes** — a read bounded by ``min_generation=g``
   either carries a tag >= g or raised StaleReadError; with
   ``stale_ok`` it carries the explicit ``stale`` tag instead.  Every
   answer is compared BITWISE against ``bfs_reference`` of the merged
   graph at exactly the generation its tag names — a stale answer must
   be a CORRECT old answer, never a wrong one.
3. **Post-recovery convergence** — after the soak (kills, faults,
   failover and all), a fleet refresh + standing reads from EVERY
   replica are bitwise-equal to the merged reference.

Determinism: the event stream and the fault plan both derive from the
ONE ``seed``; a failure raises :class:`ChaosFailure` whose message
prints the seed, the plan (with live fire counts) and the event tail —
the reproduction recipe, per the acceptance criterion.

Scope note: the default insert capacity is sized so the soak never
crosses a compaction epoch — overflow escalation has its own dedicated
drills (tests/test_live.py) and folding epochs into the soak would
mostly re-test them slowly.  Worker rejoin therefore replays the local
journal prefix and catches up from the controller, the same path a
production same-epoch crash takes.

:func:`autopilot_soak` is the AUTONOMOUS variant: the same
invariants, but every operational action is taken by the autopilot
subsystems instead of the harness — a load ramp trips the
:class:`~lux_tpu_torch.serve.autopilot.autoscaler.Autoscaler` into a
scale-up, the controller kill is detected and repaired by a
:class:`~lux_tpu_torch.serve.autopilot.election.Standby` election, a small
insert capacity forces an overflow-escalated compaction, and a
standing-query subscription must keep delivering across all of it.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from lux_tpu_torch import fault
from lux_tpu_torch.fault.drills import wire_chaos
from lux_tpu_torch.mutate.deltalog import DeltaLog


class ChaosFailure(AssertionError):
    """An invariant broke; the message carries seed + plan + events."""


def _fail(seed: int, plan, events: List[dict], why: str,
          cause: Optional[BaseException] = None,
          repro: str = "chaos_soak") -> "ChaosFailure":
    tail = events[-12:]
    msg = (f"chaos soak FAILED (seed={seed}): {why}\n"
           f"reproduce: {repro}(seed={seed})\n"
           f"{plan.describe() if plan is not None else 'no wire plan'}\n"
           "event tail:\n" +
           "\n".join(f"  {json.dumps(e, default=str)}" for e in tail))
    err = ChaosFailure(msg)
    if cause is not None:
        err.__cause__ = cause
    return err


def chaos_soak(seed: int, steps: int = 16, workers: int = 2,
               scale: int = 8, ef: int = 4, rows: int = 10,
               cap: int = 4096, controller_kill: bool = False,
               wire_faults: bool = True,
               journal_root: Optional[str] = None,
               read_deadline_s: float = 60.0, device="cuda") -> dict:
    """Run one seeded soak on ``device``; returns the report dict or
    raises :class:`ChaosFailure`."""
    from lux_tpu_torch import obs
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.models.sssp import bfs_reference
    from lux_tpu_torch.serve.live.bench import churn_batch
    from lux_tpu_torch.serve.live.controller import (
        promote_live_controller,
        start_live_fleet,
    )
    from lux_tpu_torch.serve.live.replica import LiveReplica

    rng = np.random.default_rng(seed)
    g = generate.rmat(scale, ef, seed=int(rng.integers(1 << 30)))
    own_tmp = None
    if journal_root is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="lux_chaos_")
        journal_root = own_tmp.name
    snapshot_path = os.path.join(journal_root, "snap.lux")
    standing = (("sssp", 0),)
    parts = 2
    plan = wire_chaos(seed=seed + 1) if wire_faults else None
    events: List[dict] = []
    graphs = {0: g}  # generation -> merged HostGraph (tiny at scale 8)
    mirror = DeltaLog(g)  # the independent acked-writes mirror
    acked_gen = 0
    kills = rejoins = failovers = 0
    dead: Dict[str, object] = {}  # wid -> killed worker (to rejoin)

    fleet = start_live_fleet(
        workers, g, parts=parts, cap=cap, buckets=(1, 4),
        standing=standing, journal_root=journal_root,
        snapshot_path=snapshot_path, device=device)
    ctl = fleet.controller
    shards = build_pull_shards(g, parts)

    def bounded_read(src: int, bound: int, stale_ok: bool):
        fut = ctl.submit_retrying(
            int(src), deadline_s=read_deadline_s, min_generation=bound,
            stale_ok=stale_ok,
            request_id=f"chaos-{seed}-r{len(events)}")
        ans = fut.result(timeout=0)
        tag = fut.generation if fut.generation is not None else 0
        if not stale_ok and tag < bound:
            raise AssertionError(
                f"read-your-writes broke: bound {bound}, tag {tag}")
        if stale_ok and tag < bound and not fut.stale:
            raise AssertionError(
                f"stale answer (tag {tag} < bound {bound}) missing the "
                "explicit stale tag")
        ref = bfs_reference(graphs[tag], int(src))
        if not np.array_equal(ans, ref):
            raise AssertionError(
                f"answer at generation {tag} (src {src}) is not the "
                "merged reference — wrong, not just stale")
        return tag, bool(fut.stale)

    def rejoin(wid: str):
        from lux_tpu_torch.serve.fleet.worker import ReplicaWorker

        live = LiveReplica(
            g, shards, cap=cap,
            journal_dir=os.path.join(journal_root, wid),
            standing=standing, device=device)
        w = ReplicaWorker(shards, worker_id=wid, graph_id="live",
                          q_buckets=(1, 4), live=live,
                          device=device).start()
        fleet.thread_workers.append(w)
        ctl.add_worker("127.0.0.1", w.port)
        return w

    try:
        with obs.span("fault.chaos", seed=seed, steps=steps,
                      workers=workers):
            if plan is not None:
                fault.install(plan)
            kill_step = (int(rng.integers(steps // 3, 2 * steps // 3))
                         if controller_kill else -1)
            for i in range(steps):
                if i == kill_step:
                    # standby-driven failover: the harness
                    # only KILLS; a Standby detects the silence,
                    # wins the incarnation-fenced election and runs
                    # promote_live_controller itself — the soak then
                    # adopts whatever the group promoted.
                    from lux_tpu_torch.serve.autopilot.election import (
                        Standby,
                        StandbyGroup,
                    )

                    def _promote(tc=None):
                        endpoints = [("127.0.0.1", w.port)
                                     for w in fleet.thread_workers
                                     if w._running]
                        return promote_live_controller(
                            g, os.path.join(journal_root, "controller"),
                            snapshot_path, endpoints, seed=seed + 2)

                    group = StandbyGroup()
                    standbys = [Standby(group, sid, ctl, _promote,
                                        hb_interval_s=0.02,
                                        death_after_s=0.15,
                                        seed=seed).start()
                                for sid in range(2)]
                    ctl.kill()
                    failovers += 1
                    got = group.wait_promoted(timeout_s=60.0)
                    for s in standbys:
                        s.stop()
                    if got is None:
                        raise AssertionError(
                            "no standby promoted a controller within "
                            "60s of the incumbent's death")
                    ctl, rep = got
                    fleet.controller = ctl
                    events.append({"i": i, "ev": "failover",
                                   "joined": rep["joined"],
                                   "refused": rep["refused"],
                                   "winner": group.claimed_by(
                                       standbys[0].incumbent_incarnation),
                                   "gen": ctl.generation()})
                    if ctl.generation() < acked_gen:
                        raise AssertionError(
                            f"promotion lost acked writes: journal at "
                            f"{ctl.generation()}, acked {acked_gen}")
                    continue
                ev = rng.choice(
                    ["write", "read", "read_stale", "refresh", "kill"],
                    p=[0.45, 0.25, 0.10, 0.10, 0.10])
                if ev == "kill" and len(ctl.live_workers()) <= 1:
                    ev = "write"  # never kill the last live replica
                if ev == "write":
                    src, dst, op = churn_batch(mirror, rng, rows)
                    rep = ctl.admit_writes(
                        src, dst, op,
                        write_id=f"chaos-{seed}-w{i}")
                    if not rep.get("deduped"):
                        mirror.apply(src, dst, op)
                        graphs[rep["generation"]] = mirror.merged_graph()
                    acked_gen = max(acked_gen, rep["generation"])
                    events.append({"i": i, "ev": "write",
                                   "gen": rep["generation"],
                                   "acked": rep["acked"]})
                elif ev in ("read", "read_stale"):
                    src = int(rng.integers(0, g.nv))
                    stale_ok = ev == "read_stale"
                    bound = acked_gen + (1 if stale_ok else 0)
                    tag, stale = bounded_read(src, bound, stale_ok)
                    events.append({"i": i, "ev": ev, "src": src,
                                   "bound": bound, "tag": tag,
                                   "stale": stale})
                elif ev == "refresh":
                    if dead:  # rejoin before refreshing (refresh_fleet
                        # needs every live replica to answer)
                        for wid in sorted(dead):
                            rejoin(wid)
                            rejoins += 1
                        dead.clear()
                    ctl.refresh_fleet()
                    for wid, ent in ctl.read_standing_all("sssp").items():
                        tag = int(ent["generation"])
                        if not np.array_equal(
                                ent["state"],
                                bfs_reference(graphs[tag], 0)):
                            raise AssertionError(
                                f"standing state on {wid} at generation "
                                f"{tag} != merged reference")
                    events.append({"i": i, "ev": "refresh",
                                   "gen": acked_gen})
                else:  # kill one worker (rejoined on a later refresh
                    # or at the end)
                    victim = sorted(ctl.live_workers())[
                        int(rng.integers(0, len(ctl.live_workers())))]
                    w = next(x for x in fleet.thread_workers
                             if x.worker_id == victim and x._running)
                    w.kill()
                    dead[victim] = w
                    kills += 1
                    events.append({"i": i, "ev": "kill", "wid": victim})
            # ---- post-recovery acceptance --------------------------------
            for wid in sorted(dead):
                rejoin(wid)
                rejoins += 1
            dead.clear()
            merged = ctl.journal.log.merged_graph()
            mref = mirror.merged_graph()
            if not (np.array_equal(merged.row_ptr, mref.row_ptr)
                    and np.array_equal(merged.col_idx, mref.col_idx)):
                raise AssertionError(
                    "controller journal merged graph != acked-writes "
                    "mirror (acked write lost or corrupted)")
            for src in rng.integers(0, g.nv, 3):
                bounded_read(int(src), acked_gen, stale_ok=False)
            ctl.refresh_fleet()
            allr = ctl.read_standing_all("sssp")
            final_ref = bfs_reference(graphs[acked_gen], 0)
            for wid, ent in allr.items():
                if int(ent["generation"]) < acked_gen:
                    raise AssertionError(
                        f"{wid} standing tag {ent['generation']} < "
                        f"acked {acked_gen} after final refresh")
                if not np.array_equal(ent["state"], final_ref):
                    raise AssertionError(
                        f"{wid} post-recovery standing state != merged "
                        "reference")
    except ChaosFailure:
        raise
    except BaseException as e:  # noqa: BLE001 — every failure must
        # carry its reproduction recipe (seed + plan + events)
        raise _fail(seed, plan, events, f"{type(e).__name__}: {e}",
                    cause=e) from e
    finally:
        if plan is not None:
            fault.uninstall()
        try:
            fleet.close()
        except Exception:  # noqa: BLE001 — teardown must finish
            pass
        if own_tmp is not None:
            own_tmp.cleanup()
    return {
        "seed": seed, "steps": steps, "generation": acked_gen,
        "writes": sum(1 for e in events if e["ev"] == "write"),
        "reads": sum(1 for e in events if e["ev"].startswith("read")),
        "worker_kills": kills, "rejoins": rejoins,
        "failovers": failovers,
        "faults_injected": plan.total_fired() if plan else 0,
        "fault_counters": plan.counters() if plan else [],
        "events": events,
    }


def autopilot_soak(seed: int, steps: int = 8, scale: int = 7,
                   ef: int = 4, rows: int = 8, cap: int = 64,
                   start_workers: int = 1, max_workers: int = 3,
                   journal_root: Optional[str] = None,
                   read_deadline_s: float = 60.0, device="cuda") -> dict:
    """The FULL autonomous loop under one seed, the replicas on
    ``device``:

    1. a load ramp (offered qps above the per-worker knee) must trip
       the Autoscaler into a previewed, cooldown-gated scale-up;
    2. a controller kill must be DETECTED and repaired by a standby
       election — the harness only kills; a Standby runs
       ``promote_live_controller`` and the standing-query subscription
       keeps delivering across the failover via hub rebind;
    3. a small insert capacity must overflow into an escalated
       fleet-wide compaction;

    with the chaos invariants held throughout: zero acked-write loss,
    every read bitwise-equal to the merged reference at its tag, and
    post-recovery standing answers bitwise from every replica.
    Returns the report (incident keys included, so a recording caller
    can assert the stitched traces) or raises :class:`ChaosFailure`.
    """
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.models.sssp import bfs_reference
    from lux_tpu_torch.obs.slo import default_fleet_slos
    from lux_tpu_torch.serve.autopilot import (
        Autoscaler,
        AutoscalerConfig,
        Standby,
        StandbyGroup,
        default_fleet_policy,
    )
    from lux_tpu_torch.serve.fleet.worker import ReplicaWorker
    from lux_tpu_torch.serve.live.bench import churn_batch
    from lux_tpu_torch.serve.live.controller import (
        promote_live_controller,
        start_live_fleet,
    )
    from lux_tpu_torch.serve.live.replica import LiveReplica

    rng = np.random.default_rng(seed)
    g = generate.rmat(scale, ef, seed=int(rng.integers(1 << 30)))
    own_tmp = None
    if journal_root is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="lux_pilot_")
        journal_root = own_tmp.name
    snapshot_path = os.path.join(journal_root, "snap.lux")
    standing = (("sssp", 0),)
    parts = 2
    events: List[dict] = []
    graphs = {0: g}
    mirror = DeltaLog(g)
    acked_gen = 0
    delivered: List[int] = []
    knee_qps = 50.0  # the "measured" per-worker knee the ramp beats

    fleet = start_live_fleet(
        start_workers, g, parts=parts, cap=cap, buckets=(1, 4),
        standing=standing, journal_root=journal_root,
        snapshot_path=snapshot_path, hb_interval_s=0.05, device=device)
    shards = build_pull_shards(g, parts)
    policy = default_fleet_policy(max_shed_frac=0.5)
    fleet.controller.set_slos(default_fleet_slos())
    fleet.controller.set_policy(policy)
    sub = fleet.controller.subscribe("sssp")
    hub = fleet.controller._sub_hub
    inc0 = str(fleet.controller.incarnation)

    def do_write(tag: str, n_rows: Optional[int] = None) -> dict:
        nonlocal acked_gen
        src, dst, op = churn_batch(mirror, rng,
                                   rows if n_rows is None else n_rows)
        rep = fleet.controller.admit_writes(
            src, dst, op, write_id=f"pilot-{seed}-{tag}")
        mirror.apply(src, dst, op)
        graphs[rep["generation"]] = mirror.merged_graph()
        acked_gen = max(acked_gen, rep["generation"])
        events.append({"ev": "write", "tag": tag,
                       "gen": rep["generation"],
                       "compacted": rep.get("compacted", False)})
        return rep

    def bounded_read(src: int) -> None:
        fut = fleet.controller.submit_retrying(
            int(src), deadline_s=read_deadline_s,
            min_generation=acked_gen,
            request_id=f"pilot-{seed}-r{len(events)}")
        ans = fut.result(timeout=0)
        gen_tag = fut.generation if fut.generation is not None else 0
        if gen_tag < acked_gen:
            raise AssertionError(
                f"read-your-writes broke: bound {acked_gen}, tag "
                f"{gen_tag}")
        if not np.array_equal(ans, bfs_reference(graphs[gen_tag],
                                                 int(src))):
            raise AssertionError(
                f"answer at generation {gen_tag} (src {src}) != merged "
                "reference")
        events.append({"ev": "read", "src": int(src), "tag": gen_tag})

    def drain_sub(min_gen: int, why: str) -> None:
        deadline = time.monotonic() + 30.0
        while True:
            upd = sub.get(timeout_s=max(deadline - time.monotonic(),
                                        0.1))
            delivered.append(int(upd["generation"]))
            if upd["generation"] >= min_gen:
                events.append({"ev": "sub", "why": why,
                               "gen": upd["generation"]})
                return
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"subscription stuck below generation {min_gen} "
                    f"({why}); delivered {delivered[-4:]}")

    def spawn(i: int):
        wid = f"w{start_workers + i}"
        live = LiveReplica(
            g, shards, cap=cap,
            journal_dir=os.path.join(journal_root, wid),
            standing=standing, device=device)
        w = ReplicaWorker(shards, worker_id=wid, graph_id="live",
                          q_buckets=(1, 4), live=live,
                          device=device).start()
        fleet.thread_workers.append(w)
        return w

    scaler = Autoscaler(
        fleet.controller, spawn,
        config=AutoscalerConfig(
            min_workers=start_workers, max_workers=max_workers,
            up_occupancy=0.6, down_occupancy=0.15, up_consecutive=2,
            down_consecutive=1000, cooldown_s=0.0, interval_s=0.05,
            max_move_frac=0.95),
        knee_qps_per_worker=knee_qps)
    standbys: List[Standby] = []
    try:
        # ---- phase A: load ramp -> autoscaler scale-up ---------------
        scaler.note_offered_qps(knee_qps * (start_workers + 1))
        for i in range(max(int(steps), 3)):
            do_write(f"a{i}")
            bounded_read(int(rng.integers(0, g.nv)))
            act = scaler.tick()
            if act is not None:
                events.append({"ev": "scale", **{
                    k: act[k] for k in ("action", "worker",
                                        "moved_frac", "seq")}})
        scale_ups = [a for a in scaler.actions()
                     if a["action"] == "scale_up"]
        if not scale_ups:
            raise AssertionError(
                "the load ramp never tripped the autoscaler "
                f"(signals: {scaler.signals()})")
        fleet.controller.refresh_fleet()
        drain_sub(acked_gen, "post-ramp refresh")

        # ---- phase B: controller kill -> standby election ------------
        def _promote(tc=None):
            endpoints = [("127.0.0.1", w.port)
                         for w in fleet.thread_workers if w._running]
            return promote_live_controller(
                g, os.path.join(journal_root, "controller"),
                snapshot_path, endpoints, seed=seed + 2)

        group = StandbyGroup()
        standbys = [Standby(group, sid, fleet.controller, _promote,
                            on_promoted=lambda c, r: hub.rebind(c),
                            hb_interval_s=0.02, death_after_s=0.15,
                            seed=seed).start()
                    for sid in range(2)]
        fleet.controller.kill()
        got = group.wait_promoted(timeout_s=60.0)
        if got is None:
            raise AssertionError(
                "no standby promoted a controller within 60s")
        ctl2, rep = got
        if ctl2.generation() < acked_gen:
            raise AssertionError(
                f"promotion lost acked writes: journal at "
                f"{ctl2.generation()}, acked {acked_gen}")
        fleet.controller = ctl2
        ctl2.set_slos(default_fleet_slos())
        ctl2.set_policy(policy)
        events.append({"ev": "failover", "winner": group.claimed_by(inc0),
                       "joined": rep["joined"], "refused": rep["refused"],
                       "gen": ctl2.generation()})
        drain_sub(0, "rebind after election")  # delivery survived

        # ---- phase C: overflow -> escalated compaction ---------------
        # fat churn batches: the overlay capacity is per-part and
        # LANE-rounded (mutate/overlay.delta_cap), so thin batches
        # would take ~cap writes to fill it — the drill wants the
        # OVERFLOW, not the grind
        compactions = 0
        for i in range(40):
            if do_write(f"c{i}", n_rows=rows * 8).get("compacted"):
                compactions += 1
                break
        if not compactions:
            raise AssertionError(
                f"insert cap {cap} never overflowed into a compaction "
                f"after 40 post-election fat batches")
        do_write("post-compact")

        # ---- acceptance ----------------------------------------------
        merged = fleet.controller.journal.log.merged_graph()
        mref = mirror.merged_graph()
        if not (np.array_equal(merged.row_ptr, mref.row_ptr)
                and np.array_equal(merged.col_idx, mref.col_idx)):
            raise AssertionError(
                "controller journal merged graph != acked-writes "
                "mirror (acked write lost or corrupted)")
        for src in rng.integers(0, g.nv, 3):
            bounded_read(int(src))
        fleet.controller.refresh_fleet()
        final_ref = bfs_reference(graphs[acked_gen], 0)
        for wid, ent in fleet.controller.read_standing_all(
                "sssp").items():
            if int(ent["generation"]) < acked_gen:
                raise AssertionError(
                    f"{wid} standing tag {ent['generation']} < acked "
                    f"{acked_gen} after final refresh")
            if not np.array_equal(ent["state"], final_ref):
                raise AssertionError(
                    f"{wid} post-recovery standing state != merged "
                    "reference")
        drain_sub(acked_gen, "final refresh")
    except ChaosFailure:
        raise
    except BaseException as e:  # noqa: BLE001 — carry the recipe
        raise _fail(seed, None, events, f"{type(e).__name__}: {e}",
                    cause=e, repro="autopilot_soak") from e
    finally:
        for s in standbys:
            s.stop()
        scaler.stop()
        try:
            fleet.close()
        except Exception:  # noqa: BLE001 — teardown must finish
            pass
        if own_tmp is not None:
            own_tmp.cleanup()
    return {
        "seed": seed, "generation": acked_gen,
        "writes": sum(1 for e in events if e["ev"] == "write"),
        "reads": sum(1 for e in events if e["ev"] == "read"),
        "scale_ups": len(scale_ups), "elections": group.elections,
        "winner": group.claimed_by(inc0), "compactions": compactions,
        "sub_delivered": delivered,
        "incident_keys": {
            "election": f"election:{inc0}",
            "scale": [f"scale:{inc0}:{a['seq']}"
                      for a in scaler.actions()],
        },
        "events": events,
    }


def election_drill(plan: "fault.FaultPlan", fenced: bool = True,
                   timeout_s: float = 30.0) -> dict:
    """Replay an election counterexample of the model checker against
    the REAL election code (the model -> implementation round-trip).

    ``plan`` is an exported counterexample schedule
    (``lux_tpu_torch.analysis.proto.export.export_faultplan``, or the
    reference's, whose JSON is the same): delay rules
    at the ``election.detect`` / ``election.promote`` process points
    that hold the first winner's promotion window open while a second
    standby detects late — the detached-promotion + TOCTOU schedule.
    The drill runs real :class:`Standby` threads over a dead incumbent
    and imposes the schedule:

    * ``fenced=True`` — the real :class:`StandbyGroup`: the late
      claimant is fenced out and must adopt; ``elections == 1``;
    * ``fenced=False`` — the model's broken twin
      (``UnfencedStandbyGroup``): the SAME schedule completes a second
      promotion; ``elections == 2`` — the model's abstract split-brain
      reproduced as a real one.

    Returns ``{"elections", "outcomes", "winner", "fired"}``; the
    caller asserts on ``elections``.  The incumbent and the promoted
    controllers are inert stand-ins — the protocol under drill is the
    election, not the promotion payload (chaos_soak covers that
    integration end-to-end).
    """
    from lux_tpu_torch.serve.autopilot.election import Standby, StandbyGroup

    class _DeadIncumbent:
        incarnation = "inc-0"
        hb_interval_s = 0.01
        hb_timeout_s = 0.03

        def ping(self):
            raise ConnectionError("incumbent is dead")

    class _PromotedController:
        def __init__(self, sid: int):
            self.incarnation = f"inc-1-s{sid}"

    if fenced:
        group = StandbyGroup()
    else:
        from lux_tpu_torch.analysis.proto.election_model import (
            UnfencedStandbyGroup,
        )

        group = UnfencedStandbyGroup()
    incumbent = _DeadIncumbent()
    standbys: List[Standby] = []
    with fault.installed(plan):
        for sid in range(2):
            def _promote(tc=None, sid=sid):
                return (_PromotedController(sid),
                        {"joined": [], "refused": []})

            standbys.append(Standby(
                group, sid, incumbent, _promote,
                hb_interval_s=incumbent.hb_interval_s,
                death_after_s=incumbent.hb_timeout_s,
                seed=sid).start())
        try:
            # wait for the first claim, then stop the claimant MID-
            # promotion (its promote is held open by the plan's delay
            # rule): stop() deregisters it, shifting min(live ids) to
            # the late detector while the promotion is still running —
            # the fence is now the ONLY thing standing between the
            # late claim and a second election
            deadline = time.monotonic() + timeout_s
            first = None
            while time.monotonic() < deadline:
                first = group.claimed_by(incumbent.incarnation)
                if first is not None:
                    break
                time.sleep(0.002)
            if first is None:
                raise AssertionError(
                    "election drill: no standby claimed within "
                    f"{timeout_s}s (plan: {plan.describe()})")
            group.deregister(first)  # stop() would join the held
            # promotion; the drill needs the deregistration NOW
            standbys[first]._stop.set()
            # let both the detached promotion and the late detector
            # run to completion
            settle = time.monotonic() + timeout_s
            while time.monotonic() < settle:
                done = all(s.outcome is not None or not
                           (s._thread is not None
                            and s._thread.is_alive())
                           for s in standbys)
                if done and group.promoted is not None:
                    break
                time.sleep(0.01)
        finally:
            for s in standbys:
                s.stop()
    return {
        "elections": group.elections,
        "outcomes": {s.standby_id: s.outcome for s in standbys},
        "winner": group.claimed_by(incumbent.incarnation),
        "fired": plan.total_fired(),
    }
