"""SLO-driven autoscaling for the replica fleet.

Counterpart of ``lux_tpu.serve.autopilot.autoscaler``.  The fleet already
MEASURES everything that matters — per-worker queue occupancy rides
every heartbeat (serve/fleet/worker.py), the SLO engine turns
latency/availability into multiwindow burn verdicts (obs/slo.py), and
the saturation bench (serve/fleet/bench.py) locates the knee in
queries/s per worker.  ``tick()`` reads them and acts:

* **hot** when mean occupancy crosses ``up_occupancy``, when any SLO
  verdict is ``burning``, or when the knee-derived desired worker
  count (``ceil(offered_qps / knee_qps_per_worker)``) exceeds the
  live count -> spawn ONE worker and join it;
* **idle** when occupancy sits under ``down_occupancy`` with clean
  verdicts and no knee pressure -> retire the NEWEST spawned worker
  (LIFO, so the baseline fleet the operator started is never reaped).

Flap resistance comes from two mechanisms, both required: a signal
must hold for ``up_consecutive``/``down_consecutive`` ticks
(hysteresis — one bursty heartbeat is not a trend), and any action
starts a ``cooldown_s`` window during which no further action fires
(the join's ~1/(R+1) rebalance and replica warmup must land before the
signals are trusted again).  Every action is additionally gated on a
``rebalance_preview`` dry run: if the membership change would move
more than ``max_move_frac`` of the keyspace, the action is refused and
counted, because a rebalance that invalidates most of the fleet's
locality is worse than the congestion it fixes.

Scale actions are INCIDENTS: each emits a ``pilot.scale`` span on a
keyed incident trace (``scale:{incarnation}:{seq}``) carrying
direction, worker id, the previewed move fraction, and the occupancy/
verdict evidence — a stitched log renders the decision and the
resulting join/leave as one timeline.

The scaler owns only worker PROCESS lifecycle via the ``spawn`` /
``reap`` callables the harness provides; ring membership, key movement
and token fencing stay in the controller.  Pure stdlib.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, List, Optional

from lux_tpu_torch.obs import dtrace
from lux_tpu_torch.obs.slo import worst_verdict
from lux_tpu_torch.utils.config import env_float, env_int


class AutoscalerConfig:
    """Knobs with env overrides (resolved ONCE at construction — never
    read os.environ from the tick loop/thread):

    ==============================  =========================  =======
    knob                            env                        default
    ==============================  =========================  =======
    ``up_occupancy``                ``LUX_PILOT_UP_OCC``       0.6
    ``down_occupancy``              ``LUX_PILOT_DOWN_OCC``     0.15
    ``up_consecutive``              ``LUX_PILOT_UP_TICKS``     2
    ``down_consecutive``            ``LUX_PILOT_DOWN_TICKS``   4
    ``cooldown_s``                  ``LUX_PILOT_COOLDOWN_S``   2.0
    ``interval_s``                  ``LUX_PILOT_INTERVAL_S``   0.25
    ``max_move_frac``               ``LUX_PILOT_MAX_MOVE_FRAC``0.75
    ==============================  =========================  =======

    Explicit constructor arguments beat the environment; a garbage env
    value raises ``ValueError`` naming the knob (config.env_float's
    contract)."""

    def __init__(self, min_workers: int = 1, max_workers: int = 4,
                 up_occupancy: Optional[float] = None,
                 down_occupancy: Optional[float] = None,
                 up_consecutive: Optional[int] = None,
                 down_consecutive: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 interval_s: Optional[float] = None,
                 max_move_frac: Optional[float] = None):
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.up_occupancy = (
            env_float("LUX_PILOT_UP_OCC", 0.6, minimum=0.0, maximum=1.0)
            if up_occupancy is None else float(up_occupancy))
        self.down_occupancy = (
            env_float("LUX_PILOT_DOWN_OCC", 0.15, minimum=0.0,
                      maximum=1.0)
            if down_occupancy is None else float(down_occupancy))
        self.up_consecutive = (
            env_int("LUX_PILOT_UP_TICKS", 2, minimum=1, maximum=1000)
            if up_consecutive is None else int(up_consecutive))
        self.down_consecutive = (
            env_int("LUX_PILOT_DOWN_TICKS", 4, minimum=1, maximum=1000)
            if down_consecutive is None else int(down_consecutive))
        self.cooldown_s = (
            env_float("LUX_PILOT_COOLDOWN_S", 2.0, minimum=0.0,
                      maximum=3600.0)
            if cooldown_s is None else float(cooldown_s))
        self.interval_s = (
            env_float("LUX_PILOT_INTERVAL_S", 0.25, minimum=0.01,
                      maximum=60.0)
            if interval_s is None else float(interval_s))
        self.max_move_frac = (
            env_float("LUX_PILOT_MAX_MOVE_FRAC", 0.75, minimum=0.0,
                      maximum=1.0)
            if max_move_frac is None else float(max_move_frac))
        self.validate()

    def validate(self) -> None:
        if not (1 <= self.min_workers <= self.max_workers):
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"{self.min_workers}..{self.max_workers}")
        if self.down_occupancy >= self.up_occupancy:
            raise ValueError(
                f"down_occupancy ({self.down_occupancy}) must sit below "
                f"up_occupancy ({self.up_occupancy}) — equal thresholds "
                f"flap")


class Autoscaler:
    """The scaling loop.  ``spawn(index) -> worker`` must return a
    STARTED worker object exposing ``.worker_id`` and ``.port`` (the
    live-fleet harnesses build the LiveReplica + ReplicaWorker pair);
    ``reap(worker)`` tears the process down after a scale-down
    (optional — workers also exit on the controller's shutdown RPC).

    Drive it either by calling ``tick()`` from the harness (tests and
    the bench do — deterministic with an injected ``clock``) or via
    ``start()``'s background thread at ``config.interval_s``."""

    def __init__(self, controller,
                 spawn: Callable[[int], object],
                 reap: Optional[Callable[[object], None]] = None,
                 config: Optional[AutoscalerConfig] = None,
                 knee_qps_per_worker: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.ctl = controller
        self.spawn = spawn
        self.reap = reap
        self.cfg = config if config is not None else AutoscalerConfig()
        self.knee_qps_per_worker = (
            None if knee_qps_per_worker is None
            else float(knee_qps_per_worker))
        self.clock = clock
        self._lock = threading.Lock()
        self._offered_qps: Optional[float] = None
        self._hot_streak = 0
        self._idle_streak = 0
        self._last_action_t: Optional[float] = None
        self._seq = 0
        self._spawned: List[object] = []  # LIFO retirement order
        self._refused_moves = 0
        self._actions: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- inputs ----------------------------------------------------------

    def note_offered_qps(self, qps: Optional[float]) -> None:
        """Tell the scaler the CURRENT offered load (the bench/ingest
        layer knows it; the controller only sees what it admits)."""
        with self._lock:
            self._offered_qps = None if qps is None else float(qps)

    def set_capacity(self, knee_qps_per_worker: Optional[float]) -> None:
        """Install (or refresh) the measured saturation knee — the
        per-worker capacity estimate the desired-count signal divides
        by.  Feed it from ``ramp_to_knee``'s estimate."""
        with self._lock:
            self.knee_qps_per_worker = (
                None if knee_qps_per_worker is None
                else float(knee_qps_per_worker))

    def signals(self) -> dict:
        """The current evidence, as ``tick()`` will read it: mean
        queue occupancy over live workers' last heartbeats, the worst
        SLO verdict, the live count, and the knee-derived desired
        count (None without both a knee and an offered-qps note)."""
        workers = self.ctl.workers()
        occs = []
        for info in workers.values():
            if not info.get("alive"):
                continue
            hb = info.get("last_hb") or {}
            if "occupancy" in hb:
                occs.append(float(hb["occupancy"]))
            elif "queue_depth" in hb:
                occs.append(float(hb["queue_depth"])
                            / max(float(hb.get("max_queue", 256)), 1.0))
        alive = sum(1 for i in workers.values() if i.get("alive"))
        with self._lock:
            offered = self._offered_qps
            knee = self.knee_qps_per_worker
        desired = None
        if offered is not None and knee is not None and knee > 0:
            desired = max(self.cfg.min_workers,
                          min(self.cfg.max_workers,
                              int(math.ceil(offered / knee))))
        return {"occupancy": (sum(occs) / len(occs)) if occs else 0.0,
                "verdict": worst_verdict(self.ctl.slo_status()),
                "alive": alive, "desired": desired,
                "offered_qps": offered, "knee": knee}

    # -- the loop --------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """One control-loop evaluation.  Returns the action report —
        ``{action, worker, moved_frac, occupancy, verdict, ...}`` —
        when an action fired, ``None`` when the loop held steady."""
        now = self.clock() if now is None else float(now)
        sig = self.signals()
        occ, verdict, alive = (sig["occupancy"], sig["verdict"],
                               sig["alive"])
        desired = sig["desired"]
        hot = (occ >= self.cfg.up_occupancy or verdict == "burning"
               or (desired is not None and desired > alive))
        idle = (occ <= self.cfg.down_occupancy
                and verdict in ("ok", "no_data")
                and (desired is None or desired < alive))
        with self._lock:
            self._hot_streak = self._hot_streak + 1 if hot else 0
            self._idle_streak = self._idle_streak + 1 if idle else 0
            hot_ready = self._hot_streak >= self.cfg.up_consecutive
            idle_ready = self._idle_streak >= self.cfg.down_consecutive
            cooling = (self._last_action_t is not None
                       and now - self._last_action_t < self.cfg.cooldown_s)
        if cooling:
            return None
        if hot_ready and alive < self.cfg.max_workers:
            return self._scale_up(now, sig)
        if idle_ready and alive > self.cfg.min_workers and self._spawned:
            return self._scale_down(now, sig)
        return None

    def _incident(self, direction: str):
        with self._lock:
            self._seq += 1
            seq = self._seq
        key = f"scale:{self.ctl.incarnation}:{seq}"
        return dtrace.incident(key), seq

    def _scale_up(self, now: float, sig: dict) -> Optional[dict]:
        w = self.spawn(len(self._spawned))
        preview = self.ctl.rebalance_preview(add=[w.worker_id])
        if preview["moved_frac"] > self.cfg.max_move_frac:
            # refuse the join, reap the orphan: moving this much of
            # the keyspace mid-congestion does more harm than one
            # more replica does good
            with self._lock:
                self._refused_moves += 1
            if self.reap is not None:
                self.reap(w)
            return None
        stc, seq = self._incident("up")
        with dtrace.tspan("pilot.scale", stc, always=True,
                          direction="up", worker=w.worker_id,
                          moved_frac=preview["moved_frac"],
                          occupancy=round(sig["occupancy"], 4),
                          verdict=sig["verdict"], seq=seq):
            self.ctl.add_worker("127.0.0.1", w.port, tc=stc)
        self.ctl._pilot_count("scale_up")
        report = {"action": "scale_up", "worker": w.worker_id,
                  "moved_frac": preview["moved_frac"],
                  "occupancy": sig["occupancy"],
                  "verdict": sig["verdict"], "alive": sig["alive"] + 1,
                  "seq": seq}
        with self._lock:
            self._spawned.append(w)
            self._last_action_t = now
            self._hot_streak = 0
            self._idle_streak = 0
            self._actions.append(report)
        return report

    def _scale_down(self, now: float, sig: dict) -> Optional[dict]:
        with self._lock:
            if not self._spawned:
                return None
            w = self._spawned[-1]
        preview = self.ctl.rebalance_preview(remove=[w.worker_id])
        if preview["moved_frac"] > self.cfg.max_move_frac:
            with self._lock:
                self._refused_moves += 1
            return None
        stc, seq = self._incident("down")
        with dtrace.tspan("pilot.scale", stc, always=True,
                          direction="down", worker=w.worker_id,
                          moved_frac=preview["moved_frac"],
                          occupancy=round(sig["occupancy"], 4),
                          verdict=sig["verdict"], seq=seq):
            self.ctl.remove_worker(w.worker_id, shutdown=True)
        self.ctl._pilot_count("scale_down")
        if self.reap is not None:
            self.reap(w)
        report = {"action": "scale_down", "worker": w.worker_id,
                  "moved_frac": preview["moved_frac"],
                  "occupancy": sig["occupancy"],
                  "verdict": sig["verdict"], "alive": sig["alive"] - 1,
                  "seq": seq}
        with self._lock:
            self._spawned.pop()
            self._last_action_t = now
            self._hot_streak = 0
            self._idle_streak = 0
            self._actions.append(report)
        return report

    # -- lifecycle -------------------------------------------------------

    def actions(self) -> List[dict]:
        with self._lock:
            return list(self._actions)

    def stats(self) -> dict:
        with self._lock:
            return {"actions": len(self._actions),
                    "spawned_live": len(self._spawned),
                    "refused_moves": self._refused_moves,
                    "hot_streak": self._hot_streak,
                    "idle_streak": self._idle_streak}

    def start(self) -> "Autoscaler":
        """Run ``tick()`` on a daemon thread every ``interval_s``."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="lux-pilot-scale",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — a failed tick must not
                pass           # kill the loop; next tick re-reads state

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
