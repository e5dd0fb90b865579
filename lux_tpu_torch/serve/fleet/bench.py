"""Fleet saturation measurement core of ``lux_tpu_torch/tools/fleet_bench.py``.

Counterpart of ``lux_tpu.serve.fleet.bench``; ``measure_autoscale`` drives
the autopilot's autoscaler over it.

The measurement is an **open-loop offered-QPS ramp**: at each level the
harness submits queries at a fixed rate for a window (it does NOT wait
for answers before submitting the next — closed-loop clients can never
overrun a service, so they never find the knee), then resolves every
future and scores the level:

* sustained  — goodput >= ``GOODPUT_FRAC`` x offered, and the
  shed+error+timeout fraction <= ``FAIL_FRAC``;
* the **knee** is the highest sustained goodput; the ramp stops at the
  first unsustained level (the service is past saturation: queues grow
  without bound, p99 explodes, the controller sheds).

Each fleet width gets its own ramp and its own row
(``sssp_fleet_qps_w{W}_rmat{scale}_1chip``, with a ``_cpu_fallback``
suffix off the card).  Workers are spawned as real processes by default
(``mode="proc"``, shared-nothing, loopback sockets), each a CUDA process
on ``device`` (default ``cuda``) that inherits ``CUDA_VISIBLE_DEVICES``;
``mode="thread"`` runs them in-process for fast tests — same protocol,
same controller path, same bytes on the wire.  ``pin`` ties a worker's
HOST threads to one core; its engines stay on ``device``.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np

from lux_tpu_torch.obs import dtrace
from lux_tpu_torch.obs.slo import default_fleet_slos
from lux_tpu_torch.serve.fleet.controller import (
    FleetController,
    FleetError,
    FleetRejectedError,
    FleetTimeoutError,
)

#: a level is sustained when goodput >= this fraction of offered load...
GOODPUT_FRAC = 0.85
#: ...and at most this fraction of requests shed / errored / timed out
FAIL_FRAC = 0.05


# ----------------------------------------------------------------------
# fleet lifecycle (thread + process modes)
# ----------------------------------------------------------------------


class Fleet:
    """A controller plus the workers it was started with; ``close()``
    tears everything down regardless of mode or health."""

    def __init__(self, controller: FleetController, thread_workers: list,
                 procs: list):
        self.controller = controller
        self.thread_workers = thread_workers
        self.procs = procs

    def close(self) -> None:
        try:
            self.controller.close(shutdown_workers=bool(self.procs))
        except Exception:  # noqa: BLE001 — teardown must finish
            pass
        for w in self.thread_workers:
            try:
                if w._running:
                    w.stop()
            except Exception:  # noqa: BLE001
                pass
        for p in self.procs:  # launcher.ProcHandle: SIGTERM, then SIGKILL
            try:
                p.terminate(timeout_s=10.0)
            except Exception:  # noqa: BLE001
                pass


def start_fleet(n_workers: int, graph_path: str = "", shards=None,
                graph_id: str = "g", mode: str = "proc", parts: int = 1,
                buckets: Sequence[int] = (1, 8), max_queue: int = 256,
                wait_ms: float = 2.0, hb_interval_s: float = 0.25,
                pin: bool = True, device: str = "cuda",
                apps: Sequence[str] = ("sssp",), method: str = "auto",
                env: Optional[dict] = None) -> Fleet:
    """Start ``n_workers`` replicas + a controller wired to all of them.

    ``mode="proc"`` spawns worker processes serving ``graph_path`` (the
    honest shared-nothing fleet), all started together (each loads the
    snapshot, builds its shards and warms its engines on ``device``);
    ``mode="thread"`` builds in-process workers over ``shards``.
    ``pin`` (proc mode, Linux) pins worker ``i``'s host threads to core
    ``i % ncores``; ``env`` adds to the workers' environment (a drill's
    ``LUX_FAULT_PLAN``).  Kernels are built once in this process before the
    first CUDA worker starts (serve/fleet/launcher.prebuild_kernels).
    """
    from concurrent.futures import ThreadPoolExecutor

    from lux_tpu_torch import obs
    from lux_tpu_torch.serve.fleet import launcher

    ctl = FleetController(hb_interval_s=hb_interval_s)
    procs: list = []
    threads: list = []
    fleet = Fleet(ctl, threads, procs)
    try:
        with obs.span("fleet.start", workers=n_workers, mode=mode,
                      graph=graph_id, device=str(device)):
            if mode == "proc":
                if not graph_path:
                    raise ValueError("proc mode needs graph_path")
                launcher.prebuild_kernels(device)
                cores = (sorted(os.sched_getaffinity(0))
                         if pin and hasattr(os, "sched_getaffinity") else [])

                def spawn(i: int):
                    extra = ["--graph", graph_path, "--graph-id", graph_id,
                             "--parts", str(parts),
                             "--apps", ",".join(apps),
                             "--buckets", ",".join(str(b) for b in buckets),
                             "--method", method,
                             "--max-queue", str(max_queue),
                             "--wait-ms", str(wait_ms)]
                    if cores:
                        extra += ["--cpus", str(cores[i % len(cores)])]
                    return launcher.launch(
                        "lux_tpu_torch.serve.fleet.worker",
                        ["--worker-id", f"w{i}", "--port", "0",
                         "--device", str(device), *extra],
                        env={"LUX_OBS_RUN_ID": obs.run_id(), **(env or {})})

                with ThreadPoolExecutor(max(n_workers, 1)) as ex:
                    futs = [ex.submit(spawn, i) for i in range(n_workers)]
                    errs = []
                    for f in futs:
                        try:
                            procs.append(f.result())
                        except Exception as e:  # noqa: BLE001
                            errs.append(e)
                if errs:
                    raise FleetError(f"worker failed to start: {errs[0]}")
                ports = [p.port for p in procs]
            else:
                if shards is None:
                    raise ValueError("thread mode needs shards")
                from lux_tpu_torch.serve.fleet.worker import ReplicaWorker

                for i in range(n_workers):
                    w = ReplicaWorker(
                        shards, worker_id=f"w{i}", graph_id=graph_id,
                        apps=tuple(apps), q_buckets=tuple(buckets),
                        max_queue=max_queue, max_wait_ms=wait_ms,
                        method=method, device=device).start()
                    threads.append(w)
                ports = [w.port for w in threads]
            for port in ports:
                ctl.add_worker("127.0.0.1", port)
    except BaseException:
        fleet.close()
        raise
    return fleet


# ----------------------------------------------------------------------
# the ramp
# ----------------------------------------------------------------------


def offered_level(ctl: FleetController, sources: np.ndarray, rate: float,
                  window_s: float, timeout_ms: float = 4000.0,
                  grace_s: float = 15.0) -> dict:
    """One open-loop level: submit at ``rate`` QPS for ``window_s``,
    resolve everything, score it."""
    n = max(int(rate * window_s), 1)
    futs = []
    shed = 0
    t0 = time.monotonic()  # FleetFuture stamps t_done on this clock
    for i in range(n):
        target = t0 + i / rate
        now = time.monotonic()
        if target > now:
            time.sleep(target - now)
        try:
            futs.append(ctl.submit(int(sources[i % len(sources)]),
                                   timeout_ms=timeout_ms))
        except FleetRejectedError:
            shed += 1  # admission backpressure IS the datapoint
    ok = timeouts = errors = 0
    last_done = t0 + window_s
    lat: List[float] = []
    for f in futs:
        try:
            f.result(timeout=grace_s)
            ok += 1
            if f.latency_s is not None:
                lat.append(f.latency_s)
            if f.t_done is not None:
                last_done = max(last_done, f.t_done)
        except FleetTimeoutError:
            timeouts += 1
        except FleetError:
            errors += 1
    fail_frac = (shed + timeouts + errors) / max(n, 1)
    lat_ms = sorted(x * 1e3 for x in lat)
    # goodput horizon: submit window + completion tail, from the futures'
    # own resolve stamps (NOT the wall time of this thread's sequential
    # result() loop), minus one typical latency — a healthy level's last
    # answer lands ~p50 after its last submit, and charging that tail
    # against the rate would mis-score a 100%-complete level as
    # unsustained whenever p50/window_s exceeds 1-GOODPUT_FRAC.  Past
    # the knee the backlog drains for MANY multiples of p50, so the
    # correction never hides real saturation.
    p50_s = (lat_ms[len(lat_ms) // 2] / 1e3) if lat_ms else 0.0
    elapsed = max(last_done - t0 - p50_s, window_s)
    goodput = ok / elapsed

    def pct(p):
        if not lat_ms:
            return 0.0
        return round(lat_ms[min(int(p / 100 * len(lat_ms)),
                                len(lat_ms) - 1)], 2)

    return {
        "offered_qps": round(rate, 1),
        "submitted": n,
        "completed": ok,
        "shed": shed,
        "timeouts": timeouts,
        "errors": errors,
        "goodput_qps": round(goodput, 2),
        "fail_frac": round(fail_frac, 4),
        "p50_ms": pct(50),
        "p99_ms": pct(99),
        "sustained": bool(goodput >= GOODPUT_FRAC * rate
                          and fail_frac <= FAIL_FRAC),
    }


def ramp_to_knee(ctl: FleetController, sources: np.ndarray,
                 start_qps: float = 8.0, growth: float = 1.6,
                 max_levels: int = 12, window_s: float = 1.5,
                 timeout_ms: float = 4000.0, settle_s: float = 0.25,
                 refine_levels: int = 3) -> dict:
    """Ramp offered QPS geometrically until the fleet stops sustaining
    it, then bisect the bracket; the knee is the best sustained goodput
    (QPS + p99 there).

    The refinement phase exists because a geometric grid alone is too
    coarse at the top: with growth 1.6 the true capacity can sit ~anywhere
    in a 60% span between the last sustained and first failing level, and
    whether the boundary level "sustains" becomes a coin flip between
    runs.  Bisecting the (sustained, failed) bracket pins the knee to a
    ~growth^(1/2^refine_levels) band instead."""
    from lux_tpu_torch import obs

    levels: List[dict] = []
    knee: Optional[dict] = None
    fail_rate: Optional[float] = None

    def run_level(rate: float, i, phase: str) -> dict:
        with obs.span("fleet.bench.level", offered=round(rate, 1),
                      level=i, phase=phase) as sp:
            lv = offered_level(ctl, sources, rate, window_s,
                               timeout_ms=timeout_ms)
            sp.set(goodput=lv["goodput_qps"], sustained=lv["sustained"])
        lv["phase"] = phase
        levels.append(lv)
        time.sleep(settle_s)  # let queues drain between levels
        return lv

    rate = float(start_qps)
    unsustained_run = 0
    for i in range(max_levels):
        lv = run_level(rate, i, "ramp")
        if lv["sustained"]:
            unsustained_run = 0
            if knee is None or lv["goodput_qps"] > knee["goodput_qps"]:
                knee = lv
                fail_rate = None  # a fail below a later knee is stale
        else:
            if fail_rate is None or rate < fail_rate:
                fail_rate = rate
            # one bad level can be a transient (GC pause, page-in burst
            # on an oversubscribed host) — a KNEE needs the collapse to
            # hold, so stop only on two unsustained levels in a row.
            # That rule applies with NO knee found too: a start rate
            # already past capacity must not ramp geometrically through
            # every level of pure timeouts
            unsustained_run += 1
            if unsustained_run >= 2:
                break
        rate *= growth
    if knee is not None and fail_rate is not None:
        lo, hi = knee["offered_qps"], fail_rate
        for i in range(refine_levels):
            if hi / max(lo, 1e-9) < 1.15:
                break  # bracket already tight
            mid = (lo * hi) ** 0.5  # geometric midpoint
            lv = run_level(mid, i, "refine")
            if lv["sustained"]:
                lo = mid
                if lv["goodput_qps"] > knee["goodput_qps"]:
                    knee = lv
            else:
                hi = mid
    if knee is None:
        knee = max(levels, key=lambda l: l["goodput_qps"])
    return {"levels": levels, "knee_qps": knee["goodput_qps"],
            "knee_offered_qps": knee["offered_qps"],
            "knee_p50_ms": knee["p50_ms"], "knee_p99_ms": knee["p99_ms"],
            "knee_sustained": knee["sustained"]}


# ----------------------------------------------------------------------
# paired width comparison
# ----------------------------------------------------------------------


def closed_loop_slice(ctl: FleetController, sources: np.ndarray,
                      dur_s: float, inflight: int = 64,
                      grace_s: float = 60.0) -> float:
    """Closed-loop goodput for one slice: keep ``inflight`` requests
    outstanding for ``dur_s``, then drain; returns completed QPS.
    In-flight accounting is a semaphore released by each future's done
    callback — O(1) per request, so the client never becomes the thing
    being measured."""
    import threading

    slots = threading.Semaphore(inflight)
    t0 = time.perf_counter()
    futs: List = []
    i = 0
    while time.perf_counter() - t0 < dur_s:
        if not slots.acquire(timeout=0.05):
            continue  # fleet has inflight outstanding; re-check clock
        f = ctl.submit(int(sources[i % len(sources)]))
        f.add_done_callback(lambda _f: slots.release())
        futs.append(f)
        i += 1
    ok = 0
    for f in futs:
        try:
            f.result(timeout=grace_s)
            ok += 1
        except FleetError:
            pass
    return ok / (time.perf_counter() - t0)


def paired_probe(ctl_a: FleetController, ctl_b: FleetController,
                 sources: np.ndarray, slices: int = 6,
                 slice_s: float = 2.5, inflight: int = 48) -> dict:
    """Interleaved paired capacity comparison of two LIVE fleets.

    Why this exists: on a shared/CPU-quota'd host, throughput swings 2x+
    on ~30 s timescales, so sequential per-width ramps compare two
    different machines-in-time and the width ratio is noise (measured
    here: sequential 2w/1w ratios of 0.5-1.7 across reps at a true ratio
    of ~1.9).  Keeping BOTH fleets alive and alternating short
    closed-loop slices between them pairs the host noise out; the MEDIAN
    per-slice ratio is the robust scale-out number, and a quota burst
    shows up as one outlier slice instead of poisoning a whole width."""
    from lux_tpu_torch import obs

    # one discarded warmup alternation: both fleets page in their hot
    # paths under load before any recorded slice
    closed_loop_slice(ctl_a, sources, slice_s / 2, inflight)
    closed_loop_slice(ctl_b, sources, slice_s / 2, inflight)
    qps_a: List[float] = []
    qps_b: List[float] = []
    for k in range(slices):
        with obs.span("fleet.bench.paired_slice", index=k) as sp:
            a = closed_loop_slice(ctl_a, sources, slice_s, inflight)
            b = closed_loop_slice(ctl_b, sources, slice_s, inflight)
            sp.set(qps_a=round(a, 1), qps_b=round(b, 1))
        qps_a.append(round(a, 2))
        qps_b.append(round(b, 2))
    ratios = sorted(b / a for a, b in zip(qps_a, qps_b) if a > 0)
    n = len(ratios)
    if not n:
        median = 0.0
    elif n % 2:  # true median: even counts average the middle pair
        median = ratios[n // 2]
    else:
        median = 0.5 * (ratios[n // 2 - 1] + ratios[n // 2])
    return {"qps_a": qps_a, "qps_b": qps_b,
            "ratios": [round(r, 2) for r in ratios],
            "median_ratio": round(median, 2)}


# ----------------------------------------------------------------------
# trace overhead (paired traced vs untraced slices)
# ----------------------------------------------------------------------


def measure_trace_overhead(ctl: FleetController, sources: np.ndarray,
                           slices: int = 6, slice_s: float = 1.5,
                           inflight: int = 48) -> dict:
    """Paired traced-vs-untraced throughput on ONE live fleet: the same
    interleaved closed-loop methodology as the width probe (host noise
    pairs out; a sequential A/B on a quota-swinging host measures the
    host).  Odd/even slices flip ``dtrace.set_enabled`` — everything
    else (fleet, engines, sockets) is identical.  Returns the per-slice
    QPS lists, the median traced/untraced ratio, and
    ``overhead_frac = 1 - median`` (what a tracing-cost budget
    reads).  The override is always restored."""
    qps_on: List[float] = []
    qps_off: List[float] = []

    def one(enabled: bool) -> None:
        dtrace.set_enabled(enabled)
        q = round(closed_loop_slice(ctl, sources, slice_s, inflight), 2)
        (qps_on if enabled else qps_off).append(q)

    try:
        # warmup alternation, discarded (page in both configurations)
        dtrace.set_enabled(False)
        closed_loop_slice(ctl, sources, slice_s / 2, inflight)
        dtrace.set_enabled(True)
        closed_loop_slice(ctl, sources, slice_s / 2, inflight)
        for k in range(slices):
            # ABBA ordering: alternate which config goes first so a
            # linear host-throughput drift cancels out of the pairs
            # instead of biasing every pair the same way
            first_off = (k % 2 == 0)
            one(not first_off)
            one(first_off)
    finally:
        dtrace.set_enabled(None)
    ratios = sorted(on / off for on, off in zip(qps_on, qps_off)
                    if off > 0)
    n = len(ratios)
    if not n:
        median = 0.0
    elif n % 2:
        median = ratios[n // 2]
    else:
        median = 0.5 * (ratios[n // 2 - 1] + ratios[n // 2])
    return {"qps_traced": qps_on, "qps_untraced": qps_off,
            "ratios": [round(r, 4) for r in ratios],
            "median_ratio": round(median, 4),
            "overhead_frac": round(1.0 - median, 4)}


# ----------------------------------------------------------------------
# the standing row
# ----------------------------------------------------------------------


def measure_fleet_saturation(scale: int = 12, ef: int = 8,
                             workers: Sequence[int] = (1, 2, 4),
                             mode: str = "proc", parts: int = 1,
                             buckets: Sequence[int] = (1, 8),
                             start_qps: float = 8.0, growth: float = 1.6,
                             max_levels: int = 12, window_s: float = 1.5,
                             seed: int = 0, graph_path: str = "",
                             pin: bool = True, paired: bool = True,
                             trace_probe: bool = True, device: str = "cuda",
                             method: str = "auto") -> dict:
    """Ramp a 1/2/4-worker fleet (each width its own fresh fleet) on one
    rmat graph; returns rows plus the width comparison.  ``graph_path``
    reuses an existing ``.lux`` snapshot; otherwise the graph is
    generated and written to a temp snapshot (proc workers load it from
    disk — the same file a republish would ship).  ``device``/``method``
    go to every worker; the rows name the card's fleet ``_1chip`` and
    add ``_cpu_fallback`` off it."""
    from lux_tpu_torch import obs
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.format import write_lux
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.serve.benchmarks import pick_sources

    g = None
    tmp = None
    if not graph_path:
        g = generate.rmat(scale, ef, seed=seed)
        tmp = tempfile.NamedTemporaryFile(
            suffix=".lux", prefix=f"fleet_rmat{scale}_", delete=False)
        tmp.close()
        write_lux(tmp.name, g)
        graph_path = tmp.name
    else:
        from lux_tpu_torch.graph.format import read_lux

        g = read_lux(graph_path)
    sources = pick_sources(g, 256, seed=seed)
    shards = build_pull_shards(g, parts) if mode == "thread" else None
    gid = f"rmat{scale}"
    on_card = str(device).split(":")[0] == "cuda"
    suffix = "_1chip" if on_card else "_1chip_cpu_fallback"
    rows: List[dict] = []
    knees = {}
    try:
        overhead = None
        for w in workers:
            with obs.span("fleet.bench.width", workers=int(w), mode=mode):
                fleet = start_fleet(
                    int(w), graph_path=graph_path, shards=shards,
                    graph_id=gid, mode=mode, parts=parts,
                    buckets=buckets, pin=pin, device=device,
                    method=method)
                # the standing serving SLOs, scored over the ramp's own
                # traffic — every width row records a verdict
                fleet.controller.set_slos(default_fleet_slos())
                try:
                    res = ramp_to_knee(
                        fleet.controller, sources, start_qps=start_qps,
                        growth=growth, max_levels=max_levels,
                        window_s=window_s)
                    if trace_probe and int(w) == max(
                            int(x) for x in workers):
                        # the tracing cost, measured at the
                        # widest fleet right after its ramp (the knee's
                        # QPS regime, paired slices)
                        with obs.span("fleet.bench.trace_overhead"):
                            overhead = measure_trace_overhead(
                                fleet.controller, sources)
                    ctl_stats = fleet.controller.stats()
                    slo_rows = fleet.controller.slo_status()
                    hb = {wid: d["last_hb"] for wid, d in
                          fleet.controller.workers().items()}
                finally:
                    fleet.close()
            knees[int(w)] = res["knee_qps"]
            rows.append({
                "metric": f"sssp_fleet_qps_w{w}_rmat{scale}{suffix}",
                "value": res["knee_qps"],
                "unit": "QPS",
                "p99_ms": res["knee_p99_ms"],
                "p50_ms": res["knee_p50_ms"],
                "offered_at_knee": res["knee_offered_qps"],
                "workers": int(w),
                "mode": mode,
                "pinned": bool(pin and mode == "proc"),
                "app": "sssp",
                "platform": "cuda" if on_card else "cpu",
                "method": method,
                "peak_bytes": {wid: h.get("peak_bytes") for wid, h in
                               hb.items()},
                "nv": int(g.nv),
                "ne": int(g.ne),
                "levels": res["levels"],
                "controller": ctl_stats,
                "slo": slo_rows,
                "run_id": obs.run_id(),
            })
        if paired and 1 in knees and 2 in knees:
            # the scale-out ratio (2 replicas vs 1) measured the
            # noise-robust way: both fleets live, load alternating
            with obs.span("fleet.bench.paired", widths=[1, 2]):
                fa = start_fleet(1, graph_path=graph_path, shards=shards,
                                 graph_id=gid, mode=mode, parts=parts,
                                 buckets=buckets, pin=pin, device=device,
                                 method=method)
                try:
                    fb = start_fleet(2, graph_path=graph_path,
                                     shards=shards, graph_id=gid,
                                     mode=mode, parts=parts,
                                     buckets=buckets, pin=pin,
                                     device=device, method=method)
                    try:
                        probe = paired_probe(fa.controller, fb.controller,
                                             sources)
                    finally:
                        fb.close()
                finally:
                    fa.close()
            for row in rows:
                if row["workers"] == 2:
                    row["paired_vs_w1"] = probe
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp.name)
            except OSError:
                pass
    out = {"rows": rows, "knees": knees, "graph": gid}
    if overhead is not None:
        out["trace_overhead"] = overhead
    if 1 in knees and 2 in knees and knees[1] > 0:
        out["scaleup_2v1_knee"] = round(knees[2] / knees[1], 2)
    if 1 in knees and 4 in knees and knees[1] > 0:
        out["scaleup_4v1_knee"] = round(knees[4] / knees[1], 2)
    for row in rows:
        if row.get("paired_vs_w1"):
            # the headline scale-out number: paired median, not the
            # sequential-knee ratio the host noise owns
            out["scaleup_2v1"] = row["paired_vs_w1"]["median_ratio"]
    return out


# ----------------------------------------------------------------------
# the autoscale ramp
# ----------------------------------------------------------------------


#: the autoscale bench's loads, as multiples of the knee it is given
OVERLOAD_FACTOR, LOW_FACTOR = 1.5, 0.5
#: the scaler's streaks: it ticks once a level, seconds of traffic, so one
#: overloaded level is the trend (a second would run under the shed mode
#: that the first one's latency arms); three idle levels retire a replica
AUTOSCALE_UP_TICKS, AUTOSCALE_DOWN_TICKS = 1, 3
#: the levels' read-latency objective: a batch of 8 RMAT 20 sources takes
#: about 0.25 s on the card at half the knee, so the reference's 500 ms
#: is two batches, and its burn arms shed mode inside the first
#: overloaded level
AUTOSCALE_P99_MS = 2000.0
#: a query's deadline: an overload's backlog drains, it does not time out
AUTOSCALE_TIMEOUT_MS = 30000.0
#: the scaler's bounds: one worker to start, one more at most
AUTOSCALE_MIN_WORKERS, AUTOSCALE_MAX_WORKERS = 1, 2


def measure_autoscale(knee_qps: float, spawner=None, scale: int = 10,
                      ef: int = 8, buckets: Sequence[int] = (1, 8),
                      window_s: float = 1.0, overload_levels: int = 2,
                      low_levels: int = 0, cooldown_s: float = 0.0,
                      mode: str = "thread", graph_path: str = "",
                      device: str = "cuda",
                      method: str = "auto") -> dict:
    """The closed-loop bench over a knee measured elsewhere
    (``knee_qps``, one worker's saturation QPS from
    :func:`measure_fleet_saturation`) on the seed-0 RMAT ``scale``
    graph (or ``graph_path``), one part a worker: start
    ``AUTOSCALE_MIN_WORKERS``, install the default AdmissionPolicy plus
    an Autoscaler fed that knee (at most ``AUTOSCALE_MAX_WORKERS``),
    then offer one level at ``LOW_FACTOR`` x the knee (the scaler must
    hold), up to ``overload_levels`` at ``OVERLOAD_FACTOR`` x (the
    scaler spawns and joins a replica, previewed), and up to
    ``low_levels`` at ``LOW_FACTOR`` x until the scaler retires a
    replica (LIFO, after ``cooldown_s``).  The scaler ticks after each
    level.  As in the reference's bench, the scale-up is decided on the
    offered load the bench declares (``note_offered_qps``) against the
    knee: the actions check the scaler's arithmetic and the fleet's
    join and retire, not the detection of an overload; each level's
    counts (goodput, p99, ``sustained``) are what the fleet measured.
    The row records every scale action, every level's counts, and the
    shed fraction of the overload levels against the policy's
    ``max_shed_frac`` budget (``shed_bounded``).  The SLO windows span
    2.5 and 7.5 levels, so an overload's burn clears inside the run.

    ``mode="thread"`` builds the baseline fleet and the spawned replicas
    in-process on ``device``; ``mode="proc"`` starts the baseline as
    worker processes serving ``graph_path`` and spawns through
    ``spawner`` (``launcher.process_spawner``'s (spawn, reap) pair)."""
    from lux_tpu_torch import obs
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.serve.autopilot import (
        Autoscaler,
        AutoscalerConfig,
        default_fleet_policy,
    )
    from lux_tpu_torch.serve.benchmarks import pick_sources
    from lux_tpu_torch.serve.fleet.worker import ReplicaWorker

    if graph_path:
        from lux_tpu_torch.graph.format import read_lux

        g = read_lux(graph_path, mmap=False)
    else:
        g = generate.rmat(scale, ef, seed=0)
    sources = pick_sources(g, 256, seed=0)
    gid = f"rmat{scale}"
    start_workers = AUTOSCALE_MIN_WORKERS
    shards = build_pull_shards(g, 1) if mode == "thread" else None
    fleet = start_fleet(start_workers, graph_path=graph_path, shards=shards,
                        graph_id=gid, mode=mode, parts=1,
                        buckets=buckets, device=device, method=method,
                        pin=False)
    ctl = fleet.controller
    policy = default_fleet_policy()
    ctl.set_slos(default_fleet_slos(
        read_p99_ms=AUTOSCALE_P99_MS,
        windows=((2.5 * window_s, 10.0), (7.5 * window_s, 2.0))))
    ctl.set_policy(policy)
    reap = None
    if spawner is not None:
        spawn_one, reap_one = spawner

        def spawn(i: int):
            h = spawn_one(i)
            fleet.procs.append(h)
            return h

        def reap(h) -> None:
            reap_one(h)
            if h in fleet.procs:
                fleet.procs.remove(h)
    else:
        if shards is None:
            shards = build_pull_shards(g, 1)

        def spawn(i: int):
            w = ReplicaWorker(
                shards, worker_id=f"w{start_workers + i}", graph_id=gid,
                q_buckets=tuple(buckets), method=method,
                device=device).start()
            fleet.thread_workers.append(w)
            return w

    scaler = Autoscaler(
        ctl, spawn, reap=reap,
        config=AutoscalerConfig(
            min_workers=start_workers, max_workers=AUTOSCALE_MAX_WORKERS,
            up_consecutive=AUTOSCALE_UP_TICKS,
            down_consecutive=AUTOSCALE_DOWN_TICKS,
            cooldown_s=float(cooldown_s), max_move_frac=0.95))
    grace_s = AUTOSCALE_TIMEOUT_MS / 1e3 + 15.0
    levels: List[dict] = []

    def level(rate: float, phase: str) -> dict:
        with obs.span("fleet.bench.autoscale.level", phase=phase,
                      offered=round(rate, 1)):
            lv = offered_level(ctl, sources, rate, window_s,
                               timeout_ms=AUTOSCALE_TIMEOUT_MS,
                               grace_s=grace_s)
        lv["phase"] = phase
        lv["t"] = time.monotonic()
        act = scaler.tick()
        if act is not None:
            lv["scale_action"] = act
        lv["alive"] = len(ctl.live_workers())
        levels.append(lv)
        return lv

    try:
        with obs.span("fleet.bench.autoscale", scale=scale,
                      start_workers=start_workers,
                      max_workers=AUTOSCALE_MAX_WORKERS):
            scaler.set_capacity(float(knee_qps))
            low_qps = float(knee_qps) * LOW_FACTOR
            scaler.note_offered_qps(low_qps)
            level(low_qps, "warm")
            overload_qps = float(knee_qps) * OVERLOAD_FACTOR
            scaler.note_offered_qps(overload_qps)
            shed = submitted = 0
            for _ in range(int(overload_levels)):
                lv = level(overload_qps, "overload")
                shed += lv["shed"]
                submitted += lv["submitted"]
                if len(ctl.live_workers()) >= AUTOSCALE_MAX_WORKERS:
                    break
            for _ in range(int(low_levels)):
                scaler.note_offered_qps(low_qps)
                lv = level(low_qps, "low")
                if lv.get("scale_action", {}).get("action") == "scale_down":
                    break
            ctl_stats = ctl.stats()
            slo_rows = ctl.slo_status()
    finally:
        scaler.stop()
        fleet.close()
    actions = scaler.actions()
    shed_frac = round(shed / max(submitted, 1), 4)
    workers_after = start_workers + sum(
        1 for a in actions if a["action"] == "scale_up") - sum(
        1 for a in actions if a["action"] == "scale_down")
    on_card = str(device).split(":")[0] == "cuda"
    row = {
        "metric": (f"sssp_autoscale_w{start_workers}to{workers_after}"
                   f"_rmat{scale}_{'cuda' if on_card else 'cpu'}"),
        "value": workers_after,
        "unit": "workers",
        "knee_qps": float(knee_qps),
        "workers_before": start_workers,
        "workers_after": workers_after,
        "scale_actions": actions,
        "overload_qps": round(overload_qps, 1),
        "low_qps": round(low_qps, 1),
        "shed": shed,
        "submitted": submitted,
        "shed_frac": shed_frac,
        "max_shed_frac": policy.max_shed_frac,
        "shed_bounded": bool(shed_frac <= policy.max_shed_frac),
        "policy": policy.to_dict(),
        "pilot": ctl_stats.get("pilot"),
        "app": "sssp",
        "platform": "cuda" if on_card else "cpu",
        "mode": mode,
        "method": method,
        "nv": int(g.nv),
        "ne": int(g.ne),
        "controller": ctl_stats,
        "slo": slo_rows,
        "run_id": obs.run_id(),
    }
    return {"rows": [row], "levels": levels, "graph": gid}
