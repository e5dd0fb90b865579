"""Mixed read/write measurement for the live fleet.

Counterpart of ``lux_tpu.serve.live.bench`` (the core behind the
reference's ``sssp_live_w{W}_rmat{scale}`` row).  The workload is the
product shape: a writer admitting edge-churn batches through the
controller (each batch = half deletes of live base edges, half inserts —
edge count roughly conserved) while closed-loop readers keep sssp
queries in flight against the fleet.  Measured:

* sustained write batches/s + rows/s (admit -> journal -> replicate ->
  every replica acked, the full write path);
* read QPS under the concurrent write load;
* read STALENESS in generations — journal generation at submit minus
  the generation tag the answer carries — p50/p99;
* fleet refresh latency: one ``refresh_fleet`` after the mixed window
  (warm standing states to the final generation, every replica).

``mixed_window`` drives one window through any live controller (thread
or process workers); ``measure_live_mixed`` builds a thread-mode fleet
on ``device`` around it.
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from lux_tpu_torch.serve.fleet.controller import FleetError
from lux_tpu_torch.serve.live.controller import start_live_fleet


def churn_batch(dlog, rng, rows: int):
    """(src, dst, op) for one balanced churn batch against ``dlog``'s
    CURRENT epoch base: rows//2 deletes of LIVE base edges (the base
    minus already-tombstoned slots — compaction-epoch safe) + rows//2
    inserts of fresh random edges."""
    base = dlog.base
    ndel = rows // 2
    live = np.flatnonzero(~dlog.del_base)
    ndel = min(ndel, len(live))
    dele = rng.choice(live, ndel, replace=False) if ndel else \
        np.zeros(0, np.int64)
    nins = rows - ndel
    src = np.concatenate([np.asarray(base.col_idx, np.int64)[dele],
                          rng.integers(0, base.nv, nins)])
    dst = np.concatenate([np.asarray(base.dst_of_edges(),
                                     np.int64)[dele],
                          rng.integers(0, base.nv, nins)])
    op = np.concatenate([np.zeros(ndel, np.int8),
                         np.ones(nins, np.int8)])
    return src, dst, op


def _pct(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(int(p / 100 * len(sorted_vals)),
                           len(sorted_vals) - 1)]


def mixed_window(ctl, sources: Sequence[int], rng, batch_rows: int = 64,
                 write_batches: int = 20, reader_threads: int = 2,
                 rmw_frac: float = 0.25, min_window_s: float = 2.0,
                 read_timeout_s: float = 60.0) -> dict:
    """One mixed window on a running live fleet behind ``ctl``: the
    writer admits ``write_batches`` churn batches of ``batch_rows`` rows
    (drawn with ``rng`` against the controller's journal), while
    ``reader_threads`` closed-loop readers submit SSSP queries over
    ``sources``; ``rmw_frac`` of the reads carry a ``min_generation``
    bound at the last acknowledged write's generation (the
    read-your-writes path measured under load).  Returns the tallies:
    write and read rates, staleness and latency percentiles, the bounded
    reads and how many came back tagged below their bound, and each
    admit's seconds and acknowledging workers."""
    stop = threading.Event()
    reads_ok = [0] * reader_threads
    read_errors = [0] * reader_threads
    bounded = [0] * reader_threads
    below = [0] * reader_threads
    staleness: List[List[int]] = [[] for _ in range(reader_threads)]
    lat_ms: List[List[float]] = [[] for _ in range(reader_threads)]
    #: last generation admit_writes RETURNED (journaled + replica-acked)
    #: — the bound a read-your-writes client actually holds.  Bounding
    #: on ctl.generation() would race the replication window: the
    #: journal advances at admit, replicas ack later, and a bounded
    #: read in between is a spurious StaleReadError.
    acked_gen = [0]
    every = max(int(round(1 / max(rmw_frac, 1e-9))), 1)

    def reader(slot: int) -> None:
        k = slot
        while not stop.is_set():
            g_sub = ctl.generation()
            bound = acked_gen[0] if k % every == 0 else None
            try:
                f = ctl.submit(int(sources[k % len(sources)]),
                               min_generation=bound)
                f.result(timeout=read_timeout_s)
            except FleetError:
                read_errors[slot] += 1
                k += 1
                continue
            reads_ok[slot] += 1
            if bound is not None:
                bounded[slot] += 1
                if f.generation is None or f.generation < bound:
                    below[slot] += 1
            if f.generation is not None:
                staleness[slot].append(max(g_sub - f.generation, 0))
            if f.latency_s is not None:
                lat_ms[slot].append(f.latency_s * 1e3)
            k += 1

    threads = [threading.Thread(target=reader, args=(i,),
                                name=f"lux-live-bench-read-{i}",
                                daemon=True)
               for i in range(reader_threads)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    compactions = 0
    write_s_each: List[float] = []
    acks: List[List[str]] = []
    try:
        for _ in range(write_batches):
            src, dst, op = churn_batch(ctl.journal.log, rng, batch_rows)
            tw = time.perf_counter()
            rep = ctl.admit_writes(src, dst, op)
            write_s_each.append(time.perf_counter() - tw)
            acks.append(list(rep["acked"]))
            acked_gen[0] = rep["generation"]
            compactions += int(rep["compacted"])
        write_s = time.perf_counter() - t0
        # writes can outpace the readers on a small graph; keep the read
        # side of the mixed window open long enough that its QPS and
        # staleness percentiles mean something
        while time.perf_counter() - t0 < min_window_s:
            time.sleep(0.02)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=max(read_timeout_s, 1.0) * 2)
    read_s = time.perf_counter() - t0
    stale = sorted(x for s in staleness for x in s)
    lats = sorted(x for s in lat_ms for x in s)
    ok = sum(reads_ok)
    return {
        "read_qps": ok / max(read_s, 1e-9),
        "reads": ok,
        "read_errors": sum(read_errors),
        "bounded_reads": sum(bounded),
        "bounded_below_bound": sum(below),
        "read_p50_ms": _pct(lats, 50),
        "read_p99_ms": _pct(lats, 99),
        "staleness_gen_p50": _pct(stale, 50),
        "staleness_gen_p99": _pct(stale, 99),
        "write_batches_per_s": write_batches / max(write_s, 1e-9),
        "write_rows_per_s": write_batches * batch_rows / max(write_s, 1e-9),
        "write_s_each": write_s_each,
        "acks": acks,
        "write_seconds": write_s,
        "window_seconds": read_s,
        "compactions": compactions,
        "final_acked_generation": acked_gen[0],
    }


def measure_live_mixed(scale: int = 12, ef: int = 8, workers: int = 2,
                       parts: int = 2, batch_rows: int = 64,
                       write_batches: int = 20,
                       reader_threads: int = 2,
                       cap: Optional[int] = None, seed: int = 0,
                       buckets: Sequence[int] = (1, 8),
                       rmw_frac: float = 0.25,
                       min_window_s: float = 2.0,
                       device="cuda") -> dict:
    """One mixed window on a fresh thread-mode live fleet on ``device``;
    returns the bench row plus the raw tallies."""
    from lux_tpu_torch import obs
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.obs.slo import default_fleet_slos
    from lux_tpu_torch.serve.benchmarks import pick_sources

    g = generate.rmat(scale, ef, seed=seed)
    # capacity sized to the window's own churn: all inserts could land
    # in one part on a skewed draw
    need = (batch_rows * write_batches) // 2 + batch_rows
    cap = cap if cap is not None else max(1024, need)
    snap = os.path.join(tempfile.gettempdir(),
                        f"lux_live_bench_{os.getpid()}.lux")
    sources = pick_sources(g, 64, seed=seed)
    rng = np.random.default_rng(seed)
    # standing pagerank rides the replicas' gather route (fused-pf by
    # default), so the refresh leg measures the shipped serving config
    fleet = start_live_fleet(
        workers, g, parts=parts, cap=cap, buckets=buckets,
        snapshot_path=snap, graph_id=f"rmat{scale}",
        standing=(("sssp", 0), ("pagerank", None)), device=device)
    ctl = fleet.controller
    # the standing serving SLOs, scored over this window's own reads +
    # writes: the row records a verdict per objective
    ctl.set_slos(default_fleet_slos())
    try:
        with obs.span("live.bench.mixed", workers=workers,
                      batches=write_batches, rows=batch_rows):
            win = mixed_window(ctl, sources, rng, batch_rows=batch_rows,
                               write_batches=write_batches,
                               reader_threads=reader_threads,
                               rmw_frac=rmw_frac, min_window_s=min_window_s)
            with obs.span("live.bench.refresh"):
                refresh = ctl.refresh_fleet()
            gens = ctl.worker_generations()
            ctl_stats = ctl.stats()
            slo_rows = ctl.slo_status()
    finally:
        fleet.close()
        try:
            os.unlink(snap)
        except OSError:
            pass
    platform = "cuda" if str(device).split(":")[0] == "cuda" else "cpu"
    return {
        "metric": f"sssp_live_w{workers}_rmat{scale}_{platform}",
        "value": round(win["read_qps"], 2),
        "unit": "QPS",
        "write_batches_per_s": round(win["write_batches_per_s"], 2),
        "write_rows_per_s": round(win["write_rows_per_s"], 1),
        "reads": win["reads"],
        "read_errors": win["read_errors"],
        "bounded_reads": win["bounded_reads"],
        "bounded_below_bound": win["bounded_below_bound"],
        "read_p50_ms": round(win["read_p50_ms"], 2),
        "read_p99_ms": round(win["read_p99_ms"], 2),
        "staleness_gen_p50": win["staleness_gen_p50"],
        "staleness_gen_p99": win["staleness_gen_p99"],
        "fleet_refresh_s": refresh["seconds"],
        "route_family": os.environ.get("LUX_LIVE_ROUTE", "fused-pf"),
        "final_generation": max(gens.values()) if gens else 0,
        "worker_generations": gens,
        "compactions": win["compactions"],
        "workers": workers,
        "batch_rows": batch_rows,
        "app": "sssp",
        "platform": platform,
        "nv": int(g.nv),
        "ne": int(g.ne),
        "controller": ctl_stats,
        "slo": slo_rows,
    }
