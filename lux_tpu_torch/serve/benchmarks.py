"""Serving measurement core.

Counterpart of ``lux_tpu.serve.benchmarks`` (the reference's
``sssp_qps_*`` bench row and tools/serve_bench.py measure through it).
Throughput contract: warm Q-batched QPS against warm Q=1 SEQUENTIAL QPS
on the same graph, both through warmed engines, so the ratio isolates
batching, not first launches.  Latency percentiles come from a burst
pushed through the real scheduler path (queue wait + batch service), not
from engine time alone.  Every timed window is fenced on the device
(``torch.cuda.synchronize()`` at both ends).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from lux_tpu_torch.serve.metrics import ServeMetrics
from lux_tpu_torch.serve.scheduler import MicroBatchScheduler
from lux_tpu_torch.serve.warm import WarmEngineCache
from lux_tpu_torch.utils.roofline import serve_summarize


def pick_sources(g, n: int, seed: int = 0) -> np.ndarray:
    """Exactly n query vertices with out-edges (a zero-out-degree source
    converges at once and measures nothing).  Distinct while the graph
    has enough eligible vertices, repeats otherwise: callers rely on
    getting n back.  The same numpy draw as the reference's."""
    deg = np.bincount(g.col_idx, minlength=g.nv)
    cand = np.flatnonzero(deg > 0)
    if not len(cand):
        raise ValueError("graph has no vertex with out-edges to query")
    rng = np.random.default_rng(seed)
    return rng.choice(cand, size=n, replace=len(cand) < n).astype(np.int32)


def _fence(device: torch.device) -> float:
    """Wait for the card, then read the clock."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def measure_serving(g, shards, app: str = "sssp", q: int = 64,
                    num_seq: int = 8, batched_reps: int = 2,
                    method: str = "auto", seed: int = 0,
                    max_wait_ms: float = 2.0, device="cuda") -> dict:
    """Measure the serving path on ``shards`` (a PullShards bundle of
    ``g``) on ``device``; returns a JSON-ready dict.  Steps:

      1. warm Q=1 and Q=``q`` engines (wall cost reported separately);
      2. warm Q=1 sequential baseline over ``num_seq`` queries;
      3. warm Q=``q`` batched throughput over ``batched_reps`` full
         batches (distinct sources per batch);
      4. a ``q``-request burst through the MicroBatchScheduler for
         end-to-end latency percentiles and occupancy.
    """
    cache = WarmEngineCache(shards, apps=(app,), q_buckets=(1, q), method=method,
                            device=device)
    dev = cache.device
    warm_s = cache.prewarm()

    sources = pick_sources(g, max(num_seq, q * batched_reps, q), seed=seed)

    # --- warm Q=1 sequential baseline ---
    eng1, _ = cache.get(app, 1)
    t0 = _fence(dev)
    for s in sources[:num_seq]:
        eng1.run([int(s)])
    seq_elapsed = _fence(dev) - t0
    qps_seq = num_seq / seq_elapsed

    # --- warm Q=q batched throughput ---
    engq, _ = cache.get(app, q)
    batch_times = []
    traversed_total = 0
    iters_seen = []
    t0 = _fence(dev)
    for rep in range(batched_reps):
        batch = np.resize(sources[rep * q:(rep + 1) * q], q)
        tb = time.perf_counter()
        out = engq.run(batch)
        batch_times.append(_fence(dev) - tb)
        traversed_total += sum(out.traversed)
        iters_seen.append(out.iters)
    bat_elapsed = _fence(dev) - t0
    qps_batched = (q * batched_reps) / bat_elapsed

    # --- scheduler burst: end-to-end latency through the real path ---
    metrics = ServeMetrics()
    sched = MicroBatchScheduler(cache, app=app, max_wait_ms=max_wait_ms,
                                max_queue=4 * q, metrics=metrics)
    futs = [sched.submit(int(s)) for s in sources[:q]]
    t0 = _fence(dev)
    sched.drain()
    burst_elapsed = _fence(dev) - t0
    for f in futs:
        f.result(timeout=0)  # already resolved; raises on any error
    summary = metrics.summary(elapsed_s=burst_elapsed, cache_stats=cache.stats())

    out = {
        "app": app,
        "q": q,
        "method": engq.method,
        "platform": dev.type,
        "qps_batched": round(qps_batched, 3),
        "qps_q1_sequential": round(qps_seq, 3),
        "batched_vs_q1": round(qps_batched / qps_seq, 2),
        "batch_ms": round(float(np.mean(batch_times)) * 1e3, 1),
        "iters": iters_seen[0] if iters_seen else 0,
        "warm_trace_s": round(warm_s, 1),
        # end-to-end request latency through the scheduler path, at the top
        # level so artifact parsers need not dig
        "latency_ms": summary.get("latency_ms", {}),
        "scheduler": summary,
    }
    out.update(serve_summarize(q * batched_reps, bat_elapsed, traversed_total))
    return out
