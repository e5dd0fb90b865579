"""--serve CLI driver shared by the SSSP and PageRank apps.

Counterpart of ``lux_tpu.serve.driver``.  Runs the whole serving path in
one process on one device: build the pull layout, print the memory
estimate, warm the configured Q buckets, push the query burst through
the micro-batching scheduler, and print the metrics summary as one JSON
line ``{"metric": "<app>_serve", ...}`` (the reference's keys but
``run_id``, which comes with ``obs``).  ``LUX_SERVE_PROM=<path>`` also
writes the Prometheus text of the run there.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from lux_tpu_torch.serve.benchmarks import pick_sources
from lux_tpu_torch.serve.metrics import ServeMetrics
from lux_tpu_torch.serve.scheduler import MicroBatchScheduler, RejectedError
from lux_tpu_torch.serve.warm import WarmEngineCache
from lux_tpu_torch.utils.config import RunConfig


@dataclasses.dataclass
class ServeRunResult:
    rc: int  # 0, or 1 when -check failed
    summary: dict  # the JSON line's fields after "metric"
    sources: np.ndarray  # (n,) int32 query vertices, in submit order
    answers: List[Optional[np.ndarray]]  # (nv,) per query; None = failed
    estimate_bytes: int  # the memory estimate printed before set-up
    peak_bytes: Optional[int]  # max_memory_allocated on the card (None off it)
    method: str  # the resolved segment-reduction method


def _validate(cfg: RunConfig) -> None:
    """The reference's refusals: --serve is the single-process batched
    service (allgather pull layout, unweighted programs).  The flags of
    the distributed and layout features it also refuses never reach
    here: parse_args rejects them as not ported."""
    bad = []
    if cfg.method == "pallas":
        bad.append("--method pallas")
    if cfg.route_gather:
        bad.append("--route-gather")
    if cfg.ckpt_every or cfg.ckpt_dir:
        bad.append("checkpointing")
    if cfg.repartition_every:
        bad.append("--repartition-every")
    if cfg.verbose:
        bad.append("--verbose")
    if cfg.stream_hbm_gib:
        bad.append("--stream-hbm-gib")
    if cfg.weighted or cfg.delta:
        bad.append("--weighted/--delta")
    if bad:
        raise SystemExit(
            "--serve is the single-process batched query service "
            "(allgather pull layout, unweighted programs); it does not "
            "combine with: " + ", ".join(bad))


def parse_buckets(spec: str) -> tuple:
    try:
        qs = tuple(sorted({int(x) for x in spec.split(",") if x.strip()}))
    except ValueError:
        raise SystemExit(f"--serve-buckets: bad bucket list {spec!r}")
    if not qs or qs[0] < 1:
        raise SystemExit(f"--serve-buckets: buckets must be >= 1: {spec!r}")
    return qs


def parse_sources(cfg: RunConfig, g) -> np.ndarray:
    if cfg.serve_sources:
        try:
            src = np.asarray(
                [int(x) for x in cfg.serve_sources.split(",") if x.strip()], np.int32)
        except ValueError:
            raise SystemExit(f"--serve-sources: bad vertex list {cfg.serve_sources!r}")
        if src.size == 0 or src.min() < 0 or src.max() >= g.nv:
            raise SystemExit(f"--serve-sources: vertices must be in [0, {g.nv})")
        return src
    if cfg.serve_queries < 1:
        raise SystemExit("--serve-queries must be >= 1")
    return pick_sources(g, cfg.serve_queries, seed=cfg.seed)


def _check_answers(app: str, g, cfg: RunConfig, sources, answers) -> int:
    """-check: every SSSP answer against the triangle inequality and a 0
    at its own source; the first four PPR answers against the float64
    oracle.  Returns the violation count."""
    bad = 0
    if app == "sssp":
        from lux_tpu_torch.models import sssp as sssp_model

        for i in range(len(sources)):
            bad += sssp_model.check_distances(g, answers[i])
            # bind the answer to ITS request: the triangle inequality holds
            # for any source's distance field (even all-INF), so a row
            # mismapped across requests would otherwise pass
            if answers[i][int(sources[i])] != 0:
                bad += 1
    else:
        from lux_tpu_torch.models.pagerank import ppr_reference

        for i in range(min(len(sources), 4)):
            want = ppr_reference(g, int(sources[i]), cfg.num_iters)
            scale = max(float(np.abs(want).mean()), 1e-30)
            tol = 1e-3 * np.maximum(np.abs(want), scale)
            bad += int(np.sum(np.abs(answers[i] - want) > tol))
    return bad


def run_serve_cli(cfg: RunConfig, g, app: str, route=None) -> ServeRunResult:
    """The --serve entry of the apps: serve cfg.serve_queries random
    vertices (or --serve-sources) of ``g`` (None: the graph the flags
    name) through warm engines on cfg.device and print the JSON metrics
    line; returns the answers beside the exit code (``rc``)."""
    from lux_tpu_torch.apps import common
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.serve.batched import resolve_method
    from lux_tpu_torch.utils import preflight
    from lux_tpu_torch.utils.device import resolve_device
    from lux_tpu_torch.utils.timing import Timer

    _validate(cfg)
    if app == "ppr" and cfg.dtype != "float32":
        raise SystemExit("--serve runs the float32 batched engines")
    if route is not None:
        raise ValueError("--serve runs the direct gather; it takes no routed plan")
    dev = resolve_device(cfg.device)
    if g is None:
        g = common.load_graph(cfg)
    buckets = parse_buckets(cfg.serve_buckets)
    sources = parse_sources(cfg, g)
    shards = build_pull_shards(g, cfg.num_parts)
    method = resolve_method(cfg.method, app, g.nv, dev)
    # the widest bucket's state and per-edge gather, every part resident
    est = preflight.scale_residency(
        preflight.estimate_pull(shards.spec, max(buckets), method=method),
        shards.spec.num_parts)
    common.report_preflight(est, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    metrics = ServeMetrics()
    cache = WarmEngineCache(
        shards, apps=(app,), q_buckets=buckets, method=cfg.method,
        num_iters=cfg.num_iters, max_iters=cfg.max_iters, metrics=metrics,
        device=dev)
    warm_s = cache.prewarm()
    print(f"warmed {len(buckets)} {app} bucket(s) {buckets} in {warm_s:.1f} s")
    sched = MicroBatchScheduler(
        cache, app=app, max_wait_ms=cfg.serve_wait_ms,
        max_queue=cfg.serve_max_queue,
        default_timeout_ms=cfg.serve_timeout_ms, metrics=metrics)
    timer = Timer(dev)
    futs = []
    for s in sources:
        while True:
            try:
                futs.append(sched.submit(int(s)))
                break
            except RejectedError:
                # burst larger than the admission bound: pump until the
                # queue drains a batch, then retry (a client's backpressure
                # loop)
                if not sched.step():
                    time.sleep(max(cfg.serve_wait_ms / 4e3, 1e-4))
    sched.drain()
    answers, failed = [], 0
    for f in futs:
        try:
            answers.append(f.result(timeout=0))
        except Exception:  # noqa: BLE001 - timeout / engine error rows
            answers.append(None)
            failed += 1
    elapsed = timer.stop()
    cache_stats = cache.stats()
    summary = metrics.summary(elapsed_s=elapsed, cache_stats=cache_stats)
    print(json.dumps({"metric": f"{app}_serve", **summary}), flush=True)
    peak = None
    if dev.type == "cuda":
        peak = int(torch.cuda.max_memory_allocated(dev))
        print(f"peak device memory: {peak / (1 << 30):.3f} GiB "
              f"(estimate {est.total_bytes / (1 << 30):.3f} GiB)")
    prom_path = os.environ.get("LUX_SERVE_PROM")
    if prom_path:
        # a one-shot scrape artifact; a bad path must not fail a run that
        # already answered its queries
        try:
            with open(prom_path, "w", encoding="utf-8") as fh:
                fh.write(metrics.dump(elapsed_s=elapsed, cache_stats=cache_stats,
                                      exemplars=False))
            print(f"# prometheus metrics -> {prom_path}", flush=True)
        except OSError as e:
            print(f"# prometheus metrics NOT written ({prom_path}): {e}",
                  file=sys.stderr, flush=True)
    rc = 0
    if cfg.check:
        ok_rows = [(s, a) for s, a in zip(sources, answers) if a is not None]
        violations = _check_answers(app, g, cfg, [s for s, _ in ok_rows],
                                    [a for _, a in ok_rows]) + failed
        rc = 0 if common.print_check(f"{app} serve", violations) else 1
    return ServeRunResult(rc, summary, sources, answers, est.total_bytes, peak,
                          method)
