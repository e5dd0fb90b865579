"""Serving metrics: the request-side observability surface.

Counterpart of ``lux_tpu.serve.metrics``.  Collected by the scheduler per
request and batch and summarized through utils/timing.percentiles and
utils/roofline.serve_summarize, so a serving run emits one JSON line the
way an engine run emits its GTEPS.

Memory is bounded for a long-lived service: histograms reservoir-sample
past their cap (utils/timing.LatencyHistogram), batch records keep a
recent window plus running aggregates, and queue depth keeps only its
running max.

The flight-recorder snapshot (``emit_snapshot``) and the per-bucket
trace-id exemplars read the reference's ``obs`` package, which is not
ported: both are no-ops here (``exemplars()`` is always empty).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time

from lux_tpu_torch.utils.roofline import serve_summarize
from lux_tpu_torch.utils.timing import LatencyHistogram


@dataclasses.dataclass
class BatchRecord:
    q: int  # dispatched bucket size (incl. padding)
    real: int  # real (non-padding) queries
    warm: bool  # engine came from the warm cache
    service_s: float  # engine wall time for the batch


class ServeMetrics:
    """Thread-safe counters for one service lifetime."""

    #: recent BatchRecords kept for inspection; aggregates are unbounded
    RECENT_BATCHES = 1024

    #: Prometheus histogram boundaries (seconds) for request latency and
    #: queue wait
    BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self):
        self._lock = threading.Lock()
        self.latency = LatencyHistogram()  # enqueue -> result, per request
        self.queue_wait = LatencyHistogram()  # enqueue -> dispatch
        self.batches = collections.deque(maxlen=self.RECENT_BATCHES)
        self._batch_count = 0
        self._batch_slots = 0
        self._batch_real = 0
        self._batch_warm = 0
        self.completed = 0
        self.timeouts = 0
        self.rejected = 0
        self.evictions = 0  # warm-cache engines dropped by the LRU bound
        self.retries = 0  # re-dispatched requests served
        self.stale_reads = 0  # bounded-staleness degraded reads served
        self.traversed_edges = 0
        self._depth_max = 0
        self._depth_n = 0
        #: service birth on the monotonic clock: scrape()'s qps denominator
        self._t_start = time.monotonic()

    def record_batch(self, q: int, real: int, warm: bool, service_s: float):
        with self._lock:
            self.batches.append(BatchRecord(q, real, warm, service_s))
            self._batch_count += 1
            self._batch_slots += q
            self._batch_real += real
            self._batch_warm += int(warm)

    def record_done(self, latency_s: float, wait_s: float, traversed: int,
                    trace: str | None = None):
        """One answered request.  ``trace`` (a distributed-trace id) is
        accepted and not recorded: exemplars come with ``obs``."""
        with self._lock:
            self.completed += 1
            self.latency.record(latency_s)
            self.queue_wait.record(wait_s)
            self.traversed_edges += int(traversed)

    def record_timeout(self):
        with self._lock:
            self.timeouts += 1

    def record_rejected(self):
        with self._lock:
            self.rejected += 1

    def record_eviction(self):
        with self._lock:
            self.evictions += 1

    def record_retry(self):
        with self._lock:
            self.retries += 1

    def record_stale_read(self):
        with self._lock:
            self.stale_reads += 1

    def counters(self) -> dict:
        """Point-in-time copy of the monotonic counters."""
        with self._lock:
            return {
                "completed": self.completed,
                "timeouts": self.timeouts,
                "rejected": self.rejected,
                "evictions": self.evictions,
                "retries": self.retries,
                "stale_reads": self.stale_reads,
                "batches": self._batch_count,
                "traversed_edges": self.traversed_edges,
            }

    def sample_queue_depth(self, depth: int):
        with self._lock:
            self._depth_n += 1
            self._depth_max = max(self._depth_max, int(depth))

    def summary(self, elapsed_s: float | None = None,
                cache_stats: dict | None = None) -> dict:
        """JSON-ready summary; ``elapsed_s`` (service wall time) adds the
        QPS and aggregate-GTEPS fields."""
        with self._lock:
            out = {
                "completed": self.completed,
                "timeouts": self.timeouts,
                "rejected": self.rejected,
                "evictions": self.evictions,
                "retries": self.retries,
                "stale_reads": self.stale_reads,
                "latency_ms": self.latency.summary_ms(),
                "queue_wait_ms": self.queue_wait.summary_ms(),
                "batches": self._batch_count,
            }
            if self._depth_n:
                out["queue_depth_max"] = self._depth_max
            if self._batch_count:
                out["batch_occupancy"] = round(
                    self._batch_real / max(self._batch_slots, 1), 4)
                out["warm_batch_ratio"] = round(
                    self._batch_warm / self._batch_count, 4)
            completed = self.completed
            traversed = self.traversed_edges
            lat = list(self.latency.samples)
        if elapsed_s is not None:
            out.update(serve_summarize(completed, elapsed_s, traversed,
                                       latencies_s=lat))
        if cache_stats:
            out["engine_cache"] = cache_stats
        return out

    def _histogram_lines(self, name: str, hist, help_text: str,
                         lab: str = "") -> list:
        """Prometheus text-format histogram of a LatencyHistogram.  Past
        the reservoir cap the recorder holds a uniform sample of the
        stream, so bucket counts are scaled to the true request count
        while ``_count`` stays exact.  ``lab`` is a pre-rendered label
        pair (``replica="w0",``) merged ahead of ``le``."""
        samples = list(hist.samples)
        count = len(hist)
        lines = [f"# HELP {name} {help_text}", f"# TYPE {name} histogram"]
        bare = f"{{{lab[:-1]}}}" if lab else ""  # label set without le
        scale = (count / len(samples)) if samples else 0.0
        for le in self.BUCKETS_S:
            cum = sum(1 for s in samples if s <= le)
            lines.append(f'{name}_bucket{{{lab}le="{le}"}} {int(round(cum * scale))}')
        lines.append(f'{name}_bucket{{{lab}le="+Inf"}} {count}')
        lines.append(f"{name}_sum{bare} {round(sum(samples) * scale, 6)}")
        lines.append(f"{name}_count{bare} {count}")
        return lines

    def dump(self, elapsed_s: float | None = None,
             cache_stats: dict | None = None, replica: str = "",
             exemplars: bool = True) -> str:
        """Prometheus text exposition of the counter, gauge and histogram
        set; safe from any thread.  ``replica`` labels every series with
        a worker id.  ``exemplars`` is accepted for the reference's
        signature; there are none to append (they come with ``obs``), so
        the output is always classic 0.0.4 text."""
        lab = f'replica="{replica}",' if replica else ""
        sfx = f"{{{lab[:-1]}}}" if lab else ""
        with self._lock:
            lines = []

            def counter(name, val, help_text):
                lines.extend([f"# HELP {name} {help_text}",
                              f"# TYPE {name} counter", f"{name}{sfx} {val}"])

            def gauge(name, val, help_text):
                lines.extend([f"# HELP {name} {help_text}",
                              f"# TYPE {name} gauge", f"{name}{sfx} {val}"])

            counter("lux_serve_requests_completed_total", self.completed,
                    "requests answered")
            counter("lux_serve_requests_timeout_total", self.timeouts,
                    "requests whose deadline expired in queue")
            counter("lux_serve_requests_shed_total", self.rejected,
                    "requests rejected by bounded-queue backpressure")
            counter("lux_serve_batches_total", self._batch_count,
                    "engine batches dispatched")
            counter("lux_serve_engine_evictions_total", self.evictions,
                    "warm-cache engines dropped by the LRU bound")
            counter("lux_serve_retries_total", self.retries,
                    "re-dispatched or envelope-retried requests served")
            counter("lux_serve_stale_reads_total", self.stale_reads,
                    "bounded-staleness degraded reads served")
            counter("lux_serve_traversed_edges_total", self.traversed_edges,
                    "edges traversed across all answered queries")
            if self._depth_n:
                gauge("lux_serve_queue_depth_max", self._depth_max,
                      "maximum observed queue depth")
            if self._batch_count:
                gauge("lux_serve_batch_occupancy",
                      round(self._batch_real / max(self._batch_slots, 1), 4),
                      "real queries / dispatched slots")
                gauge("lux_serve_warm_batch_ratio",
                      round(self._batch_warm / self._batch_count, 4),
                      "batches served by a warm engine")
            lines.extend(self._histogram_lines(
                "lux_serve_request_latency_seconds", self.latency,
                "enqueue-to-result latency", lab=lab))
            lines.extend(self._histogram_lines(
                "lux_serve_queue_wait_seconds", self.queue_wait,
                "enqueue-to-dispatch wait", lab=lab))
            completed = self.completed
        if elapsed_s is not None and elapsed_s > 0:
            lines.extend([
                "# HELP lux_serve_qps completed requests per second",
                "# TYPE lux_serve_qps gauge",
                f"lux_serve_qps{sfx} {round(completed / elapsed_s, 4)}"])
        if cache_stats and (cache_stats.get("warm_hits")
                            or cache_stats.get("cold_traces")):
            ratio = cache_stats.get("warm_hit_ratio")
            if ratio is None:  # a foreign stats dict
                hits = int(cache_stats.get("warm_hits", 0))
                cold = int(cache_stats.get("cold_traces", 0))
                ratio = round(hits / max(hits + cold, 1), 4)
            lines.extend([
                "# HELP lux_serve_warm_hit_ratio warm engine-cache hits / lookups",
                "# TYPE lux_serve_warm_hit_ratio gauge",
                f"lux_serve_warm_hit_ratio{sfx} {ratio}"])
        return "\n".join(lines) + "\n"

    def exemplars(self) -> dict:
        """The per-bucket latency exemplars: none until ``obs`` is ported."""
        return {}

    def scrape(self, queue_depth: int | None = None,
               cache_stats: dict | None = None, replica: str = "",
               extra_gauges=()) -> str:
        """``dump`` plus the in-flight state a collector needs between
        snapshots: ``lux_serve_qps`` over the service's own lifetime
        clock (always present), the caller's live ``queue_depth`` as a
        gauge, and ``extra_gauges`` rows of (name, value, help)."""
        elapsed = max(time.monotonic() - self._t_start, 1e-9)
        text = self.dump(elapsed_s=elapsed, cache_stats=cache_stats,
                         replica=replica)
        lab = f'{{replica="{replica}"}}' if replica else ""
        lines = []
        if queue_depth is not None:
            lines.extend([
                "# HELP lux_serve_queue_depth current queued requests",
                "# TYPE lux_serve_queue_depth gauge",
                f"lux_serve_queue_depth{lab} {int(queue_depth)}"])
        for name, val, help_text in extra_gauges:
            lines.extend([f"# HELP {name} {help_text}",
                          f"# TYPE {name} gauge", f"{name}{lab} {val}"])
        return text + ("\n".join(lines) + "\n" if lines else "")

    def emit_snapshot(self, rec=None, elapsed_s: float | None = None,
                      cache_stats: dict | None = None,
                      summary: dict | None = None) -> None:
        """The flight-recorder snapshot point: a no-op until ``obs`` (the
        event log it writes to) is ported."""
