"""Serving summary fields.

Of ``lux_tpu.utils.roofline`` only ``serve_summarize`` is here; the
traffic models come with the benchmark.
"""
from __future__ import annotations

from lux_tpu_torch.utils.timing import percentiles


def serve_summarize(num_queries: int, elapsed_s: float,
                    traversed_edges: int, latencies_s=None) -> dict:
    """JSON-ready serving fields where the unit of work is a REQUEST:
    queries a second, aggregate traversed-edge GTEPS, and latency
    percentiles (ms).  Batch occupancy lives with the batch records
    (serve/metrics.ServeMetrics.summary)."""
    out = {
        "qps": round(num_queries / elapsed_s, 3) if elapsed_s > 0 else 0.0,
        "queries": int(num_queries),
        "gteps_aggregate": round(traversed_edges / elapsed_s / 1e9, 4)
        if elapsed_s > 0 else 0.0,
        "traversed_edges": int(traversed_edges),
    }
    if latencies_s:
        out["latency_ms"] = {k: round(v * 1e3, 3)
                             for k, v in percentiles(latencies_s).items()}
    return out
