"""lux_tpu_torch.serve — batched multi-source query serving on one device.

Counterpart of ``lux_tpu.serve`` (the fleet and pods are ``serve.fleet``,
mutation-aware serving ``serve.live``, the autopilot ``serve.autopilot``):

  * ``serve.batched``    — multi-source engines: one iteration answers Q
    SSSP sources or Q personalized-PageRank seeds (a trailing query axis
    over shared graph shards).
  * ``serve.warm``       — engine cache keyed on (app, method, layout, Q
    bucket), warmed at service start.
  * ``serve.scheduler``  — dynamic micro-batching admission queue:
    coalesce, pad, deadline, backpressure, cold-shape degradation.
  * ``serve.metrics``    — per-query latency percentiles, batch
    occupancy, queue depth, warm-vs-cold hit ratio.
  * ``serve.benchmarks`` — the QPS measurement core.
  * ``serve.driver``     — the ``--serve`` flag of the SSSP and PageRank
    apps.

The unit of work here is a REQUEST, not a graph.  Exports resolve lazily
(PEP 562), as in the reference.
"""
_EXPORTS = {
    "BatchedEngine": "lux_tpu_torch.serve.batched",
    "BatchedResult": "lux_tpu_torch.serve.batched",
    "MultiSourcePPR": "lux_tpu_torch.serve.batched",
    "MultiSourceSSSP": "lux_tpu_torch.serve.batched",
    "MicroBatchScheduler": "lux_tpu_torch.serve.scheduler",
    "RejectedError": "lux_tpu_torch.serve.scheduler",
    "ServeTimeoutError": "lux_tpu_torch.serve.scheduler",
    "EngineKey": "lux_tpu_torch.serve.warm",
    "WarmEngineCache": "lux_tpu_torch.serve.warm",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
