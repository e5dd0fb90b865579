"""lux_tpu_torch.serve.fleet — the multi-replica serving fleet and pods.

Counterpart of ``lux_tpu.serve.fleet``: the controller/worker split on
top of ``lux_tpu_torch.serve``, with each replica worker a CUDA process
of its own on the card.

* ``fleet.hashring``   — deterministic consistent-hash routing of
  (app, graph_id, Q-slot) keys with bounded key movement on join/leave.
* ``fleet.wire``       — length-prefixed JSON + npy frames over loopback
  TCP (stdlib; no pickle), byte-compatible with the reference's.
* ``fleet.stream``     — snapshots streamed over the wire in chunks.
* ``fleet.worker``     — the replica: a ``WarmEngineCache`` + per-app
  ``MicroBatchScheduler`` behind a socket, with prepare/commit
  zero-downtime republish and a ``kill()`` fault drill.
* ``fleet.controller`` — admission, routing, heartbeat-driven
  backpressure/shedding, death recovery, and the republish barrier.
* ``fleet.pod``        — worker processes that together hold ONE sharded
  graph and run the pull engine's per-part step over the wire.
* ``fleet.launcher``   — ``python -m`` worker and pod processes.
* ``fleet.bench``      — the saturation harness of
  ``lux_tpu_torch/tools/fleet_bench.py``: ramp offered QPS to the
  throughput knee, record QPS + p99 at the knee per fleet width.

Exports resolve LAZILY (PEP 562): importing the package imports neither
torch nor any engine.
"""
_EXPORTS = {
    "FleetController": "lux_tpu_torch.serve.fleet.controller",
    "FleetError": "lux_tpu_torch.serve.fleet.controller",
    "FleetFuture": "lux_tpu_torch.serve.fleet.controller",
    "FleetRejectedError": "lux_tpu_torch.serve.fleet.controller",
    "FleetTimeoutError": "lux_tpu_torch.serve.fleet.controller",
    "NoWorkersError": "lux_tpu_torch.serve.fleet.controller",
    "StaleReadError": "lux_tpu_torch.serve.fleet.controller",
    "WorkerRefusedError": "lux_tpu_torch.serve.fleet.controller",
    "HashRing": "lux_tpu_torch.serve.fleet.hashring",
    "route_key": "lux_tpu_torch.serve.fleet.hashring",
    "StreamSink": "lux_tpu_torch.serve.fleet.stream",
    "StreamTable": "lux_tpu_torch.serve.fleet.stream",
    "negotiate_chunk_bytes": "lux_tpu_torch.serve.fleet.stream",
    "stream_file": "lux_tpu_torch.serve.fleet.stream",
    "PodError": "lux_tpu_torch.serve.fleet.pod",
    "PodWorker": "lux_tpu_torch.serve.fleet.pod",
    "pod_connect": "lux_tpu_torch.serve.fleet.pod",
    "run_pull_pod": "lux_tpu_torch.serve.fleet.pod",
    "LaunchError": "lux_tpu_torch.serve.fleet.launcher",
    "ProcHandle": "lux_tpu_torch.serve.fleet.launcher",
    "launch": "lux_tpu_torch.serve.fleet.launcher",
    "launch_fleet_worker": "lux_tpu_torch.serve.fleet.launcher",
    "launch_pod_worker": "lux_tpu_torch.serve.fleet.launcher",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
