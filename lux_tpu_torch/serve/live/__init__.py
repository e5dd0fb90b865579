"""lux_tpu_torch.serve.live — mutation-aware serving: the write path
through the fleet.

Counterpart of ``lux_tpu.serve.live``.  The controller ADMITS edge
insert/delete batches, sequences them into an authoritative crash-safe
journal (mutate/deltalog.py's npz+``.ok`` format) with monotonic
GENERATION numbers, and replicates each committed batch to every
replica, where workers install statically-shaped overlays into the
serving engines (no snapshot swap) and run the warm refresh between
queries.  Query answers carry generation tags; admission takes a
``min_generation`` bound — read-your-writes.  ``DeltaOverflow`` anywhere
escalates to a fleet-wide compaction through the token-guarded two-phase
republish; a joining/recovering worker catches up by snapshot + journal
replay.

Pieces:

* ``journal.py``   — LiveJournal: the controller's sequencer (the ONE
  write order) + batch wire packing + the compaction epoch.
* ``replica.py``   — LiveReplica: worker-side delta log, serving
  overlays, standing-state warm refresh on the worker's device.
* ``controller.py``— LiveFleetController: admit/replicate/refresh/
  compact + generation-aware routing and worker catch-up.
* ``bench.py``     — the mixed read/write measurement.
* ``errors.py``    — the protocol-surface exceptions/reason constants
  (``GenerationGap``, the ``add_worker`` refusal reasons), stdlib only.

Exports resolve LAZILY (PEP 562): importing the package loads no engine.
"""
_EXPORTS = {
    "LiveFleetController": "lux_tpu_torch.serve.live.controller",
    "promote_live_controller": "lux_tpu_torch.serve.live.controller",
    "start_live_fleet": "lux_tpu_torch.serve.live.controller",
    "LiveJournal": "lux_tpu_torch.serve.live.journal",
    "GenerationGap": "lux_tpu_torch.serve.live.errors",
    "LiveReplica": "lux_tpu_torch.serve.live.replica",
    "parse_standing": "lux_tpu_torch.serve.live.replica",
    "churn_batch": "lux_tpu_torch.serve.live.bench",
    "measure_live_mixed": "lux_tpu_torch.serve.live.bench",
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
