"""lux_tpu_torch.mutate — dynamic graphs: edge churn without rebuilding.

Counterpart of ``lux_tpu.mutate``:

  deltalog  — batched insert/delete resolved against the base CSC, with
              a crash-safe npz+json journal (the reference's format);
  overlay   — fixed-shape per-part buffers (tombstone mask + insert
              slots, ``LUX_DELTA_CAP``) the overlay-aware engines consume;
  graph     — MutableGraph: base + log + layouts + auto-compaction;
  refresh   — warm-restart PageRank/CC/SSSP from prior converged state;
  compact   — merge the log into a new snapshot and report which
              plan-cache entries it invalidates.

``refresh``/``compact`` import the engines, and the engines import
``overlay`` — so this package eagerly exposes only the engine-free half
and resolves the rest on first attribute access.
"""
from __future__ import annotations

from lux_tpu_torch.mutate.deltalog import (  # noqa: F401
    DeltaLog,
    DeltaOverflow,
    OP_DELETE,
    OP_INSERT,
)
from lux_tpu_torch.mutate.overlay import (  # noqa: F401 — before graph
    OverlayArrays,
    OverlayStatic,
    build_pull_overlay,
    build_push_overlay,
    delta_cap,
)
from lux_tpu_torch.mutate.graph import MutableGraph  # noqa: F401

_LAZY = ("refresh", "compact")


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return importlib.import_module(f"lux_tpu_torch.mutate.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
