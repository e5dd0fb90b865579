"""lux_tpu_torch.obs — the flight recorder, one event log per run.

Counterpart of ``lux_tpu.obs`` (copies and PyTorch versions: the port
imports nothing of the reference).  The layers:

* **recorder** (pure stdlib) — ``span()``/``point()`` context managers
  writing an append-only JSONL event log under a uid-checked 0o700
  directory (``LUX_OBS_DIR``); nested span ids, monotonic timestamps, a
  ``run_id``.  Begin events are on disk before the work they cover runs.
  The schema is the reference's: ``tools/luxview.py`` renders the log.
* **ring** (torch) — fixed-capacity per-iteration telemetry kept in a
  device tensor during the engines' loops and fetched once at the end;
  no host read per iteration, and every result bitwise unchanged.
* **xprof** (stdlib) — parses the chrome trace ``torch.profiler`` writes
  under ``--profile-dir`` and attributes device time to the port's
  kernels against gathers, scatters, copies and concatenations.
* **dtrace**, **slo** (stdlib) — trace contexts with keyed ids, and
  declarative SLOs as multi-window burn rates with trace exemplars.

This ``__init__`` (and recorder, dtrace) import neither torch nor numpy;
``ring`` and ``xprof`` are imported where they are used.
"""
from lux_tpu_torch.obs.recorder import (  # noqa: F401
    Recorder,
    Span,
    install,
    new_run_id,
    point,
    recorder,
    run_id,
    span,
)
from lux_tpu_torch.obs import dtrace  # noqa: F401  (stdlib-only, like recorder)
