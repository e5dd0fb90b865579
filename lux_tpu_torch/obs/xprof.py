"""Kernel attribution from a ``torch.profiler`` chrome trace: who got the
device time?

Counterpart of ``lux_tpu.obs.xprof``.  ``utils/profiling.trace`` exports
the profiler's chrome trace (``*.trace.json``) into the ``--profile-dir``
directory; this module reads it with the stdlib (gzip + json).  Every
complete event (``"ph": "X"``) carries (name, dur µs, cat); the device
events are the ones whose category is a CUDA kernel, copy or memset, so
device time separates from the host's operator and runtime events.

The question this answers is the port's own: of a window's device time,
how much ran inside the seven hand-written kernels (by family), against
PyTorch's gathers, scatters, copies and transposes, and concatenations.
CUDA kernels appear under their demangled ``__global__`` names (templates
included), so the classes match by substring.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Dict, List, Optional, Tuple

#: kernel-name classification, first match wins (lowercase substrings).
#: The port's own kernels come first: ``csrc/*.cu``'s ``__global__``
#: names (lane_gather_kernel contains "gather"; the run fill/fold kernels
#: are shared by spmv_blockcsr and mxreduce_pass_gather).  Then
#: PyTorch's: CatArrayBatchedCopy before the copies (it contains "copy"),
#: the scatter family before the gathers (``_scatter_gather_elementwise``
#: serves both, told apart by its functor's template argument; indexFunc*
#: is index_add_).
CLASSES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("spmv", ("spmv_span_kernel", "spmv_blockcsr_2d_kernel")),
    ("scan", ("scan_tiles", "scan_carries", "apply_carries")),
    ("routed-pf", ("fused_pass_kernel", "mx_chunk_kernel")),
    ("route", ("lane_gather_kernel", "sublane_gather_kernel")),
    ("runs", ("runs_fill_kernel", "runs_fold_kernel")),
    ("cat", ("catarraybatchedcopy", "cat_array", "aten::cat")),
    # gather instances of the shared scatter/gather kernel (torch.gather,
    # take): the functor's is_scatter_like template argument is false
    ("gather", ("scatter_gather_internal_kernel<false",)),
    ("scatter", ("scatter", "indexfunc", "index_put", "index_add")),
    ("gather", ("indexselect", "index_select", "gather", "index_elementwise")),
    ("copy", ("copy", "transpose", "memcpy", "memset")),
)

#: chrome-trace categories of device work (torch.profiler / Kineto)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def classify(name: str) -> str:
    low = name.lower()
    for cls, needles in CLASSES:
        if any(n in low for n in needles):
            return cls
    return "other"


#: per-file on-disk size cap for synchronous parsing (MB): a trace of a
#: long window must not stall or exhaust the run that just finished its
#: measured work.  Oversized files are skipped and named in the emitted
#: event; raise LUX_OBS_XPROF_MAX_MB to parse them.
MAX_MB_ENV = "LUX_OBS_XPROF_MAX_MB"
DEFAULT_MAX_MB = 64


def _max_bytes() -> int:
    from lux_tpu_torch.utils.config import env_int

    try:
        mb = env_int(MAX_MB_ENV, DEFAULT_MAX_MB, minimum=1)
    except ValueError:
        mb = DEFAULT_MAX_MB
    return int(mb) * (1 << 20)


def _trace_files(trace_dir: str) -> List[str]:
    """The NEWEST capture under ``trace_dir``: one file per
    ``profiling.trace`` session, and the apps reuse one ``--profile-dir``
    across runs, so attributing the union would mix runs."""
    files = (glob.glob(os.path.join(trace_dir, "*.trace.json"))
             + glob.glob(os.path.join(trace_dir, "*.trace.json.gz")))
    return [max(files, key=os.path.getmtime)] if files else []


def _load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        doc = json.load(f)
    return doc.get("traceEvents", []) if isinstance(doc, dict) else doc


def kernel_table(trace_dir: str, top: int = 0,
                 skipped: Optional[List[str]] = None,
                 meta: Optional[Dict] = None) -> List[Dict]:
    """Aggregate device time per kernel name over the newest trace file
    under ``trace_dir``.  Returns rows sorted by total time desc:
    {"name", "class", "total_ms", "calls", "frac"} — frac of the summed
    device time.  Empty list when no trace file exists.  A file over the
    LUX_OBS_XPROF_MAX_MB on-disk cap is not parsed; its path is appended
    to ``skipped`` when the caller passes a list.  A trace with no device
    events (a CPU run) sums every complete event instead and sets
    ``meta["host_only"]``, so consumers label the table as host wall
    time, not device time."""
    totals: Dict[str, List[float]] = {}
    cap = _max_bytes()
    events: list = []
    for path in _trace_files(trace_dir):
        try:
            if os.path.getsize(path) > cap:
                if skipped is not None:
                    skipped.append(path)
                continue
            events = _load_events(path)
        except (OSError, ValueError):
            continue
    complete = [ev for ev in events if ev.get("ph") == "X"]
    device = [ev for ev in complete
              if str(ev.get("cat", "")).lower() in DEVICE_CATS]
    if not device and complete and meta is not None:
        meta["host_only"] = True
    for ev in device or complete:
        name = str(ev.get("name", ""))
        t = totals.setdefault(name, [0.0, 0])
        t[0] += float(ev.get("dur", 0.0))
        t[1] += 1
    grand = sum(t[0] for t in totals.values()) or 1.0
    rows = [
        {"name": name, "class": classify(name),
         "total_ms": round(t[0] / 1e3, 6), "calls": t[1],
         "frac": round(t[0] / grand, 4)}
        for name, t in totals.items()
    ]
    rows.sort(key=lambda r: (-r["total_ms"], r["name"]))
    return rows[:top] if top else rows


def class_summary(rows: List[Dict]) -> Dict[str, float]:
    """{class: total_ms} rollup of a kernel_table."""
    out: Dict[str, float] = {}
    for r in rows:
        out[r["class"]] = round(out.get(r["class"], 0.0) + r["total_ms"], 6)
    return out


def emit_kernel_table(trace_dir: str, rec=None,
                      top: int = 40) -> Optional[List[Dict]]:
    """Parse ``trace_dir`` and write the attribution into the event log
    as one ``xprof.kernels`` point (the reference's name, which luxview
    renders); returns the rows (None when no trace was found).  The
    class totals and call counts cover every row, not only the ``top``
    written.  Never raises: attribution is bookkeeping, not a run
    dependency."""
    skipped: List[str] = []
    meta: Dict = {}
    try:
        rows = kernel_table(trace_dir, skipped=skipped, meta=meta)
    except Exception:  # noqa: BLE001 — attribution must never cost a run
        return None
    if not rows and not skipped:
        return None
    from lux_tpu_torch import obs

    r = rec if rec is not None else obs.recorder()
    ev = {"trace_dir": trace_dir, "rows": rows[:top] if top else rows,
          "classes": class_summary(rows),
          "total_ms": round(sum(x["total_ms"] for x in rows), 6),
          "calls": sum(x["calls"] for x in rows)}
    if meta.get("host_only"):  # no device events: host wall, not device ms
        ev["host_only"] = True
    if skipped:  # over-cap files: named, not silently absent
        ev["skipped_over_cap"] = skipped
        ev["cap_mb"] = _max_bytes() >> 20
    r.point("xprof.kernels", **ev)
    return rows
