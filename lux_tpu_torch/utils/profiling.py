"""Profiling integration: ``--profile-dir`` as a torch.profiler capture.

Counterpart of ``lux_tpu.utils.profiling``.  ``trace(dir)`` wraps a run
in ``torch.profiler.profile`` (CPU activity, plus CUDA on a card) under
an ``xprof.trace`` recorder span, exports the chrome trace into ``dir``
(viewable in Perfetto or chrome://tracing), then parses it
(obs/xprof.py) and writes the per-kernel device-time table into the
run's event log, so ``tools/luxview.py`` can say how much of the window
ran inside the port's kernels from the flight-recorder log alone.

One capture per process is the rule: on the card, a third
``torch.profiler`` session in one process has come back with no device
events, so a caller that needs several windows runs them in one session
or in separate processes.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger("lux_tpu_torch")


@contextlib.contextmanager
def trace(trace_dir: str | None, device=None):
    """Context manager: capture a torch.profiler trace when ``trace_dir``
    is given (CUDA activity when ``device`` is a card, or when it is None
    and a card is present).  On exit the device is synchronized, the
    trace is written as ``<dir>/lux_torch_<stamp>_<pid>.trace.json`` and
    the kernel table lands in the event log (best effort: attribution
    never fails a run)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from lux_tpu_torch import obs

    dev = torch.device(device) if device is not None else None
    cuda = (dev.type == "cuda") if dev is not None else torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"lux_torch_{time.strftime('%Y%m%d_%H%M%S')}"
                                   f"_{os.getpid()}.trace.json")
    with obs.span("xprof.trace", dir=trace_dir) as sp:
        with profile(activities=acts) as prof:
            yield
            if cuda:
                torch.cuda.synchronize(dev)
        prof.export_chrome_trace(path)
        sp.set(file=os.path.basename(path))
    rows = attribute_trace(trace_dir)
    if rows:
        top = ", ".join(f"{r['name'][:40]}={r['total_ms']}ms" for r in rows[:3])
        log.info("profiler trace written to %s; top kernels: %s", path, top)
    print(f"profiler trace written to {path}")


def attribute_trace(trace_dir: str, top: int = 40):
    """Parse an already captured trace under ``trace_dir`` and emit the
    per-kernel table into the event log; returns the rows (None when no
    trace file was found).  Safe on any directory."""
    from lux_tpu_torch.obs import xprof

    return xprof.emit_kernel_table(trace_dir, top=top)


def annotate(name: str):
    """Named region on the trace's timelines (a no-op outside tracing)."""
    return torch.profiler.record_function(name)
