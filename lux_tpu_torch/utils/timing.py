"""Wall-clock timer with a device fence, per-iteration stats, the serving
path's latency percentiles, and the end-of-run summary."""
from __future__ import annotations

import dataclasses
import random
import time
from typing import List, Optional

import torch


class Timer:
    """Wall-clock timer fenced on the device at both ends.  PyTorch CUDA
    calls return before the card finishes, so the start waits for work
    queued before it and ``stop`` for work queued since."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self._fence()
        self.t0 = time.perf_counter()
        self.elapsed = 0.0

    def _fence(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stop(self) -> float:
        self._fence()
        self.elapsed = time.perf_counter() - self.t0
        return self.elapsed


@dataclasses.dataclass
class IterStat:
    it: int
    active: int
    seconds: float
    #: per-phase wall times (s) when the driver fences the iteration into
    #: load/comp/update sub-steps; None on whole-iteration records
    load_s: Optional[float] = None
    comp_s: Optional[float] = None
    update_s: Optional[float] = None


class IterStats:
    """Collects the per-iteration stats, and prints them in verbose mode
    (the reference's activeNodes/loadTime/compTime/updateTime lines)."""

    def __init__(self, verbose: bool = False):
        self.verbose = verbose
        self.stats: List[IterStat] = []

    def record(self, it: int, active: int, seconds: float):
        self.stats.append(IterStat(it, active, seconds))
        if self.verbose:
            print(f"iter {it:4d}: activeNodes({active}) time({seconds*1e3:.3f} ms)")

    def record_phases(self, it: int, active: int, load_s: float, comp_s: float,
                      update_s: float):
        total = load_s + comp_s + update_s
        self.stats.append(IterStat(it, active, total, load_s, comp_s, update_s))
        if self.verbose:
            print(f"iter {it:4d}: activeNodes({active}) "
                  f"loadTime({load_s*1e3:.3f} ms) "
                  f"compTime({comp_s*1e3:.3f} ms) "
                  f"updateTime({update_s*1e3:.3f} ms)")

    @property
    def seconds(self) -> float:
        """The recorded iterations' seconds, summed."""
        return sum(s.seconds for s in self.stats)


def percentiles(values, ps=(50, 95, 99)) -> dict:
    """{"p50": ..., ...} over ``values``: nearest rank on the sorted
    sample (p99 of 100 samples is the 99th largest, never an
    interpolated value that no request actually experienced).  Empty
    input yields an empty dict."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return {}
    out = {}
    for p in ps:
        rank = max(int((p / 100.0) * len(vals) + 0.999999) - 1, 0)
        out[f"p{p}"] = vals[min(rank, len(vals) - 1)]
    return out


class LatencyHistogram:
    """Per-request latency recorder of the serving path: record seconds,
    summarize as millisecond percentiles.  Bounded: past ``max_samples``
    it reservoir-samples (uniform over the whole stream, fixed seed), so
    a long-lived service keeps O(max_samples) memory."""

    def __init__(self, max_samples: int = 65_536):
        self.samples: List[float] = []
        self.count = 0
        self.max_samples = max_samples
        self._rng = random.Random(0x1c3)

    def record(self, seconds: float):
        self.count += 1
        if len(self.samples) < self.max_samples:
            self.samples.append(float(seconds))
        else:
            j = self._rng.randrange(self.count)
            if j < self.max_samples:
                self.samples[j] = float(seconds)

    def __len__(self) -> int:
        return self.count

    def summary_ms(self, ps=(50, 95, 99)) -> dict:
        return {k: round(v * 1e3, 3) for k, v in percentiles(self.samples, ps).items()}


def report_elapsed(seconds: float, ne: int, iters: int,
                   traversed: Optional[int] = None) -> float:
    """Print the end-of-run summary; returns GTEPS (fixed-iteration apps
    count iters * ne edges, frontier apps the edges actually traversed)."""
    edges = traversed if traversed is not None else iters * ne
    gteps = edges / seconds / 1e9 if seconds > 0 else float("nan")
    print(f"ELAPSED TIME = {seconds:.7f} s")
    print(f"ITERATIONS   = {iters}")
    print(f"GTEPS        = {gteps:.4f}")
    return gteps
