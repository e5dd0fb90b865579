"""Wall-clock timer with a device fence, and the end-of-run summary."""
from __future__ import annotations

import time
from typing import Optional

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
