"""Device-time breakdown of PageRank iterations on the card.

    python -m lux_tpu_torch.apps.profile_pagerank --rmat-scale 20 --rmat-ef 16 \\
        -ni 10 --method pallas

Takes the app's flags (``--route-gather`` included: its plan is built in
set-up, before either window).  Times ``-ni`` iterations as the app does
(``apps.pagerank.timed_iterations``), then runs ``-ni`` more under
``torch.profiler`` and prints one JSON line: the app's ms/iteration, the
CUDA kernel time per iteration from the trace, the device's idle share
(1 - traced kernel time / the app's unprofiled wall time of an equal
window; the profiler's own wall time is inflated by its overhead and is
not used), and the kernels by total device time.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from lux_tpu_torch.apps import common
from lux_tpu_torch.apps.pagerank import prepare, timed_iterations
from lux_tpu_torch.utils.config import parse_args
from lux_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    cfg = parse_args(argv, description=__doc__)
    dev = resolve_device(cfg.device)
    if dev.type != "cuda":
        raise SystemExit("profile_pagerank measures the card; --device cuda")
    common.resolve_route_auto(cfg)
    g = common.load_graph(cfg)
    iterate, state, _ = prepare(cfg, g, dev)
    n = cfg.num_iters
    wall_ms = timed_iterations(iterate, state, n, dev) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        iterate(state, n)
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:12]
    print(json.dumps({
        "method": cfg.method, "route_gather": cfg.route_gather, "iters": n,
        "nv": g.nv, "ne": g.ne,
        "device": torch.cuda.get_device_name(dev),
        "ms_per_iter": wall_ms / n, "kernel_ms_per_iter": busy_ms / n,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels": [{"name": e.key[:80], "ms_per_iter": e.device_time_total / 1e3 / n,
                     "count": e.count} for e in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
