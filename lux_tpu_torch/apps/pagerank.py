"""PageRank CLI app (`python -m lux_tpu_torch.apps.pagerank`).

-ni fixed iterations over -ng parts stacked on one device, ELAPSED TIME +
derived GTEPS on exit.  ``--method pallas`` runs the block-CSR SpMV
kernel path (one part); the other methods run the pull engine
(``mxscan`` = the segmented-scan kernel), whose per-edge gather
``--route-gather`` replaces with the routed pull (ops/expand.py).
``-verbose`` prints each iteration's fenced load/comp/update times;
``--ckpt-dir``/``--ckpt-every`` save the global state every N iterations
and resume from the latest checkpoint; ``--stream-hbm-gib`` keeps the
edge arrays in pinned host memory and streams them through that device
budget (engine/stream.py); ``--serve`` answers a burst of
personalized-PageRank queries through the batched query service instead
(serve/driver.py; ``-ni`` is each query's iteration count).  Runs on the
card unless ``--device cpu``.
The elapsed time covers the iterations only: graph load, layout build,
the routed plan's construction, the host-to-device copy and an untimed
warm-up run of the same iterations on a copy of the state come before
the timer starts, and checkpoint I/O stays outside it.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np

from lux_tpu_torch.apps import common
from lux_tpu_torch.apps.common import timed_iterations  # noqa: F401 (the apps' timing)
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.models.pagerank import (PageRankProgram, check_ranks,
                                           make_pallas_runner)
from lux_tpu_torch.utils.config import parse_args
from lux_tpu_torch.utils.device import resolve_device
from lux_tpu_torch.utils.timing import report_elapsed


@dataclasses.dataclass
class RunResult:
    rc: int  # 0, or 1 when -check failed
    graph: HostGraph
    ranks: np.ndarray  # (nv,) pre-divided ranks, float32
    seconds: float  # iterations only, device-fenced
    gteps: float
    route_gather: str = ""  # the routed mode that ran ("" = direct)
    iters: int = 0  # iterations this run executed (a resume runs fewer)
    streamed: Optional[common.StreamedRun] = None  # --stream-hbm-gib's geometry


def prepare(cfg, g, dev, route=None):
    """Set up the method's layout and state on ``dev`` (apps/common.prepare);
    returns (iterate, state, ranks), ``ranks(state)`` reading the (nv,)
    pre-divided ranks to the host."""
    return common.prepare(cfg, g, dev, PageRankProgram(nv=g.nv, dtype=cfg.dtype),
                          make_pallas_runner, route)


def run(argv=None, route=None, graph: Optional[HostGraph] = None):
    """The app's body: parse, load, iterate, report, check.  ``route``:
    an already built routed plan for the same graph, as ``prepare``
    takes it; ``graph``: the graph the flags name, already loaded
    (library callers reuse one graph and one plan across runs).  Returns
    a RunResult, or under ``--serve`` the service's
    serve.driver.ServeRunResult."""
    cfg = parse_args(argv, description=__doc__, pull=True, stream=True, serve=True)
    dev = resolve_device(cfg.device)
    if cfg.serve:
        from lux_tpu_torch.serve import driver

        return driver.run_serve_cli(cfg, graph, "ppr", route)
    common.resolve_route_auto(cfg)
    g = graph if graph is not None else common.load_graph(cfg)
    prog = PageRankProgram(nv=g.nv, dtype=cfg.dtype)
    streamed = None
    if cfg.stream_hbm_gib:
        streamed = common.run_streamed(cfg, g, prog, dev)
        ranks, elapsed, iters = streamed.state, streamed.seconds, streamed.iters
    else:
        ranks, elapsed, iters = common.run_pull_app(cfg, g, dev, prog, make_pallas_runner,
                                                    "pagerank", route)
    gteps = report_elapsed(elapsed, g.ne, iters)
    common.top_k("rank (pre-divided)", ranks)
    rc = 0
    if cfg.check:
        ok = common.print_check(
            "pagerank (fixed-point residual)",
            check_ranks(g, ranks, num_iters=cfg.num_iters, dtype=cfg.dtype))
        rc = 0 if ok else 1
    return RunResult(rc, g, ranks, elapsed, gteps, cfg.route_gather, iters, streamed)


def main(argv=None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
