"""PageRank CLI app (`python -m lux_tpu_torch.apps.pagerank`).

-ni fixed iterations on one part, ELAPSED TIME + derived GTEPS on exit.
``--method pallas`` runs the block-CSR SpMV kernel path; the other
methods run the pull engine (``mxscan`` = the segmented-scan kernel).
Runs on the card unless ``--device cpu``.  The elapsed time covers the
``-ni`` iterations only: graph load, layout build, the host-to-device
copy and an untimed warm-up run of the same ``-ni`` iterations on a
copy of the state come before the timer starts.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

from lux_tpu_torch.apps import common
from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.models.pagerank import (PageRankProgram, check_ranks,
                                           make_pallas_runner)
from lux_tpu_torch.ops import cuda_build
from lux_tpu_torch.utils.config import parse_args
from lux_tpu_torch.utils.device import resolve_device
from lux_tpu_torch.utils.timing import Timer, report_elapsed


@dataclasses.dataclass
class RunResult:
    rc: int  # 0, or 1 when -check failed
    graph: HostGraph
    ranks: np.ndarray  # (nv,) pre-divided ranks, float32
    seconds: float  # iterations only, device-fenced
    gteps: float


def prepare(cfg, g, dev):
    """Set up the method's layout and state on ``dev``; returns
    (iterate, state, ranks): ``iterate(state, n)`` runs n iterations in
    place on ``state``, ``ranks(state)`` reads the (nv,) pre-divided
    ranks to the host."""
    if dev.type == "cuda":
        cuda_build.load_all()  # building and loading are set-up, not iterations
    if cfg.method == "pallas":
        run_blockcsr, state = make_pallas_runner(g, dtype=cfg.dtype, device=dev)
        return run_blockcsr, state, lambda s: s[: g.nv].float().cpu().numpy()
    shards = build_pull_shards(g, cfg.num_parts)
    prog = PageRankProgram(nv=g.nv, dtype=cfg.dtype)
    arrays = to_device(shards.arrays, dev)

    def iterate(state, n):
        pull.run_pull_fixed(prog, shards.spec, arrays, state, n, cfg.method,
                            donate=True)

    return (iterate, pull.init_state(prog, arrays),
            lambda s: shards.scatter_to_global(s.float().cpu().numpy()))


def timed_iterations(iterate, state, n: int, dev) -> float:
    """Seconds of ``n`` iterations in place on ``state``, device-fenced:
    the app's one definition of the iteration time.  The same ``n``
    iterations run first on a copy of the state, untimed, so first-launch
    costs (kernel module loading, allocator growth, the card's clocks
    rising from idle) stay out of it."""
    iterate(state.clone(), n)
    timer = Timer(dev)
    iterate(state, n)
    return timer.stop()


def run(argv=None) -> RunResult:
    """The app's body: parse, load, iterate, report, check."""
    cfg = parse_args(argv, description=__doc__)
    dev = resolve_device(cfg.device)
    g = common.load_graph(cfg)
    iterate, state, read_ranks = prepare(cfg, g, dev)
    elapsed = timed_iterations(iterate, state, cfg.num_iters, dev)
    ranks = read_ranks(state)
    gteps = report_elapsed(elapsed, g.ne, cfg.num_iters)
    common.top_k("rank (pre-divided)", ranks)
    rc = 0
    if cfg.check:
        ok = common.print_check(
            "pagerank (fixed-point residual)",
            check_ranks(g, ranks, num_iters=cfg.num_iters, dtype=cfg.dtype))
        rc = 0 if ok else 1
    return RunResult(rc, g, ranks, elapsed, gteps)


def main(argv=None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
