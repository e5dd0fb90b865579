"""Collaborative filtering CLI app (`python -m lux_tpu_torch.apps.colfilter`).

-ni fixed gradient iterations of K = 20 latent features on a weighted
rating graph (``-file``, or the synthetic ``bipartite_ratings`` graph of
--rmat-scale / --rmat-ef), on one part; ELAPSED TIME, GTEPS and the
training RMSE on exit.  ``--method pallas`` runs the 2-D block-CSR SpMV
kernel path; the other methods run the pull engine over -ng parts
stacked on one device, whose source and destination reads
``--route-gather expand|expand-pf`` replaces with the routed pull
(ops/expand.py, one feature column at a time; the fused modes take scalar
state only).  ``-verbose``, ``--ckpt-dir``/``--ckpt-every`` and
``--stream-hbm-gib`` as in apps/pagerank.py.  Runs on the card unless
``--device cpu``.  The elapsed time covers the iterations only, measured
as in apps/pagerank.py (apps/common.timed_iterations).
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np

from lux_tpu_torch.apps import common
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.models import colfilter as cf_model
from lux_tpu_torch.utils.config import parse_args
from lux_tpu_torch.utils.device import resolve_device
from lux_tpu_torch.utils.timing import report_elapsed


@dataclasses.dataclass
class RunResult:
    rc: int  # 0, or 1 when -check failed
    graph: HostGraph
    state: np.ndarray  # (nv, K) latent vectors, float32
    seconds: float  # iterations only, device-fenced
    gteps: float
    rmse: float  # training RMSE of the final state
    route_gather: str = ""  # the routed mode that ran ("" = direct)
    iters: int = 0  # iterations this run executed (a resume runs fewer)
    streamed: Optional[common.StreamedRun] = None  # --stream-hbm-gib's geometry


def prepare(cfg, g, dev, route=None):
    """Set up the method's layout and state on ``dev`` (apps/common.prepare);
    returns (iterate, state, read), ``read(state)`` bringing the (nv, K)
    latents to the host."""
    return common.prepare(cfg, g, dev, program(cfg), cf_model.make_pallas_runner, route,
                          state_width=cf_model.K)


def program(cfg) -> cf_model.CFProgram:
    return cf_model.CFProgram(dtype=cfg.dtype, err_dot=cf_model._resolve_err_dot(None))


def run(argv=None, route=None, graph: Optional[HostGraph] = None) -> RunResult:
    """The app's body: parse, load, iterate, report, check.  ``route``:
    an already built CF routed plan for the same graph, as ``prepare``
    takes it; ``graph``: the rating graph the flags name, already loaded."""
    cfg = parse_args(argv, description=__doc__, pull=True, stream=True)
    dev = resolve_device(cfg.device)
    common.resolve_route_auto(cfg)
    g = graph if graph is not None else common.load_graph(cfg, weighted=True,
                                                          bipartite=True)
    streamed = None
    if cfg.stream_hbm_gib:
        # the wide (V, K) latent matrix is the memory case of streaming
        streamed = common.run_streamed(cfg, g, program(cfg), dev, state_width=cf_model.K)
        v, elapsed, iters = streamed.state, streamed.seconds, streamed.iters
    else:
        v, elapsed, iters = common.run_pull_app(cfg, g, dev, program(cfg),
                                                cf_model.make_pallas_runner, "colfilter",
                                                route, state_width=cf_model.K)
    v = v.astype(np.float32)
    gteps = report_elapsed(elapsed, g.ne, iters)
    err = cf_model.rmse(g, v)
    print(f"training RMSE = {err:.4f}")
    rc = 0
    if cfg.check:
        # an extension, as in the reference: Lux ships no CF check task
        ok = common.print_check("colfilter (training progress)",
                                cf_model.check_training(g, v))
        rc = 0 if ok else 1
    return RunResult(rc, g, v, elapsed, gteps, err, cfg.route_gather, iters, streamed)


def main(argv=None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
