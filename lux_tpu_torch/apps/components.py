"""Connected components CLI app (`python -m lux_tpu_torch.apps.components`).

Max-label propagation on the push engine, one part: everyone starts
active, the direction-optimized loop runs to convergence, -check
validates label dominance on the host, -verbose prints per-iteration
active counts and load/comp/update times.  ``--route-gather
expand|expand-pf`` routes the dense rounds' gather.  Runs on the card
unless ``--device cpu``; timed as apps/sssp.py times SSSP.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from lux_tpu_torch.apps import common
from lux_tpu_torch.apps.sssp import PushRunResult, build_push_app_shards, run_convergence_app
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.models import components as cc_model
from lux_tpu_torch.utils.config import parse_args
from lux_tpu_torch.utils.device import resolve_device


def run(argv=None, route=None, graph: Optional[HostGraph] = None) -> PushRunResult:
    """The app's body: parse, load, converge, report, check.  ``route`` and
    ``graph`` as in apps/sssp.run."""
    cfg = parse_args(argv, description=__doc__, push=True)
    resolve_device(cfg.device)
    g = graph if graph is not None else common.load_graph(cfg)
    shards = build_push_app_shards(g, cfg)
    res = run_convergence_app(cc_model.MaxLabelProgram(), shards, cfg,
                              "components", g, route)
    print(f"{len(np.unique(res.state))} distinct labels")
    if cfg.check:
        ok = common.print_check("components", cc_model.check_labels(g, res.state))
        res.rc = 0 if ok else 1
    return res


def main(argv=None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
