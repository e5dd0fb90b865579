"""Connected components CLI app (`python -m lux_tpu_torch.apps.components`).

Max-label propagation on the push engine over -ng parts stacked on one
device: everyone starts active, the direction-optimized loop runs to
convergence, -check validates label dominance on the host, -verbose
prints per-iteration active counts and load/comp/update times.
``--route-gather expand|expand-pf`` routes the dense rounds' gather;
``--ckpt-dir``/``--ckpt-every`` and ``--repartition-every`` as in
apps/sssp.py.  ``--stream-hbm-gib`` runs the pull form to convergence
with the edge arrays streamed from pinned host memory (engine/stream.py;
the reference's components starts dense anyway, so the all-in-edges
sweep is the natural streamed shape).  Runs on the card unless
``--device cpu``; timed as apps/sssp.py times SSSP.
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
from lux_tpu_torch.utils.timing import report_elapsed


def run(argv=None, route=None, graph: Optional[HostGraph] = None) -> PushRunResult:
    """The app's body: parse, load, converge, report, check.  ``route`` and
    ``graph`` as in apps/sssp.run."""
    cfg = parse_args(argv, description=__doc__, push=True, stream=True)
    dev = resolve_device(cfg.device)
    g = graph if graph is not None else common.load_graph(cfg)
    prog = cc_model.MaxLabelProgram()
    if cfg.stream_hbm_gib:
        st = common.run_streamed(cfg, g, prog, dev, active_fn=cc_model.active_count)
        print(f"components converged in {st.iters} iterations")
        gteps = report_elapsed(st.seconds, g.ne, st.iters)
        res = PushRunResult(0, g, st.state, st.iters, st.iters * g.ne, st.iters,
                            st.seconds, gteps, cfg.method, streamed=st)
    else:
        shards = build_push_app_shards(g, cfg)
        res = run_convergence_app(prog, shards, cfg, "components", g, route)
    print(f"{len(np.unique(res.state))} distinct labels")
    if cfg.check:
        ok = common.print_check("components", cc_model.check_labels(g, res.state))
        res.rc = 0 if ok else 1
    return res


def main(argv=None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
