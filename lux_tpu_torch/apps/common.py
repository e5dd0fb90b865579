"""Shared app-driver scaffolding: load graph, routed-pull planning,
report, check verdict."""
from __future__ import annotations

import logging

import numpy as np

from lux_tpu_torch.engine import methods
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.format import read_lux
from lux_tpu_torch.ops import expand
from lux_tpu_torch.ops import shuffle as shuf
from lux_tpu_torch.utils.config import RunConfig

log = logging.getLogger("lux_tpu_torch")


def load_graph(cfg: RunConfig) -> HostGraph:
    """The ``-file`` graph, else the synthetic RMAT of --rmat-scale /
    --rmat-ef / --seed."""
    if cfg.file:
        try:
            g = read_lux(cfg.file)
        except (OSError, ValueError) as e:
            raise SystemExit(f"cannot read {cfg.file}: {e}")
        log.info("loaded %s: nv=%d ne=%d", cfg.file, g.nv, g.ne)
        return g
    g = generate.rmat(cfg.rmat_scale, cfg.rmat_ef, seed=cfg.seed)
    log.info("synthetic graph: nv=%d ne=%d", g.nv, g.ne)
    return g


def print_check(name: str, violations: int) -> bool:
    """[PASS]/[FAIL] verdict line."""
    verdict = "[PASS]" if violations == 0 else "[FAIL]"
    print(f"{verdict} {name} check: {violations} violations")
    return violations == 0


def top_k(label: str, values: np.ndarray, k: int = 5):
    idx = np.argsort(values)[::-1][:k]
    print(f"top-{k} {label}: "
          + ", ".join(f"v{int(i)}={float(values[i]):.3e}" for i in idx))


def route_base(rg: str) -> str:
    """Layout family of a --route-gather mode: 'expand-pf'/'fused-pf'/
    'fused-mx' bind the same shard layouts as their base — pass fusion
    (and the in-kernel reduction) only changes the kernel grouping."""
    return rg[:-3] if rg.endswith(("-pf", "-mx")) else rg


def route_is_pf(rg: str) -> bool:
    # fused-mx is inherently pass-fused (its prefix groups + the
    # in-kernel reduce group all run the chained kernels)
    return rg.endswith(("-pf", "-mx"))


def route_mx(rg: str):
    """The ``mx`` argument of the fused planners for a --route-gather
    mode: 'fused-mx' plans the MXREDUCE form, 'fused-pf' follows
    engine/methods.reduce_mode (None), plain 'fused' is unfused (False)."""
    if rg == "fused-mx":
        return True
    return None if rg == "fused-pf" else False


def resolve_route_auto(cfg) -> None:
    """Bare ``--route-gather`` (const 'auto') follows
    engine/methods.route_mode: expand-pf, or expand under
    LUX_ROUTE_MODE=routed.  Both are bitwise-identical."""
    if cfg.route_gather != "auto":
        return
    cfg.route_gather = ("expand-pf" if methods.route_mode() == "routed-pf"
                        else "expand")


def build_pull_route(cfg: RunConfig, shards, prog):
    """ONE --route-gather plan construction for a pull-layout run (host
    set-up: call it OUTSIDE the timed window): the fused plans for the
    'fused*' modes, the expand plan otherwise; '' = None.  Returns the
    (static, numpy arrays) plan."""
    rg = cfg.route_gather
    if not rg:
        return None
    resolve_route_auto(cfg)
    rg = cfg.route_gather
    if getattr(prog, "k", 1) > 1:
        raise SystemExit(
            "--route-gather supports scalar vertex state; the per-column "
            "routes of wide programs are not ported yet")
    pf = route_is_pf(rg)
    if route_base(rg) == "fused":
        return expand.plan_fused_shards(shards, prog.reduce, pf=pf,
                                        mx=route_mx(rg))
    return expand.plan_expand_shards(shards, pf=pf)


def route_mode_of(plan) -> str:
    """The --route-gather mode a built plan replays."""
    static = plan[0]
    pf = isinstance(static.r1, shuf.StaticRoutePF)
    if isinstance(static, expand.FusedStatic):
        if static.mx is not None:
            return "fused-mx"
        return "fused-pf" if pf else "fused"
    return "expand-pf" if pf else "expand"


def check_route_mode(cfg: RunConfig, plan) -> None:
    """Raise when a plan handed to an app is not the one its
    --route-gather mode builds."""
    want = cfg.route_gather
    if want == "fused-pf" and expand.resolve_fused_mx(None):
        want = "fused-mx"
    got = route_mode_of(plan)
    if got != want:
        raise ValueError(f"the plan handed in replays {got!r}, but "
                         f"--route-gather is {cfg.route_gather!r}")
