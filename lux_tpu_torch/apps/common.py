"""Shared app-driver scaffolding: load graph, the method checks and the
memory preflight, pull-engine set-up, routed-pull planning, the timed
window, report, check verdict."""
from __future__ import annotations

import logging

import numpy as np

from lux_tpu_torch.engine import methods, pull
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.format import read_lux
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.ops import cuda_build, expand, spmv
from lux_tpu_torch.ops import shuffle as shuf
from lux_tpu_torch.utils import preflight
from lux_tpu_torch.utils.config import RunConfig
from lux_tpu_torch.utils.timing import Timer

log = logging.getLogger("lux_tpu_torch")


def load_graph(cfg: RunConfig, weighted: bool = False,
               bipartite: bool = False) -> HostGraph:
    """The ``-file`` graph, else a synthetic one from --rmat-scale /
    --rmat-ef / --seed: RMAT, or with ``bipartite`` the rating graph of
    collaborative filtering (2^scale vertices, half users and half
    items, 2^scale * ef / 2 ratings, each an edge both ways).
    ``weighted`` requires edge weights of a file, and gives RMAT some."""
    if cfg.file:
        try:
            g = read_lux(cfg.file)
        except (OSError, ValueError) as e:
            raise SystemExit(f"cannot read {cfg.file}: {e}")
        if weighted and not g.weighted:
            raise SystemExit(f"{cfg.file} has no edge weights")
        log.info("loaded %s: nv=%d ne=%d", cfg.file, g.nv, g.ne)
        return g
    if bipartite:
        n_half = (1 << cfg.rmat_scale) // 2
        g = generate.bipartite_ratings(
            n_half, n_half, (1 << cfg.rmat_scale) * cfg.rmat_ef // 2, seed=cfg.seed)
    else:
        g = generate.rmat(cfg.rmat_scale, cfg.rmat_ef, seed=cfg.seed,
                          weighted=weighted)
    log.info("synthetic graph: nv=%d ne=%d", g.nv, g.ne)
    return g


def validate_exchange(cfg: RunConfig, prog, dev) -> None:
    """Resolve ``--method auto`` to the measured winner for ``prog``'s
    reduce on ``dev`` (engine/methods.resolve_sum) and refuse, with a CLI
    message before any set-up, the methods that cannot reduce it: the
    prefix-difference strategies and ``pallas`` are sum-only.  The
    exchange, edge-shard and layout checks of the reference come with
    multi-GPU."""
    cfg.method = methods.resolve_sum(cfg.method, prog.reduce,
                                     methods.default_platform(dev))
    if cfg.method in ("cumsum", "mxsum") and prog.reduce != "sum":
        raise SystemExit(
            f"--method {cfg.method} is a prefix-diff strategy: sum-reduce "
            f"programs only (this app reduces with {prog.reduce})")
    if cfg.method == "pallas" and prog.reduce != "sum":
        raise SystemExit(
            "--method pallas: sum-reduce programs only; min/max apps "
            "use scan/scatter")


def estimate_exchange(shards, cfg: RunConfig, state_width: int = 1,
                      dst_state: bool = False) -> preflight.MemoryEstimate:
    """The memory estimate of a pull run of ``shards`` on one device: one
    part's arrays, state and per-edge gather (``dst_state``: the program
    reads the destination too), every part resident, plus the routed
    plan of ``cfg.route_gather`` from the geometry (before it is
    built)."""
    sbytes = 2 if cfg.dtype == "bfloat16" else 4
    est = preflight.estimate_pull(shards.spec, state_width, sbytes,
                                  dst_state=dst_state, method=cfg.method)
    est = preflight.scale_residency(est, shards.spec.num_parts)
    if cfg.route_gather:
        resolve_route_auto(cfg)
        est = preflight.add_routed_bytes(
            est, shards.spec.num_parts * preflight.routed_plan_bytes_analytic(
                shards.spec, cfg.route_gather, wide=state_width > 1))
    return est


def estimate_blockcsr(bc, state_width: int = 1, dtype: str = "float32"):
    """The memory estimate of a block-CSR runner (``--method pallas``)
    over the layout ``bc``: PageRank's (``state_width`` 1: out-degrees)
    or CF's (wide: slot weights and destination rows)."""
    wide = state_width > 1
    return preflight.estimate_pallas_pull(
        bc.num_chunks, bc.e_src_pos.shape[1], bc.num_vblocks * bc.v_blk,
        state_width, weighted=wide, degree=not wide, dst_state=wide,
        state_dtype_bytes=2 if dtype == "bfloat16" else 4)


def report_preflight(est, dev) -> bool:
    """Print the estimate and warn when it exceeds the memory of ``dev``
    (apps print it before set-up, outside any timed window).  The
    reference's --edge-shards hint comes with --edge-shards."""
    print(est)
    return preflight.check_fits(est, device=dev)


def prepare(cfg: RunConfig, g: HostGraph, dev, prog, pallas_runner, route=None,
            state_width: int = 1):
    """An app's set-up for a ``-ni`` run on ``dev``: ``--method pallas``
    builds ``pallas_runner(g, dtype=, device=)`` (the model's block-CSR
    kernel path), any other method the pull engine running ``prog``.
    Returns (iterate, state, read): ``iterate(state, n)`` runs n
    iterations in place on ``state``, ``read(state)`` brings the (nv,
    ...) state to the host as float32.  With ``cfg.route_gather`` the
    routed plan is built here (set-up, like the kernel build), unless the
    caller hands in ``route``, a plan it built for the same graph with
    ops/expand or :func:`build_pull_route`.  The memory estimate of the
    layout (``state_width`` columns) is printed before anything lands on
    the device."""
    validate_exchange(cfg, prog, dev)
    if cfg.method == "pallas":
        bc = spmv.build_blockcsr(g)
        report_preflight(estimate_blockcsr(bc, state_width, cfg.dtype), dev)
        if dev.type == "cuda":
            cuda_build.load_all()  # building and loading are set-up, not iterations
        run, state = pallas_runner(g, dtype=cfg.dtype, device=dev, bc=bc)
        return run, state, lambda s: s[: g.nv].float().cpu().numpy()
    shards = build_pull_shards(g, cfg.num_parts)
    report_preflight(estimate_exchange(shards, cfg, state_width,
                                       dst_state=prog.needs_dst_state), dev)
    if dev.type == "cuda":
        cuda_build.load_all()
    arrays = to_device(shards.arrays, dev)
    if route is None and cfg.route_gather:
        route = build_pull_route(cfg, shards, prog)
    if route is not None:
        check_route_mode(cfg, route)
        route = expand.plan_to_device(route, dev)

    def iterate(state, n):
        pull.run_pull_fixed(prog, shards.spec, arrays, state, n, cfg.method,
                            route=route, donate=True)

    return (iterate, pull.init_state(prog, arrays),
            lambda s: shards.scatter_to_global(s.float().cpu().numpy()))


def timed_iterations(iterate, state, n: int, dev) -> float:
    """Seconds of ``n`` iterations in place on ``state``, device-fenced:
    the apps' one definition of the iteration time.  The same ``n``
    iterations run first on a copy of the state, untimed, so first-launch
    costs (kernel module loading, allocator growth, the card's clocks
    rising from idle) stay out of it."""
    iterate(state.clone(), n)
    timer = Timer(dev)
    iterate(state, n)
    return timer.stop()


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
    'fused*' modes, the CF per-column src + dst plan for wide programs,
    the expand plan otherwise; '' = None.  Returns the (static, numpy
    arrays) plan."""
    rg = cfg.route_gather
    if not rg:
        return None
    resolve_route_auto(cfg)
    rg = cfg.route_gather
    pf = route_is_pf(rg)
    wide = getattr(prog, "k", 1) > 1
    if route_base(rg) == "fused":
        if wide:
            raise SystemExit(
                "--route-gather fused supports scalar vertex state; "
                "wide dst-dependent programs route with "
                "--route-gather expand (per-column src + dst plans)")
        return expand.plan_fused_shards(shards, prog.reduce, pf=pf,
                                        mx=route_mx(rg))
    if wide:
        return expand.plan_cf_route_shards(shards, pf=pf)
    return expand.plan_expand_shards(shards, pf=pf)


def build_push_route(cfg: RunConfig, shards):
    """The push apps' --route-gather plan (host set-up, outside the timed
    window): the expand plan of the push shards' embedded pull layout,
    pass-fused for 'expand-pf'; '' = None.  The dense rounds route their
    gather only, so there is no fused form."""
    if not cfg.route_gather:
        return None
    resolve_route_auto(cfg)
    return expand.plan_expand_shards(shards.pull, pf=route_is_pf(cfg.route_gather))


def route_mode_of(plan) -> str:
    """The --route-gather mode a built plan replays."""
    static = plan[0]
    if isinstance(static, expand.CFRouteStatic):
        static = static.src
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
