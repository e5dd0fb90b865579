"""Shared app-driver scaffolding: load graph, the method checks and the
memory preflight, pull-engine set-up, routed-pull planning, the timed
window, the step-wise and checkpointed pull loop, the streamed runner,
report, check verdict."""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from lux_tpu_torch.engine import methods, pull
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.format import read_lux
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.ops import cuda_build, expand, spmv
from lux_tpu_torch.ops import shuffle as shuf
from lux_tpu_torch.utils import checkpoint, preflight, profiling
from lux_tpu_torch.utils.config import RunConfig
from lux_tpu_torch.utils.timing import IterStats, Timer

_ROUTE_VERBOSE_ERR = (
    "-verbose 3-phase fencing is a direct-gather observability mode; "
    "drop --route-gather or -verbose")

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
    pl = setup_pull(cfg, g, dev, prog, route, state_width)
    return pl.iterate, pull.init_state(prog, pl.arrays), pl.read


@dataclasses.dataclass
class PullSetup:
    """The pull engine's layout on the device: host shards, device
    arrays, the routed plan on the device (or None)."""

    prog: object
    shards: object
    arrays: object
    route: object
    method: str

    def iterate(self, state, n: int) -> None:
        """n iterations in place on ``state``."""
        pull.run_pull_fixed(self.prog, self.shards.spec, self.arrays, state, n,
                            self.method, route=self.route, donate=True)

    def read(self, state) -> np.ndarray:
        """The (nv, ...) global state on the host, float32."""
        return self.shards.scatter_to_global(state.float().cpu().numpy())


def setup_pull(cfg: RunConfig, g: HostGraph, dev, prog, route=None,
               state_width: int = 1) -> PullSetup:
    """The pull engine's part of :func:`prepare` (``cfg.method`` already
    resolved): the shards, the printed estimate, the kernel build, the
    device arrays and the routed plan."""
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
    return PullSetup(prog, shards, arrays, route, cfg.method)


def run_pull_app(cfg: RunConfig, g: HostGraph, dev, prog, pallas_runner, app: str,
                 route=None, state_width: int = 1):
    """A fixed-iteration pull app's run (PageRank, CF): set-up, then the
    timed ``-ni`` iterations, or with ``-verbose``/``--ckpt-every`` the
    step-wise loop, from the latest checkpoint of ``--ckpt-dir`` when it
    holds one.  Returns (the (nv, ...) float32 state on the host, the
    timed seconds, the iterations this run executed)."""
    stepwise = cfg.verbose or cfg.ckpt_every
    if cfg.method == "pallas" and (stepwise or cfg.ckpt_dir):
        raise SystemExit(
            "--method pallas: -verbose/checkpointing are not wired to the "
            "kernel path; use --method scan, scatter or mxscan for those")
    if cfg.verbose and (cfg.route_gather or route is not None):
        raise SystemExit(_ROUTE_VERBOSE_ERR)
    if cfg.method == "pallas" or not (stepwise or cfg.ckpt_dir):
        iterate, state, read = prepare(cfg, g, dev, prog, pallas_runner, route,
                                       state_width)
        with profiling.trace(cfg.profile_dir, dev):
            elapsed = timed_iterations(iterate, state, cfg.num_iters, dev)
        return read(state), elapsed, cfg.num_iters
    validate_exchange(cfg, prog, dev)
    pl = setup_pull(cfg, g, dev, prog, route, state_width)
    state, start_it = resume_or_init(cfg, app, pl.shards, pull.init_state(prog, pl.arrays),
                                     g.nv)
    n = max(cfg.num_iters - start_it, 0)
    if not stepwise:
        with profiling.trace(cfg.profile_dir, dev):
            elapsed = timed_iterations(pl.iterate, state, n, dev)
        return pl.read(state), elapsed, n

    def on_iter(it, st):
        if cfg.ckpt_every and (it + 1) % cfg.ckpt_every == 0:
            save_global(cfg, app, pl.shards, it + 1, st)

    with profiling.trace(cfg.profile_dir, dev):
        pl.iterate(state.clone(), n)  # untimed, as timed_iterations does
        state, stats = run_pull_stepwise(pl, state, start_it, cfg.num_iters, cfg,
                                         g.nv, dev, on_iter)
    return pl.read(state), stats.seconds, n


def run_pull_stepwise(pl: PullSetup, state, start_it: int, num_iters: int,
                      cfg: RunConfig, nv: int, dev, on_iter=None):
    """Step-wise pull loop for -verbose / --ckpt-every runs.  Verbose mode
    fences each iteration into load/comp/update sub-steps
    (engine/pull.compile_pull_phases, the reference's per-phase timers);
    otherwise each iteration runs as one fenced step (through the routed
    plan when there is one).  ``on_iter(it, state)`` runs after each
    iteration, outside the recorded times (checkpoint I/O is not engine
    time).  Returns (final state, IterStats)."""
    stats = IterStats(verbose=cfg.verbose)
    if cfg.verbose:
        if pl.route is not None:
            raise SystemExit(_ROUTE_VERBOSE_ERR)
        load, comp, update = pull.compile_pull_phases(pl.prog, pl.shards.spec, pl.method)
    for it in range(start_it, num_iters):
        if cfg.verbose:
            t = Timer(dev)
            gath = load(pl.arrays, state)
            lt = t.stop()
            t = Timer(dev)
            acc = comp(pl.arrays, gath)
            ct = t.stop()
            t = Timer(dev)
            state = update(pl.arrays, state, acc)
            stats.record_phases(it, nv, lt, ct, t.stop())
        else:
            t = Timer(dev)
            pl.iterate(state, 1)
            stats.record(it, nv, t.stop())
        if on_iter is not None:
            on_iter(it, state)
    return state, stats


def resume_or_init(cfg: RunConfig, app: str, shards, state, nv: int):
    """Elastic resume: restack the latest global checkpoint of
    ``--ckpt-dir`` (any previous -ng) onto THIS run's layout, cast to this
    run's state dtype; returns (state, start_iteration)."""
    if not cfg.ckpt_dir:
        return state, 0
    saved, start_it, prev = checkpoint.load_resume(cfg.ckpt_dir, app, nv)
    if saved is None:
        return state, 0
    if isinstance(saved, torch.Tensor):  # bfloat16: restack its f32 widening
        saved = saved.float().numpy()
    stacked = shards.global_to_stacked(np.asarray(saved))
    print(f"resumed from {prev} at iteration {start_it}")
    return torch.from_numpy(stacked).to(device=state.device, dtype=state.dtype), start_it


def save_global(cfg: RunConfig, app: str, shards, iteration: int, state) -> str:
    """Checkpoint the stacked device state as the layout-independent
    global vector (elastic: any later -ng can resume it)."""
    host = state.cpu()
    if host.dtype == torch.bfloat16:
        glob = torch.from_numpy(shards.scatter_to_global(host.float().numpy()))
        glob = glob.to(torch.bfloat16)
    else:
        glob = shards.scatter_to_global(host.numpy())
    return checkpoint.save_iteration(cfg.ckpt_dir, iteration, glob, app)


@dataclasses.dataclass
class StreamedRun:
    state: np.ndarray  # (nv, ...) global final state, float32 or int32
    seconds: float  # the timed run, device-fenced
    iters: int
    chunk_e: int  # edges a chunk
    n_chunks: int  # chunks a part
    resident_bytes: int  # engine/stream.streamed_hbm_bytes of the run
    budget_bytes: int
    edge_bytes: int  # the resident engine's edge arrays (what streaming avoids)
    layout: object = None  # the engine/stream.StreamedPullShards that ran


def run_streamed(cfg: RunConfig, g: HostGraph, prog, dev, state_width: int = 1,
                 active_fn=None) -> StreamedRun:
    """The pull apps' --stream-hbm-gib runner: host-resident edges streamed
    through a device-byte budget (engine/stream.py).  Validates the
    combination, builds and prints the streamed geometry, runs once
    untimed and once timed (the fixed-iteration driver, or with
    ``active_fn`` the convergence driver of components)."""
    from lux_tpu_torch.engine import stream as stream_eng

    if (cfg.method == "pallas" or cfg.verbose or cfg.ckpt_every or cfg.ckpt_dir
            or cfg.repartition_every or cfg.route_gather):
        raise SystemExit(
            "--stream-hbm-gib is the single-process host-offload mode; it "
            "does not combine with --method pallas/-verbose/checkpointing/"
            "--repartition-every/--route-gather")
    validate_exchange(cfg, prog, dev)
    sbytes = 2 if cfg.dtype == "bfloat16" else 4
    shards = build_pull_shards(g, cfg.num_parts)
    budget = int(cfg.stream_hbm_gib * (1 << 30))
    chunk_e = stream_eng.chunk_edges_for_budget(shards.spec, budget, sbytes, state_width)
    resident = stream_eng.streamed_hbm_bytes(shards.spec, chunk_e, sbytes, state_width)
    total = stream_eng.edge_bytes_total(shards.spec)
    ssh = stream_eng.build_streamed_pull(shards, chunk_e, pin_memory=dev.type == "cuda")
    n_chunks = len(ssh.chunks[0])
    print(f"streamed: {n_chunks} chunk(s) of {chunk_e} edges/part; resident "
          f"{resident/(1<<30):.3f} GiB <= budget {budget/(1<<30):.3f} GiB "
          f"(monolithic edge arrays {total/(1<<30):.3f} GiB)")
    if dev.type == "cuda":
        cuda_build.load_all()
    state0 = pull.init_state(prog, to_device(ssh.varrays, dev))

    def go():
        if active_fn is not None:
            return stream_eng.run_pull_until_streamed(prog, ssh, state0, cfg.max_iters,
                                                      active_fn, method=cfg.method)
        return (stream_eng.run_pull_fixed_streamed(prog, ssh, state0, cfg.num_iters,
                                                   method=cfg.method), cfg.num_iters)

    with profiling.trace(cfg.profile_dir, dev):
        go()
        timer = Timer(dev)
        out, iters = go()
        elapsed = timer.stop()
    host = out.float() if out.dtype == torch.bfloat16 else out
    return StreamedRun(ssh.scatter_to_global(host.cpu().numpy()), elapsed, iters, chunk_e,
                       n_chunks, resident, budget, total, ssh)


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


def report_plan(build):
    """Run a cached planner call ``build()`` and print whether its entries
    were loaded from the plan disk cache (``LUX_TORCH_PLAN_CACHE``) or
    built, and the seconds it took (ops/expand.plan_stats_snapshot).
    Returns the plan."""
    before = expand.plan_stats_snapshot()
    plan = build()
    after = expand.plan_stats_snapshot()
    built = after["built"] - before["built"]
    loaded = after["loaded"] - before["loaded"]
    secs = (after["cold_s"] - before["cold_s"]) + (after["warm_s"] - before["warm_s"])
    how = "built" if built and not loaded else "loaded" if loaded and not built \
        else f"built {built} / loaded {loaded}"
    print(f"routed plan {how}: {built + loaded} cache entries in {secs:.3f} s")
    return plan


def build_pull_route(cfg: RunConfig, shards, prog):
    """ONE --route-gather plan construction for a pull-layout run (host
    set-up: call it OUTSIDE the timed window): the fused plans for the
    'fused*' modes, the CF per-column src + dst plan for wide programs,
    the expand plan otherwise; '' = None.  Each goes through the plan
    disk cache (ops/expand's ``*_cached`` planners, as the reference's
    apps do), and the run prints whether it loaded or built the plan.
    Returns the (static, numpy arrays) plan."""
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
        return report_plan(lambda: expand.plan_fused_shards_cached(
            shards, prog.reduce, pf=pf, mx=route_mx(rg)))
    if wide:
        return report_plan(lambda: expand.plan_cf_route_shards_cached(shards, pf=pf))
    return report_plan(lambda: expand.plan_expand_shards_cached(shards, pf=pf))


def build_push_route(cfg: RunConfig, shards):
    """The push apps' --route-gather plan (host set-up, outside the timed
    window): the expand plan of the push shards' embedded pull layout,
    pass-fused for 'expand-pf', through the plan disk cache as in
    :func:`build_pull_route`; '' = None.  The dense rounds route their
    gather only, so there is no fused form."""
    if not cfg.route_gather:
        return None
    resolve_route_auto(cfg)
    pf = route_is_pf(cfg.route_gather)
    return report_plan(lambda: expand.plan_expand_shards_cached(shards.pull, pf=pf))


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
