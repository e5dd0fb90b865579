"""Shared app-driver scaffolding: load graph, the method and exchange
checks and the memory preflight, pull-engine set-up, routed-pull
planning, the timed window, the step-wise and checkpointed pull loop,
the distributed runner (--distributed: the parts spread over the ranks
of torch.distributed, parallel/), the streamed runner, report, check
verdict."""
from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Optional

import numpy as np
import torch

from lux_tpu_torch.engine import methods, pull
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.format import read_lux
from lux_tpu_torch.graph.shards import build_pull_shards, global_to_stacked, to_device
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
    exchange checks are the reference's (:func:`check_distributed`); the
    gather relayouts' are :func:`refuse_relayouts`."""
    was_auto = cfg.method == "auto"
    cfg.method = methods.resolve_sum(cfg.method, prog.reduce,
                                     methods.default_platform(dev))
    refuse_relayouts(cfg)
    if cfg.method in ("cumsum", "mxsum") and prog.reduce != "sum":
        raise SystemExit(
            f"--method {cfg.method} is a prefix-diff strategy: sum-reduce "
            f"programs only (this app reduces with {prog.reduce})")
    if cfg.method == "pallas" and prog.reduce != "sum":
        raise SystemExit(
            "--method pallas: sum-reduce programs only; min/max apps "
            "use scan/scatter")
    check_distributed(cfg, prog, was_auto)


def check_distributed(cfg: RunConfig, prog, was_auto: bool) -> None:
    """The reference's --exchange rules (``lux_tpu.apps.common
    .validate_exchange``), before any set-up: ring and scatter need
    --distributed and run --method scan or scatter
    (parallel/ring.bucketed_method: an ``auto`` winner they cannot run
    falls back to scan, with a note; an explicit one is refused), scatter
    needs a sum program without destination reads, pallas runs on the
    allgather exchange, and the relayouts bind to the allgather pull
    layout."""
    if cfg.distributed:
        check_route(cfg, prog)
    if cfg.feat_shards > 1:
        return check_feat(cfg, prog, was_auto)
    if cfg.edge_shards > 1:
        return check_edge2d(cfg, prog, was_auto)
    if cfg.exchange != "allgather" and not cfg.distributed:
        raise SystemExit(f"--exchange {cfg.exchange} requires --distributed")
    if not cfg.distributed:
        return
    if cfg.stream_hbm_gib:
        raise SystemExit("--distributed runs the resident pull engines; it does not "
                         "combine with --stream-hbm-gib")
    if cfg.method == "pallas" and cfg.exchange != "allgather":
        raise SystemExit("--method pallas runs on the allgather exchange, 1-D mesh")
    if cfg.method == "pallas" and (cfg.verbose or cfg.ckpt_every or cfg.ckpt_dir):
        raise SystemExit(
            "--method pallas: -verbose/checkpointing are not wired to the "
            "kernel path; use --method scan, scatter or mxscan for those")
    if cfg.exchange == "allgather":
        return
    if cfg.sort_segments or cfg.compact_gather:
        raise SystemExit(
            "--sort-segments/--compact-gather relay out the allgather pull "
            "layout; the bucket (ring/scatter) layouts have their own edge "
            "orders and ship their own slices")
    _downgrade_scan_family(cfg, was_auto, f"--exchange {cfg.exchange}")
    if cfg.exchange == "scatter" and (
            prog.reduce != "sum" or getattr(prog, "needs_dst_state", False)):
        raise SystemExit(
            "--exchange scatter needs a sum-reducible program without "
            "per-edge destination reads; use --exchange ring or allgather")


def downgrade_pf(cfg: RunConfig, layout: str) -> None:
    """expand-pf -> expand, with a note: the pass-fused plans bind the
    allgather pull layout, and pf is a bitwise-identical grouping of the
    kernels, so a layout that plans a bucket at a time runs the unfused
    family rather than failing (the reference's one policy for the pull
    apps and the push apps' ring)."""
    import sys

    print(f"# --route-gather expand-pf: {layout} plans per-bucket; running the unfused "
          "'expand' family (bitwise-identical)", file=sys.stderr)
    cfg.route_gather = "expand"


def check_route(cfg: RunConfig, prog) -> None:
    """The reference's --route-gather matrix under --distributed, before
    any set-up: every layout routes in ``expand`` (allgather, the ring
    and reduce-scatter buckets, the edge-sharded chunks, the feat-sharded
    columns; a bucketed layout downgrades expand-pf to expand with a
    note); the fused modes and the pass-fused ones run on the allgather
    exchange alone, and the fused modes only on scalar state; no mode
    combines with --method pallas, --compact-gather, --stream-hbm-gib,
    -verbose or --ckpt-every."""
    if not cfg.route_gather:
        return
    resolve_route_auto(cfg)
    wide = getattr(prog, "k", 1) > 1
    if cfg.route_gather == "expand-pf" and (
            cfg.exchange != "allgather" or cfg.edge_shards > 1 or cfg.feat_shards > 1):
        downgrade_pf(cfg, "this exchange/layout")
    if wide and route_base(cfg.route_gather) == "fused":
        raise SystemExit(
            "--route-gather fused supports scalar vertex state; colfilter's wide "
            "dst-dependent load routes with --route-gather expand (per-column src + "
            "dst plans)")
    expand_only = cfg.route_gather == "expand"
    bucket_ok = cfg.exchange in ("ring", "scatter") and expand_only and not wide
    feat_ok = cfg.feat_shards > 1 and expand_only and cfg.exchange == "allgather"
    e2d_ok = (cfg.edge_shards > 1 and expand_only and cfg.exchange == "allgather"
              and not wide)
    if ((cfg.exchange != "allgather" and not bucket_ok)
            or (cfg.edge_shards > 1 and not e2d_ok)
            or (cfg.feat_shards > 1 and not feat_ok)
            or cfg.method == "pallas" or cfg.compact_gather or cfg.stream_hbm_gib):
        raise SystemExit(
            "--route-gather expand covers every pull layout (allgather, ring/scatter "
            "buckets, edge-sharded chunks, feat-sharded columns); 'fused' and the "
            "pass-fused '-pf' variants are allgather-only, and no mode combines with "
            "--method pallas/--compact-gather/--stream-hbm-gib")
    if cfg.verbose:
        raise SystemExit(_ROUTE_VERBOSE_ERR)
    if cfg.ckpt_every:
        raise SystemExit(
            "--route-gather with checkpointing is a single-device stepping mode; the "
            "distributed chunked driver runs the direct gather — drop one of the flags")


def _downgrade_scan_family(cfg: RunConfig, was_auto: bool, where: str) -> None:
    """The method a bucketed or chunked layout runs (scan or scatter;
    parallel/ring.bucketed_method): an ``auto`` winner it cannot run
    falls back to scan, with a note; an explicit one is refused."""
    import sys

    from lux_tpu_torch.parallel.ring import bucketed_method

    try:
        method = bucketed_method(cfg.method, was_auto)
    except ValueError as e:
        raise SystemExit(f"{where}: {e}")
    if method != cfg.method:
        print(f"# --method auto: the {cfg.method} winner falls back to {method} on "
              f"{where} (bucketed reductions run scan/scatter)", file=sys.stderr)
        cfg.method = method


def _refuse_2d_relayouts(cfg: RunConfig) -> None:
    if cfg.sort_segments or cfg.compact_gather:
        raise SystemExit(
            "--sort-segments/--compact-gather relay out the allgather pull layout; "
            "the edge-sharded and feat-sharded layouts have their own edge orders and "
            "ship their own slices")


def check_feat(cfg: RunConfig, prog, was_auto: bool) -> None:
    """The reference's --feat-shards rules (``lux_tpu.apps.common
    .validate_exchange``): CF's wide state only, --distributed, the
    allgather or ring exchange (scan/scatter on the ring), no pallas, F
    dividing K, and no -verbose or checkpointing; then the grid: the
    ranks a multiple of F, -ng a multiple of the part rows."""
    from lux_tpu_torch.parallel.multihost import dist_world

    F = cfg.feat_shards
    if getattr(prog, "k", 1) <= 1:
        raise SystemExit(
            "--feat-shards shards a wide (V, K) latent state; this app's state has no "
            "feature dim (colfilter only)")
    if not cfg.distributed:
        raise SystemExit("--feat-shards requires --distributed")
    if cfg.exchange not in ("allgather", "ring") or cfg.edge_shards > 1:
        raise SystemExit(
            "--feat-shards (2-D parts x feat mesh) runs on the allgather or ring "
            "exchange; it cannot combine with --exchange scatter or --edge-shards")
    _refuse_2d_relayouts(cfg)
    if cfg.exchange == "ring":
        _downgrade_scan_family(cfg, was_auto, "--feat-shards --exchange ring")
    if cfg.method == "pallas":
        raise SystemExit(
            "--feat-shards supports --method scan/scatter/cumsum/mxsum (the kernel "
            "path has its own distribution)")
    if prog.k % F:
        raise SystemExit(f"--feat-shards {F} must divide the latent dim K={prog.k}")
    if cfg.verbose or cfg.ckpt_every or cfg.ckpt_dir:
        raise SystemExit(
            "--feat-shards: -verbose/checkpointing are not wired to the 2-D feat mesh; "
            "drop --feat-shards for those")
    W = dist_world()
    if W < F:
        raise SystemExit(f"--feat-shards {F}: needs at least that many devices (ranks), "
                         f"{W} available")
    if W % F or cfg.num_parts % (W // F):
        raise SystemExit(
            f"--feat-shards {F}: {W} ranks form {W // F} part rows of {F} feat shards "
            f"only when F divides the rank count and the part rows divide -ng "
            f"({cfg.num_parts})")


def check_edge2d(cfg: RunConfig, prog, was_auto: bool) -> None:
    """The reference's --edge-shards rules: --distributed, the 2-D grid's
    own exchange (not ring/scatter), scan or scatter (an auto winner
    downgraded), one part a part row: -ng x --edge-shards ranks."""
    from lux_tpu_torch.parallel.multihost import dist_world

    if not cfg.distributed:
        raise SystemExit("--edge-shards requires --distributed")
    if cfg.exchange != "allgather":
        raise SystemExit(
            "--edge-shards (2-D mesh) has its own exchange; it cannot combine with "
            "--exchange ring/scatter")
    _refuse_2d_relayouts(cfg)
    if cfg.method == "pallas":
        raise SystemExit("--method pallas runs on the allgather exchange, 1-D mesh")
    if cfg.method in ("cumsum", "mxsum") or (
            cfg.method == "mxscan" and not was_auto):
        raise SystemExit(
            "--edge-shards supports --method scan or scatter (edge chunks carry no "
            "row_ptr for prefix-diff reduces; the mxscan kernel is confined to the csc "
            "engines here)")
    _downgrade_scan_family(cfg, was_auto, "--edge-shards")
    need, W = cfg.num_parts * cfg.edge_shards, dist_world()
    if W != need:
        raise SystemExit(
            f"--edge-shards: {cfg.num_parts} x {cfg.edge_shards} = {need} devices needed "
            f"(one rank each), {W} available")


def refuse_relayouts(cfg: RunConfig) -> None:
    """The reference's refusals of the gather relayouts, with a CLI
    message before any set-up: both relay out the pull layout's src_pos,
    which the block-CSR kernel path (--method pallas) does not use; the
    routed plans and the streamed chunks replay src_pos itself, so they
    take --sort-segments but not the --compact-gather mirror."""
    if cfg.method == "pallas" and (cfg.sort_segments or cfg.compact_gather):
        raise SystemExit(
            "--sort-segments/--compact-gather relay out the pull layout's "
            "gather; the block-CSR (--method pallas) layout has its own edge "
            "order and gather")
    if cfg.compact_gather and cfg.route_gather:
        raise SystemExit(
            "--route-gather plans replay the pull layout's src_pos; it does "
            "not combine with --compact-gather (--sort-segments composes)")
    if cfg.compact_gather and cfg.stream_hbm_gib:
        raise SystemExit(
            "--stream-hbm-gib streams the pull layout's src_pos chunk by "
            "chunk; it does not combine with --compact-gather "
            "(--sort-segments composes)")


def report_layout(kind: str, layout, seconds: float) -> None:
    """The apps' build line: which layout, how many parts, the host path
    that built it (native or numpy) and its seconds."""
    parts = getattr(getattr(layout, "spec", None), "num_parts", 1)
    print(f"layout built: {kind}, {parts} part(s), host path {layout.host_io}, "
          f"{seconds:.3f} s")


def estimate_exchange(shards, cfg: RunConfig, state_width: int = 1,
                      dst_state: bool = False, reduce: str = "sum") -> preflight.MemoryEstimate:
    """The memory estimate of a pull run of ``shards`` on one device: one
    part's arrays, state and per-edge gather (``dst_state``: the program
    reads the destination too), every part resident, plus the routed
    plan of ``cfg.route_gather`` from the geometry (before it is
    built)."""
    sbytes = 2 if cfg.dtype == "bfloat16" else 4
    est = preflight.estimate_pull(shards.spec, state_width, sbytes, dst_state=dst_state,
                                  method=cfg.method, device=cfg.device, reduce=reduce)
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
        t0 = time.perf_counter()
        bc = spmv.build_blockcsr(g)
        report_layout("block-CSR", bc, time.perf_counter() - t0)
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
    resolved): the shards (with the gather relayouts of the flags), the
    printed estimate, the kernel build, the device arrays and the routed
    plan."""
    t0 = time.perf_counter()
    shards = build_pull_shards(g, cfg.num_parts, sort_segments=cfg.sort_segments,
                               compact_gather=cfg.compact_gather)
    report_layout("pull", shards, time.perf_counter() - t0)
    report_preflight(estimate_exchange(shards, cfg, state_width,
                                       dst_state=prog.needs_dst_state,
                                       reduce=prog.reduce), dev)
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
    holds one (``--distributed`` runs :func:`run_dist_app` instead).
    Returns (the (nv, ...) float32 state on the host, the timed seconds,
    the iterations this run executed)."""
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


def resume_or_init(cfg: RunConfig, app: str, shards, state, nv: int, pg=None):
    """Elastic resume: restack the latest global checkpoint of
    ``--ckpt-dir`` (any previous -ng, exchange or rank count) onto THIS
    run's layout, cast to this run's state dtype; under --distributed
    (``pg``) this rank's parts of it.  Returns (state, start_iteration)."""
    if not cfg.ckpt_dir:
        return state, 0
    saved, start_it, prev = checkpoint.load_resume(cfg.ckpt_dir, app, nv)
    if saved is None:
        return state, 0
    if isinstance(saved, torch.Tensor):  # bfloat16: restack its f32 widening
        saved = saved.float().numpy()
    stacked = global_to_stacked(shards.cuts, shards.spec.nv_pad, np.asarray(saved))
    if pg is not None:
        stacked = stacked[pg.lo:pg.hi]
    if main_rank():
        print(f"resumed from {prev} at iteration {start_it}")
    return torch.from_numpy(stacked).to(device=state.device, dtype=state.dtype), start_it


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
            or cfg.repartition_every or cfg.route_gather or cfg.edge_shards > 1
            or cfg.feat_shards > 1):
        raise SystemExit(
            "--stream-hbm-gib is the single-process host-offload mode; it "
            "does not combine with --method pallas/-verbose/checkpointing/"
            "--repartition-every/--route-gather/--edge-shards/--feat-shards")
    validate_exchange(cfg, prog, dev)
    sbytes = 2 if cfg.dtype == "bfloat16" else 4
    t0 = time.perf_counter()
    shards = build_pull_shards(g, cfg.num_parts, sort_segments=cfg.sort_segments)
    report_layout("pull (streamed)", shards, time.perf_counter() - t0)
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


def timed_iterations(iterate, state, n: int, dev, barrier=None) -> float:
    """Seconds of ``n`` iterations in place on ``state``, device-fenced:
    the apps' one definition of the iteration time.  The same ``n``
    iterations run first on a copy of the state, untimed, so first-launch
    costs (kernel module loading, allocator growth, the card's clocks
    rising from idle) stay out of it.  ``barrier`` (distributed runs)
    lines the ranks up before the timer starts."""
    iterate(state.clone(), n)
    if barrier is not None:
        barrier()
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


def report_plan(build, show: bool = True):
    """Run a cached planner call ``build()`` and print (``show``) whether
    its entries were loaded from the plan disk cache
    (``LUX_TORCH_PLAN_CACHE``) or built, and the seconds it took
    (ops/expand.plan_stats_snapshot).  Returns the plan."""
    before = expand.plan_stats_snapshot()
    plan = build()
    after = expand.plan_stats_snapshot()
    built = after["built"] - before["built"]
    loaded = after["loaded"] - before["loaded"]
    secs = (after["cold_s"] - before["cold_s"]) + (after["warm_s"] - before["warm_s"])
    how = "built" if built and not loaded else "loaded" if loaded and not built \
        else f"built {built} / loaded {loaded}"
    if show:
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


def build_push_route(cfg: RunConfig, shards, rows=None, show: bool = True):
    """The push apps' --route-gather plan (host set-up, outside the timed
    window): on the ring exchange the bucket plans of the ring push
    layout, else the expand plan of the push shards' embedded pull layout
    (``rows``: a rank's parts only), pass-fused for 'expand-pf', through
    the plan disk cache as in :func:`build_pull_route`; '' = None.  The
    dense rounds route their gather only, so there is no fused form."""
    if not cfg.route_gather:
        return None
    resolve_route_auto(cfg)
    if cfg.exchange == "ring":
        return report_plan(lambda: expand.plan_ring_route_shards_cached(shards), show)
    pf = route_is_pf(cfg.route_gather)
    return report_plan(lambda: expand.plan_expand_shards_cached(shards.pull, pf=pf, rows=rows),
                       show)


def _resident_rows(pg, arrays) -> list:
    """This rank's rows of a stacked layout: its parts of all P rows, or
    every row of a subset build of its k."""
    n = arrays.src_pos.shape[0]
    return list(pg.parts) if n == pg.num_parts else list(range(n))


def _dist_planner(cfg: RunConfig, layout, prog, pg, grid, template):
    """The cached planner call of this rank's --route-gather plan."""
    rg = cfg.route_gather
    if grid is not None and grid.axis == "edge":
        return lambda: expand.plan_edge2d_route_shards_cached(layout)
    if cfg.exchange == "ring":
        return lambda: expand.plan_ring_route_shards_cached(layout)
    if cfg.exchange == "scatter":
        return lambda: expand.plan_scatter_route_shards_cached(layout)
    rows, pf = _resident_rows(pg, layout.arrays), route_is_pf(rg)
    if template is not None:
        return lambda: expand.plan_fused_shards_cached(
            layout, prog.reduce, pf=pf, mx=route_mx(rg), rows=rows, template=template)
    if getattr(prog, "k", 1) > 1:
        return lambda: expand.plan_cf_route_shards_cached(layout, pf=pf, rows=rows)
    return lambda: expand.plan_expand_shards_cached(layout, pf=pf, rows=rows)


def _agree_planned(err) -> None:
    """Every rank's plan made (``err`` None here), agreed in one
    all-reduce every rank takes; else every rank exits, naming the
    error where it happened."""
    from lux_tpu_torch.parallel import dist

    if not dist.agree_ok(err is None):
        raise SystemExit(f"--route-gather: the routed plan failed on "
                         f"{'this rank' if err else 'another rank'}"
                         + (f": {err}" if err else ""))


def build_dist_route(cfg: RunConfig, layout, prog, pg, grid=None):
    """This rank's --route-gather plan under --distributed (host set-up,
    before the first exchange), through the plan disk cache: the rows of
    its own parts (allgather, feat: the pull layout's; the fused modes
    against the group template agreed over the ranks), the buckets of
    its ring or reduce-scatter build, its edge2d cell; '' = None.  The
    ranks then agree that every plan was made, in one all-reduce, so a
    rank whose plan failed fails every rank instead of leaving them in
    the first exchange.  Rank 0 prints the load line.  Returns the
    stacked (static, arrays) plan of this rank's rows."""
    if not cfg.route_gather:
        return None
    from lux_tpu_torch.parallel import dist

    rg, show = cfg.route_gather, main_rank()
    plan, err, template = None, None, None
    if route_base(rg) == "fused":
        try:
            local = expand._group_template(layout.arrays, _resident_rows(pg, layout.arrays))
        except Exception as e:  # every rank still takes the template's collective
            local, err = None, e
        try:
            template = dist.agree_template(pg, local)
        except RuntimeError as e:
            err = err or e
    try:
        if err is None:
            plan = report_plan(_dist_planner(cfg, layout, prog, pg, grid, template), show)
    except Exception as e:  # agreed on below, by every rank
        err = e
    _agree_planned(err)
    return plan


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


# ---------------------------------------------------------------------------
# --distributed: the parts spread over the ranks of torch.distributed
# ---------------------------------------------------------------------------


def main_rank() -> bool:
    """Whether this process prints the run's result lines: rank 0 of a
    distributed run, or the only process."""
    import torch.distributed as tdist

    return not (tdist.is_available() and tdist.is_initialized()) or tdist.get_rank() == 0


def make_mesh_if(cfg: RunConfig, dev):
    """This rank's parallel.mesh.PartsGroup under --distributed (joining
    the process group: parallel/multihost.initialize reads the launcher's
    environment and LUX_DIST_BACKEND), its mesh.Grid2D under
    --edge-shards or --feat-shards, else None."""
    if not cfg.distributed:
        return None
    from lux_tpu_torch.parallel import multihost

    try:
        if cfg.edge_shards > 1:
            return multihost.initialize_grid(cfg.num_parts, cfg.edge_shards, "edge", dev)
        if cfg.feat_shards > 1:
            return multihost.initialize_grid(cfg.num_parts, cfg.feat_shards, "feat", dev)
        return multihost.initialize(cfg.num_parts, dev)
    except ValueError as e:
        raise SystemExit(f"--distributed: {e}")


def require_parts_fit_devices(cfg: RunConfig, pg, what: str) -> None:
    """One part a rank: the block-CSR engine keeps no k resident parts
    (allgather, ring and scatter do)."""
    if cfg.num_parts != pg.world:
        raise SystemExit(
            f"{what} keeps one part a rank; -ng must equal the rank count "
            f"({pg.world} ranks; allgather/ring/scatter support several resident "
            "parts a rank)")


def build_exchange_shards(g: HostGraph, cfg: RunConfig, pg, grid=None):
    """This rank's layout for the selected exchange: the block-CSR parts
    (--method pallas, its one part), its (part, chunk) of the 2-D edge
    grid (``grid``, --edge-shards; with -file read by pread), the pull
    shards (allgather and the feat grid: this rank's parts from the
    file's byte ranges with -file, else built), or the ring /
    reduce-scatter buckets of its parts over the same pull geometry."""
    from lux_tpu_torch.graph import sharded_load

    P, mine = cfg.num_parts, list(pg.parts)
    if cfg.edge_shards > 1:
        from lux_tpu_torch.parallel.edge2d import build_edge2d_shards

        return build_edge2d_shards(g, P, cfg.edge_shards, parts_subset=mine,
                                   chunks_subset=[grid.index], path=cfg.file)
    if cfg.method == "pallas":
        from lux_tpu_torch.parallel import pallas_dist

        return pallas_dist.build_pallas_parts(g, P, parts_subset=mine)
    if cfg.file:
        pull_sh = sharded_load.load_pull_shards(
            cfg.file, P, parts_subset=mine, sort_segments=cfg.sort_segments,
            compact_gather=cfg.compact_gather)
    else:
        pull_sh = build_pull_shards(g, P, sort_segments=cfg.sort_segments,
                                    compact_gather=cfg.compact_gather)
    if cfg.exchange == "allgather":
        return pull_sh
    if cfg.exchange == "ring":
        from lux_tpu_torch.parallel.ring import build_ring_shards

        return build_ring_shards(g, P, parts_subset=mine, pull=pull_sh)
    from lux_tpu_torch.parallel.scatter import build_scatter_shards

    return build_scatter_shards(g, P, parts_subset=mine, pull=pull_sh)


def estimate_dist(layout, cfg: RunConfig, pg, state_width: int = 1,
                  dst_state: bool = False, reduce: str = "sum") -> preflight.MemoryEstimate:
    """One rank's memory estimate: its k resident parts of the exchange's
    layout, plus the gathered (P*V, ...) state of the allgather and the
    block-CSR pull, plus the --route-gather plans of its resident parts
    (preflight.routed_plan_bytes_analytic, or the bucket plans':
    routed_bucket_plan_bytes_analytic)."""
    est = _estimate_dist_layout(layout, cfg, pg, state_width, dst_state, reduce)
    if not cfg.route_gather:
        return est
    # the routed plans are static device arrays a resident part, charged
    # from the geometry before any is built
    spec = layout.spec
    if cfg.edge_shards > 1:
        extra = preflight.routed_bucket_plan_bytes_analytic(
            1, layout.e2_pad, spec.num_parts * spec.nv_pad)
    elif cfg.exchange in ("ring", "scatter"):
        extra = pg.k * preflight.routed_bucket_plan_bytes_analytic(
            spec.num_parts, layout.e_bucket_pad, spec.nv_pad)
    else:
        extra = pg.k * preflight.routed_plan_bytes_analytic(
            spec, cfg.route_gather, wide=state_width > 1)
    return preflight.add_routed_bytes(est, extra)


def _estimate_dist_layout(layout, cfg: RunConfig, pg, state_width: int,
                          dst_state: bool, reduce: str) -> preflight.MemoryEstimate:
    sbytes = 2 if cfg.dtype == "bfloat16" else 4
    spec = layout.spec
    if cfg.edge_shards > 1:
        return preflight.estimate_edge2d(spec, layout.e2_pad, state_width, sbytes)
    if cfg.feat_shards > 1:
        state_width //= cfg.feat_shards  # a rank holds K/F features of its parts
    gathered = spec.gathered_size * state_width * sbytes
    if cfg.method == "pallas":
        a = layout.arrays
        wide = state_width > 1
        est = preflight.estimate_pallas_pull(
            a.e_src_pos.shape[1], layout.t_chunk, layout.num_vblocks * layout.v_blk,
            state_width, weighted=wide, degree=not wide, dst_state=wide,
            state_dtype_bytes=sbytes)
        return preflight.add_gathered_bytes(est, gathered)
    if cfg.exchange == "ring":
        return preflight.scale_residency(preflight.estimate_ring(
            spec, layout.e_bucket_pad, state_width, sbytes), pg.k)
    if cfg.exchange == "scatter":
        return preflight.scale_residency(preflight.estimate_scatter(
            spec, layout.e_bucket_pad, state_width, sbytes), pg.k)
    est = preflight.estimate_pull(spec, state_width, sbytes, dst_state=dst_state,
                                  method=cfg.method, device=pg.device.type, reduce=reduce)
    return preflight.add_gathered_bytes(preflight.scale_residency(est, pg.k), gathered)


@dataclasses.dataclass
class DistSetup:
    """One rank's distributed run: its layout with the arrays it reads
    placed on its device once, the exchange and the method."""

    prog: object
    pg: object
    layout: object
    exchange: str
    method: str
    pallas: bool
    arrays: object = None  # allgather: this rank's (k, ...) ShardArrays
    #: --edge-shards / --feat-shards: this rank's mesh.Grid2D (``pg`` is
    #: then its parts-axis group)
    grid: object = None
    #: --route-gather: this rank's rows of the routed plan, on its device
    #: (parallel/mesh.place_plan), or None
    route: object = None

    def initial(self):
        """This rank's initial (k, V, ...) block on its device, from the
        placed layout's vertex arrays."""
        from lux_tpu_torch.parallel import feat, pallas_dist

        prog, grid = self.prog, self.grid
        if grid is not None and grid.axis == "feat":
            view = self.arrays if self.arrays is not None else self.layout.pull.arrays
            return feat.init_state_feat(prog, view, grid)
        if self.pallas:
            return pallas_dist.init_state_pallas(prog, self.layout).to(self.pg.device)
        if self.arrays is not None:
            return pull.init_state(prog, self.arrays)
        if grid is not None:  # the edge grid's placed cells
            return pull.init_state(prog, self.layout.arrays)
        return pull.init_state(prog, self.layout.pull.arrays)

    def iterate(self, state, n: int) -> None:
        """n iterations in place on this rank's (k, V, ...) block."""
        from lux_tpu_torch.parallel import dist, edge2d, feat, pallas_dist, ring, scatter

        prog, pg, lay, route = self.prog, self.pg, self.layout, self.route
        if self.grid is not None and self.grid.axis == "edge":
            out = edge2d.run_pull_fixed_2d(prog, lay, state, n, self.grid, self.method,
                                           route=route)
        elif self.grid is not None and self.exchange == "ring":
            out = feat.run_cf_feat_ring(prog, lay, state, n, self.grid, self.method)
        elif self.grid is not None:
            out = feat.run_cf_feat_dist(prog, lay.spec, self.arrays, state, n, self.grid,
                                        self.method, route=route)
        elif self.pallas:
            run = (pallas_dist.run_cf_pallas_dist if prog.needs_dst_state
                   else pallas_dist.run_pull_fixed_pallas_dist)
            out = run(prog, lay, state, n, pg)
        elif self.exchange == "ring":
            out = ring.run_pull_fixed_ring(prog, lay, state, n, pg, self.method, route=route)
        elif self.exchange == "scatter":
            out = scatter.run_pull_fixed_scatter(prog, lay, state, n, pg, self.method,
                                                 route=route)
        else:
            out = dist.run_pull_fixed_dist(prog, lay.spec, self.arrays, state, n, pg,
                                           self.method, route=route)
        state.copy_(out)

    def assemble(self, state) -> Optional[np.ndarray]:
        """The stacked (P, V, ...) global state on rank 0 (float32), None
        elsewhere (every rank takes part)."""
        from lux_tpu_torch.parallel import edge2d, feat, multihost

        if self.grid is None:
            return multihost.assemble_global(self.pg, state)
        mod = edge2d if self.grid.axis == "edge" else feat
        return mod.assemble_global(self.grid, state)

    def read(self, state) -> Optional[np.ndarray]:
        """The (nv, ...) global state on rank 0 (float32), None elsewhere."""
        stacked = self.assemble(state)
        return None if stacked is None else self.layout.scatter_to_global(stacked)

    def barrier(self) -> None:
        """Line up every rank of the run (the whole grid under a 2-D mesh)."""
        import torch.distributed as tdist

        if self.grid is None:
            self.pg.barrier()
        else:
            tdist.barrier()

    def exchange_split(self, state, n: int) -> dict:
        """ms an iteration of n more iterations on a copy of ``state``,
        split into compute, staging (device blocks through the pinned
        host buffers) and collective, with every exchange fenced; the
        fences make the whole slower than the unfenced run."""
        from lux_tpu_torch.parallel.mesh import ExchangeTimes

        pg = self.pg
        work = state.clone()
        pg.timed, pg.times = True, ExchangeTimes()
        try:
            t0 = pg.fence()
            self.iterate(work, n)
            total = pg.fence() - t0
        finally:
            pg.timed = False
        t = pg.times
        per = 1e3 / max(n, 1)
        out = {"ms_per_iter": total * per,
               "compute_ms": (total - t.stage_s - t.collective_s) * per,
               "staging_ms": t.stage_s * per, "collective_ms": t.collective_s * per,
               "exchanges": t.calls, "backend": pg.backend, "ranks": pg.world,
               "resident_parts": pg.k, "staged": pg.staged}
        if self.grid is not None:
            out.update(ranks=self.grid.world,
                       grid=f"{pg.world}x{self.grid.size} {self.grid.axis}")
        return out


def setup_dist(cfg: RunConfig, g: HostGraph, dev, prog, state_width: int = 1):
    """This rank's set-up: join the group, build its layout (printed on
    rank 0), check its memory estimate against its device, build the
    kernels, make its --route-gather plan (:func:`build_dist_route`: its
    rows only, agreed over the ranks before the first exchange), place
    the arrays and the plan; returns (DistSetup, its initial (k, V, ...)
    block on the device)."""
    from lux_tpu_torch.parallel.mesh import shard_stacked
    from lux_tpu_torch.parallel.ring import vertex_view

    grid = pg = make_mesh_if(cfg, dev)
    if cfg.edge_shards > 1 or cfg.feat_shards > 1:
        pg = grid.parts
    else:
        grid = None
    pallas = cfg.method == "pallas"
    if pallas:
        require_parts_fit_devices(cfg, pg, "--method pallas")
    t0 = time.perf_counter()
    layout = build_exchange_shards(g, cfg, pg, grid)
    kind = "block-CSR" if pallas else cfg.exchange
    if grid is not None:
        kind = f"{kind} on a {pg.world}x{grid.size} {grid.axis} grid"
    world = pg.world if grid is None else grid.world
    est = estimate_dist(layout, cfg, pg, state_width, dst_state=prog.needs_dst_state,
                        reduce=prog.reduce)
    if main_rank():
        report_layout(f"{kind} (rank 0 of {world})", layout, time.perf_counter() - t0)
        print(est)
    # the 1-D allgather pull's hint names the --edge-shards a grid of these
    # ranks could run
    hint = grid is None and cfg.exchange == "allgather" and not pallas
    preflight.check_fits(est, device=pg.device, spec=layout.spec if hint else None,
                         state_width=state_width,
                         state_dtype_bytes=2 if cfg.dtype == "bfloat16" else 4,
                         max_edge_shards=world // cfg.num_parts if hint else 0)
    if pg.device.type == "cuda":
        cuda_build.load_all()
    route = build_dist_route(cfg, layout, prog, pg, grid)
    if route is not None:
        from lux_tpu_torch.parallel.mesh import place_plan

        route = place_plan(pg, route)
    arrays = None
    if grid is not None and grid.axis == "edge":
        from lux_tpu_torch.parallel.edge2d import place_cells

        layout = place_cells(layout, pg.device)
    elif grid is not None and cfg.exchange == "allgather":
        arrays = shard_stacked(pg, layout.arrays)
    elif pallas:
        layout = dataclasses.replace(layout, arrays=shard_stacked(pg, layout.arrays))
    elif cfg.exchange == "allgather":
        arrays = shard_stacked(pg, layout.arrays)
    else:
        # the buckets and the per-vertex view go to the device; the pull
        # layout's O(E) arrays never do
        view = vertex_view(pg, layout.pull.arrays)
        layout = dataclasses.replace(
            layout, pull=dataclasses.replace(layout.pull, arrays=view),
            **{f: shard_stacked(pg, getattr(layout, f)) for f in ("rarrays", "sarrays")
               if hasattr(layout, f)})
    ds = DistSetup(prog, pg, layout, cfg.exchange, cfg.method, pallas, arrays, grid, route)
    return ds, ds.initial()


def run_dist_app(cfg: RunConfig, g: HostGraph, dev, prog, app: str, state_width: int = 1):
    """:func:`run_pull_app` under --distributed: this rank's set-up, then
    the timed ``-ni`` iterations (an untimed run first, the ranks lined
    up by a barrier before the timer), or with ``-verbose`` (allgather)
    the fenced load/comp/update loop, or with ``--ckpt-every`` chunks
    with a checkpoint between them, from the latest checkpoint when
    ``--ckpt-dir`` holds one.  With ``-verbose`` rank 0 also prints the
    exchange's split of an iteration (compute, staging, collective) from
    a further fenced run (DistSetup.exchange_split).  Returns (the (nv,
    ...) state on rank 0, else None; seconds; the iterations this run
    executed; (this rank's DistSetup, its final (k, V, ...) block))."""
    validate_exchange(cfg, prog, dev)
    ds, state = setup_dist(cfg, g, dev, prog, state_width)
    state, start_it = resume_or_init(cfg, app, ds.layout, state, g.nv, ds.pg)
    n = max(cfg.num_iters - start_it, 0)
    stepwise = cfg.verbose and cfg.exchange == "allgather" and ds.grid is None
    if cfg.verbose and not stepwise and main_rank():
        print("note: -verbose per-iteration stepping is an allgather-exchange mode; "
              "this run stays fused")
    # rank 0 traces (one trace directory, one event-log table)
    with profiling.trace(cfg.profile_dir if main_rank() else None, ds.pg.device):
        if stepwise:
            ds.iterate(state.clone(), n)
            state, stats = run_pull_stepwise_dist(ds, state, start_it, cfg, g.nv, app)
            elapsed = stats.seconds
        elif cfg.ckpt_every:
            state, elapsed = run_fixed_dist_chunked(ds, state, start_it, cfg, app)
        else:
            elapsed = timed_iterations(ds.iterate, state, n, ds.pg.device, ds.barrier)
    if cfg.verbose and n:
        split = ds.exchange_split(state, n)
        if main_rank():
            print("exchange: " + json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                                             for k, v in split.items()}))
    return ds.read(state), elapsed, n, (ds, state)


def save_global(cfg: RunConfig, app: str, shards, iteration: int, state, ds=None):
    """Checkpoint the stacked device state as the layout-independent
    global vector (elastic: any later -ng can resume it); under
    --distributed (``ds``, this rank's DistSetup) ``state`` is this
    rank's block, gathered to rank 0, which writes."""
    if ds is not None:
        stacked = ds.assemble(state)
        if stacked is None:
            return None
        glob = shards.scatter_to_global(stacked)
        if state.dtype == torch.bfloat16:
            glob = torch.from_numpy(glob).to(torch.bfloat16)
        return checkpoint.save_iteration(cfg.ckpt_dir, iteration, glob, app)
    host = state.cpu()
    if host.dtype == torch.bfloat16:
        glob = torch.from_numpy(shards.scatter_to_global(host.float().numpy()))
        glob = glob.to(torch.bfloat16)
    else:
        glob = shards.scatter_to_global(host.numpy())
    return checkpoint.save_iteration(cfg.ckpt_dir, iteration, glob, app)


def run_pull_stepwise_dist(ds: DistSetup, state, start_it: int, cfg: RunConfig, nv: int,
                           app: str):
    """The -verbose distributed loop: each iteration fenced into the
    load (with the exchange) / comp / update phases of
    parallel/dist.compile_pull_phases_dist, times printed by rank 0;
    checkpoints between iterations as run_pull_stepwise takes them.
    Returns (final block, IterStats)."""
    from lux_tpu_torch.parallel import dist

    stats = IterStats(verbose=cfg.verbose and main_rank())
    load, comp, update = dist.compile_pull_phases_dist(ds.prog, ds.pg, ds.method)
    for it in range(start_it, cfg.num_iters):
        t = Timer(ds.pg.device)
        gath = load(ds.arrays, state)
        lt = t.stop()
        t = Timer(ds.pg.device)
        acc = comp(ds.arrays, gath)
        ct = t.stop()
        t = Timer(ds.pg.device)
        state = update(ds.arrays, state, acc)
        stats.record_phases(it, nv, lt, ct, t.stop())
        if cfg.ckpt_every and (it + 1) % cfg.ckpt_every == 0:
            save_global(cfg, app, ds.layout, it + 1, state, ds)
    return state, stats


def run_fixed_dist_chunked(ds: DistSetup, state, start_it: int, cfg: RunConfig, app: str):
    """The distributed run in --ckpt-every-sized chunks with a checkpoint
    between them (rank 0 writes).  Returns (state, compute seconds): the
    checkpoint I/O stays out of the reported time."""
    compute = 0.0
    it = start_it
    while it < cfg.num_iters:
        n = min(cfg.ckpt_every, cfg.num_iters - it)
        t = Timer(ds.pg.device)
        ds.iterate(state, n)
        compute += t.stop()
        it += n
        if it < cfg.num_iters or cfg.num_iters % cfg.ckpt_every == 0:
            save_global(cfg, app, ds.layout, it, state, ds)
    return state, compute


def finish_dist(cfg: RunConfig, rc: int) -> int:
    """Under --distributed every rank returns the largest rank's exit
    code (a -check failure on rank 0 fails them all)."""
    if not cfg.distributed:
        return rc
    from lux_tpu_torch.parallel import multihost

    return multihost.agree_max(rc)


def leave_group() -> None:
    """The CLI's exit: leave the process group a --distributed run
    joined."""
    from lux_tpu_torch.parallel import multihost

    multihost.shutdown()


# ---------------------------------------------------------------------------
# --distributed on the push apps (SSSP, components): the distributed push
# ---------------------------------------------------------------------------


def push_exchange_split(pg, converge) -> dict:
    """ms an iteration of one more ``converge()`` (which returns the final
    carry) with every exchange of the group ``pg`` fenced, split into
    compute, staging (device blocks through the pinned host buffers) and
    collective; the fences make it slower than the unfenced run."""
    from lux_tpu_torch.parallel.mesh import ExchangeTimes

    pg.timed, pg.times = True, ExchangeTimes()
    try:
        t0 = pg.fence()
        out = converge()
        total = pg.fence() - t0
    finally:
        pg.timed = False
    t, n = pg.times, max(out.it, 1)
    per = 1e3 / n
    return {"ms_per_iter": total * per,
            "compute_ms": (total - t.stage_s - t.collective_s) * per,
            "staging_ms": t.stage_s * per, "collective_ms": t.collective_s * per,
            "exchanges": t.calls, "iterations": out.it, "backend": pg.backend,
            "ranks": pg.world, "resident_parts": pg.k, "staged": pg.staged}


def estimate_push_dist(shards, cfg: RunConfig, pg) -> preflight.MemoryEstimate:
    """One rank's memory estimate of the distributed push: its k resident
    parts of the exchange's layout (the allgather push shards, the ring
    push buckets, the block-CSR push's one part), plus the exchanged
    frontier queues, and for the allgather the gathered (P*V) state; with
    --route-gather the dense rounds' plans of its parts."""
    spec, pspec = shards.spec, shards.pspec
    if cfg.method == "pallas":
        return preflight.estimate_push_pallas(spec, pspec, shards.pl.e_src_pos.shape[1],
                                              shards.t_chunk)
    if cfg.exchange == "ring":
        est = preflight.scale_residency(
            preflight.estimate_push_ring(spec, pspec, shards.e_bucket_pad), pg.k)
        extra = preflight.routed_bucket_plan_bytes_analytic(
            spec.num_parts, shards.e_bucket_pad, spec.nv_pad)
    else:
        est = preflight.add_gathered_bytes(
            preflight.scale_residency(preflight.estimate_push(spec, pspec), pg.k),
            spec.gathered_size * 4 + preflight.push_exchange_bytes(spec, pspec))
        extra = preflight.routed_plan_bytes_analytic(spec, "expand")
    if cfg.route_gather:  # the dense rounds' plans, a resident part each
        est = preflight.add_routed_bytes(est, pg.k * extra)
    return est


def setup_push_dist(cfg: RunConfig, g: HostGraph, dev, prog):
    """This rank's set-up of a distributed push app: join the group, build
    its layout (the block-CSR and ring layouts only its own parts' chunks
    and buckets; printed on rank 0 with the memory estimate), check the
    estimate against its device before anything lands there, build the
    kernels, make and place its --route-gather plan, place its statics.  Returns (engine/push.PushLayout, the
    estimate)."""
    from lux_tpu_torch.engine import push
    from lux_tpu_torch.graph.push_shards import build_push_shards
    from lux_tpu_torch.parallel import pallas_dist, ring

    pg = make_mesh_if(cfg, dev)
    P, mine = cfg.num_parts, list(pg.parts)
    t0 = time.perf_counter()
    if cfg.method == "pallas":
        require_parts_fit_devices(cfg, pg, "--method pallas")
        shards, kind = pallas_dist.build_push_pallas_shards(g, P, parts_subset=mine), \
            "push + block-CSR"
    elif cfg.exchange == "ring":
        shards, kind = ring.build_push_ring_shards(g, P, parts_subset=mine), "push + ring"
    else:
        shards = build_push_shards(g, P, sort_segments=cfg.sort_segments,
                                   compact_gather=cfg.compact_gather)
        kind = "push"
    est = estimate_push_dist(shards, cfg, pg)
    if main_rank():
        report_layout(f"{kind} (rank 0 of {pg.world})", getattr(shards, "push", shards),
                      time.perf_counter() - t0)
        print(est)
    preflight.check_fits(est, device=pg.device)
    if pg.device.type == "cuda":
        cuda_build.load_all()
    route = build_push_dist_route(cfg, shards, pg)
    return push.place_layout(prog, shards, pg, cfg.method, route=route), est


def build_push_dist_route(cfg: RunConfig, shards, pg):
    """This rank's --route-gather plan of the distributed push (the ring
    build's bucket plans, else its parts' rows of the pull layout's
    expand plan), on its device, the ranks agreeing that every plan was
    made before the first exchange; '' = None."""
    if not cfg.route_gather:
        return None
    from lux_tpu_torch.parallel.mesh import place_plan

    plan, err = None, None
    try:
        rows = None if cfg.exchange == "ring" else _resident_rows(pg, shards.pull.arrays)
        plan = build_push_route(cfg, shards, rows=rows, show=main_rank())
    except Exception as e:  # agreed on below, by every rank
        err = e
    _agree_planned(err)
    return place_plan(pg, plan)
