"""Generic spec-workload driver: ``python -m lux_tpu_torch.apps.run <program>``.

Counterpart of ``lux_tpu.apps.run``: one driver for every declarative
workload.  It owns the CLI boilerplate — graph load, flag validation, the
method checks and the memory estimate (apps/common), the shard build,
``--route-gather``, timing, the [PASS]/[FAIL] ``-check`` verdict — so a
workload is a spec in :mod:`lux_tpu_torch.program.library` plus a runner
entry here.  Runs on the card unless ``--device cpu``.

Shipped programs:

  bfs        multi-source BFS on the frontier/push engine (``--sources``;
             ``--engine pull`` runs the pull-until surface — bitwise the
             same distances); the push apps' flags apply (-verbose,
             --max-iters, --route-gather expand|expand-pf, --distributed
             with --exchange allgather|ring, routed there too; the pull
             surface routes single-device runs only)
  kcore      k-core decomposition by iterative peel (``--kmax``); runs on
             the symmetrized simple view unless ``--directed``
  labelprop  seeded multi-class label propagation (dense pull, wide
             (V, --labels) state; seeds every ``--seed-stride``)
  triangles  weighted triangle counting — the two-phase intersection
             program (symmetrized view; unit weights when the input
             graph is unweighted)

``--distributed`` spreads the -ng parts over the ranks of
torch.distributed (``python -m torch.distributed.run --nproc-per-node W
-m lux_tpu_torch.apps.run <program> --distributed ...``): bfs on the
distributed push (or pull-until) engine, kcore's levels on the
distributed pull-until, labelprop on the distributed pull, all on the
allgather exchange (bfs also the ring); rank 0 prints.

Timing: the set-up (graph, layout, routed plan, host-to-device copy,
kernel build) comes first, then one untimed run of the workload, then the
timed one, device-fenced (the ranks lined up by a barrier first).  GTEPS
as the reference's bench rows count it: bfs the edges traversed, kcore ne
per peel round, labelprop ne per iteration, triangles ne per phase (two).

The four reference apps keep their own CLIs
(``lux_tpu_torch.apps.{pagerank,sssp,components,colfilter}``).
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Optional

import numpy as np

from lux_tpu_torch.apps import common
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.shards import build_pull_shards
from lux_tpu_torch.ops import cuda_build, expand
from lux_tpu_torch.program import library, workloads
from lux_tpu_torch.program.spec import bind
from lux_tpu_torch.utils.config import RunConfig, parse_args
from lux_tpu_torch.utils.device import resolve_device
from lux_tpu_torch.utils import preflight, profiling
from lux_tpu_torch.utils.timing import Timer, report_elapsed


@dataclasses.dataclass
class SpecRunResult:
    rc: int  # 0, or 1 when -check failed
    graph: HostGraph  # the graph the program ran on (kcore/triangles: its view)
    #: bfs distances (nv,) int32, kcore coreness (nv,) int32, labelprop
    #: probabilities (nv, L) float32, triangles incidence (nv,) float32
    state: np.ndarray
    iters: int  # bfs iterations, kcore peel rounds, labelprop -ni, triangles 2
    seconds: float  # the timed run, device-fenced
    gteps: float
    method: str  # the resolved segment-reduction method
    route_gather: str = ""  # the routed mode that ran ("" = direct)
    #: per program: bfs traversed edges and dense rounds, kcore k_max,
    #: triangles the totals and bitset words
    stats: dict = dataclasses.field(default_factory=dict)
    estimate_bytes: int = 0  # the memory estimate printed before set-up


def _parse_sources(cfg, nv: int):
    try:
        srcs = [int(s) for s in cfg.sources.split(",") if s.strip()]
    except ValueError:
        raise SystemExit(f"--sources must be comma-separated vertex ids, "
                         f"got {cfg.sources!r}")
    if not srcs:
        raise SystemExit("--sources needs at least one vertex")
    for s in srcs:
        if not 0 <= s < nv:
            raise SystemExit(f"--sources vertex {s} out of range [0, {nv})")
    return srcs


def _require_allgather(cfg, what: str) -> None:
    if cfg.exchange != "allgather" or cfg.edge_shards > 1 or cfg.feat_shards > 1:
        raise SystemExit(
            f"{what} runs on the allgather pull layout; --exchange "
            "ring/scatter, --edge-shards and --feat-shards are not "
            "wired to this workload")


def _check_verdict(cfg, name: str, violations) -> int:
    """The -check verdict (rank 0 under --distributed); ``violations()``
    runs only under -check."""
    if not cfg.check or not common.main_rank():
        return 0
    return 0 if common.print_check(name, violations()) else 1


def _say(line: str) -> None:
    """Print a result line: the only process, or rank 0."""
    if common.main_rank():
        print(line)


def _dist_set_up(cfg: RunConfig, g: HostGraph, prog, dev, state_width: int = 1):
    """A pull workload's set-up under --distributed: the method checks,
    this rank's group, the pull shards with its resident parts on its
    device, the memory estimate (printed by rank 0), the kernel build.
    Returns (shards, group, the estimate's bytes)."""
    from lux_tpu_torch.parallel.mesh import shard_stacked

    common.validate_exchange(cfg, prog, dev)
    if cfg.method == "pallas":
        raise SystemExit("--method pallas runs the block-CSR kernel path of the "
                         "pagerank and colfilter apps; the spec workloads reduce "
                         "through the pull engine")
    pg = common.make_mesh_if(cfg, dev)
    t0 = time.perf_counter()
    shards = build_pull_shards(g, cfg.num_parts)
    est = common.estimate_dist(shards, cfg, pg, state_width, reduce=prog.reduce)
    if common.main_rank():
        common.report_layout(f"allgather (rank 0 of {pg.world})", shards,
                             time.perf_counter() - t0)
        print(est)
    preflight.check_fits(est, device=pg.device)
    if pg.device.type == "cuda":
        cuda_build.load_all()
    shards = dataclasses.replace(shards, arrays=shard_stacked(pg, shards.arrays))
    return shards, pg, est.total_bytes


def _pull_set_up(cfg: RunConfig, g: HostGraph, prog, dev, route,
                 state_width: int = 1, dst_state: bool = False):
    """The pull programs' set-up: method checks, shards, the memory
    estimate, kernel build, the routed plan (``route``: one already built
    for the same layout), the arrays on ``dev``.  Returns (device shards,
    device plan or None, the estimate's bytes)."""
    common.validate_exchange(cfg, prog, dev)
    if cfg.method == "pallas":
        raise SystemExit("--method pallas runs the block-CSR kernel path of the "
                         "pagerank and colfilter apps; the spec workloads reduce "
                         "through the pull engine")
    t0 = time.perf_counter()
    shards = build_pull_shards(g, cfg.num_parts, sort_segments=cfg.sort_segments,
                               compact_gather=cfg.compact_gather)
    common.report_layout("pull", shards, time.perf_counter() - t0)
    est = common.estimate_exchange(shards, cfg, state_width, dst_state=dst_state,
                                   reduce=prog.reduce)
    common.report_preflight(est, dev)
    if dev.type == "cuda":
        cuda_build.load_all()  # building and loading are set-up
    if route is None:
        route = common.build_pull_route(cfg, shards, prog)
    elif cfg.route_gather:
        common.check_route_mode(cfg, route)
    else:
        raise ValueError("a routed plan was handed in, but --route-gather is not set")
    if route is not None:
        route = expand.plan_to_device(route, dev)
    return workloads.on_device(shards, dev), route, est.total_bytes


def _timed(dev, run, pg=None):
    """(the result of ``run()``, its seconds): one untimed run, then the
    timed one (under a group ``pg`` the ranks lined up first)."""
    run()
    if pg is not None:
        pg.barrier()
    timer = Timer(dev)
    out = run()
    return out, timer.stop()


def _report(elapsed: float, ne: int, iters: int) -> float:
    """GTEPS, with the ELAPSED TIME lines printed by rank 0."""
    if common.main_rank():
        return report_elapsed(elapsed, ne, iters)
    return iters * ne / elapsed / 1e9 if elapsed > 0 else float("nan")


def _run_bfs(cfg, g, route) -> SpecRunResult:
    dev = resolve_device(cfg.device)
    sources = _parse_sources(cfg, g.nv)
    prog = workloads.bfs_program(g.nv, sources)
    if cfg.prog_engine == "pull":
        # the pull-until surface: bitwise the same min fixpoint
        _require_allgather(cfg, "bfs --engine pull")
        if cfg.verbose:
            raise SystemExit("-verbose splits the push engine's phases; "
                             "bfs --engine pull has none")
        common.resolve_route_auto(cfg)
        if (cfg.route_gather or route is not None) and cfg.distributed:
            raise SystemExit("bfs --engine pull routes single-device "
                             "allgather runs only")
        pg = None
        if cfg.distributed:
            shards, pg, est = _dist_set_up(cfg, g, prog, dev)
            dev = pg.device
        else:
            shards, route, est = _pull_set_up(cfg, g, prog, dev, route)
        (dist, iters), elapsed = _timed(dev, lambda: workloads.bfs(
            shards, sources, num_parts=cfg.num_parts, max_iters=cfg.max_iters,
            method=cfg.method, engine="pull", route=route, device=dev, mesh=pg), pg)
        _say(f"bfs converged in {iters} iterations")
        gteps = _report(elapsed, g.ne, max(iters, 1))
        stats = {}
    else:
        # home surface: the direction-optimizing push engine, through the
        # SAME convergence driver the sssp/components CLIs use
        from lux_tpu_torch.apps.sssp import build_push_app_shards, run_convergence_app

        if cfg.method == "pallas":
            raise SystemExit("--method pallas is a sum-reduce kernel; "
                             "bfs reduces with min")
        shards = None if cfg.distributed else build_push_app_shards(g, cfg)
        res = run_convergence_app(prog, shards, cfg, "bfs", g, route)
        dist, iters, elapsed, gteps = res.state, res.iters, res.seconds, res.gteps
        est = res.estimate_bytes
        stats = {"traversed_edges": res.traversed, "dense_rounds": res.dense_rounds}
    if dist is None:  # a rank other than 0 of the distributed push
        return SpecRunResult(0, g, dist, iters, elapsed, gteps, cfg.method,
                             cfg.route_gather, stats, est)
    reached = int(np.sum(dist < g.nv))
    depth = int(dist[dist < g.nv].max(initial=0))
    _say(f"reached {reached}/{g.nv} vertices from {len(sources)} "
         f"source(s); max level {depth}")
    rc = _check_verdict(cfg, "bfs", lambda: workloads.check_bfs(g, dist, sources))
    return SpecRunResult(rc, g, dist, iters, elapsed, gteps, cfg.method,
                         cfg.route_gather, stats, est)


def _run_kcore(cfg, g0, route) -> SpecRunResult:
    dev = resolve_device(cfg.device)
    g = g0 if cfg.directed else workloads.symmetrize(g0)
    view = "directed in-neighborhoods" if cfg.directed else \
        "symmetrized simple view"
    common.resolve_route_auto(cfg)
    prog = bind(library.KCORE, kk=1)
    _require_allgather(cfg, "kcore")
    if cfg.distributed and (cfg.route_gather or route is not None):
        raise SystemExit("kcore routes single-device runs only; the distributed "
                         "pull-until driver has no route= path")
    pg = None
    if cfg.distributed:
        shards, pg, est = _dist_set_up(cfg, g, prog, dev)
        dev = pg.device
    else:
        shards, route, est = _pull_set_up(cfg, g, prog, dev, route)
    (coreness, kmax, rounds), elapsed = _timed(dev, lambda: workloads.kcore(
        shards, kmax=cfg.kmax, num_parts=cfg.num_parts,
        max_iters=cfg.max_iters, method=cfg.method, route=route, device=dev, mesh=pg), pg)
    _say(f"kcore ({view}): k_max={kmax} in {rounds} peel rounds")
    gteps = _report(elapsed, g.ne, max(rounds, 1))
    top = np.bincount(coreness, minlength=kmax + 1)
    _say("core sizes (|coreness >= k|): "
         + ", ".join(f"k{k}={int(top[k:].sum())}"
                     for k in range(1, min(kmax, 8) + 1)))
    rc = _check_verdict(cfg, "kcore", lambda: workloads.check_kcore(g, coreness))
    return SpecRunResult(rc, g, coreness, rounds, elapsed, gteps, cfg.method,
                         cfg.route_gather, {"k_max": kmax}, est)


def _run_labelprop(cfg, g, route) -> SpecRunResult:
    dev = resolve_device(cfg.device)
    prog = workloads.labelprop_program(cfg.labels, cfg.seed_stride)
    _require_allgather(cfg, "labelprop")
    if cfg.route_gather or route is not None:
        raise SystemExit(
            "labelprop's wide probability state is not wired to "
            "--route-gather (see docs/PROGRAMS.md lowering matrix)")
    pg = None
    if cfg.distributed:
        shards, pg, est = _dist_set_up(cfg, g, prog, dev, state_width=cfg.labels)
        dev = pg.device
    else:
        shards, _, est = _pull_set_up(cfg, g, prog, dev, None, state_width=cfg.labels)
    probs, elapsed = _timed(dev, lambda: workloads.labelprop(
        shards, labels=cfg.labels, stride=cfg.seed_stride,
        num_iters=cfg.num_iters, num_parts=cfg.num_parts, method=cfg.method,
        device=dev, mesh=pg), pg)
    gteps = _report(elapsed, g.ne, cfg.num_iters)
    hist = np.bincount(probs.argmax(-1), minlength=cfg.labels)
    _say("argmax label histogram: "
         + ", ".join(f"c{i}={int(n)}" for i, n in enumerate(hist)))
    rc = _check_verdict(cfg, "labelprop", lambda: workloads.check_labelprop(
        probs, cfg.labels, cfg.seed_stride))
    return SpecRunResult(rc, g, probs, cfg.num_iters, elapsed, gteps,
                         cfg.method, estimate_bytes=est)


def _run_triangles(cfg, g0, route) -> SpecRunResult:
    dev = resolve_device(cfg.device)
    if cfg.directed:
        if g0.weights is None:
            raise SystemExit("triangles --directed needs a weighted graph "
                             "(the closing-edge weight)")
        g = g0
    else:
        g = workloads.symmetrize(g0)
    if cfg.distributed or cfg.route_gather or route is not None:
        raise SystemExit(
            "triangles is a single-device two-phase program; "
            "--distributed/--route-gather are not wired (see "
            "docs/PROGRAMS.md)")
    _require_allgather(cfg, "triangles")
    if g.nv > workloads.TRIANGLES_MAX_NV:
        raise SystemExit(f"triangles: nv={g.nv} exceeds the supported "
                         f"{workloads.TRIANGLES_MAX_NV} (quadratic bitsets)")
    workloads.require_simple(g)
    words = (g.nv + 31) // 32
    # phase 2 holds the most: the source and destination bitsets per edge
    shards, _, est = _pull_set_up(cfg, g, bind(library.TRI_COUNT), dev, None,
                                  state_width=words, dst_state=True)
    (incidence, stats), elapsed = _timed(dev, lambda: workloads.triangles(
        shards, num_parts=cfg.num_parts, method=cfg.method, device=dev))
    gteps = report_elapsed(elapsed, g.ne, 2)  # two phases, one edge sweep each
    print(f"weighted triangle incidence total = "
          f"{stats['total_weighted_incidence']:.1f} "
          f"(bitset words/vertex: {stats['bitset_words']})")
    if g0.weights is None and not cfg.directed:
        print(f"triangles (unit weights, exact) = "
              f"{stats['triangles_if_unit']:.0f}")
    rc = _check_verdict(cfg, "triangles",
                        lambda: workloads.check_triangles(g, incidence))
    return SpecRunResult(rc, g, incidence, 2, elapsed, gteps, cfg.method,
                         stats=stats, estimate_bytes=est)


#: name -> (parse_args surface, runner)
PROGRAMS = {
    "bfs": ("push", _run_bfs),
    "kcore": ("pull", _run_kcore),
    "labelprop": ("pull", _run_labelprop),
    "triangles": ("pull", _run_triangles),
}


def run(argv, route=None, graph: Optional[HostGraph] = None) -> SpecRunResult:
    """One program: ``argv[0]`` names it, the rest are its flags.
    ``route``: an already built routed plan of the layout the program
    runs on (bfs: the push shards' pull layout, kcore: the symmetrized
    view's); ``graph``: the graph the flags name, already loaded
    (library callers reuse one graph and one plan across runs)."""
    name = argv[0]
    if name not in PROGRAMS:
        raise ValueError(f"unknown program {name!r}; available: "
                         + ", ".join(sorted(PROGRAMS)))
    kind, runner = PROGRAMS[name]
    cfg = parse_args(argv[1:], description=__doc__, push=kind == "push",
                     program=True, prog=name)
    dev = resolve_device(cfg.device)
    g = graph if graph is not None else common.load_graph(cfg)
    with profiling.trace(cfg.profile_dir if common.main_rank() else None, dev):
        res = runner(cfg, g, route)
    res.rc = common.finish_dist(cfg, res.rc)
    return res


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("usage: python -m lux_tpu_torch.apps.run "
              f"{{{','.join(sorted(PROGRAMS))}}} [flags]   "
              "(-h after a program name for its flags)")
        return 0 if argv else 2
    if argv[0] not in PROGRAMS:
        print(f"unknown program {argv[0]!r}; available: "
              + ", ".join(sorted(PROGRAMS))
              + " (the reference apps keep their own CLIs: "
                "python -m lux_tpu_torch.apps.<pagerank|sssp|components|"
                "colfilter>)", file=sys.stderr)
        return 2
    try:
        return run(argv).rc
    finally:
        common.leave_group()


if __name__ == "__main__":
    sys.exit(main())
