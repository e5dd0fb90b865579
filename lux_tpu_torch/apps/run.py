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
             --max-iters, --route-gather expand|expand-pf)
  kcore      k-core decomposition by iterative peel (``--kmax``); runs on
             the symmetrized simple view unless ``--directed``
  labelprop  seeded multi-class label propagation (dense pull, wide
             (V, --labels) state; seeds every ``--seed-stride``)
  triangles  weighted triangle counting — the two-phase intersection
             program (symmetrized view; unit weights when the input
             graph is unweighted)

Timing: the set-up (graph, layout, routed plan, host-to-device copy,
kernel build) comes first, then one untimed run of the workload, then the
timed one, device-fenced.  GTEPS as the reference's bench rows count it:
bfs the edges traversed, kcore ne per peel round, labelprop ne per
iteration, triangles ne per phase (two).

The four reference apps keep their own CLIs
(``lux_tpu_torch.apps.{pagerank,sssp,components,colfilter}``).
"""
from __future__ import annotations

import dataclasses
import sys
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


def _check_verdict(cfg, name: str, violations) -> int:
    """The -check verdict; ``violations()`` runs only under -check."""
    if not cfg.check:
        return 0
    return 0 if common.print_check(name, violations()) else 1


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
    shards = build_pull_shards(g, cfg.num_parts)
    est = common.estimate_exchange(shards, cfg, state_width, dst_state=dst_state)
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


def _timed(dev, run):
    """(the result of ``run()``, its seconds): one untimed run, then the
    timed one."""
    run()
    timer = Timer(dev)
    out = run()
    return out, timer.stop()


def _run_bfs(cfg, g, route) -> SpecRunResult:
    dev = resolve_device(cfg.device)
    sources = _parse_sources(cfg, g.nv)
    prog = workloads.bfs_program(g.nv, sources)
    if cfg.prog_engine == "pull":
        # the pull-until surface: bitwise the same min fixpoint
        if cfg.verbose:
            raise SystemExit("-verbose splits the push engine's phases; "
                             "bfs --engine pull has none")
        common.resolve_route_auto(cfg)
        shards, route, est = _pull_set_up(cfg, g, prog, dev, route)
        (dist, iters), elapsed = _timed(dev, lambda: workloads.bfs(
            shards, sources, num_parts=cfg.num_parts, max_iters=cfg.max_iters,
            method=cfg.method, engine="pull", route=route, device=dev))
        print(f"bfs converged in {iters} iterations")
        gteps = report_elapsed(elapsed, g.ne, max(iters, 1))
        stats = {}
    else:
        # home surface: the direction-optimizing push engine, through the
        # SAME convergence driver the sssp/components CLIs use
        from lux_tpu_torch.apps.sssp import build_push_app_shards, run_convergence_app

        if cfg.method == "pallas":
            raise SystemExit("--method pallas is a sum-reduce kernel; "
                             "bfs reduces with min")
        shards = build_push_app_shards(g, cfg)
        res = run_convergence_app(prog, shards, cfg, "bfs", g, route)
        dist, iters, elapsed, gteps = res.state, res.iters, res.seconds, res.gteps
        est = res.estimate_bytes
        stats = {"traversed_edges": res.traversed, "dense_rounds": res.dense_rounds}
    reached = int(np.sum(dist < g.nv))
    depth = int(dist[dist < g.nv].max(initial=0))
    print(f"reached {reached}/{g.nv} vertices from {len(sources)} "
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
    shards, route, est = _pull_set_up(cfg, g, bind(library.KCORE, kk=1), dev, route)
    (coreness, kmax, rounds), elapsed = _timed(dev, lambda: workloads.kcore(
        shards, kmax=cfg.kmax, num_parts=cfg.num_parts,
        max_iters=cfg.max_iters, method=cfg.method, route=route, device=dev))
    print(f"kcore ({view}): k_max={kmax} in {rounds} peel rounds")
    gteps = report_elapsed(elapsed, g.ne, max(rounds, 1))
    top = np.bincount(coreness, minlength=kmax + 1)
    print("core sizes (|coreness >= k|): "
          + ", ".join(f"k{k}={int(top[k:].sum())}"
                      for k in range(1, min(kmax, 8) + 1)))
    rc = _check_verdict(cfg, "kcore", lambda: workloads.check_kcore(g, coreness))
    return SpecRunResult(rc, g, coreness, rounds, elapsed, gteps, cfg.method,
                         cfg.route_gather, {"k_max": kmax}, est)


def _run_labelprop(cfg, g, route) -> SpecRunResult:
    dev = resolve_device(cfg.device)
    prog = workloads.labelprop_program(cfg.labels, cfg.seed_stride)
    if cfg.route_gather or route is not None:
        raise SystemExit(
            "labelprop's wide probability state is not wired to "
            "--route-gather (see docs/PROGRAMS.md lowering matrix)")
    shards, _, est = _pull_set_up(cfg, g, prog, dev, None, state_width=cfg.labels)
    probs, elapsed = _timed(dev, lambda: workloads.labelprop(
        shards, labels=cfg.labels, stride=cfg.seed_stride,
        num_iters=cfg.num_iters, num_parts=cfg.num_parts, method=cfg.method,
        device=dev))
    gteps = report_elapsed(elapsed, g.ne, cfg.num_iters)
    hist = np.bincount(probs.argmax(-1), minlength=cfg.labels)
    print("argmax label histogram: "
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
    if cfg.route_gather or route is not None:
        raise SystemExit(
            "triangles is a single-device two-phase program; "
            "--distributed/--route-gather are not wired (see "
            "docs/PROGRAMS.md)")
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
    resolve_device(cfg.device)
    g = graph if graph is not None else common.load_graph(cfg)
    return runner(cfg, g, route)


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
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
