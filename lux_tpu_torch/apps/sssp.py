"""SSSP CLI app (`python -m lux_tpu_torch.apps.sssp`).

BFS-flavored single-source shortest paths on the push engine, one part:
-start source, the direction-optimized loop to convergence, -check
triangle-inequality validation on the host, -verbose per-iteration active
counts and load/comp/update times.  ``--route-gather expand|expand-pf``
routes the dense rounds' gather; ``--weighted`` relaxes with integer edge
weights.  Runs on the card unless ``--device cpu``.

The elapsed time is one run to convergence from the initial carry; an
untimed run from the same carry comes first (first launches, allocator
growth, the card's clocks rising from idle).  GTEPS counts the edges
actually traversed: every real edge in a dense round, the frontier's
out-edges in a sparse one.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np

from lux_tpu_torch.apps import common
from lux_tpu_torch.engine import methods, push
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.push_shards import PushShards, build_push_shards
from lux_tpu_torch.models import sssp as sssp_model
from lux_tpu_torch.ops import cuda_build, expand
from lux_tpu_torch.utils import preflight
from lux_tpu_torch.utils.config import RunConfig, parse_args
from lux_tpu_torch.utils.device import resolve_device
from lux_tpu_torch.utils.timing import Timer, report_elapsed


@dataclasses.dataclass
class PushRunResult:
    rc: int  # 0, or 1 when -check failed
    graph: HostGraph
    state: np.ndarray  # (nv,) int32 distances or labels
    iters: int
    traversed: int  # edges traversed, exact
    dense_rounds: int
    seconds: float  # the timed run to convergence, device-fenced
    gteps: float  # traversed / seconds
    method: str  # the resolved segment-reduction method
    route_gather: str = ""  # the routed mode that ran ("" = direct)
    #: -verbose only: seconds summed per phase, the comp phase split by
    #: direction (load, dense, sparse, update)
    phases: Optional[dict] = None
    estimate_bytes: int = 0  # the memory estimate printed before set-up


def build_push_app_shards(g: HostGraph, cfg: RunConfig) -> PushShards:
    """The push layout of the allgather exchange on one device."""
    if cfg.method == "pallas":
        raise SystemExit(
            "--method pallas (push) runs on a device mesh in the reference "
            "(parallel/pallas_dist); the distributed push is not ported to "
            "lux_tpu_torch yet: use --method scan, scatter or mxscan")
    return build_push_shards(g, cfg.num_parts)


def run_push_verbose(prog, shards: PushShards, cfg: RunConfig, arrays, parrays,
                     carry, dev):
    """The phase-split loop: each phase fenced on the device and timed,
    one line per iteration.  Returns (final carry, phase seconds)."""
    load, comp, update = push.push_phases(prog, shards.pspec, shards.spec,
                                          cfg.method, device=dev)
    phases = {"load": 0.0, "dense": 0.0, "sparse": 0.0, "update": 0.0}
    c = carry
    while c.it < cfg.max_iters:
        t = Timer(dev)
        plan = load(parrays, c)
        lt = t.stop()
        if plan.active == 0:
            break
        t = Timer(dev)
        new = comp(arrays, parrays, c, plan)
        ct = t.stop()
        t = Timer(dev)
        c = update(arrays, c, new, plan)
        ut = t.stop()
        mode = "dense" if plan.dense else "sparse"
        phases["load"] += lt
        phases[mode] += ct
        phases["update"] += ut
        print(f"iter {c.it - 1:4d}: activeNodes({int(c.active)}) mode({mode}) "
              f"loadTime({lt * 1e3:.3f} ms) compTime({ct * 1e3:.3f} ms) "
              f"updateTime({ut * 1e3:.3f} ms)")
    return c, phases


def run_convergence_app(prog, shards: PushShards, cfg: RunConfig, name: str,
                        g: HostGraph, route=None) -> PushRunResult:
    """The frontier apps' shared driver (SSSP, components and bfs): method
    and route resolution with the reference's refusals, the memory
    estimate, the routed plan
    (set-up; ``route`` is one already built for the same layout), an
    untimed run to convergence, then the timed one.  Returns the result
    with rc 0 (the caller checks)."""
    dev = resolve_device(cfg.device)
    cfg.method = methods.resolve_sum(cfg.method, prog.reduce,
                                     methods.default_platform(dev))
    common.resolve_route_auto(cfg)
    if cfg.route_gather and cfg.verbose:
        raise SystemExit(
            "--route-gather on the push apps routes the dense rounds of the "
            "plain loop; it cannot combine with -verbose")
    if cfg.method in ("cumsum", "mxsum"):
        raise SystemExit(
            f"--method {cfg.method} is a prefix-diff strategy: sum-reduce "
            f"programs only (this app reduces with {prog.reduce})")
    est = preflight.scale_residency(
        preflight.estimate_push(shards.spec, shards.pspec), shards.spec.num_parts)
    if cfg.route_gather:
        # the dense rounds' routed plan is a real per-part slice
        est = preflight.add_routed_bytes(est, shards.spec.num_parts * (
            preflight.routed_plan_bytes_analytic(shards.spec, "expand")))
    common.report_preflight(est, dev)
    if dev.type == "cuda":
        cuda_build.load_all()  # building and loading are set-up
    if route is None:
        route = common.build_push_route(cfg, shards)
    elif cfg.route_gather:
        common.check_route_mode(cfg, route)
    else:
        raise ValueError("a routed plan was handed in, but --route-gather is not set")
    if route is not None:
        route = expand.plan_to_device(route, dev)
    arrays, parrays, carry0 = push.push_init(prog, shards, dev)

    def converge():
        return push.run_push_chunk(prog, shards.pspec, shards.spec, arrays,
                                   parrays, carry0, cfg.max_iters, cfg.method,
                                   route)

    converge()
    phases = None
    timer = Timer(dev)
    if cfg.verbose:
        out, phases = run_push_verbose(prog, shards, cfg, arrays, parrays,
                                       carry0, dev)
    else:
        out = converge()
    elapsed = timer.stop()
    state = shards.scatter_to_global(out.state.cpu().numpy())
    print(f"{name} converged in {out.it} iterations "
          f"({out.dense_rounds} dense rounds)")
    gteps = report_elapsed(elapsed, shards.spec.ne, out.it, traversed=out.edges)
    return PushRunResult(0, g, state, out.it, out.edges, out.dense_rounds,
                         elapsed, gteps, cfg.method, cfg.route_gather, phases,
                         est.total_bytes)


def run(argv=None, route=None, graph: Optional[HostGraph] = None) -> PushRunResult:
    """The app's body: parse, load, converge, report, check.  ``route``:
    an already built expand plan of the same graph's pull layout;
    ``graph``: the graph the flags name, already loaded (library callers
    reuse one graph and one plan across runs)."""
    cfg = parse_args(argv, description=__doc__, push=True, sssp=True)
    resolve_device(cfg.device)
    g = graph if graph is not None else common.load_graph(cfg, weighted=cfg.weighted)
    if cfg.weighted and not np.issubdtype(g.weights.dtype, np.integer):
        raise SystemExit("weighted SSSP uses integer edge costs; got dtype "
                         + str(g.weights.dtype))
    if not 0 <= cfg.start < g.nv:
        raise SystemExit(f"-start {cfg.start} out of range [0, {g.nv})")
    shards = build_push_app_shards(g, cfg)
    cls = sssp_model.WeightedSSSPProgram if cfg.weighted else sssp_model.SSSPProgram
    prog = cls(nv=shards.spec.nv, start=cfg.start)
    res = run_convergence_app(prog, shards, cfg, "sssp", g, route)
    reached = int(np.sum(res.state < prog.inf))
    print(f"reached {reached}/{g.nv} vertices from {cfg.start}")
    if cfg.check:
        ok = common.print_check(
            "sssp", sssp_model.check_distances(g, res.state, weighted=cfg.weighted))
        res.rc = 0 if ok else 1
    return res


def main(argv=None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
