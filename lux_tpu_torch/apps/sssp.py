"""SSSP CLI app (`python -m lux_tpu_torch.apps.sssp`).

BFS-flavored single-source shortest paths on the push engine over -ng
parts stacked on one device: -start source, the direction-optimized loop
to convergence, -check triangle-inequality validation on the host,
-verbose per-iteration active counts and load/comp/update times.
``--route-gather expand|expand-pf`` routes the dense rounds' gather;
``--weighted`` relaxes with integer edge weights, and ``--delta N`` runs
delta-stepping with bucket width N (engine/delta.py).
``--ckpt-dir``/``--ckpt-every`` run in windows with an elastic frontier
(or delta) checkpoint between them and resume from the latest;
``--repartition-every`` rebalances the parts' vertex cuts from their
measured load (engine/repartition.py); ``--serve`` answers a burst of
queries through the batched query service instead (serve/driver.py).
Runs on the card unless ``--device cpu``.

The elapsed time is one run to convergence from the initial (or resumed)
carry; an untimed run from the same carry comes first (first launches,
allocator growth, the card's clocks rising from idle), and checkpoint
I/O stays outside the timed compute.  GTEPS counts the edges actually
traversed: every real edge in a dense round, the frontier's out-edges in
a sparse one.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import NamedTuple, Optional

import numpy as np

import torch

from lux_tpu_torch.apps import common
from lux_tpu_torch.engine import delta as delta_eng
from lux_tpu_torch.engine import methods, push, repartition
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.push_shards import PushShards, build_push_shards
from lux_tpu_torch.models import sssp as sssp_model
from lux_tpu_torch.ops import cuda_build, expand
from lux_tpu_torch.utils import checkpoint as ckpt
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
    #: --repartition-every only: each recut as (iteration, old cuts, new
    #: cuts, the window's per-part work)
    recuts: Optional[list] = None
    shards: Optional[PushShards] = None  # the final layout (a recut changes it)
    streamed: Optional[common.StreamedRun] = None  # components --stream-hbm-gib


def build_push_app_shards(g: HostGraph, cfg: RunConfig) -> PushShards:
    """The push layout of the allgather exchange, -ng parts on one device."""
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


def _save_frontier_ckpt(cfg: RunConfig, name: str, shards: PushShards,
                        carry: push.PushCarry) -> str:
    """One elastic frontier checkpoint from the in-flight carry: global
    state, changed-vertex mask, exact edge count."""
    state_g = shards.scatter_to_global(carry.state.cpu().numpy())
    counts = carry.count.cpu().numpy()
    f_cap = shards.pspec.f_cap
    if counts.max() > f_cap:
        # overflowed queues are truncated; the exact frontier is not
        # recoverable: save the dense superset (min/max relaxation is
        # confluent: extra active vertices cost work, never correctness)
        changed_g = np.ones(shards.spec.nv, bool)
    else:
        changed_g = repartition._changed_mask_from_queues(
            carry.q_vid.cpu().numpy(), counts, f_cap, shards.spec.nv)
    return ckpt.save_frontier(cfg.ckpt_dir, carry.it, state_g, changed_g, carry.edges,
                              name)


def push_resume(prog, shards: PushShards, cfg: RunConfig, name: str,
                arrays) -> push.PushCarry:
    """The push carry to start from: rebuilt from the latest frontier
    checkpoint of ``--ckpt-dir`` (any part count can resume any other's:
    the queues rebuild from the saved mask), else the initial one."""
    s_g, c_g, e_acc, it0, prev = ckpt.load_resume_frontier(cfg.ckpt_dir, name,
                                                           shards.spec.nv)
    if s_g is None:
        return push._init_carry(prog, shards.pspec, arrays)
    print(f"resumed from {prev} at iteration {it0}")
    return repartition._rebuild_carry(shards, arrays, s_g, c_g, it0, e_acc)


def run_push_checkpointed(prog, shards: PushShards, cfg: RunConfig, name: str,
                          arrays, parrays, carry0, dev, save: bool = True):
    """Windowed push run from ``carry0`` with an elastic frontier
    checkpoint after every window of --ckpt-every iterations (``save``).
    Returns (final carry, compute seconds): the seconds EXCLUDE the
    checkpoint I/O, so the reported GTEPS stays an engine number."""
    compute, c = 0.0, carry0
    while int(c.active) > 0 and c.it < cfg.max_iters:
        it_stop = min(c.it + cfg.ckpt_every, cfg.max_iters)
        t = Timer(dev)
        c = push.run_push_chunk(prog, shards.pspec, shards.spec, arrays, parrays, c,
                                it_stop, cfg.method)
        compute += t.stop()
        if save:
            _save_frontier_ckpt(cfg, name, shards, c)
    return c, compute


def delta_resume(prog, shards: PushShards, cfg: RunConfig, name: str,
                 arrays) -> delta_eng.DeltaCarry:
    """The delta carry to start from: the latest delta checkpoint of
    ``--ckpt-dir`` restacked onto this layout, else the initial one."""
    s_g, p_g, e_acc, thr, it0, prev = ckpt.load_resume_delta(cfg.ckpt_dir, name,
                                                             shards.spec.nv)
    if s_g is None:
        return delta_eng._init_carry(prog, arrays, cfg.delta)
    dev = arrays.vtx_mask.device
    st = torch.from_numpy(shards.pull.global_to_stacked(s_g)).to(dev)
    pend = torch.from_numpy(shards.pull.global_to_stacked(p_g)).to(dev)
    print(f"resumed from {prev} at iteration {it0}")
    return delta_eng.DeltaCarry(st, pend, torch.tensor(thr, dtype=torch.int32, device=dev),
                                it0, pend.sum(dtype=torch.int32), e_acc)


def run_delta_checkpointed(prog, shards: PushShards, cfg: RunConfig, name: str,
                           arrays, parrays, carry0, dev, save: bool = True):
    """Windowed delta-stepping from ``carry0`` with an elastic checkpoint
    (global state, pending mask, exact edge count, bucket threshold)
    after every window of --ckpt-every rounds (``save``).  Returns (final
    carry, compute seconds), checkpoint I/O excluded."""
    compute, c = 0.0, carry0
    while int(c.active) > 0 and c.it < cfg.max_iters:
        it_stop = min(c.it + cfg.ckpt_every, cfg.max_iters)
        t = Timer(dev)
        c = delta_eng.run_delta_chunk(prog, shards.pspec, shards.spec, cfg.delta, arrays,
                                      parrays, c, it_stop, cfg.method)
        compute += t.stop()
        if save:
            ckpt.save_delta(cfg.ckpt_dir, c.it,
                            shards.scatter_to_global(c.state.cpu().numpy()),
                            shards.scatter_to_global(c.pending.cpu().numpy()),
                            c.edges, int(c.thr), name)
    return c, compute


class _Final(NamedTuple):
    """What the report reads of a run's last carry."""

    state: object
    it: int
    edges: int
    dense_rounds: int


def _refuse(cfg: RunConfig, prog) -> None:
    """The reference's refusal matrix of the frontier apps, for the
    options this package runs."""
    if cfg.route_gather and (cfg.ckpt_every or cfg.repartition_every or cfg.verbose):
        raise SystemExit(
            "--route-gather on the push apps routes the dense rounds of the "
            "plain loop (composes with --delta); it cannot combine with "
            "-verbose, checkpointing or --repartition-every")
    if cfg.method in ("cumsum", "mxsum"):
        raise SystemExit(
            f"--method {cfg.method} is a prefix-diff strategy: sum-reduce "
            f"programs only (this app reduces with {prog.reduce})")
    if cfg.ckpt_every or cfg.ckpt_dir:
        if not (cfg.ckpt_every and cfg.ckpt_dir):
            raise SystemExit(
                "frontier-app checkpointing runs in windows: pass BOTH "
                "--ckpt-dir and --ckpt-every")
        if cfg.verbose or cfg.repartition_every:
            raise SystemExit(
                "--ckpt-every (frontier apps) is a windowed driver; it does "
                "not combine with -verbose or --repartition-every")
    if cfg.repartition_every:
        if cfg.repartition_every < 0:
            raise SystemExit("--repartition-every must be positive")
        if cfg.verbose:
            raise SystemExit(
                "--repartition-every runs the engine in windows; the "
                "per-iteration -verbose fence is not available")
    if cfg.delta:
        if cfg.delta < 0:
            raise SystemExit("--delta must be positive")
        if not cfg.weighted:
            raise SystemExit(
                "--delta orders WEIGHTED distances into buckets; unweighted "
                "BFS already expands one hop-bucket per iteration — add "
                "--weighted")
        if cfg.verbose or cfg.repartition_every:
            raise SystemExit(
                "--delta is the bucketed driver (--ckpt-every composes): it "
                "does not combine with -verbose or --repartition-every")


def run_convergence_app(prog, shards: PushShards, cfg: RunConfig, name: str,
                        g: HostGraph, route=None) -> PushRunResult:
    """The frontier apps' shared driver (SSSP, components and bfs): method
    and route resolution with the reference's refusals, the memory
    estimate, the routed plan (set-up; ``route`` is one already built for
    the same layout), the resume from ``--ckpt-dir``, an untimed run to
    convergence, then the timed one: the plain loop, delta-stepping, the
    checkpointed windows, the adaptive repartitioning, or the -verbose
    phase split.  Returns the result with rc 0 (the caller checks)."""
    dev = resolve_device(cfg.device)
    cfg.method = methods.resolve_sum(cfg.method, prog.reduce,
                                     methods.default_platform(dev))
    common.resolve_route_auto(cfg)
    _refuse(cfg, prog)
    if cfg.delta:
        delta_eng._validate(prog, cfg.delta)
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
    arrays, parrays = push.place(shards, dev)
    phases, recuts, compute = None, None, None
    if cfg.ckpt_every:
        if cfg.delta:
            carry0 = delta_resume(prog, shards, cfg, name, arrays)
            windows = run_delta_checkpointed
        else:
            carry0 = push_resume(prog, shards, cfg, name, arrays)
            windows = run_push_checkpointed

        def converge(save=False):
            return windows(prog, shards, cfg, name, arrays, parrays, carry0, dev, save)
    elif cfg.repartition_every:
        def converge(on_repartition=None):
            return repartition.run_push_adaptive(
                prog, g, cfg.num_parts, chunk=cfg.repartition_every,
                threshold=cfg.repartition_threshold, max_iters=cfg.max_iters,
                method=cfg.method, on_repartition=on_repartition, shards=shards,
                device=dev, placed=(arrays, parrays))
    elif cfg.delta:
        carry0 = delta_eng._init_carry(prog, arrays, cfg.delta)

        def converge():
            return delta_eng.run_delta_chunk(prog, shards.pspec, shards.spec, cfg.delta,
                                             arrays, parrays, carry0, cfg.max_iters,
                                             cfg.method, route)
    else:
        carry0 = push._init_carry(prog, shards.pspec, arrays)

        def converge():
            return push.run_push_chunk(prog, shards.pspec, shards.spec, arrays,
                                       parrays, carry0, cfg.max_iters, cfg.method,
                                       route)

    if cfg.repartition_every:
        # warm-up on the static layout: the recuts' host rebuilds are part
        # of the adaptive run, not first-launch costs
        push.run_push_chunk(prog, shards.pspec, shards.spec, arrays, parrays,
                            push._init_carry(prog, shards.pspec, arrays),
                            cfg.max_iters, cfg.method)
    else:
        converge()
    timer = Timer(dev)
    if cfg.ckpt_every:
        out, compute = converge(save=True)
    elif cfg.repartition_every:
        recuts = []

        def note(it, old_cuts, new_cuts, work):
            recuts.append((it, old_cuts.tolist(), new_cuts.tolist(), work.tolist()))
            moved = int(np.abs(new_cuts - old_cuts).max())
            print(f"iter {it}: repartition (imbalance "
                  f"{repartition.imbalance(work):.2f}, max boundary move "
                  f"{moved} vertices)")

        res = converge(note)
        print(f"{res.reparts} repartition(s)")
        out = _Final(res.stacked, res.iters, res.edges, res.dense_rounds)
        shards = res.shards
    elif cfg.verbose:
        out, phases = run_push_verbose(prog, shards, cfg, arrays, parrays, carry0, dev)
    else:
        out = converge()
    elapsed = timer.stop()
    if compute is not None:
        elapsed = compute  # checkpoint I/O (device reads + disk) is not engine time
    state = shards.scatter_to_global(out.state.cpu().numpy())
    print(f"{name} converged in {out.it} iterations "
          f"({out.dense_rounds} dense rounds)")
    gteps = report_elapsed(elapsed, shards.spec.ne, out.it, traversed=out.edges)
    return PushRunResult(0, g, state, out.it, out.edges, out.dense_rounds,
                         elapsed, gteps, cfg.method, cfg.route_gather, phases,
                         est.total_bytes, recuts, shards)


def run(argv=None, route=None, graph: Optional[HostGraph] = None):
    """The app's body: parse, load, converge, report, check.  ``route``:
    an already built expand plan of the same graph's pull layout;
    ``graph``: the graph the flags name, already loaded (library callers
    reuse one graph and one plan across runs).  Returns a PushRunResult,
    or under ``--serve`` the service's serve.driver.ServeRunResult."""
    cfg = parse_args(argv, description=__doc__, push=True, sssp=True, serve=True)
    resolve_device(cfg.device)
    if cfg.serve:
        from lux_tpu_torch.serve import driver

        return driver.run_serve_cli(cfg, graph, "sssp", route)
    g = graph if graph is not None else common.load_graph(cfg, weighted=cfg.weighted)
    if cfg.weighted and not np.issubdtype(g.weights.dtype, np.integer):
        raise SystemExit("weighted SSSP uses integer edge costs; got dtype "
                         + str(g.weights.dtype))
    if not 0 <= cfg.start < g.nv:
        raise SystemExit(f"-start {cfg.start} out of range [0, {g.nv})")
    if cfg.delta and cfg.weighted and int(g.weights.min()) < 0:
        raise SystemExit("--delta needs non-negative edge weights "
                         "(bucket order breaks under negative costs)")
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
