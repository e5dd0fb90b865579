"""SSSP CLI app (`python -m lux_tpu_torch.apps.sssp`).

BFS-flavored single-source shortest paths on the push engine over -ng
parts stacked on one device: -start source, the direction-optimized loop
to convergence, -check triangle-inequality validation on the host,
-verbose per-iteration active counts and load/comp/update times.
``--distributed`` spreads the parts over the ranks of torch.distributed
(``python -m torch.distributed.run --nproc-per-node W -m
lux_tpu_torch.apps.sssp --distributed ...``; LUX_DIST_BACKEND=gloo for
ranks that share a card): ``--exchange allgather|ring`` for the dense
rounds, ``--method pallas`` for the block-CSR kernel's (one part a
rank), with --delta, --repartition-every, the checkpoints and -verbose
(allgather) as on one device; rank 0 prints and checks.
``--route-gather expand|expand-pf`` routes the dense rounds' gather (under
--distributed on the allgather and the ring, each rank planning its own
parts or buckets; not with --distributed --delta);
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
import json
import sys
import time
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
from lux_tpu_torch.utils import profiling
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
    #: --distributed: (this rank's engine/push.PushLayout, its final
    #: carry, the -verbose fenced run's exchange split or None); ``state``
    #: is None off rank 0
    dist: Optional[tuple] = None


def build_push_app_shards(g: HostGraph, cfg: RunConfig) -> PushShards:
    """The push layout of the allgather exchange, -ng parts on one device,
    with the gather relayouts of the flags (the reference's refusals
    first, common.refuse_relayouts)."""
    common.refuse_relayouts(cfg)
    if cfg.method == "pallas":
        raise SystemExit(
            "--method pallas (push) runs on ranks: add --distributed (one part "
            "a rank; one card = -ng 1 --distributed)")
    if cfg.exchange != "allgather":
        raise SystemExit(f"--exchange {cfg.exchange} requires --distributed")
    t0 = time.perf_counter()
    shards = build_push_shards(g, cfg.num_parts, sort_segments=cfg.sort_segments,
                               compact_gather=cfg.compact_gather)
    common.report_layout("push", shards, time.perf_counter() - t0)
    return shards


def run_push_verbose(prog, shards: PushShards, cfg: RunConfig, arrays, parrays,
                     carry, dev, split=None, show: bool = True):
    """The phase-split loop: each phase fenced on the device and timed,
    one line per iteration (when ``show``).  ``split`` is the (load,
    comp, update) triple (default: push.push_phases on one device; a
    rank passes push.compile_push_phases_dist's).  Returns (final carry,
    phase seconds)."""
    load, comp, update = split or push.push_phases(prog, shards.pspec, shards.spec,
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
        if show:
            print(f"iter {c.it - 1:4d}: activeNodes({int(c.active)}) mode({mode}) "
                  f"loadTime({lt * 1e3:.3f} ms) compTime({ct * 1e3:.3f} ms) "
                  f"updateTime({ut * 1e3:.3f} ms)")
    return c, phases


def _save_frontier_ckpt(cfg: RunConfig, name: str, shards: PushShards,
                        carry: push.PushCarry) -> str:
    """One elastic frontier checkpoint from the in-flight stacked carry:
    global state, changed-vertex mask, exact edge count."""
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


def _save_ckpt(cfg: RunConfig, name: str, lay: push.PushLayout, carry) -> None:
    """The checkpoint of a window: the frontier (or delta) carry of every
    part (stitched over the ranks under --distributed, a collective),
    written by rank 0 or the only process."""
    sh = lay.shards
    if cfg.delta:
        state, pend = lay.stack(carry.state), lay.stack(carry.pending)
        if lay.lead:
            ckpt.save_delta(cfg.ckpt_dir, carry.it, sh.scatter_to_global(state.cpu().numpy()),
                            sh.scatter_to_global(pend.cpu().numpy()), carry.edges,
                            int(carry.thr), name)
        return
    full = lay.full(carry)
    if lay.lead:
        _save_frontier_ckpt(cfg, name, sh, full)


def _resume(cfg: RunConfig, name: str, lay: push.PushLayout):
    """The carry a checkpointed run starts from: the latest frontier (or
    delta) checkpoint of ``--ckpt-dir`` restacked onto this layout's
    resident parts (any part or rank count resumes any other's: the
    queues rebuild from the saved mask), else the initial one."""
    sh, pg = lay.shards, lay.pg
    if cfg.delta:
        s_g, p_g, e_acc, thr, it0, prev = ckpt.load_resume_delta(cfg.ckpt_dir, name,
                                                                 sh.spec.nv)
        if s_g is None:
            return delta_eng.init_on(lay, cfg.delta)
        dev = lay.view.vtx_mask.device
        st, pend = (torch.from_numpy(sh.pull.global_to_stacked(x)[lay.rows]).to(dev)
                    for x in (s_g, p_g))
        c = delta_eng.DeltaCarry(st, pend, torch.tensor(thr, dtype=torch.int32, device=dev),
                                 it0, None if pg else pend.sum(dtype=torch.int32), e_acc)
    else:
        s_g, c_g, e_acc, it0, prev = ckpt.load_resume_frontier(cfg.ckpt_dir, name,
                                                               sh.spec.nv)
        if s_g is None:
            return lay.init()
        c = repartition._rebuild_carry(sh, lay.view, s_g, c_g, it0, e_acc, pg)
    if lay.lead:
        print(f"resumed from {prev} at iteration {it0}")
    return push.settle_active(pg, c)


class _Final(NamedTuple):
    """What the report reads of a run's last carry."""

    state: object
    it: int
    edges: int
    dense_rounds: int


def _refuse(cfg: RunConfig, prog) -> None:
    """The reference's refusal matrix of the frontier apps, for the
    options this package runs (the relayouts' refusals run before the
    layout is built: build_push_app_shards)."""
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


def _refuse_dist(cfg: RunConfig, was_auto: bool) -> None:
    """The reference's refusals of the distributed push arms (after
    :func:`_refuse`): --route-gather routes the allgather and the ring
    dense rounds (expand-pf downgraded to expand on the ring, with a
    note), without --delta; pallas runs one part a rank on the allgather exchange,
    without -verbose, checkpoints, repartitioning or delta; the ring runs the bucketed methods (an ``auto`` winner it
    cannot run falls back, with a note), without delta or the allgather
    relayouts."""
    if cfg.route_gather:
        if cfg.delta:
            raise SystemExit(
                "--route-gather on push apps routes the allgather dense rounds "
                "(single-device or --distributed; composes with single-device "
                "--delta) and the distributed ring dense rounds; it cannot combine "
                "with --distributed --delta")
        if cfg.route_gather == "expand-pf" and cfg.exchange == "ring":
            common.downgrade_pf(cfg, "the ring exchange")
    if cfg.method == "pallas":
        if cfg.exchange != "allgather":
            raise SystemExit("--method pallas has its own dense path; it cannot "
                             "combine with --exchange ring")
        if cfg.verbose or cfg.repartition_every or cfg.ckpt_every or cfg.delta:
            raise SystemExit(
                "--method pallas (push): -verbose/--repartition-every/checkpointing/"
                "--delta are not wired to the kernel path; use --method scan, "
                "scatter or mxscan")
    if cfg.exchange != "ring":
        return
    if cfg.delta:
        raise SystemExit("--delta is the allgather bucketed driver: it does not "
                         "combine with --exchange ring")
    if cfg.sort_segments or cfg.compact_gather:
        raise SystemExit("--sort-segments/--compact-gather relay out the allgather "
                         "dense-round layout; the ring buckets have their own order")
    from lux_tpu_torch.parallel.ring import bucketed_method

    try:
        method = bucketed_method(cfg.method, was_auto)
    except ValueError as e:
        raise SystemExit(f"--exchange ring: {e}")
    if method != cfg.method:
        print(f"# --method auto: the {cfg.method} winner falls back to {method} on "
              "--exchange ring (bucketed reductions run scan/scatter)", file=sys.stderr)
        cfg.method = method


def _place_one_device(prog, shards: PushShards, cfg: RunConfig, dev, route):
    """The -ng parts on one device: the memory estimate (printed and
    checked), the kernels, the routed plan (set-up; ``route`` is one
    already built for the same layout), the statics.  Returns
    (engine/push.PushLayout, the estimate)."""
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
    return push.place_layout(prog, shards, None, cfg.method, dev, route=route), est


def run_convergence_app(prog, shards: Optional[PushShards], cfg: RunConfig, name: str,
                        g: HostGraph, route=None) -> PushRunResult:
    """The frontier apps' one driver (SSSP, components and bfs), on one
    device or, under ``--distributed``, on each rank: method and route
    resolution with the reference's refusals, the layout placed with its
    memory estimate (``shards``: the -ng parts on one device; None under
    --distributed, where each rank builds its own, apps/common
    .setup_push_dist), the resume from ``--ckpt-dir``, an untimed run to
    convergence (the static layout's under --repartition-every: the
    recuts' host rebuilds are part of the adaptive run, not first-launch
    costs), then, the ranks lined up, the timed one: the plain loop,
    delta-stepping, the checkpointed windows, the adaptive repartitioning,
    or the -verbose phase split (one device and the allgather exchange;
    the ring runs fused, with a note).  Under --distributed -verbose rank 0
    also prints the exchange's split of a further fenced run.  Returns the
    result with rc 0 (the caller checks), its ``state`` on rank 0 only."""
    dev = resolve_device(cfg.device)
    was_auto = cfg.method == "auto"
    if cfg.method != "pallas":
        cfg.method = methods.resolve_sum(cfg.method, prog.reduce,
                                         methods.default_platform(dev))
    common.resolve_route_auto(cfg)
    if cfg.distributed:
        common.refuse_relayouts(cfg)
    _refuse(cfg, prog)
    if cfg.distributed:
        _refuse_dist(cfg, was_auto)
    if cfg.delta:
        delta_eng._validate(prog, cfg.delta)
    if cfg.distributed:
        if route is not None:
            raise ValueError("a routed plan was handed in, but under --distributed each "
                             "rank plans its own rows (--route-gather)")
        lay, est = common.setup_push_dist(cfg, g, dev, prog)
    else:
        lay, est = _place_one_device(prog, shards, cfg, dev, route)
    shards, pg, show = lay.shards, lay.pg, lay.lead
    phases, recuts, compute, split = None, None, None, None

    def window(c, it_stop):
        if cfg.delta:
            return delta_eng.run_window(lay, cfg.delta, c, it_stop)
        return lay.loop(c, it_stop)

    if cfg.ckpt_every:
        carry0 = _resume(cfg, name, lay)

        def converge(save=False):
            c, secs = carry0, 0.0
            while int(c.active) > 0 and c.it < cfg.max_iters:
                t = Timer(dev)
                c = window(c, min(c.it + cfg.ckpt_every, cfg.max_iters))
                secs += t.stop()
                if save:
                    _save_ckpt(cfg, name, lay, c)
            return c, secs
    elif cfg.repartition_every:
        def converge(on_repartition=None):
            return repartition.run_push_adaptive(
                prog, g, cfg.num_parts, chunk=cfg.repartition_every,
                threshold=cfg.repartition_threshold, max_iters=cfg.max_iters,
                method=cfg.method, mesh=pg, on_repartition=on_repartition, device=dev,
                placed=lay, exchange=lay.exchange, sort_segments=cfg.sort_segments,
                compact_gather=cfg.compact_gather)
    else:
        carry0 = delta_eng.init_on(lay, cfg.delta) if cfg.delta else lay.init()

        def converge():
            return window(carry0, cfg.max_iters)
    stepwise = cfg.verbose and lay.exchange == "allgather"
    if cfg.verbose and not stepwise and show:
        print("note: -verbose per-iteration stepping is an allgather-exchange mode; "
              f"{lay.exchange} runs fused")
    # rank 0 traces (one trace directory, one event-log table)
    with profiling.trace(cfg.profile_dir if show else None, dev):
        if cfg.repartition_every:
            lay.loop(lay.init(), cfg.max_iters)
        else:
            converge()
        if pg is not None:
            pg.barrier()
        timer = Timer(dev)
        if cfg.ckpt_every:
            out, compute = converge(save=True)
        elif cfg.repartition_every:
            recuts = []

            def note(it, old_cuts, new_cuts, work):
                recuts.append((it, old_cuts.tolist(), new_cuts.tolist(), work.tolist()))
                if show:
                    moved = int(np.abs(new_cuts - old_cuts).max())
                    print(f"iter {it}: repartition (imbalance "
                          f"{repartition.imbalance(work):.2f}, max boundary move "
                          f"{moved} vertices)")

            res = converge(note)
            if show:
                print(f"{res.reparts} repartition(s)")
            out = _Final(res.stacked, res.iters, res.edges, res.dense_rounds)
            shards = res.shards
        elif stepwise:
            steps = None if pg is None else push.compile_push_phases_dist(
                prog, pg, shards.pspec, shards.spec, lay.method)
            out, phases = run_push_verbose(prog, shards, cfg, lay.arrays, lay.parrays,
                                           carry0, dev, steps, show)
        else:
            out = converge()
        elapsed = timer.stop()
    if compute is not None:
        elapsed = compute  # checkpoint I/O (device reads + disk) is not engine time
    if pg is not None and cfg.verbose and not (cfg.ckpt_every or cfg.repartition_every):
        split = common.push_exchange_split(pg, converge)
        if show:
            print("exchange: " + json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                                             for k, v in split.items()}))
    if cfg.repartition_every:
        state = res.state if show else None
    else:
        state = lay.read(out.state)
    gteps = out.edges / elapsed / 1e9 if elapsed > 0 else float("nan")
    if show:
        print(f"{name} converged in {out.it} iterations "
              f"({out.dense_rounds} dense rounds)")
        gteps = report_elapsed(elapsed, shards.spec.ne, out.it, traversed=out.edges)
    return PushRunResult(0, g, state, out.it, out.edges, out.dense_rounds, elapsed, gteps,
                         cfg.method, cfg.route_gather, phases, est.total_bytes, recuts,
                         shards, dist=None if pg is None else (lay, out, split))


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
    cls = sssp_model.WeightedSSSPProgram if cfg.weighted else sssp_model.SSSPProgram
    prog = cls(nv=g.nv, start=cfg.start)
    shards = None if cfg.distributed else build_push_app_shards(g, cfg)
    res = run_convergence_app(prog, shards, cfg, "sssp", g, route)
    if res.state is not None:  # the only process, or rank 0
        reached = int(np.sum(res.state < prog.inf))
        print(f"reached {reached}/{g.nv} vertices from {cfg.start}")
        if cfg.check:
            ok = common.print_check(
                "sssp", sssp_model.check_distances(g, res.state, weighted=cfg.weighted))
            res.rc = 0 if ok else 1
    res.rc = common.finish_dist(cfg, res.rc)
    return res


def main(argv=None) -> int:
    try:
        return run(argv).rc
    finally:
        common.leave_group()


if __name__ == "__main__":
    sys.exit(main())
