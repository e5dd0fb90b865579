"""Command-line configuration of the apps.

The flags are the reference CLI's (``lux_tpu.utils.config``) restricted to
what this package runs, plus ``--device``.  ``-ng`` stacks that many parts
on the one device (``--method pallas`` runs one).  The pull apps
(``pull=True``: PageRank, collaborative filtering) add ``-verbose/-v``
and the checkpoint flags; the push apps (``push=True``:
SSSP, components and bfs) ``-verbose/-v``, ``--max-iters``, the checkpoint
flags and the adaptive repartitioning's; SSSP (``sssp=True``) ``-start``,
``--weighted`` and ``--delta``; both the gather relayouts
``--sort-segments`` and ``--compact-gather``; the apps with a streamed driver
(``stream=True``) ``--stream-hbm-gib``; and the generic program driver
(``program=True``, ``python -m lux_tpu_torch.apps.run``) its workload
knobs and ``--max-iters``; SSSP and PageRank (``serve=True``) the
``--serve`` group of the batched query service, as the reference's flag
sets do; the pull and push apps and the generic program driver also
``--distributed`` and ``--exchange`` (the parts spread over the ranks of
torch.distributed, parallel/: the pull apps and the pull workloads
exchange by allgather, ring or scatter, the push apps and bfs by
allgather or ring, as in the reference), and the pull apps and pull
workloads the 2-D grids ``--edge-shards`` and ``--feat-shards``
(parallel/edge2d.py, parallel/feat.py; the workloads refuse them, as the
reference's do).  A reference flag of a feature not ported
(``NOT_PORTED``) is rejected with a message that it is not ported yet,
never silently ignored.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional


def env_int(name: str, default: Optional[int] = None, *,
            minimum: Optional[int] = None,
            maximum: Optional[int] = None) -> Optional[int]:
    """Parse an integer environment knob, with an error that names the
    variable.  Unset or empty reads as ``default``; a set-but-garbage or
    out-of-bounds value raises ValueError (a mistyped thread count must
    fail the launch, not quietly run single-threaded)."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        val = int(raw.strip())
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None
    if minimum is not None and val < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {val}")
    if maximum is not None and val > maximum:
        raise ValueError(f"{name} must be <= {maximum}, got {val}")
    return val


def env_float(name: str, default: Optional[float] = None, *,
              minimum: Optional[float] = None,
              maximum: Optional[float] = None) -> Optional[float]:
    """``env_int``'s float twin, with the same contract: unset or empty
    reads as ``default``; garbage, NaN or an out-of-bounds value raises a
    ValueError that names the variable."""
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return default
    try:
        val = float(raw.strip())
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None
    if val != val:  # NaN would defeat every min/max comparison below
        raise ValueError(f"{name} must be a number, got NaN")
    if minimum is not None and val < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {val}")
    if maximum is not None and val > maximum:
        raise ValueError(f"{name} must be <= {maximum}, got {val}")
    return val


#: reference flags this package does not run yet (and, as before the push
#: apps took them, the push flags on the apps that do not take them)
NOT_PORTED = ("-start", "-verbose", "-v", "--max-iters", "--weighted")
EXCHANGES = ("allgather", "ring", "scatter")
#: the push apps' dense-round exchanges (the reference's choices)
PUSH_EXCHANGES = ("allgather", "ring")

METHODS = ("auto", "scan", "cumsum", "mxsum", "mxscan", "scatter", "pallas")

#: --route-gather modes (the reference's); the bare flag means "auto"
ROUTE_GATHER = ("auto", "expand", "expand-pf", "fused", "fused-pf", "fused-mx")
#: the push apps route their dense rounds' gather only
PUSH_ROUTE_GATHER = ("auto", "expand", "expand-pf")


@dataclasses.dataclass
class RunConfig:
    file: Optional[str] = None  # .lux path; None => synthetic RMAT
    num_parts: int = 1  # -ng: graph parts, stacked on the one device
    num_iters: int = 10  # -ni
    check: bool = False  # -check/-c: run the validator
    #: segment-reduction strategy; "auto" resolves per engine.methods,
    #: "pallas" runs the block-CSR SpMV kernel path
    method: str = "auto"
    dtype: str = "float32"  # state storage dtype
    #: routed pull mode ("" = the direct gather; see ROUTE_GATHER)
    route_gather: str = ""
    rmat_scale: int = 16  # synthetic graph size when file is None
    rmat_ef: int = 8
    seed: int = 0
    device: str = "cuda"
    profile_dir: Optional[str] = None  # --profile-dir: torch.profiler trace
    start: int = 0  # -start: SSSP's source vertex
    verbose: bool = False  # -verbose: per-iteration phase times
    max_iters: int = 10_000  # --max-iters: the push apps' iteration cap
    weighted: bool = False  # --weighted: SSSP relaxes with edge weights
    ckpt_dir: Optional[str] = None  # checkpoint/resume directory
    ckpt_every: int = 0  # save every N iterations (0 = off)
    #: >0 = delta-stepping bucket width for weighted SSSP (engine/delta.py)
    delta: int = 0
    #: --distributed: the parts spread over the ranks of torch.distributed
    #: (parallel/; one process a rank, k = num_parts / ranks parts each)
    distributed: bool = False
    #: the distributed state exchange: allgather | ring | scatter
    exchange: str = "allgather"
    #: >1 = split each part's edges over this many ranks (the 2-D parts x
    #: edge grid, parallel/edge2d.py; ranks = num_parts * edge_shards)
    edge_shards: int = 1
    #: >1 = split CF's latent dim over this many ranks (the 2-D parts x
    #: feat grid, parallel/feat.py)
    feat_shards: int = 1
    #: >0 = host-offload streaming under this device-byte budget in GiB
    #: (engine/stream.py; pagerank/colfilter fixed, components until)
    stream_hbm_gib: float = 0.0
    #: >0 = adaptive repartitioning (push apps): every N iterations
    #: rebalance the vertex cuts from the measured per-part load
    repartition_every: int = 0
    #: recut when the window's max/mean per-part load exceeds this
    repartition_threshold: float = 1.25
    #: gather-locality relayout: each destination segment's edges ordered
    #: by src_pos (graph/shards.sort_segments_inplace)
    sort_segments: bool = False
    #: compact-gather layout: each part gathers through its unique
    #: in-sources (graph/shards.build_compact_mirror)
    compact_gather: bool = False
    #: --serve: run the app as a batched query service (serve/): warm
    #: Q-bucket engines + the micro-batching scheduler instead of one
    #: whole-graph run
    serve: bool = False
    serve_queries: int = 64  # random query count when no explicit list
    serve_sources: str = ""  # comma-separated query vertices (overrides)
    serve_buckets: str = "1,8,64"  # warm Q buckets, warmed at start
    serve_wait_ms: float = 5.0  # micro-batch coalescing window
    serve_timeout_ms: float = 0.0  # per-request deadline (0 = none)
    serve_max_queue: int = 256  # admission bound (backpressure past it)
    # --- generic program driver (python -m lux_tpu_torch.apps.run) --------
    sources: str = "0"  # bfs: comma-separated seed vertices
    labels: int = 8  # labelprop: number of classes
    seed_stride: int = 16  # labelprop: every Nth vertex is a seed
    kmax: int = 0  # kcore: peel ceiling (0 = until the core empties)
    prog_engine: str = "auto"  # workload surface override (push/pull)
    directed: bool = False  # kcore/triangles: skip the symmetrized view


def parse_args(argv=None, description: str = "", push: bool = False,
               sssp: bool = False, program: bool = False, prog: str = "",
               pull: bool = False, stream: bool = False,
               serve: bool = False) -> RunConfig:
    """The apps' flags; ``pull`` adds the pull apps' flag set, ``push``
    the frontier apps', ``sssp`` SSSP's own, ``stream`` the streamed
    driver's budget, ``serve`` the query service's, and ``program`` the
    generic program driver's workload knobs (``prog`` names the workload
    in the usage line), as the reference's ``pull=``/``push=``/
    ``sssp=``/``stream=``/``serve=``/``program=`` do."""
    ap = argparse.ArgumentParser(
        description=description,
        prog=f"python -m lux_tpu_torch.apps.run {prog}" if prog else None)
    ap.add_argument("-file", help=".lux graph file (default: synthetic RMAT)")
    ap.add_argument("-ng", "--num-parts", type=int, default=1,
                    help="number of graph parts, stacked on the one device, "
                         "or with --distributed spread over the ranks "
                         "(--method pallas runs one a rank)")
    ap.add_argument("-ni", "--num-iters", type=int, default=10)
    if sssp:
        ap.add_argument("-start", type=int, default=0, help="source vertex")
    if push or pull:
        ap.add_argument("-verbose", "-v", action="store_true",
                        help="per-iteration active count and load/comp/update "
                             "times (device-fenced phases)")
        ap.add_argument("--ckpt-dir", help="checkpoint directory (resume if present)")
        ap.add_argument("--ckpt-every", type=int, default=0,
                        help="save state every N iterations")
    if push or program:
        ap.add_argument("--max-iters", type=int, default=10_000)
    # the pull workloads of the generic program driver take the pull
    # apps' exchange flags (and refuse all but allgather, as the
    # reference's do)
    mesh = pull or (program and not push)
    if mesh or push:
        ap.add_argument("--distributed", action="store_true",
                        help="spread the -ng parts over the ranks of "
                             "torch.distributed (launch with python -m "
                             "torch.distributed.run --nproc-per-node W; "
                             "LUX_DIST_BACKEND=gloo for ranks that share a "
                             "card)")
    if push:
        ap.add_argument("--exchange", default="allgather", choices=PUSH_EXCHANGES,
                        help="dense-round state exchange under --distributed: "
                             "allgather (every rank gathers the whole state) "
                             "or ring (blocks stream rank to rank); sparse "
                             "rounds exchange the frontier queues")
    if mesh:
        ap.add_argument("--exchange", default="allgather", choices=EXCHANGES,
                        help="distributed state exchange: allgather (every "
                             "rank gathers the whole state), ring (blocks "
                             "stream rank to rank) or scatter (partials "
                             "summed by a reduce-scatter; sum programs "
                             "without destination reads)")
        ap.add_argument("--edge-shards", type=int, default=1,
                        help="split each part's edges over N ranks (2-D parts x "
                             "edge grid; ranks = num_parts * N). A capacity "
                             "feature for parts bigger than one device: the "
                             "state is gathered on every edge shard, so the "
                             "exchange's volume scales xN")
        ap.add_argument("--feat-shards", type=int, default=1,
                        help="split the latent feature dim over N ranks (2-D "
                             "parts x feat grid, CF only; the rank count a "
                             "multiple of N, -ng a multiple of ranks / N)")
    if pull:
        ap.add_argument("--sort-segments", action="store_true",
                        help="reorder edges within each destination segment "
                             "by gather index (gather locality; commutative "
                             "reduces only: float sums round differently "
                             "from the unsorted layout, deterministically)")
        ap.add_argument("--compact-gather", action="store_true",
                        help="two-stage gather through a per-part unique-"
                             "in-source mirror (working set O(unique "
                             "sources) instead of O(nv); bitwise-identical "
                             "results)")
    if push:
        ap.add_argument("--sort-segments", action="store_true",
                        help="reorder the dense-round pull layout's edges "
                             "within each destination segment by gather "
                             "index (gather locality; bitwise-free for "
                             "min/max relaxation)")
        ap.add_argument("--compact-gather", action="store_true",
                        help="dense rounds gather through a per-part "
                             "unique-in-source mirror (working set "
                             "O(unique sources); bitwise-identical)")
    if push:
        ap.add_argument("--repartition-every", type=int, default=0,
                        help="rebalance vertex cuts from measured per-part "
                             "load every N iterations (0 = static cuts)")
        ap.add_argument("--repartition-threshold", type=float, default=1.25,
                        help="recut when the window's max/mean per-part "
                             "load exceeds this ratio")
    ap.add_argument("-check", "-c", action="store_true")
    ap.add_argument("--method", default="auto", choices=METHODS,
                    help="segment-reduction strategy; auto = the measured "
                         "per-platform winner (engine.methods); pallas = "
                         "the block-CSR SpMV kernel")
    ap.add_argument("--route-gather", nargs="?", const="auto", default="",
                    choices=PUSH_ROUTE_GATHER if push else ROUTE_GATHER,
                    help="Benes-routed pull (ops/expand.py): 'expand' "
                         "replaces the per-edge state gather with lane "
                         "shuffles (bitwise-identical); 'fused' also "
                         "replaces the segmented reduce (deterministic "
                         "group association).  The '-pf' variants run the "
                         "pass-fused kernel (2-3 passes per kernel, same "
                         "bits); 'fused-mx' reduces inside the route's "
                         "last kernel; 'fused-pf' follows LUX_REDUCE_MODE "
                         "(default group).  The bare flag means 'auto': "
                         "expand-pf, or expand under "
                         "LUX_ROUTE_MODE=routed.  Not with --method pallas"
                         + ("; the push apps route their dense rounds' "
                            "gather (expand modes only)" if push else ""))
    if not push:  # the frontier apps' state is int32
        ap.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"], help="state storage dtype")
    ap.add_argument("--rmat-scale", type=int, default=16)
    ap.add_argument("--rmat-ef", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (no fallback: cuda without a card fails)")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the run's "
                         "iterations into this directory; the per-kernel "
                         "device-time table lands in the event log "
                         "(utils/profiling.py, obs/xprof.py)")
    if sssp:
        ap.add_argument("--weighted", action="store_true",
                        help="relax with integer edge weights")
        ap.add_argument("--delta", type=int, default=0,
                        help="delta-stepping bucket width (weighted; one "
                             "device or --distributed allgather): expand "
                             "only pending vertices with "
                             "dist < the current bucket's bound — "
                             "near-Dijkstra edge counts (0 = chaotic "
                             "relaxation)")
    if stream:
        ap.add_argument("--stream-hbm-gib", type=float, default=0.0,
                        help="host-offload streaming: keep the edge arrays "
                             "in pinned host memory and stream double-"
                             "buffered chunks through this device-byte "
                             "budget every iteration (graphs whose edges "
                             "exceed the card's memory)")
    if serve:
        sg = ap.add_argument_group(
            "serving (lux_tpu_torch.serve: batched multi-source query service)")
        sg.add_argument("--serve", action="store_true",
                        help="serve a burst of queries through warm batched "
                             "engines + the micro-batching scheduler instead "
                             "of one whole-graph run")
        sg.add_argument("--serve-queries", type=int, default=64,
                        help="number of random query vertices to serve")
        sg.add_argument("--serve-sources", default="",
                        help="comma-separated query vertices (overrides "
                             "--serve-queries)")
        sg.add_argument("--serve-buckets", default="1,8,64",
                        help="Q buckets warmed at service start")
        sg.add_argument("--serve-wait-ms", type=float, default=5.0,
                        help="micro-batch coalescing window")
        sg.add_argument("--serve-timeout-ms", type=float, default=0.0,
                        help="per-request deadline (0 = none)")
        sg.add_argument("--serve-max-queue", type=int, default=256,
                        help="admission-queue bound (rejects past it)")
    if program:
        pg = ap.add_argument_group(
            "program (generic spec-workload driver, lux_tpu_torch.apps.run)")
        pg.add_argument("--sources", default="0",
                        help="bfs: comma-separated seed vertices "
                             "(distance = hops to the nearest)")
        pg.add_argument("--labels", type=int, default=8,
                        help="labelprop: number of label classes (the "
                             "wide-state trailing dim)")
        pg.add_argument("--seed-stride", type=int, default=16,
                        help="labelprop: every Nth vertex is a pinned "
                             "seed of class vid %% labels")
        pg.add_argument("--kmax", type=int, default=0,
                        help="kcore: peel ceiling (0 = peel until the "
                             "core empties)")
        pg.add_argument("--engine", dest="prog_engine", default="auto",
                        choices=["auto", "push", "pull"],
                        help="execution surface override for workloads "
                             "that lower onto both (bfs)")
        pg.add_argument("--directed", action="store_true",
                        help="kcore/triangles: run on the directed "
                             "in-neighborhoods as-is instead of the "
                             "symmetrized simple view")
    ns, rest = ap.parse_known_args(argv)
    for arg in rest:
        flag = arg.split("=", 1)[0]
        if flag in NOT_PORTED:
            ap.error(f"{flag} is not ported to lux_tpu_torch yet")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if ns.num_parts < 1:
        ap.error(f"-ng must be positive, got {ns.num_parts}")
    if ns.num_parts != 1 and ns.method == "pallas" and not getattr(ns, "distributed", False):
        ap.error("-ng: --method pallas runs one part (-ng 1) on one device; "
                 "its multi-part form is --distributed (one part a rank)")
    if getattr(ns, "ckpt_every", 0) and not ns.ckpt_dir:
        ap.error("--ckpt-every requires --ckpt-dir")
    if getattr(ns, "serve", False) and getattr(ns, "distributed", False):
        ap.error("--serve answers queries in one process; it does not combine with "
                 "--distributed")
    if ns.route_gather and ns.method == "pallas":
        ap.error("--route-gather does not combine with --method pallas: the "
                 "block-CSR runner has its own gather and no routed form")
    return RunConfig(
        file=ns.file,
        num_parts=ns.num_parts,
        num_iters=ns.num_iters,
        check=ns.check,
        method=ns.method,
        dtype=getattr(ns, "dtype", "float32"),
        route_gather=ns.route_gather,
        rmat_scale=ns.rmat_scale,
        rmat_ef=ns.rmat_ef,
        seed=ns.seed,
        device=ns.device,
        profile_dir=ns.profile_dir,
        start=getattr(ns, "start", 0),
        verbose=getattr(ns, "verbose", False),
        max_iters=getattr(ns, "max_iters", 10_000),
        weighted=getattr(ns, "weighted", False),
        ckpt_dir=getattr(ns, "ckpt_dir", None),
        ckpt_every=getattr(ns, "ckpt_every", 0),
        delta=getattr(ns, "delta", 0),
        distributed=getattr(ns, "distributed", False),
        exchange=getattr(ns, "exchange", "allgather"),
        edge_shards=getattr(ns, "edge_shards", 1),
        feat_shards=getattr(ns, "feat_shards", 1),
        stream_hbm_gib=getattr(ns, "stream_hbm_gib", 0.0),
        repartition_every=getattr(ns, "repartition_every", 0),
        repartition_threshold=getattr(ns, "repartition_threshold", 1.25),
        sort_segments=getattr(ns, "sort_segments", False),
        compact_gather=getattr(ns, "compact_gather", False),
        serve=getattr(ns, "serve", False),
        serve_queries=getattr(ns, "serve_queries", 64),
        serve_sources=getattr(ns, "serve_sources", ""),
        serve_buckets=getattr(ns, "serve_buckets", "1,8,64"),
        serve_wait_ms=getattr(ns, "serve_wait_ms", 5.0),
        serve_timeout_ms=getattr(ns, "serve_timeout_ms", 0.0),
        serve_max_queue=getattr(ns, "serve_max_queue", 256),
        sources=getattr(ns, "sources", "0"),
        labels=getattr(ns, "labels", 8),
        seed_stride=getattr(ns, "seed_stride", 16),
        kmax=getattr(ns, "kmax", 0),
        prog_engine=getattr(ns, "prog_engine", "auto"),
        directed=getattr(ns, "directed", False),
    )
