#!/usr/bin/env python3
"""On-card smoke test of lux_tpu_torch: build, check and time the CUDA
kernels, then drive single-GPU PageRank (direct and routed), collaborative
filtering, SSSP, connected components, the spec workloads (bfs, kcore,
labelprop, triangles), the long and out-of-core runs (delta-stepping,
adaptive repartitioning, host-offload streaming, checkpoint/resume) and
the batched query service (--serve) through the apps, and dynamic graphs
(lux_tpu_torch.mutate: churn, warm refresh, compaction, the plan cache).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It takes no options: the main path is the repository's headline size,
RMAT scale 20, edge factor 16, seed 0, 10 iterations; for collaborative
filtering (K = 20) that is the rating graph bipartite_ratings(2^19, 2^19,
2^23): 2^20 vertices, 2^24 edges.

Phases, each printing one JSON line with its seconds:
  1. device   the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build    nvcc of the seven kernel sources, all in parallel, and g++ of
              the native route colorer; seconds of each.
  3. kernels  spmv_blockcsr and mxscan_segmented against their plain
              PyTorch versions, at a small ragged shape and at the main
              path's shape, for sum/min/max in f32 and int32 (and bf16
              sum for the SpMV).  min/max/int32 must be bitwise equal;
              f32 sums of positive values within rtol 1e-5 (the kernels
              associate the sum in another order than the plain
              versions), and two calls bitwise equal.  Then each
              kernel's stress case, timed: the SpMV on the main layout's
              slot count with one vertex holding every slot, and the scan
              at 2^24 elements with one segment (a head at 0 only); their
              f32 sums within rtol 1e-5 of the same sums in float64 (the
              plain f32 versions round a 17 M-term sum themselves), the
              scan's min/max/int32 bitwise.  Each kernel's launches
              (grid, threads, shared-memory bytes).
  4. plan     the routed plans of the main graph, each family built once
              and reused below: expand, its pass-fused form, the fused
              (group) plan and its pass-fused form, and fused-mx; for
              each its spaces, digits, kernel and step counts, seconds,
              colorer (the native one must have run) and threads.
  5. routed   the four routed-pull kernels against their plain versions:
              lane_gather (u8/int32 indices, f32/bf16/int32 values, small
              row counts and the main path's (2^24/128, 128)),
              sublane_gather (d = 2, 4, 8 at a small and a 2^21-column
              shape), fused_pass_gather on every group of the main
              expand-pf plan (with each tile size's launch and the CTAs
              an SM holds), mxreduce_pass_gather on the main fused-mx
              plan's reduce group (sum/min/max, f32 and int32; its
              chunks, grid and the CTAs an SM holds) and, on the same
              values, a rank map whose one output block holds every
              tile.  Gathers and mx min/max/int32 bitwise, mx f32 sums
              within rtol 1e-5 of the same sums in float64 (the plain
              version's f32 index_add_ rounds a hub's sum in atomic
              order, near that tolerance itself).  Beside them the
              path-level yardsticks: the whole routed expand against
              index_select, and the fused-mx apply against index_select
              plus the mxscan segment sum (both held to float64 sums).
              Then one torch.profiler session traces the three-launch
              kernels' f32 sums at the main shapes and prints each
              launch's device time: spmv_blockcsr (fill, spans, fold),
              mxscan_segmented (tiles, carries, apply) and
              mxreduce_pass_gather (fill, chunks, fold; the fold's share).
  6. main     `apps.pagerank`, 10 iterations with -check, for --method
              pallas, --method mxscan, and --route-gather expand, the bare
              flag (must resolve to expand-pf), fused, fused-pf and
              fused-mx (mxscan wherever the reduce is not fused).  Each
              run: check_ranks 0 bad vertices, ranks within rtol 1e-4 of
              the float64 oracle (10 iterations of float32 accumulation
              over segments of up to ~1e5 edges), the launch counter of
              its kernel >= the iteration count (every counter is set to
              0 just before the run).  The expand modes' ranks must equal
              the direct mxscan run's bit for bit, fused-pf's fused's.
  7-8. cf_kernel, cf_plan, cf_main, cf_accuracy: collaborative
              filtering's kernel against its plain version, its routed
              plans, the app's runs and the libraries against a float64
              oracle.
  9. push_main `apps.sssp` at RMAT 20 / ef 16 from the vertex with the
              largest out-degree, with -check, under --method mxscan, scan
              and scatter and --route-gather expand-pf and expand (mxscan
              beside them; the plans of phase 4, not planned again).  Each
              run: GTEPS on the traversed edges, ms, iterations, dense
              rounds, traversed edges; its kernels launched at least once
              per dense round.  The five distance arrays bitwise equal,
              with equal iterations and traversed edges, and equal to a
              BFS of scipy.sparse.csgraph from the same start, computed in
              the spawned pool.
  10. cc_main `apps.components` under the same five modes, and the pull
              form (models/components.connected_components, mxscan) once;
              every label array bitwise equal, and equal to the max-label
              fixpoint that the pool iterates with np.maximum.at.  Then
              push_race: one dense round of each app (gather, relax,
              segmented min/max, apply) under scan, scatter and mxscan,
              timed on the converged state: the cuda winners of min/max.
  11. spec_main the spec workloads through `apps.run`, each run with
              -check, its launches, GTEPS, the memory estimate it printed
              and the card's peak memory: bfs on the main graph from the
              four largest out-degrees under mxscan, scatter, scan and
              --route-gather expand-pf (phase 4's plan), bitwise equal in
              distances, iterations, traversed edges and dense rounds, and
              equal to scipy's shortest paths; --engine pull once, equal.
              kcore on the symmetrized main graph under mxscan and scatter,
              bitwise equal, equal to a host peel; at RMAT 16 direct,
              fused-mx and expand-pf (plans built once here), bitwise
              equal.  labelprop (8 labels, seed stride 16, 10 iterations)
              under auto and scatter, within rtol 2e-4, atol 1e-6 of a
              float64 oracle.  triangles on the symmetrized weighted RMAT
              15 graph (nv = 2^15, 1,024 bitset words) under mxscan and
              scatter, within check_triangles' tolerance of a bitset
              oracle.  The oracles run in the spawned pool.  Then
              spec_kernels: the slice's new kernel callers against their
              plain versions, timed: the scan kernel's int32 sum over
              k-core's layout (31.4 M slots, bitwise) and its f32 sum over
              triangle phase 2's weighted, destination-dependent values
              (against the same sum in float64); the mx kernel's int32 sum
              on the RMAT 16 fused-mx plan.
  12. sum_race one segmented sum of one pull iteration at RMAT 20 per
              method (scan, scatter, mxscan, mxsum): the PageRank f32 sum
              and the k-core int32 sum; integer sums bitwise equal, f32
              sums' error against float64 recorded (only methods within
              rtol 1e-5 may win).  The f32 winner is the cuda sum row of
              engine/methods.WINNERS, printed beside it.
  13. delta_main weighted SSSP (the main graph's edges, integer weights
              1..100) from its largest out-degree through `apps.sssp`:
              chaotic, --delta 25 and 100, and --delta 100 with
              --route-gather expand-pf (phase 4's plan); all bitwise equal
              and equal to scipy's Dijkstra (the pool).  Rounds, traversed
              edges, ms, GTEPS, launches; the scan kernel's int32 min at
              one dense round of the weighted layout against its plain
              version.
  14. repart_main SSSP (from the lowest-numbered vertex of out-degree 1:
              a BFS with a sparse start) and components with -ng 4 on the
              card, static and --repartition-every 2 (threshold 1.05), and
              SSSP with --repartition-every 1, which must recut:
              equal to each other and to phase 9-10's oracles; each
              recut's window imbalance and that window's work under the
              new cuts; ms against the static run.
  15. stream_main PageRank (10 iterations) and components on RMAT 22
              through --stream-hbm-gib 0.3: PageRank within rtol 1e-4 of
              its float64 oracle (the pool), components bitwise the
              resident pull run, prefetch on and off bitwise; chunks a
              part, bytes an iteration, ms an iteration with prefetch on
              and off, the rate of a plain pinned copy of the same bytes
              and the link bound it gives, peak memory (at most the
              budget) beside the estimate; the scan kernel on one chunk whose first
              segment began in an earlier chunk (f32 sum against float64,
              int32 max bitwise).
  16. ckpt_main  runs cut and resumed from their checkpoints, bitwise the
              uninterrupted runs: PageRank --ckpt-every 5 (5, then 10),
              SSSP --delta 25 --ckpt-every 2 and components --ckpt-every
              2, each cut at half its rounds; the seconds a save takes and
              its bytes on disk.
  17. serve_main the batched query service on the main graph: `apps.sssp
              --serve --serve-queries 64 --serve-buckets 1,8,64 -check` and
              `apps.pagerank --serve -ni 10 --serve-queries 64 -check`
              (QPS, latency p50/p95/p99, batch occupancy, warm hit ratio,
              the estimate and the peak memory); every SSSP answer 0 at its
              source with no triangle-inequality violation, the first 8
              bitwise a scipy BFS from the same source and the first 4 PPR
              answers within rtol 1e-4 of the float64 oracle (both in the
              pool); then serve/benchmarks.measure_serving (SSSP, Q = 64,
              4 sequential Q = 1 queries, one batch: bench.py's serving
              row) under auto and scatter, and one batched iteration's
              gather, edge, reduce and apply timed under the plain scan and
              scatter.  No kernel lies on this path: auto's mxscan falls
              back to the plain scan on (E, Q) values.
  18. mutate_main dynamic graphs (the reference's refresh row,
              bench.py:1130-1330) on the main graph at 8 parts stacked on
              the card: priors (PageRank's exact fixpoint, SSSP from the
              largest out-degree, components), a one-edge warm-up batch
              refreshed, the 1 % churn (k = ne / 200 deletes, then k
              inserts, default_rng(0)) applied as two batches; the three
              warm refreshes timed best of two (two runs bitwise equal);
              batched SSSP serving (Q = 64, scatter) through a
              WarmEngineCache holding the overlay and the scheduler;
              compaction (snapshot + plan-cache invalidation report);
              the cold legs (read_lux, the shard builds with the same
              cuts, the expand-pf plan through the cached planner built
              on an empty cache and loaded again, the cold runs).  Warm
              SSSP and components bitwise the cold ones, scipy's BFS and
              the max-label fixpoint of the merged graph (the pool builds
              it by position, independently of the delta-log); PageRank
              warm and cold within rtol 1e-4 of the float64 fixpoint, their
              ulp distance printed; the served answers bitwise the
              compacted graph's engine, the first 8 scipy's BFS.  Then a
              churn confined to one part (invalidated fraction 1/8, the
              warm cache rebuilds that part alone) and the routed refresh
              on the one-part layout with phase 4's expand-pf, fused-pf
              and fused-mx plans (expand-pf bitwise the direct refresh,
              the fused ones within 1e-6; three max-label overlay
              iterations under each bitwise the cold merged-graph step;
              each kernel's launches in one iteration equal with the
              overlay and without).  Last, the four kernels of the path on
              the overlay's inputs against their plain versions: the scan
              on tombstone-masked values, the mx kernel with tombstoned
              ranks in the middle of tiles (timed), and every tombstoned
              routed replay bitwise its run on the plain versions.
Times: kernel, plain, one PyTorch library call where one computes the
same function, and the bound: the bytes the function must move over the
card's memory rate (every kernel here does at most one add or compare
per 4 bytes moved, so its operation time is far below it).
Then the kernel table as one JSON line (each row's launches on the
PageRank main path, and beside them on the push paths: one SSSP and one
components run of the mode that runs that kernel, on the spec paths
one bfs, one kcore and one triangles run, and on the long runs one delta,
one adaptive SSSP, one streamed PageRank and one resumed PageRank run,
on the serving path the whole of phase 17, and on the dynamic-graph path
phase 18 up to the kernels' comparisons), the smoke's seconds, the
nvidia-smi line, and the verdict line {"ok": true, "device": {...}}
last.  Any failed phase exits
non-zero before the verdict; so does a machine without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

SCALE, EF, ITERS = 20, 16, 10  # the main path: RMAT 20 / ef 16, 10 iterations
REPS = 20  # timed launches per kernel
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SUM_RTOL = 1e-5
RANK_RTOL = 1e-4
ROUTED = ("expand", "", "fused", "fused-pf", "fused-mx")  # "" = the bare flag
#: the kernel each main-path run must have launched >= ITERS times
RUN_KERNEL = {"pallas": "spmv_blockcsr", "mxscan": "mxscan_segmented",
              "expand": "lane_gather", "expand-pf": "fused_pass_gather",
              "fused": "lane_gather", "fused-pf": "fused_pass_gather",
              "fused-mx": "mxreduce_pass_gather"}
CF_K = 20  # latent features (models/colfilter.K)
CF_ROUTED_SCALE = 18  # the routed CF runs: two expand plans each
CF_GAMMA = 1e-3  # the accuracy runs' step (the app's 3.5e-7 barely moves)
CF_RTOL = 1e-4  # against the f64 oracle: 10 iterations of f32 sums
#: the kernel each CF run must have launched >= ITERS times
CF_RUN_KERNEL = {"pallas": "spmv_blockcsr_2d", "expand-pf": "fused_pass_gather",
                 "expand": "lane_gather"}


#: the push apps' runs: (label, the app's extra flags, the phase-4 plan)
PUSH_RUNS = (("mxscan", ["--method", "mxscan"], None), ("scan", ["--method", "scan"], None),
             ("scatter", ["--method", "scatter"], None),
             ("expand-pf", ["--route-gather", "expand-pf", "--method", "mxscan"], "expand-pf"),
             ("expand", ["--route-gather", "expand", "--method", "mxscan"], "expand"))
#: the kernels each push run must launch, at least once per dense round
PUSH_RUN_KERNELS = {"mxscan": ("mxscan_segmented",),
                    "expand-pf": ("fused_pass_gather", "mxscan_segmented"),
                    "expand": ("lane_gather", "mxscan_segmented")}
#: the push run whose launches the kernel table gives for each kernel
PUSH_KERNEL_RUN = {"mxscan_segmented": "mxscan", "fused_pass_gather": "expand-pf",
                   "lane_gather": "expand"}
RACE = ("scan", "scatter", "mxscan")  # the dense round's segment-reduce methods
SUM_RACE = ("scan", "scatter", "mxscan", "mxsum")  # the sum's methods
SPEC_SOURCES = 4  # bfs: the largest out-degrees
#: bfs runs (label, the app's flags, whether it replays the phase-4 expand-pf plan)
BFS_RUNS = (("mxscan", ["--method", "mxscan"], False),
            ("scatter", ["--method", "scatter"], False),
            ("scan", ["--method", "scan"], False),
            ("expand-pf", ["--route-gather", "expand-pf", "--method", "mxscan"], True))
KCORE_ROUTED_SCALE = 16  # routed k-core: plans at RMAT 20 take minutes a family
KCORE_ROUTED = ("fused-mx", "expand-pf")
LP_LABELS, LP_STRIDE = 8, 16  # labelprop: the reference's defaults
LP_RTOL, LP_ATOL = 2e-4, 1e-6  # against the float64 oracle (tests/test_program.py:503)
TRI_SCALE = 15  # triangles: nv = TRIANGLES_MAX_NV, the reference's ceiling
#: per program, the run whose launches the kernel table gives for each kernel
SPEC_KERNEL_RUN = {
    "bfs": {"mxscan_segmented": "bfs-mxscan", "fused_pass_gather": "bfs-expand-pf",
            "lane_gather": "bfs-expand-pf"},
    "kcore": {"mxscan_segmented": "kcore-mxscan", "mxreduce_pass_gather": "kcore16-fused-mx",
              "fused_pass_gather": "kcore16-fused-mx", "lane_gather": "kcore16-expand-pf"},
    "triangles": {"mxscan_segmented": "triangles-mxscan"}}


#: the long and out-of-core runs (phases 13-16)
DELTA_WIDTHS = (25, 100)  # --delta widths: a quarter of the weight ceiling, and all of it
DELTA_ROUTED = 100  # the routed delta run's width
#: -ng, --repartition-every, and a tight --repartition-threshold, so that the
#: recut path runs at this size
REPART_PARTS, REPART_EVERY, REPART_THRESHOLD = 4, 2, 1.05
#: the streamed runs: RMAT 22 through a 0.3 GiB budget (the vertex side
#: alone takes 0.24 GiB of it, so the edges move in ~35 chunks)
STREAM_SCALE, STREAM_GIB = 22, 0.3
STREAM_MIN_CHUNKS = 4  # every part must stream in at least this many chunks
CKPT_PR_EVERY, CKPT_DELTA_EVERY, CKPT_CC_EVERY = 5, 2, 2  # --ckpt-every
SERVE_Q = 64  # the serving row's batch (bench.py:918-921): Q = 64, one part
SERVE_BUCKETS = "1,8,64"  # the warm Q buckets of the SSSP service
SERVE_BFS = 8  # SSSP answers held to scipy's BFS
SERVE_PPR = 4  # PPR answers held to the float64 oracle
SERVE_METHODS = ("auto", "scatter")  # measure_serving's runs
F32_TINY = 1.1754944e-38  # below the smallest normal f32: subnormal rounding
#: per kernel, the long runs whose launches the kernel table gives
LONG_KERNEL_RUN = {
    "mxscan_segmented": {"delta": ("delta", f"delta-{DELTA_ROUTED}"),
                         "repart": ("repart", "sssp"), "stream": ("stream", "pagerank"),
                         "ckpt": ("ckpt", "pagerank")},
    "fused_pass_gather": {"delta": ("delta", f"delta-{DELTA_ROUTED}-expand-pf")},
    "lane_gather": {"delta": ("delta", f"delta-{DELTA_ROUTED}-expand-pf")}}


#: the process pool of the host oracles and the scratch directory of the
#: generated graphs and checkpoints, removed on every exit path
_POOL = None
_TMP = None


class PhaseFailure(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, between
    CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def compare(torch, got, want, exact: bool, mask=None, what: str = "kernel") -> float:
    """Max abs difference; raises PhaseFailure past the tolerance."""
    if mask is not None:
        got, want = got[mask], want[mask]
    if exact:
        require(torch.equal(got, want), f"{what} differs from its plain version")
        return 0.0
    g64, w64 = got.double(), want.double()
    diff = (g64 - w64).abs()
    err = float(diff.max()) if got.numel() else 0.0
    bad = diff > SUM_RTOL * w64.abs()
    if bool(bad.any()):
        i = int(torch.argmax((diff / w64.abs().clamp_min(1e-300)) * bad))
        raise PhaseFailure(f"{what}: f32 sum outside rtol {SUM_RTOL} at {int(bad.sum())} "
                           f"places: max abs err {err}; worst at {i}: got {float(g64[i])}, "
                           f"want {float(w64[i])}")
    return err


def spmv_cases(torch, np, spmv, bc, dev, reps: int, timed: bool):
    """Every supported spmv case on one block-CSR layout; returns rows."""
    rng = np.random.default_rng(7)
    C, T = bc.e_dst_rel.shape
    e_dst = torch.from_numpy(bc.e_dst_rel).to(dev)
    cb = torch.from_numpy(bc.chunk_block).to(dev)
    cf = torch.from_numpy(bc.chunk_first).to(dev)
    nv_pad = bc.num_vblocks * bc.v_blk
    state_f = torch.from_numpy(rng.random(nv_pad, dtype=np.float32) + 0.01).to(dev)
    state_i = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, nv_pad, dtype=np.int64).astype(np.int32)).to(dev)
    e_src = torch.from_numpy(bc.e_src_pos).to(dev).long()
    flat_dst = torch.from_numpy(np.where(
        bc.e_dst_rel < bc.v_blk,
        bc.chunk_block[:, None].astype(np.int64) * bc.v_blk + bc.e_dst_rel,
        nv_pad).reshape(-1)).to(dev)
    rows = []
    for op, dtype in (("sum", torch.float32), ("sum", torch.bfloat16),
                      ("min", torch.float32), ("max", torch.float32),
                      ("min", torch.int32), ("max", torch.int32)):
        src = state_i if dtype == torch.int32 else state_f.to(dtype)
        vals = src[e_src].contiguous()

        def kernel():
            return spmv.spmv_blockcsr(vals, e_dst, cb, cf, op=op, v_blk=bc.v_blk,
                                      num_vblocks=bc.num_vblocks)

        def plain():
            return spmv.spmv_blockcsr_plain(vals, e_dst, cb, cf, op=op, v_blk=bc.v_blk,
                                            num_vblocks=bc.num_vblocks)

        exact = op != "sum"
        got = kernel()
        # sums: the same sums in float64; the plain version's f32 index_add_
        # rounds a hub's ~7e4 values in atomic order, itself near rtol 1e-5
        want = plain() if exact else torch.zeros(
            nv_pad + 1, dtype=torch.float64, device=dev).index_add_(
                0, flat_dst, vals.reshape(-1).double())[:nv_pad]
        torch.cuda.synchronize()
        what = f"spmv {op} {dtype}"
        err = compare(torch, got, want, exact, what=what)
        require(torch.equal(got, kernel()), f"{what}: two calls differ")
        row = {"op": op, "dtype": str(dtype).replace("torch.", ""),
               "shape": [C, T], "max_abs_err": err, "exact": exact}
        if timed:
            out_bytes = nv_pad * got.element_size()
            nbytes = C * T * (vals.element_size() + 4) + out_bytes
            library_ms = None
            if op == "sum":
                vflat = vals.reshape(-1).float() if dtype != torch.float32 else vals.reshape(-1)
                library_ms = time_ms(torch, lambda: torch.zeros(
                    nv_pad + 1, device=dev).index_add_(0, flat_dst, vflat), reps)
            row.update(kernel_ms=time_ms(torch, kernel, reps),
                       plain_ms=time_ms(torch, plain, max(2, reps // 4)),
                       library_ms=library_ms, bound_ms=bound_ms(nbytes),
                       bytes=nbytes)
        rows.append(row)
    return rows


def scan_cases(torch, np, scan, head, valid_end, invalid, values_f, dev,
               reps: int, timed: bool):
    """Every supported scan case on one (head, validity) geometry."""
    rng = np.random.default_rng(11)
    n = head.shape[0]
    vals_i = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)).to(dev)
    if valid_end is not None:
        mask = torch.arange(n, device=dev) < valid_end.item()
    else:
        mask = ~invalid
    rows = []
    for op, dtype in (("sum", torch.float32), ("min", torch.float32),
                      ("max", torch.float32), ("sum", torch.int32),
                      ("min", torch.int32), ("max", torch.int32)):
        vals = vals_i if dtype == torch.int32 else values_f

        def kernel():
            return scan.mxscan_segmented(vals, head, invalid, op=op, valid_end=valid_end)

        def plain():
            return scan.mxscan_segmented_plain(vals, head, invalid, op=op,
                                               valid_end=valid_end)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        exact = not (op == "sum" and dtype == torch.float32)
        what = f"scan {op} {dtype}"
        err = compare(torch, got, want, exact, mask, what=what)
        require(torch.equal(got, kernel()), f"{what}: two calls differ")
        row = {"op": op, "dtype": str(dtype).replace("torch.", ""), "n": n,
               "max_abs_err": err, "exact": exact}
        if timed:
            nbytes = n * (vals.element_size() + 1 + vals.element_size())
            row.update(kernel_ms=time_ms(torch, kernel, reps),
                       plain_ms=time_ms(torch, plain, max(2, reps // 4)),
                       library_ms=None, bound_ms=bound_ms(nbytes), bytes=nbytes)
        rows.append(row)
    return rows


def timed(rows, op="sum", dtype="float32"):
    """The timed row of ``op`` and ``dtype`` among a kernel's case rows."""
    return next(r for r in rows if "kernel_ms" in r and r["op"] == op
                and r["dtype"] == dtype)


def traced_splits(torch, groups: dict, reps: int = 5) -> dict:
    """Device milliseconds per call of each launch of several wrappers,
    from ONE torch.profiler session (a later session in this process came
    back with no device events).  ``groups`` maps a wrapper's label to
    (fn, parts), ``parts`` a launch's label to a substring of its
    kernel's name.  Each group's ``reps`` calls follow a marker kernel
    (torch.cuda._sleep's), so a launch counts for the group whose marker
    it follows, whatever names the groups share; None where the group's
    window holds no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn, _ in groups.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn, _ in groups.values():
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    windows = []
    for e in events:
        if "spin_kernel" in e.name:
            windows.append([])
        elif windows:
            windows[-1].append(e)
    if len(windows) != len(groups):
        windows = [[] for _ in groups]
    return {label: {part: sum(e.time_range.elapsed_us() for e in win if sub in e.name)
                    / 1e3 / reps if any(sub in e.name for e in win) else None
                    for part, sub in parts.items()}
            for (label, (_, parts)), win in zip(groups.items(), windows)}


def spmv_hub_case(torch, np, spmv, bc, dev, reps: int, main_ms: float):
    """spmv_blockcsr on the main layout's slot count with one vertex holding
    every slot (chunk_block and e_dst_rel all 0): a run the old one-warp
    design walked serially.  f32 sums against float64 sums (the plain
    version's f32 index_add_ rounds a 17 M-term sum in atomic order and is
    no yardstick there), then timed beside the main layout's time."""
    C, T = bc.e_dst_rel.shape
    rng = np.random.default_rng(19)
    vals = torch.from_numpy(rng.random((C, T), dtype=np.float32) + 0.01).to(dev)
    e_dst = torch.zeros((C, T), dtype=torch.int32, device=dev)
    cb = torch.zeros(C, dtype=torch.int32, device=dev)
    cf = torch.zeros(C, dtype=torch.int32, device=dev)
    cf[0] = 1
    kw = dict(op="sum", v_blk=bc.v_blk, num_vblocks=bc.num_vblocks)
    got = spmv.spmv_blockcsr(vals, e_dst, cb, cf, **kw)
    want = torch.zeros(got.shape, dtype=torch.float64, device=dev)
    want[0] = vals.double().sum()
    torch.cuda.synchronize()
    err = compare(torch, got, want, exact=False, what="spmv, one vertex holding every slot")
    require(torch.equal(got, spmv.spmv_blockcsr(vals, e_dst, cb, cf, **kw)),
            "spmv, one vertex holding every slot: two calls differ")
    kernel_ms = time_ms(torch, lambda: spmv.spmv_blockcsr(vals, e_dst, cb, cf, **kw), reps)
    nbytes = C * T * 8 + got.numel() * 4
    return {"shape": [C, T], "op": "sum", "dtype": "float32", "max_abs_err": err,
            "rtol_vs_f64": SUM_RTOL, "kernel_ms": kernel_ms,
            "plain_ms": time_ms(torch, lambda: spmv.spmv_blockcsr_plain(vals, e_dst, cb, cf, **kw),
                                max(2, reps // 4)),
            "bound_ms": bound_ms(nbytes), "bytes": nbytes, "main_ms": main_ms,
            "ratio_to_main": kernel_ms / main_ms}


def scan_one_segment_case(torch, np, scan, dev, reps: int, main_ms: float, n: int = 1 << 24):
    """mxscan_segmented at n = 2^24 elements with one segment (a head at 0
    only), so every tile's carry runs through all the tiles before it.
    min/max/int32 bitwise against the plain version; f32 sums of positive
    values within rtol 1e-5 of float64 prefix sums (a 16.7 M-term prefix in
    the plain f32 ladder is no yardstick); the f32 sum timed."""
    rng = np.random.default_rng(12)
    head = torch.zeros(n, dtype=torch.bool, device=dev)
    head[0] = True
    vals_f = torch.from_numpy(rng.random(n, dtype=np.float32) + 0.01).to(dev)
    vals_i = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)).to(dev)
    rows, timing = [], {}
    for op, vals in (("sum", vals_f), ("min", vals_f), ("max", vals_f), ("sum", vals_i),
                     ("min", vals_i), ("max", vals_i)):
        exact = not (op == "sum" and vals.dtype == torch.float32)
        got = scan.mxscan_segmented(vals, head, op=op)
        want = (scan.mxscan_segmented_plain(vals, head, op=op) if exact
                else torch.cumsum(vals.double(), 0))
        torch.cuda.synchronize()
        what = f"scan {op} {vals.dtype}, one segment over {n} elements"
        err = compare(torch, got, want, exact, what=what)
        require(torch.equal(got, scan.mxscan_segmented(vals, head, op=op)),
                f"{what}: two calls differ")
        del want
        rows.append({"op": op, "dtype": str(vals.dtype).replace("torch.", ""),
                     "max_abs_err": err, "exact": exact})
        if not exact:
            timing = {"kernel_ms": time_ms(torch, lambda: scan.mxscan_segmented(
                vals_f, head, op="sum"), reps)}
    nbytes = n * (4 + 1 + 4)
    return {"n": n, "heads": 1, "cases": rows, "rtol_vs_f64": SUM_RTOL,
            "max_abs_err": max(r["max_abs_err"] for r in rows), "bound_ms": bound_ms(nbytes),
            "bytes": nbytes, "main_ms": main_ms, **timing,
            "ratio_to_main": timing["kernel_ms"] / main_ms}


def ragged_graph(np, csc):
    """A small graph with the block-CSR corner cases: a ragged last block,
    a hub vertex spanning several chunks, empty vertex blocks, and an
    all-padding tail."""
    rng = np.random.default_rng(5)
    nv = 5000
    dst = np.concatenate([rng.integers(0, 1500, 20000), np.full(3000, 2100),
                          rng.integers(4000, nv, 700)])
    src = rng.integers(0, nv, dst.shape[0])
    return csc.from_edge_list(src, dst, nv)


def counters(spmv, scan, shuffle) -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    return {"spmv_blockcsr": spmv.spmv_blockcsr, "spmv_blockcsr_2d": spmv.spmv_blockcsr_2d,
            "mxscan_segmented": scan.mxscan_segmented, **shuffle.KERNELS}


def timed_plan(native, route_mod, shuffle, mode: str, build):
    """Run ``build()`` (a routed planner) and return (plan, report): its
    spaces, digits, kernel and step counts, seconds, which colorer ran
    (native True / numpy False / None when no coloring ran, as in a
    to_pf upgrade) and on how many threads."""
    route_mod.reset_color_stats()
    t0 = time.perf_counter()
    plan = build()
    seconds = time.perf_counter() - t0
    static, arrays = plan
    calls = dict(route_mod.COLOR_STATS)
    rep = {"mode": mode, "n": static.n, "n2": getattr(static, "n2", None),
           "seconds": seconds, "arrays": len(arrays),
           "bytes": int(sum(a.nbytes for a in arrays)),
           "native": None if not any(calls.values()) else calls["numpy"] == 0,
           "colorer_calls": calls, "threads": native.route_threads()}
    for k in ("r1", "r2", "vr"):
        r = getattr(static, k, None)
        if r is not None:
            rep[k] = {"dims": list(r.dims), "kernels": shuffle.route_num_hbm_passes(r),
                      "steps": shuffle.route_num_arrays(r)}
    if getattr(static, "mx", None) is not None:
        rep["mx_steps"] = len(static.mx.steps)
    return plan, rep


def lane_cases(torch, np, shuffle, dev, main_idx, reps: int):
    """lane_gather against torch.gather: small row counts for every
    value/index type, then the main path's shape with a real pass's
    indices (timed)."""
    rng = np.random.default_rng(13)
    n_cases = 0
    for rows in (1, 2, 4, 1000):
        for idt in (torch.uint8, torch.int32):
            for dt in (torch.float32, torch.bfloat16, torch.int32):
                x = torch.from_numpy(rng.integers(-2**20, 2**20, (rows, 128))
                                     .astype(np.int32)).to(dev)
                x = x if dt == torch.int32 else x.to(dt)
                idx = torch.from_numpy(rng.integers(0, 128, (rows, 128))
                                       .astype(np.int32)).to(dev).to(idt)
                got = shuffle.lane_gather(x, idx)
                require(torch.equal(got, shuffle.lane_gather_plain(x, idx)),
                        f"lane_gather differs at rows={rows} {dt} {idt}")
                n_cases += 1
    x = torch.from_numpy(rng.random(main_idx.shape, dtype=np.float32)).to(dev)
    got = shuffle.lane_gather(x, main_idx)
    torch.cuda.synchronize()
    require(torch.equal(got, shuffle.lane_gather_plain(x, main_idx)),
            "lane_gather differs at the main shape")
    idx64 = main_idx.long()
    n = x.numel()
    return {"cases": n_cases, "shape": list(x.shape), "idx": "uint8",
            "max_abs_err": 0.0,
            "kernel_ms": time_ms(torch, lambda: shuffle.lane_gather(x, main_idx), reps),
            "plain_ms": time_ms(torch, lambda: shuffle.lane_gather_plain(x, main_idx), reps),
            "library_ms": time_ms(torch, lambda: torch.gather(x, 1, idx64), reps),
            "bound_ms": bound_ms(n * (2 * 4 + 1)), "bytes": n * (2 * 4 + 1)}


def sublane_cases(torch, np, shuffle, dev, reps: int):
    rng = np.random.default_rng(14)
    out = {"cases": []}
    for d in (2, 4, 8):
        for length in (1000, 1 << 21):
            x = torch.from_numpy(rng.random((d, length), dtype=np.float32)).to(dev)
            idx = torch.from_numpy(rng.integers(0, d, (d, length)).astype(np.uint8)).to(dev)
            got = shuffle.sublane_gather(x, idx)
            torch.cuda.synchronize()
            require(torch.equal(got, shuffle.sublane_gather_plain(x, idx)),
                    f"sublane_gather differs at d={d} L={length}")
            out["cases"].append([d, length])
    idx64 = idx.long()
    n = x.numel()
    out.update(shape=list(x.shape), max_abs_err=0.0,
               kernel_ms=time_ms(torch, lambda: shuffle.sublane_gather(x, idx), reps),
               plain_ms=time_ms(torch, lambda: shuffle.sublane_gather_plain(x, idx), reps),
               library_ms=time_ms(torch, lambda: torch.gather(x, 0, idx64), reps),
               bound_ms=bound_ms(n * (2 * 4 + 1)), bytes=n * (2 * 4 + 1))
    return out


def fused_cases(torch, np, shuffle, expand, plan_pf, dev, reps: int):
    """fused_pass_gather on every group of the main expand-pf plan, in
    replay order (each group's input is the previous group's output);
    with each tile size's launch and the CTAs one SM holds."""
    static, arrays = plan_pf
    r1a, _, r2a = expand.split_arrays(static, arrays)
    rng = np.random.default_rng(15)
    groups = []
    for name, rs, ra in (("r1", static.r1, r1a), ("r2", static.r2, r2a)):
        y = torch.from_numpy(rng.random(rs.n, dtype=np.float32)).to(dev)
        i = 0
        for g in rs.groups:
            y = shuffle._relayout(y, g.view, g.perm_axes).reshape(g.kshape)
            k = len(g.steps)
            idx = ra[i:i + k]
            got = shuffle.fused_pass_gather(y, idx, g)
            torch.cuda.synchronize()
            require(torch.equal(got, shuffle.fused_pass_gather_plain(y, idx, g)),
                    f"fused_pass_gather differs on {name} group {len(groups)}")
            n = y.numel()
            nbytes = n * (2 * 4 + k * idx[0].element_size())
            groups.append({
                "route": name, "steps": k, "block_rows": g.block_rows,
                "relayouts": sum(st.relayout is not None for st in g.steps),
                "kernel_ms": time_ms(torch, lambda: shuffle.fused_pass_gather(y, idx, g), reps),
                "plain_ms": time_ms(torch, lambda: shuffle.fused_pass_gather_plain(y, idx, g),
                                    max(2, reps // 4)),
                "bound_ms": bound_ms(nbytes), "bytes": nbytes})
            y, i = got.reshape(-1), i + k
    mean = {k: sum(g[k] for g in groups) / len(groups)
            for k in ("kernel_ms", "plain_ms", "bound_ms")}
    # the launch of each tile size (csrc/fused_pass_gather.cu): one CTA per
    # tile, a thread per 16-element unit up to 512, the f32 tile in shared
    # memory; __launch_bounds__(512, 2) holds two such CTAs on an SM
    launch = {f"block_rows={br}": {
        "ctas": static.r1.n // 128 // br, "threads": min(br * 128 // 16, 512),
        "smem_bytes": br * 128 * 4}
        for br in sorted({g["block_rows"] for g in groups})}
    return {"groups": groups, "launch": launch, "max_abs_err": 0.0, "library_ms": None, **mean}


def mx_sum_f64(torch, shuffle, y, idx, dst_rel, tile_block, g):
    """The mx group's sums in float64: the plain version's steps, then an
    index_add_ over flat ranks in float64 (the plain version itself sums
    floats in f32)."""
    z = shuffle._steps_plain(y, g.steps, idx).double()
    ranks = dst_rel.long()
    tile = torch.arange(z.shape[0], device=z.device) // g.block_rows
    flat = tile_block.long()[tile][:, None] * g.v_blk + ranks
    valid = ranks < g.v_blk
    out = torch.zeros(g.num_blocks * g.v_blk, dtype=torch.float64, device=z.device)
    return out.index_add_(0, flat[valid], z[valid])


def mx_cases(torch, np, shuffle, expand, plan_mx, dev, reps: int):
    """mxreduce_pass_gather on the main fused-mx plan's reduce group, for
    every op and value type, against its plain version.  Returns the
    record and the f32-sum call, to be traced."""
    static, arrays = plan_mx
    *_, mxa = expand.split_fused_arrays(static, arrays, static.weighted)
    mxg = static.mx
    k = len(mxg.steps)
    idx, dst_rel, tile_block = mxa[:k], mxa[k], mxa[k + 1]
    total = sum(c for _, c, _ in static.groups)
    rng = np.random.default_rng(16)
    n2 = static.n2
    xf = torch.from_numpy(rng.random(n2, dtype=np.float32) + 0.01).to(dev)
    xi = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, n2, dtype=np.int64)
                          .astype(np.int32)).to(dev)
    rows, err, timed = [], 0.0, {}
    for op, x in (("sum", xf), ("min", xf), ("max", xf), ("sum", xi), ("min", xi),
                  ("max", xi)):
        g = dataclasses.replace(mxg, op=op)
        y = shuffle._relayout(x, g.view, g.perm_axes).reshape(g.kshape)
        exact = not (op == "sum" and x.dtype == torch.float32)
        got = shuffle.mxreduce_pass_gather(y, idx, dst_rel, tile_block, g)
        # f32 sums: the plain version in float64.  In f32 its index_add_
        # accumulates one rank's values in atomic order, and at RMAT 20's
        # largest in-degrees that order's own rounding nears rtol 1e-5
        want = (shuffle.mxreduce_pass_gather_plain(y, idx, dst_rel, tile_block, g) if exact
                else mx_sum_f64(torch, shuffle, y, idx, dst_rel, tile_block, g))
        torch.cuda.synchronize()
        e = compare(torch, got[:total], want[:total], exact, what=f"mx {op} {x.dtype}")
        err = max(err, e)
        rows.append({"op": op, "dtype": str(x.dtype).replace("torch.", ""),
                     "max_abs_err": e, "exact": exact})
        if not exact:
            timed = {
                "kernel_ms": time_ms(torch, lambda: shuffle.mxreduce_pass_gather(
                    y, idx, dst_rel, tile_block, g), reps),
                "plain_ms": time_ms(torch, lambda: shuffle.mxreduce_pass_gather_plain(
                    y, idx, dst_rel, tile_block, g), max(2, reps // 4))}
    nbytes = (n2 * (4 + k * idx[0].element_size() + dst_rel.element_size())
              + mxg.num_blocks * mxg.v_blk * 4)
    per_block = torch.bincount(tile_block.long(), minlength=mxg.num_blocks)
    g = dataclasses.replace(mxg, op="sum")
    y = shuffle._relayout(xf, g.view, g.perm_axes).reshape(g.kshape)
    # a larger hub on the same values and steps: one output block holds
    # every tile, each of its v_blk ranks spans n2 / v_blk elements
    pos = torch.arange(n2, device=dev)
    hub_rel = torch.where(dst_rel.reshape(-1) < mxg.v_blk, pos * mxg.v_blk // n2,
                          mxg.v_blk).to(dst_rel.dtype).reshape(dst_rel.shape)
    hub_tb = torch.zeros_like(tile_block)
    hub = dataclasses.replace(g, num_blocks=1)
    got = shuffle.mxreduce_pass_gather(y, idx, hub_rel, hub_tb, hub)
    # a rank here sums 2^18 values: held to float64 sums, whose own
    # rounding stays far below rtol 1e-5 (the plain version's f32 would not)
    want = mx_sum_f64(torch, shuffle, y, idx, hub_rel, hub_tb, hub)
    torch.cuda.synchronize()
    hub_err = compare(torch, got, want, exact=False, what="mx, one block holding every tile")
    return {"cases": rows, "n2": n2, "steps": k, "tile_rows": mxg.block_rows,
            "num_blocks": mxg.num_blocks, "v_blk": mxg.v_blk, "max_abs_err": max(err, hub_err),
            # the output blocks' sizes, which the chunked grid no longer follows
            "max_tiles_per_block": int(per_block.max()),
            "mean_tiles_per_block": float(per_block.float().mean()),
            "largest_block_share": float(per_block.max()) / tile_block.numel(),
            # a CTA of 512 threads per chunk, its values in shared memory,
            # then one CTA folds the chunks' summaries
            "launch": {"chunk_ctas": shuffle.mx_num_chunks(y.shape[0], mxg.block_rows),
                       "chunk_threads": 512, "chunk_smem_bytes": shuffle.MX_MAX_TILE_ELEMS * 4,
                       "fold_ctas": 1},
            "hub": {"largest_block_share": 1.0, "max_abs_err": hub_err,
                    "kernel_ms": time_ms(torch, lambda: shuffle.mxreduce_pass_gather(
                        y, idx, hub_rel, hub_tb, hub), reps),
                    "plain_ms": time_ms(torch, lambda: shuffle.mxreduce_pass_gather_plain(
                        y, idx, hub_rel, hub_tb, hub), max(2, reps // 4))},
            "library_ms": None, "bound_ms": bound_ms(nbytes), "bytes": nbytes,
            **timed}, functools.partial(shuffle.mxreduce_pass_gather, y, idx, dst_rel, tile_block, g)


def path_yardsticks(torch, np, expand, segment, sh, plans, dev, reps: int):
    """The whole routed expand against index_select of the same state,
    and the whole fused-mx apply against index_select + the mxscan
    segment sum: the routed replay's cost beside the direct path's.  Both
    f32 sums are held to the same sums in float64 (rtol 1e-5), not to
    each other: each associates a hub's ~10^5 values its own way."""
    rng = np.random.default_rng(17)
    full = torch.from_numpy(rng.random(sh.spec.gathered_size, dtype=np.float32)
                            + 0.01).to(dev)
    src_pos = torch.from_numpy(sh.arrays.src_pos[0]).to(dev)
    row_ptr = torch.from_numpy(sh.arrays.row_ptr[0]).to(dev)
    head = torch.from_numpy(sh.arrays.head_flag[0]).to(dev)
    m = int(sh.arrays.edge_mask[0].sum())
    out = {"direct_gather_ms": time_ms(torch, lambda: full.index_select(0, src_pos), reps)}
    want = full.index_select(0, src_pos)
    for mode in ("expand", "expand-pf"):
        st, arr = plans[mode]
        part = tuple(a[0] for a in arr)
        got = expand.apply_expand(full, st, part)
        torch.cuda.synchronize()
        require(torch.equal(got[:m], want[:m]), f"routed {mode} differs from index_select")
        out[f"{mode}_ms"] = time_ms(torch, lambda: expand.apply_expand(full, st, part), reps)

    def direct_sum():
        return segment.segment_sum_csc(full.index_select(0, src_pos), row_ptr, head,
                                       method="mxscan")

    def direct_sum_f64():
        """The same segment sums in float64 (a cumulative sum's differences),
        the reference both f32 paths are held to."""
        vals = full.double().index_select(0, src_pos)
        cs = torch.zeros(vals.numel() + 1, dtype=torch.float64, device=dev)
        torch.cumsum(vals, 0, out=cs[1:])
        rp = row_ptr.long()
        return cs[rp[1:]] - cs[rp[:-1]]

    st, arr = plans["fused-mx"]
    part = tuple(a[0] for a in arr)
    got = expand.apply_fused(full, st, part)
    want = direct_sum_f64()
    torch.cuda.synchronize()
    compare(torch, got, want, exact=False, what="the fused-mx apply against f64 segment sums")
    compare(torch, direct_sum(), want, exact=False,
            what="index_select + mxscan against f64 segment sums")
    out["fused-mx_ms"] = time_ms(torch, lambda: expand.apply_fused(full, st, part), reps)
    out["direct_gather_mxscan_ms"] = time_ms(torch, direct_sum, reps)
    return out


def cf_argv(scale: int) -> list:
    """The CF app's flags at ``scale`` (edge factor EF, seed 0, ITERS, -check)."""
    return ["--rmat-scale", str(scale), "--rmat-ef", str(EF), "--seed", "0",
            "-ni", str(ITERS), "-check", "--device", "cuda"]


def cf_oracle_f64(scale: int):
    """The float64 numpy oracle of CF (models/colfilter.colfilter_reference)
    at gamma = CF_GAMMA on the app's rating graph of ``scale``; returns
    (state (nv, K) float64, its RMSE, seconds).  Runs in a spawned process
    while the card works: at scale 20 it takes minutes on the host."""
    import numpy as np
    from lux_tpu_torch.apps import common
    from lux_tpu_torch.models import colfilter as cf
    from lux_tpu_torch.utils.config import parse_args

    g = common.load_graph(parse_args(cf_argv(scale)), weighted=True, bipartite=True)
    t0 = time.perf_counter()
    v = cf.colfilter_reference(g, ITERS, gamma=CF_GAMMA, dtype=np.float64)
    return v, cf.rmse(g, v), time.perf_counter() - t0


def tail_start(np, g) -> int:
    """repart_main's SSSP source: the lowest-numbered vertex of out-degree
    1, whose BFS starts with tiny frontiers (sparse windows whose work is
    uneven across parts, so the recut runs)."""
    return int(np.flatnonzero(g.out_degrees() == 1)[0])


def push_oracles(scale: int):
    """The push apps' host oracles on the main graph: (the vertex with the
    largest out-degree, its unweighted BFS distances from
    scipy.sparse.csgraph with INF == nv, the max-label fixpoint of
    models/components.fixpoint_labels, seconds, and the BFS distances from
    ``tail_start``).  Runs in a spawned process while the card works."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models.components import fixpoint_labels

    g = generate.rmat(scale, EF, seed=0)
    t0 = time.perf_counter()
    start = int(np.argmax(g.out_degrees()))
    adj = csr_matrix((np.ones(g.ne), (g.col_idx, g.dst_of_edges())), shape=(g.nv, g.nv))
    d = shortest_path(adj, directed=True, unweighted=True, indices=[start, tail_start(np, g)])
    dist = np.where(np.isinf(d), g.nv, d).astype(np.int32)
    return start, dist[0], fixpoint_labels(g), time.perf_counter() - t0, dist[1]


def push_runs(np, app, phase: str, g, extra_argv: list, plans: dict, kernels: dict,
              smi: str, device: str = "cuda"):
    """One push app through its CLI body under each of PUSH_RUNS on the
    main graph ``g``, with -check; every launch counter set to 0 just before
    each run and read just after.  Requires -check to pass, each run's
    kernels to launch at least once per dense round, and every run's
    state, iterations and traversed edges to equal the mxscan run's.
    Returns ({label: result}, {label: launch counts})."""
    results, launches = {}, {}
    for label, extra, mode in PUSH_RUNS:
        argv = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0", "-check",
                "--device", device] + extra_argv + extra
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = app.run(argv, route=plans.get(mode), graph=g)
        counts = {name: fn.launches for name, fn in kernels.items()}
        results[label], launches[label] = res, counts
        emit({"phase": phase, "run": label, "argv": extra_argv + extra, "rc": res.rc,
              "method": res.method, "route_gather": res.route_gather, "iters": res.iters,
              "dense_rounds": res.dense_rounds, "traversed_edges": res.traversed,
              "gteps": res.gteps, "ms": res.seconds * 1e3,
              "wall_seconds": time.perf_counter() - t0, "launches": counts,
              "nv": g.nv, "ne": g.ne, "device": smi})
        require(res.rc == 0, f"{phase} {label}: -check failed")
        for name in PUSH_RUN_KERNELS.get(label, ()):
            require(counts[name] >= max(res.dense_rounds, 1),
                    f"{phase} {label}: {name} launched {counts[name]} times in "
                    f"{res.dense_rounds} dense rounds")
        first = results["mxscan"]
        require(np.array_equal(res.state, first.state),
                f"{phase} {label}: state differs from the mxscan run")
        require((res.iters, res.traversed) == (first.iters, first.traversed),
                f"{phase} {label}: (iterations, traversed) {(res.iters, res.traversed)} "
                f"differ from the mxscan run's {(first.iters, first.traversed)}")
    return results, launches


def push_race(torch, push, sh, apps, dev, reps: int) -> dict:
    """Milliseconds of one dense round (engine/push.dense_part_step: the
    gather, relax, segmented min/max and apply of every edge) per RACE
    method, for each (name, program, converged global state) of ``apps``
    on the pull layout ``sh``; the methods' outputs must be bitwise
    equal.  Returns {name: {method: ms}}."""
    from lux_tpu_torch.graph.shards import to_device

    arr = to_device(sh.arrays, dev).part(0)
    out = {}
    for name, prog, state in apps:
        full = prog.init_state(arr.global_vid, arr.degree, arr.vtx_mask)
        full[: state.shape[0]] = torch.from_numpy(state).to(dev)
        rounds = {m: push.dense_part_step(prog, arr, full, full, m) for m in RACE}
        for m in RACE:
            require(torch.equal(rounds[m], rounds["scan"]),
                    f"race {name}: the {m} dense round differs from scan's")
        out[name] = {m: time_ms(torch, functools.partial(push.dense_part_step, prog, arr,
                                                         full, full, m), reps)
                     for m in RACE}
    return out


def bfs_sources(np, g) -> list:
    """bfs's sources: the SPEC_SOURCES largest out-degrees (bench.py:747's choice)."""
    deg = np.bincount(g.col_idx, minlength=g.nv)
    return [int(v) for v in np.argsort(deg)[::-1][:SPEC_SOURCES]]


def spec_oracles_bfs_labelprop(scale: int):
    """The bfs and labelprop host oracles on the main graph (scipy: the
    unweighted shortest paths from each source, minimum over them; the
    float64 labelprop recurrence as CSR products) and their seconds.
    Runs in a spawned process while the card works."""
    import numpy as np
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.program import workloads as wl

    g = generate.rmat(scale, EF, seed=0)
    t0 = time.perf_counter()
    dist = wl.bfs_reference_fast(g, bfs_sources(np, g))
    t1 = time.perf_counter()
    probs = wl.labelprop_reference_fast(g, LP_LABELS, LP_STRIDE, ITERS)
    return dist, probs, {"bfs": t1 - t0, "labelprop": time.perf_counter() - t1}


def spec_oracles_kcore_triangles(scale: int, tri_scale: int):
    """The k-core host oracle on the symmetrized main graph (the peel by
    removed vertices' out-edges) and the triangle oracle on the
    symmetrized weighted graph of ``tri_scale`` (bitsets, per-edge set
    bits of the intersection), with their seconds.  Runs in a spawned
    process while the card works."""
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.program import workloads as wl

    gs = wl.symmetrize(generate.rmat(scale, EF, seed=0))
    t0 = time.perf_counter()
    core = wl.kcore_reference_fast(gs)
    t1 = time.perf_counter()
    gt = wl.symmetrize(generate.rmat(tri_scale, EF, seed=0, weighted=True))
    t2 = time.perf_counter()
    inc = wl.triangles_reference_fast(gt)
    return core, inc, {"kcore": t1 - t0, "triangles": time.perf_counter() - t2}


def spec_run(torch, run_app, phase: str, label: str, argv: list, kernels: dict,
             smi: str, graph, route=None):
    """One program through apps/run.py with its launch counters set to 0
    just before and read just after, and the card's peak memory of the
    run; emits its line and requires -check to pass.  Returns (result,
    launch counts)."""
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_app.run(argv, route=route, graph=graph)
    counts = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": phase, "run": label, "argv": argv, "rc": res.rc, "method": res.method,
          "route_gather": res.route_gather, "iters": res.iters, "gteps": res.gteps,
          "ms": res.seconds * 1e3, "wall_seconds": time.perf_counter() - t0,
          "stats": res.stats, "launches": counts, "estimate_bytes": res.estimate_bytes,
          "max_memory_allocated": peak, "nv": res.graph.nv, "ne": res.graph.ne,
          "device": smi})
    require(res.rc == 0, f"{phase} {label}: -check failed")
    return res, counts


def spec_kernel_cases(torch, np, scan, shuffle, expand, pull, wl, library, bind,
                      kcore_res, g_tri, plan_mx, dev, reps: int) -> list:
    """The slice's new callers of the kernels, at its shapes, against their
    plain versions: the scan kernel's int32 sum over k-core's symmetrized
    layout (the alive flags of level 2, gathered per edge), its f32 sum
    over triangle phase 2's weighted, destination-dependent edge values,
    and the mx kernel's int32 sum on routed k-core's fused-mx plan (0/1
    values in its group space)."""
    from lux_tpu_torch.graph.shards import build_pull_shards, to_device

    rows = []
    gs = kcore_res.graph
    sh = build_pull_shards(gs, 1)
    a = to_device(sh.arrays, dev).part(0)
    core = torch.from_numpy(kcore_res.state).to(dev)
    alive = torch.cat([(core >= 2).to(torch.int32), torch.zeros(
        sh.spec.nv_pad - gs.nv, dtype=torch.int32, device=dev)])
    rows.append(scan_case(torch, scan, "kcore int32 sum", alive.index_select(0, a.src_pos),
                          a.head_flag, a.row_ptr[-1:], "sum", reps))
    del a, alive
    sht = wl.on_device(build_pull_shards(g_tri, 1), dev)
    at = sht.arrays
    words = (g_tri.nv + 31) // 32
    phase1 = wl.BitPatterns(bind(library.TRI_NEIGHBORS, w=words, width=words))
    bits = pull.run_pull_fixed(phase1, sht.spec, at, pull.init_state(phase1, at), 1, "scatter")
    phase2 = bind(library.TRI_COUNT)
    load, _, _ = pull.compile_pull_phases(phase2, sht.spec, "mxscan")
    src, dst = load(at, bits)[0]
    tvals = phase2.edge_value(src, at.weights[0], dst).contiguous()
    del src, dst, bits
    rows.append(scan_case(torch, scan, "triangles phase 2 f32 sum", tvals, at.head_flag[0],
                          at.row_ptr[0][-1:], "sum", reps))
    del tvals, sht, at
    torch.cuda.empty_cache()
    static, arrays = expand.plan_to_device(plan_mx, dev)
    *_, mxa = expand.split_fused_arrays(static, tuple(x[0] for x in arrays), static.weighted)
    g = dataclasses.replace(static.mx, op="sum")
    k = len(g.steps)
    idx, dst_rel, tile_block = mxa[:k], mxa[k], mxa[k + 1]
    x = torch.from_numpy(np.random.default_rng(23).integers(0, 2, static.n2)
                         .astype(np.int32)).to(dev)
    y = shuffle._relayout(x, g.view, g.perm_axes).reshape(g.kshape)
    kernel = functools.partial(shuffle.mxreduce_pass_gather, y, idx, dst_rel, tile_block, g)
    plain = functools.partial(shuffle.mxreduce_pass_gather_plain, y, idx, dst_rel, tile_block, g)
    total = sum(c for _, c, _ in static.groups)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = compare(torch, got[:total], want[:total], True, what="mx, kcore int32 sum")
    nbytes = (static.n2 * (4 + k * idx[0].element_size() + dst_rel.element_size())
              + g.num_blocks * g.v_blk * 4)
    rows.append({"kernel": "mxreduce_pass_gather", "case": "kcore int32 sum", "n2": static.n2,
                 "dtype": "int32", "exact": True, "max_abs_err": err,
                 "kernel_ms": time_ms(torch, kernel, reps),
                 "plain_ms": time_ms(torch, plain, max(2, reps // 4)), "library_ms": None,
                 "bound_ms": bound_ms(nbytes), "bytes": nbytes})
    return rows


def sum_race(torch, segment, layouts: dict, dev, reps: int) -> dict:
    """Milliseconds of one per-destination sum (ops/segment.segment_sum_csc,
    the reduce of one pull iteration) per SUM_RACE method on each layout
    of ``layouts``: {name: (values, row_ptr, head_flag, dst_local)}.  Integer
    sums must be bitwise equal across the methods (mxsum downgrades them
    to scan).  An f32 sum's largest error relative to the same sums in
    float64 is recorded: the prefix-difference method (mxsum) loses the
    global prefix's digits, so only methods within rtol 1e-5 may win.
    Returns {name: {"ms": {method: ms}, "max_rel_err": {method: err},
    "winner": method}}."""
    out = {}
    for name, (vals, row_ptr, head, dst) in layouts.items():
        fns = {m: functools.partial(segment.segment_sum_csc, vals, row_ptr, head, dst,
                                    method=m) for m in SUM_RACE}
        exact = vals.dtype != torch.float32
        if exact:
            want = fns["scan"]()
        else:
            want = torch.zeros(row_ptr.shape[0], dtype=torch.float64, device=dev)
            want.index_add_(0, dst.long(), vals.double())
            want = want[:-1]
        errs = {}
        for m, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if exact:
                compare(torch, got, want, True, what=f"race {name} {m}")
                errs[m] = 0.0
            else:
                rel = (got.double() - want).abs() / want.abs().clamp_min(1e-300)
                errs[m] = float(torch.where(want != 0, rel, (got != 0).double()).max())
        ms = {m: time_ms(torch, fn, reps) for m, fn in fns.items()}
        ok = [m for m in SUM_RACE if errs[m] <= SUM_RTOL]
        out[name] = {"ms": ms, "max_rel_err": errs, "winner": min(ok, key=ms.get)}
    return out


def spmv_2d_cases(torch, np, spmv, bc, dev, ks, reps: int, timed: bool):
    """spmv_blockcsr_2d against its plain version on one block-CSR layout,
    for each K in ``ks``, f32 and bf16 values (positive, so rtol holds);
    off the main shape also K = 20 values 4 bytes off a 16-byte boundary
    (the kernel's scalar path)."""
    gen = torch.Generator(device=dev).manual_seed(18)
    e_dst = torch.from_numpy(bc.e_dst_rel).to(dev)
    cb = torch.from_numpy(bc.chunk_block).to(dev)
    cf = torch.from_numpy(bc.chunk_first).to(dev)
    C, T = bc.e_dst_rel.shape
    n = bc.num_vblocks * bc.v_blk
    flat_dst = torch.from_numpy(np.where(
        bc.e_dst_rel < bc.v_blk,
        bc.chunk_block[:, None].astype(np.int64) * bc.v_blk + bc.e_dst_rel,
        n).reshape(-1)).to(dev)
    cases = [(k, dt, 0) for k in ks for dt in (torch.float32, torch.bfloat16)]
    if not timed:
        cases.append((20, torch.float32, 1))
    rows = []
    for k, dtype, offset in cases:
        flat = torch.rand(C * T * k + offset, device=dev, generator=gen) + 0.01
        vals = flat[offset:].view(C, T, k).to(dtype)
        del flat

        def kernel():
            return spmv.spmv_blockcsr_2d(vals, e_dst, cb, cf, v_blk=bc.v_blk,
                                         num_vblocks=bc.num_vblocks)

        def plain():
            return spmv.spmv_blockcsr_2d_plain(vals, e_dst, cb, cf, v_blk=bc.v_blk,
                                               num_vblocks=bc.num_vblocks)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        row = {"k": k, "dtype": str(dtype).replace("torch.", ""), "shape": [C, T, k],
               "offset_bytes": 4 * offset, "max_abs_err": compare(torch, got, want, False)}
        del got, want
        if timed:
            # inputs read once (values, e_dst_rel, chunk_block), output written once
            nbytes = C * T * (k * vals.element_size() + 4) + C * 4 + n * k * 4
            vflat = vals.reshape(-1, k).float()
            row.update(
                kernel_ms=time_ms(torch, kernel, reps),
                plain_ms=time_ms(torch, plain, max(2, reps // 4)),
                library_ms=time_ms(torch, lambda: torch.zeros(n + 1, k, device=dev)
                                   .index_add_(0, flat_dst, vflat), max(2, reps // 4)),
                bound_ms=bound_ms(nbytes), bytes=nbytes)
            del vflat
        rows.append(row)
        del vals
    return rows


def spec_phases(torch, np, g, sh, push_plans: dict, kernels: dict, smi: str, dev,
                spec_oracle_a, spec_oracle_b) -> dict:
    """Phases 11-12 on the main graph ``g`` (its pull layout ``sh`` and the
    phase-4 expand plans ``push_plans``): spec_main, spec_kernels and
    sum_race; the oracles are the pool's pending results.  Returns the
    launch counts of every spec run."""
    from lux_tpu_torch.apps import run as run_app
    from lux_tpu_torch.engine import methods, pull
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.shards import build_pull_shards, to_device
    from lux_tpu_torch.ops import expand, scan, segment, shuffle
    from lux_tpu_torch.program import library
    from lux_tpu_torch.program import workloads as wl
    from lux_tpu_torch.program.spec import bind

    # 11. the spec workloads through apps/run.py
    t0 = time.perf_counter()
    spec_launches = {}
    srcs = bfs_sources(np, g)
    main_argv = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0",
                 "--device", dev.type]
    bfs_argv = ["bfs"] + main_argv + ["-check", "--sources", ",".join(map(str, srcs))]
    bfs = {}
    for label, extra, replay in BFS_RUNS:
        res, spec_launches[f"bfs-{label}"] = spec_run(
            torch, run_app, "spec_main", f"bfs-{label}", bfs_argv + extra, kernels, smi, g,
            push_plans["expand-pf"] if replay else None)
        bfs[label] = res
        first = bfs["mxscan"]
        require(np.array_equal(res.state, first.state) and res.iters == first.iters
                and res.stats == first.stats,
                f"bfs {label}: (distances, iterations, traversed, dense rounds) differ "
                "from the mxscan run's")
        for name in PUSH_RUN_KERNELS.get(label, ()):
            require(spec_launches[f"bfs-{label}"][name] >= res.stats["dense_rounds"],
                    f"bfs {label}: {name} launched too few times")
    res, spec_launches["bfs-pull"] = spec_run(torch, run_app, "spec_main", "bfs-pull",
                                              bfs_argv + ["--engine", "pull"], kernels, smi, g)
    require(np.array_equal(res.state, bfs["mxscan"].state), "bfs pull: distances differ")
    require(spec_launches["bfs-pull"]["mxscan_segmented"] >= res.iters,
            "bfs pull: the scan kernel launched too few times")
    o_dist, o_probs, o_secs = spec_oracle_a.get(timeout=900)
    require(np.array_equal(bfs["mxscan"].state, o_dist), "bfs distances differ from scipy's")
    emit({"phase": "spec_main", "program": "bfs", "sources": srcs,
          "oracle": "scipy.sparse.csgraph shortest_path, min over the sources",
          "oracle_seconds": o_secs["bfs"], "reached": int((o_dist < g.nv).sum()),
          "oracle_equal": True})

    # k-core on the symmetrized main graph, its int32 sums through the scan kernel
    kc = {}
    for label in ("mxscan", "scatter"):
        res, spec_launches[f"kcore-{label}"] = spec_run(
            torch, run_app, "spec_main", f"kcore-{label}",
            ["kcore"] + main_argv + ["-check", "--method", label], kernels, smi, g)
        kc[label] = res
        require(np.array_equal(res.state, kc["mxscan"].state)
                and (res.iters, res.stats) == (kc["mxscan"].iters, kc["mxscan"].stats),
                f"kcore {label}: (coreness, rounds, k_max) differ from the mxscan run's")
    require(spec_launches["kcore-mxscan"]["mxscan_segmented"] >= kc["mxscan"].iters,
            "kcore mxscan: the scan kernel launched fewer times than the rounds")
    o_core, o_inc, o2_secs = spec_oracle_b.get(timeout=900)
    require(np.array_equal(kc["mxscan"].state, o_core), "coreness differs from the host peel")
    gs = kc["mxscan"].graph
    emit({"phase": "spec_main", "program": "kcore", "ne_symmetrized": gs.ne,
          "max_degree": int(gs.in_degrees().max()), "k_max": kc["mxscan"].stats["k_max"],
          "rounds": kc["mxscan"].iters, "oracle": "host peel by removed out-edges",
          "oracle_seconds": o2_secs["kcore"], "oracle_equal": True})

    # routed k-core at KCORE_ROUTED_SCALE: the plans built once, handed to the app
    g16 = generate.rmat(KCORE_ROUTED_SCALE, EF, seed=0)
    sh16 = build_pull_shards(wl.symmetrize(g16), 1)
    t1 = time.perf_counter()
    plans16 = {"fused-mx": expand.plan_fused_shards(sh16, "sum", pf=True, mx=True)}
    t2 = time.perf_counter()
    plans16["expand-pf"] = expand.plan_expand_shards(sh16, pf=True)
    emit({"phase": "spec_main", "program": "kcore", "plan_scale": KCORE_ROUTED_SCALE,
          "plan_seconds": {"fused-mx": t2 - t1, "expand-pf": time.perf_counter() - t2}})
    argv16 = ["kcore", "--rmat-scale", str(KCORE_ROUTED_SCALE), "--rmat-ef", str(EF),
              "--seed", "0", "--device", dev.type, "-check", "--method", "mxscan"]
    k16, spec_launches["kcore16-mxscan"] = spec_run(torch, run_app, "spec_main",
                                                    "kcore16-mxscan", argv16, kernels, smi, g16)
    for mode in KCORE_ROUTED:
        res, spec_launches[f"kcore16-{mode}"] = spec_run(
            torch, run_app, "spec_main", f"kcore16-{mode}", argv16 + ["--route-gather", mode],
            kernels, smi, g16, plans16[mode])
        require(np.array_equal(res.state, k16.state)
                and (res.iters, res.stats) == (k16.iters, k16.stats),
                f"kcore {mode}: (coreness, rounds, k_max) differ from the direct run's")
        name = RUN_KERNEL[mode]
        require(spec_launches[f"kcore16-{mode}"][name] >= res.iters,
                f"kcore {mode}: {name} launched fewer times than the rounds")

    # label propagation: wide (V, 8) state
    lp = {}
    for label, extra in (("auto", []), ("scatter", ["--method", "scatter"])):
        res, spec_launches[f"labelprop-{label}"] = spec_run(
            torch, run_app, "spec_main", f"labelprop-{label}",
            ["labelprop"] + main_argv + ["-check", "-ni", str(ITERS), "--labels",
                                         str(LP_LABELS), "--seed-stride", str(LP_STRIDE)]
            + extra, kernels, smi, g)
        lp[label] = res
        err = float(np.max(np.abs(res.state - o_probs)))
        require(res.state.shape == (g.nv, LP_LABELS) and bool(np.isfinite(res.state).all()),
                f"labelprop {label}: probabilities not finite or misshaped")
        require(np.allclose(res.state, o_probs, rtol=LP_RTOL, atol=LP_ATOL),
                f"labelprop {label}: off the float64 oracle by {err}")
        emit({"phase": "spec_main", "program": "labelprop", "run": label,
              "max_abs_err_vs_f64": err, "rtol": LP_RTOL, "atol": LP_ATOL,
              "oracle": "float64 recurrence as scipy CSR products",
              "oracle_seconds": o_secs["labelprop"]})

    # triangles on the symmetrized weighted TRI_SCALE graph
    g15 = generate.rmat(TRI_SCALE, EF, seed=0, weighted=True)
    tri = {}
    for label, extra in (("mxscan", ["--method", "mxscan", "-check"]),
                         ("scatter", ["--method", "scatter"])):
        res, spec_launches[f"triangles-{label}"] = spec_run(
            torch, run_app, "spec_main", f"triangles-{label}",
            ["triangles", "--rmat-scale", str(TRI_SCALE), "--rmat-ef", str(EF), "--seed", "0",
             "--device", dev.type] + extra, kernels, smi, g15)
        tri[label] = res
        ref = o_inc.astype(np.float64)
        bad = int(np.sum(~np.isfinite(res.state)
                         | (np.abs(res.state - ref) > 1e-5 * np.maximum(np.abs(ref), 1.0))))
        require(res.state.shape == (g15.nv,) and bad == 0,
                f"triangles {label}: {bad} vertices off the bitset oracle")
        emit({"phase": "spec_main", "program": "triangles", "run": label, "bad_vertices": bad,
              "total_weighted_incidence": res.stats["total_weighted_incidence"],
              "bitset_words": res.stats["bitset_words"], "ne_symmetrized": res.graph.ne,
              "oracle": "numpy bitsets, per-edge set bits of the intersection",
              "oracle_seconds": o2_secs["triangles"]})
    require(spec_launches["triangles-mxscan"]["mxscan_segmented"] >= 1,
            "triangles mxscan: phase 2 launched no scan kernel")
    emit({"phase": "spec_main", "seconds": time.perf_counter() - t0, "device": smi})

    # the slice's new kernel callers against their plain versions
    t0 = time.perf_counter()
    spec_rows = spec_kernel_cases(torch, np, scan, shuffle, expand, pull, wl, library, bind,
                                  kc["mxscan"], tri["mxscan"].graph, plans16["fused-mx"],
                                  dev, REPS)
    emit({"phase": "spec_kernels", "cases": spec_rows, "seconds": time.perf_counter() - t0,
          "device": smi})
    del plans16, sh16, g16, g15, bfs, lp, tri
    torch.cuda.empty_cache()

    # 12. the sum race: one reduce of one iteration, per method
    t0 = time.perf_counter()
    shk = build_pull_shards(gs, 1)
    core = torch.from_numpy(kc["mxscan"].state).to(dev)
    layouts = {}
    for name, shx, full in (
            ("pagerank_f32", sh, torch.from_numpy(
                np.random.default_rng(21).random(sh.spec.gathered_size, dtype=np.float32)
                + 0.01).to(dev)),
            ("kcore_int32", shk, torch.cat([(core >= 2).to(torch.int32), torch.zeros(
                shk.spec.gathered_size - gs.nv, dtype=torch.int32, device=dev)]))):
        a = to_device(shx.arrays, dev).part(0)
        layouts[name] = (full.index_select(0, a.src_pos), a.row_ptr, a.head_flag, a.dst_local)
    race_sum = sum_race(torch, segment, layouts, dev, REPS)
    emit({"phase": "sum_race", "race": race_sum,
          "winners_row": methods.WINNERS.get(("cuda", "sum")),
          "graph": {"pagerank_f32": [g.nv, g.ne], "kcore_int32": [gs.nv, gs.ne]},
          "seconds": time.perf_counter() - t0, "device": smi})
    return spec_launches


def save_graph(np, tmp: str, name: str, g) -> None:
    """A HostGraph's arrays as .npy files under ``tmp`` (the pool's
    hand-off of a generated graph to the card's process)."""
    for f in ("row_ptr", "col_idx", "weights"):
        if getattr(g, f) is not None:
            np.save(os.path.join(tmp, f"{name}_{f}.npy"), getattr(g, f))


def load_saved_graph(np, csc, tmp: str, name: str):
    arrs = {f: np.load(os.path.join(tmp, f"{name}_{f}.npy"))
            for f in ("row_ptr", "col_idx", "weights")
            if os.path.exists(os.path.join(tmp, f"{name}_{f}.npy"))}
    return csc.HostGraph(nv=arrs["row_ptr"].shape[0] - 1, ne=arrs["col_idx"].shape[0],
                         row_ptr=arrs["row_ptr"], col_idx=arrs["col_idx"],
                         weights=arrs.get("weights"))


def long_weighted_graph(tmp: str, scale: int):
    """The weighted main graph (RMAT ``scale`` / EF / seed 0, integer
    weights 1..100: the unweighted graph's edges, so its hub is the same
    vertex), saved under ``tmp``, and scipy's Dijkstra distances from that
    hub (the lightest of parallel edges; INF == 1 << 30).  Returns (hub,
    distances, seconds).  Runs in a spawned process while the card works."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    from lux_tpu_torch.graph import generate

    t0 = time.perf_counter()
    g = generate.rmat(scale, EF, seed=0, weighted=True)
    save_graph(np, tmp, "weighted", g)
    hub = int(np.argmax(g.out_degrees()))
    dst = g.dst_of_edges()
    order = np.lexsort((g.weights, g.col_idx, dst))
    s, d, w = g.col_idx[order], dst[order], g.weights[order]
    first = np.ones(g.ne, bool)
    first[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
    adj = csr_matrix((w[first].astype(np.float64), (s[first], d[first])), shape=(g.nv, g.nv))
    dist = dijkstra(adj, directed=True, indices=hub)
    return hub, np.where(np.isfinite(dist), dist, 1 << 30).astype(np.int32), \
        time.perf_counter() - t0


def long_stream_graph(tmp: str, scale: int):
    """The streamed runs' graph (RMAT ``scale`` / EF / seed 0) saved under
    ``tmp``, and its float64 PageRank oracle of ITERS iterations.
    Returns (oracle, seconds).  Runs in a spawned process."""
    import numpy as np

    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models.pagerank import pagerank_reference

    t0 = time.perf_counter()
    g = generate.rmat(scale, EF, seed=0)
    save_graph(np, tmp, "stream", g)
    return pagerank_reference(g, ITERS), time.perf_counter() - t0


def scan_case(torch, scan, case: str, vals, head, valid_end, op: str, reps: int):
    """The scan kernel's segmented ``op`` of ``vals`` on one caller's
    shape against its plain version on the valid slots: int32 and min/max
    bitwise, an f32 sum within rtol 1e-5 of the same sum in float64; two
    calls bitwise; timed beside its bound."""
    n = vals.shape[0]
    kernel = functools.partial(scan.mxscan_segmented, vals, head, op=op, valid_end=valid_end)
    plain = functools.partial(scan.mxscan_segmented_plain, vals, head, op=op,
                              valid_end=valid_end)
    exact = not (op == "sum" and vals.dtype == torch.float32)
    got = kernel()
    want = plain() if exact else scan.segmented_scan(vals.double(), head, torch.add)
    torch.cuda.synchronize()
    mask = torch.arange(n, device=vals.device) < valid_end
    what = f"scan, {case}"
    err = compare(torch, got, want, exact, mask, what=what)
    require(torch.equal(got, kernel()), f"{what}: two calls differ")
    nbytes = n * (2 * vals.element_size() + 1)
    return {"kernel": "mxscan_segmented", "case": case, "op": op, "n": n,
            "dtype": str(vals.dtype).replace("torch.", ""), "exact": exact,
            "valid": int(valid_end.item()), "max_abs_err": err,
            "kernel_ms": time_ms(torch, kernel, reps),
            "plain_ms": time_ms(torch, plain, max(2, reps // 4)), "library_ms": None,
            "bound_ms": bound_ms(nbytes), "bytes": nbytes}


def counted(kernels: dict, fn, *args, **kw):
    """``fn(*args, **kw)`` with every launch counter set to 0 just before
    and read just after: (result, {kernel: launches}, wall seconds)."""
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    res = fn(*args, **kw)
    return res, {name: k.launches for name, k in kernels.items()}, time.perf_counter() - t0


def delta_main(torch, np, kernels, smi, dev, tmp, long_w, plan_pf, hub, reps):
    """Phase 13: weighted SSSP from the hub through apps.sssp: chaotic,
    --delta at DELTA_WIDTHS, and --delta DELTA_ROUTED with --route-gather
    expand-pf (phase 4's plan: the weighted graph has the main graph's
    edges); all equal to each other and to scipy's Dijkstra.  Then the
    scan kernel's int32 min at one dense round of the weighted layout.
    Returns (the weighted graph, {run: result}, {run: launches}, the
    kernel row)."""
    from lux_tpu_torch.apps import sssp as sssp_app
    from lux_tpu_torch.graph import csc
    from lux_tpu_torch.graph.shards import build_pull_shards, to_device
    from lux_tpu_torch.models import sssp as sssp_model
    from lux_tpu_torch.ops import scan

    t0 = time.perf_counter()
    w_hub, w_dist, w_secs = long_w.get(timeout=900)
    require(w_hub == hub, f"the weighted graph's hub {w_hub} is not the main graph's {hub}")
    gw = load_saved_graph(np, csc, tmp, "weighted")
    base = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0", "--weighted",
            "-start", str(hub), "-check", "--device", "cuda", "--method", "mxscan"]
    routed = f"delta-{DELTA_ROUTED}-expand-pf"
    cases = ([("chaotic", [], None)]
             + [(f"delta-{d}", ["--delta", str(d)], None) for d in DELTA_WIDTHS]
             + [(routed, ["--delta", str(DELTA_ROUTED), "--route-gather", "expand-pf"],
                 plan_pf)])
    runs, launches = {}, {}
    for label, extra, plan in cases:
        res, counts, wall = counted(kernels, sssp_app.run, base + extra, route=plan, graph=gw)
        runs[label], launches[label] = res, counts
        emit({"phase": "delta_main", "run": label, "argv": extra, "rc": res.rc,
              "rounds": res.iters, "dense_rounds": res.dense_rounds,
              "traversed_edges": res.traversed, "ms": res.seconds * 1e3, "gteps": res.gteps,
              "launches": counts, "wall_seconds": wall, "device": smi})
        require(res.rc == 0, f"delta_main {label}: -check failed")
        require(np.array_equal(res.state, w_dist),
                f"delta_main {label}: distances differ from scipy's Dijkstra")
        require(counts["mxscan_segmented"] >= res.dense_rounds,
                f"delta_main {label}: mxscan launched {counts['mxscan_segmented']} times in "
                f"{res.dense_rounds} dense rounds")
    plain = runs[f"delta-{DELTA_ROUTED}"]
    require((runs[routed].iters, runs[routed].traversed) == (plain.iters, plain.traversed),
            "delta_main: the routed run's rounds or edges differ from the direct one's")
    require(runs[routed].dense_rounds > 0, "delta_main: the routed run had no dense round")
    for name in ("fused_pass_gather", "lane_gather"):
        require(launches[routed][name] > 0, f"delta_main: the routed run launched no {name}")
    sh = build_pull_shards(gw, 1)
    a = to_device(sh.arrays, dev).part(0)
    prog = sssp_model.WeightedSSSPProgram(nv=gw.nv, start=hub)
    full = prog.init_state(a.global_vid, a.degree, a.vtx_mask)
    full[: gw.nv] = torch.from_numpy(runs["delta-%d" % DELTA_WIDTHS[0]].state).to(dev)
    vals = prog.relax(full.index_select(0, a.src_pos), a.weights).contiguous()
    row = scan_case(torch, scan, "delta dense round int32 min", vals, a.head_flag,
                         a.row_ptr[-1:], "min", reps)
    emit({"phase": "delta_main", "oracle": "scipy.sparse.csgraph.dijkstra",
          "oracle_seconds": w_secs, "hub": hub, "reached": int((w_dist < (1 << 30)).sum()),
          "kernel": row, "seconds": time.perf_counter() - t0, "device": smi})
    del a, full, vals, sh
    return gw, runs, launches, row


def repart_main(np, kernels, smi, g, o_tail, o_labels):
    """Phase 14: -ng REPART_PARTS on the card through apps.sssp (from
    ``tail_start``, whose BFS distances ``o_tail`` the pool computed) and
    apps.components, static and with --repartition-every REPART_EVERY
    (threshold REPART_THRESHOLD), and SSSP again with windows of one
    iteration, whose first window (one vertex's out-edges) must recut;
    equal to each other and to the oracles.  Each recut's window
    imbalance, and the same window's work under the new cuts.  Returns
    {app: launches of the REPART_EVERY run}."""
    from lux_tpu_torch.apps import components as cc_app
    from lux_tpu_torch.apps import sssp as sssp_app
    from lux_tpu_torch.engine import repartition

    t0 = time.perf_counter()
    launches = {}
    for name, mod, extra, oracle, every in (
            ("sssp", sssp_app, ["-start", str(tail_start(np, g))], o_tail, REPART_EVERY),
            ("sssp", sssp_app, ["-start", str(tail_start(np, g))], o_tail, 1),
            ("components", cc_app, [], o_labels, REPART_EVERY)):
        base = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0",
                "-ng", str(REPART_PARTS), "--method", "mxscan", "-check",
                "--device", "cuda"] + extra
        if every == REPART_EVERY:
            static, _, _ = counted(kernels, mod.run, base, graph=g)
        res, counts, wall = counted(kernels, mod.run,
                                    base + ["--repartition-every", str(every),
                                            "--repartition-threshold", str(REPART_THRESHOLD)],
                                    graph=g)
        launches.setdefault(name, counts)
        recuts = []
        for it, old, new, work in res.recuts:
            old, new, work = np.asarray(old), np.asarray(new), np.asarray(work)
            cum = np.concatenate([[0.0], np.cumsum(
                repartition.vertex_weights(work, old, g.row_ptr))])
            recuts.append({"it": it, "old_cuts": old.tolist(), "new_cuts": new.tolist(),
                           "imbalance_before": repartition.imbalance(work),
                           "imbalance_after_estimate": repartition.imbalance(
                               cum[new[1:]] - cum[new[:-1]]),
                           "max_boundary_move": int(np.abs(new - old).max())})
        emit({"phase": "repart_main", "app": name, "argv": extra, "parts": REPART_PARTS,
              "every": every, "threshold": REPART_THRESHOLD, "rc": res.rc, "recuts": recuts,
              "iters": res.iters, "dense_rounds": res.dense_rounds,
              "traversed_edges": res.traversed, "ms": res.seconds * 1e3, "gteps": res.gteps,
              "static_ms": static.seconds * 1e3, "static_gteps": static.gteps,
              "launches": counts, "wall_seconds": wall, "device": smi})
        require(res.rc == 0 and static.rc == 0, f"repart_main {name}: -check failed")
        require(np.array_equal(res.state, static.state),
                f"repart_main {name}: the adaptive state differs from the static one")
        require(np.array_equal(res.state, oracle), f"repart_main {name}: state off the oracle")
        require((res.iters, res.traversed) == (static.iters, static.traversed),
                f"repart_main {name}: iterations or edges differ from the static run")
        require(counts["mxscan_segmented"] >= res.dense_rounds,
                f"repart_main {name}: mxscan launched {counts['mxscan_segmented']} times")
        if every == 1:  # a one-vertex first window: its uneven work must recut
            require(recuts, "repart_main sssp: --repartition-every 1 made no recut")
    emit({"phase": "repart_main", "seconds": time.perf_counter() - t0})
    return launches


def stream_main(torch, np, kernels, smi, dev, tmp, long_s, reps):
    """Phase 15: PageRank (ITERS iterations) and components on RMAT
    STREAM_SCALE through the apps with --stream-hbm-gib STREAM_GIB:
    PageRank within rtol 1e-4 of its float64 oracle, components bitwise
    the resident pull run, prefetch on and off bitwise; the geometry, the
    bytes an iteration moves, ms an iteration with prefetch on and off,
    the rate of a plain pinned copy of the same bytes, the link bound,
    and the peak memory beside the budget and the estimate.  Then the
    scan kernel on one chunk whose first segment began in an earlier
    chunk.  Returns (launches {app: counts}, kernel rows)."""
    from lux_tpu_torch.apps import components as cc_app
    from lux_tpu_torch.apps import pagerank as pr_app
    from lux_tpu_torch.engine import pull, stream
    from lux_tpu_torch.graph import csc
    from lux_tpu_torch.graph.shards import to_device
    from lux_tpu_torch.models import components as cc_model
    from lux_tpu_torch.models.pagerank import PageRankProgram
    from lux_tpu_torch.ops import scan
    from lux_tpu_torch.utils.timing import Timer

    t0 = time.perf_counter()
    pr64, oracle_s = long_s.get(timeout=1100)
    gs = load_saved_graph(np, csc, tmp, "stream")
    argv = ["--rmat-scale", str(STREAM_SCALE), "--rmat-ef", str(EF), "--seed", "0",
            "--device", "cuda", "--method", "mxscan", "--stream-hbm-gib", str(STREAM_GIB)]
    launches, rows = {}, []
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = counted(kernels, pr_app.run, argv + ["-ni", str(ITERS)], graph=gs)
    peak = torch.cuda.max_memory_allocated() - base_mem
    launches["pagerank"] = counts
    st = res.streamed
    ssh = st.layout
    rel = float(np.max(np.abs(res.ranks.astype(np.float64) - pr64)
                       / np.abs(pr64.astype(np.float64))))
    moved = ssh.packed.numel()  # every chunk row crosses the link once an iteration
    prog = PageRankProgram(nv=gs.nv)
    s0 = pull.init_state(prog, to_device(ssh.varrays, dev))
    on_off = {}
    for prefetch in (True, False):
        timer = Timer(dev)
        out = stream.run_pull_fixed_streamed(prog, ssh, s0, ITERS, "mxscan", prefetch)
        on_off[prefetch] = (timer.stop() * 1e3 / ITERS, out)
    require(torch.equal(on_off[True][1], on_off[False][1]),
            "stream_main: prefetch on and off differ")
    # the plain pinned copy of the same bytes, chunk by chunk into one buffer
    buf = torch.empty(ssh.packed.shape[2], dtype=torch.uint8, device=dev)
    rows_host = ssh.packed.reshape(-1, ssh.packed.shape[2])

    def copy_all():
        for r in range(rows_host.shape[0]):
            buf.copy_(rows_host[r], non_blocking=True)

    copy_ms = time_ms(torch, copy_all, 3, warmup=1)
    rate = moved / (copy_ms * 1e-3)
    # the scan kernel on one chunk whose first segment began in an earlier chunk
    rp = ssh.row_ptrs[0]
    c = next(c for c, ch in enumerate(ssh.chunks[0])
             if c and int(ch.dst_local[0]) < ssh.spec.nv_pad
             and rp[int(ch.dst_local[0])] < ch.lo)
    ch = ssh.chunks[0][c]
    xfer = stream._Transfer(ssh, dev)
    xfer.put(0, 0, c, after=0)
    chunk = xfer.take(0, 0, c)
    full = on_off[True][1].reshape(-1)
    vals = full.index_select(0, chunk.src_pos).contiguous()
    rows.append(scan_case(torch, scan, "streamed chunk f32 sum", vals, chunk.head_flag,
                               chunk.row_ptr[-1:], "sum", reps))
    labels = chunk.src_pos.clone()  # max-label values: the sources' positions
    rows.append(scan_case(torch, scan, "streamed chunk int32 max", labels,
                               chunk.head_flag, chunk.row_ptr[-1:], "max", reps))
    emit({"phase": "stream_main", "app": "pagerank", "scale": STREAM_SCALE,
          "nv": gs.nv, "ne": gs.ne, "rc": res.rc, "max_rel_err_vs_f64": rel,
          "chunks_per_part": st.n_chunks, "chunk_edges": st.chunk_e, "parts": 1,
          "bytes_per_iter": moved, "ms_per_iter": res.seconds * 1e3 / ITERS,
          "gteps": res.gteps, "ms_per_iter_prefetch_on": on_off[True][0],
          "ms_per_iter_prefetch_off": on_off[False][0],
          "pinned_copy_gb_per_s": rate / 1e9, "link_bound_ms_per_iter": copy_ms,
          "peak_bytes": peak, "budget_bytes": st.budget_bytes,
          "estimate_bytes": st.resident_bytes, "edge_bytes_resident_engine": st.edge_bytes,
          "kernel_chunk": c, "kernel": rows, "launches": counts, "wall_seconds": wall,
          "oracle_seconds": oracle_s, "device": smi})
    require(res.rc == 0, "stream_main pagerank: failed")
    require(bool(np.isfinite(res.ranks).all()) and res.ranks.shape == (gs.nv,),
            "stream_main pagerank: ranks not finite or misshaped")
    require(rel <= RANK_RTOL, f"stream_main pagerank: ranks off the f64 oracle by {rel}")
    require(st.n_chunks >= STREAM_MIN_CHUNKS,
            f"stream_main: {st.n_chunks} chunks a part, fewer than {STREAM_MIN_CHUNKS}")
    require(peak <= st.budget_bytes,
            f"stream_main pagerank: peak {peak} bytes over the budget {st.budget_bytes}")
    require(counts["mxscan_segmented"] >= ITERS * st.n_chunks,
            f"stream_main: mxscan launched {counts['mxscan_segmented']} times")
    del res, st, ssh, s0, on_off, buf, rows_host, xfer, chunk, full, vals, labels
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, counts, wall = counted(kernels, cc_app.run, argv + ["-check"], graph=gs)
    peak = torch.cuda.max_memory_allocated() - base_mem
    launches["components"] = counts
    st = res.streamed
    off, _ = stream.run_pull_until_streamed(
        cc_model.MaxLabelProgram(), st.layout,
        pull.init_state(cc_model.MaxLabelProgram(), to_device(st.layout.varrays, dev)),
        10_000, cc_model.active_count, "mxscan", prefetch=False)
    off = st.layout.scatter_to_global(off.cpu().numpy())
    st.layout = None
    torch.cuda.empty_cache()
    resident = cc_model.connected_components(gs, method="mxscan", device=dev)
    emit({"phase": "stream_main", "app": "components", "rc": res.rc, "iters": res.iters,
          "chunks_per_part": st.n_chunks, "chunk_edges": st.chunk_e,
          "ms_per_iter": res.seconds * 1e3 / res.iters, "peak_bytes": peak,
          "budget_bytes": st.budget_bytes, "estimate_bytes": st.resident_bytes,
          "launches": counts, "wall_seconds": wall,
          "seconds": time.perf_counter() - t0, "device": smi})
    require(res.rc == 0, "stream_main components: -check failed")
    require(peak <= st.budget_bytes,
            f"stream_main components: peak {peak} bytes over the budget {st.budget_bytes}")
    require(np.array_equal(res.state, resident),
            "stream_main components: labels differ from the resident run")
    require(np.array_equal(off, res.state), "stream_main components: prefetch off differs")
    return launches, rows


def ckpt_main(np, kernels, smi, tmp, g, gw, hub, pr_ranks, delta_whole, cc_whole):
    """Phase 16: runs cut and resumed from their checkpoints, bitwise the
    uninterrupted runs: PageRank --ckpt-every CKPT_PR_EVERY, run to
    ITERS/2 then resumed to ITERS (against phase 6's mxscan run); SSSP
    --delta DELTA_WIDTHS[0] --ckpt-every CKPT_DELTA_EVERY, cut at half its
    rounds (against phase 13's run); components --ckpt-every
    CKPT_CC_EVERY, cut at half its iterations (against phase 10's mxscan
    run).  The seconds a save takes and its bytes on disk.  Returns
    {app: launches of the resumed run}."""
    from lux_tpu_torch.apps import components as cc_app
    from lux_tpu_torch.apps import pagerank as pr_app
    from lux_tpu_torch.apps import sssp as sssp_app
    from lux_tpu_torch.utils import checkpoint

    t0 = time.perf_counter()
    launches = {}
    common = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0",
              "--method", "mxscan", "--device", "cuda"]
    d_pr, d_d, d_cc, d_t = (os.path.join(tmp, n) for n in ("ck_pr", "ck_delta", "ck_cc", "ck_t"))
    half = ITERS // 2
    ck = ["--ckpt-dir", d_pr, "--ckpt-every", str(CKPT_PR_EVERY)]
    cut, _, _ = counted(kernels, pr_app.run, common + ["-ni", str(half)] + ck, graph=g)
    res, counts, wall = counted(kernels, pr_app.run, common + ["-ni", str(ITERS)] + ck, graph=g)
    launches["pagerank"] = counts
    require(cut.iters == half and res.iters == ITERS - half,
            f"ckpt_main pagerank: ran {cut.iters} + {res.iters} iterations")
    require(np.array_equal(res.ranks, pr_ranks),
            "ckpt_main pagerank: the resumed ranks differ from the uninterrupted run's")
    t1 = time.perf_counter()
    path = checkpoint.save_iteration(d_t, ITERS, res.ranks, "pagerank")
    saves = {"pagerank": {"seconds": time.perf_counter() - t1,
                          "bytes": os.path.getsize(path)}}
    emit({"phase": "ckpt_main", "app": "pagerank", "every": CKPT_PR_EVERY,
          "cut_at": half, "resumed_iters": res.iters, "ms": res.seconds * 1e3,
          "files": sorted(os.listdir(d_pr)), "launches": counts, "wall_seconds": wall,
          "save": saves["pagerank"], "device": smi})
    wbase = ["--weighted", "-start", str(hub), "--delta", str(DELTA_WIDTHS[0]),
             "--ckpt-dir", d_d, "--ckpt-every", str(CKPT_DELTA_EVERY)]
    for name, mod, graph, extra, whole, d in (
            ("sssp-delta", sssp_app, gw, wbase, delta_whole, d_d),
            ("components", cc_app, g,
             ["--ckpt-dir", d_cc, "--ckpt-every", str(CKPT_CC_EVERY)], cc_whole, d_cc)):
        stop = max(whole.iters // 2, 1)
        cut, _, _ = counted(kernels, mod.run, common + extra + ["--max-iters", str(stop)],
                            graph=graph)
        res, counts, wall = counted(kernels, mod.run, common + extra + ["-check"],
                                    graph=graph)
        launches[name] = counts
        files = sorted(os.listdir(d), key=lambda f: int(f[5:-4]))
        t1 = time.perf_counter()
        if name == "sssp-delta":
            path = checkpoint.save_delta(d_t, 1, res.state, res.state < (1 << 30),
                                         res.traversed, 0, "sssp")
        else:
            path = checkpoint.save_frontier(d_t, 1, res.state, np.ones(g.nv, bool),
                                            res.traversed, name)
        saves[name] = {"seconds": time.perf_counter() - t1, "bytes": os.path.getsize(path)}
        emit({"phase": "ckpt_main", "app": name, "cut_at": cut.iters,
              "iters": res.iters, "traversed_edges": res.traversed,
              "ms": res.seconds * 1e3, "checkpoints": len(files), "last": files[-1],
              "launches": counts, "wall_seconds": wall, "save": saves[name], "device": smi})
        require(cut.iters == stop, f"ckpt_main {name}: the cut run stopped at {cut.iters}")
        require(res.rc == 0, f"ckpt_main {name}: -check failed")
        require(np.array_equal(res.state, whole.state),
                f"ckpt_main {name}: the resumed state differs from the uninterrupted run's")
        require((res.iters, res.traversed) == (whole.iters, whole.traversed),
                f"ckpt_main {name}: iterations or edges differ from the uninterrupted run")
    emit({"phase": "ckpt_main", "seconds": time.perf_counter() - t0})
    return launches


def serve_oracles(scale: int):
    """The serving phase's host oracles on the main graph: the query
    vertices the --serve driver draws (serve/benchmarks.pick_sources,
    seed 0), scipy's BFS distances (INF == nv) from the first SERVE_BFS
    and the float64 personalized PageRank (models/pagerank.ppr_reference,
    ITERS iterations) of the first SERVE_PPR, and seconds.  Runs in a
    spawned process while the card works."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.models.pagerank import ppr_reference
    from lux_tpu_torch.serve.benchmarks import pick_sources

    g = generate.rmat(scale, EF, seed=0)
    t0 = time.perf_counter()
    src = pick_sources(g, SERVE_Q, seed=0)
    adj = csr_matrix((np.ones(g.ne), (g.col_idx, g.dst_of_edges())), shape=(g.nv, g.nv))
    d = shortest_path(adj, directed=True, unweighted=True, indices=src[:SERVE_BFS])
    dist = np.where(np.isinf(d), g.nv, d).astype(np.int32)
    ppr = [ppr_reference(g, int(v), ITERS) for v in src[:SERVE_PPR]]
    return src, dist, ppr, time.perf_counter() - t0


def serve_split(torch, np, g, sh, dev, sources, reps: int = 3) -> dict:
    """Milliseconds of one batched SSSP iteration's steps at Q = SERVE_Q
    on the main layout (serve/batched._batched_part: the (E, Q) gather,
    the edge function, the segmented min of every lane, the apply), per
    reduce method of SERVE_METHODS' resolution (the plain scan that
    mxscan falls back to on (E, Q) values, and scatter), from the
    initial state of ``sources``; CUDA events, ``reps`` launches each
    after warm-up.  The methods' minima must be bitwise equal."""
    from lux_tpu_torch.graph.shards import to_device
    from lux_tpu_torch.ops import segment
    from lux_tpu_torch.serve import batched

    prog = batched.make_program("sssp", g.nv)
    arr = to_device(sh.arrays, dev).part(0)
    q = torch.from_numpy(np.asarray(sources, np.int32)).to(dev)
    loc = prog.init_part(arr.global_vid, arr.degree, arr.vtx_mask, q)
    src = loc.index_select(0, arr.src_pos)
    vals = prog.edge_value(src, arr.weights)
    out, accs = {}, {}
    for method in ("scan", "scatter"):
        def reduce(m=method):
            return segment.segment_min_csc(vals, arr.row_ptr, arr.head_flag, arr.dst_local,
                                           method=m)
        accs[method] = reduce()
        out[method] = {
            "gather": time_ms(torch, lambda: loc.index_select(0, arr.src_pos), reps, 1),
            "edge": time_ms(torch, lambda: prog.edge_value(src, arr.weights), reps, 1),
            "reduce": time_ms(torch, reduce, reps, 1),
            "apply": time_ms(torch, lambda: prog.apply(loc, accs["scan"], arr, q), reps, 1)}
    require(torch.equal(accs["scan"], accs["scatter"]),
            "serve_split: the scan's and scatter's lane minima differ")
    return out


def serve_main(torch, np, kernels, smi, dev, g, sh, serve_oracle):
    """Phase 17: the batched query service on the main graph, through the
    apps' library entry with the graph built above: `apps.sssp --serve
    --serve-queries SERVE_Q --serve-buckets SERVE_BUCKETS -check` and
    `apps.pagerank --serve -ni ITERS --serve-queries SERVE_Q -check`, each
    summary (QPS, latency percentiles, batch occupancy, warm hit ratio)
    with the estimate and the peak memory; every SSSP answer 0 at its
    source with no triangle-inequality violation (the driver's -check),
    the first SERVE_BFS bitwise scipy's BFS and the first SERVE_PPR within
    rtol 1e-4 of the float64 oracle (the pool).  Then
    serve/benchmarks.measure_serving with bench.py's serving-row
    arguments under each of SERVE_METHODS, and one batched iteration's
    steps timed (serve_split).  Every launch counter is set to 0 at the
    phase's start and read at its end: returns them."""
    from lux_tpu_torch.apps import pagerank as pr_app
    from lux_tpu_torch.apps import sssp as sssp_app
    from lux_tpu_torch.serve.benchmarks import measure_serving

    t0 = time.perf_counter()
    for k in kernels.values():
        k.launches = 0
    base = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0",
            "--device", "cuda", "--serve", "--serve-queries", str(SERVE_Q), "-check"]
    runs = {}
    for app, mod, extra in (("sssp", sssp_app, ["--serve-buckets", SERVE_BUCKETS]),
                            ("ppr", pr_app, ["-ni", str(ITERS)])):
        t1 = time.perf_counter()
        res = mod.run(base + extra, graph=g)
        runs[app] = res
        s = res.summary
        emit({"phase": "serve_main", "app": app, "argv": extra, "rc": res.rc,
              "method": res.method, "qps": s["qps"], "latency_ms": s["latency_ms"],
              "queue_wait_ms": s["queue_wait_ms"], "batches": s["batches"],
              "batch_occupancy": s["batch_occupancy"],
              "warm_hit_ratio": s["engine_cache"]["warm_hit_ratio"],
              "warm_seconds": s["engine_cache"]["warm_seconds"],
              "completed": s["completed"], "traversed_edges": s["traversed_edges"],
              "gteps_aggregate": s["gteps_aggregate"], "estimate_bytes": res.estimate_bytes,
              "peak_bytes": res.peak_bytes, "wall_seconds": time.perf_counter() - t1,
              "device": smi})
        require(res.rc == 0, f"serve_main {app}: -check failed")
        require(s["completed"] == SERVE_Q and s["timeouts"] == 0,
                f"serve_main {app}: {s['completed']} of {SERVE_Q} answered")
        require(all(a is not None and a.shape == (g.nv,) for a in res.answers),
                f"serve_main {app}: an answer is missing or misshaped")
    ss, pp = runs["sssp"], runs["ppr"]
    for i, (v, a) in enumerate(zip(ss.sources, ss.answers)):
        require(a[int(v)] == 0, f"serve_main sssp: answer {i} is not 0 at its source {v}")
    require(all(np.isfinite(a).all() for a in pp.answers), "serve_main ppr: ranks not finite")
    o_src, o_dist, o_ppr, oracle_s = serve_oracle.get(timeout=900)
    require(np.array_equal(o_src, ss.sources) and np.array_equal(o_src, pp.sources),
            "serve_main: the oracle's query vertices differ from the driver's")
    for i in range(SERVE_BFS):
        require(np.array_equal(ss.answers[i], o_dist[i]),
                f"serve_main sssp: answer {i} (source {o_src[i]}) differs from scipy's BFS")
    ppr_err = []
    for i in range(SERVE_PPR):
        got, want = pp.answers[i].astype(np.float64), o_ppr[i].astype(np.float64)
        diff = np.abs(got - want)
        bad = int((diff > RANK_RTOL * np.abs(want) + F32_TINY).sum())
        ppr_err.append(float((diff / np.maximum(np.abs(want), F32_TINY)).max()))
        require(bad == 0, f"serve_main ppr: answer {i} (seed {o_src[i]}) off the float64 "
                          f"oracle at {bad} vertices (rtol {RANK_RTOL})")
    emit({"phase": "serve_main", "oracle": "scipy.sparse.csgraph BFS, float64 PPR",
          "bfs_checked": SERVE_BFS, "ppr_checked": SERVE_PPR, "ppr_max_rel_err": ppr_err,
          "sssp_max_dist": int(max(int(a[a < g.nv].max()) for a in ss.answers)),
          "oracle_seconds": oracle_s})
    del runs, ss, pp
    torch.cuda.empty_cache()
    for method in SERVE_METHODS:
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        res = measure_serving(g, sh, app="sssp", q=SERVE_Q, num_seq=4, batched_reps=1,
                              method=method, device=dev)
        emit({"phase": "serve_main", "measure_serving": method,
              "peak_bytes": int(torch.cuda.max_memory_allocated(dev)),
              "wall_seconds": time.perf_counter() - t1, "device": smi, **res})
        require(res["scheduler"]["completed"] == SERVE_Q and res["scheduler"]["timeouts"] == 0,
                f"serve_main measure_serving {method}: the burst was not fully answered")
        require(res["qps_batched"] > 0 and res["qps_q1_sequential"] > 0,
                f"serve_main measure_serving {method}: no throughput")
        torch.cuda.empty_cache()
    emit({"phase": "serve_main", "q": SERVE_Q, "split_ms": serve_split(
        torch, np, g, sh, dev, o_src), "device": smi})
    torch.cuda.empty_cache()
    counts = {name: k.launches for name, k in kernels.items()}
    emit({"phase": "serve_main", "launches": counts, "seconds": time.perf_counter() - t0})
    return counts


MUTATE_PARTS = 8  # the reference's refresh row runs 8 parts (bench.py:1155)
MUTATE_CONFINED = 256  # the confined churn: deletes (and as many inserts) in one part
MUTATE_PART = 3  # ... that part's destination range
MUTATE_ATOL = 1e-6  # fused-pf / fused-mx refresh against the direct one (test_mutate.py)


def edge_sha(np, g) -> str:
    """A fingerprint of a graph's edge multiset, whatever the order of
    equal edges within a destination."""
    import hashlib

    key = g.dst_of_edges().astype(np.int64) * g.nv + np.asarray(g.col_idx, np.int64)
    return hashlib.sha1(np.sort(key).tobytes()).hexdigest()


def mutate_churn(np, g, cur):
    """The 1 % churn of the reference's refresh row (bench.py:1162,
    1180-1190) against ``cur``, the graph after its one-edge warm-up
    batch: k = ne // 200 distinct edges of ``cur`` deleted, then k inserts
    with uniform endpoints, drawn with default_rng(0).  Returns the two
    deleted positions in ``cur``, the two batches' (src, dst) and k."""
    k = g.ne // 200
    rng = np.random.default_rng(0)
    dele = rng.choice(cur.ne, size=k, replace=False)
    deletes = (np.asarray(cur.col_idx)[dele], cur.dst_of_edges()[dele])
    inserts = (rng.integers(0, g.nv, k), rng.integers(0, g.nv, k))
    return dele, deletes, inserts, k


def mutate_oracles(scale: int):
    """The dynamic-graph phase's host oracles, built independently of the
    delta-log: the main graph plus the warm-up edge (0, 1), the churn's
    deletes removed BY POSITION and its inserts appended, through
    from_edge_list.  Returns the merged graph's edge fingerprint, scipy's
    BFS distances (INF == nv) from the largest out-degree and from the
    first SERVE_BFS serving sources, the max-label fixpoint, the float64
    PageRank fixpoint (60 iterations of an alpha = 0.15 contraction) and
    seconds.  Runs in a spawned process while the card works."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.csc import from_edge_list
    from lux_tpu_torch.models.components import fixpoint_labels
    from lux_tpu_torch.models.pagerank import _host_iteration
    from lux_tpu_torch.serve.benchmarks import pick_sources

    g = generate.rmat(scale, EF, seed=0)
    t0 = time.perf_counter()
    cur = from_edge_list(np.append(np.asarray(g.col_idx, np.int64), 0),
                         np.append(g.dst_of_edges().astype(np.int64), 1), g.nv)
    dele, _, inserts, _ = mutate_churn(np, g, cur)
    keep = np.ones(cur.ne, bool)
    keep[dele] = False
    merged = from_edge_list(
        np.concatenate([np.asarray(cur.col_idx, np.int64)[keep], inserts[0]]),
        np.concatenate([cur.dst_of_edges().astype(np.int64)[keep], inserts[1]]), g.nv)
    start = int(np.argmax(np.bincount(g.col_idx, minlength=g.nv)))
    sources = pick_sources(g, SERVE_Q, seed=0)[:SERVE_BFS]
    adj = csr_matrix((np.ones(merged.ne), (merged.col_idx, merged.dst_of_edges())),
                     shape=(g.nv, g.nv))
    d = shortest_path(adj, directed=True, unweighted=True,
                      indices=[start] + [int(v) for v in sources])
    dist = np.where(np.isinf(d), g.nv, d).astype(np.int32)
    labels = fixpoint_labels(merged)
    deg = merged.out_degrees().astype(np.float64)
    pr = np.where(deg > 0, (1.0 / g.nv) / np.maximum(deg, 1.0), 1.0 / g.nv)
    for _ in range(60):
        pr = _host_iteration(merged, pr, deg)
    return {"sha": edge_sha(np, merged), "start": start, "sources": sources,
            "dist": dist, "labels": labels, "pr": pr, "ne": merged.ne,
            "seconds": time.perf_counter() - t0}


def ulp_diff(np, a, b) -> int:
    """The largest distance in units in the last place between two f32
    arrays of non-negative values."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ai - bi).max()) if ai.size else 0


def rel_err(np, got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), F32_TINY)))


def best_of2(torch, fn):
    """(best wall seconds of two calls, both results): each call ends
    with a synchronize."""
    best, outs = float("inf"), []
    for _ in range(2):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        outs.append(out)
    return best, outs


def max_plan(plan):
    """A sum plan of a fused family relabelled for the max reduce: the
    routes, group layout and rank tiles do not depend on the reduce (the
    planner reads it into the static only), so the max-label checks reuse
    phase 4's plans instead of planning twice more."""
    static, arrays = plan
    if not hasattr(static, "reduce"):  # an expand plan reads no reduce
        return plan
    mx = static.mx if static.mx is None else dataclasses.replace(static.mx, op="max")
    return dataclasses.replace(static, reduce="max", mx=mx), arrays


def mutate_routed(torch, np, kernels, dev, g, sh, plans, batches):
    """The routed refresh on the main one-part layout with phase 4's BASE
    plans (expand-pf, fused-pf, fused-mx): the same churn in a one-part
    MutableGraph; PageRank refreshed direct and under each plan (expand-pf
    bitwise the direct one, the fused families within MUTATE_ATOL); three
    overlay iterations of the max-label step under each plan bitwise equal
    to each other and to the cold merged-graph step; and each kernel's
    launches in one PageRank iteration with the overlay and without,
    which must be equal.  Returns (record, the MutableGraph, its overlay)."""
    from lux_tpu_torch.engine import pull
    from lux_tpu_torch.graph.shards import build_pull_shards, to_device
    from lux_tpu_torch.models.components import MaxLabelProgram
    from lux_tpu_torch.models.pagerank import PageRankProgram
    from lux_tpu_torch.mutate import MutableGraph, refresh

    t0 = time.perf_counter()
    mg = MutableGraph(g, num_parts=1, cap=max(1024, g.ne // 200 + 128))
    require(np.array_equal(mg.pull_shards.arrays.src_pos, sh.arrays.src_pos),
            "mutate: the one-part layout is not the one phase 4 planned")
    _, arr = mg.device_pull(dev)
    pr0, _ = refresh.converge_pagerank(mg.pull_shards, device=dev, arrays=arr)
    for b in batches:
        mg.apply(*b)
    ov = mg.pull_overlay()
    rec = {"scale": SCALE, "parts": 1, "prior_seconds": time.perf_counter() - t0}
    direct, it = refresh.refresh_pagerank(mg, pr0, device=dev)
    rec["iters"] = {"direct": it}
    for fam in ("expand-pf", "fused-pf", "fused-mx"):
        got, it = refresh.refresh_pagerank(mg, pr0, route=plans[fam], device=dev)
        rec["iters"][fam] = it
        diff = float((got - direct).abs().max())
        rec[f"{fam}_max_abs_diff"] = diff
        if fam == "expand-pf":
            require(torch.equal(got, direct),
                    "mutate: PageRank refresh under expand-pf differs from the direct one")
        else:
            require(diff <= MUTATE_ATOL, f"mutate: PageRank refresh under {fam} off the "
                                         f"direct one by {diff} (atol {MUTATE_ATOL})")
    merged = mg.log.merged_graph()
    sh_m = build_pull_shards(merged, 1, cuts=np.asarray(mg.pull_shards.cuts))
    arr_m = to_device(sh_m.arrays, dev)
    lab = MaxLabelProgram()
    cold = pull.run_pull_fixed(lab, sh_m.spec, arr_m, pull.init_state(lab, arr_m), 3)
    cold = sh_m.scatter_to_global(cold.cpu().numpy())
    del arr_m, sh_m, merged
    for fam in ("expand-pf", "fused-pf", "fused-mx"):
        got = pull.run_pull_fixed(lab, mg.pull_shards.spec, arr, pull.init_state(lab, arr), 3,
                                  route=max_plan(plans[fam]), overlay=ov)
        require(np.array_equal(mg.pull_shards.scatter_to_global(got.cpu().numpy()), cold),
                f"mutate: three max-label overlay iterations under {fam} differ from the "
                "cold merged-graph step")
    # the overlay launches no kernel of its own (the reference's LUX-J503)
    prog = PageRankProgram(nv=g.nv)
    s0 = pull.init_state(prog, arr)
    launches = {}
    for fam in ("direct", "expand-pf", "fused-pf", "fused-mx"):
        route = None if fam == "direct" else plans[fam]
        pair = []
        for overlay in (None, ov):
            before = {n: kn.launches for n, kn in kernels.items()}
            pull.run_pull_fixed(prog, mg.pull_shards.spec, arr, s0, 1, route=route,
                                overlay=overlay)
            pair.append({n: kn.launches - before[n] for n, kn in kernels.items()})
        require(pair[0] == pair[1], f"mutate: one {fam} iteration launches {pair[1]} with the "
                                    f"overlay, {pair[0]} without")
        launches[fam] = pair[1]
    rec["launches_per_iteration"] = launches
    rec["seconds"] = time.perf_counter() - t0
    return rec, mg, ov


def mutate_kernel_cases(torch, np, scan, shuffle, expand, dev, mg, ov, plans, reps):
    """The four kernels of the refresh path on the overlay's inputs, at the
    main one-part layout: mxscan_segmented on tombstone-masked values
    (f32 sum against float64 segment sums, int32 max bitwise the plain
    version); mxreduce_pass_gather with tombstoned ranks sent to v_blk in
    the middle of tiles (f32 sum against float64, int32 max bitwise) and
    timed; and every expand-pf, fused-pf and fused-mx replay with the
    tombstones (fused_pass_gather, lane_gather, mxreduce) bitwise its run
    with the kernels swapped for their plain versions on the same card
    (int32 max-label values).  Returns {kernel: max_abs_err} and the mx
    timing row."""
    from lux_tpu_torch.mutate import overlay as ovl

    sh = mg.pull_shards
    rng = np.random.default_rng(18)
    del_val = torch.from_numpy(ov[1].del_val[0]).to(dev)
    full = torch.from_numpy(rng.random(sh.spec.gathered_size, dtype=np.float32) + 0.01).to(dev)
    ifull = torch.from_numpy(rng.integers(0, 1 << 30, sh.spec.gathered_size)
                             .astype(np.int32)).to(dev)
    src_pos = torch.from_numpy(sh.arrays.src_pos[0]).to(dev)
    row_ptr = torch.from_numpy(sh.arrays.row_ptr[0]).to(dev)
    head = torch.from_numpy(sh.arrays.head_flag[0]).to(dev)
    err = {}
    # mxscan on masked values
    vals = ovl.mask_deleted(full.index_select(0, src_pos), del_val, "sum")
    got = scan.mxscan_segmented(vals, head, op="sum", valid_end=row_ptr[-1:])
    nz = row_ptr[1:] > row_ptr[:-1]
    ends = (row_ptr[1:].long() - 1).clamp(min=0)
    cs = torch.zeros(vals.numel() + 1, dtype=torch.float64, device=dev)
    torch.cumsum(vals.double(), 0, out=cs[1:])
    want = cs[row_ptr[1:].long()] - cs[row_ptr[:-1].long()]
    err["mxscan_segmented"] = compare(torch, got[ends][nz], want[nz], exact=False,
                                      what="mutate: mxscan on tombstone-masked f32 values")
    ivals = ovl.mask_deleted(ifull.index_select(0, src_pos), del_val, "max")
    got = scan.mxscan_segmented(ivals, head, op="max", valid_end=row_ptr[-1:])
    want = scan.mxscan_segmented_plain(ivals, head, op="max", valid_end=row_ptr[-1:])
    m = int(row_ptr[-1])
    compare(torch, got[:m], want[:m], exact=True, what="mutate: mxscan on masked int32 max")
    # mxreduce with tombstoned ranks
    static, arrays = expand.plan_to_device(plans["fused-mx"], dev)
    part = tuple(a[0] for a in arrays)
    *_, gslot, _, mxa = expand.split_fused_arrays(static, part, static.weighted)
    mxg = static.mx
    k = len(mxg.steps)
    idx, dst_rel, tile_block = mxa[:k], mxa[k], mxa[k + 1]
    g_del = torch.zeros(static.n2 + 1, dtype=torch.bool, device=dev)
    g_del[gslot.long()] = del_val
    rel = dst_rel.masked_fill(g_del[: static.n2].view(dst_rel.shape), mxg.v_blk)
    total = sum(c for _, c, _ in static.groups)
    xf = torch.from_numpy(rng.random(static.n2, dtype=np.float32) + 0.01).to(dev)
    xi = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, static.n2, dtype=np.int64)
                          .astype(np.int32)).to(dev)
    mx_err = 0.0
    for op, x in (("sum", xf), ("max", xi)):
        g = dataclasses.replace(mxg, op=op)
        y = shuffle._relayout(x, g.view, g.perm_axes).reshape(g.kshape)
        got = shuffle.mxreduce_pass_gather(y, idx, rel, tile_block, g)
        exact = op == "max"
        want = (shuffle.mxreduce_pass_gather_plain(y, idx, rel, tile_block, g) if exact
                else mx_sum_f64(torch, shuffle, y, idx, rel, tile_block, g))
        torch.cuda.synchronize()
        mx_err = max(mx_err, compare(torch, got[:total], want[:total], exact,
                                     what=f"mutate: mx {op} with tombstoned ranks"))
        if not exact:
            mx_row = {"tombstoned_slots": int(g_del[: static.n2].sum()),
                      "kernel_ms": time_ms(torch, lambda: shuffle.mxreduce_pass_gather(
                          y, idx, rel, tile_block, g), reps),
                      "plain_ms": time_ms(torch, lambda: shuffle.mxreduce_pass_gather_plain(
                          y, idx, rel, tile_block, g), max(2, reps // 4))}
    err["mxreduce_pass_gather"] = mx_err
    # the whole tombstoned replays, kernels against their plain versions
    names = ("lane_gather", "fused_pass_gather", "mxreduce_pass_gather")
    real = {n: getattr(shuffle, n) for n in names}

    def replays():
        out = {}
        for fam in ("expand-pf", "fused-pf", "fused-mx"):
            st, arrs = expand.plan_to_device(max_plan(plans[fam]), dev)
            p0 = tuple(a[0] for a in arrs)
            if fam == "expand-pf":
                out[fam] = expand.apply_expand(ifull, st, p0)
            else:
                out[fam] = expand.apply_fused(ifull, st, p0, del_val=del_val)
        torch.cuda.synchronize()
        return out

    with_kernels = replays()
    try:
        for n in names:
            setattr(shuffle, n, getattr(shuffle, f"{n}_plain"))
        plain = replays()
    finally:
        for n, fn in real.items():
            setattr(shuffle, n, fn)
    for fam, got in with_kernels.items():
        require(torch.equal(got, plain[fam]),
                f"mutate: the tombstoned {fam} replay differs with the plain kernels")
    for n in ("lane_gather", "fused_pass_gather"):
        err[n] = 0.0
    return err, mx_row


def mutate_main(torch, np, kernels, smi, dev, g, tmp, mutate_oracle, routed, reps):
    """Phase 18: dynamic graphs on the main graph (the reference's
    ``*_refresh_churn1pct_*`` row, bench.py:1130-1330), at MUTATE_PARTS
    parts stacked on the card.  Priors (PageRank by converge_pagerank,
    SSSP from the largest out-degree, components), a one-edge warm-up
    batch refreshed, then the 1 % churn (mutate_churn) applied as two
    batches; the three refreshes timed best of two, the two runs bitwise
    equal; batched SSSP serving (Q = SERVE_Q, scatter) through a
    WarmEngineCache holding the overlay, with the scheduler; compaction
    (snapshot + invalidation report); the cold legs: read_lux of the
    snapshot, the shard builds with the same cuts, the expand-pf plan
    through the cached planner on an empty cache (built) and again
    (loaded), the cold runs; the gates against the oracles of the pool
    (mutate_oracles); the churn confined to one part (invalidated
    fraction 1 / MUTATE_PARTS, its plan rebuild from the warm cache); the
    routed refresh on the one-part layout with phase 4's plans
    (mutate_routed).  Every launch counter is set to 0 at the start and
    read after mutate_routed; then mutate_kernel_cases holds the four
    kernels against their plain versions on the overlay's inputs.
    ``routed`` = (graph, one-part shards, plans).  Returns (launches,
    {kernel: max_abs_err}, record)."""
    from lux_tpu_torch.engine import push
    from lux_tpu_torch.graph.format import read_lux
    from lux_tpu_torch.graph.push_shards import build_push_shards
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.models.components import MaxLabelProgram
    from lux_tpu_torch.models.sssp import SSSPProgram
    from lux_tpu_torch.mutate import OP_DELETE, OP_INSERT, MutableGraph, refresh
    from lux_tpu_torch.ops import expand, scan, shuffle
    from lux_tpu_torch.serve import batched
    from lux_tpu_torch.serve.benchmarks import pick_sources
    from lux_tpu_torch.serve.scheduler import MicroBatchScheduler
    from lux_tpu_torch.serve.warm import WarmEngineCache

    t_phase = time.perf_counter()
    for kn in kernels.values():
        kn.launches = 0
    P = MUTATE_PARTS
    snap = os.path.join(tmp, "mutate.lux")
    cache_dir = os.path.join(tmp, "plans")
    # the plan cache's default directory too (the compaction's
    # invalidation report derives its entry paths there)
    os.environ["LUX_TORCH_PLAN_CACHE"] = cache_dir
    mg = MutableGraph(g, num_parts=P, snapshot=snap, cap=max(1024, g.ne // 200 + 128))
    t0 = time.perf_counter()
    pshards = mg.push_shards
    mg.device_push(dev)
    layout_s = time.perf_counter() - t0
    start = int(np.argmax(np.bincount(g.col_idx, minlength=g.nv)))
    t0 = time.perf_counter()
    st, _, _ = push.run_push(SSSPProgram(nv=g.nv, start=start), pshards, device=dev)
    dist = pshards.scatter_to_global(st.cpu().numpy())
    st, _, _ = push.run_push(MaxLabelProgram(), pshards, device=dev)
    labels = pshards.scatter_to_global(st.cpu().numpy())
    pr, pr_it = refresh.converge_pagerank(mg.pull_shards, device=dev,
                                          arrays=mg.device_pull(dev)[1])
    priors_s = time.perf_counter() - t0
    mg.apply([0], [1], [OP_INSERT])  # the warm-up batch (bench.py:1174)
    t0 = time.perf_counter()
    pr, _ = refresh.refresh_pagerank(mg, pr, device=dev)
    dist, _ = refresh.refresh_sssp(mg, dist, start, device=dev)
    labels, _ = refresh.refresh_components(mg, labels, device=dev)
    warmup_s = time.perf_counter() - t0
    _, deletes, inserts, k = mutate_churn(np, g, mg.log.merged_graph())
    t0 = time.perf_counter()
    mg.apply(*deletes, np.full(k, OP_DELETE, np.int8))
    mg.apply(*inserts, np.full(k, OP_INSERT, np.int8))
    apply_s = time.perf_counter() - t0
    occ = mg.occupancy()
    emit({"phase": "mutate_main", "scale": SCALE, "parts": P, "churn_edges": 2 * k,
          "cap": mg.cap, "layout_seconds": layout_s, "priors_seconds": priors_s,
          "prior_pagerank_iters": pr_it, "warmup_refresh_seconds": warmup_s,
          "apply_s": apply_s, "delta_occupancy": occ})
    # the warm refreshes, best of two; two runs from one prior bitwise equal
    refresh_s, iters = {}, {}
    refresh_s["pagerank"], (a, b) = best_of2(
        torch, lambda: refresh.refresh_pagerank(mg, pr, device=dev))
    require(torch.equal(a[0], b[0]) and a[1] == b[1],
            "mutate: two PageRank refreshes from one prior differ")
    pr_warm, iters["pagerank"] = mg.pull_shards.scatter_to_global(a[0].cpu().numpy()), a[1]
    refresh_s["sssp"], (a, b) = best_of2(
        torch, lambda: refresh.refresh_sssp(mg, dist, start, device=dev))
    require(np.array_equal(a[0], b[0]), "mutate: two SSSP refreshes from one prior differ")
    dist_warm, iters["sssp"] = a
    refresh_s["components"], (a, b) = best_of2(
        torch, lambda: refresh.refresh_components(mg, labels, device=dev))
    require(np.array_equal(a[0], b[0]), "mutate: two CC refreshes from one prior differ")
    labels_warm, iters["components"] = a
    # the host's share: each refresh's analysis and overlay build alone
    host_s = {}
    for name, fn in (("sssp_dirty", lambda: refresh.sssp_dirty(mg, dist, start)),
                     ("cc_dirty", lambda: refresh.cc_dirty(mg, labels)),
                     ("pull_overlay", mg.pull_overlay),
                     ("push_overlay", mg.push_overlay_parts)):
        t0 = time.perf_counter()
        fn()
        host_s[name] = time.perf_counter() - t0
    # one PageRank iteration at 8 parts, with the overlay (already on the
    # card) and without: CUDA events over REPS iterations each
    from lux_tpu_torch.engine import pull
    from lux_tpu_torch.models.pagerank import PageRankProgram

    prog = PageRankProgram(nv=g.nv)
    _, arr = mg.device_pull(dev)
    spec = mg.pull_shards.spec
    ov_dev = pull.overlay_parts(mg.pull_overlay(), dev, spec)
    s0 = pull.init_state(prog, arr)
    iter_ms = {"overlay": time_ms(torch, lambda: pull.run_pull_fixed(
                   prog, spec, arr, s0, 1, overlay=ov_dev), reps),
               "base": time_ms(torch, lambda: pull.run_pull_fixed(prog, spec, arr, s0, 1), reps),
               "fold_rounds": int(ov_dev[0].rounds.shape[0])}
    del ov_dev, s0
    # serving: the overlay installed in a warm cache, through the scheduler
    t0 = time.perf_counter()
    sources = pick_sources(g, SERVE_Q, seed=0)
    ostatic, oarr = mg.pull_overlay()
    cache = WarmEngineCache(mg.pull_shards, apps=("sssp",), q_buckets=(SERVE_Q,),
                            method="scatter", overlay_static=ostatic, device=dev)
    cache.prewarm()
    cache.set_overlay(1, oarr)
    sched = MicroBatchScheduler(cache, app="sssp", max_wait_ms=0.0).start()
    try:
        futs = [sched.submit(int(v)) for v in sources]
        live = np.stack([f.result(timeout=600) for f in futs])
        gens = {f.generation for f in futs}
    finally:
        sched.stop()
    require(gens == {1}, f"mutate: served generations {gens}, not the installed 1")
    serve_s = time.perf_counter() - t0
    del cache, sched, futs
    torch.cuda.empty_cache()
    # compaction: the snapshot and the plan-cache invalidation
    t0 = time.perf_counter()
    rep = mg.compact(path=snap)
    compact_s = time.perf_counter() - t0
    inval = rep["invalidation"]
    merged_sha = edge_sha(np, mg.base)
    cold_eng = batched.BatchedEngine(mg.pull_shards, "sssp", SERVE_Q, method="scatter",
                                     device=dev)
    cold_serve = cold_eng.run(sources).state
    require(np.array_equal(live, cold_serve),
            "mutate: serving with the overlay differs from an engine on the compacted graph")
    del cold_eng
    torch.cuda.empty_cache()
    # the cold legs
    cuts = np.asarray(mg.pull_shards.cuts)
    brk = {}
    t0 = time.perf_counter()
    gc = read_lux(snap)
    brk["load"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shc = build_pull_shards(gc, P, cuts=cuts)
    brk["build_pull"] = time.perf_counter() - t0
    expand.reset_plan_stats()
    t0 = time.perf_counter()
    expand.plan_expand_shards_cached(shc, cache_dir, pf=True)
    brk["plan_build"] = time.perf_counter() - t0
    built = expand.plan_stats_snapshot()
    t0 = time.perf_counter()
    expand.plan_expand_shards_cached(shc, cache_dir, pf=True)
    brk["plan_load"] = time.perf_counter() - t0
    loaded = expand.plan_stats_snapshot()
    require(built["built"] == 2 * P and loaded["built"] == built["built"]
            and loaded["loaded"] == P,
            f"mutate: the plan cache built {built} then {loaded}")
    t0 = time.perf_counter()
    out, _ = refresh.converge_pagerank(shc, device=dev)
    pr_cold = shc.scatter_to_global(out.cpu().numpy())
    brk["compute_pagerank"] = time.perf_counter() - t0
    del shc, out
    t0 = time.perf_counter()
    shp = build_push_shards(gc, P, cuts=cuts)
    brk["build_push"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st, _, _ = push.run_push(SSSPProgram(nv=g.nv, start=start), shp, device=dev)
    dist_cold = shp.scatter_to_global(st.cpu().numpy())
    brk["compute_sssp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    st, _, _ = push.run_push(MaxLabelProgram(), shp, device=dev)
    labels_cold = shp.scatter_to_global(st.cpu().numpy())
    brk["compute_components"] = time.perf_counter() - t0
    del shp, gc, st
    torch.cuda.empty_cache()
    cold = {}
    for app, build, comp in (("pagerank", "build_pull", "compute_pagerank"),
                             ("sssp", "build_push", "compute_sssp"),
                             ("components", "build_push", "compute_components")):
        base = brk["load"] + brk[build] + brk[comp]
        cold[app] = {"plan_built": base + brk["plan_build"], "plan_loaded": base + brk["plan_load"]}
    # the gates
    o = mutate_oracle.get(timeout=900)
    require(o["sha"] == merged_sha and o["start"] == start,
            "mutate: the compacted graph is not the oracle's merged graph")
    require(np.array_equal(o["sources"], sources[:SERVE_BFS]), "mutate: oracle sources differ")
    require(np.array_equal(dist_warm, dist_cold) and np.array_equal(dist_warm, o["dist"][0]),
            "mutate: warm SSSP differs from the cold rebuild or scipy's BFS")
    require(np.array_equal(labels_warm, labels_cold) and np.array_equal(labels_warm, o["labels"]),
            "mutate: warm components differ from the cold rebuild or the fixpoint")
    for i in range(SERVE_BFS):
        require(np.array_equal(live[i], o["dist"][1 + i]),
                f"mutate: served answer {i} differs from scipy's BFS on the merged graph")
    pr_err = {"warm": rel_err(np, pr_warm, o["pr"]), "cold": rel_err(np, pr_cold, o["pr"])}
    require(max(pr_err.values()) <= RANK_RTOL,
            f"mutate: PageRank off the float64 fixpoint by {pr_err} (rtol {RANK_RTOL})")
    rows = {}
    for app, warm_v, cold_v in (("pagerank", pr_warm, pr_cold), ("sssp", dist_warm, dist_cold),
                                ("components", labels_warm, labels_cold)):
        rows[app] = {"value": cold[app]["plan_built"] / refresh_s[app],
                     "value_plan_loaded": cold[app]["plan_loaded"] / refresh_s[app],
                     "refresh_s": refresh_s[app], "cold_s": cold[app]["plan_built"],
                     "cold_s_plan_loaded": cold[app]["plan_loaded"],
                     "warm_over_cold": refresh_s[app] / cold[app]["plan_built"],
                     "warm_over_cold_plan_loaded": refresh_s[app] / cold[app]["plan_loaded"],
                     "refresh_iters": int(iters[app]),
                     "bitwise_equal": bool(np.array_equal(warm_v, cold_v))}
    rows["pagerank"]["max_ulp_diff"] = ulp_diff(np, pr_warm, pr_cold)
    rows["pagerank"]["max_rel_err_vs_f64"] = pr_err
    emit({"phase": "mutate_main", "rows": rows, "cold_breakdown": brk,
          "pagerank_iteration_ms": iter_ms, "host_seconds": host_s,
          "invalidated_bucket_fraction": inval["fraction"], "invalidation": inval,
          "apply_s": apply_s, "compact_s": compact_s, "delta_occupancy": occ, "parts": P,
          "serve": {"q": SERVE_Q, "method": "scatter", "seconds": serve_s,
                    "bfs_checked": SERVE_BFS},
          "plan_cache": {"build": built, "load": loaded}, "oracle_seconds": o["seconds"],
          "device": smi})
    del o, dist, labels, pr, live, cold_serve
    # a churn confined to one part's destination range
    t0 = time.perf_counter()
    lo, hi = int(cuts[MUTATE_PART]), int(cuts[MUTATE_PART + 1])
    dsts = mg.base.dst_of_edges()
    rng = np.random.default_rng(1)
    dele = rng.choice(np.flatnonzero((dsts >= lo) & (dsts < hi)), MUTATE_CONFINED,
                      replace=False)
    mg.apply(np.asarray(mg.base.col_idx)[dele], dsts[dele],
             np.full(MUTATE_CONFINED, OP_DELETE, np.int8))
    mg.apply(rng.integers(0, g.nv, MUTATE_CONFINED), rng.integers(lo, hi, MUTATE_CONFINED),
             np.full(MUTATE_CONFINED, OP_INSERT, np.int8))
    del dsts
    rep2 = mg.compact(path=snap)
    expand.reset_plan_stats()
    t1 = time.perf_counter()
    expand.plan_expand_shards_cached(mg.pull_shards, cache_dir, pf=True)
    rebuild_s = time.perf_counter() - t1
    stats = expand.plan_stats_snapshot()
    frac = rep2["invalidation"]["fraction"]
    emit({"phase": "mutate_main", "confined_part": MUTATE_PART, "churn_edges": 2 * MUTATE_CONFINED,
          "invalidation": rep2["invalidation"], "plan_rebuild_s": rebuild_s,
          "plan_stats": stats, "seconds": time.perf_counter() - t0})
    require(frac == 1.0 / P and rep2["invalidation"]["changed_parts"] == [MUTATE_PART],
            f"mutate: a churn confined to part {MUTATE_PART} invalidated {rep2['invalidation']}")
    require(stats["loaded"] == P - 1 and stats["built"] == 2,
            f"mutate: the warm cache rebuilt {stats} after the confined churn")
    del mg
    torch.cuda.empty_cache()
    # the routed refresh on the one-part layout, phase 4's plans: the same
    # batches (a rehearsal on a smaller graph draws its own churn)
    g_r, sh_r, plans = routed
    if g_r is g:
        batches = [([0], [1], [OP_INSERT]), (*deletes, np.full(k, OP_DELETE, np.int8)),
                   (*inserts, np.full(k, OP_INSERT, np.int8))]
    else:
        _, d2, i2, k2 = mutate_churn(np, g_r, g_r)
        batches = [(*d2, np.full(k2, OP_DELETE, np.int8)), (*i2, np.full(k2, OP_INSERT, np.int8))]
    rec, mg1, ov1 = mutate_routed(torch, np, kernels, dev, g_r, sh_r, plans, batches)
    counts = {name: kn.launches for name, kn in kernels.items()}
    emit({"phase": "mutate_main", "routed": rec, "device": smi})
    for name in ("mxscan_segmented", "lane_gather", "fused_pass_gather", "mxreduce_pass_gather"):
        require(counts[name] > 0, f"mutate: {name} was never launched on the refresh path")
    err, mx_row = mutate_kernel_cases(torch, np, scan, shuffle, expand, dev, mg1, ov1, plans,
                                      reps)
    emit({"phase": "mutate_main", "kernels_vs_plain": err, "mx_tombstoned": mx_row,
          "launches": counts, "seconds": time.perf_counter() - t_phase})
    return counts, err, {"rows": rows, "cold_breakdown": brk}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on the card",
              file=sys.stderr)
        return 2
    t_smoke = time.perf_counter()
    from lux_tpu_torch import native
    from lux_tpu_torch.apps import colfilter as cf_app
    from lux_tpu_torch.apps import common
    from lux_tpu_torch.apps import components as cc_app
    from lux_tpu_torch.apps import pagerank as app
    from lux_tpu_torch.apps import sssp as sssp_app
    from lux_tpu_torch.engine import push
    from lux_tpu_torch.graph import csc, generate
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.models import colfilter as cf_model
    from lux_tpu_torch.models import components as cc_model
    from lux_tpu_torch.models import sssp as sssp_model
    from lux_tpu_torch.models.pagerank import pagerank_reference
    from lux_tpu_torch.ops import cuda_build, expand, scan, segment, shuffle, spmv
    from lux_tpu_torch.ops import route as route_mod
    from lux_tpu_torch.utils.config import parse_args

    # the host oracles take minutes: start them now, beside the card
    global _POOL, _TMP
    _TMP = tempfile.mkdtemp(prefix="lux_smoke_")
    _POOL = multiprocessing.get_context("spawn").Pool(4)
    cf_oracle = _POOL.apply_async(cf_oracle_f64, (SCALE,))
    push_oracle = _POOL.apply_async(push_oracles, (SCALE,))
    spec_oracle_a = _POOL.apply_async(spec_oracles_bfs_labelprop, (SCALE,))
    spec_oracle_b = _POOL.apply_async(spec_oracles_kcore_triangles, (SCALE, TRI_SCALE))
    long_w = _POOL.apply_async(long_weighted_graph, (_TMP, SCALE))
    long_s = _POOL.apply_async(long_stream_graph, (_TMP, STREAM_SCALE))
    serve_oracle = _POOL.apply_async(serve_oracles, (SCALE,))
    mutate_oracle = _POOL.apply_async(mutate_oracles, (SCALE,))

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    kernels = counters(spmv, scan, shuffle)

    # 1. device
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "numpy": np.__version__})

    # 2. build
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    t1 = time.perf_counter()
    require(native.available(), "the native route colorer did not build")
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "nvcc_seconds": built,
          "nvcc_wall": t1 - t0, "native_colorer_seconds": time.perf_counter() - t1,
          "nvcc": cuda_build.nvcc_path(), "native": str(native.library_path().name)})
    for name in cuda_build.SOURCES:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"# ptxas {name}: {line.strip()}", flush=True)

    # 3. kernels of the direct path against their plain versions
    t0 = time.perf_counter()
    small = ragged_graph(np, csc)
    small_bc = spmv.build_blockcsr(small)
    g = generate.rmat(SCALE, EF, seed=0)
    bc = spmv.build_blockcsr(g)
    rows_spmv = (spmv_cases(torch, np, spmv, small_bc, dev, REPS, False)
                 + spmv_cases(torch, np, spmv, bc, dev, REPS, True))
    rng = np.random.default_rng(9)
    n_small = 10007
    head_s = rng.random(n_small) < 0.1
    head_s[3000:9000] = False  # one segment spanning several tiles
    vals_s = rng.random(n_small, dtype=np.float32) + 0.01
    vals_s[9500:] = np.where(np.arange(n_small - 9500) % 2, np.nan, np.inf)
    invalid_s = np.zeros(n_small, bool)
    invalid_s[9500:] = True
    rows_scan = scan_cases(
        torch, np, scan, torch.from_numpy(head_s).to(dev), None,
        torch.from_numpy(invalid_s).to(dev), torch.from_numpy(vals_s).to(dev),
        dev, REPS, False)
    sh = build_pull_shards(g, 1)
    state = torch.from_numpy(rng.random(sh.spec.gathered_size, dtype=np.float32)
                             + 0.01).to(dev)
    src_pos = torch.from_numpy(sh.arrays.src_pos[0]).to(dev).long()
    row_ptr = torch.from_numpy(sh.arrays.row_ptr[0]).to(dev)
    main_head = torch.from_numpy(sh.arrays.head_flag[0]).to(dev)
    main_vals = state[src_pos].contiguous()
    rows_scan += scan_cases(torch, np, scan, main_head, row_ptr[-1:], None, main_vals, dev,
                            REPS, True)
    spmv_main, scan_main = timed(rows_spmv), timed(rows_scan)
    spmv_hub = spmv_hub_case(torch, np, spmv, bc, dev, REPS, spmv_main["kernel_ms"])
    scan_seg = scan_one_segment_case(torch, np, scan, dev, REPS, scan_main["kernel_ms"])
    # the launches: grid, threads, shared-memory bytes (static: the
    # combination trees' per-warp tables; no dynamic shared memory)
    C, T = bc.e_dst_rel.shape
    n_out = bc.num_vblocks * bc.v_blk
    e_dst = torch.from_numpy(bc.e_dst_rel).to(dev)
    cb = torch.from_numpy(bc.chunk_block).to(dev)
    cf = torch.from_numpy(bc.chunk_first).to(dev)
    spmv_vals = state[torch.from_numpy(bc.e_src_pos).to(dev).long()]
    spmv_launch = {
        "fill": {"ctas": min(-(-n_out // 256), 1056), "threads": 256, "smem_bytes": 0},
        "spans": {"ctas": -(-C * T // spmv.SPAN_SLOTS), "threads": 512,
                  "slots_per_cta": spmv.SPAN_SLOTS, "smem_bytes": 5 * 32 * 4},
        "fold": {"ctas": 1, "threads": 1024, "smem_bytes": 5 * 32 * 4}}
    n_scan = main_vals.numel()
    tiles = -(-n_scan // 8192)
    scan_launch = {
        "tiles": {"ctas": tiles, "threads": 512, "elems_per_cta": 8192,
                  "smem_bytes": 3 * 16 * 4},
        "carries": {"ctas": 1, "threads": 1024, "smem_bytes": 2 * 32 * 4},
        "apply": {"ctas": tiles - 1, "threads": 256, "smem_bytes": 0}}
    # the main shapes' f32 sums, traced with the mx kernel in phase 5
    to_trace = {
        "spmv_blockcsr": (functools.partial(
            spmv.spmv_blockcsr, spmv_vals, e_dst, cb, cf, op="sum", v_blk=bc.v_blk,
            num_vblocks=bc.num_vblocks), {"fill": "runs_fill_kernel", "spans": "spmv_span_kernel",
                                          "fold": "runs_fold_kernel"}),
        "mxscan_segmented": (functools.partial(
            scan.mxscan_segmented, main_vals, main_head, op="sum", valid_end=row_ptr[-1:]),
            {"tiles": "scan_tiles", "carries": "scan_carries", "apply": "apply_carries"})}
    emit({"phase": "kernels", "kernels": ["spmv_blockcsr", "mxscan_segmented"],
          "spmv_blockcsr": rows_spmv, "mxscan_segmented": rows_scan,
          "spmv_one_hub": spmv_hub, "scan_one_segment": scan_seg,
          "spmv_launch": spmv_launch, "scan_launch": scan_launch,
          "graph": {"scale": SCALE, "ef": EF, "nv": g.nv, "ne": g.ne,
                    "chunks": C, "t_chunk": T, "vblocks": bc.num_vblocks},
          "seconds": time.perf_counter() - t0})
    del bc, state, src_pos, row_ptr, main_head, main_vals, spmv_vals, e_dst, cb, cf

    # 4. the routed plans, each family built once
    t0 = time.perf_counter()
    plans, reports = {}, []
    for mode, build in (
            ("expand", lambda: expand.plan_expand_shards(sh)),
            ("expand-pf", lambda: expand.to_pf(plans["expand"])),
            ("fused", lambda: expand.plan_fused_shards(sh, "sum")),
            ("fused-pf", lambda: expand.to_pf(plans["fused"])),
            ("fused-mx", lambda: expand.plan_fused_shards(sh, "sum", mx=True))):
        plans[mode], rep = timed_plan(native, route_mod, shuffle, mode, build)
        reports.append(rep)
        require(rep["native"] is (None if mode.endswith("-pf") else True),
                f"plan {mode}: colorer {rep['colorer_calls']}, the native one must run")
    emit({"phase": "plan", "plans": reports, "seconds": time.perf_counter() - t0})

    # 5. the routed-pull kernels against their plain versions
    t0 = time.perf_counter()
    on_dev = {m: expand.plan_to_device(p, dev) for m, p in plans.items()}
    r1a = expand.split_arrays(on_dev["expand"][0], on_dev["expand"][1])[0]
    rows_lane = lane_cases(torch, np, shuffle, dev, r1a[0][0].reshape(-1, 128), REPS)
    rows_sub = sublane_cases(torch, np, shuffle, dev, REPS)
    part = {m: (st, tuple(a[0] for a in arr)) for m, (st, arr) in on_dev.items()}
    rows_fused = fused_cases(torch, np, shuffle, expand, part["expand-pf"], dev, REPS)
    rows_mx, mx_fn = mx_cases(torch, np, shuffle, expand, part["fused-mx"], dev, REPS)
    to_trace["mxreduce_pass_gather"] = (mx_fn, {"fill": "runs_fill_kernel",
                                                "chunks": "mx_chunk_kernel",
                                                "fold": "runs_fold_kernel"})
    yard = path_yardsticks(torch, np, expand, segment, sh, on_dev, dev, REPS)
    # each launch's traced device time, the three kernels in one session
    traced = traced_splits(torch, to_trace)
    del to_trace, mx_fn
    emit({"phase": "routed", "lane_gather": rows_lane, "sublane_gather": rows_sub,
          "fused_pass_gather": rows_fused, "mxreduce_pass_gather": rows_mx,
          "path": yard, "seconds": time.perf_counter() - t0})
    mx_t = traced["mxreduce_pass_gather"]
    mx_total = sum(ms for ms in mx_t.values() if ms)
    emit({"phase": "traced", "traced_ms": traced,
          "mx_fold_share": mx_t["fold"] / mx_total if mx_t["fold"] else None})
    del on_dev, part, r1a
    torch.cuda.empty_cache()

    # 6. the main path, through the app
    ref = None
    runs, launches, ranks = [], {}, {}
    runs = [("pallas", ["--method", "pallas"], None), ("mxscan", ["--method", "mxscan"], None)]
    for mode in ROUTED:
        flag = ["--route-gather"] + ([mode] if mode else [])
        method = ["--method", "mxscan"] if not mode.startswith("fused") else []
        runs.append((mode or "bare", flag + method, plans[mode or "expand-pf"]))
    for label, extra, route in runs:
        argv_app = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF), "--seed", "0",
                    "-ni", str(ITERS), "-check", "--device", "cuda"] + extra
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = app.run(argv_app, route=route, graph=g)
        counts = {name: fn.launches for name, fn in kernels.items()}
        mode = res.route_gather or label
        launches[mode] = counts
        ranks[mode] = res.ranks
        if ref is None:
            ref = pagerank_reference(res.graph, ITERS)
        finite = bool(np.isfinite(res.ranks).all()) and res.ranks.shape == (res.graph.nv,)
        rel = float(np.max(np.abs(res.ranks.astype(np.float64) - ref)
                           / np.abs(ref.astype(np.float64))))
        emit({"phase": "main", "run": label, "mode": mode, "argv": extra, "rc": res.rc,
              "launches": counts, "finite": finite, "max_rel_err_vs_f64": rel,
              "gteps": res.gteps, "ms_per_iter": res.seconds * 1e3 / ITERS,
              "seconds": res.seconds, "wall_seconds": time.perf_counter() - t0,
              "nv": res.graph.nv, "ne": res.graph.ne, "device": smi})
        require(res.rc == 0, f"{label}: -check failed")
        require(finite, f"{label}: ranks not finite or misshaped")
        require(rel <= RANK_RTOL, f"{label}: ranks off the f64 oracle by {rel}")
        require(counts[RUN_KERNEL[mode]] >= ITERS,
                f"{label}: {RUN_KERNEL[mode]} launched {counts[RUN_KERNEL[mode]]} times")
        if mode.startswith("expand"):
            require(counts["mxscan_segmented"] >= ITERS, f"{label}: mxscan not launched")
            require(np.array_equal(res.ranks, ranks["mxscan"]),
                    f"{label}: ranks differ from the direct mxscan run")
        if label == "bare":
            require(mode == "expand-pf", f"the bare --route-gather ran {mode}")
    require(np.array_equal(ranks["fused-pf"], ranks["fused"]),
            "fused-pf ranks differ from fused")
    # the push phases reuse the main graph, its pull layout and its expand
    # plans; the dynamic-graph phase the pass-fused families
    push_plans = {m: plans[m] for m in ("expand", "expand-pf")}
    mutate_plans = {m: plans[m] for m in ("expand-pf", "fused-pf", "fused-mx")}
    pr_ranks = ranks["mxscan"]  # phase 16's uninterrupted run
    del plans, ranks, ref, res, small, small_bc
    torch.cuda.empty_cache()

    # 7. collaborative filtering's kernel against its plain version
    t0 = time.perf_counter()
    g_cf = common.load_graph(parse_args(cf_argv(SCALE)), weighted=True, bipartite=True)
    bc_cf = spmv.build_blockcsr(g_cf)
    rows_2d = (spmv_2d_cases(torch, np, spmv, spmv.build_blockcsr(ragged_graph(np, csc)), dev,
                             (1, 3, CF_K), REPS, False)
               + spmv_2d_cases(torch, np, spmv, bc_cf, dev, (CF_K,), REPS, True))
    emit({"phase": "cf_kernel", "spmv_blockcsr_2d": rows_2d,
          "graph": {"scale": SCALE, "ef": EF, "nv": g_cf.nv, "ne": g_cf.ne,
                    "chunks": bc_cf.num_chunks, "vblocks": bc_cf.num_vblocks},
          "seconds": time.perf_counter() - t0})
    del bc_cf
    torch.cuda.empty_cache()

    # 8. collaborative filtering through the app: the kernel path and the
    # engine at scale 20, the routed reads at CF_ROUTED_SCALE
    t0 = time.perf_counter()
    g_r = common.load_graph(parse_args(cf_argv(CF_ROUTED_SCALE)), weighted=True,
                            bipartite=True)
    sh_r = build_pull_shards(g_r, 1)
    route_mod.reset_color_stats()
    plan_e = expand.plan_cf_route_shards(sh_r)
    t1 = time.perf_counter()
    plan_pf = expand.to_pf(plan_e)
    emit({"phase": "cf_plan", "scale": CF_ROUTED_SCALE, "nv": g_r.nv, "ne": g_r.ne,
          "expand_seconds": t1 - t0, "to_pf_seconds": time.perf_counter() - t1,
          "arrays": len(plan_e[1]), "pf_arrays": len(plan_pf[1]),
          "colorer_calls": dict(route_mod.COLOR_STATS)})
    del sh_r
    states = {}
    for scale, label, extra, route in (
            (SCALE, "pallas", ["--method", "pallas"], None),
            (SCALE, "scatter", ["--method", "scatter"], None),
            (SCALE, "auto", [], None),
            (CF_ROUTED_SCALE, "direct", [], None),
            (CF_ROUTED_SCALE, "expand-pf", ["--route-gather", "expand-pf"], plan_pf),
            (CF_ROUTED_SCALE, "expand", ["--route-gather", "expand"], plan_e)):
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = cf_app.run(cf_argv(scale) + extra, route=route,
                         graph=g_cf if scale == SCALE else g_r)
        counts = {name: fn.launches for name, fn in kernels.items()}
        launches[f"cf-{label}"] = counts
        states[label] = res.state
        finite = (bool(np.isfinite(res.state).all())
                  and res.state.shape == (res.graph.nv, CF_K))
        emit({"phase": "cf_main", "run": label, "scale": scale, "argv": extra, "rc": res.rc,
              "launches": counts, "finite": finite, "rmse": res.rmse,
              "rmse_init": cf_model.init_rmse(res.graph), "gteps": res.gteps,
              "ms_per_iter": res.seconds * 1e3 / ITERS, "seconds": res.seconds,
              "wall_seconds": time.perf_counter() - t0, "nv": res.graph.nv,
              "ne": res.graph.ne, "device": smi})
        require(res.rc == 0, f"cf {label}: -check failed")
        require(finite, f"cf {label}: state not finite or misshaped")
        if label in CF_RUN_KERNEL:
            name = CF_RUN_KERNEL[label]
            require(counts[name] >= ITERS, f"cf {label}: {name} launched {counts[name]} times")
        if route is not None:
            require(np.array_equal(res.state, states["direct"]),
                    f"cf {label}: state differs from the direct run at scale {scale}")
        del res
    del plan_e, plan_pf, states, g_r
    torch.cuda.empty_cache()

    # the libraries at gamma = CF_GAMMA against the f64 oracle
    t0 = time.perf_counter()
    run_2d, s0 = cf_model.make_pallas_runner(g_cf, gamma=CF_GAMMA, device=dev)
    got = {"make_pallas_runner": run_2d(s0, ITERS)[: g_cf.nv].float().cpu().numpy()}
    del run_2d, s0
    torch.cuda.empty_cache()
    got["colfilter"] = cf_model.colfilter(g_cf, ITERS, gamma=CF_GAMMA, device=dev)
    t1 = time.perf_counter()
    v64, rmse64, oracle_s = cf_oracle.get(timeout=1200)
    for name, v in got.items():
        rel = float(np.max(np.abs(v - v64) / np.abs(v64)))
        rmse = cf_model.rmse(g_cf, v)
        emit({"phase": "cf_accuracy", "runner": name, "gamma": CF_GAMMA, "iters": ITERS,
              "max_rel_err_vs_f64": rel, "rmse": rmse, "rmse_init": cf_model.init_rmse(g_cf),
              "oracle_rmse": rmse64, "oracle_seconds": oracle_s,
              "oracle_wait_seconds": time.perf_counter() - t1,
              "runs_seconds": t1 - t0})
        require(bool(np.isfinite(v).all()) and v.shape == (g_cf.nv, CF_K),
                f"{name}: state not finite or misshaped")
        require(rel <= CF_RTOL, f"{name}: off the f64 oracle by {rel}")
        require(rmse < cf_model.init_rmse(g_cf), f"{name}: training did not lower the RMSE")

    del g_cf, got
    torch.cuda.empty_cache()

    # 9. SSSP through the app from the vertex with the largest out-degree
    t0 = time.perf_counter()
    start = int(np.argmax(g.out_degrees()))
    sssp_runs, sssp_launches = push_runs(np, sssp_app, "push_main", g, ["-start", str(start)],
                                         push_plans, kernels, smi)
    o_start, o_dist, o_labels, oracle_s, o_tail = push_oracle.get(timeout=900)
    require(o_start == start, f"the oracle's start {o_start} is not {start}")
    require(np.array_equal(sssp_runs["mxscan"].state, o_dist),
            "SSSP distances differ from the scipy BFS oracle")
    emit({"phase": "push_main", "start": start, "oracle": "scipy.sparse.csgraph BFS",
          "oracle_seconds": oracle_s, "reached": int((o_dist < g.nv).sum()),
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    # 10. connected components: the push form under the five modes, the pull form once
    t0 = time.perf_counter()
    cc_runs, cc_launches = push_runs(np, cc_app, "cc_main", g, [], push_plans, kernels, smi)
    for fn in kernels.values():
        fn.launches = 0
    t1 = time.perf_counter()
    pull_labels = cc_model.connected_components(g, method="mxscan", device=dev)
    pull_s = time.perf_counter() - t1
    pull_counts = {name: fn.launches for name, fn in kernels.items()}
    require(pull_counts["mxscan_segmented"] > 0, "the pull form launched no mxscan")
    require(np.array_equal(pull_labels, cc_runs["mxscan"].state),
            "the pull form's labels differ from the push form's")
    require(np.array_equal(cc_runs["mxscan"].state, o_labels),
            "labels differ from the max-label fixpoint oracle")
    emit({"phase": "cc_main", "run": "pull", "method": "mxscan", "wall_seconds": pull_s,
          "launches": pull_counts, "distinct_labels": int(len(np.unique(o_labels))),
          "oracle": "max-label fixpoint (np.maximum.at)", "seconds": time.perf_counter() - t0})
    race = push_race(torch, push, sh, (
        ("sssp", sssp_model.SSSPProgram(nv=g.nv, start=start), sssp_runs["mxscan"].state),
        ("components", cc_model.MaxLabelProgram(), cc_runs["mxscan"].state)), dev, REPS)
    emit({"phase": "push_race", "ms_per_dense_round": race,
          "winner": {name: min(ms, key=ms.get) for name, ms in race.items()}, "device": smi})
    cc_whole = cc_runs["mxscan"]  # phase 16's uninterrupted run
    del sssp_runs, cc_runs
    torch.cuda.empty_cache()

    # 11-12. the spec workloads, their kernel callers, the sum race
    spec_launches = spec_phases(torch, np, g, sh, push_plans, kernels, smi, dev,
                                spec_oracle_a, spec_oracle_b)
    torch.cuda.empty_cache()

    # 13-16. the long and out-of-core runs
    long_launches = {}
    gw, delta_runs, long_launches["delta"], delta_row = delta_main(
        torch, np, kernels, smi, dev, _TMP, long_w, push_plans["expand-pf"], start, REPS)
    del push_plans
    torch.cuda.empty_cache()
    long_launches["repart"] = repart_main(np, kernels, smi, g, o_tail, o_labels)
    torch.cuda.empty_cache()
    long_launches["stream"], stream_rows = stream_main(torch, np, kernels, smi, dev, _TMP,
                                                       long_s, REPS)
    torch.cuda.empty_cache()
    long_launches["ckpt"] = ckpt_main(np, kernels, smi, _TMP, g, gw, start, pr_ranks,
                                      delta_runs[f"delta-{DELTA_WIDTHS[0]}"], cc_whole)
    long_rows = [delta_row] + stream_rows
    del gw, delta_runs, cc_whole, pr_ranks
    torch.cuda.empty_cache()

    # 17. the batched query service
    serve_launches = serve_main(torch, np, kernels, smi, dev, g, sh, serve_oracle)
    torch.cuda.empty_cache()

    # 18. dynamic graphs
    mutate_launches, mutate_err, _ = mutate_main(torch, np, kernels, smi, dev, g, _TMP,
                                                 mutate_oracle, (g, sh, mutate_plans), REPS)
    del g, sh, mutate_plans
    torch.cuda.empty_cache()

    table = []
    for name, rows, stress, run, replaces in (
            ("spmv_blockcsr", rows_spmv, spmv_hub, "pallas", "lux_tpu/ops/pallas_spmv.py:273"),
            ("mxscan_segmented", rows_scan, scan_seg, "mxscan",
             "lux_tpu/ops/pallas_scan.py:193")):
        r = timed(rows)
        extra = long_rows if name == "mxscan_segmented" else []
        table.append({"name": name, "route": "cuda",
                      "source": f"lux_tpu_torch/csrc/{cuda_build.SOURCES[name]}",
                      "replaces": replaces, "launches": launches[run][name],
                      "max_abs_err": max(x["max_abs_err"] for x in rows + [stress] + extra),
                      "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                      "bound_ms": r["bound_ms"], "bound_by": "bytes",
                      "library_ms": r["library_ms"]})
    r = next(x for x in rows_2d if "kernel_ms" in x and x["dtype"] == "float32")
    table.append({"name": "spmv_blockcsr_2d", "route": "cuda",
                  "source": f"lux_tpu_torch/csrc/{cuda_build.SOURCES['spmv_blockcsr_2d']}",
                  "replaces": "lux_tpu/ops/pallas_spmv.py:343",
                  "launches": launches["cf-pallas"]["spmv_blockcsr_2d"],
                  "max_abs_err": max(x["max_abs_err"] for x in rows_2d),
                  "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                  "bound_by": "bytes", "library_ms": r["library_ms"]})
    for name, r, replaces in (
            ("lane_gather", rows_lane, "lux_tpu/ops/pallas_shuffle.py:89"),
            ("sublane_gather", rows_sub, "lux_tpu/ops/pallas_shuffle.py:116"),
            ("fused_pass_gather", rows_fused, "lux_tpu/ops/pallas_shuffle.py:981"),
            ("mxreduce_pass_gather", rows_mx, "lux_tpu/ops/pallas_shuffle.py:937")):
        table.append({"name": name, "route": "cuda",
                      "source": f"lux_tpu_torch/csrc/{cuda_build.SOURCES[name]}",
                      "replaces": replaces,
                      "launches": max(c[name] for c in launches.values()),
                      "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": "bytes", "library_ms": r["library_ms"]})
    for row in table:
        run = PUSH_KERNEL_RUN.get(row["name"])
        row["launches_push"] = {"sssp": sssp_launches[run][row["name"]] if run else 0,
                                "components": cc_launches[run][row["name"]] if run else 0}
        row["launches_spec"] = {
            prog: spec_launches[runs[row["name"]]][row["name"]] if row["name"] in runs else 0
            for prog, runs in SPEC_KERNEL_RUN.items()}
        row["launches_long"] = {
            kind: long_launches[phase][run][row["name"]]
            for kind, (phase, run) in LONG_KERNEL_RUN.get(row["name"], {}).items()}
        row["launches_serve"] = serve_launches[row["name"]]
        row["launches_mutate"] = mutate_launches[row["name"]]
        if row["name"] in mutate_err:
            row["max_abs_err"] = max(row["max_abs_err"], mutate_err[row["name"]])
    emit({"phase": "total", "seconds": time.perf_counter() - t_smoke})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    finally:
        if _POOL is not None:
            _POOL.terminate()
            _POOL.join()
        if _TMP is not None:
            shutil.rmtree(_TMP, ignore_errors=True)
