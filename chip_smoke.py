#!/usr/bin/env python3
"""On-card smoke test of lux_tpu_torch: build, check and time the CUDA
kernels, then drive single-GPU PageRank through the app, direct and
routed.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It takes no options: the main path is the repository's headline size,
RMAT scale 20, edge factor 16, seed 0, 10 PageRank iterations.

Phases, each printing one JSON line with its seconds:
  1. device   the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build    nvcc of the six kernel sources, all in parallel, and g++ of
              the native route colorer; seconds of each.
  3. kernels  spmv_blockcsr and mxscan_segmented against their plain
              PyTorch versions, at a small ragged shape and at the main
              path's shape, for sum/min/max in f32 and int32 (and bf16
              sum for the SpMV).  min/max/int32 must be bitwise equal;
              f32 sums of positive values within rtol 1e-5 (the kernels
              associate the sum in another order than the plain
              versions).
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
              expand-pf plan, mxreduce_pass_gather on the main fused-mx
              plan's reduce group (sum/min/max, f32 and int32).  Gathers
              and mx min/max/int32 bitwise, mx f32 sums rtol 1e-5.  Beside
              them the path-level yardsticks: the whole routed expand
              against index_select, and the fused-mx apply against
              index_select plus the mxscan segment sum.
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
Times: kernel, plain, one PyTorch library call where one computes the
same function, and the bound: the bytes the function must move over the
card's memory rate (every kernel here does at most one add or compare
per 8 bytes moved, so its operation time is far below it).
Then the kernel table as one JSON line, the nvidia-smi line, and the
verdict line {"ok": true, "device": {...}} last.  Any failed phase exits
non-zero before the verdict; so does a machine without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
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


def compare(torch, got, want, exact: bool, mask=None) -> float:
    """Max abs difference; raises PhaseFailure past the tolerance."""
    if mask is not None:
        got, want = got[mask], want[mask]
    if exact:
        require(torch.equal(got, want), "kernel differs from its plain version")
        return 0.0
    g32, w32 = got.double(), want.double()
    err = float((g32 - w32).abs().max()) if got.numel() else 0.0
    ok = bool(((g32 - w32).abs() <= SUM_RTOL * w32.abs()).all())
    require(ok, f"f32 sum outside rtol {SUM_RTOL}: max abs err {err}")
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

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        exact = op != "sum"
        err = compare(torch, got, want, exact)
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
        err = compare(torch, got, want, exact, mask)
        row = {"op": op, "dtype": str(dtype).replace("torch.", ""), "n": n,
               "max_abs_err": err, "exact": exact}
        if timed:
            nbytes = n * (vals.element_size() + 1 + vals.element_size())
            row.update(kernel_ms=time_ms(torch, kernel, reps),
                       plain_ms=time_ms(torch, plain, max(2, reps // 4)),
                       library_ms=None, bound_ms=bound_ms(nbytes), bytes=nbytes)
        rows.append(row)
    return rows


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
    return {"spmv_blockcsr": spmv.spmv_blockcsr,
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
    replay order (each group's input is the previous group's output)."""
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
    return {"groups": groups, "max_abs_err": 0.0, "library_ms": None, **mean}


def mx_cases(torch, np, shuffle, expand, plan_mx, dev, reps: int):
    """mxreduce_pass_gather on the main fused-mx plan's reduce group, for
    every op and value type, against its plain version."""
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
        got = shuffle.mxreduce_pass_gather(y, idx, dst_rel, tile_block, g)
        want = shuffle.mxreduce_pass_gather_plain(y, idx, dst_rel, tile_block, g)
        torch.cuda.synchronize()
        exact = not (op == "sum" and x.dtype == torch.float32)
        e = compare(torch, got[:total], want[:total], exact)
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
    return {"cases": rows, "n2": n2, "steps": k, "tile_rows": mxg.block_rows,
            "num_blocks": mxg.num_blocks, "v_blk": mxg.v_blk, "max_abs_err": err,
            # the imbalance of one CTA per output block: the largest block's
            # tiles, and its share of all tiles
            "max_tiles_per_block": int(per_block.max()),
            "mean_tiles_per_block": float(per_block.float().mean()),
            "largest_block_share": float(per_block.max()) / tile_block.numel(),
            "library_ms": None, "bound_ms": bound_ms(nbytes), "bytes": nbytes, **timed}


def path_yardsticks(torch, np, expand, segment, sh, plans, dev, reps: int):
    """The whole routed expand against index_select of the same state,
    and the whole fused-mx apply against index_select + the mxscan
    segment sum: the routed replay's cost beside the direct path's."""
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

    st, arr = plans["fused-mx"]
    part = tuple(a[0] for a in arr)
    got = expand.apply_fused(full, st, part)
    want = direct_sum()
    torch.cuda.synchronize()
    compare(torch, got, want, exact=False)
    out["fused-mx_ms"] = time_ms(torch, lambda: expand.apply_fused(full, st, part), reps)
    out["direct_gather_mxscan_ms"] = time_ms(torch, direct_sum, reps)
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on the card",
              file=sys.stderr)
        return 2
    from lux_tpu_torch import native
    from lux_tpu_torch.apps import pagerank as app
    from lux_tpu_torch.graph import csc, generate
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.models.pagerank import pagerank_reference
    from lux_tpu_torch.ops import cuda_build, expand, scan, segment, shuffle, spmv
    from lux_tpu_torch.ops import route as route_mod

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    kernels = counters(spmv, scan, shuffle)

    # 1. device
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

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
    rows_scan += scan_cases(
        torch, np, scan, torch.from_numpy(sh.arrays.head_flag[0]).to(dev),
        row_ptr[-1:], None, state[src_pos].contiguous(), dev, REPS, True)
    emit({"phase": "kernels", "kernels": ["spmv_blockcsr", "mxscan_segmented"],
          "spmv_blockcsr": rows_spmv, "mxscan_segmented": rows_scan,
          "graph": {"scale": SCALE, "ef": EF, "nv": g.nv, "ne": g.ne},
          "seconds": time.perf_counter() - t0})
    del bc, state, src_pos, row_ptr

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
    rows_mx = mx_cases(torch, np, shuffle, expand, part["fused-mx"], dev, REPS)
    yard = path_yardsticks(torch, np, expand, segment, sh, on_dev, dev, REPS)
    emit({"phase": "routed", "lane_gather": rows_lane, "sublane_gather": rows_sub,
          "fused_pass_gather": rows_fused, "mxreduce_pass_gather": rows_mx,
          "path": yard, "seconds": time.perf_counter() - t0})
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
        res = app.run(argv_app, route=route)
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

    def timed(rows, op="sum", dtype="float32"):
        return next(r for r in rows if "kernel_ms" in r and r["op"] == op
                    and r["dtype"] == dtype)

    table = []
    for name, rows, run, replaces in (
            ("spmv_blockcsr", rows_spmv, "pallas", "lux_tpu/ops/pallas_spmv.py:273"),
            ("mxscan_segmented", rows_scan, "mxscan", "lux_tpu/ops/pallas_scan.py:193")):
        r = timed(rows)
        table.append({"name": name, "route": "cuda",
                      "source": f"lux_tpu_torch/csrc/{cuda_build.SOURCES[name]}",
                      "replaces": replaces, "launches": launches[run][name],
                      "max_abs_err": max(x["max_abs_err"] for x in rows),
                      "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                      "bound_ms": r["bound_ms"], "bound_by": "bytes",
                      "library_ms": r["library_ms"]})
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
