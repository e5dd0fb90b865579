#!/usr/bin/env python3
"""On-card smoke test of lux_tpu_torch: build, check and time the CUDA
kernels, then drive single-GPU PageRank through the app.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It takes no options: the main path is the repository's headline size,
RMAT scale 20, edge factor 16, seed 0, 10 PageRank iterations.

Phases, each printing one JSON line:
  1. device   the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build    nvcc of every kernel source, all in parallel; seconds.
  3. kernels  each kernel against its plain PyTorch version on the card,
              at a small ragged shape and at the main path's shape, for
              sum/min/max in f32 and int32 (and bf16 sum for the SpMV).
              min/max/int32 must be bitwise equal; f32 sums of positive
              values within rtol 1e-5 (the kernels associate the sum in
              another order than the plain versions; bf16 inputs are the
              same bits on both sides and both accumulate in f32).
              Times: kernel, plain, one PyTorch library call where one
              computes the same function, and the bound: the bytes the
              function must move over the card's memory rate (both
              kernels do about one add or compare per 8-9 bytes, so
              their operation time is ~100x below it).
  4. main     `apps.pagerank` with --method pallas and then --method
              mxscan, 10 iterations with -check: check_ranks must report 0
              bad vertices, the ranks must be within rtol 1e-4 of the
              float64 oracle (10 iterations of float32 accumulation over
              segments of up to ~1e5 edges), and the launch counter of the
              method's kernel must read >= the iteration count.
Then the kernel table as one JSON line, the nvidia-smi line, and the
verdict line {"ok": true, "device": {...}} last.  Any failed phase exits
non-zero before the verdict; so does a machine without a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

SCALE, EF, ITERS = 20, 16, 10  # the main path: RMAT 20 / ef 16, 10 iterations
REPS = 20  # timed launches per kernel
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SUM_RTOL = 1e-5
RANK_RTOL = 1e-4


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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on the card",
              file=sys.stderr)
        return 2
    from lux_tpu_torch.apps import pagerank as app
    from lux_tpu_torch.graph import csc, generate
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.models.pagerank import pagerank_reference
    from lux_tpu_torch.ops import cuda_build, scan, spmv

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)

    # 1. device
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "nvcc": cuda_build.nvcc_path()})
    for name in cuda_build.SOURCES:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"# ptxas {name}: {line.strip()}", flush=True)

    # 3. kernels against their plain versions
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
          "graph": {"scale": SCALE, "ef": EF, "nv": g.nv, "ne": g.ne}})
    del bc, sh, state, src_pos, row_ptr

    # 4. the main path, through the app
    ref = None
    counters = {"pallas": spmv.spmv_blockcsr, "mxscan": scan.mxscan_segmented}
    launches = {}
    for method, counter in counters.items():
        argv_app = ["--rmat-scale", str(SCALE), "--rmat-ef", str(EF),
                    "--seed", "0", "-ni", str(ITERS), "--method", method,
                    "-check", "--device", "cuda"]
        spmv.spmv_blockcsr.launches = 0
        scan.mxscan_segmented.launches = 0
        res = app.run(argv_app)
        launches[method] = counter.launches
        if ref is None:
            ref = pagerank_reference(res.graph, ITERS)
        finite = bool(np.isfinite(res.ranks).all()) and res.ranks.shape == (res.graph.nv,)
        rel = float(np.max(np.abs(res.ranks.astype(np.float64) - ref)
                           / np.abs(ref.astype(np.float64))))
        emit({"phase": "main", "method": method, "rc": res.rc,
              "launches": launches[method], "finite": finite,
              "max_rel_err_vs_f64": rel, "gteps": res.gteps,
              "ms_per_iter": res.seconds * 1e3 / ITERS, "seconds": res.seconds,
              "nv": res.graph.nv, "ne": res.graph.ne, "device": smi})
        require(res.rc == 0, f"{method}: -check failed")
        require(finite, f"{method}: ranks not finite or misshaped")
        require(rel <= RANK_RTOL, f"{method}: ranks off the f64 oracle by {rel}")
        require(launches[method] >= ITERS,
                f"{method}: kernel launched {launches[method]} times")

    def timed(rows, op="sum", dtype="float32"):
        return next(r for r in rows if "kernel_ms" in r and r["op"] == op
                    and r["dtype"] == dtype)

    table = []
    for name, rows, method, replaces in (
            ("spmv_blockcsr", rows_spmv, "pallas", "lux_tpu/ops/pallas_spmv.py:273"),
            ("mxscan_segmented", rows_scan, "mxscan", "lux_tpu/ops/pallas_scan.py:193")):
        r = timed(rows)
        table.append({"name": name, "route": "cuda",
                      "source": f"lux_tpu_torch/csrc/{cuda_build.SOURCES[name]}",
                      "replaces": replaces, "launches": launches[method],
                      "max_abs_err": max(x["max_abs_err"] for x in rows),
                      "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                      "bound_ms": r["bound_ms"], "bound_by": "bytes",
                      "library_ms": r["library_ms"]})
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
