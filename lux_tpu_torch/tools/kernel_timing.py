"""Time the routed gather and the sorted segment sum on the card, three ways.

    python -m lux_tpu_torch.tools.kernel_timing [--rows 131072,16384,4096]
        [--segsum] [--json PATH]

For ``lane_gather`` (``ops/shuffle``) at (R, 128) f32 values with uint8
indices, in turns with ``torch.gather`` on the same inputs (kernel,
gather, gather, kernel, ...), each call timed as

  * ``event_ms``: REPS launches back to back between CUDA events (what
    ``chip_smoke.time_ms`` reads; when enqueueing a call takes longer than
    the device's work, this is the enqueue);
  * ``graph_ms``: the device time, REPS launches captured in one CUDA
    graph and the graph replayed between events;
  * ``enqueue_us``: the host's microseconds a call (``time.perf_counter``
    over many calls, the device synchronised only after the clock stops);

beside the bound (R * 128 * 9 bytes over 3.35 TB/s) and the time a plain
``copy_`` of x would take for the same bytes (``copy_rate_ms``: the
card's read-and-write rate, measured).  With ``--segsum``,
``segment_sum_sorted`` (``ops/segment``) on sorted keys of a power-law
degree sequence, at (E,), (E, 20) and (E, 64): two launches held bitwise,
the sum held to a float64 ``index_add_`` at rtol 1e-5, and its event time
beside ``index_add_``'s and the bound.  The indices and keys are drawn
from a seed; ``chip_smoke.py`` calls the same functions with a real
pass's indices and the main layouts' keys.  Prints one JSON line a case
with the card's name; runs only on a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

REPS = 20  # launches a timing
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SUM_RTOL = 1e-5
BF16_RTOL = 2e-2


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def event_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Mean ms a call of ``fn`` over ``reps`` back-to-back calls between
    CUDA events."""
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


def graph_ms(fn, reps: int = REPS, replays: int = 5) -> float:
    """Mean device ms a call of ``fn``: ``reps`` calls captured in one CUDA
    graph, the graph replayed ``replays`` times between events (after one
    untimed replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(end) / (reps * replays)


def enqueue_us(fn, calls: int = 400) -> float:
    """Host microseconds a call: ``calls`` calls under ``time.perf_counter``,
    the device synchronised before the clock starts and after it stops."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def _three(fn) -> dict:
    return {"event_ms": event_ms(fn), "graph_ms": graph_ms(fn), "enqueue_us": enqueue_us(fn)}


def lane_timing(x: torch.Tensor, idx: torch.Tensor) -> dict:
    """``lane_gather`` against ``torch.gather`` at x's shape, in turns
    (kernel, gather, gather, kernel, twice); each reading
    the three times of :func:`_three`.  Checks the kernel bitwise first."""
    from lux_tpu_torch.ops import shuffle

    idx64 = idx.long()
    got = shuffle.lane_gather(x, idx)
    if not torch.equal(got, torch.gather(x, 1, idx64)):
        raise AssertionError(f"lane_gather differs from torch.gather at {tuple(x.shape)}")
    kern = lambda: shuffle.lane_gather(x, idx)  # noqa: E731
    lib = lambda: torch.gather(x, 1, idx64)  # noqa: E731
    runs = {"kernel": [], "torch_gather": []}
    for _ in range(2):
        runs["kernel"].append(_three(kern))
        runs["torch_gather"].append(_three(lib))
        runs["torch_gather"].append(_three(lib))
        runs["kernel"].append(_three(kern))
    nbytes = x.numel() * (2 * x.element_size() + idx.element_size())
    # the card's read-and-write rate on these bytes: a plain copy of x
    dst = torch.empty_like(x)
    copy_ms = graph_ms(lambda: dst.copy_(x))
    return {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
            "idx": str(idx.dtype).split(".")[-1], **runs,
            "bound_ms": bound_ms(nbytes), "bytes": nbytes, "copy_graph_ms": copy_ms,
            "copy_rate_ms": copy_ms * nbytes / (2 * x.numel() * x.element_size())}


def segsum_case(vals: torch.Tensor, keys: torch.Tensor, num_segments: int) -> dict:
    """``segment_sum_sorted`` on f32 ``vals`` by the sorted ``keys``: two
    launches bitwise, the sum within SUM_RTOL of a float64 index_add_, the
    same for the values rounded to bf16 (through the scatter method's
    widen-and-round, within BF16_RTOL); timed beside index_add_."""
    from lux_tpu_torch.ops import segment
    from lux_tpu_torch.utils import roofline

    n = num_segments
    idx = keys.long().clamp(0, n)
    ref = torch.zeros((n + 1,) + vals.shape[1:], dtype=torch.float64, device=vals.device)
    ref.index_add_(0, idx, vals.double())
    ref = ref[:n]
    a = segment.segment_sum_sorted(vals, keys, n)
    b = segment.segment_sum_sorted(vals, keys, n)
    torch.cuda.synchronize()
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError(f"segment_sum_sorted: two launches differ at {tuple(vals.shape)}")
    diff = (a.double() - ref).abs()
    bad = diff > SUM_RTOL * ref.abs()
    if bool(bad.any()):
        raise AssertionError(f"segment_sum_sorted: {int(bad.sum())} sums outside rtol "
                             f"{SUM_RTOL} of float64 at {tuple(vals.shape)}")
    row = {"shape": list(vals.shape), "segments": n, "bitwise_rerun": True,
           "max_abs_err": float(diff.max()) if diff.numel() else 0.0}
    del ref, diff, bad, b
    vb = vals.to(torch.bfloat16)
    refb = torch.zeros((n + 1,) + vals.shape[1:], dtype=torch.float64, device=vals.device)
    refb.index_add_(0, idx, vb.double())
    refb = refb[:n]
    ab = segment._scatter(vb, keys, n, "sum")
    bb = segment._scatter(vb, keys, n, "sum")
    torch.cuda.synchronize()
    if not torch.equal(ab.view(torch.int16), bb.view(torch.int16)):
        raise AssertionError(f"segment_sum_sorted bf16: two launches differ at "
                             f"{tuple(vals.shape)}")
    db = (ab.double() - refb).abs()
    if bool((db > BF16_RTOL * refb.abs() + BF16_RTOL).any()):
        raise AssertionError(f"segment_sum_sorted bf16: outside {BF16_RTOL} of float64 at "
                             f"{tuple(vals.shape)}")
    row["bf16_max_abs_err"] = float(db.max()) if db.numel() else 0.0
    del vb, refb, ab, bb, db
    k = vals[0].numel() if vals.shape[0] else 1
    out = torch.zeros((n + 1,) + vals.shape[1:], dtype=torch.float32, device=vals.device)
    nbytes = roofline.sorted_sum_bytes(keys.numel(), n, k)
    row.update(
        kernel_ms=event_ms(lambda: segment.segment_sum_sorted(vals, keys, n)),
        plain_ms=event_ms(lambda: segment.segment_sum_sorted_plain(vals, keys, n)),
        library_ms=event_ms(lambda: out.index_add_(0, idx, vals)),
        bound_ms=bound_ms(nbytes), bytes=nbytes)
    return row


def powerlaw_keys(rng, num_segments: int, slots: int, pad: int) -> np.ndarray:
    """Sorted int32 keys: ``slots`` draws of a Zipf-like degree sequence over
    ``num_segments`` keys, then ``pad`` padding slots (the sentinel)."""
    w = 1.0 / np.arange(1, num_segments + 1) ** 0.8
    keys = np.sort(rng.choice(num_segments, slots, p=w / w.sum())).astype(np.int32)
    return np.concatenate([keys, np.full(pad, num_segments, np.int32)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="131072,16384,4096")
    ap.add_argument("--segsum", action="store_true")
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--json", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing: no CUDA device; it times the card's kernels")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    rng = np.random.default_rng(args.seed)
    lines = []
    for rows in (int(r) for r in args.rows.split(",") if r):
        x = torch.from_numpy(rng.random((rows, 128), dtype=np.float32)).to(dev)
        idx = torch.from_numpy(rng.integers(0, 128, (rows, 128)).astype(np.uint8)).to(dev)
        lines.append({"kernel": "lane_gather", **lane_timing(x, idx), "device": name})
    if args.segsum:
        nv, ne = 1 << 20, 1 << 24
        keys = torch.from_numpy(powerlaw_keys(rng, nv, ne, 4096)).to(dev)
        for k in (1, 20, 64):
            shape = (keys.numel(),) if k == 1 else (keys.numel(), k)
            vals = torch.from_numpy(rng.random(shape, dtype=np.float32) + 0.01).to(dev)
            lines.append({"kernel": "segment_sum_sorted",
                          **segsum_case(vals, keys, nv), "device": name})
            del vals
            torch.cuda.empty_cache()
    for line in lines:
        print(json.dumps(line), flush=True)
        if args.json:
            with open(args.json, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
