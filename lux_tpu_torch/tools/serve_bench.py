"""Serving benchmark: warm batched throughput against Q=1 sequential.

    python -m lux_tpu_torch.tools.serve_bench [--rmat-scale 16] [--rmat-ef 16]
        [--q 64] [--app sssp|ppr] [--num-seq 8] [--reps 2] [--method auto]
        [--min-speedup 0] [--seed 0] [--device cuda|cpu]

Counterpart of the reference's ``tools/serve_bench.py``: measures the
serving path (``serve/benchmarks.measure_serving``) and prints one JSON
line ``<app>_qps_rmat<scale>_1chip`` — warm batched QPS at the Q bucket,
with the warm Q=1 sequential QPS, the batched-vs-sequential ratio,
scheduler latency percentiles, batch occupancy and the warm hit ratio.
It runs on the card by default; ``--device cpu`` runs on the CPU and then
names the row ``..._1chip_cpu_fallback`` (the suffix only labels the
row).  Without a card and without ``--device cpu`` it refuses to run.
A nonzero ``--min-speedup`` makes it a gate: exit 1 when
batched/sequential falls below it.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="warm batched serving throughput against Q=1 sequential")
    ap.add_argument("--rmat-scale", type=int, default=16)
    ap.add_argument("--rmat-ef", type=int, default=16)
    ap.add_argument("--app", default="sssp", choices=["sssp", "ppr"])
    ap.add_argument("--q", type=int, default=64, help="throughput bucket size")
    ap.add_argument("--num-seq", type=int, default=8,
                    help="queries in the warm Q=1 sequential baseline")
    ap.add_argument("--reps", type=int, default=2,
                    help="full Q-batches in the batched measurement")
    ap.add_argument("--num-parts", type=int, default=1)
    ap.add_argument("--method", default="auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--min-speedup", type=float, default=0.0,
                    help="exit 1 if batched/sequential < this (a gate)")
    args = ap.parse_args(argv)

    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.serve.benchmarks import measure_serving
    from lux_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)  # no card + cuda: raises here
    g = generate.rmat(args.rmat_scale, args.rmat_ef, seed=0)
    shards = build_pull_shards(g, args.num_parts)
    print(f"# serve_bench: nv={g.nv} ne={g.ne} app={args.app} q={args.q} "
          f"device={dev}", file=sys.stderr, flush=True)
    res = measure_serving(g, shards, app=args.app, q=args.q, num_seq=args.num_seq,
                          batched_reps=args.reps, method=args.method,
                          seed=args.seed, device=dev)
    suffix = "" if dev.type == "cuda" else "_cpu_fallback"
    line = {"metric": f"{args.app}_qps_rmat{args.rmat_scale}_1chip{suffix}",
            "value": res["qps_batched"], "unit": "QPS",
            # the serving row's baseline IS request-at-a-time serving
            "vs_baseline": res["batched_vs_q1"], **res}
    print(json.dumps(line), flush=True)
    if args.min_speedup and res["batched_vs_q1"] < args.min_speedup:
        print(f"# FAIL: batched/sequential {res['batched_vs_q1']} < "
              f"{args.min_speedup}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
