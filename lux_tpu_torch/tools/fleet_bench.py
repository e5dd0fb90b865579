"""Fleet saturation benchmark: ramp offered QPS to the throughput knee.

    python -m lux_tpu_torch.tools.fleet_bench [--rmat-scale 12] [--rmat-ef 8]
        [--workers 1,2,4] [--mode proc|thread] [--buckets 1,8]
        [--method auto] [--start-qps 8] [--growth 1.6] [--levels 12]
        [--window-s 1.5] [--graph path.lux] [--min-scaleup 0]
        [--device cuda|cpu]

Counterpart of the reference's ``tools/fleet_bench.py``.  Starts a
1/2/4-worker loopback serving fleet (``serve/fleet``) on one RMAT graph —
worker processes by default, each a CUDA process on the card — and ramps
an open-loop SSSP query load until the fleet stops sustaining it
(``serve/fleet/bench.measure_fleet_saturation``).  Prints one JSON line
per fleet width, ``sssp_fleet_qps_w{W}_rmat{scale}_1chip``: goodput QPS
at the knee with p50/p99 there, the ramp's levels, the controller's
counters and each worker's peak device memory.  ``--device cpu`` runs the
workers on the CPU and adds ``_cpu_fallback`` to the row names (the
suffix only labels the rows); without a card and without ``--device
cpu`` it refuses to run.  A nonzero ``--min-scaleup`` makes it a gate on
the paired 2-vs-1-worker probe.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="ramp a serving fleet's offered QPS to the knee, per width")
    ap.add_argument("--rmat-scale", type=int, default=12)
    ap.add_argument("--rmat-ef", type=int, default=8)
    ap.add_argument("--workers", default="1,2,4",
                    help="comma list of fleet widths to ramp")
    ap.add_argument("--mode", default="proc", choices=["proc", "thread"])
    ap.add_argument("--num-parts", type=int, default=1)
    ap.add_argument("--buckets", default="1,8")
    ap.add_argument("--method", default="auto")
    ap.add_argument("--start-qps", type=float, default=8.0)
    ap.add_argument("--growth", type=float, default=1.6)
    ap.add_argument("--levels", type=int, default=12)
    ap.add_argument("--window-s", type=float, default=1.5)
    ap.add_argument("--graph", default="",
                    help="existing .lux snapshot (overrides --rmat-*)")
    ap.add_argument("--no-pin", action="store_true",
                    help="do NOT pin each worker's host threads to one core")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--min-scaleup", type=float, default=0.0,
                    help="exit 1 if the paired 2w/1w ratio < this (a gate)")
    args = ap.parse_args(argv)

    from lux_tpu_torch import obs
    from lux_tpu_torch.serve.fleet.bench import measure_fleet_saturation
    from lux_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)  # no card + cuda: raises here
    widths = tuple(int(w) for w in args.workers.split(",") if w.strip())
    print(f"# fleet_bench: scale={args.rmat_scale} widths={widths} "
          f"mode={args.mode} device={dev} run_id={obs.run_id()}",
          file=sys.stderr, flush=True)
    res = measure_fleet_saturation(
        scale=args.rmat_scale, ef=args.rmat_ef, workers=widths, mode=args.mode,
        parts=args.num_parts,
        buckets=tuple(int(b) for b in args.buckets.split(",") if b),
        start_qps=args.start_qps, growth=args.growth, max_levels=args.levels,
        window_s=args.window_s, seed=args.seed, graph_path=args.graph,
        pin=not args.no_pin, device=dev.type, method=args.method)
    for row in res["rows"]:
        print(json.dumps(row), flush=True)
    knees = res["knees"]
    print("# knees: " + " ".join(f"{w}w={knees[w]}" for w in sorted(knees))
          + (f" paired_2v1={res.get('scaleup_2v1')}" if "scaleup_2v1" in res else ""),
          file=sys.stderr, flush=True)
    if args.min_scaleup:
        ratio = res.get("scaleup_2v1")
        if ratio is None:
            print("# FAIL: --min-scaleup set but the paired 2w/1w probe did not "
                  "run (--workers must include 1 and 2)", file=sys.stderr, flush=True)
            return 1
        if ratio < args.min_scaleup:
            print(f"# FAIL: paired 2w/1w {ratio} < {args.min_scaleup}",
                  file=sys.stderr, flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
