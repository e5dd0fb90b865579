"""Routed-plan cache prewarmer: build the Benes expand/fused/CF plans of a
configuration ahead of the runs that need them.

    python -m lux_tpu_torch.tools.plan_prewarm --scale 20 --ef 16
    python -m lux_tpu_torch.tools.plan_prewarm --scale 18 --kinds expand-pf
    python -m lux_tpu_torch.tools.plan_prewarm --scale 20 --check-only

Counterpart of the reference's ``tools/plan_prewarm.py``.  The plans go
to the per-part disk cache the apps read (``ops/expand``; the directory
is ``LUX_TORCH_PLAN_CACHE``, else ``$TMPDIR/lux_torch_expand_plans_<uid>``,
or ``--cache-dir``), keyed on the exact shard layout bytes, so this
builds the apps' own layout: ``rmat(scale, ef, seed=0)`` (the rating
graph of ``apps.colfilter`` for the ``cf`` kinds) through
``build_pull_shards(g, parts)``, which is also the push apps' dense
layout at one part.  Planning is host work: no card is touched.

Prints one JSON line: per kind the cold/warm seconds and entry counts,
or under ``--check-only`` whether each cache is already warm.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

KINDS = ("expand", "expand-pf", "fused", "fused-pf", "fused-mx", "cf", "cf-pf")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="prewarm the routed-plan disk cache for an app configuration")
    ap.add_argument("--scale", type=int, default=20, help="RMAT scale")
    ap.add_argument("--ef", type=int, default=16, help="edge factor")
    ap.add_argument("--parts", type=int, default=1,
                    help="pull-shard part count (the apps' -ng)")
    ap.add_argument("--kinds", default="expand,expand-pf,fused,fused-pf,fused-mx",
                    help="comma list from {%s}; the -pf families derive from the "
                         "unfused entries by a numpy transform, so warming them "
                         "after the base family costs seconds" % ",".join(KINDS))
    ap.add_argument("--reduce", default="sum",
                    help="fused-plan reduce op (joins the cache tag)")
    ap.add_argument("--threads", type=int, default=0,
                    help="override LUX_ROUTE_THREADS/LUX_PLAN_THREADS "
                         "(0 = leave the env/cpu_count defaults)")
    ap.add_argument("--cache-dir", default=None,
                    help="override the plan cache directory")
    ap.add_argument("--check-only", action="store_true",
                    help="report cache warmth without building")
    args = ap.parse_args(argv)
    kinds = [k.strip() for k in args.kinds.split(",") if k.strip()]
    bad = set(kinds) - set(KINDS)
    if bad:
        ap.error(f"unknown plan kinds: {sorted(bad)}")
    if args.threads > 0:
        os.environ["LUX_ROUTE_THREADS"] = str(args.threads)
        os.environ["LUX_PLAN_THREADS"] = str(args.threads)

    from lux_tpu_torch import native
    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.shards import build_pull_shards
    from lux_tpu_torch.ops import expand

    t0 = time.perf_counter()
    layouts = {}

    def shards_for(kind: str):
        # the CF kinds plan colfilter's rating graph, as apps.colfilter loads it
        rating = kind.startswith("cf")
        if rating not in layouts:
            if rating:
                half = (1 << args.scale) // 2
                g = generate.bipartite_ratings(half, half,
                                               (1 << args.scale) * args.ef // 2, seed=0)
            else:
                g = generate.rmat(args.scale, args.ef, seed=0)
            layouts[rating] = build_pull_shards(g, args.parts)
        return layouts[rating]

    for kind in kinds:
        shards_for(kind)
    out = {
        "scale": args.scale, "ef": args.ef, "parts": args.parts,
        "graph_build_seconds": time.perf_counter() - t0,
        "route_threads": native.route_threads(),
        "plan_threads": expand._plan_threads(),
        "kinds": {},
    }
    cd, red = args.cache_dir, args.reduce
    if args.check_only:
        probes = {
            "expand": lambda s: expand.has_cached_expand_plan(s, cache_dir=cd),
            "expand-pf": lambda s: expand.has_cached_expand_plan(s, cache_dir=cd, pf=True),
            "fused": lambda s: expand.has_cached_fused_plan(s, red, cache_dir=cd),
            "fused-pf": lambda s: expand.has_cached_fused_plan(s, red, cache_dir=cd,
                                                               pf=True),
            "fused-mx": lambda s: expand.has_cached_fused_plan(s, red, cache_dir=cd,
                                                               mx=True),
            "cf": lambda s: expand.has_cached_cf_plan(s, cache_dir=cd),
            "cf-pf": lambda s: expand.has_cached_cf_plan(s, cache_dir=cd, pf=True),
        }
        for kind in kinds:
            out["kinds"][kind] = {"warm": probes[kind](shards_for(kind)) is not None}
        print(json.dumps(out), flush=True)
        return 0

    builders = {
        "expand": lambda s: expand.plan_expand_shards_cached(s, cache_dir=cd),
        "expand-pf": lambda s: expand.plan_expand_shards_cached(s, cache_dir=cd, pf=True),
        "fused": lambda s: expand.plan_fused_shards_cached(s, red, cache_dir=cd),
        "fused-pf": lambda s: expand.plan_fused_shards_cached(s, red, cache_dir=cd,
                                                              pf=True),
        "fused-mx": lambda s: expand.plan_fused_shards_cached(s, red, cache_dir=cd,
                                                              mx=True),
        "cf": lambda s: expand.plan_cf_route_shards_cached(s, cache_dir=cd),
        "cf-pf": lambda s: expand.plan_cf_route_shards_cached(s, cache_dir=cd, pf=True),
    }
    for kind in kinds:
        expand.reset_plan_stats()
        t0 = time.perf_counter()
        _, arrays = builders[kind](shards_for(kind))
        wall = time.perf_counter() - t0
        st = expand.plan_stats_snapshot()
        out["kinds"][kind] = {
            "wall_seconds": wall, "cold_seconds": st["cold_s"],
            "warm_seconds": st["warm_s"], "entries_built": st["built"],
            "entries_loaded": st["loaded"], "warm": st["built"] == 0,
            "plan_bytes": int(sum(a.nbytes for a in arrays)),
        }
        print(f"# {kind}: {wall:.1f} s wall ({st['built']} built / "
              f"{st['loaded']} loaded)", file=sys.stderr, flush=True)
        del arrays
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
