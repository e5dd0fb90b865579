"""Generate a synthetic graph as a `.lux` file.

    python -m lux_tpu_torch.tools.gen_graph rmat --scale 22 --ef 16 -o rmat22.lux
    python -m lux_tpu_torch.tools.gen_graph ratings --users 500000 \\
        --items 18000 --ratings 2000000 -o ratings.lux

Counterpart of the reference's ``tools/gen_graph.py`` for the generators
this package has: RMAT (graph/generate.rmat, the same graph as the
reference's for a seed) and collaborative filtering's rating graph
(graph/generate.bipartite_ratings).  The file is written through the
native counting sort when it builds (graph/format.write_lux_edges), else
by numpy; the bytes are the same.  Host work only: no card is touched.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="synthetic graph -> .lux")
    sub = ap.add_subparsers(dest="kind", required=True)
    r = sub.add_parser("rmat")
    r.add_argument("--scale", type=int, required=True)
    r.add_argument("--ef", type=int, default=16)
    r.add_argument("--weighted", action="store_true")
    b = sub.add_parser("ratings")
    b.add_argument("--users", type=int, required=True)
    b.add_argument("--items", type=int, required=True)
    b.add_argument("--ratings", type=int, required=True)
    for p in (r, b):
        p.add_argument("-o", "--output", required=True)
        p.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from lux_tpu_torch.graph import generate
    from lux_tpu_torch.graph.format import write_lux_edges

    if args.kind == "rmat":
        g = generate.rmat(args.scale, args.ef, seed=args.seed, weighted=args.weighted)
    else:
        g = generate.bipartite_ratings(args.users, args.items, args.ratings, seed=args.seed)
    path = write_lux_edges(args.output, g.nv, g.col_idx, g.dst_of_edges(), g.weights)
    print(f"wrote {args.output}: nv={g.nv} ne={g.ne}"
          + (" (weighted)" if g.weighted else "") + f", host path {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
