"""Graph converter: a text edge list to a `.lux` CSC binary.

    python -m lux_tpu_torch.tools.converter -nv N -ne M -input edges.txt \\
        -output g.lux [-weighted] [--python]

Counterpart of the reference's ``tools/converter.py``, with its flags
(-nv -ne -input -output -weighted).  Prefers the native ``lux-convert``
executable (native/converter_main.cc over the counting sort of
native/lux_io.cc, built on first use); without a compiler, or with
``--python``, it parses with numpy and writes through graph/format.
Both write the same bytes: CSC by a stable sort on the destination.  The
input is "src dst [weight]" a line; blank lines and '#' comments are
skipped.  Host work only: no card is touched.
"""
from __future__ import annotations

import argparse
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="text edge list -> .lux")
    ap.add_argument("-nv", type=int, required=True, help="number of vertices")
    ap.add_argument("-ne", type=int, required=True, help="number of edges")
    ap.add_argument("-input", required=True, help="text edge list path")
    ap.add_argument("-output", required=True, help="output .lux path")
    ap.add_argument("-weighted", action="store_true", help="a third column of int32 weights")
    ap.add_argument("--python", action="store_true", help="force the numpy path")
    args = ap.parse_args(argv)

    if not args.python:
        from lux_tpu_torch.native import io as native_io

        exe = native_io.converter()
        if exe is not None:
            cmd = [str(exe), "-nv", str(args.nv), "-ne", str(args.ne),
                   "-input", args.input, "-output", args.output]
            return subprocess.call(cmd + (["-weighted"] if args.weighted else []))

    from lux_tpu_torch.graph.csc import from_edge_list
    from lux_tpu_torch.graph.format import read_edge_list_text, write_lux
    from lux_tpu_torch.native import io as native_io

    with native_io.numpy_path():
        src, dst, w = read_edge_list_text(args.input, weighted=args.weighted)
    if len(src) != args.ne:
        print(f"expected {args.ne} edges, parsed {len(src)}", file=sys.stderr)
        return 1
    if len(src) and (src.min() < 0 or dst.min() < 0 or max(src.max(), dst.max()) >= args.nv):
        print(f"an edge endpoint lies outside [0, {args.nv})", file=sys.stderr)
        return 1
    g = from_edge_list(src, dst, args.nv, weights=w)
    write_lux(args.output, g)
    print(f"wrote {args.output}: nv={g.nv} ne={g.ne}" + (" (weighted)" if args.weighted else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
