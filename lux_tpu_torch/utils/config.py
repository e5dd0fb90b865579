"""Command-line configuration of the apps.

The flags are the reference CLI's (``lux_tpu.utils.config``) restricted to
what this package runs, plus ``--device``.  Every other reference flag is
rejected with a message that it is not ported yet, never silently
ignored.
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


#: reference flags this package does not run yet
NOT_PORTED = (
    "-start", "-verbose", "-v", "--max-iters", "--distributed", "--ckpt-dir",
    "--ckpt-every", "--profile-dir", "--exchange", "--edge-shards",
    "--feat-shards", "--sort-segments", "--compact-gather",
    "--repartition-every", "--repartition-threshold", "--weighted", "--delta",
    "--serve", "--serve-queries", "--serve-sources", "--serve-buckets",
    "--serve-wait-ms", "--serve-timeout-ms", "--serve-max-queue", "--sources",
    "--labels", "--seed-stride", "--kmax", "--engine", "--directed",
    "--stream-hbm-gib",
)

METHODS = ("auto", "scan", "cumsum", "mxsum", "mxscan", "scatter", "pallas")

#: --route-gather modes (the reference's); the bare flag means "auto"
ROUTE_GATHER = ("auto", "expand", "expand-pf", "fused", "fused-pf", "fused-mx")


@dataclasses.dataclass
class RunConfig:
    file: Optional[str] = None  # .lux path; None => synthetic RMAT
    num_parts: int = 1  # -ng: graph parts (1 on this package)
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


def parse_args(argv=None, description: str = "") -> RunConfig:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("-file", help=".lux graph file (default: synthetic RMAT)")
    ap.add_argument("-ng", "--num-parts", type=int, default=1,
                    help="number of graph parts (only 1 is ported)")
    ap.add_argument("-ni", "--num-iters", type=int, default=10)
    ap.add_argument("-check", "-c", action="store_true")
    ap.add_argument("--method", default="auto", choices=METHODS,
                    help="segment-reduction strategy; auto = the measured "
                         "per-platform winner (engine.methods); pallas = "
                         "the block-CSR SpMV kernel")
    ap.add_argument("--route-gather", nargs="?", const="auto", default="",
                    choices=ROUTE_GATHER,
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
                         "LUX_ROUTE_MODE=routed.  Not with --method pallas")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"], help="state storage dtype")
    ap.add_argument("--rmat-scale", type=int, default=16)
    ap.add_argument("--rmat-ef", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to run (no fallback: cuda without a card fails)")
    ns, rest = ap.parse_known_args(argv)
    for arg in rest:
        flag = arg.split("=", 1)[0]
        if flag in NOT_PORTED:
            ap.error(f"{flag} is not ported to lux_tpu_torch yet")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if ns.num_parts != 1:
        ap.error("-ng: only one part (-ng 1) is ported to lux_tpu_torch yet")
    if ns.route_gather and ns.method == "pallas":
        ap.error("--route-gather does not combine with --method pallas: the "
                 "block-CSR runner has its own gather and no routed form")
    return RunConfig(
        file=ns.file,
        num_parts=ns.num_parts,
        num_iters=ns.num_iters,
        check=ns.check,
        method=ns.method,
        dtype=ns.dtype,
        route_gather=ns.route_gather,
        rmat_scale=ns.rmat_scale,
        rmat_ef=ns.rmat_ef,
        seed=ns.seed,
        device=ns.device,
    )
