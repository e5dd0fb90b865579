"""Command-line configuration of the apps.

The flags are the reference CLI's (``lux_tpu.utils.config``) restricted to
what this package runs, plus ``--device``.  Every other reference flag is
rejected with a message that it is not ported yet, never silently
ignored.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

#: reference flags this package does not run yet
NOT_PORTED = (
    "-start", "-verbose", "-v", "--max-iters", "--distributed", "--ckpt-dir",
    "--ckpt-every", "--profile-dir", "--exchange", "--edge-shards",
    "--feat-shards", "--sort-segments", "--compact-gather", "--route-gather",
    "--repartition-every", "--repartition-threshold", "--weighted", "--delta",
    "--serve", "--serve-queries", "--serve-sources", "--serve-buckets",
    "--serve-wait-ms", "--serve-timeout-ms", "--serve-max-queue", "--sources",
    "--labels", "--seed-stride", "--kmax", "--engine", "--directed",
    "--stream-hbm-gib",
)

METHODS = ("auto", "scan", "cumsum", "mxsum", "mxscan", "scatter", "pallas")


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
    return RunConfig(
        file=ns.file,
        num_parts=ns.num_parts,
        num_iters=ns.num_iters,
        check=ns.check,
        method=ns.method,
        dtype=ns.dtype,
        rmat_scale=ns.rmat_scale,
        rmat_ef=ns.rmat_ef,
        seed=ns.seed,
        device=ns.device,
    )
