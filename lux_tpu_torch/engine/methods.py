"""Segment-reduction method resolution.

Counterpart of ``lux_tpu.engine.methods``.  ``method="auto"`` resolves
once at driver entry from the platform and a table of MEASURED winners.
``WINNERS`` gains a ("cuda", reduce) row only from an H100 measurement;
a (platform, reduce) without a row resolves to ``FALLBACK`` — the
portable choice, as the reference does for a platform it has no row
for.  The reference's TPU rows and its winners overlay file are never
read here.

Environment knobs:
  LUX_SUM_MODE         scan | mxsum | mxscan — under ``auto``, forces the
                       float-sum strategy on every platform.
  LUX_METHOD_PLATFORM  overrides the platform name used for resolution.
  LUX_ROUTE_MODE       routed | routed-pf — what the bare --route-gather
                       runs (default routed-pf).
  LUX_REDUCE_MODE      group | mxreduce — the reduce of --route-gather
                       fused-pf (default group).
  LUX_CF_ERR_DOT       vpu | mxu — the collaborative-filtering error-dot
                       (default vpu).
  LUX_MERGE_MODE       bulk | tree — the push engine's cross-part merge of
                       sparse rounds (default bulk).
"""
from __future__ import annotations

import os

#: concrete strategies a resolution may produce ("pallas" needs the
#: block-CSR layout and is chosen by the app, never by resolution)
CONCRETE = ("scan", "cumsum", "mxsum", "mxscan", "scatter")

#: (platform, reduce) -> measured winner.  min/max: chip_smoke.py phase
#: push_race, one dense round of SSSP (min) and components (max) at RMAT
#: 20 on an H100: mxscan 0.314 / 0.332 ms, scatter 0.874 / 0.766, scan
#: 5.06 / 4.99.  sum (one row, keyed as the reference keys its float-sum
#: winner): chip_smoke.py phase sum_race, one segmented sum of one pull
#: iteration at RMAT 20 on an NVIDIA H100 80GB HBM3 at 700.00 W: the
#: PageRank f32 sum mxscan 0.220 ms, scatter 0.579, scan 4.84, mxsum 4.97
#: (and off the float64 sums by up to 45x its value: the global prefix's
#: digits are lost); the k-core int32 sum on the symmetrized graph mxscan
#: 0.180, scatter 0.944, scan 9.24, mxsum (= scan for integers) 9.25.
#: Wide (E, K) sums downgrade mxscan to the plain scan (ops/segment).
WINNERS: dict[tuple[str, str], str] = {
    ("cuda", "min"): "mxscan",
    ("cuda", "max"): "mxscan",
    ("cuda", "sum"): "mxscan",
}

#: platform without a measured row: the portable choice
FALLBACK = "scan"

#: scan-family float-sum strategies LUX_SUM_MODE may select
SUM_MODES = ("scan", "mxsum", "mxscan")


def default_platform(device=None) -> str:
    """"cuda" or "cpu" from ``device`` (a torch.device or string), unless
    LUX_METHOD_PLATFORM overrides it."""
    env = os.environ.get("LUX_METHOD_PLATFORM")
    if env:
        return env
    if device is None:
        return "cpu"
    return getattr(device, "type", str(device).split(":")[0])


def sum_mode() -> str:
    """LUX_SUM_MODE when set (validated), else "scan"."""
    env = os.environ.get("LUX_SUM_MODE")
    if env:
        if env not in SUM_MODES:
            raise ValueError(f"LUX_SUM_MODE must be one of {SUM_MODES}, got {env!r}")
        return env
    return "scan"


def resolve(method: str, reduce: str = "sum", platform: str | None = None) -> str:
    """``"auto"`` -> the measured winner for (platform, reduce), else
    FALLBACK; concrete methods pass through unchanged."""
    if method != "auto":
        return method
    plat = platform if platform is not None else default_platform()
    chosen = WINNERS.get((plat, reduce), FALLBACK)
    if chosen not in CONCRETE:
        raise ValueError(f"winner {chosen!r} for {plat}:{reduce} is not concrete")
    return chosen


def resolve_sum(method: str, reduce: str = "sum", platform: str | None = None) -> str:
    """``resolve`` plus the scan-family refinement: under ``auto``, a sum
    follows LUX_SUM_MODE when it is set (an explicit choice, on every
    platform, as in the reference), else a sum that resolves to "scan"
    follows sum_mode().  Explicit methods and min/max pass through."""
    if method == "auto" and reduce == "sum" and os.environ.get("LUX_SUM_MODE"):
        return sum_mode()
    resolved = resolve(method, reduce, platform)
    if method == "auto" and reduce == "sum" and resolved == "scan":
        return sum_mode()
    return resolved


#: LOAD-phase route modes: "routed" = the unfused Benes expand (one
#: kernel per pass), "routed-pf" = the pass-fused replay (2-3 passes per
#: kernel, ops/expand.to_pf).  Both are bitwise-identical to the direct
#: gather, so either is always safe to follow.
ROUTE_MODES = ("routed", "routed-pf")


def route_mode() -> str:
    """The routed-plan flavor the bare ``--route-gather`` runs:
    LUX_ROUTE_MODE when set (validated), else "routed-pf" (the
    reference's default).  The reference's chip-measured overlay entry
    is never read here; an H100 measurement would be its own row."""
    env = os.environ.get("LUX_ROUTE_MODE")
    if env:
        if env not in ROUTE_MODES:
            raise ValueError(
                f"LUX_ROUTE_MODE must be one of {ROUTE_MODES}, got {env!r}")
        return env
    return "routed-pf"


#: REDUCE-phase modes of the fused routed loop: "group" = the plain
#: masked group reshape-reduce (torch), "mxreduce" = the segmented
#: reduction inside the route's final kernel (ops/shuffle
#: .mxreduce_pass_gather).  Float sums associate differently in the two,
#: so the default stays "group", as in the reference.
REDUCE_MODES = ("group", "mxreduce")


def reduce_mode() -> str:
    """The fused-reduce flavor ``--route-gather fused-pf`` follows:
    LUX_REDUCE_MODE when set (validated), else "group"."""
    env = os.environ.get("LUX_REDUCE_MODE")
    if env:
        if env not in REDUCE_MODES:
            raise ValueError(
                f"LUX_REDUCE_MODE must be one of {REDUCE_MODES}, got {env!r}")
        return env
    return "group"


#: CF error-dot flavors (models/colfilter.err_dot): "vpu" = the elementwise
#: multiply + a sum over the K lanes, "mxu" = the K-contraction as a
#: (rows, K) @ (K, 1) f32 matmul.  Both are exact per term; only the f32
#: association of the K-sum differs.
CF_DOT_MODES = ("vpu", "mxu")


def cf_err_dot_mode() -> str:
    """The CF error-dot flavor the drivers run: LUX_CF_ERR_DOT when set
    (validated), else "vpu".  The port has measured no winner on the card
    yet, and the reference's chip-measured overlay entry is never read."""
    env = os.environ.get("LUX_CF_ERR_DOT")
    if env:
        if env not in CF_DOT_MODES:
            raise ValueError(
                f"LUX_CF_ERR_DOT must be one of {CF_DOT_MODES}, got {env!r}")
        return env
    return "vpu"


#: cross-part merge of the push engine's sparse rounds: "bulk" scatters
#: the whole concatenated frontier into each part at once, "tree" gives
#: each source part its own partial and combines them up a static tree
#: (ops/merge_tree.py).  Bitwise equal for the min/max push programs.
MERGE_MODES = ("bulk", "tree")


def merge_mode() -> str:
    """The merge flavor the push engine runs when none is named:
    LUX_MERGE_MODE when set (validated), else "bulk".  The reference's
    chip-measured overlay entry is never read here."""
    env = os.environ.get("LUX_MERGE_MODE")
    if env:
        if env not in MERGE_MODES:
            raise ValueError(
                f"LUX_MERGE_MODE must be one of {MERGE_MODES}, got {env!r}")
        return env
    return "bulk"
