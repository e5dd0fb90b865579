"""Segment-reduction method resolution.

Counterpart of ``lux_tpu.engine.methods``.  ``method="auto"`` resolves
once at driver entry from the platform and a table of MEASURED winners.
The port has measured none yet: ``WINNERS`` gains a ("cuda", reduce) row
only from an H100 measurement, so until then every platform resolves to
``FALLBACK`` — the portable choice, as the reference does for a platform
it has no row for.  The reference's TPU rows and its winners overlay
file are never read here.

Environment knobs:
  LUX_SUM_MODE         scan | mxsum | mxscan — under ``auto``, forces the
                       float-sum strategy on every platform.
  LUX_METHOD_PLATFORM  overrides the platform name used for resolution.
"""
from __future__ import annotations

import os

#: concrete strategies a resolution may produce ("pallas" needs the
#: block-CSR layout and is chosen by the app, never by resolution)
CONCRETE = ("scan", "cumsum", "mxsum", "mxscan", "scatter")

#: (platform, reduce) -> measured winner; empty until a chip measurement
#: of the port lands here
WINNERS: dict[tuple[str, str], str] = {}

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
    """``resolve`` plus the scan-family refinement: under ``auto``, a float
    sum that resolves to "scan" follows LUX_SUM_MODE.  Explicit methods
    and min/max pass through."""
    resolved = resolve(method, reduce, platform)
    if method == "auto" and reduce == "sum" and resolved == "scan":
        return sum_mode()
    return resolved
