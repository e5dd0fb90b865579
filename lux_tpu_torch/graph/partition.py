"""Edge-balanced contiguous vertex partitioning.

Vertices are split into ``num_parts`` contiguous ranges so each range
holds at most ``edge_cap = ceil(ne / num_parts)`` in-edges (a range may
exceed the cap only when a single vertex's in-degree does).
"""
from __future__ import annotations

import numpy as np


def edge_balanced_cuts(row_ptr: np.ndarray, num_parts: int) -> np.ndarray:
    """(P+1,) int64 cut points; part p owns vertices [cuts[p], cuts[p+1]).

    ``row_ptr`` is the (nv+1,) CSC offset array with its leading 0.
    cuts[0] == 0, cuts[P] == nv, monotone non-decreasing.
    """
    nv = row_ptr.shape[0] - 1
    ne = int(row_ptr[-1])
    edge_cap = -(-ne // num_parts) if ne else 0  # ceil div
    cuts = np.empty(num_parts + 1, dtype=np.int64)
    cuts[0] = 0
    if ne == 0:
        # degenerate: spread vertices evenly
        step = -(-nv // num_parts)
        for p in range(1, num_parts):
            cuts[p] = min(nv, p * step)
        cuts[num_parts] = nv
        return cuts
    # greedy sweep: searchsorted finds the first vertex boundary at or
    # past each part's cumulative edge target
    for p in range(1, num_parts):
        target = min(ne, p * edge_cap)
        v = int(np.searchsorted(row_ptr, target, side="left"))
        cuts[p] = max(v, cuts[p - 1])
    cuts[num_parts] = nv
    return np.minimum(cuts, nv)
