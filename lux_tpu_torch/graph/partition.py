"""Contiguous vertex partitioning.

Vertices are split into ``num_parts`` contiguous ranges.  The static
policy balances in-edges: each range holds at most ``edge_cap =
ceil(ne / num_parts)`` of them (a range may exceed the cap only when a
single vertex's in-degree does).  :func:`weighted_cuts` balances any
per-vertex work weight instead (the adaptive repartitioning's recut).
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


def part_of_vertex(cuts: np.ndarray, vids: np.ndarray) -> np.ndarray:
    """Map vertex ids to their owning part index under ``cuts``."""
    return (np.searchsorted(cuts, vids, side="right") - 1).astype(np.int32)


def weighted_cuts(weights: np.ndarray, num_parts: int) -> np.ndarray:
    """Contiguous cuts balancing an arbitrary per-vertex work weight.

    Generalizes :func:`edge_balanced_cuts` (whose weight is the
    in-degree) to runtime-measured weights, with cuts of the same
    contiguous-range form, so the shard layouts are built the same way.
    ``weights`` is (nv,) non-negative; returns (P+1,) int64 cuts,
    cuts[0] == 0, cuts[P] == nv, monotone."""
    nv = weights.shape[0]
    cum = np.zeros(nv + 1, dtype=np.float64)
    np.cumsum(weights, out=cum[1:])
    total = cum[-1]
    if total <= 0:
        return edge_balanced_cuts(np.arange(nv + 1, dtype=np.int64), num_parts)
    cap = total / num_parts
    cuts = np.empty(num_parts + 1, dtype=np.int64)
    cuts[0] = 0
    for p in range(1, num_parts):
        target = min(total, p * cap)
        v = int(np.searchsorted(cum, target, side="left"))
        cuts[p] = max(v, cuts[p - 1])
    cuts[num_parts] = nv
    return np.minimum(cuts, nv)
