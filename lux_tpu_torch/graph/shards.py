"""Device-ready graph shards: static-shape padded CSC partitions.

Vertices are split into contiguous edge-balanced ranges (partition.py);
every part is padded to the same ``nv_pad`` vertices and ``e_pad`` edges
(multiples of 128) and the parts are stacked along a leading axis.  The
arrays are built in numpy exactly as ``lux_tpu.graph.shards`` builds them
(byte-identical for the same graph), then moved to a torch device with
:func:`to_device`.

Key encodings:
  * ``src_pos`` is each edge's source position in the padded concatenated
    state of shape (P * nv_pad,): for source s owned by part q,
    ``src_pos = q * nv_pad + (s - cuts[q])``.
  * CSC edges are sorted by destination, so destination segments are
    encoded once as ``row_ptr``/``head_flag``, and padding slots carry the
    sentinel ``dst_local == nv_pad``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.partition import edge_balanced_cuts

LANE = 128  # pad 1-D extents to multiples of this (layout parity)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Static shard geometry."""

    num_parts: int
    nv: int
    ne: int
    nv_pad: int  # per-part padded vertex count
    e_pad: int  # per-part padded edge count
    weighted: bool

    @property
    def gathered_size(self) -> int:
        """Length of the padded concatenated state vector."""
        return self.num_parts * self.nv_pad


class ShardArrays(NamedTuple):
    """Stacked per-part arrays (leading axis = part), numpy or torch.

    Shapes (P = num_parts, V = nv_pad, E = e_pad):
      row_ptr:   (P, V+1) int32  local CSC offsets; padded vertices empty.
      src_pos:   (P, E)   int32  source position in the (P*V,) state.
      dst_local: (P, E)   int32  local destination in [0, V); padding = V.
      head_flag: (P, E)   bool   True at the first edge of each segment.
      edge_mask: (P, E)   bool   True for real edges.
      vtx_mask:  (P, V)   bool   True for real vertices.
      degree:    (P, V)   int32  out-degree of each local vertex.
      global_vid:(P, V)   int32  global vertex id (nv-1 on padding slots).
      weights:   (P, E)   float32 edge weights (zeros when unweighted).
      mirror_pos:(P, 0)   int32  compact-gather mirror (not built here;
      mirror_rel:(P, 0)   int32  kept zero-width for layout parity).
    """

    row_ptr: np.ndarray
    src_pos: np.ndarray
    dst_local: np.ndarray
    head_flag: np.ndarray
    edge_mask: np.ndarray
    vtx_mask: np.ndarray
    degree: np.ndarray
    global_vid: np.ndarray
    weights: np.ndarray
    mirror_pos: np.ndarray
    mirror_rel: np.ndarray

    def part(self, p: int) -> "ShardArrays":
        """The arrays of part ``p`` (leading axis dropped)."""
        return ShardArrays(*(a[p] for a in self))


@dataclasses.dataclass
class PullShards:
    """Host bundle: spec + arrays + partition bookkeeping."""

    spec: ShardSpec
    arrays: ShardArrays
    cuts: np.ndarray  # (P+1,) vertex cut points

    def scatter_to_global(self, stacked: np.ndarray) -> np.ndarray:
        """Collapse a (P, nv_pad, ...) stacked state to (nv, ...) order."""
        return stacked_to_global(self.cuts, stacked)

    def global_to_stacked(self, full: np.ndarray) -> np.ndarray:
        """Split a (nv, ...) global state into (P, nv_pad, ...) stacks."""
        return global_to_stacked(self.cuts, self.spec.nv_pad, full)


def global_to_stacked(cuts: np.ndarray, nv_pad: int, full: np.ndarray) -> np.ndarray:
    """Split a (nv, ...) global state into (P, nv_pad, ...) zero-padded
    stacks under ``cuts``, the inverse of :func:`stacked_to_global` (an
    elastic checkpoint restacks onto any layout through it)."""
    P = cuts.shape[0] - 1
    out = np.zeros((P, nv_pad) + full.shape[1:], dtype=full.dtype)
    for p in range(P):
        lo, hi = int(cuts[p]), int(cuts[p + 1])
        out[p, : hi - lo] = full[lo:hi]
    return out


def stacked_to_global(cuts: np.ndarray, stacked: np.ndarray) -> np.ndarray:
    """De-pad a (P, nv_pad, ...) stacked state into (nv, ...) global order."""
    out = []
    for p in range(cuts.shape[0] - 1):
        n = int(cuts[p + 1] - cuts[p])
        out.append(np.asarray(stacked[p])[:n])
    return np.concatenate(out, axis=0)


def shard_geometry(row_ptr_global: np.ndarray, num_parts: int,
                   cuts: Optional[np.ndarray] = None):
    """(cuts, nv_pad, e_pad) for padded shards, with the int32-range
    guards.  ``cuts`` overrides the static edge-balanced sweep with
    caller-chosen contiguous bounds (the adaptive repartitioning feeds
    partition.weighted_cuts here)."""
    if cuts is None:
        cuts = edge_balanced_cuts(row_ptr_global, num_parts)
    nv_counts = np.diff(cuts)
    e_counts = row_ptr_global[cuts[1:]] - row_ptr_global[cuts[:-1]]
    nv_pad = max(LANE, _round_up(int(nv_counts.max()), LANE))
    e_pad = max(LANE, _round_up(int(e_counts.max()) or 1, LANE))
    if int(e_counts.max()) >= 2**31:
        raise ValueError(
            f"a part holds {int(e_counts.max())} edges >= 2^31; "
            f"increase num_parts (currently {num_parts})"
        )
    if num_parts * nv_pad >= 2**31:
        raise ValueError("num_parts * nv_pad exceeds int32 gather range")
    return cuts, nv_pad, e_pad


def alloc_arrays(num_rows: int, nv_pad: int, e_pad: int) -> ShardArrays:
    """Zeroed stacked arrays for ``num_rows`` parts."""
    return ShardArrays(
        row_ptr=np.zeros((num_rows, nv_pad + 1), np.int32),
        src_pos=np.zeros((num_rows, e_pad), np.int32),
        dst_local=np.full((num_rows, e_pad), nv_pad, np.int32),
        head_flag=np.zeros((num_rows, e_pad), bool),
        edge_mask=np.zeros((num_rows, e_pad), bool),
        vtx_mask=np.zeros((num_rows, nv_pad), bool),
        degree=np.zeros((num_rows, nv_pad), np.int32),
        global_vid=np.zeros((num_rows, nv_pad), np.int32),
        weights=np.zeros((num_rows, e_pad), np.float32),
        mirror_pos=np.zeros((num_rows, 0), np.int32),
        mirror_rel=np.zeros((num_rows, 0), np.int32),
    )


def fill_part(
    arrays: ShardArrays,
    i: int,
    vlo: int,
    vhi: int,
    rp_local: np.ndarray,
    srcs: np.ndarray,
    w: Optional[np.ndarray],
    cuts: np.ndarray,
    nv_pad: int,
    nv: int,
    degrees_slice: np.ndarray,
) -> None:
    """Fill stacked row ``i`` with one part's data.

    rp_local: (n+1,) local offsets with leading 0; srcs: (m,) global source
    ids; degrees_slice: (n,) out-degrees of [vlo, vhi).
    """
    n, m = vhi - vlo, len(srcs)
    rp = np.asarray(rp_local, np.int32)
    arrays.row_ptr[i, : n + 1] = rp
    arrays.row_ptr[i, n + 1 :] = m  # padded vertices: empty tail ranges
    srcs64 = np.asarray(srcs, np.int64)
    own = (np.searchsorted(cuts, srcs64, side="right") - 1).astype(np.int64)
    arrays.src_pos[i, :m] = (own * nv_pad + (srcs64 - cuts[own])).astype(np.int32)
    arrays.dst_local[i, :m] = np.repeat(
        np.arange(n, dtype=np.int32), np.diff(rp[: n + 1])
    )
    starts = rp[:n][rp[:n] < rp[1 : n + 1]]
    arrays.head_flag[i, starts] = True
    arrays.edge_mask[i, :m] = True
    arrays.vtx_mask[i, :n] = True
    arrays.degree[i, :n] = degrees_slice
    arrays.global_vid[i, :n] = np.arange(vlo, vhi, dtype=np.int32)
    arrays.global_vid[i, n:] = nv - 1
    if w is not None:
        arrays.weights[i, :m] = np.asarray(w, np.float32)


def build_pull_shards(
    g: HostGraph,
    num_parts: int,
    degrees: Optional[np.ndarray] = None,
    cuts: Optional[np.ndarray] = None,
) -> PullShards:
    """Partition + pad a HostGraph into pull-model shards (numpy arrays;
    :func:`to_device` moves them).  ``cuts``: (P+1,) contiguous vertex
    bounds instead of the edge-balanced ones."""
    cuts, nv_pad, e_pad = shard_geometry(g.row_ptr, num_parts, cuts)
    if degrees is None:
        degrees = g.out_degrees()
    arrays = alloc_arrays(num_parts, nv_pad, e_pad)
    for p in range(num_parts):
        vlo, vhi = int(cuts[p]), int(cuts[p + 1])
        elo, ehi = int(g.row_ptr[vlo]), int(g.row_ptr[vhi])
        fill_part(
            arrays, p, vlo, vhi,
            g.row_ptr[vlo : vhi + 1] - elo,
            g.col_idx[elo:ehi],
            None if g.weights is None else g.weights[elo:ehi],
            cuts, nv_pad, g.nv, degrees[vlo:vhi],
        )
    spec = ShardSpec(
        num_parts=num_parts,
        nv=g.nv,
        ne=g.ne,
        nv_pad=nv_pad,
        e_pad=e_pad,
        weighted=g.weights is not None,
    )
    return PullShards(spec=spec, arrays=arrays, cuts=cuts)


def to_device(arrays: ShardArrays, device) -> ShardArrays:
    """numpy ShardArrays -> torch tensors on ``device``; dtypes are kept
    (int32 stays int32, bool stays bool, float32 stays float32)."""
    return ShardArrays(*(
        torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays
    ))
