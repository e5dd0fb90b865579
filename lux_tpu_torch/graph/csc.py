"""Host-side graph container in CSC (compressed sparse column) form.

Edges are grouped by *destination* vertex: ``col_idx[row_ptr[v] :
row_ptr[v+1]]`` are the in-neighbor sources of vertex ``v``.  Plain
numpy, identical to ``lux_tpu.graph.csc``; device shards are built in
:mod:`lux_tpu_torch.graph.shards`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class HostGraph:
    """A directed graph in CSC form on the host.

    Attributes:
      nv: number of vertices (nv < 2**31 so device indices fit int32).
      ne: number of directed edges.
      row_ptr: (nv + 1,) int64, ``row_ptr[0] == 0``, monotone
        non-decreasing; in-edges of v are ``col_idx[row_ptr[v]:row_ptr[v+1]]``.
      col_idx: (ne,) int32 source vertex ids, grouped by destination.
      weights: optional (ne,) edge weights.
    """

    nv: int
    ne: int
    row_ptr: np.ndarray
    col_idx: np.ndarray
    weights: Optional[np.ndarray] = None

    def __post_init__(self):
        if not 1 <= self.nv < 2**31:
            raise ValueError(f"nv must be in [1, 2^31), got {self.nv}")
        if self.row_ptr.shape != (self.nv + 1,):
            raise ValueError(f"row_ptr shape {self.row_ptr.shape} != ({self.nv + 1},)")
        if self.col_idx.shape != (self.ne,):
            raise ValueError(f"col_idx shape {self.col_idx.shape} != ({self.ne},)")
        if self.row_ptr[0] != 0 or self.row_ptr[-1] != self.ne:
            raise ValueError("row_ptr must start at 0 and end at ne")
        if self.weights is not None and self.weights.shape != (self.ne,):
            raise ValueError(f"weights shape {self.weights.shape} != ({self.ne},)")

    @property
    def weighted(self) -> bool:
        return self.weights is not None

    def validate(self) -> None:
        """Full O(ne) validation (monotone row_ptr, src ids in range)."""
        if not np.all(np.diff(self.row_ptr) >= 0):
            raise ValueError("row_ptr not monotone")
        if self.ne and (self.col_idx.min() < 0 or self.col_idx.max() >= self.nv):
            raise ValueError("col_idx holds a vertex id out of range")

    def out_degrees(self) -> np.ndarray:
        """Out-degree per vertex, counted from the in-edge lists."""
        return np.bincount(self.col_idx, minlength=self.nv).astype(np.int32)

    def in_degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int32)

    def to_csr(self):
        """The out-edge (CSR) view: (csr_row_ptr, csr_dst, csr_perm), by a
        stable sort of the sources.  ``csr_perm`` maps each CSR slot back
        to its CSC edge index (for weights)."""
        dst_of_edge = self.dst_of_edges()
        perm = np.argsort(self.col_idx, kind="stable")
        csr_dst = dst_of_edge[perm]
        csr_row_ptr = np.zeros(self.nv + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.col_idx, minlength=self.nv), out=csr_row_ptr[1:])
        return csr_row_ptr, csr_dst, perm

    def dst_of_edges(self) -> np.ndarray:
        """(ne,) int32 destination id of each CSC edge slot."""
        return np.repeat(
            np.arange(self.nv, dtype=np.int64), np.diff(self.row_ptr)
        ).astype(np.int32)


def from_edge_list(
    src: np.ndarray,
    dst: np.ndarray,
    nv: int,
    weights: Optional[np.ndarray] = None,
) -> HostGraph:
    """Build a CSC HostGraph from a raw edge list (stable sort by dst)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    ne = src.shape[0]
    if dst.shape[0] != ne:
        raise ValueError(f"src has {ne} edges but dst has {dst.shape[0]}")
    order = np.argsort(dst, kind="stable")
    col_idx = src[order].astype(np.int32)
    row_ptr = np.zeros(nv + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=nv), out=row_ptr[1:])
    w = None if weights is None else np.asarray(weights)[order]
    return HostGraph(nv=nv, ne=ne, row_ptr=row_ptr, col_idx=col_idx, weights=w)
