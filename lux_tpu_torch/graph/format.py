"""Reader/writer for the `.lux` binary graph format.

On-disk layout, little-endian:

    uint32  nv
    uint64  ne
    uint64  row_ptr[nv]      # CSC offsets; row_ptr[i] is the END of vertex
                             # i's in-edge block (no leading zero on disk)
    uint32  col_idx[ne]      # in-edge sources grouped by destination
    int32   weights[ne]      # only for weighted graphs

Files from the original converter may carry a trailing int32 degree array
(nv entries) that is never read; ``read_lux`` recognizes it by file size.

``read_lux`` memory-maps the file.  The partial per-part read
(``read_lux_range``), the edge-list writer (``write_lux_edges``) and the
text parser (``read_edge_list_text``) go through the native host I/O
library (lux_tpu_torch.native.io: pread, a counting sort, a line parser)
when it builds, else through numpy; both give the same arrays.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np

from lux_tpu_torch.graph.csc import HostGraph, from_edge_list
from lux_tpu_torch.native import io as native_io

LUX_HEADER_BYTES = 12  # sizeof(uint32) + sizeof(uint64)


def read_lux(path: str, weighted: Optional[bool] = None, mmap: bool = True) -> HostGraph:
    """Read a `.lux` file into a HostGraph.

    ``weighted=None`` infers the layout from the exact file size: base
    (unweighted), base + 4*nv (unweighted with the trailing degree array),
    base + 4*ne (weighted), base + 4*ne + 4*nv (weighted + degrees).
    Ambiguous sizes (nv == ne) resolve to unweighted with a warning;
    unrecognized sizes raise.  ``mmap`` memory-maps the arrays read-only.
    The read is a ``graph.load`` recorder span.
    """
    from lux_tpu_torch import obs

    with obs.span("graph.load", file=os.path.basename(path), mmap=mmap) as sp:
        g = _read_lux_impl(path, weighted, mmap)
        sp.set(nv=g.nv, ne=g.ne, weighted=g.weights is not None)
        return g


def _read_lux_impl(path: str, weighted: Optional[bool], mmap: bool) -> HostGraph:
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        header = f.read(LUX_HEADER_BYTES)
    nv = int(np.frombuffer(header, dtype="<u4", count=1)[0])
    ne = int(np.frombuffer(header[4:], dtype="<u8", count=1)[0])

    rows_off = LUX_HEADER_BYTES
    cols_off = rows_off + 8 * nv
    w_off = cols_off + 4 * ne
    base_size = w_off
    if weighted is None:
        if ne == nv and ne > 0 and size == base_size + 4 * ne:
            warnings.warn(
                f"{path}: nv == ne makes the weighted and unweighted+degrees "
                "layouts the same size; assuming unweighted — pass weighted= "
                "explicitly to silence or override",
                stacklevel=2,
            )
        if ne == 0 or size in (base_size, base_size + 4 * nv):
            weighted = False
        elif size in (base_size + 4 * ne, base_size + 4 * ne + 4 * nv):
            weighted = True
        else:
            raise ValueError(
                f"{path}: cannot infer weights from size {size} "
                f"(nv={nv}, ne={ne}); pass weighted= explicitly"
            )

    def _arr(dtype, count, offset):
        if mmap:
            return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=(count,))
        with open(path, "rb") as f:
            f.seek(offset)
            return np.fromfile(f, dtype=dtype, count=count)

    raw_rows = _arr("<u8", nv, rows_off)
    col_idx = _arr("<u4", ne, cols_off)
    row_ptr = np.zeros(nv + 1, dtype=np.int64)
    row_ptr[1:] = raw_rows
    weights = _arr("<i4", ne, w_off) if weighted else None
    return HostGraph(
        nv=nv,
        ne=ne,
        row_ptr=row_ptr,
        # zero-copy reinterpret (u4 -> i4, same itemsize)
        col_idx=np.asarray(col_idx).view(np.int32),
        weights=None if weights is None else np.asarray(weights),
    )


def write_lux(path: str, g: HostGraph) -> None:
    """Write a HostGraph as a `.lux` file (no trailing degree array)."""
    with open(path, "wb") as f:
        f.write(np.uint32(g.nv).tobytes())
        f.write(np.uint64(g.ne).tobytes())
        f.write(g.row_ptr[1:].astype("<u8").tobytes())
        f.write(g.col_idx.astype("<u4").tobytes())
        if g.weights is not None:
            f.write(g.weights.astype("<i4").tobytes())


def write_lux_edges(path: str, nv: int, src: np.ndarray, dst: np.ndarray,
                    weights: Optional[np.ndarray] = None) -> str:
    """Write an edge list as a `.lux` file: CSC by a stable sort on the
    destination (input order within a destination).  Returns the path
    that ran, "native" (the counting sort) or "numpy"."""
    if native_io.write_from_edges(path, nv, src, dst, weights):
        return "native"
    if len(src) and (int(np.max(src)) >= nv or int(np.max(dst)) >= nv
                     or int(np.min(src)) < 0 or int(np.min(dst)) < 0):
        raise ValueError(f"an edge endpoint lies outside [0, {nv})")
    write_lux(path, from_edge_list(src, dst, nv,
                                   None if weights is None else np.asarray(weights, np.int32)))
    return "numpy"


def read_lux_range(path: str, row_lo: int, row_hi: int,
                   weighted: Optional[bool] = None,
                   header: Optional[HostGraph] = None):
    """Read one partition's slice of a `.lux` file, vertices [row_lo,
    row_hi): the per-part partial load (counterpart of
    ``lux_tpu.graph.format.read_lux_range``), by pread through the
    native library when it builds, else from the memory map.

    Returns (row_ptr_local (n+1,) int64 rebased to 0, col_idx (m,) int32,
    weights (m,) int32 | None).  Pass ``header`` (a prior mmap read_lux
    result) to avoid re-reading the header and offsets per call."""
    g = header if header is not None else read_lux(path, weighted=weighted, mmap=True)
    if not 0 <= row_lo <= row_hi <= g.nv:
        raise ValueError(f"row range [{row_lo}, {row_hi}) outside [0, {g.nv}]")
    col_lo, col_hi = int(g.row_ptr[row_lo]), int(g.row_ptr[row_hi])
    if weighted is None:
        weighted = g.weights is not None
    rng = native_io.read_range(path, g.nv, g.ne, row_lo, row_hi, col_lo, col_hi,
                               weighted)
    if rng is not None:
        rows_end, cols, w = rng
        row_ptr = np.empty(row_hi - row_lo + 1, np.int64)
        row_ptr[0] = 0
        row_ptr[1:] = rows_end.astype(np.int64) - col_lo
        return row_ptr, cols.view(np.int32), w
    row_ptr = (g.row_ptr[row_lo: row_hi + 1] - col_lo).astype(np.int64)
    cols = np.asarray(g.col_idx[col_lo:col_hi])
    w = (np.asarray(g.weights[col_lo:col_hi])
         if weighted and g.weights is not None else None)
    return row_ptr, cols, w


def read_edge_list_text(path: str, weighted: bool = False):
    """Parse a whitespace text edge list ("src dst [weight]" a line; blank
    lines and '#' comments skipped): the converter's input.  Returns
    (src, dst, weights | None); the native line parser when it builds
    (uint32 ids), else ``np.loadtxt`` (int64 ids)."""
    parsed = native_io.parse_edge_text(path, weighted)
    if parsed is not None:
        return parsed
    data = np.loadtxt(path, dtype=np.int64, ndmin=2)
    w = data[:, 2].astype(np.int32) if weighted else None
    return data[:, 0], data[:, 1], w
