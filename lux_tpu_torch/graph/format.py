"""Reader/writer for the `.lux` binary graph format (numpy path).

On-disk layout, little-endian:

    uint32  nv
    uint64  ne
    uint64  row_ptr[nv]      # CSC offsets; row_ptr[i] is the END of vertex
                             # i's in-edge block (no leading zero on disk)
    uint32  col_idx[ne]      # in-edge sources grouped by destination
    int32   weights[ne]      # only for weighted graphs

Files from the original converter may carry a trailing int32 degree array
(nv entries) that is never read; ``read_lux`` recognizes it by file size.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np

from lux_tpu_torch.graph.csc import HostGraph

LUX_HEADER_BYTES = 12  # sizeof(uint32) + sizeof(uint64)


def read_lux(path: str, weighted: Optional[bool] = None, mmap: bool = True) -> HostGraph:
    """Read a `.lux` file into a HostGraph.

    ``weighted=None`` infers the layout from the exact file size: base
    (unweighted), base + 4*nv (unweighted with the trailing degree array),
    base + 4*ne (weighted), base + 4*ne + 4*nv (weighted + degrees).
    Ambiguous sizes (nv == ne) resolve to unweighted with a warning;
    unrecognized sizes raise.  ``mmap`` memory-maps the arrays read-only.
    """
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
