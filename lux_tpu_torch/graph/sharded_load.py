"""Sharded graph loading: pull shards straight from partial `.lux` reads,
never materializing the whole edge array.

Counterpart of ``lux_tpu.graph.sharded_load`` (the reference's
pull_load_task pipeline, core/pull_model.inl:253-320: every node reads
only its partitions' byte ranges).  A pod worker (serve/fleet/pod.py)
loads only the parts its placement slice owns; the arrays are
byte-identical to those rows of ``graph.shards.build_pull_shards``.

The only whole-file pass is the out-degree scan (the reference's serial
``pull_scan_task_impl``), a chunked histogram over the memory-mapped
column array.  The per-part reads are preads through the native host
library when it builds (graph/format.read_lux_range), and the gather
relayouts (``sort_segments``, ``compact_gather``) apply to the loaded
rows as in graph/shards.build_pull_shards.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from lux_tpu_torch.graph import format as fmt
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.shards import (
    LANE,
    PullShards,
    ShardSpec,
    _round_up,
    alloc_arrays,
    build_compact_mirror,
    each_part,
    fill_part,
    shard_geometry,
    sort_segments_inplace,
)
from lux_tpu_torch.native import io as native_io


def out_degrees_from_file(path: str, chunk_edges: int = 1 << 24,
                          header: Optional[HostGraph] = None) -> np.ndarray:
    """Streaming out-degree histogram over the mmap-backed column array
    (each chunk counted by the native library when it builds)."""
    if header is None:
        header = fmt.read_lux(path, mmap=True)
    deg = np.zeros(header.nv, np.int64)
    col = header.col_idx  # memory-mapped view, never fully materialized
    for lo in range(0, header.ne, chunk_edges):
        hi = min(lo + chunk_edges, header.ne)
        part = native_io.count_degrees(col[lo:hi], header.nv)
        deg += part if part is not None else np.bincount(col[lo:hi], minlength=header.nv)
    return deg.astype(np.int32)


def compact_width_from_file(path: str, num_parts: int,
                            header: Optional[HostGraph] = None) -> int:
    """GLOBAL compact-mirror width U_pad of a file-loaded graph: the max
    unique in-source count over ALL parts, LANE-padded, from one pass of
    per-part range reads (deterministic, so every host computes the
    same width)."""
    if header is None:
        header = fmt.read_lux(path, mmap=True)
    cuts, _, _ = shard_geometry(np.asarray(header.row_ptr), num_parts)
    u_max = 1
    for p in range(num_parts):
        _, srcs, _ = fmt.read_lux_range(path, int(cuts[p]), int(cuts[p + 1]),
                                        header=header)
        u_max = max(u_max, int(np.unique(srcs).size) if len(srcs) else 1)
    return max(LANE, _round_up(u_max, LANE))


def load_pull_shards(path: str, num_parts: int,
                     parts_subset: Optional[Sequence[int]] = None,
                     degrees: Optional[np.ndarray] = None,
                     sort_segments: bool = False,
                     compact_gather: bool = False,
                     compact_u_pad: Optional[int] = None) -> PullShards:
    """Pull shards of a `.lux` file from per-part partial reads.

    ``parts_subset``: the part indices to materialize (default: all); the
    stacked arrays have leading dimension len(parts_subset), in subset
    order.  The padded geometry (nv_pad, e_pad) is computed GLOBALLY, so
    every subset gives identically shaped blocks, and only the selected
    parts' edges enter host memory.

    ``sort_segments`` / ``compact_gather``: the gather relayouts of
    build_pull_shards, applied to the loaded rows.  A SUBSET load with
    ``compact_gather`` needs the mirror width of the whole file for
    shapes that agree across loads: pass ``compact_u_pad``
    (:func:`compact_width_from_file`), or leave it None to pay one more
    pass here.  The load is a ``graph.load`` recorder span that names the
    host path."""
    from lux_tpu_torch import obs

    host_io = native_io.host_path()
    header = fmt.read_lux(path, mmap=True)
    cuts, nv_pad, e_pad = shard_geometry(np.asarray(header.row_ptr), num_parts)
    parts_subset = list(range(num_parts) if parts_subset is None else parts_subset)
    with obs.span("graph.load", file=os.path.basename(path), parts=num_parts,
                  loaded=len(parts_subset), host_io=host_io,
                  sort_segments=sort_segments, compact_gather=compact_gather):
        if degrees is None:
            degrees = out_degrees_from_file(path, header=header)
        arrays = alloc_arrays(len(parts_subset), nv_pad, e_pad)

        def load(item):  # each part reads its range and fills its own rows
            i, p = item
            vlo, vhi = int(cuts[p]), int(cuts[p + 1])
            rp_local, srcs, w = fmt.read_lux_range(path, vlo, vhi, header=header)
            fill_part(arrays, i, vlo, vhi, rp_local, srcs, w, cuts, nv_pad,
                      header.nv, degrees[vlo:vhi])

        each_part(enumerate(parts_subset), load)
        if sort_segments:
            sort_segments_inplace(arrays)
        if compact_gather:
            if compact_u_pad is None and len(parts_subset) < num_parts:
                compact_u_pad = compact_width_from_file(path, num_parts, header=header)
            arrays = build_compact_mirror(arrays, u_pad=compact_u_pad)
    spec = ShardSpec(num_parts=num_parts, nv=header.nv, ne=header.ne,
                     nv_pad=nv_pad, e_pad=e_pad, weighted=header.weighted)
    return PullShards(spec=spec, arrays=arrays, cuts=cuts, host_io=host_io)
