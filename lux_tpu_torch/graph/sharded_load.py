"""Sharded graph loading: pull shards straight from partial `.lux` reads,
never materializing the whole edge array.

Counterpart of ``lux_tpu.graph.sharded_load`` (the reference's
pull_load_task pipeline, core/pull_model.inl:253-320: every node reads
only its partitions' byte ranges).  A pod worker (serve/fleet/pod.py)
loads only the parts its placement slice owns; the arrays are
byte-identical to those rows of ``graph.shards.build_pull_shards``.

The only whole-file pass is the out-degree scan (the reference's serial
``pull_scan_task_impl``), a chunked histogram over the memory-mapped
column array.  ``--sort-segments`` and ``--compact-gather`` are not
ported (utils/config.NOT_PORTED), so this loader refuses them too.
"""
from __future__ import annotations

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
    fill_part,
    shard_geometry,
)


def out_degrees_from_file(path: str, chunk_edges: int = 1 << 24,
                          header: Optional[HostGraph] = None) -> np.ndarray:
    """Streaming out-degree histogram over the mmap-backed column array."""
    if header is None:
        header = fmt.read_lux(path, mmap=True)
    deg = np.zeros(header.nv, np.int64)
    col = header.col_idx  # memory-mapped view, never fully materialized
    for lo in range(0, header.ne, chunk_edges):
        hi = min(lo + chunk_edges, header.ne)
        deg += np.bincount(col[lo:hi], minlength=header.nv)
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
    parts' edges enter host memory.  ``sort_segments``,
    ``compact_gather`` and ``compact_u_pad`` (the reference's gather
    relayouts) raise NotImplementedError."""
    if sort_segments or compact_gather or compact_u_pad is not None:
        raise NotImplementedError(
            "sort_segments / compact_gather are not ported to lux_tpu_torch "
            "yet (ROADMAP Queue 1 item 5)")
    header = fmt.read_lux(path, mmap=True)
    cuts, nv_pad, e_pad = shard_geometry(np.asarray(header.row_ptr), num_parts)
    parts_subset = list(range(num_parts) if parts_subset is None else parts_subset)
    if degrees is None:
        degrees = out_degrees_from_file(path, header=header)
    arrays = alloc_arrays(len(parts_subset), nv_pad, e_pad)
    for i, p in enumerate(parts_subset):
        vlo, vhi = int(cuts[p]), int(cuts[p + 1])
        rp_local, srcs, w = fmt.read_lux_range(path, vlo, vhi, header=header)
        fill_part(arrays, i, vlo, vhi, rp_local, srcs, w, cuts, nv_pad,
                  header.nv, degrees[vlo:vhi])
    spec = ShardSpec(num_parts=num_parts, nv=header.nv, ne=header.ne,
                     nv_pad=nv_pad, e_pad=e_pad, weighted=header.weighted)
    return PullShards(spec=spec, arrays=arrays, cuts=cuts)
