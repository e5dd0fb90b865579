"""2-D (parts x edge) parallelism: each part's edges split over the ranks
of its part row.

Counterpart of ``lux_tpu.parallel.edge2d``.  A part is bound to one rank
in the 1-D engines, so a part whose edge slice does not fit one device
cannot run; here the ranks form a (parts x edge) grid (parallel/mesh
.Grid2D, rank r = p*EP + e), each part's CSC edge slice is cut into EP
contiguous chunks, and rank (p, e) holds chunk e of part p.  Every edge
shard computes a PARTIAL per-destination reduction for the part's whole
destination range (a chunk may start or stop mid-destination: partial
sums, mins and maxes are what the edge axis combines), and ``apply``
runs on every edge shard's replica of the combined accumulator.

One iteration: the parts-axis all-gather of the state (within the rank's
column of the grid), the chunk's ``segment_reduce_by_ends``, the sum,
min or max over the edge axis (mesh.axis_all_reduce), then apply.  The
chunks carry no row_ptr, so the reductions run ``--method scan`` or
``scatter`` only; the mxscan kernel stays on the CSC engines, as in the
reference.  ``route=`` (ops/expand.plan_edge2d_route_shards: one expand
plan a cell, over the (P*V,) parts-gathered state) replays the chunk's
gather as routed lane shuffles, bitwise the direct gather.

Layout (P parts, EP edge shards, E2 = the padded chunk capacity), the
reference's byte for byte:
  src_pos:   (P, EP, E2) int32  positions in the (P*V,) gathered state
  dst_local: (P, EP, E2) int32  part-local destination; padding holds V
  head_flag: (P, EP, E2) bool   per-chunk destination-segment starts
  weights:   (P, EP, E2) float32
plus the per-part vertex arrays, shared by the part's edge shards.  A
rank builds its own (part, chunk) only (``parts_subset``/
``chunks_subset``), and never the 1-D layout's O(E) arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from lux_tpu_torch.engine import methods
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.shards import (ShardSpec, edge2d_chunk_pad, shard_geometry,
                                        stacked_to_global)
from lux_tpu_torch.native import io as native_io
from lux_tpu_torch.ops import segment
from lux_tpu_torch.parallel.mesh import Grid2D, axis_all_reduce
from lux_tpu_torch.parallel.placement import halo_all_gather
from lux_tpu_torch.parallel.ring import _RingView, gather_bucket, mark_bucket_heads

#: the reference's refusal of a method the chunks cannot reduce
EDGE2D_METHODS_NOTE = (
    "edge-sharded chunks carry no row_ptr: method='scan' or 'scatter' only "
    "(--method; an auto mxscan winner downgrades to scan on this layout)")


class Edge2DArrays(NamedTuple):
    src_pos: np.ndarray  # (R, C, E2) int32
    dst_local: np.ndarray  # (R, C, E2) int32
    head_flag: np.ndarray  # (R, C, E2) bool
    weights: np.ndarray  # (R, C, E2) float32
    #: per-part vertex arrays, shared by every edge shard of the part
    vtx_mask: np.ndarray  # (R, V) bool
    degree: np.ndarray  # (R, V) int32
    global_vid: np.ndarray  # (R, V) int32


@dataclasses.dataclass
class Edge2DShards:
    spec: ShardSpec
    cuts: np.ndarray
    arrays2d: Edge2DArrays
    num_edge_shards: int
    e2_pad: int
    #: the parts and chunks whose rows arrays2d holds, in order
    parts_subset: list = dataclasses.field(default_factory=list)
    chunks_subset: list = dataclasses.field(default_factory=list)
    #: the host path the chunks were read by: "native" or "numpy"
    host_io: str = "numpy"

    @property
    def arrays(self):
        """The vertex-array view engine/pull.init_state reads (global_vid,
        degree, vtx_mask).  The 1-D layout's O(E) edge arrays are not
        kept: edge sharding is for parts whose edges do not fit one
        device, so the host keeps no second copy of them."""
        return self.arrays2d

    def scatter_to_global(self, stacked):
        return stacked_to_global(self.cuts, stacked)


def _chunk_edges(g: HostGraph, path: Optional[str], lo: int, hi: int):
    """Sources (int32) and weights (or None) of edges [lo, hi): a pread of
    ``path`` through the native library when it builds, else the graph's
    (memory-mapped) arrays; only that range is read."""
    if path is not None and hi > lo:
        rng = native_io.read_range(path, g.nv, g.ne, 0, 0, lo, hi, g.weights is not None)
        if rng is not None:
            return rng[1].view(np.int32), rng[2]
    w = None if g.weights is None else np.asarray(g.weights[lo:hi])
    return np.asarray(g.col_idx[lo:hi]), w


def _chunk_dst_local(rp: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Part-local destinations of the part's edges [lo, hi) (offsets in
    the part), from its row_ptr slice ``rp`` (rebased to 0) alone."""
    counts = np.clip(rp[1:], lo, hi) - np.clip(rp[:-1], lo, hi)
    return np.repeat(np.arange(len(rp) - 1, dtype=np.int32), counts.astype(np.int64))


def build_edge2d_shards(g: HostGraph, num_parts: int, num_edge_shards: int,
                        parts_subset: Optional[Sequence[int]] = None,
                        chunks_subset: Optional[Sequence[int]] = None,
                        path: Optional[str] = None,
                        degrees: Optional[np.ndarray] = None) -> Edge2DShards:
    """Split each part's CSC edge slice into ``num_edge_shards``
    contiguous chunks (a boundary may fall mid-destination: the partial
    reductions are combined over the edge axis).  ``parts_subset`` and
    ``chunks_subset`` build only those rows (a rank: its own part and
    chunk); the chunk capacity E2 is the global one, from the parts' edge
    counts.  ``path``: the ``.lux`` file ``g`` was read from (memory
    mapped), whose chunks are then read by pread; ``degrees``: the
    out-degrees, when known.  Never builds the 1-D layout's O(E) arrays."""
    row_ptr = np.asarray(g.row_ptr)
    cuts, nv_pad, e_pad = shard_geometry(row_ptr, num_parts)
    spec = ShardSpec(num_parts=num_parts, nv=g.nv, ne=g.ne, nv_pad=nv_pad, e_pad=e_pad,
                     weighted=g.weights is not None)
    EP, V = num_edge_shards, nv_pad
    if EP < 1:
        raise ValueError(f"num_edge_shards must be >= 1, got {EP}")
    parts = list(range(num_parts) if parts_subset is None else parts_subset)
    chunks = list(range(EP) if chunks_subset is None else chunks_subset)
    e_counts = row_ptr[cuts[1:]] - row_ptr[cuts[:-1]]
    E2 = edge2d_chunk_pad(int(e_counts.max()) if len(e_counts) else 1, EP)
    if degrees is None:
        if path is not None:
            from lux_tpu_torch.graph.sharded_load import out_degrees_from_file

            degrees = out_degrees_from_file(path, header=g)
        else:
            degrees = g.out_degrees()
    R, C = len(parts), len(chunks)
    src_pos = np.zeros((R, C, E2), np.int32)
    dst_local = np.full((R, C, E2), V, np.int32)
    head_flag = np.zeros((R, C, E2), bool)
    weights = np.zeros((R, C, E2), np.float32)
    vtx_mask = np.zeros((R, V), bool)
    degree = np.zeros((R, V), np.int32)
    global_vid = np.full((R, V), g.nv - 1, np.int32)
    for i, p in enumerate(parts):
        vlo, vhi = int(cuts[p]), int(cuts[p + 1])
        n = vhi - vlo
        vtx_mask[i, :n] = True
        degree[i, :n] = degrees[vlo:vhi]
        global_vid[i, :n] = np.arange(vlo, vhi, dtype=np.int32)
        elo, ehi = int(row_ptr[vlo]), int(row_ptr[vhi])
        m_part = ehi - elo
        rp = (row_ptr[vlo: vhi + 1] - elo).astype(np.int64)
        step = -(-m_part // EP) if m_part else 0
        for j, e in enumerate(chunks):
            lo = min(e * step, m_part)
            hi = min(lo + step, m_part)
            m = hi - lo
            srcs, w = _chunk_edges(g, path, elo + lo, elo + hi)
            if native_io.fill_src_pos(srcs, cuts, V, src_pos[i, j, :m]) is None:
                s64 = np.asarray(srcs, np.int64)
                own = np.searchsorted(cuts, s64, side="right") - 1
                src_pos[i, j, :m] = (own * V + (s64 - cuts[own])).astype(np.int32)
            dl = _chunk_dst_local(rp, lo, hi)
            dst_local[i, j, :m] = dl
            mark_bucket_heads(head_flag[i, j], dl)
            if w is not None:
                weights[i, j, :m] = np.asarray(w).astype(np.float32)
    return Edge2DShards(
        spec=spec, cuts=cuts,
        arrays2d=Edge2DArrays(src_pos, dst_local, head_flag, weights, vtx_mask, degree,
                              global_vid),
        num_edge_shards=EP, e2_pad=E2, parts_subset=parts, chunks_subset=chunks,
        host_io=native_io.host_path())


def place_cells(shards: Edge2DShards, device) -> Edge2DShards:
    """``shards`` with its arrays as tensors on ``device``, placed once
    (the drivers take them as they are)."""
    return dataclasses.replace(shards, arrays2d=Edge2DArrays(*(
        torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in shards.arrays2d)))


def resolve_method(method: str, reduce: str, device) -> str:
    """The reduction the chunks run: scan or scatter as given; ``auto``
    resolves per engine/methods on ``device`` and a winner the chunks
    cannot run (mxscan on the card) falls back to scan; any other
    explicit method is refused."""
    if method == "auto":
        m = methods.resolve(method, reduce, methods.default_platform(device))
        return m if m in ("scan", "scatter") else methods.FALLBACK
    if method not in ("scan", "scatter"):
        raise ValueError(EDGE2D_METHODS_NOTE)
    return method


class _Cell(NamedTuple):
    """This rank's chunk and its part's vertex view, on its device."""

    src_pos: torch.Tensor
    dst_local: torch.Tensor
    dst_clip: torch.Tensor
    head_flag: torch.Tensor
    weights: torch.Tensor
    view: _RingView
    #: the cell's routed plan (static, arrays on the device), or None
    plan: object = None


def _place(shards: Edge2DShards, state0, grid: Grid2D, route=None):
    """This rank's cell (with its plan of a stacked (R, C, ...) ``route``
    over the same cells) and its (1, V, ...) state block on its device."""
    pg = grid.parts
    spec = shards.spec
    if grid.axis != "edge" or grid.size != shards.num_edge_shards:
        raise ValueError(f"the shards have {shards.num_edge_shards} edge shards, the grid "
                         f"{grid.size} {grid.axis} shards")
    if spec.num_parts != pg.num_parts or pg.k != 1:
        raise ValueError(
            f"the edge-sharded layout keeps one part a part row: {spec.num_parts} parts x "
            f"{shards.num_edge_shards} edge shards need {spec.num_parts * shards.num_edge_shards}"
            f" ranks, the grid has {grid.world}")
    p, e = pg.rank, grid.index
    try:
        i, j = shards.parts_subset.index(p), shards.chunks_subset.index(e)
    except ValueError:
        raise ValueError(f"the shards hold parts {shards.parts_subset} x chunks "
                         f"{shards.chunks_subset}, not this rank's ({p}, {e})") from None
    a = shards.arrays2d
    dev = pg.device

    def put(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    V = spec.nv_pad
    dst = put(a.dst_local[i, j])
    plan = None
    if route is not None:
        from lux_tpu_torch.ops import expand

        if not isinstance(route[0], expand.ExpandStatic):
            raise ValueError("the edge-sharded chunks route their gather with expand "
                             "plans (ops/expand.plan_edge2d_route_shards), not a "
                             f"{type(route[0]).__name__}")
        plan = expand.plan_to_device((route[0], tuple(x[i, j] for x in route[1])), dev)
    cell = _Cell(put(a.src_pos[i, j]), dst, dst.clamp(0, V - 1), put(a.head_flag[i, j]),
                 put(a.weights[i, j]),
                 _RingView(put(a.global_vid[i]), put(a.degree[i]), put(a.vtx_mask[i])), plan)
    state0 = state0 if isinstance(state0, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(state0))
    if state0.shape[0] == spec.num_parts:
        state0 = state0[p: p + 1]
    elif state0.shape[0] != 1:
        raise ValueError(f"state0 has {state0.shape[0]} rows: neither the {spec.num_parts} "
                         "parts nor this rank's one")
    return cell, state0.to(dev)


def _iteration(prog, cell: _Cell, block: torch.Tensor, grid: Grid2D,
               method: str) -> torch.Tensor:
    """One iteration on this rank: the parts-axis gather, the chunk's
    partial reduction, its combination over the edge axis, apply."""
    full = halo_all_gather(block, grid.parts)
    local = block[0]
    dst_state = local.index_select(0, cell.dst_clip) if prog.needs_dst_state else None
    src = gather_bucket(full, cell.src_pos, cell.plan)
    vals = prog.edge_value(src, cell.weights, dst_state)
    part = segment.segment_reduce_by_ends(vals, cell.head_flag, cell.dst_local,
                                          local.shape[0], reduce=prog.reduce, method=method)
    acc = axis_all_reduce(grid, part, prog.reduce)
    return prog.apply(local, acc, cell.view)[None]


def run_pull_fixed_2d(prog, shards: Edge2DShards, state0, num_iters: int, grid: Grid2D,
                      method: str = "auto", route=None) -> torch.Tensor:
    """Fixed-iteration pull over the (parts x edge) grid.  ``state0`` is
    stacked by part, all P or this rank's one row (engine/pull
    .init_state over ``shards.arrays``); ``shards`` all cells or this
    rank's; ``route`` the cells' plans (ops/expand.plan_edge2d_route_shards
    [_cached] over the same cells), bitwise the direct run.  Returns this
    rank's final (1, V, ...) block, which every edge shard of the part
    holds alike."""
    method = resolve_method(method, prog.reduce, grid.parts.device)
    cell, block = _place(shards, state0, grid, route)
    for _ in range(num_iters):
        block = _iteration(prog, cell, block, grid, method)
    return block


def run_pull_until_2d(prog, shards: Edge2DShards, state0, max_iters: int,
                      active_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                      grid: Grid2D, method: str = "auto"):
    """Convergence-driven pull over the grid (CC style): iterate until the
    global active count, ``active_fn(old, new)`` of each part summed over
    the parts axis (a part's count is the same on its edge shards), is 0,
    or ``max_iters`` ran.  Returns (this rank's final (1, V, ...) block,
    iterations run)."""
    from lux_tpu_torch.parallel.dist import global_active

    method = resolve_method(method, prog.reduce, grid.parts.device)
    cell, block = _place(shards, state0, grid)
    it = 0
    while it < max_iters:
        new = _iteration(prog, cell, block, grid, method)
        active = global_active(grid.parts, active_fn(block, new).sum())
        block = new
        it += 1
        if active == 0:
            break
    return block, it


def assemble_global(grid: Grid2D, block: torch.Tensor) -> Optional[np.ndarray]:
    """The stacked (P, V, ...) state on the grid's lead rank (float32 for
    a bf16 state), gathered over the parts axis; None elsewhere."""
    from lux_tpu_torch.parallel import multihost

    st = multihost.assemble_global(grid.parts, block)
    return st if grid.lead else None
