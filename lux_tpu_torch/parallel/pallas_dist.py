"""The distributed pull on the block-CSR SpMV kernels (``--method pallas``
across ranks).

Counterpart of the pull and CF parts of ``lux_tpu.parallel.pallas_dist``
(the reference's kernels are Pallas; here they are the hand-written
CUDA kernels of ops/spmv).  Each rank holds ONE part, as the reference's
``require_parts_fit_devices`` demands: every iteration all-gathers the
state over the ranks, gathers the per-slot source values from it, reduces
them by destination on ``spmv_blockcsr`` (PageRank) or ``spmv_blockcsr_2d``
(CF's ``err * srcVec``, whose destination rows come from the rank's own
block), and applies.

Host layout: each part's padded vertex range (the pull shards' nv_pad row)
is tiled into v_blk-wide blocks; every part gets the same number of blocks
and chunks (padded with no-op chunks whose slots are all padding), so the
per-part arrays stack into (P, C, T) like the reference's, byte for byte.

The distributed push runs its dense rounds on the same kernel
(``PushPallasShards``, ``run_push_pallas_dist``): the gathered state's
slot values relaxed, then ``spmv_blockcsr`` in int32 min (SSSP) or max
(components) over the rank's chunks; the sparse rounds are the push
engine's (engine/push), on the frontier CSR of the same partition.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.shards import ShardSpec, build_pull_shards, stacked_to_global
from lux_tpu_torch.ops import spmv
from lux_tpu_torch.parallel.mesh import PartsGroup, shard_stacked
from lux_tpu_torch.parallel.placement import halo_all_gather


class PallasArrays(NamedTuple):
    """Stacked (R, ...) arrays of the distributed block-CSR pull (R = P,
    or the parts a subset build holds)."""

    e_src_pos: Any  # (R, C, T) int32: gathered-coordinate sources
    e_dst_rel: Any  # (R, C, T) int32: dst - block base; v_blk = padding
    e_weight: Any  # (R, C, T) float32, or (R, 1, 1) zeros when unweighted
    chunk_block: Any  # (R, C) int32
    chunk_first: Any  # (R, C) int32
    global_vid: Any  # (R, V) int32: the vertex view of init and apply
    degree: Any  # (R, V) int32
    vtx_mask: Any  # (R, V) bool


@dataclasses.dataclass
class PallasParts:
    spec: ShardSpec
    cuts: np.ndarray
    num_vblocks: int
    v_blk: int
    t_chunk: int
    arrays: PallasArrays
    #: the parts whose rows the arrays hold, in order
    parts_subset: list = dataclasses.field(default_factory=list)
    #: the host path the chunks were filled by: "native" or "numpy"
    host_io: str = "numpy"

    def scatter_to_global(self, stacked: np.ndarray) -> np.ndarray:
        return stacked_to_global(self.cuts, stacked)


class _LocalView:
    """The HostGraph surface build_blockcsr reads, for ONE part's padded
    row: a local row_ptr over the whole nv_pad range (empty tail rows)."""

    def __init__(self, row_ptr, nv, weights):
        self.row_ptr = row_ptr
        self.nv = nv
        self.weights = weights

    def dst_of_edges(self) -> np.ndarray:
        return np.repeat(np.arange(self.nv, dtype=np.int64), np.diff(self.row_ptr))


def _num_chunks(row_ptr: np.ndarray, v_blk: int, t_chunk: int) -> int:
    """Chunks of one part's block-CSR (every block at least one), from its
    row_ptr alone."""
    nv = len(row_ptr) - 1
    nb = -(-nv // v_blk)
    bounds = row_ptr[np.minimum(np.arange(nb + 1) * v_blk, nv)].astype(np.int64)
    return int(np.maximum(1, -(-np.diff(bounds) // t_chunk)).sum())


def build_pallas_parts(g: HostGraph, num_parts: int, v_blk: Optional[int] = None,
                       t_chunk: Optional[int] = None, base=None,
                       parts_subset: Optional[Sequence[int]] = None) -> PallasParts:
    """Partition + block-CSR relayout for the distributed block-CSR pull:
    the edge-balanced shard geometry of build_pull_shards (states are
    interchangeable across engines), each part's padded row relaid out
    by ``ops/spmv.build_blockcsr``.  ``base`` supplies already built pull
    shards; ``parts_subset`` builds only those parts' rows (a rank's own),
    with the chunk count of every part, so the shapes agree with the
    full build's."""
    if base is None:
        base = build_pull_shards(g, num_parts)
    spec, cuts, arr = base.spec, base.cuts, base.arrays
    v_blk = v_blk or spmv.V_BLK
    t_chunk = t_chunk or spmv.T_CHUNK
    rows = list(range(num_parts) if parts_subset is None else parts_subset)
    c_max = max(_num_chunks(arr.row_ptr[p].astype(np.int64), v_blk, t_chunk)
                for p in range(num_parts))
    parts = []
    for p in rows:
        rp = arr.row_ptr[p].astype(np.int64)
        m = int(rp[-1])
        w = arr.weights[p][:m] if spec.weighted else None
        parts.append(spmv.build_blockcsr(_LocalView(rp, spec.nv_pad, w),
                                         src_pos=arr.src_pos[p][:m], v_blk=v_blk,
                                         t_chunk=t_chunk))
    nb = -(-spec.nv_pad // v_blk)
    R = len(rows)
    e_src = np.zeros((R, c_max, t_chunk), np.int32)
    e_dst = np.full((R, c_max, t_chunk), v_blk, np.int32)
    # an unweighted graph carries a (R, 1, 1) zero placeholder: PageRank's
    # edge function ignores it and the card never holds O(E) zeros
    e_w = (np.zeros((R, c_max, t_chunk), np.float32) if spec.weighted
           else np.zeros((R, 1, 1), np.float32))
    cb = np.zeros((R, c_max), np.int32)
    cf = np.zeros((R, c_max), np.int32)
    for i, bc in enumerate(parts):
        c = bc.num_chunks
        e_src[i, :c] = bc.e_src_pos
        e_dst[i, :c] = bc.e_dst_rel
        if bc.e_weight is not None:
            e_w[i, :c] = bc.e_weight
        cb[i, :c] = bc.chunk_block
        cf[i, :c] = bc.chunk_first
        # padding chunks route to the last real block with no first flag:
        # the kernel accumulates nothing from them (every slot is padding)
        cb[i, c:] = bc.chunk_block[-1] if c else 0
    sel = np.asarray(rows, np.int64)
    arrays = PallasArrays(e_src_pos=e_src, e_dst_rel=e_dst, e_weight=e_w, chunk_block=cb,
                          chunk_first=cf, global_vid=arr.global_vid[sel],
                          degree=arr.degree[sel], vtx_mask=arr.vtx_mask[sel])
    return PallasParts(spec=spec, cuts=cuts, num_vblocks=nb, v_blk=v_blk, t_chunk=t_chunk,
                       arrays=arrays, parts_subset=rows,
                       host_io=parts[0].host_io if parts else "numpy")


def init_state_pallas(prog, pp: PallasParts) -> torch.Tensor:
    """Stacked (R, V, ...) initial state of the built parts (the contract
    of pull.init_state), where the arrays are (host arrays: the CPU)."""
    a = pp.arrays
    return torch.stack([
        prog.init_state(torch.as_tensor(a.global_vid[i]), torch.as_tensor(a.degree[i]),
                        torch.as_tensor(a.vtx_mask[i]))
        for i in range(a.global_vid.shape[0])])


def _guard(prog):
    if prog.reduce != "sum" or getattr(prog, "needs_dst_state", False):
        raise ValueError("pallas distributed pull: sum-reduce programs without "
                         "destination-state edge terms only")


def _one_part(pg: PartsGroup, pp: PallasParts):
    if pp.spec.num_parts != pg.world or pg.k != 1:
        raise ValueError(
            f"the block-CSR distributed pull keeps one part a rank: {pp.spec.num_parts} "
            f"parts over {pg.world} ranks (-ng must equal the rank count)")


class _Part(NamedTuple):
    """One part's device arrays (leading axis dropped)."""

    e_src_flat: torch.Tensor
    e_dst_rel: torch.Tensor
    e_weight: torch.Tensor
    chunk_block: torch.Tensor
    chunk_first: torch.Tensor
    global_vid: torch.Tensor
    degree: torch.Tensor
    vtx_mask: torch.Tensor


def _device_part(pg: PartsGroup, arrays: PallasArrays) -> _Part:
    a = shard_stacked(pg, arrays)
    return _Part(a.e_src_pos[0].reshape(-1), a.e_dst_rel[0], a.e_weight[0],
                 a.chunk_block[0], a.chunk_first[0], a.global_vid[0], a.degree[0],
                 a.vtx_mask[0])


def run_pull_fixed_pallas_dist(prog, pp: PallasParts, state0, num_iters: int,
                               pg: PartsGroup) -> torch.Tensor:
    """Fixed-iteration distributed pull on ``spmv_blockcsr``.  ``state0``
    stacked (P, V) or this rank's (1, V); returns the final (1, V)
    block."""
    _guard(prog)
    _one_part(pg, pp)
    arr = _device_part(pg, pp.arrays)
    local = shard_stacked(pg, state0)[0]
    shape = arr.e_dst_rel.shape
    nv_pad = pp.spec.nv_pad
    for _ in range(num_iters):
        full = halo_all_gather(local[None], pg)
        # (C, T) in the storage dtype; the kernel reduces in f32
        vals = prog.edge_value(full.index_select(0, arr.e_src_flat).view(shape),
                               arr.e_weight)
        acc = spmv.spmv_blockcsr(vals.contiguous(), arr.e_dst_rel, arr.chunk_block,
                                 arr.chunk_first, op="sum", v_blk=pp.v_blk,
                                 num_vblocks=pp.num_vblocks)[:nv_pad]
        local = prog.apply(local, acc, arr)
    return local[None]


def run_cf_pallas_dist(prog, pp: PallasParts, state0, num_iters: int,
                       pg: PartsGroup) -> torch.Tensor:
    """Distributed CF on ``spmv_blockcsr_2d``: the err * srcVec sum of each
    destination as the 2-D kernel's segmented sum, the (V, K) latent
    state all-gathered an iteration.  Returns the final (1, V, K)
    block."""
    if prog.reduce != "sum" or not getattr(prog, "needs_dst_state", False):
        raise ValueError("pallas 2-D distributed pull is the CF shape: sum-reduce with "
                         "a destination-state edge term")
    if not pp.spec.weighted:
        raise ValueError("CF requires a weighted graph")
    _one_part(pg, pp)
    arr = _device_part(pg, pp.arrays)
    local = shard_stacked(pg, state0)[0]
    shape = arr.e_dst_rel.shape
    nv_pad = pp.spec.nv_pad
    # destinations are always this part's: the error term's destination
    # rows come from the resident block, never the exchanged state
    dst_local = (arr.chunk_block[:, None] * pp.v_blk + arr.e_dst_rel).clamp(
        0, nv_pad - 1).reshape(-1)
    for _ in range(num_iters):
        full = halo_all_gather(local[None], pg)
        src_vec = full.index_select(0, arr.e_src_flat).view(*shape, -1)
        dst_vec = local.index_select(0, dst_local).view(*shape, -1)
        vals = prog.edge_value(src_vec, arr.e_weight, dst_vec)
        acc = spmv.spmv_blockcsr_2d(vals.contiguous(), arr.e_dst_rel, arr.chunk_block,
                                    arr.chunk_first, v_blk=pp.v_blk,
                                    num_vblocks=pp.num_vblocks)[:nv_pad]
        local = prog.apply(local, acc, arr)
    return local[None]


@dataclasses.dataclass
class PushPallasShards:
    """Push layout whose DENSE rounds reduce on the block-CSR kernel: the
    frontier CSR and queues of ``build_push_shards``, and the block-CSR
    chunks (gathered-coordinate sources) of the same partition instead
    of the pull layout's O(E) arrays."""

    push: Any  # graph.push_shards.PushShards
    pl: PallasArrays
    num_vblocks: int
    v_blk: int
    t_chunk: int
    #: the parts whose rows ``pl`` holds, in order
    parts_subset: list = dataclasses.field(default_factory=list)

    @property
    def spec(self):
        return self.push.spec

    @property
    def pspec(self):
        return self.push.pspec

    @property
    def cuts(self):
        return self.push.cuts

    @property
    def pull(self):
        return self.push.pull

    @property
    def arrays(self):
        return self.push.arrays

    @property
    def parrays(self):
        return self.push.parrays

    def scatter_to_global(self, stacked: np.ndarray) -> np.ndarray:
        return self.push.scatter_to_global(stacked)


def build_push_pallas_shards(g: HostGraph, num_parts: int, v_blk: Optional[int] = None,
                             t_chunk: Optional[int] = None, cuts=None,
                             parts_subset: Optional[Sequence[int]] = None
                             ) -> PushPallasShards:
    """Push shards and the block-CSR dense-round layout on one
    edge-balanced partition (``base=push.pull``): states are
    interchangeable with every other push engine.  ``parts_subset``
    builds only those parts' chunks (a rank's own)."""
    from lux_tpu_torch.graph.push_shards import build_push_shards

    push_sh = build_push_shards(g, num_parts, cuts=cuts)
    pp = build_pallas_parts(g, num_parts, v_blk=v_blk, t_chunk=t_chunk, base=push_sh.pull,
                            parts_subset=parts_subset)
    return PushPallasShards(push=push_sh, pl=pp.arrays, num_vblocks=pp.num_vblocks,
                            v_blk=pp.v_blk, t_chunk=pp.t_chunk,
                            parts_subset=pp.parts_subset)


def push_pallas_statics(shards: PushPallasShards, pg: PartsGroup):
    """This rank's statics on its device: its part's chunks, frontier CSR
    and (1, V) vertex view; never the pull layout's O(E) arrays.
    Returns (part, parrays, view)."""
    if shards.spec.num_parts != pg.world or pg.k != 1:
        raise ValueError(
            f"the block-CSR push keeps one part a rank: {shards.spec.num_parts} parts "
            f"over {pg.world} ranks (-ng must equal the rank count)")
    from lux_tpu_torch.parallel.ring import _RingView

    part = _device_part(pg, shards.pl)
    # the (1, V) vertex view the push engine's carry reads
    view = _RingView(part.global_vid[None], part.degree[None], part.vtx_mask[None])
    return part, shard_stacked(pg, shards.push.parrays), view


def push_pallas_dense_fn(prog, shards: PushPallasShards, part: _Part, pg: PartsGroup):
    """The pallas push's dense round: the state all-gathered, each slot's
    source value relaxed, then ``spmv_blockcsr`` in the program's int32
    min or max over this rank's chunks (padding slots hold ``v_blk`` and
    drop); vertices the kernel leaves at the neutral keep their value."""
    shape, nv_pad = part.e_dst_rel.shape, shards.spec.nv_pad
    op = torch.minimum if prog.reduce == "min" else torch.maximum

    def dense_fn(block):
        local = block[0]
        full = halo_all_gather(block, pg)
        vals = prog.relax(full.index_select(0, part.e_src_flat).view(shape), part.e_weight)
        acc = spmv.spmv_blockcsr(vals.contiguous(), part.e_dst_rel, part.chunk_block,
                                 part.chunk_first, op=prog.reduce, v_blk=shards.v_blk,
                                 num_vblocks=shards.num_vblocks)[:nv_pad]
        return torch.where(part.vtx_mask, op(local, acc), local)[None]

    return dense_fn


def run_push_pallas_dist(prog, shards: PushPallasShards, pg: PartsGroup,
                         max_iters: int = 10_000):
    """Distributed push with block-CSR kernel dense rounds (min/max frontier
    programs: SSSP, weighted SSSP, components), one part a rank.  Only the
    chunks, the frontier CSR and the vertex view reach the device.
    Bitwise the single-process push.  Returns (this rank's final (1, V)
    block, iterations, traversed edges)."""
    from lux_tpu_torch.engine import push

    lay = push.place_layout(prog, shards, pg)
    out = lay.loop(lay.init(), max_iters)
    return out.state, out.it, out.edges
