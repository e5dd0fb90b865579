"""Ring-streamed state exchange: the alternative to the all-gather for
state too large to gather on every rank.

Counterpart of the pull part of ``lux_tpu.parallel.ring``.  Each rank
keeps only its resident (k, V, ...) block; the blocks go around the ring
(``batch_isend_irecv`` to the previous rank and from the next, double
buffered), and each arriving block's edge contributions fold into the
resident accumulators as it arrives, so no rank ever holds the whole
state.  Host side, each part's edges are bucketed by the part that owns
their source (P buckets, padded to the largest), byte for byte the
reference's layout.

``route=`` (ops/expand.plan_ring_route_shards: one expand plan a (resident
part, streamed part) bucket) replays each bucket's gather of the streamed
block as routed lane shuffles, bitwise the direct gather; the sweep is a
Python loop, so it takes bucket (i, q)'s plan directly.

Destinations are always local, so a program that reads the destination
state per edge (CF's error term) takes it from the resident block.  The
ring runs ``--method scan|scatter`` only (bucketed reductions carry no
row_ptr), as in the reference.  The ring push (``PushRingShards`` here,
its driver ``engine/push.run_push_ring``) folds the same buckets into its
dense rounds.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from lux_tpu_torch.engine import methods
from lux_tpu_torch.engine.pull import PullProgram
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.shards import LANE, PullShards, _round_up, build_pull_shards
from lux_tpu_torch.native import io as native_io
from lux_tpu_torch.ops import segment
from lux_tpu_torch.parallel.mesh import PartsGroup, shard_stacked
from lux_tpu_torch.parallel.placement import _wire

#: the reference's note for a method a bucketed exchange cannot run
BUCKETED_METHODS_NOTE = (
    "the ring and reduce_scatter exchanges run --method scan or scatter "
    "(bucketed reductions carry no row_ptr for the prefix-difference methods; "
    "the mxscan kernel runs on the allgather exchange)")


class RingArrays(NamedTuple):
    """Per-part, per-source-bucket edge structure (R = the built parts,
    all P or a rank's subset; B = e_bucket_pad):
      src_local: (R, P, B) int32  source index WITHIN the streamed block
      dst_local: (R, P, B) int32  local destination; padding holds V
      head_flag: (R, P, B) bool   segment starts by destination, and the
                 first padding slot (the last real edge reads as an end)
      weights:   (R, P, B) float32
    No per-bucket (V+1) row_ptr: every array is edge-aligned, so the
    buckets cost O(part edges), not O(P^2 * V)."""

    src_local: np.ndarray
    dst_local: np.ndarray
    head_flag: np.ndarray
    weights: np.ndarray


@dataclasses.dataclass
class RingShards:
    pull: PullShards
    rarrays: RingArrays
    e_bucket_pad: int
    #: the parts whose rows rarrays holds, in order
    parts_subset: list
    #: the host path the buckets were filled by: "native" or "numpy"
    host_io: str = "numpy"

    @property
    def spec(self):
        return self.pull.spec

    @property
    def arrays(self):
        return self.pull.arrays

    @property
    def cuts(self):
        return self.pull.cuts

    def scatter_to_global(self, stacked):
        return self.pull.scatter_to_global(stacked)


def bucket_counts(g: HostGraph, cuts, num_parts: int) -> np.ndarray:
    """(P, P) bucket edge counts: [p, q] = edges into part p's
    destinations from part q's sources.  One pass over each part's slice
    (col_idx may be a memory map: only that range is read); every rank
    computes it so the padded bucket shape agrees."""
    counts = np.zeros((num_parts, num_parts), np.int64)
    for p in range(num_parts):
        elo = int(g.row_ptr[cuts[p]])
        ehi = int(g.row_ptr[cuts[p + 1]])
        own = np.searchsorted(cuts, g.col_idx[elo:ehi], side="right") - 1
        counts[p] = np.bincount(own, minlength=num_parts)
    return counts


def _slice_dst_local(g: HostGraph, vlo: int, vhi: int) -> np.ndarray:
    """Part-local destinations of the edge slice of vertices [vlo, vhi),
    from row_ptr alone."""
    rp = np.asarray(g.row_ptr[vlo: vhi + 1])
    return np.repeat(np.arange(vhi - vlo, dtype=np.int32), np.diff(rp).astype(np.int64))


def _owner_split(srcs: np.ndarray, cuts) -> tuple:
    """Stable owner-bucketing of an edge slice: (order, counts), by the
    native counting sort when the library builds, else NumPy's stable
    argsort (the same permutation)."""
    res = native_io.bucket_split(srcs, cuts)
    if res is not None:
        return res
    own = np.searchsorted(cuts, srcs, side="right") - 1
    counts = np.bincount(own, minlength=len(cuts) - 1)
    return np.argsort(own, kind="stable"), counts


def _native_bucket_fill_ok(w_in) -> bool:
    """The native fill takes int32 weights: any dtype an int32 cast could
    change takes the NumPy path, so both paths stay bit-identical."""
    return w_in is None or w_in.dtype in (np.int8, np.int16, np.int32, np.uint8, np.uint16)


def mark_bucket_heads(hf_row: np.ndarray, dl: np.ndarray) -> None:
    """Destination-segment starts of one bucket (edges in CSC order); the
    first padding slot is flagged too, so segment_reduce_by_ends reads
    the last real edge as an end."""
    m = len(dl)
    if m:
        hf_row[0] = True
        hf_row[1:m] = dl[1:] != dl[:-1]
    if m < hf_row.shape[0]:
        hf_row[m] = True


def _subset(num_parts, parts_subset, placement, host):
    if placement is not None:
        if parts_subset is not None:
            raise ValueError("pass placement or parts_subset, not both")
        if placement.num_parts != num_parts:
            raise ValueError(f"placement has {placement.num_parts} parts, not {num_parts}")
        parts_subset = placement.parts_of(host)
    return list(range(num_parts) if parts_subset is None else parts_subset)


def _alloc(R: int, Pn: int, B: int, V: int):
    return (np.zeros((R, Pn, B), np.int32), np.full((R, Pn, B), V, np.int32),
            np.zeros((R, Pn, B), bool), np.zeros((R, Pn, B), np.float32))


def build_ring_shards(g: HostGraph, num_parts: int,
                      parts_subset: Optional[Sequence[int]] = None, pull=None,
                      counts=None, placement=None, host: int = 0) -> RingShards:
    """Bucket the graph for ring streaming.  ``parts_subset`` builds only
    those parts' (P, B) rows (a rank holds O(its edges)); ``pull`` an
    existing pull build (all parts, or the same subset from
    graph/sharded_load); ``counts`` precomputed :func:`bucket_counts`;
    ``placement``/``host`` take the subset from a PlacementTree slice."""
    rows = _subset(num_parts, parts_subset, placement, host)
    pull = pull if pull is not None else build_pull_shards(g, num_parts)
    spec, cuts = pull.spec, pull.cuts
    Pn, V = num_parts, spec.nv_pad
    counts = counts if counts is not None else bucket_counts(g, cuts, Pn)
    B = _round_up(max(1, int(counts.max())), LANE)
    src_local, dst_local, head_flag, weights = _alloc(len(rows), Pn, B, V)
    identity = np.arange(Pn, dtype=np.int64)
    blk = Pn * B
    for i, p in enumerate(rows):
        vlo, vhi = int(cuts[p]), int(cuts[p + 1])
        elo, ehi = int(g.row_ptr[vlo]), int(g.row_ptr[vhi])
        w_in = None if g.weights is None else np.asarray(g.weights[elo:ehi])
        if _native_bucket_fill_ok(w_in) and native_io.bucket_fill(
                np.asarray(g.col_idx[elo:ehi]), np.asarray(g.row_ptr[vlo: vhi + 1]), w_in,
                cuts, B, identity, B,
                src_local.reshape(-1)[i * blk: (i + 1) * blk],
                dst_local.reshape(-1)[i * blk: (i + 1) * blk],
                head_flag.view(np.uint8).reshape(-1)[i * blk: (i + 1) * blk],
                weights.reshape(-1)[i * blk: (i + 1) * blk]):
            continue
        srcs = np.asarray(g.col_idx[elo:ehi]).astype(np.int64)
        dl_slice = _slice_dst_local(g, vlo, vhi)
        # the stable owner split keeps CSC (by destination) order in a bucket
        order, _ = _owner_split(srcs, cuts)
        splits = np.split(order, np.cumsum(counts[p])[:-1])
        for q in range(Pn):
            eids = splits[q]
            m = len(eids)
            src_local[i, q, :m] = (srcs[eids] - cuts[q]).astype(np.int32)
            dl = dl_slice[eids]
            dst_local[i, q, :m] = dl
            mark_bucket_heads(head_flag[i, q], dl)
            if w_in is not None:
                weights[i, q, :m] = w_in[eids].astype(np.float32)
    return RingShards(pull=pull, rarrays=RingArrays(src_local, dst_local, head_flag, weights),
                      e_bucket_pad=B, parts_subset=rows, host_io=native_io.host_path())


@dataclasses.dataclass
class PushRingShards:
    """Push shards with the RING dense exchange: the frontier CSR (sparse
    rounds exchange queues) and the per-source-owner ring buckets (dense
    rounds fold streamed state blocks instead of gathering the whole
    state), on one partition.  The O(E) pull arrays inside ``push`` stay
    on the host: the ring push driver never places them."""

    push: object  # graph.push_shards.PushShards
    rarrays: RingArrays
    e_bucket_pad: int
    #: the parts whose bucket rows rarrays holds, in order
    parts_subset: list

    @property
    def spec(self):
        return self.push.spec

    @property
    def pspec(self):
        return self.push.pspec

    @property
    def parrays(self):
        return self.push.parrays

    @property
    def arrays(self):
        return self.push.arrays

    @property
    def pull(self):
        return self.push.pull

    @property
    def cuts(self):
        return self.push.cuts

    def scatter_to_global(self, stacked):
        return self.push.scatter_to_global(stacked)


def build_push_ring_shards(g: HostGraph, num_parts: int,
                           parts_subset: Optional[Sequence[int]] = None,
                           cuts=None, push=None) -> PushRingShards:
    """Push shards and ring buckets over the SAME partition: one
    ``build_push_shards`` (``cuts``: a recut's bounds), or the already
    built ``push`` layout, wrapped with the buckets of ``parts_subset``
    (default all parts)."""
    from lux_tpu_torch.graph.push_shards import build_push_shards

    if push is None:
        push = build_push_shards(g, num_parts, cuts=cuts)
    rs = build_ring_shards(g, num_parts, parts_subset, pull=push.pull)
    return PushRingShards(push=push, rarrays=rs.rarrays, e_bucket_pad=rs.e_bucket_pad,
                          parts_subset=rs.parts_subset)


def neutral_like(local: torch.Tensor, reduce: str) -> torch.Tensor:
    """The fold accumulator's neutral element, in the REDUCTION dtype:
    floats reduce in f32 (a bf16 state's edge values are f32), integer
    programs in their own dtype."""
    dt = local.dtype if not local.dtype.is_floating_point else torch.promote_types(
        local.dtype, torch.float32)
    if reduce == "sum":
        return torch.zeros_like(local, dtype=dt)
    if dt.is_floating_point:
        v = float("inf") if reduce == "min" else float("-inf")
    else:
        v = torch.iinfo(dt).max if reduce == "min" else torch.iinfo(dt).min
    return torch.full_like(local, v, dtype=dt)


def ring_sweep(block: torch.Tensor, acc, fold, pg: PartsGroup):
    """The ring schedule: W-1 fold steps, each overlapped with the
    transfer of the stream to the previous rank (and of the next rank's to
    this one), then the last fold without a transfer.  ``fold(s, acc,
    stream) -> acc`` consumes the block that started s hops away (rank
    (r + s) % W).  Under gloo on a card the stream crosses through pinned
    host buffers; with ``pg.timed`` the copies and the transfers' waits
    add to ``pg.times``."""
    import torch.distributed as dist

    W = pg.world
    stream = block.contiguous()
    for s in range(W - 1):
        t0 = pg.fence() if pg.timed else 0.0
        if pg.staged:
            send = pg.pinned("ring_send", stream)
            send.copy_(stream)
            recv = pg.pinned("ring_recv", stream)
        else:
            send, recv = stream, torch.empty_like(stream)
        t1 = pg.fence() if pg.timed else 0.0
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, _wire(send), pg.peer((pg.rank - 1) % W),
                       group=pg.group),
            dist.P2POp(dist.irecv, _wire(recv), pg.peer((pg.rank + 1) % W),
                       group=pg.group)])
        acc = fold(s, acc, stream)
        t2 = pg.fence() if pg.timed else 0.0
        for w in works:
            w.wait()
        t3 = pg.fence() if pg.timed else 0.0
        stream = recv.to(pg.device, copy=True) if pg.staged else recv
        if pg.timed:
            t4 = pg.fence()
            pg.times.stage_s += (t1 - t0) + (t4 - t3)
            pg.times.collective_s += t3 - t2
            pg.times.calls += 1
    return fold(W - 1, acc, stream)


class _RingView(NamedTuple):
    """The per-vertex arrays apply reads, for the bucketed drivers."""

    global_vid: torch.Tensor
    degree: torch.Tensor
    vtx_mask: torch.Tensor


_FOLD = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def bucketed_method(method: str, was_auto: bool) -> str:
    """The method a bucketed exchange runs, given a resolved ``method``:
    scan and scatter run as they are; an ``auto`` winner the buckets
    cannot run (mxscan on the card) falls back to engine/methods.FALLBACK;
    another explicit method is refused."""
    if method in ("scan", "scatter"):
        return method
    if was_auto:
        return methods.FALLBACK
    raise ValueError(BUCKETED_METHODS_NOTE)


def resolve_bucketed(method: str, reduce: str, device) -> str:
    """:func:`bucketed_method` of ``method``, with ``auto`` resolved per
    engine/methods on ``device``."""
    if method != "auto":
        return bucketed_method(method, False)
    return bucketed_method(methods.resolve(method, reduce, methods.default_platform(device)),
                           True)


def vertex_view(pg: PartsGroup, arrays) -> _RingView:
    """This rank's (k, V) global_vid, degree and vtx_mask on its device."""
    return _RingView(*(shard_stacked(pg, getattr(arrays, f)) for f in _RingView._fields))


def bucket_routes(pg: PartsGroup, route):
    """This rank's bucket plans of a stacked (R, S, ...) bucket plan (R:
    all P rows or this rank's k; S: the P peer parts), on its device:
    ``[i][q]`` is resident part i's plan of bucket q, (static, arrays);
    None for no plan.  Only expand plans route a bucket's gather."""
    if route is None:
        return None
    from lux_tpu_torch.ops import expand
    from lux_tpu_torch.parallel.mesh import resident_plans

    if not isinstance(route[0], expand.ExpandStatic):
        raise ValueError("the bucketed exchanges route their gathers with expand plans "
                         f"(ops/expand.plan_*_route_shards), not a {type(route[0]).__name__}")
    if route[1] and route[1][0].shape[1] != pg.num_parts:
        raise ValueError(f"the bucket plan has {route[1][0].shape[1]} buckets a part, the "
                         f"group {pg.num_parts} parts")
    return [[(static, tuple(a[q] for a in arr)) for q in range(pg.num_parts)]
            for static, arr in resident_plans(pg, route)]


def gather_bucket(block_lane: torch.Tensor, idx: torch.Tensor, plan) -> torch.Tensor:
    """A bucket's gather of one state block: ``block_lane[idx]``, or its
    routed replay through ``plan`` (bitwise on the bucket's real edges)."""
    if plan is None:
        return block_lane.index_select(0, idx)
    from lux_tpu_torch.ops import expand

    return expand.apply_expand(block_lane, plan[0], plan[1])


def check_subset(parts_subset, pg: PartsGroup) -> None:
    """Ring buckets built for all parts, or for exactly this rank's."""
    rows = list(parts_subset)
    if len(rows) not in (pg.num_parts, pg.k) or (
            len(rows) == pg.k and rows != list(pg.parts)):
        raise ValueError(f"ring shards hold parts {rows}, this rank {list(pg.parts)}")


def run_pull_fixed_ring(prog: PullProgram, shards: RingShards, state0, num_iters: int,
                        pg: PartsGroup, method: str = "auto", route=None) -> torch.Tensor:
    """Fixed-iteration distributed pull with ring-streamed state blocks.
    ``state0`` is stacked by part, all P or this rank's k; ``shards`` all
    parts or this rank's subset; ``route`` its bucket plans
    (ops/expand.plan_ring_route_shards[_cached]), bitwise the direct
    run.  Returns this rank's final (k, V, ...) block."""
    method = resolve_bucketed(method, prog.reduce, pg.device)
    if shards.spec.num_parts != pg.num_parts:
        raise ValueError(f"the shards have {shards.spec.num_parts} parts, the group "
                         f"{pg.num_parts}")
    check_subset(shards.parts_subset, pg)
    rarr = shard_stacked(pg, shards.rarrays)
    view = vertex_view(pg, shards.arrays)
    block = shard_stacked(pg, state0)
    k, V = pg.k, shards.spec.nv_pad
    plans = bucket_routes(pg, route)
    clip = [[rarr.dst_local[i, q].clamp(0, V - 1) for q in range(pg.num_parts)]
            for i in range(k)] if prog.needs_dst_state else None

    def fold(s, acc, stream):
        dev = (pg.rank + s) % pg.world
        out = []
        for i in range(k):
            a = acc[i]
            for j in range(k):
                q = dev * k + j  # global part of streamed lane j
                dst_state = (block[i].index_select(0, clip[i][q])
                             if clip is not None else None)
                src = gather_bucket(stream[j], rarr.src_local[i, q],
                                    plans and plans[i][q])
                vals = prog.edge_value(src, rarr.weights[i, q], dst_state)
                part = segment.segment_reduce_by_ends(
                    vals, rarr.head_flag[i, q], rarr.dst_local[i, q], V,
                    reduce=prog.reduce, method=method)
                a = _FOLD[prog.reduce](a, part)
            out.append(a)
        return torch.stack(out)

    for _ in range(num_iters):
        acc = ring_sweep(block, neutral_like(block, prog.reduce), fold, pg)
        block = torch.stack([prog.apply(block[i], acc[i],
                                        _RingView(*(f[i] for f in view)))
                             for i in range(k)])
    return block
