"""Reduce-scatter state exchange: per-destination partials, summed by
the collective.

Counterpart of ``lux_tpu.parallel.scatter``, the third exchange beside
the all-gather (parallel/dist.py) and the ring (parallel/ring.py): each
rank keeps only its own state block; from its resident SOURCE parts it
computes partial sums into every destination part, over the transposed
bucket layout (bucket (q, p) = the edges from q's sources into p's
destinations, held by q's rank), and one ``reduce_scatter`` sums the
partials over the ranks and hands each rank its own destination block
(``placement.halo_reduce_scatter``).

Only sum programs that read no destination state qualify (PageRank):
the collective adds, and a destination's state is on another rank.  The
exchange runs ``--method scan|scatter`` only, as the ring does.
``route=`` replays each bucket's gather of a resident block as routed lane
shuffles (ops/expand.plan_scatter_route_shards), bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from lux_tpu_torch.engine.pull import PullProgram
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.shards import LANE, PullShards, _round_up, build_pull_shards
from lux_tpu_torch.native import io as native_io
from lux_tpu_torch.ops import segment
from lux_tpu_torch.parallel.mesh import PartsGroup, shard_stacked
from lux_tpu_torch.parallel.placement import halo_reduce_scatter
from lux_tpu_torch.parallel.ring import (_RingView, _alloc, _native_bucket_fill_ok,
                                         _owner_split, _slice_dst_local, _subset,
                                         bucket_counts, bucket_routes, gather_bucket,
                                         mark_bucket_heads, resolve_bucketed,
                                         vertex_view)

#: the reference's refusals (its driver asserts them)
NOT_SUM = ("reduce_scatter exchange requires a sum-reducible program; "
           "use the ring or all_gather drivers for min/max")
NEEDS_DST = ("program reads destination state per edge (e.g. CF's error term); "
             "pre-combined reduce_scatter cannot supply it — use ring/all_gather")


class ScatterArrays(NamedTuple):
    """Source owner q's view (R = the built owners, all P or a rank's
    subset; B = e_bucket_pad): for each destination part p, the edges
    from q's sources into p.
      src_local: (R, P, B) int32  source index within q's resident block
      dst_local: (R, P, B) int32  p-local destination; padding holds V
      head_flag: (R, P, B) bool   destination-segment starts (and the
                 first padding slot, see ring.mark_bucket_heads)
      weights:   (R, P, B) float32"""

    src_local: np.ndarray
    dst_local: np.ndarray
    head_flag: np.ndarray
    weights: np.ndarray


@dataclasses.dataclass
class ScatterShards:
    pull: PullShards
    sarrays: ScatterArrays
    e_bucket_pad: int
    #: the source owners whose rows sarrays holds, in order
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


def build_scatter_shards(g: HostGraph, num_parts: int,
                         parts_subset: Optional[Sequence[int]] = None, pull=None,
                         counts=None, placement=None, host: int = 0) -> ScatterShards:
    """The transposed bucket build: axis 0 = the SOURCE owner q (whose
    rank stores and computes the bucket), axis 1 = the destination part
    p.  ``parts_subset``, ``pull``, ``counts``, ``placement``/``host`` as
    in ring.build_ring_shards."""
    rows = _subset(num_parts, parts_subset, placement, host)
    pull = pull if pull is not None else build_pull_shards(g, num_parts)
    spec, cuts = pull.spec, pull.cuts
    Pn, V = num_parts, spec.nv_pad
    counts = counts if counts is not None else bucket_counts(g, cuts, Pn)
    B = _round_up(max(1, int(counts.max())), LANE)
    row_of = {q: i for i, q in enumerate(rows)}
    src_local, dst_local, head_flag, weights = _alloc(len(rows), Pn, B, V)
    row_map = np.full(Pn, -1, np.int64)
    for q in rows:
        row_map[q] = row_of[q]
    for p in range(Pn):  # destination part: one slice, split by owner
        vlo, vhi = int(cuts[p]), int(cuts[p + 1])
        elo, ehi = int(g.row_ptr[vlo]), int(g.row_ptr[vhi])
        w_in = None if g.weights is None else np.asarray(g.weights[elo:ehi])
        if _native_bucket_fill_ok(w_in) and native_io.bucket_fill(
                np.asarray(g.col_idx[elo:ehi]), np.asarray(g.row_ptr[vlo: vhi + 1]), w_in,
                cuts, B,
                # transposed: owner q's bucket for destination p sits at
                # row_of[q] * (P*B) + p*B, so the views start at column p
                row_map, Pn * B,
                src_local.reshape(-1)[p * B:], dst_local.reshape(-1)[p * B:],
                head_flag.view(np.uint8).reshape(-1)[p * B:],
                weights.reshape(-1)[p * B:]):
            continue
        srcs = np.asarray(g.col_idx[elo:ehi]).astype(np.int64)
        dl_slice = _slice_dst_local(g, vlo, vhi)
        order, _ = _owner_split(srcs, cuts)
        splits = np.split(order, np.cumsum(counts[p])[:-1])
        for q in rows:  # only the owners built here
            i = row_of[q]
            eids = splits[q]
            m = len(eids)
            src_local[i, p, :m] = (srcs[eids] - cuts[q]).astype(np.int32)
            dl = dl_slice[eids]
            dst_local[i, p, :m] = dl
            mark_bucket_heads(head_flag[i, p], dl)
            if w_in is not None:
                weights[i, p, :m] = w_in[eids].astype(np.float32)
    return ScatterShards(pull=pull,
                         sarrays=ScatterArrays(src_local, dst_local, head_flag, weights),
                         e_bucket_pad=B, parts_subset=rows, host_io=native_io.host_path())


def check_program(prog) -> None:
    """Refuse what a pre-combined reduce-scatter cannot run."""
    if prog.reduce != "sum":
        raise ValueError(NOT_SUM)
    if getattr(prog, "needs_dst_state", False):
        raise ValueError(NEEDS_DST)


def run_pull_fixed_scatter(prog: PullProgram, shards: ScatterShards, state0,
                           num_iters: int, pg: PartsGroup,
                           method: str = "auto", route=None) -> torch.Tensor:
    """Fixed-iteration distributed pull over the reduce-scatter exchange,
    k parts resident a rank.  ``state0`` stacked by part (all P or this
    rank's k); ``route`` the bucket plans
    (ops/expand.plan_scatter_route_shards[_cached]: bucket (j, p) gathers
    resident block j for destination part p), bitwise the direct run.
    Returns this rank's final (k, V, ...) block."""
    check_program(prog)
    method = resolve_bucketed(method, prog.reduce, pg.device)
    if shards.spec.num_parts != pg.num_parts:
        raise ValueError(f"the shards have {shards.spec.num_parts} parts, the group "
                         f"{pg.num_parts}")
    sarr = shard_stacked(pg, shards.sarrays)
    view = vertex_view(pg, shards.arrays)
    block = shard_stacked(pg, state0)
    k, V, Pn = pg.k, shards.spec.nv_pad, pg.num_parts
    plans = bucket_routes(pg, route)

    def partial_for(local, p):
        # partials into destination part p from every resident source
        # part, summed before the collective (sum programs only)
        lanes = []
        for j in range(k):
            src = gather_bucket(local[j], sarr.src_local[j, p], plans and plans[j][p])
            vals = prog.edge_value(src, sarr.weights[j, p], None)
            lanes.append(segment.segment_reduce_by_ends(
                vals, sarr.head_flag[j, p], sarr.dst_local[j, p], V, reduce="sum",
                method=method))
        return torch.stack(lanes).sum(0)

    for _ in range(num_iters):
        partials = torch.stack([partial_for(block, p) for p in range(Pn)])  # (P, V, ...)
        acc = halo_reduce_scatter(partials, k, pg)
        block = torch.stack([prog.apply(block[i], acc[i], _RingView(*(f[i] for f in view)))
                             for i in range(k)])
    return block
