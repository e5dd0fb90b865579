"""Feature-dimension (tensor-parallel) sharding of CF's wide vertex state.

Counterpart of ``lux_tpu.parallel.feat``.  Collaborative filtering's
latent state is (V, K); the 1-D engines spread V over the ranks and keep
all K.  Here the ranks form a (parts x feat) grid (parallel/mesh.Grid2D,
rank r = p*F + f), K is split over the F ranks of a part row, and each
rank holds a (k_parts, V, K/F) block: the state and the all-gathered
exchange shrink F-fold, the all-gather running within the rank's column
of the grid.

The one cross-feature term of CF's math is the error dot product
``err = w - <v_src, v_dst>``: each rank computes its partial dot over its
K/F features, then ONE (k_parts, E) f32 sum over the feat axis a
iteration (mesh.axis_all_reduce) completes it, O(E) on the wire instead
of O(E * K).  The err * v_src products, the per-destination reduction and
apply are feature-local.  The only reassociation is the K-sum split into
F partial sums, so results match the 1-D engines to float addition-order
tolerance.

``run_cf_feat_ring`` streams the (k, V, K/F) blocks around the parts
axis instead of gathering them (parallel/ring.ring_sweep; one feat sum
of the (k, k, B) dots a fold step), so a rank holds O(nv/P * K/F) state:
both big axes sharded at once.  With ``-ng`` a multiple of the part
rows, k parts sit in one part row.

``run_cf_feat_dist(route=)`` routes the source and destination reads per
feature column (ops/expand.apply_cf_route); the plans are the 1-D CF
plans of the pull layout, one serving every feat slice of a part row.
The ring form gathers directly, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lux_tpu_torch.engine import methods
from lux_tpu_torch.engine.pull import gather_sources
from lux_tpu_torch.graph.shards import ShardArrays, ShardSpec
from lux_tpu_torch.ops import segment
from lux_tpu_torch.parallel.mesh import Grid2D, axis_all_gather, axis_all_reduce, shard_stacked
from lux_tpu_torch.parallel.placement import halo_all_gather
from lux_tpu_torch.program.expr import dot_lanes

_SUM = segment.reducers()["sum"]


def _check(prog, grid: Grid2D, num_parts: int) -> int:
    """The feature slice width K/F, after the reference's checks."""
    if grid.axis != "feat":
        raise ValueError(f"feat sharding runs on a feat grid, not {grid.axis!r}")
    if prog.reduce != "sum" or not getattr(prog, "needs_dst_state", False):
        raise ValueError("feat sharding is CF's sum-reduce path (a program reading "
                         "the destination's latent vector)")
    if num_parts != grid.parts.num_parts:
        raise ValueError(f"the shards have {num_parts} parts, the grid "
                         f"{grid.parts.num_parts}")
    if prog.k % grid.size:
        raise ValueError(f"{grid.size} feat shards do not divide the latent dim "
                         f"K={prog.k}")
    return prog.k // grid.size


def feat_slice(prog, grid: Grid2D) -> slice:
    """This rank's columns of the K latent features."""
    kf = prog.k // grid.size
    return slice(grid.index * kf, (grid.index + 1) * kf)


def shard_feat(prog, grid: Grid2D, state0) -> torch.Tensor:
    """This rank's (k, V, K/F) block of a stacked state: (P|k, V, K)
    (its parts' rows, its feature columns) or already its block."""
    block = shard_stacked(grid.parts, state0)
    if block.shape[-1] == prog.k:
        block = block[..., feat_slice(prog, grid)].contiguous()
    elif block.shape[-1] != prog.k // grid.size:
        raise ValueError(f"state0 has {block.shape[-1]} features: neither K={prog.k} "
                         f"nor this rank's {prog.k // grid.size}")
    return block


def init_state_feat(prog, arrays: ShardArrays, grid: Grid2D) -> torch.Tensor:
    """This rank's (k, V, K/F) initial block from the stacked vertex
    arrays (all P parts or this rank's k), one resident part at a time:
    only one part's (V, K) initial state is ever whole, and only for the
    moment it is sliced."""
    from lux_tpu_torch.parallel.ring import vertex_view

    view = vertex_view(grid.parts, arrays)
    sl = feat_slice(prog, grid)
    return torch.stack([prog.init_state(view.global_vid[j], view.degree[j],
                                        view.vtx_mask[j])[..., sl].contiguous()
                        for j in range(grid.parts.k)])


def _method(method: str, device) -> str:
    return methods.resolve_sum(method, "sum", methods.default_platform(device))


def run_cf_feat_dist(prog, spec: ShardSpec, arrays: ShardArrays, state0, num_iters: int,
                     grid: Grid2D, method: str = "auto", route=None) -> torch.Tensor:
    """Fixed-iteration CF on the (parts x feat) grid over the allgather
    exchange.  ``arrays``: the pull layout stacked by part, all P or this
    rank's k (the same on every feat shard of a part row); ``state0`` as
    :func:`shard_feat` takes it; ``route`` the CF plans of the same rows
    (ops/expand.plan_cf_route_shards[_cached]: the source and destination
    reads per feature column, bitwise the direct gathers; one plan serves
    every feat slice).  Returns this rank's final (k, V, K/F) block."""
    from lux_tpu_torch.ops import expand
    from lux_tpu_torch.parallel.mesh import resident_plans

    _check(prog, grid, spec.num_parts)
    pg = grid.parts
    if route is not None and not isinstance(route[0], expand.CFRouteStatic):
        raise ValueError("the feat grid routes CF's wide reads with a CF plan "
                         f"(ops/expand.plan_cf_route_shards), not a {type(route[0]).__name__}")
    arrays = shard_stacked(pg, arrays)
    block = shard_feat(prog, grid, state0)
    method = _method(method, pg.device)
    k, V = pg.k, spec.nv_pad
    parts = [arrays.part(j) for j in range(k)]
    clips = [a.dst_local.clamp(0, V - 1) for a in parts]
    plans = resident_plans(pg, route)
    for _ in range(num_iters):
        full = halo_all_gather(block, pg)  # (P*V, Kf) over the parts axis only
        srcs, dots = [], []
        for j, a in enumerate(parts):
            if plans is None:
                src = gather_sources(a, full).float()
                dst = block[j].index_select(0, clips[j]).float()
            else:
                src, dst = expand.apply_cf_route(full, block[j], *plans[j])
                src, dst = src.float(), dst.float()
            srcs.append(src)
            dots.append(dot_lanes(src, dst, prog.err_dot))
        # the only cross-feature exchange: the (k, E) error dots
        dot = axis_all_reduce(grid, torch.stack(dots), "sum")
        new = []
        for j, a in enumerate(parts):
            vals = (a.weights - dot[j])[:, None] * srcs[j]
            acc = _SUM(vals, a.row_ptr, a.head_flag, a.dst_local, method=method)
            new.append(prog.apply(block[j], acc, a))
        block = torch.stack(new)
    return block


def run_cf_feat_ring(prog, shards, state0, num_iters: int, grid: Grid2D,
                     method: str = "auto") -> torch.Tensor:
    """Fixed-iteration CF on the (parts x feat) grid with ring-streamed
    state blocks (``shards``: parallel/ring.RingShards, all parts or this
    rank's k): each fold step takes the partial dots of every resident
    part against every streamed one, sums them over the feat axis in one
    collective, and folds the feature-local products.  Returns this
    rank's final (k, V, K/F) block."""
    from lux_tpu_torch.parallel.ring import (_RingView, check_subset, neutral_like,
                                             resolve_bucketed, ring_sweep, vertex_view)

    _check(prog, grid, shards.spec.num_parts)
    pg = grid.parts
    method = resolve_bucketed(method, "sum", pg.device)
    check_subset(shards.parts_subset, pg)
    rarr = shard_stacked(pg, shards.rarrays)
    view = vertex_view(pg, shards.arrays)
    block = shard_feat(prog, grid, state0)
    k, V = pg.k, shards.spec.nv_pad
    clip = [[rarr.dst_local[i, q].clamp(0, V - 1) for q in range(pg.num_parts)]
            for i in range(k)]

    def fold(s, acc, stream):
        row = (pg.rank + s) % pg.world
        qs = [row * k + j for j in range(k)]  # global parts of the streamed lanes
        srcs = [[stream[j].index_select(0, rarr.src_local[i, q]).float()
                 for j, q in enumerate(qs)] for i in range(k)]
        dots = torch.stack([torch.stack([
            dot_lanes(srcs[i][j], block[i].index_select(0, clip[i][q]).float(),
                      prog.err_dot)
            for j, q in enumerate(qs)]) for i in range(k)])
        # the one cross-feature exchange of the step: (k_res, k_stream, B)
        dots = axis_all_reduce(grid, dots, "sum")
        out = []
        for i in range(k):
            a = acc[i]
            for j, q in enumerate(qs):
                vals = (rarr.weights[i, q] - dots[i, j])[:, None] * srcs[i][j]
                a = a + segment.segment_reduce_by_ends(
                    vals, rarr.head_flag[i, q], rarr.dst_local[i, q], V, reduce="sum",
                    method=method)
            out.append(a)
        return torch.stack(out)

    for _ in range(num_iters):
        acc = ring_sweep(block, neutral_like(block, "sum"), fold, pg)
        block = torch.stack([prog.apply(block[i], acc[i], _RingView(*(f[i] for f in view)))
                             for i in range(k)])
    return block


def assemble_global(grid: Grid2D, block: torch.Tensor) -> Optional[np.ndarray]:
    """The stacked (P, V, K) state on the grid's lead rank (float32 for a
    bf16 state), from every rank's (k, V, K/F) block: the feature slices
    of a part row side by side, then the part rows in part order; None
    on the other ranks."""
    from lux_tpu_torch.parallel import multihost

    cols = axis_all_gather(grid, block)  # (F, k, V, Kf)
    whole = cols.permute(1, 2, 0, 3).reshape(block.shape[:2] + (-1,))
    st = multihost.assemble_global(grid.parts, whole.contiguous())
    return st if grid.lead else None
