"""The push (frontier) execution engine with direction optimization.

Counterpart of ``lux_tpu.engine.push``:

  * State per part: the vertex values (distances or labels) and a sparse
    frontier QUEUE of (vertex id, value) pairs with static capacity
    ``f_cap``.
  * Direction switch per iteration: a frontier of more than nv/16
    vertices runs a DENSE (pull) round, the segmented reduce over every
    in-edge of the concatenated state; otherwise a SPARSE (push) round
    compacts the frontier's out-edges into a fixed ``e_sp`` buffer and
    scatter-combines them into each part's slice.  An overflowing queue
    or edge buffer forces a dense round.
  * Two sparse tiers: a round whose frontier out-edges fit ``e_sp_small``
    walks that many slots instead of ``e_sp``.
  * Cross-part merge of sparse rounds: ``bulk`` (one scatter of the whole
    concatenated frontier) or ``tree`` (ops/merge_tree.py), bitwise equal
    for the min/max programs.
  * Convergence when no vertex changed.

Where the reference decides direction, tier and stop on the device
(``lax.cond`` and ``lax.while_loop``), this engine reads the three values
on the host with ONE copy per iteration (``_push_prep``) and branches in
Python.  Parts run one after another in a Python loop, as in the pull
engine.  Queues are exact compactions in ascending local index, so the
results, the iteration count and the traversed-edge count are bitwise the
reference's.

The per-part load counter of the repartition policy, ``sp_work`` (the
sparse-round out-edges walked per part, saturating at 2^32 - 1 as the
reference's uint32 does), is summed on the host from the per-part totals
that the one read of ``_push_prep`` already brings.

``overlay_static=``/``oarrays=`` run the loop against a mutating graph
(lux_tpu_torch.mutate): dense rounds neutralize tombstoned base edges,
sparse rounds walk the patched CSR (deleted edges point at the drop
slot), and the insert buffer is folded in once a round after the
direction branch, from the round's input state.

``telemetry=`` (obs/ring.py, schema ``("it", "frontier", "edges_lo",
"dense")``) records one row a round in a device tensor; its values are
the ones the round's one host read already returned, so it adds no read
and leaves every result bitwise unchanged.

The distributed push (``run_push_dist``, ``run_push_ring``, and the
bodies ``parallel/pallas_dist`` and ``engine/delta`` share) runs the same
rounds over the ranks of torch.distributed, rank r holding parts [r*k,
(r+1)*k): each round exchanges the (k, f_cap) queues (one all-gather, or
``merge="tree"``'s staged point-to-point rounds), sums the round's votes
over the ranks in ONE all-reduce read with the round's one host read,
and branches only on the summed values, so every rank takes the same
path.  Dense rounds all-gather the state (or stream it around the ring).
Results, iterations and traversed edges are bitwise the single-process
run's at the same parts.  ``place_layout`` places any of these layouts
(or every part on one device) as a ``PushLayout`` with one window loop:
the apps' one frontier driver, the adaptive repartitioning and the
models run through it.

``route=`` under a group routes the dense rounds' gather: the allgather
layout's parts through their expand plans over the pull layout, the ring
layout's buckets through their bucket plans (ops/expand
.plan_ring_route_shards), each the rank's rows of a stacked plan; bitwise
the direct rounds.

Not ported: carry donation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Protocol

import torch

from lux_tpu_torch.engine import methods, pull
from lux_tpu_torch.graph import push_shards as ps
from lux_tpu_torch.graph.push_shards import SRC_SENTINEL, PushArrays, PushShards, PushSpec
from lux_tpu_torch.graph.shards import ShardArrays, ShardSpec, to_device
from lux_tpu_torch.mutate import overlay as ovl
from lux_tpu_torch.obs import ring as obs_ring
from lux_tpu_torch.ops import expand, merge_tree, segment
from lux_tpu_torch.utils.device import resolve_device


class PushProgram(Protocol):
    """Frontier vertex program (the SSSP/CC app contract)."""

    #: "min" | "max": the combiner AND the monotone direction of the state.
    reduce: str

    def init_state(self, global_vid, degree, vtx_mask) -> torch.Tensor: ...

    def init_frontier(self, global_vid, state, vtx_mask) -> torch.Tensor:
        """Initial active mask (e.g. the single source, or everyone)."""
        ...

    def relax(self, src_val, weight) -> torch.Tensor:
        """Candidate value pushed along an edge from a source holding
        ``src_val`` (e.g. src_val + 1 for BFS-SSSP)."""
        ...


def _op(prog):
    return torch.minimum if prog.reduce == "min" else torch.maximum


def _seg_reduce(prog):
    return segment.segment_min_csc if prog.reduce == "min" else segment.segment_max_csc


def _scatter_reduce(prog) -> str:
    return "amin" if prog.reduce == "min" else "amax"


def dense_part_step(prog, arr: ShardArrays, full_state, local, method="scan",
                    route=None, del_val=None):
    """Pull-mode relaxation of ONE part over all its in-edges:
    new[v] = op(old[v], op over in-edges relax(state[src])).  ``route`` =
    (ExpandStatic, this part's arrays) replaces the gather with the routed
    expand (ops/expand.py), bitwise equal; a pass-fused plan replays
    through the fused kernel.  ``del_val`` (a mutation overlay's (E,)
    tombstones) neutralizes deleted base edges' relax values, exactly
    absorbed by the min/max combiner."""
    if route is not None:
        src = expand.apply_expand(full_state, route[0], route[1])
    else:  # direct, or through the compact-gather mirror
        src = pull.gather_sources(arr, full_state)
    vals = prog.relax(src, arr.weights)
    if del_val is not None:
        vals = ovl.mask_deleted(vals, del_val, prog.reduce)
    acc = _seg_reduce(prog)(vals, arr.row_ptr, arr.head_flag, arr.dst_local,
                            method=method)
    new = _op(prog)(local, acc)
    return torch.where(arr.vtx_mask, new, local)


def sparse_prep(parr: PushArrays, q_vids):
    """One part's plan of the frontier walk: each queue entry's row (binary
    search over the part's unique sources), its out-edge count into this
    part, their inclusive prefix sum, and the total.  Returns (rows,
    counts, incl, total)."""
    u = parr.uniq_src.shape[0]
    idx = torch.searchsorted(parr.uniq_src, q_vids)
    idx_c = idx.clamp(0, u - 1)
    found = parr.uniq_src[idx_c] == q_vids
    starts = parr.csr_row_ptr[idx_c]
    ends = parr.csr_row_ptr[(idx + 1).clamp(0, u)]
    counts = torch.where(found, ends - starts, torch.zeros_like(starts))
    incl = torch.cumsum(counts, 0, dtype=torch.int32)
    return idx_c, counts, incl, incl[-1]


def _sparse_walk(prog, pspec: PushSpec, parr: PushArrays, nv_pad, q_vids,
                 q_vals, rows, incl, cap: Optional[int]):
    """The compacted out-edge walk both merge modes share: each slot of a
    ``cap``-sized buffer maps to a (queue entry, edge of that entry) pair
    and gathers (dst, candidate).  Returns (dst, cand, entry); invalid
    slots carry ``dst == nv_pad``, the drop slot."""
    j = torch.arange(cap or pspec.e_sp, dtype=torch.int32, device=q_vids.device)
    entry = torch.searchsorted(incl, j, right=True).clamp(0, q_vids.shape[0] - 1)
    prev = torch.where(entry > 0, incl[(entry - 1).clamp(min=0)], 0)
    within = j - prev
    e_max = parr.csr_dst_local.shape[0] - 1
    edge = (parr.csr_row_ptr[rows[entry]] + within).clamp(0, e_max)
    valid = j < incl[-1]
    dst = torch.where(valid, parr.csr_dst_local[edge], nv_pad)
    cand = prog.relax(q_vals[entry], parr.csr_weight[edge])
    return dst, cand, entry


def sparse_part_step(prog, pspec: PushSpec, parr: PushArrays, nv_pad, q_vids,
                     q_vals, rows, incl, local, cap: Optional[int] = None):
    """Push-mode BULK merge for ONE part: walk the frontier's out-edges
    into this part (a ``cap``-slot buffer, default the full e_sp tier) and
    scatter-combine them into the local slice in one pass.  The slice gets
    a spare slot at ``nv_pad`` that takes the invalid slots' writes."""
    dst, cand, _ = _sparse_walk(prog, pspec, parr, nv_pad, q_vids, q_vals,
                                rows, incl, cap)
    out = torch.cat([local, local.new_full(
        (1,), merge_tree.neutral(prog.reduce, local.dtype))])
    out.scatter_reduce_(0, dst.long(), cand.to(local.dtype),
                        reduce=_scatter_reduce(prog), include_self=True)
    return out[:nv_pad]


def sparse_part_step_tree(prog, pspec: PushSpec, parr: PushArrays, nv_pad,
                          q_vids, q_vals, rows, incl, local,
                          cap: Optional[int] = None):
    """Push-mode TREE merge for ONE part (ops/merge_tree.py): the same
    walk, but each SOURCE part's candidates scatter into their own
    neutral-initialized partial; the partials combine pairwise up the
    static tree and the root combines with the local slice.  Bitwise the
    bulk merge for min/max at any arity."""
    dst, cand, entry = _sparse_walk(prog, pspec, parr, nv_pad, q_vids,
                                    q_vals, rows, incl, cap)
    # the queue is P consecutive f_cap runs, one per source part
    blk = entry // pspec.f_cap
    num_blocks = q_vids.shape[0] // pspec.f_cap
    width = nv_pad + 1  # the spare slot again
    partials = torch.full((num_blocks, width),
                          merge_tree.neutral(prog.reduce, local.dtype),
                          dtype=local.dtype, device=local.device)
    partials.view(-1).scatter_reduce_(0, blk * width + dst.long(),
                                      cand.to(local.dtype),
                                      reduce=_scatter_reduce(prog),
                                      include_self=True)
    op = _op(prog)
    return op(local, merge_tree.tree_combine(partials[:, :nv_pad], op))


def _resolve_merge(merge: Optional[str]) -> str:
    """None reads engine/methods.merge_mode (LUX_MERGE_MODE, else bulk)."""
    m = methods.merge_mode() if merge is None else merge
    if m not in methods.MERGE_MODES:
        raise ValueError(f"merge must be one of {methods.MERGE_MODES}, got {m!r}")
    return m


def build_queue(pspec: PushSpec, global_vid, changed, values):
    """Exact compaction of ONE part's changed vertices into a (vid, value)
    queue of ``f_cap`` slots, in ascending local index.  Returns (q_vid,
    q_val, count); ``count`` may exceed f_cap (overflow: the queue keeps
    the first f_cap vertices and the next round must be dense).  The
    compaction is a prefix sum and a scatter (no host sync); vertices past
    f_cap write a spare slot that is dropped."""
    f_cap, dev = pspec.f_cap, changed.device
    changed_i = changed.to(torch.int32)
    count = changed_i.sum(dtype=torch.int32)
    pos = torch.cumsum(changed_i, 0, dtype=torch.int32) - 1
    slot = torch.where(changed & (pos < f_cap), pos, f_cap).long()
    loc = torch.zeros(f_cap + 1, dtype=torch.long, device=dev)
    loc.scatter_(0, slot, torch.arange(changed.shape[0], device=dev))
    loc = loc[:f_cap]
    in_q = torch.arange(f_cap, dtype=torch.int32, device=dev) < count
    q_vid = torch.where(in_q, global_vid[loc], SRC_SENTINEL)
    q_val = torch.where(in_q, values[loc], torch.zeros((), dtype=values.dtype,
                                                       device=dev))
    return q_vid, q_val, count


#: sp_work's ceiling: the reference's saturating uint32
SP_WORK_MAX = 0xFFFFFFFF


class PushCarry(NamedTuple):
    """The loop state.  Device tensors: ``state`` (P, V), the queues
    ``q_vid``/``q_val`` (P, f_cap), ``count`` (P,) and ``active`` (the
    changed-vertex total of the last round, 1 before the first; None
    after a distributed round, whose ranks sum it in the next round's
    all-reduce, :func:`settle_active`).  On a rank the stacked fields
    hold its k resident parts.  Host
    values: ``it``; ``edges``, the exact count of edges traversed (dense
    rounds walk every real edge, sparse rounds the frontier's out-edges);
    ``sp_work``, a tuple of P ints: the sparse-round out-edges walked per
    part since the driver last reset it, saturating at SP_WORK_MAX (the
    repartition policy's load signal; a dense round's work per part is
    ``dense_rounds`` times the part's edge count, derived from the cuts);
    ``dense_rounds``."""

    state: Any
    q_vid: Any
    q_val: Any
    count: Any
    it: int
    active: Any
    edges: int
    sp_work: tuple
    dense_rounds: int


class PushPlan(NamedTuple):
    """One iteration's LOAD phase: the flattened queues, each part's walk
    plan (P, P*f_cap), and the host's reading of the round: ``active``
    (the carry's), ``dense`` (direction), ``small`` (the small sparse tier
    fits), ``totals`` (each part's frontier out-edges, a tuple of ints) and
    ``sparse_edges`` (their sum)."""

    q_vids: Any
    q_vals: Any
    rows: Any
    incl: Any
    active: int
    dense: bool
    small: bool
    totals: tuple
    sparse_edges: int


def edges_total(edges) -> int:
    """The exact traversed-edge count as a Python int (the carry keeps it
    on the host already)."""
    return int(edges)


def _acc_load(sp_work: tuple, totals: tuple, dense: bool) -> tuple:
    """The window load stats' update: a sparse round adds each part's
    walked out-edges, saturating at SP_WORK_MAX (a wrapped counter would
    make the hottest part read cold and invert the recut); a dense round
    adds nothing here (its work derives from the cuts)."""
    if dense:
        return sp_work
    return tuple(min(w + t, SP_WORK_MAX) for w, t in zip(sp_work, totals))


def queues_of(pspec: PushSpec, arrays: ShardArrays, changed, values):
    """Every part's queue from a stacked changed mask: (q_vid, q_val,
    count), stacked (P, ...)."""
    queues = [build_queue(pspec, arrays.global_vid[p], changed[p], values[p])
              for p in range(values.shape[0])]
    return tuple(torch.stack(x) for x in zip(*queues))


def _init_carry(prog, pspec: PushSpec, arrays: ShardArrays) -> PushCarry:
    """Initial state + frontier queues (stacked (P, ...) layout)."""
    state0 = pull.init_state(prog, arrays)
    q_vid, q_val, cnt = queues_of(pspec, arrays, init_frontier(prog, arrays, state0),
                                  state0)
    one = torch.ones((), dtype=torch.int32, device=state0.device)
    return PushCarry(state0, q_vid, q_val, cnt, 0, one, 0,
                     (0,) * state0.shape[0], 0)


def init_frontier(prog, arrays: ShardArrays, state0):
    """The program's stacked initial active mask, real vertices only."""
    return torch.stack([
        prog.init_frontier(arrays.global_vid[p], state0[p], arrays.vtx_mask[p])
        & arrays.vtx_mask[p] for p in range(state0.shape[0])])


def _push_prep(pspec: PushSpec, spec: ShardSpec, parrays: PushArrays,
               c: PushCarry) -> PushPlan:
    """LOAD phase: flatten the queues, plan each part's sparse walk, and
    decide the round — direction, tier, whether anything is active — with
    ONE device-to-host copy."""
    P = spec.num_parts
    q_vids = c.q_vid.reshape(P * pspec.f_cap)
    q_vals = c.q_val.reshape(P * pspec.f_cap)
    preps = [sparse_prep(parrays.part(p), q_vids) for p in range(P)]
    rows = torch.stack([x[0] for x in preps])
    incl = torch.stack([x[2] for x in preps])
    totals = torch.stack([x[3] for x in preps])
    widest = totals.max()
    use_dense = ((c.count.sum(dtype=torch.int64) > spec.nv // pspec.pull_threshold_den)
                 | (c.count > pspec.f_cap).any() | (widest > pspec.e_sp))
    small = (widest <= pspec.e_sp_small) if pspec.e_sp_small else torch.zeros_like(use_dense)
    flags = torch.cat([torch.stack([c.active.to(torch.int64), use_dense.to(torch.int64),
                                    small.to(torch.int64)]), totals.to(torch.int64)])
    active, dense, fits, *parts = flags.tolist()  # the one host sync
    return PushPlan(q_vids, q_vals, rows, incl, active, bool(dense), bool(fits),
                    tuple(parts), sum(parts))


def _push_relax(prog, pspec: PushSpec, spec: ShardSpec, method, arrays,
                parrays, c: PushCarry, plan: PushPlan, routes=None,
                merge: str = "bulk", overlays=None):
    """COMP phase: the dense round (pull over all in-edges) or the sparse
    round (scatter the frontier's out-edges), part by part -> the new
    stacked state.  ``routes`` is one (static, arrays) expand plan per
    part for the dense rounds, or None.  ``overlays`` (one
    mutate.overlay.DeviceOverlay per part): dense rounds neutralize the
    tombstoned base edges, sparse rounds already skip them (the patched
    CSR), and the insert buffer is folded in once per round AFTER the
    branch, relaxing every live insert from the round's INPUT state —
    monotone-safe for min/max, and the empty slots drop."""
    V = spec.nv_pad
    full = c.state.reshape(spec.gathered_size)
    if plan.dense:
        new = torch.stack([
            dense_part_step(prog, arrays.part(p), full, c.state[p], method,
                            None if routes is None else routes[p],
                            None if overlays is None else overlays[p].del_val)
            for p in range(spec.num_parts)
        ])
    else:
        new = _sparse_all(prog, pspec, V, arrays.vtx_mask, parrays, c, plan, merge)
    if overlays is None:
        return new
    return torch.stack([ovl.delta_scatter(new[p], full, overlays[p], prog.relax,
                                          prog.reduce)
                        for p in range(spec.num_parts)])


def _sparse_all(prog, pspec: PushSpec, nv_pad: int, vtx_mask, parrays, c: PushCarry,
                plan: PushPlan, merge: str):
    """The sparse round over the carry's parts (every part on one device,
    or a rank's k resident parts): each part's walk of the whole queue,
    in the tier the plan chose, through the bulk or the tree merge."""
    step = sparse_part_step if merge == "bulk" else sparse_part_step_tree
    cap = pspec.e_sp_small if plan.small else pspec.e_sp
    return torch.stack([
        torch.where(vtx_mask[p],
                    step(prog, pspec, parrays.part(p), nv_pad, plan.q_vids, plan.q_vals,
                         plan.rows[p], plan.incl[p], c.state[p], cap),
                    c.state[p])
        for p in range(c.state.shape[0])
    ])


def _push_requeue(prog, pspec: PushSpec, spec: ShardSpec, arrays,
                  c: PushCarry, new, plan: PushPlan) -> PushCarry:
    """UPDATE phase: rebuild the queues from the changed vertices and
    account the traversed edges."""
    changed = (new != c.state) & arrays.vtx_mask
    q_vid, q_val, cnt = queues_of(pspec, arrays, changed, new)
    return PushCarry(new, q_vid, q_val, cnt, c.it + 1, cnt.sum(dtype=torch.int32),
                     _acc_edges(c.edges, spec.ne, plan),
                     _acc_load(c.sp_work, plan.totals, plan.dense),
                     c.dense_rounds + int(plan.dense))


def _acc_edges(edges: int, dense_ne: int, plan: PushPlan) -> int:
    """The exact traversed-edge count after one round: a dense round walks
    every real edge, a sparse one the frontier's out-edges."""
    return edges + (dense_ne if plan.dense else plan.sparse_edges)


def _push_iteration(prog, pspec, spec, method, arrays, parrays, c: PushCarry,
                    plan: PushPlan, routes=None, merge="bulk",
                    overlays=None) -> PushCarry:
    new = _push_relax(prog, pspec, spec, method, arrays, parrays, c, plan,
                      routes, merge, overlays)
    return _push_requeue(prog, pspec, spec, arrays, c, new, plan)


def _overlay_parts(overlay_static, oarrays, device, spec: ShardSpec):
    """The pairing guard and the overlay's one move to the device: an
    engine handed ``oarrays`` without ``overlay_static`` (or the reverse)
    would otherwise answer from the base graph under a caller who
    believes the churn applied."""
    if (overlay_static is None) != (oarrays is None):
        raise ValueError(
            "overlay_static and oarrays must be passed together: "
            "run_push_chunk(..., overlay_static=ostatic, oarrays=oarr)")
    if oarrays is None:
        return None
    return pull.overlay_parts((overlay_static, oarrays), device, spec)


def _check_expand(route) -> None:
    if route is not None and not isinstance(route[0], expand.ExpandStatic):
        raise ValueError(
            "the push engine's dense rounds route their gather only: pass "
            "an expand plan (ops/expand.plan_expand_shards, pf or not), "
            f"not a {type(route[0]).__name__}")


def _route_parts(route, device, num_parts: int):
    _check_expand(route)
    return pull._route_parts(route, device, num_parts)


def _resolve(prog, method, device) -> str:
    return methods.resolve_sum(method, prog.reduce, methods.default_platform(device))


def run_push_chunk(prog, pspec: PushSpec, spec: ShardSpec, arrays, parrays,
                   carry: PushCarry, it_stop: int, method: str = "auto",
                   route=None, merge: Optional[str] = None, overlay_static=None,
                   oarrays=None, telemetry=None):
    """Iterate from ``carry`` until nothing is active or ``it_stop``
    iterations have run in all (the reference's compiled chunk loop).
    ``arrays``/``parrays`` are tensors on the carry's device
    (:func:`push_init`); ``carry`` is left untouched, so one initial carry
    serves several runs.  One host sync per iteration.
    ``overlay_static``/``oarrays`` (mutate.overlay, passed together) run
    against the mutating graph; ``parrays`` is then the patched CSR of
    mutate.overlay.build_push_overlay.  ``telemetry`` (an
    ``obs.ring.new_ring("push")``) records each round's iteration,
    frontier size, traversed edges and direction from the round's one
    host read; the return becomes (carry, ring)."""
    dev = carry.state.device
    method = _resolve(prog, method, dev)
    merge = _resolve_merge(merge)
    routes = _route_parts(route, dev, spec.num_parts)
    overlays = _overlay_parts(overlay_static, oarrays, dev, spec)
    ring = telemetry
    c = carry
    while c.it < it_stop:
        plan = _push_prep(pspec, spec, parrays, c)
        if plan.active == 0:
            break
        if ring is not None:
            ring = obs_ring.ring_push(
                ring, c.it, plan.active,
                spec.ne if plan.dense else plan.sparse_edges, int(plan.dense))
        c = _push_iteration(prog, pspec, spec, method, arrays, parrays, c,
                            plan, routes, merge, overlays)
    return c if ring is None else (c, ring)


def push_phases(prog, pspec: PushSpec, spec: ShardSpec, method: str = "auto",
                merge: Optional[str] = None, device="cuda", overlay_static=None,
                oarrays=None):
    """One push iteration as THREE callables for the ``-verbose`` phase
    breakdown (the reference's loadTime/compTime/updateTime, its
    compile_push_phases):

      load(parrays, carry)                 -> plan (reads the round's flags)
      comp(arrays, parrays, carry, plan)   -> new stacked state
      update(arrays, carry, new, plan)     -> next PushCarry

    The caller fences between them; :func:`run_push_chunk` is the fast
    path.  ``overlay_static``/``oarrays`` as in run_push_chunk."""
    dev = resolve_device(device)
    method = _resolve(prog, method, dev)
    merge = _resolve_merge(merge)
    overlays = _overlay_parts(overlay_static, oarrays, dev, spec)

    def load(parrays, carry):
        return _push_prep(pspec, spec, parrays, carry)

    def comp(arrays, parrays, carry, plan):
        return _push_relax(prog, pspec, spec, method, arrays, parrays, carry,
                           plan, merge=merge, overlays=overlays)

    def update(arrays, carry, new, plan):
        return _push_requeue(prog, pspec, spec, arrays, carry, new, plan)

    return load, comp, update


def place(shards: PushShards, device="cuda"):
    """The layout's (arrays, parrays) as tensors on ``device``."""
    dev = resolve_device(device)
    return to_device(shards.arrays, dev), ps.to_device(shards.parrays, dev)


def push_init(prog, shards: PushShards, device="cuda"):
    """(arrays, parrays, carry0) on ``device`` for step-wise driving."""
    arrays, parrays = place(shards, device)
    return arrays, parrays, _init_carry(prog, shards.pspec, arrays)


def run_push(prog: PushProgram, shards: PushShards, max_iters: int = 10_000,
             method: str = "auto", route=None, merge: Optional[str] = None,
             device="cuda", telemetry=None):
    """Single-device driver: the direction-optimized loop to convergence
    (or ``max_iters``) on ``device``.  ``route`` (ops/expand
    .plan_expand_shards on the PULL layout, unfused or pass-fused, both
    bitwise equal) runs the dense rounds' gather through the routed
    expand.  ``merge`` ("bulk" | "tree", None = engine/methods.merge_mode)
    selects the sparse rounds' cross-part merge.  ``telemetry`` (an
    ``obs.ring.new_ring("push")`` on ``device``) as in run_push_chunk.
    Returns (final stacked state tensor, iterations, traversed edges as
    an int[, ring])."""
    arrays, parrays, carry0 = push_init(prog, shards, device)
    out = run_push_chunk(prog, shards.pspec, shards.spec, arrays, parrays,
                         carry0, max_iters, method, route, merge, telemetry=telemetry)
    if telemetry is None:
        return out.state, out.it, out.edges
    out, ring = out
    return out.state, out.it, out.edges, ring


# ---------------------------------------------------------------------------
# the distributed push: k = P / W resident parts a rank over torch.distributed
# ---------------------------------------------------------------------------

def _exchange_queues(c: PushCarry, pg, merge: str):
    """Every rank's (k, f_cap) queues, exchanged as ONE (k, 2, f_cap) int32
    block (vids and values' bits): the bulk all-gather flattens in rank
    order x resident order = global part order; the tree's staged rounds
    leave a rotated part order, which every consumer absorbs.  Returns
    the (P * f_cap,) vids and values."""
    from lux_tpu_torch.ops.merge_tree import staged_concat_gather
    from lux_tpu_torch.parallel.placement import halo_all_gather

    if c.q_val.element_size() != 4:
        raise ValueError(f"the distributed push exchanges 4-byte states, not "
                         f"{c.q_val.dtype}")
    pair = torch.stack([c.q_vid, c.q_val.view(torch.int32)], 1)
    if merge == "tree":
        got = staged_concat_gather(pair, pg)
    else:
        got = halo_all_gather(pair, pg).view(-1, 2, pair.shape[-1])
    return got[:, 0].reshape(-1), got[:, 1].reshape(-1).view(c.q_val.dtype)


def _spmd_push_prep(pspec: PushSpec, spec: ShardSpec, parrays: PushArrays, c: PushCarry,
                    pg, merge: str = "bulk") -> PushPlan:
    """LOAD phase on a rank: exchange the queues, plan each resident
    part's walk, and decide the round for every rank alike.  The global
    votes (frontier size, queue and edge-buffer overflows, the small-tier
    vote, the sparse edge total) are summed over the ranks in ONE
    all-reduce of an int64 vector, read on the host with this rank's
    per-part totals in one copy (parallel/dist.reduce_read); every branch
    is taken on those reduced values only.  ``c.active`` is None after a
    distributed round (the active count is then the queues' global
    count), else the replicated count it holds."""
    from lux_tpu_torch.parallel.dist import reduce_read

    q_vids, q_vals = _exchange_queues(c, pg, merge)
    k = c.state.shape[0]
    preps = [sparse_prep(parrays.part(j), q_vids) for j in range(k)]
    rows = torch.stack([x[0] for x in preps])
    incl = torch.stack([x[2] for x in preps])
    totals = torch.stack([x[3] for x in preps]).to(torch.int64)
    i64 = torch.int64
    shared = torch.stack([
        c.count.sum(dtype=i64), (c.count > pspec.f_cap).sum(dtype=i64),
        (totals > pspec.e_sp).sum(dtype=i64),
        (totals > pspec.e_sp_small).sum(dtype=i64) if pspec.e_sp_small
        else torch.zeros((), dtype=i64, device=totals.device),
        totals.sum()])
    local = totals if c.active is None else torch.cat([totals, c.active.reshape(1).to(i64)])
    (g_cnt, over, e_over, small_over, g_total), loc = reduce_read(pg, shared, local)
    dense = (g_cnt > spec.nv // pspec.pull_threshold_den) or over > 0 or e_over > 0
    small = bool(pspec.e_sp_small) and small_over == 0
    active = g_cnt if c.active is None else loc[k]
    return PushPlan(q_vids, q_vals, rows, incl, active, dense, small, tuple(loc[:k]),
                    g_total)


def _spmd_push_relax(prog, pspec: PushSpec, spec: ShardSpec, view, parrays,
                     c: PushCarry, plan: PushPlan, dense_fn, merge: str = "bulk"):
    """COMP phase on a rank: the engine's dense relaxation of the resident
    (k, V) block, or the sparse round over its resident parts."""
    if plan.dense:
        return dense_fn(c.state)
    return _sparse_all(prog, pspec, spec.nv_pad, view.vtx_mask, parrays, c, plan, merge)


def _spmd_push_requeue(prog, pspec: PushSpec, spec: ShardSpec, view, c: PushCarry,
                       new, plan: PushPlan) -> PushCarry:
    """UPDATE phase on a rank: the resident parts' queues and the edge and
    load accounting (the plan's edge total is already global); the active
    count is left to the next round's all-reduce (None)."""
    return _push_requeue(prog, pspec, spec, view, c, new, plan)._replace(active=None)


def _spmd_push_iter(prog, pspec: PushSpec, spec: ShardSpec, view, parrays, c: PushCarry,
                    plan: PushPlan, dense_fn, merge: str = "bulk") -> PushCarry:
    """ONE direction-optimized round on a rank, after its LOAD phase: the
    body every distributed engine shares (allgather, tree, ring, pallas,
    delta); only ``dense_fn(block) -> block`` differs."""
    new = _spmd_push_relax(prog, pspec, spec, view, parrays, c, plan, dense_fn, merge)
    return _spmd_push_requeue(prog, pspec, spec, view, c, new, plan)


def _allgather_dense_fn(prog, arrays: ShardArrays, pg, method: str, routes=None):
    """The allgather engines' dense round: the whole state gathered over
    the ranks, then each resident part's pull over its in-edges (its
    gather through ``routes[j]``, its placed expand plan, when given)."""
    from lux_tpu_torch.parallel.placement import halo_all_gather

    def dense_fn(block):
        full = halo_all_gather(block, pg)
        return torch.stack([dense_part_step(prog, arrays.part(j), full, block[j], method,
                                            route=None if routes is None else routes[j])
                            for j in range(block.shape[0])])

    return dense_fn


def settle_active(pg, c):
    """The carry (push or delta) with its ``active`` count summed over the
    ranks when a distributed round left it to the next all-reduce."""
    if c.active is not None:
        return c
    from lux_tpu_torch.parallel.dist import global_active

    live = getattr(c, "pending", None)
    local = (live if live is not None else c.count).sum(dtype=torch.int64)
    n = global_active(pg, local)
    return c._replace(active=torch.tensor(n, dtype=torch.int32, device=c.state.device))


def run_dist_chunk(prog, pspec: PushSpec, spec: ShardSpec, view, parrays,
                   carry: PushCarry, it_stop: int, pg, dense_fn,
                   merge: str = "bulk") -> PushCarry:
    """Distributed rounds from ``carry`` (this rank's k resident parts)
    until nothing is active anywhere or ``it_stop`` rounds have run in
    all; every rank takes the same branches.  ``view`` holds the resident
    parts' global_vid and vtx_mask; ``dense_fn`` is the engine's dense
    round.  Returns the carry with its active count settled over the
    ranks.  One host read a round (the prep's)."""
    c = carry
    while c.it < it_stop:
        plan = _spmd_push_prep(pspec, spec, parrays, c, pg, merge)
        if plan.active == 0:
            return c._replace(active=torch.zeros((), dtype=torch.int32,
                                                 device=c.state.device))
        c = _spmd_push_iter(prog, pspec, spec, view, parrays, c, plan, dense_fn, merge)
    return settle_active(pg, c)


def _check_parts(spec: ShardSpec, pg) -> None:
    if spec.num_parts != pg.num_parts:
        raise ValueError(f"the shards have {spec.num_parts} parts, the group "
                         f"{pg.num_parts}")


def push_init_dist(prog, shards: PushShards, pg):
    """This rank's (arrays, parrays, carry0) on its device: its k parts of
    the pull layout (the allgather dense rounds) and of the frontier CSR,
    and its parts' initial carry."""
    from lux_tpu_torch.parallel.mesh import shard_stacked

    _check_parts(shards.spec, pg)
    arrays = shard_stacked(pg, shards.arrays)
    parrays = shard_stacked(pg, shards.parrays)
    return arrays, parrays, _init_carry(prog, shards.pspec, arrays)


def shard_carry(pg, c: PushCarry) -> PushCarry:
    """This rank's parts of a stacked (P, ...) carry (host or device), on
    its device; the host fields and ``active`` (replicated) are kept."""
    from lux_tpu_torch.parallel.mesh import shard_stacked

    state, q_vid, q_val, count = (shard_stacked(pg, a)
                                  for a in (c.state, c.q_vid, c.q_val, c.count))
    sp = tuple(c.sp_work)
    sp = sp[pg.lo:pg.hi] if len(sp) == pg.num_parts else sp
    active = c.active if c.active is None else torch.as_tensor(c.active).to(pg.device)
    return c._replace(state=state, q_vid=q_vid, q_val=q_val, count=count, active=active,
                      sp_work=sp)


def assemble_carry(pg, c_local: PushCarry) -> PushCarry:
    """Every rank's resident carry stitched into the stacked (P, ...) one,
    on every rank (the inverse of :func:`shard_carry`): state, queues,
    counts and the window's per-part sp_work, with the active count
    settled."""
    from lux_tpu_torch.parallel.placement import halo_all_gather

    c = settle_active(pg, c_local)
    P = pg.num_parts

    def full(a):
        return halo_all_gather(a, pg).view((P,) + tuple(a.shape[1:]))

    counts, sp_work = gather_counts(pg, c)
    return c._replace(state=full(c.state), q_vid=full(c.q_vid), q_val=full(c.q_val),
                      count=torch.from_numpy(counts).to(c.count), sp_work=sp_work)


def gather_counts(pg, c: PushCarry):
    """Every part's queue count and window sp_work, from every rank's
    resident parts in one all-gather: ((P,) int64 host array, P-tuple)."""
    from lux_tpu_torch.parallel.placement import halo_all_gather

    ints = torch.stack([c.count.to(torch.int64),
                        torch.tensor(c.sp_work, dtype=torch.int64, device=c.count.device)], 1)
    got = halo_all_gather(ints, pg).view(pg.num_parts, 2).cpu()
    return got[:, 0].numpy(), tuple(got[:, 1].tolist())


def run_push_dist(prog: PushProgram, shards: PushShards, pg, max_iters: int = 10_000,
                  method: str = "auto", route=None, merge: Optional[str] = None):
    """Distributed driver over the ranks of ``pg`` (parallel.mesh
    .PartsGroup): the queues are exchanged every round (``merge="bulk"``:
    one all-gather; ``"tree"``: the staged rounds of ops/merge_tree), the
    whole state is all-gathered in dense rounds.  Bitwise the
    single-process :func:`run_push` at the same parts and method.
    ``shards`` is the whole layout (each rank places its own parts).
    Returns (this rank's final (k, V) block, iterations, traversed edges
    as an int)."""
    lay = place_layout(prog, shards, pg, method, route=route, merge=merge)
    out = lay.loop(lay.init(), max_iters)
    return out.state, out.it, out.edges


def compile_push_phases_dist(prog, pg, pspec: PushSpec, spec: ShardSpec,
                             method: str = "auto"):
    """One distributed push round as THREE callables for the ``-verbose``
    split on a rank (the reference's per-device load/comp/update):

      load(parrays, carry)               -> plan (queue exchange, walk
                                            plans, the reduced votes)
      comp(arrays, parrays, carry, plan) -> new (k, V) block (the dense
                                            rounds' state all-gather here)
      update(arrays, carry, new, plan)   -> next carry (its active count
                                            settled over the ranks)

    Their bodies are the fused engine's, so they compose to its result
    bit for bit.  Bulk merge, as in the reference."""
    method = _resolve(prog, method, pg.device)

    def load(parrays, carry):
        return _spmd_push_prep(pspec, spec, parrays, carry, pg, "bulk")

    def comp(arrays, parrays, carry, plan):
        return _spmd_push_relax(prog, pspec, spec, arrays, parrays, carry, plan,
                                _allgather_dense_fn(prog, arrays, pg, method))

    def update(arrays, carry, new, plan):
        return settle_active(pg, _spmd_push_requeue(prog, pspec, spec, arrays, carry,
                                                    new, plan))

    return load, comp, update


def _ring_dense_fn(prog, rarr, view, spec: ShardSpec, pg, method: str, plans=None):
    """The ring engine's dense round: the resident blocks go around the
    ranks (parallel/ring.ring_sweep); each arriving block's bucket of
    every resident part relaxes and folds (segment_reduce_by_ends) into
    the part's accumulator, so no rank holds the whole state.  ``plans``
    (parallel/ring.bucket_routes) routes each bucket's gather."""
    from lux_tpu_torch.parallel.ring import gather_bucket, neutral_like, ring_sweep

    V, k, op = spec.nv_pad, pg.k, _op(prog)

    def fold(s, acc, stream):
        first = (pg.rank + s) % pg.world * k  # global part of streamed lane 0
        out = []
        for i in range(k):
            a = acc[i]
            for j in range(k):
                q = first + j
                src = gather_bucket(stream[j], rarr.src_local[i, q], plans and plans[i][q])
                vals = prog.relax(src, rarr.weights[i, q])
                a = op(a, segment.segment_reduce_by_ends(
                    vals, rarr.head_flag[i, q], rarr.dst_local[i, q], V,
                    reduce=prog.reduce, method=method))
            out.append(a)
        return torch.stack(out)

    def dense_fn(block):
        acc = ring_sweep(block, neutral_like(block, prog.reduce), fold, pg)
        return torch.where(view.vtx_mask, op(block, acc.to(block.dtype)), block)

    return dense_fn


def place_ring_statics(shards, pg):
    """This rank's ring push statics on its device: its parts' buckets
    and frontier CSR (O(part edges)) and vertex view (O(V)), never the
    pull layout's O(E) arrays.  Returns (rarrays, parrays, view)."""
    from lux_tpu_torch.parallel.mesh import shard_stacked
    from lux_tpu_torch.parallel.ring import check_subset, vertex_view

    _check_parts(shards.spec, pg)
    check_subset(shards.parts_subset, pg)
    return (shard_stacked(pg, shards.rarrays), shard_stacked(pg, shards.parrays),
            vertex_view(pg, shards.arrays))


def ring_init_dist(prog, shards, pg):
    """(rarrays, parrays, view, carry0) of this rank for the ring push."""
    rarrays, parrays, view = place_ring_statics(shards, pg)
    return rarrays, parrays, view, _init_carry(prog, shards.pspec, view)


def run_push_ring(prog: PushProgram, shards, pg, max_iters: int = 10_000,
                  method: str = "auto", route=None, merge: Optional[str] = None):
    """Distributed push with the RING dense exchange
    (``shards``: parallel.ring.PushRingShards, all parts or this rank's
    subset): sparse rounds exchange the queues as :func:`run_push_dist`
    does, dense rounds stream the resident blocks around the ranks, so
    the per-rank state stays O(V).  Bitwise the single-process run.
    Returns (this rank's final (k, V) block, iterations, edges)."""
    lay = place_layout(prog, shards, pg, method, route=route, merge=merge)
    out = lay.loop(lay.init(), max_iters)
    return out.state, out.it, out.edges


# ---------------------------------------------------------------------------
# a layout placed on its device: the one window loop every driver runs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PushLayout:
    """A push layout's statics on the device and its window loop: every
    part stacked on one device (``pg`` None), or this rank's k resident
    parts of the allgather, ring or block-CSR layout (``exchange``).
    ``view`` holds the resident parts' global_vid, degree and vtx_mask
    (the carry reads them); ``arrays`` the pull rows of the allgather
    dense rounds (None on the ring and block-CSR layouts, which never
    place them); ``dense_fn`` a distributed engine's dense round;
    ``statics`` the ring's buckets or the block-CSR part."""

    prog: Any
    shards: Any
    pg: Any
    exchange: str
    method: str
    view: Any
    parrays: Any
    arrays: Any = None
    dense_fn: Any = None
    statics: Any = None
    route: Any = None
    merge: Optional[str] = None

    @property
    def rows(self) -> slice:
        """The stacked rows this process holds."""
        return slice(None) if self.pg is None else slice(self.pg.lo, self.pg.hi)

    @property
    def lead(self) -> bool:
        """Whether this process writes and reports: rank 0, or the only one."""
        return self.pg is None or self.pg.rank == 0

    def init(self) -> PushCarry:
        """The resident parts' initial carry."""
        return _init_carry(self.prog, self.shards.pspec, self.view)

    def loop(self, carry: PushCarry, it_stop: int) -> PushCarry:
        """Rounds from ``carry`` until nothing is active (anywhere) or
        ``it_stop`` rounds have run in all; under a group the carry comes
        back with its active count settled over the ranks."""
        sh = self.shards
        if self.pg is None:
            return run_push_chunk(self.prog, sh.pspec, sh.spec, self.arrays, self.parrays,
                                  carry, it_stop, self.method, self.route, self.merge)
        return run_dist_chunk(self.prog, sh.pspec, sh.spec, self.view, self.parrays, carry,
                              it_stop, self.pg, self.dense_fn, _resolve_merge(self.merge))

    def stack(self, block):
        """The stacked (P, V, ...) block of every part, on every rank (a
        collective under a group)."""
        if self.pg is None:
            return block
        from lux_tpu_torch.parallel.placement import halo_all_gather

        return halo_all_gather(block, self.pg).view((self.pg.num_parts,)
                                                    + tuple(block.shape[1:]))

    def full(self, carry: PushCarry) -> PushCarry:
        """The stacked (P, ...) carry of every part (assemble_carry under a
        group)."""
        return carry if self.pg is None else assemble_carry(self.pg, carry)

    def global_state(self, block):
        """The (nv,) global state, on every rank."""
        return self.shards.scatter_to_global(self.stack(block).cpu().numpy())

    def read(self, block):
        """The (nv,) global state on rank 0 (or the only process), None on
        the other ranks."""
        if self.pg is None:
            return self.shards.scatter_to_global(block.cpu().numpy())
        from lux_tpu_torch.parallel import multihost

        stacked = multihost.assemble_global(self.pg, block)
        return None if stacked is None else self.shards.scatter_to_global(stacked)

    def release(self) -> None:
        """Drop the device statics (a recut places the rebuilt layout only
        after the old one left the device); the layout is unusable after."""
        self.view = self.parrays = self.arrays = self.dense_fn = self.statics = None


def place_layout(prog, shards, pg=None, method: str = "auto", device="cuda", placed=None,
                 route=None, merge: Optional[str] = None) -> PushLayout:
    """``shards`` placed on the device, with its window loop: on
    ``device`` (``pg`` None; ``placed``: its (arrays, parrays) already
    there, ``route`` an expand plan for the dense rounds' gather), or this
    rank's parts over the ranks of ``pg`` with the dense round of the
    layout's kind: a PushShards all-gathers the state, a parallel.ring
    .PushRingShards streams it around the ring (``method`` scan or
    scatter), a parallel.pallas_dist.PushPallasShards reduces on the
    block-CSR kernel (one part a rank, min/max programs).  Under ``pg``,
    ``route`` is a stacked plan (all P rows or this rank's k): expand
    plans of the pull layout for the allgather, bucket plans
    (ops/expand.plan_ring_route_shards) for the ring; the block-CSR
    layout has none."""
    from lux_tpu_torch.parallel.pallas_dist import PushPallasShards
    from lux_tpu_torch.parallel.ring import PushRingShards

    if pg is None:
        if isinstance(shards, (PushRingShards, PushPallasShards)):
            raise ValueError("the ring and block-CSR push layouts run over a group of ranks")
        dev = resolve_device(device)
        arrays, parrays = placed if placed is not None else place(shards, dev)
        return PushLayout(prog, shards, None, "allgather", _resolve(prog, method, dev),
                          arrays, parrays, arrays=arrays, route=route, merge=merge)
    if route is not None and isinstance(shards, PushPallasShards):
        raise ValueError("the block-CSR push has its own dense gather and no routed form")
    if isinstance(shards, PushPallasShards):
        from lux_tpu_torch.parallel import pallas_dist

        if prog.reduce not in ("min", "max"):
            raise ValueError("pallas push drives min/max frontier programs; sum programs "
                             "use the pull engines")
        part, parrays, view = pallas_dist.push_pallas_statics(shards, pg)
        return PushLayout(prog, shards, pg, "pallas", "pallas", view, parrays,
                          dense_fn=pallas_dist.push_pallas_dense_fn(prog, shards, part, pg),
                          statics=part, merge=merge)
    if isinstance(shards, PushRingShards):
        from lux_tpu_torch.parallel.ring import resolve_bucketed

        from lux_tpu_torch.parallel.ring import bucket_routes

        method = resolve_bucketed(method, prog.reduce, pg.device)
        rarrays, parrays, view = place_ring_statics(shards, pg)
        plans = bucket_routes(pg, route)
        return PushLayout(prog, shards, pg, "ring", method, view, parrays,
                          dense_fn=_ring_dense_fn(prog, rarrays, view, shards.spec, pg, method,
                                                  plans),
                          statics=rarrays, route=plans, merge=merge)
    from lux_tpu_torch.parallel.mesh import resident_plans

    method = _resolve(prog, method, pg.device)
    arrays, parrays, _ = push_init_dist(prog, shards, pg)
    _check_expand(route)
    routes = resident_plans(pg, route)
    return PushLayout(prog, shards, pg, "allgather", method, arrays, parrays, arrays=arrays,
                      dense_fn=_allgather_dense_fn(prog, arrays, pg, method, routes),
                      route=routes, merge=merge)
