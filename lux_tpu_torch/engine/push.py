"""The push (frontier) execution engine with direction optimization, on
one device.

Counterpart of the single-device half of ``lux_tpu.engine.push``:

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

Not ported here: the flight-recorder ``telemetry`` loop and carry
donation; the distributed and ring push wait for the multi-GPU port.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Protocol

import torch

from lux_tpu_torch.engine import methods, pull
from lux_tpu_torch.graph import push_shards as ps
from lux_tpu_torch.graph.push_shards import SRC_SENTINEL, PushArrays, PushShards, PushSpec
from lux_tpu_torch.graph.shards import ShardArrays, ShardSpec, to_device
from lux_tpu_torch.mutate import overlay as ovl
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
    else:
        src = full_state.index_select(0, arr.src_pos)
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
    changed-vertex total of the last round, 1 before the first).  Host
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
        step = sparse_part_step if merge == "bulk" else sparse_part_step_tree
        cap = pspec.e_sp_small if plan.small else pspec.e_sp
        new = torch.stack([
            torch.where(arrays.vtx_mask[p],
                        step(prog, pspec, parrays.part(p), V, plan.q_vids,
                             plan.q_vals, plan.rows[p], plan.incl[p], c.state[p], cap),
                        c.state[p])
            for p in range(spec.num_parts)
        ])
    if overlays is None:
        return new
    return torch.stack([ovl.delta_scatter(new[p], full, overlays[p], prog.relax,
                                          prog.reduce)
                        for p in range(spec.num_parts)])


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


def _route_parts(route, device, num_parts: int):
    if route is not None and not isinstance(route[0], expand.ExpandStatic):
        raise ValueError(
            "the push engine's dense rounds route their gather only: pass "
            "an expand plan (ops/expand.plan_expand_shards, pf or not), "
            f"not a {type(route[0]).__name__}")
    return pull._route_parts(route, device, num_parts)


def _resolve(prog, method, device) -> str:
    return methods.resolve_sum(method, prog.reduce, methods.default_platform(device))


def run_push_chunk(prog, pspec: PushSpec, spec: ShardSpec, arrays, parrays,
                   carry: PushCarry, it_stop: int, method: str = "auto",
                   route=None, merge: Optional[str] = None, overlay_static=None,
                   oarrays=None) -> PushCarry:
    """Iterate from ``carry`` until nothing is active or ``it_stop``
    iterations have run in all (the reference's compiled chunk loop).
    ``arrays``/``parrays`` are tensors on the carry's device
    (:func:`push_init`); ``carry`` is left untouched, so one initial carry
    serves several runs.  One host sync per iteration.
    ``overlay_static``/``oarrays`` (mutate.overlay, passed together) run
    against the mutating graph; ``parrays`` is then the patched CSR of
    mutate.overlay.build_push_overlay."""
    dev = carry.state.device
    method = _resolve(prog, method, dev)
    merge = _resolve_merge(merge)
    routes = _route_parts(route, dev, spec.num_parts)
    overlays = _overlay_parts(overlay_static, oarrays, dev, spec)
    c = carry
    while c.it < it_stop:
        plan = _push_prep(pspec, spec, parrays, c)
        if plan.active == 0:
            break
        c = _push_iteration(prog, pspec, spec, method, arrays, parrays, c,
                            plan, routes, merge, overlays)
    return c


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
             device="cuda"):
    """Single-device driver: the direction-optimized loop to convergence
    (or ``max_iters``) on ``device``.  ``route`` (ops/expand
    .plan_expand_shards on the PULL layout, unfused or pass-fused, both
    bitwise equal) runs the dense rounds' gather through the routed
    expand.  ``merge`` ("bulk" | "tree", None = engine/methods.merge_mode)
    selects the sparse rounds' cross-part merge.  Returns (final stacked
    state tensor, iterations, traversed edges as an int)."""
    arrays, parrays, carry0 = push_init(prog, shards, device)
    out = run_push_chunk(prog, shards.pspec, shards.spec, arrays, parrays,
                         carry0, max_iters, method, route, merge)
    return out.state, out.it, out.edges
