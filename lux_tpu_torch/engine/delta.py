"""Delta-stepping weighted SSSP: bucketed priority frontiers.

Counterpart of ``lux_tpu.engine.delta``.  The
chaotic weighted SSSP (models/sssp.WeightedSSSPProgram on the plain push
engine) expands every improved vertex at once, so a vertex whose tentative
distance later improves is expanded again.  Delta-stepping (Meyer &
Sanders 2003) processes vertices in distance buckets of width Δ: only
pending vertices with ``dist < thr`` (the current bucket) expand; improved
vertices park in ``pending`` until their bucket opens, so most expand once,
with their final distance.

Every round expands through the push engine's own bodies
(``push._push_prep`` / ``push._push_relax``, via a synthesized PushCarry),
with the threshold's advance in front of them: when the current bucket is
empty the threshold jumps past the smallest pending distance in the same
round, computed on the device.  The round's one host read is the push
engine's, which here carries the pending count (the stop test) beside the
direction, the tier and the per-part out-edge totals.  A dense expansion
round relaxes every edge, which is still exact (min-relaxation is
monotone), and clears ALL pending work.  Rounds, traversed edges and state
are bitwise the reference's.

The distributed driver (``run_push_delta_dist``) runs the same rounds
on each rank's k resident parts.  The bucket-occupancy vote is a sum and
the threshold's jump a min, so each rank's (in-bucket count, smallest
pending distance, pending count) cross in ONE all-gather and every rank
folds them alike; the expansion is then the distributed push engine's
own round (exchange, one all-reduce of the votes, the dense or sparse
step) through a synthesized PushCarry.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from lux_tpu_torch.engine import pull, push
from lux_tpu_torch.graph.push_shards import PushShards, PushSpec
from lux_tpu_torch.graph.shards import ShardSpec


class DeltaCarry(NamedTuple):
    """Device tensors: ``state`` (P, V) tentative distances, ``pending``
    (P, V) bool (improved but not yet expanded), ``thr`` the int32 scalar
    EXCLUSIVE upper bound of the current bucket, ``active`` the int32
    pending count (0 = converged; None after a distributed round, summed
    over the ranks by push.settle_active).  Host ints: ``it`` the expansion
    rounds run (advances are fused into them), ``edges`` the exact
    traversed-edge count, ``dense_rounds``."""

    state: Any
    pending: Any
    thr: Any
    it: int
    active: Any
    edges: int
    dense_rounds: int = 0


def _count(mask) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


def _init_carry(prog, arrays, delta: int) -> DeltaCarry:
    state0 = pull.init_state(prog, arrays)
    pending0 = push.init_frontier(prog, arrays, state0)
    thr = torch.tensor(delta, dtype=torch.int32, device=state0.device)
    return DeltaCarry(state0, pending0, thr, 0, _count(pending0), 0)


def _advanced_thr(prog, delta: int, c: DeltaCarry, n_in, min_pend=None):
    """The bucket threshold for THIS round: unchanged while the current
    bucket still has pending work; otherwise past the smallest pending
    distance (skipping empty buckets in one hop).  int32 floor division,
    wrapping like the reference's on overflow."""
    if min_pend is None:
        inf = torch.tensor(prog.inf, dtype=c.state.dtype, device=c.state.device)
        min_pend = torch.where(c.pending, c.state, inf).min()
    jumped = (torch.div(min_pend, delta, rounding_mode="floor") + 1) * delta
    return torch.where(n_in > 0, c.thr, jumped.to(torch.int32))


def _delta_prep(prog, pspec: PushSpec, spec: ShardSpec, delta: int, arrays,
                parrays, c: DeltaCarry):
    """The round's LOAD phase: the advanced threshold, the bucket, its
    queues, and the push engine's plan of them (with the ONE host read,
    which carries the pending count as the plan's ``active``).  Returns
    (thr, in_bucket, tmp PushCarry, plan)."""
    in_bucket = c.pending & (c.state < c.thr)
    thr = _advanced_thr(prog, delta, c, _count(in_bucket))
    # recomputed under the (possibly advanced) threshold: non-empty
    # whenever any work is pending, so every round expands
    in_bucket = c.pending & (c.state < thr)
    q_vid, q_val, cnt = push.queues_of(pspec, arrays, in_bucket, c.state)
    tmp = push.PushCarry(c.state, q_vid, q_val, cnt, 0, c.active, 0,
                         (0,) * spec.num_parts, 0)
    return thr, in_bucket, tmp, push._push_prep(pspec, spec, parrays, tmp)


def _delta_iteration(prog, pspec: PushSpec, spec: ShardSpec, method, arrays,
                     parrays, c: DeltaCarry, thr, in_bucket, tmp, plan,
                     routes=None) -> DeltaCarry:
    new = push._push_relax(prog, pspec, spec, method, arrays, parrays, tmp,
                           plan, routes)
    changed = (new != c.state) & arrays.vtx_mask
    # sparse rounds expand exactly the bucket; a dense round relaxes every
    # source, so EVERYTHING pending counts as expanded
    kept = torch.zeros_like(c.pending) if plan.dense else c.pending & ~in_bucket
    pending = kept | changed
    return DeltaCarry(new, pending, thr, c.it + 1, _count(pending),
                      push._acc_edges(c.edges, spec.ne, plan),
                      c.dense_rounds + int(plan.dense))


def _validate(prog, delta: int) -> None:
    """The driver-entry guards."""
    if delta <= 0:
        raise ValueError(f"delta must be positive, got {delta}")
    if prog.reduce != "min":
        raise ValueError("delta-stepping is a min-relaxation driver")


def run_delta_chunk(prog, pspec: PushSpec, spec: ShardSpec, delta: int, arrays,
                    parrays, carry: DeltaCarry, it_stop: int, method: str = "auto",
                    route=None) -> DeltaCarry:
    """Delta rounds from ``carry`` until nothing is pending or ``it_stop``
    rounds have run in all (the reference's compiled loop with its stop
    as an argument).  ``arrays``/``parrays`` are tensors on the carry's
    device (push.push_init); ``carry`` is left untouched.  One host sync
    per round."""
    _validate(prog, delta)
    dev = carry.state.device
    method = push._resolve(prog, method, dev)
    routes = push._route_parts(route, dev, spec.num_parts)
    c = carry
    while c.it < it_stop:
        thr, in_bucket, tmp, plan = _delta_prep(prog, pspec, spec, delta, arrays,
                                                parrays, c)
        if plan.active == 0:
            break
        c = _delta_iteration(prog, pspec, spec, method, arrays, parrays, c, thr,
                             in_bucket, tmp, plan, routes)
    return c


def delta_init(prog, shards: PushShards, delta: int, device="cuda"):
    """(arrays, parrays, carry0) on ``device`` for step-wise driving."""
    arrays, parrays = push.place(shards, device)
    return arrays, parrays, _init_carry(prog, arrays, delta)


def run_push_delta(prog, shards: PushShards, delta: int, max_iters: int = 100_000,
                   method: str = "auto", route=None, device="cuda"):
    """Single-device delta-stepping driver (min-reduce programs) on
    ``device``.  Returns (final stacked state tensor, rounds run,
    traversed edges as an int).  ``delta`` is the bucket width in
    distance units: small Δ approaches Dijkstra (fewest edge relaxations,
    most rounds), large Δ the chaotic engine (fewest rounds, most edges).
    ``route`` (an expand plan on the pull layout) routes the dense
    rounds' gather, bitwise equal."""
    _validate(prog, delta)
    arrays, parrays, c0 = delta_init(prog, shards, delta, device)
    out = run_delta_chunk(prog, shards.pspec, shards.spec, delta, arrays, parrays,
                          c0, max_iters, method, route)
    return out.state, out.it, out.edges


def _spmd_delta_prep(prog, pspec: PushSpec, spec: ShardSpec, delta: int, view, parrays,
                     c: DeltaCarry, pg):
    """The distributed round's LOAD phase: the global bucket vote, the
    threshold (jumped past the global smallest pending distance when the
    bucket is empty everywhere) and the global pending count from one
    all-gather of (in-bucket, smallest pending, pending) a rank; then
    the bucket's queues and the push engine's distributed plan of them,
    whose ``active`` is the global pending count.  Returns (thr,
    in_bucket, tmp PushCarry, plan)."""
    from lux_tpu_torch.parallel.dist import gather_small

    dev = c.state.device
    in_bucket = c.pending & (c.state < c.thr)
    inf = torch.tensor(prog.inf, dtype=c.state.dtype, device=dev)
    local_min = torch.where(c.pending, c.state, inf).min()
    i64 = torch.int64
    votes = gather_small(pg, torch.stack([_count(in_bucket).to(i64), local_min.to(i64),
                                          c.pending.sum(dtype=i64)])).to(dev)
    n_in, min_pend = votes[:, 0].sum(), votes[:, 1].min().to(c.state.dtype)
    thr = _advanced_thr(prog, delta, c, n_in, min_pend)
    in_bucket = c.pending & (c.state < thr)
    q_vid, q_val, cnt = push.queues_of(pspec, view, in_bucket, c.state)
    pending = votes[:, 2].sum().to(torch.int32)
    tmp = push.PushCarry(c.state, q_vid, q_val, cnt, 0, pending, 0,
                         (0,) * c.state.shape[0], 0)
    return thr, in_bucket, tmp, push._spmd_push_prep(pspec, spec, parrays, tmp, pg)


def run_delta_dist_chunk(prog, pspec: PushSpec, spec: ShardSpec, delta: int, arrays,
                         parrays, carry: DeltaCarry, it_stop: int, pg,
                         method: str = "auto") -> DeltaCarry:
    """Distributed delta rounds from ``carry`` (this rank's k resident
    parts; ``arrays`` its pull layout rows for the allgather dense
    rounds) until nothing is pending anywhere or ``it_stop`` rounds have
    run.  Returns the carry with its pending count settled over the
    ranks."""
    _validate(prog, delta)
    method = push._resolve(prog, method, pg.device)
    dense_fn = push._allgather_dense_fn(prog, arrays, pg, method)
    c = carry
    while c.it < it_stop:
        thr, in_bucket, tmp, plan = _spmd_delta_prep(prog, pspec, spec, delta, arrays,
                                                     parrays, c, pg)
        if plan.active == 0:
            return c._replace(active=torch.zeros((), dtype=torch.int32,
                                                 device=c.state.device))
        new = push._spmd_push_relax(prog, pspec, spec, arrays, parrays, tmp, plan, dense_fn)
        changed = (new != c.state) & arrays.vtx_mask
        kept = torch.zeros_like(c.pending) if plan.dense else c.pending & ~in_bucket
        c = DeltaCarry(new, kept | changed, thr, c.it + 1, None,
                       push._acc_edges(c.edges, spec.ne, plan),
                       c.dense_rounds + int(plan.dense))
    return push.settle_active(pg, c)


def delta_init_dist(prog, shards: PushShards, delta: int, pg):
    """This rank's (arrays, parrays, carry0) for the distributed delta."""
    arrays, parrays, _ = push.push_init_dist(prog, shards, pg)
    return arrays, parrays, _init_carry(prog, arrays, delta)


def init_on(lay, delta: int) -> DeltaCarry:
    """The initial delta carry of a placed push.PushLayout (allgather),
    its pending count summed over the ranks under a group."""
    c = _init_carry(lay.prog, lay.view, delta)
    return c if lay.pg is None else push.settle_active(lay.pg, c._replace(active=None))


def run_window(lay, delta: int, carry: DeltaCarry, it_stop: int) -> DeltaCarry:
    """Delta rounds from ``carry`` on a placed push.PushLayout
    (allgather) until nothing is pending or ``it_stop``: the
    single-device loop with the layout's route, or the distributed one."""
    sh = lay.shards
    if lay.pg is None:
        return run_delta_chunk(lay.prog, sh.pspec, sh.spec, delta, lay.arrays, lay.parrays,
                               carry, it_stop, lay.method, lay.route)
    return run_delta_dist_chunk(lay.prog, sh.pspec, sh.spec, delta, lay.arrays, lay.parrays,
                                carry, it_stop, lay.pg, lay.method)


def run_push_delta_dist(prog, shards: PushShards, delta: int, pg,
                        max_iters: int = 100_000, method: str = "auto"):
    """Distributed delta-stepping over the ranks of ``pg`` (k resident
    parts a rank): the single-device bucket discipline with the bucket
    vote and the threshold's jump from one all-gather a round.  Returns
    (this rank's final (k, V) block, rounds run, traversed edges)."""
    _validate(prog, delta)
    arrays, parrays, c0 = delta_init_dist(prog, shards, delta, pg)
    out = run_delta_dist_chunk(prog, shards.pspec, shards.spec, delta, arrays, parrays, c0,
                               max_iters, pg, method)
    return out.state, out.it, out.edges
