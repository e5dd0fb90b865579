"""Memory preflight: the device-memory estimate an app prints before set-up.

Counterpart of ``lux_tpu.utils.preflight`` for one device: the estimate of
the graph arrays, the vertex state and the per-edge gathered values that a
run holds on the card, and a warning when it exceeds the card's memory.
The byte counts are this package's own arrays (``graph/shards.to_device``,
``graph/push_shards.to_device``, the block-CSR runners, the routed plans),
whose dtypes differ from the reference's TPU layouts in places: bool masks
are one byte, the sparse walk's entry index and the scatter method's
destination index are int64.  The tests pin each estimate to the ``nbytes``
of what the port builds.

The distributed engines (parallel/) are estimated per rank, against that
rank's device: the allgather pull's k resident parts plus the gathered
(P*V) state, the ring and reduce-scatter bucket layouts, the distributed
block-CSR pull, and the distributed push's ring and block-CSR layouts
(:func:`estimate_push_ring`, :func:`estimate_push_pallas`; the allgather
push is :func:`estimate_push` with :func:`push_exchange_bytes`).  The
2-D (parts x edge) grid's is :func:`estimate_edge2d`, the reference's
formula, and :func:`suggest_edge_shards` names the smallest edge-shard
count whose footprint fits, the hint :func:`check_fits` prints for a 1-D
pull layout that does not (the feature-sharded CF is the pull or ring
estimate at K/F columns).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from lux_tpu_torch.graph.push_shards import PushSpec
from lux_tpu_torch.ops.segment import sum_scratch_bytes
from lux_tpu_torch.graph.shards import ShardSpec


@dataclasses.dataclass
class MemoryEstimate:
    shard_bytes: int  # static graph arrays (and routed plans) on the device
    state_bytes: int  # vertex state (old + new) and the frontier buffers
    #: per-edge gathered values of one part (the LOAD phase's output; the
    #: concatenated state itself is a view on one device)
    gathered_bytes: int
    total_bytes: int

    def __str__(self):
        gib = 1 << 30
        return (
            f"per-device memory estimate: graph {self.shard_bytes/gib:.3f} GiB + "
            f"state {self.state_bytes/gib:.3f} GiB + "
            f"per-edge gather {self.gathered_bytes/gib:.3f} GiB = "
            f"{self.total_bytes/gib:.3f} GiB"
        )


def scale_residency(est: MemoryEstimate, k: int) -> MemoryEstimate:
    """The estimate with k parts RESIDENT on the device: the per-part
    graph arrays and state scale by k; the per-edge gather is one part's
    at a time (the engine runs the parts one after another) and does
    not."""
    if k <= 1:
        return est
    shard, state = est.shard_bytes * k, est.state_bytes * k
    return MemoryEstimate(shard, state, est.gathered_bytes,
                          shard + state + est.gathered_bytes)


def estimate_pull(spec: ShardSpec, state_width: int = 1,
                  state_dtype_bytes: int = 4, dst_state: bool = False,
                  method: str = "", device: str = "cpu",
                  reduce: str = "sum") -> MemoryEstimate:
    """One part of the pull engine: the ShardArrays (row_ptr, src_pos,
    dst_local, degree, global_vid int32; head_flag, edge_mask, vtx_mask
    bool; weights f32), the old and new state, and the per-edge gather
    (source values, and destination values when the program reads them).
    ``method="scatter"`` adds the int64 destination index its
    ``index_add_``/``scatter_reduce_`` takes; on a card (``device``
    "cuda") a sum takes the sorted-key kernel instead, whose span
    summaries (ops/segment.sum_scratch_bytes) and, for a 2-byte state,
    the values widened to f32 take the index's place."""
    V, E = spec.nv_pad, spec.e_pad
    shard = 4 * (V + 1) + 4 * E * 2 + E * 2 + V + 4 * V * 2 + 4 * E
    state = 2 * V * state_width * state_dtype_bytes
    gathered = E * state_width * state_dtype_bytes * (2 if dst_state else 1)
    if method == "scatter":
        if str(device).startswith("cuda") and reduce == "sum":
            gathered += sum_scratch_bytes(E, state_width)
            if state_dtype_bytes < 4:
                gathered += 4 * E * state_width
        else:
            gathered += 8 * E
    return MemoryEstimate(shard, state, gathered, shard + state + gathered)


def estimate_batched(spec: ShardSpec, q: int, method: str,
                     state_dtype_bytes: int = 4) -> MemoryEstimate:
    """One part of a batched serving iteration (serve/batched) with Q
    query lanes, for ``method`` as ``serve.batched.resolve_method`` picks
    it: the ShardArrays as in :func:`estimate_pull`; the (V, Q) state
    pair (the state and the iteration's new state); and the larger of the
    two peaks of the per-edge work:

    * the gather: the (E, Q) gathered source values and the (E, Q) edge
      values computed from them (a relax that copies, as SSSP's does);
    * the reduce, by method: the (E, Q) values plus the scan ladder's
      working copy and its (E - 1, Q) temporary and head flags (``scan``,
      and ``mxscan``, whose kernel is 1-D: (E, Q) values run the plain
      ladder), or its ends gather's three (V, Q) arrays; ``scatter``'s
      (V + 1, Q) output with its dump row and the int64 destination index
      twice (``long()`` then ``clamp``) — SSSP's min on either device and
      PPR's sum on the CPU; PPR's sum on a card takes the sorted-key
      kernel's (V, Q) output and span summaries, fewer bytes, so the one
      estimate holds for both apps on both devices; ``cumsum``'s prefix and its
      padded copy; ``mxsum``'s padded copy, the blocked products and
      their sum, and the 512 x 512 triangle (its ones and its tril).

    The tests pin the terms to the ``nbytes`` one batched iteration
    allocates on the CPU, and the estimate to its measured peak."""
    V, E, b = spec.nv_pad, spec.e_pad, state_dtype_bytes
    base = estimate_pull(spec, q, b)
    eq, vq = E * q * b, V * q * b
    gather = 2 * eq
    if method == "scatter":
        reduce = eq + (V + 1) * q * b + 16 * E
    elif method in ("scan", "mxscan"):
        reduce = max(3 * eq + E, 2 * eq + 3 * vq)
    elif method == "cumsum":
        reduce = 3 * eq + q * b + 16 * (V + 1)
    elif method == "mxsum":
        block = 512
        e_blk = -(-E // block) * block
        reduce = eq + 3 * e_blk * q * 4 + 2 * block * block * 4
    else:
        raise ValueError(f"estimate_batched: unknown method {method!r}")
    peak = max(gather, reduce)
    return MemoryEstimate(base.shard_bytes, base.state_bytes, peak,
                          base.shard_bytes + base.state_bytes + peak)


def routed_plan_bytes(plan) -> int:
    """Device bytes of a built routed plan, (static, arrays) with numpy or
    tensor arrays: the sum of its arrays' sizes (uint8 indices where the
    planner narrows them)."""
    return int(sum(a.nbytes for a in plan[1]))


def add_routed_bytes(est: MemoryEstimate, extra: int) -> MemoryEstimate:
    """The estimate with ``extra`` routed-plan bytes counted as graph
    (static, per-graph) bytes: the one place that arithmetic lives."""
    return MemoryEstimate(
        est.shard_bytes + extra, est.state_bytes, est.gathered_bytes,
        est.total_bytes + extra,
    )


def add_gathered_bytes(est: MemoryEstimate, extra: int) -> MemoryEstimate:
    """The estimate with ``extra`` exchange-buffer bytes (the gathered
    state of the distributed allgather) counted as gathered bytes."""
    return MemoryEstimate(est.shard_bytes, est.state_bytes, est.gathered_bytes + extra,
                          est.total_bytes + extra)


def estimate_ring(spec: ShardSpec, e_bucket_pad: int, state_width: int = 1,
                  state_dtype_bytes: int = 4) -> MemoryEstimate:
    """One resident part of the ring exchange (parallel/ring.py): its P
    buckets of edge-aligned arrays (src/dst int32, head bool, weight f32:
    13 B a slot; no (V+1) row_ptr a bucket), its vertex view (global_vid
    and degree int32, vtx_mask bool), and the resident block, the block in flight,
    the fold accumulator and the new state.  No nv-sized exchange
    buffer: that is the point of the ring."""
    Pn, V = spec.num_parts, spec.nv_pad
    shard = Pn * e_bucket_pad * 13 + V * 9
    blk = V * state_width * state_dtype_bytes
    state = 4 * blk
    return MemoryEstimate(shard, state, 0, shard + state)


def estimate_scatter(spec: ShardSpec, e_bucket_pad: int, state_width: int = 1,
                     state_dtype_bytes: int = 4) -> MemoryEstimate:
    """One resident part of the reduce-scatter exchange
    (parallel/scatter.py): the ring's bucket layout, the state and the
    new state, and the (P, V, ...) partials the collective consumes
    (reported as gathered bytes: the O(nv) term this exchange still
    pays)."""
    Pn, V = spec.num_parts, spec.nv_pad
    shard = Pn * e_bucket_pad * 13 + V * 9
    blk = V * state_width * state_dtype_bytes
    state = 2 * blk
    partials = Pn * blk
    return MemoryEstimate(shard, state, partials, shard + state + partials)


def add_routed(est: MemoryEstimate, plan) -> MemoryEstimate:
    """The estimate with a built routed plan's arrays counted in."""
    return add_routed_bytes(est, routed_plan_bytes(plan))


def routed_plan_bytes_analytic(spec: ShardSpec, mode: str = "expand",
                               wide: bool = False) -> int:
    """Routed-plan bytes from the shard GEOMETRY alone, before the plan is
    built: one index array per Benes pass of the space (uint8, or int32
    under LUX_ROUTE_IDX8=0), both routes of the expand (2 (2k - 1) passes
    over n), the fill-forward's lane index and mask byte (about 1.02 n);
    the fused modes add the second route over n2 = 2n, its group mask
    (fused-mx: a rank tile of the index width) and the pre-routed f32
    weights, and the slot route's int32 per edge slot.
    ``wide`` adds the destination route of a wide program (CF).  The
    fill-forward's size depends on the graph, so this is an estimate
    (the tests hold it to the built plan's bytes)."""
    from lux_tpu_torch.ops.expand import _idx8_enabled, _next_pow2
    from lux_tpu_torch.ops.route import factor_digits

    idx = 1 if _idx8_enabled() else 4

    def expand_cost(n):
        k = len(factor_digits(n))
        return 2 * (2 * k - 1) * n * idx + int(1.02 * n) * (idx + 1)

    mx = mode == "fused-mx"
    if mode.endswith(("-pf", "-mx")):
        mode = mode[:-3]
    n = max(_next_pow2(spec.e_pad), _next_pow2(spec.gathered_size), 128)
    b = expand_cost(n)
    if wide:
        b += expand_cost(max(_next_pow2(spec.e_pad), _next_pow2(spec.nv_pad), 128))
    if mode == "fused":
        n2 = 2 * n
        k2 = len(factor_digits(n2))
        b += (2 * k2 - 1) * n2 * idx + n2 * ((idx if mx else 1) + 4)
        b += 4 * spec.e_pad
    return b


def routed_bucket_plan_bytes_analytic(num_buckets: int, e_bucket_pad: int,
                                      state_size: int) -> int:
    """Bucket-plan bytes of ONE resident part of the bucketed routed
    exchanges, from the geometry alone: ``num_buckets`` expand plans (the
    ring and reduce-scatter: one a peer part, P; an edge2d cell: 1), each
    over n_b = pow2(max(e_bucket_pad, state_size)).  Not the allgather
    geometry: a skewed graph's padded bucket can make P * n_b far exceed
    e_pad, and the plans do not shrink with the streamed block."""
    from lux_tpu_torch.ops.expand import _idx8_enabled, _next_pow2
    from lux_tpu_torch.ops.route import factor_digits

    idx = 1 if _idx8_enabled() else 4
    n_b = max(_next_pow2(e_bucket_pad), _next_pow2(state_size), 128)
    k = len(factor_digits(n_b))
    per_plan = 2 * (2 * k - 1) * n_b * idx + int(1.02 * n_b) * (idx + 1)
    return num_buckets * per_plan


def estimate_push(spec: ShardSpec, pspec: PushSpec,
                  state_dtype_bytes: int = 4) -> MemoryEstimate:
    """One part of the push engine: the pull layout of the dense rounds
    plus the frontier CSR (uniq_src, csr_row_ptr, csr_dst_local int32;
    csr_weight f32); the state and the (vid, value) queues of f_cap
    slots, each old and new; the sparse walk's buffer of e_sp slots
    (destination and candidate, 4 bytes each, and the int64 queue entry
    from ``torch.searchsorted``)."""
    base = estimate_pull(spec, 1, state_dtype_bytes)
    U, E, F = pspec.u_pad, spec.e_pad, pspec.f_cap
    extra = 4 * U + 4 * (U + 1) + 4 * E + 4 * E
    queues = 2 * (4 + state_dtype_bytes) * F
    sparse_buf = (4 + state_dtype_bytes + 8) * pspec.e_sp
    return MemoryEstimate(
        base.shard_bytes + extra,
        base.state_bytes + queues + sparse_buf,
        base.gathered_bytes,
        base.total_bytes + extra + queues + sparse_buf,
    )


def push_exchange_bytes(spec: ShardSpec, pspec: PushSpec,
                        state_dtype_bytes: int = 4) -> int:
    """A rank's exchanged frontier queues in the distributed push: the
    gathered (P, 2, f_cap) block of every part's vids and values, and
    the flattened (P * f_cap,) vids and values the walk reads."""
    return 2 * spec.num_parts * pspec.f_cap * (4 + state_dtype_bytes)


def _frontier_csr_bytes(spec: ShardSpec, pspec: PushSpec) -> int:
    """One part's frontier CSR: uniq_src, csr_row_ptr, csr_dst_local int32
    and csr_weight f32."""
    U, E = pspec.u_pad, spec.e_pad
    return 4 * U + 4 * (U + 1) + 4 * E + 4 * E


def _push_part_state(pspec: PushSpec, blocks: int, nv_pad: int,
                     state_dtype_bytes: int) -> int:
    """One part's state ``blocks`` times, its queues old and new, and the
    sparse walk's buffer (as :func:`estimate_push` counts them)."""
    s = state_dtype_bytes
    return (blocks * nv_pad * s + 2 * (4 + s) * pspec.f_cap
            + (4 + s + 8) * pspec.e_sp)


def estimate_push_ring(spec: ShardSpec, pspec: PushSpec, e_bucket_pad: int,
                       state_dtype_bytes: int = 4) -> MemoryEstimate:
    """One resident part of the ring push (engine/push.run_push_ring): the
    frontier CSR, the part's P ring buckets (13 B a slot) and its vertex
    view (global_vid, degree int32, vtx_mask bool), as the reference
    counts them; the resident block, the block in flight, the fold
    accumulator and the new state, the queues and the sparse buffer; and
    the rank's exchanged queues (:func:`push_exchange_bytes`, as gathered
    bytes).  No O(E) pull arrays and no gathered state: dense rounds
    stream the blocks."""
    V = spec.nv_pad
    shard = (_frontier_csr_bytes(spec, pspec) + spec.num_parts * e_bucket_pad * 13
             + V * 9)
    state = _push_part_state(pspec, 4, V, state_dtype_bytes)
    gathered = push_exchange_bytes(spec, pspec, state_dtype_bytes)
    return MemoryEstimate(shard, state, gathered, shard + state + gathered)


def estimate_push_pallas(spec: ShardSpec, pspec: PushSpec, num_chunks: int, t_chunk: int,
                         state_dtype_bytes: int = 4) -> MemoryEstimate:
    """The one part of a rank of the block-CSR push
    (parallel/pallas_dist.run_push_pallas_dist): the (C, T) e_src_pos and
    e_dst_rel int32, the slot weights f32 (a 4-byte placeholder
    unweighted), chunk_block and chunk_first int32, the frontier CSR and
    the vertex view; the state and the new state, the queues and the
    sparse buffer; the gathered (P*V) state, the (C, T) slot values the
    kernel reduces, and the exchanged queues."""
    V, ct = spec.nv_pad, num_chunks * t_chunk
    blockcsr = 4 * ct * 2 + (4 * ct if spec.weighted else 4) + 4 * num_chunks * 2
    shard = blockcsr + _frontier_csr_bytes(spec, pspec) + V * 9
    state = _push_part_state(pspec, 2, V, state_dtype_bytes)
    gathered = (spec.gathered_size * state_dtype_bytes + ct * state_dtype_bytes
                + push_exchange_bytes(spec, pspec, state_dtype_bytes))
    return MemoryEstimate(shard, state, gathered, shard + state + gathered)


def estimate_pallas_pull(num_chunks: int, t_chunk: int, nv_pad: int,
                         state_width: int = 1, weighted: bool = False,
                         degree: bool = True, dst_state: bool = False,
                         state_dtype_bytes: int = 4) -> MemoryEstimate:
    """The single-device block-CSR runners (models/pagerank and
    models/colfilter .make_pallas_runner): the (C, T) e_src_pos and
    e_dst_rel int32, the slot weights f32 when ``weighted``, chunk_block
    and chunk_first int32, the int32 out-degrees when ``degree``, and
    with ``dst_state`` (CF) each slot's int32 destination row; the state
    and the new state of the apply; the (C, T, K) gathered slot values,
    twice with ``dst_state`` (source and destination rows)."""
    ct = num_chunks * t_chunk
    shard = 4 * ct * 2 + (4 * ct if weighted else 0) + 4 * num_chunks * 2
    if degree:
        shard += 4 * nv_pad
    if dst_state:
        shard += 4 * ct
    state = 2 * nv_pad * state_width * state_dtype_bytes
    gathered = ct * state_width * state_dtype_bytes * (2 if dst_state else 1)
    return MemoryEstimate(shard, state, gathered, shard + state + gathered)


def device_memory_bytes(device) -> Optional[int]:
    """The card's memory (``torch.cuda.get_device_properties``), or None
    off a card."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(dev).total_memory)


def estimate_edge2d(spec: ShardSpec, e2_pad: int, state_width: int = 1,
                    state_dtype_bytes: int = 4) -> MemoryEstimate:
    """One rank of the 2-D (parts x edge) grid: one edge chunk (src_pos,
    dst_local int32, head_flag bool, weights f32: 13 B a slot), the part's
    vertex view and state, plus the all-gathered whole state (edge
    sharding splits the EDGE arrays; the state is still gathered on every
    rank)."""
    V = spec.nv_pad
    shard = e2_pad * 13 + V * 9
    blk = V * state_width * state_dtype_bytes
    state = 3 * blk  # local + new + combined accumulator
    gathered = spec.gathered_size * state_width * state_dtype_bytes
    return MemoryEstimate(shard, state, gathered, shard + state + gathered)


def suggest_edge_shards(spec: ShardSpec, hbm_bytes: int, state_width: int = 1,
                        state_dtype_bytes: int = 4, max_shards: int = 64) -> Optional[int]:
    """The smallest edge-shard count EP >= 2 whose 2-D per-rank footprint
    fits ``hbm_bytes``, or None when no EP <= ``max_shards`` does (the
    gathered state is the floor: edge sharding divides only the edge
    arrays).  Pass the run's state width and dtype; cap ``max_shards`` at
    ranks // num_parts (edge2d keeps one part a part row)."""
    from lux_tpu_torch.graph.shards import edge2d_chunk_pad

    for ep in range(2, max_shards + 1):
        # e_pad >= the builder's raw per-part maximum, so a suggested EP fits
        e2 = edge2d_chunk_pad(spec.e_pad, ep)
        if estimate_edge2d(spec, e2, state_width, state_dtype_bytes).total_bytes <= hbm_bytes:
            return ep
    return None


def check_fits(est: MemoryEstimate, hbm_bytes: Optional[int] = None,
               device=None, spec: Optional[ShardSpec] = None, state_width: int = 1,
               state_dtype_bytes: int = 4, max_edge_shards: int = 0) -> bool:
    """Warn (returns False) when the estimate exceeds the device memory:
    ``hbm_bytes`` when given, else the memory of ``device`` when it is a
    card.  Off a card with no ``hbm_bytes`` there is nothing to hold the
    estimate to: it says so and returns True.  With ``spec`` (a 1-D pull
    layout) the warning names the smallest --edge-shards that would fit
    (:func:`suggest_edge_shards`, capped at ``max_edge_shards``: ranks //
    parts), as the reference's does."""
    if hbm_bytes is None and device is not None:
        hbm_bytes = device_memory_bytes(device)
    if hbm_bytes is None:
        print("# memory check skipped: no device memory size off a card "
              "(pass hbm_bytes)")
        return True
    if est.total_bytes > hbm_bytes:
        hint = "spread the parts over more ranks (--distributed), or use --exchange ring"
        if spec is not None and max_edge_shards >= 2:
            ep = suggest_edge_shards(spec, hbm_bytes, state_width, state_dtype_bytes,
                                     max_shards=max_edge_shards)
            if ep is not None:
                hint = (f"spread the parts over more ranks, or split the edge arrays "
                        f"with --distributed --edge-shards {ep}")
        print(
            f"WARNING: estimated {est.total_bytes/(1<<30):.2f} GiB exceeds "
            f"device memory {hbm_bytes/(1<<30):.2f} GiB — {hint}"
        )
        return False
    return True
