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

The ring, scatter, 2-D edge, feature-sharded and distributed block-CSR
estimates come with multi-GPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from lux_tpu_torch.graph.push_shards import PushSpec
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
                  method: str = "") -> MemoryEstimate:
    """One part of the pull engine: the ShardArrays (row_ptr, src_pos,
    dst_local, degree, global_vid int32; head_flag, edge_mask, vtx_mask
    bool; weights f32), the old and new state, and the per-edge gather
    (source values, and destination values when the program reads them).
    ``method="scatter"`` adds the int64 destination index its
    ``index_add_``/``scatter_reduce_`` takes."""
    V, E = spec.nv_pad, spec.e_pad
    shard = 4 * (V + 1) + 4 * E * 2 + E * 2 + V + 4 * V * 2 + 4 * E
    state = 2 * V * state_width * state_dtype_bytes
    gathered = E * state_width * state_dtype_bytes * (2 if dst_state else 1)
    if method == "scatter":
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
      twice (``long()`` then ``clamp``); ``cumsum``'s prefix and its
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


def check_fits(est: MemoryEstimate, hbm_bytes: Optional[int] = None,
               device=None) -> bool:
    """Warn (returns False) when the estimate exceeds the device memory:
    ``hbm_bytes`` when given, else the memory of ``device`` when it is a
    card.  Off a card with no ``hbm_bytes`` there is nothing to hold the
    estimate to: it says so and returns True."""
    if hbm_bytes is None and device is not None:
        hbm_bytes = device_memory_bytes(device)
    if hbm_bytes is None:
        print("# memory check skipped: no device memory size off a card "
              "(pass hbm_bytes)")
        return True
    if est.total_bytes > hbm_bytes:
        print(
            f"WARNING: estimated {est.total_bytes/(1<<30):.2f} GiB exceeds "
            f"device memory {hbm_bytes/(1<<30):.2f} GiB — increase num_parts "
            "(multi-GPU runs are not ported yet)"
        )
        return False
    return True
