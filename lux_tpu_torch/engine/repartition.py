"""Adaptive dynamic repartitioning for the push engine, on one device.

Counterpart of the single-device, ``allgather`` half of
``lux_tpu.engine.repartition``.  The Lux paper describes monitoring
per-partition runtimes and moving the contiguous cut boundaries to
rebalance load; the reference code's partitioner is the static
edge-balanced sweep.  Here:

  * The engine's carry accumulates a per-part load estimate
    (``PushCarry.sp_work``: sparse-round out-edges walked per part,
    saturating at 2^32 - 1; ``PushCarry.dense_rounds``: dense rounds,
    whose per-part work is the part's real edge count, from the cuts).
  * The driver runs the engine in windows (``push.run_push_chunk`` with
    its ``it_stop``), inspects the window's load split between windows,
    and when the imbalance (max/mean) exceeds a threshold, recuts with
    partition.weighted_cuts, rebuilds the shards, remaps the in-flight
    state and frontier onto the new layout, and resumes.

Correctness: min/max label relaxation is confluent, so the adaptive run
converges to exactly the static run's state; the exact traversed-edge
count is carried across recuts.  The per-part queues are exact only while
count <= f_cap: a window whose queue overflowed defers its recut until the
frontier shrinks.

Several parts stack on the one device here (``-ng > 1`` without a mesh);
the mesh and the ring exchange wait for the multi-GPU port.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from lux_tpu_torch.engine import push
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.partition import part_of_vertex, weighted_cuts
from lux_tpu_torch.graph.push_shards import SRC_SENTINEL, PushShards, build_push_shards
from lux_tpu_torch.utils.device import resolve_device

MULTI_GPU = ("the distributed and ring push are not ported to lux_tpu_torch yet "
             "(ROADMAP Queue 1 item 7, multi-GPU)")


class AdaptiveResult(NamedTuple):
    state: np.ndarray  # (nv,) global final state
    iters: int
    edges: int  # exact traversed-edge count
    reparts: int  # number of repartitions performed
    shards: Any  # final PushShards layout (cuts may differ from t=0)
    stacked: Any  # final stacked device state under that layout
    dense_rounds: int = 0  # dense rounds over the whole run


def part_edge_counts(cuts: np.ndarray, row_ptr: np.ndarray) -> np.ndarray:
    """Real (unpadded) in-edge count per part under ``cuts``."""
    rp = np.asarray(row_ptr)
    return (rp[cuts[1:]] - rp[cuts[:-1]]).astype(np.float64)


def part_work(sp_work, dense_rounds: int, cuts: np.ndarray,
              row_ptr: np.ndarray) -> np.ndarray:
    """Estimated edges processed per part over the window: each dense
    round walks every real in-edge of the part; sparse rounds walked the
    accumulated ``sp_work`` out-edge totals."""
    return (np.asarray(sp_work, np.float64)
            + float(dense_rounds) * part_edge_counts(cuts, row_ptr))


def imbalance(work: np.ndarray) -> float:
    """max/mean load ratio (1.0 = perfectly balanced)."""
    total = float(work.sum())
    if total <= 0.0:
        return 1.0
    return float(work.max()) * len(work) / total


def vertex_weights(work: np.ndarray, cuts: np.ndarray,
                   row_ptr: np.ndarray) -> np.ndarray:
    """Per-vertex work estimate for the recut: the part's measured
    per-edge intensity (work / real edges) spread over its vertices by
    in-degree, plus a small floor so zero-degree stretches still take
    boundary room."""
    nv = len(row_ptr) - 1
    deg = np.diff(np.asarray(row_ptr)).astype(np.float64)
    e_counts = part_edge_counts(cuts, row_ptr)
    intensity = work / np.maximum(e_counts, 1.0)
    owner = part_of_vertex(cuts, np.arange(nv, dtype=np.int64))
    w = deg * intensity[owner]
    floor = max(w.mean() * 1e-3, 1e-9)
    return w + floor


def _changed_mask_from_queues(q_vid: np.ndarray, counts: np.ndarray,
                              f_cap: int, nv: int) -> np.ndarray:
    """Global changed-vertex mask from the per-part (vid, value) queues,
    one vectorized gather over all parts."""
    assert counts.max() <= f_cap, "truncated queue: frontier unrecoverable"
    q = np.asarray(q_vid)
    slot = np.arange(q.shape[1])
    vids = q[slot[None, :] < np.asarray(counts)[:, None]]
    vids = vids[vids != SRC_SENTINEL]
    mask = np.zeros(nv, dtype=bool)
    mask[vids] = True
    return mask


def _rebuild_carry(shards_new: PushShards, arrays, state_g: np.ndarray,
                   changed_g: np.ndarray, it: int, edges: int) -> push.PushCarry:
    """Remap an in-flight global state + frontier onto a fresh shard
    layout whose ``arrays`` are already on the device."""
    dev = arrays.vtx_mask.device
    state_st = torch.from_numpy(shards_new.pull.global_to_stacked(state_g)).to(dev)
    changed_st = (torch.from_numpy(shards_new.pull.global_to_stacked(changed_g)).to(dev)
                  & arrays.vtx_mask)
    q_vid, q_val, cnt = push.queues_of(shards_new.pspec, arrays, changed_st, state_st)
    return push.PushCarry(state_st, q_vid, q_val, cnt, int(it),
                          cnt.sum(dtype=torch.int32), int(edges),
                          (0,) * shards_new.spec.num_parts, 0)


def _reset_window(carry: push.PushCarry) -> push.PushCarry:
    """Zero the window load stats without touching state or frontier."""
    return carry._replace(sp_work=(0,) * len(carry.sp_work), dense_rounds=0)


def _preflight_recut(shards: PushShards, dev, k: int = 1) -> None:
    """A recut can concentrate edges and grow e_pad/e_sp past what the
    startup preflight checked: check again before the layout moves to
    the card.  ``k`` is the number of parts resident on the device."""
    if dev.type != "cuda":
        return
    from lux_tpu_torch.utils import preflight

    est = preflight.estimate_push(shards.spec, shards.pspec)
    preflight.check_fits(preflight.scale_residency(est, k), device=dev)


def refuse_multi_gpu(mesh=None, exchange: str = "allgather") -> None:
    if exchange not in ("allgather", "ring"):
        raise ValueError(f"unsupported exchange {exchange!r}")
    if mesh is not None or exchange == "ring":
        raise NotImplementedError(
            f"mesh={mesh!r}, exchange={exchange!r}: {MULTI_GPU}")


def run_push_adaptive(prog, g: HostGraph, num_parts: int, chunk: int = 32,
                      threshold: float = 1.25, max_iters: int = 10_000,
                      method: str = "auto", mesh=None, on_repartition=None,
                      shards=None, exchange: str = "allgather",
                      device="cuda", placed=None) -> AdaptiveResult:
    """Direction-optimized push with window-based dynamic repartitioning
    on ``device``.

    Runs ``chunk`` iterations at a time; between windows, if the measured
    per-part load imbalance (max/mean) exceeds ``threshold``, recuts with
    weighted_cuts and resumes on the rebuilt layout.
    ``on_repartition(it, old_cuts, new_cuts, work)`` observes each
    recut; ``shards`` optionally supplies the initial layout, and
    ``placed`` its (arrays, parrays) already on ``device``.  ``mesh`` and
    ``exchange="ring"`` raise NotImplementedError (multi-GPU)."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    refuse_multi_gpu(mesh, exchange)
    dev = resolve_device(device)
    method = push._resolve(prog, method, dev)
    if shards is None:
        shards = build_push_shards(g, num_parts)
    arrays, parrays = placed if placed is not None else push.place(shards, dev)
    carry = push._init_carry(prog, shards.pspec, arrays)
    reparts, dense_rounds = 0, 0
    while True:
        it_stop = min(carry.it + chunk, max_iters)
        carry = push.run_push_chunk(prog, shards.pspec, shards.spec, arrays, parrays,
                                    carry, it_stop, method)
        dense_rounds += carry.dense_rounds
        if int(carry.active) == 0 or carry.it >= max_iters:
            break
        counts = carry.count.cpu().numpy()
        if counts.max() > shards.pspec.f_cap:
            # truncated queues: the frontier is not recoverable from the
            # carry; defer rebalancing until it shrinks
            carry = _reset_window(carry)
            continue
        work = part_work(carry.sp_work, carry.dense_rounds, shards.cuts, g.row_ptr)
        if imbalance(work) < threshold:
            carry = _reset_window(carry)
            continue
        new_cuts = weighted_cuts(vertex_weights(work, shards.cuts, g.row_ptr),
                                 num_parts)
        if np.array_equal(new_cuts, shards.cuts):
            carry = _reset_window(carry)
            continue
        state_g = shards.scatter_to_global(carry.state.cpu().numpy())
        changed_g = _changed_mask_from_queues(carry.q_vid.cpu().numpy(), counts,
                                              shards.pspec.f_cap, g.nv)
        if on_repartition is not None:
            on_repartition(carry.it, shards.cuts, new_cuts, work)
        shards = build_push_shards(g, num_parts, cuts=new_cuts)
        _preflight_recut(shards, dev, num_parts)
        arrays, parrays = push.place(shards, dev)
        carry = _rebuild_carry(shards, arrays, state_g, changed_g, carry.it, carry.edges)
        reparts += 1
    state_g = shards.scatter_to_global(carry.state.cpu().numpy())
    return AdaptiveResult(state_g, carry.it, carry.edges, reparts, shards,
                          carry.state, dense_rounds)
