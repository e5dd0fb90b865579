"""Fixed-shape mutation overlays for the engines.

Counterpart of ``lux_tpu.mutate.overlay``.  The host-side construction
is a copy of the reference's, so for the same shards and log the arrays
are byte for byte the reference's; the device replay is PyTorch.  Two
pieces:

  * ``del_val`` — a (P, E) bool tombstone mask over the base CSC edge
    slots.  The engines neutralize tombstoned VALUES (the reduce's
    identity: +0.0 for sum — an exact no-op on the non-negative rank
    states; the dtype's extreme for min/max — exactly absorbed), so the
    base segmented reduce runs unchanged over unchanged arrays and
    launches exactly the kernels it launches without an overlay.
  * ``d_src_pos / d_dst_local / d_weight`` — (P, D) fixed-capacity insert
    buffers (D = ``LUX_DELTA_CAP`` rounded up to 128; overflow raises
    DeltaOverflow and triggers compaction, never a reshape).  Empty
    slots carry the ``nv_pad`` destination sentinel, so the fold drops
    them.

The insert fold must not depend on the order the card runs atomics in: a
PageRank refresh iterates to residual == 0, and a fold whose bits moved
between runs might never quiesce.  :func:`device_overlay` therefore plans
the fold on the host when the overlay is moved to the device: the live
inserts of each destination are split into ROUNDS (round k holds the
k-th insert, in slot order, of every destination with more than k), so
every round scatters to distinct destinations and the rounds add in slot
order — the reference's sequential ``acc.at[d].add`` association, on any
device.  min/max folds are one ``scatter_reduce`` (exact in any order).

Exactness: for min/max/integer reduces the overlay step equals a
cold-rebuilt step on the merged graph bitwise; for float sums the insert
fold is a separate association (base-segment sum, then the fold), so the
converged fixpoints are compared instead.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from lux_tpu_torch.graph.partition import part_of_vertex
from lux_tpu_torch.mutate.deltalog import DeltaLog, DeltaOverflow
from lux_tpu_torch.ops.spmv import reduce_neutral
from lux_tpu_torch.utils.config import env_int

LANE = 128

#: default per-part insert capacity (slots) when LUX_DELTA_CAP is unset
DEFAULT_CAP = 1024

#: the one overlay-versus-plan-family rejection message: only the CF route
#: refuses overlays (the fused families tombstone in group space through
#: the plan's gslot route, ops/expand.apply_fused ``del_val=``)
FUSED_OVERLAY_NOTE = (
    "mutation overlays compose with the direct gather, the routed "
    "EXPAND family, and the FUSED families (fused/fused-pf/fused-mx "
    "tombstone deleted edges in group space via the plan's gslot "
    "route) — but NOT the CF route: its dst-state-dependent error term "
    "re-reads the destination per edge, and the overlay's insert "
    "buffer carries no dst-state replay for it.  Escape hatches: "
    "(1) re-plan the route with route_base=\"expand\" "
    "(LUX_ROUTE_MODE=routed or routed-pf keeps pass-fusion), or "
    "(2) compact() the MutableGraph — the merged base serves any plan "
    "family again (capacity knob: LUX_DELTA_CAP)")


def delta_cap(cap: Optional[int] = None) -> int:
    """The per-part delta-buffer capacity: explicit argument, else
    ``LUX_DELTA_CAP``, else DEFAULT_CAP — rounded UP to the lane width.
    The capacity is part of the overlay's shape; its occupancy is data."""
    if cap is None:
        cap = env_int("LUX_DELTA_CAP", DEFAULT_CAP, minimum=1)
    return -(-cap // LANE) * LANE


@dataclasses.dataclass(frozen=True)
class OverlayStatic:
    """Hashable overlay descriptor: only the shape-defining facts live
    here — occupancy is data."""

    cap: int
    weighted: bool


class OverlayArrays(NamedTuple):
    """Stacked per-part overlay arrays (leading axis = part), numpy.

    Shapes (P parts, E = e_pad base edge slots, D = cap):
      del_val:     (P, E) bool  True where the base edge is tombstoned.
      d_src_pos:   (P, D) int32 insert source position in the (P*V,)
                   gathered state (ShardArrays.src_pos's encoding); empty
                   slots hold 0.
      d_dst_local: (P, D) int32 local destination, or the nv_pad
                   SENTINEL on empty slots.
      d_weight:    (P, D) float32 insert weights (zeros when unweighted).
    """

    del_val: np.ndarray
    d_src_pos: np.ndarray
    d_dst_local: np.ndarray
    d_weight: np.ndarray


class DeviceOverlay(NamedTuple):
    """One part's overlay on the device, with its fold plan:
    ``del_val`` (E,), ``d_src_pos``/``d_dst_local``/``d_weight`` (D,) and
    ``rounds`` (W, R) int64 slot indices (each row names distinct
    destinations; ``D`` pads a row and names a dropped slot)."""

    del_val: torch.Tensor
    d_src_pos: torch.Tensor
    d_dst_local: torch.Tensor
    d_weight: torch.Tensor
    rounds: torch.Tensor


# ---------------------------------------------------------------------------
# device-side replay
# ---------------------------------------------------------------------------


def mask_deleted(vals: torch.Tensor, del_val: torch.Tensor, reduce: str) -> torch.Tensor:
    """Neutralize tombstoned base-edge VALUES before the segmented reduce
    (``del_val`` broadcasts against ``vals``: (E,) or (E, 1) for (E, Q)
    values)."""
    return vals.masked_fill(del_val, reduce_neutral(reduce, vals.dtype))


def delta_scatter(acc: torch.Tensor, full_state: torch.Tensor, oa: DeviceOverlay,
                  value_fn, reduce: str) -> torch.Tensor:
    """Fold one part's insert buffer into the per-destination accumulator
    ``acc`` ((V, ...), returned as a new tensor): gather the D source
    states, apply ``value_fn(src_state, weight)``, combine by local
    destination; sentinel slots (``nv_pad``) drop.  Sums add round by
    round (see the module docstring), min/max in one scatter."""
    v = acc.shape[0]
    src = full_state.index_select(0, oa.d_src_pos)
    vals = value_fn(src, oa.d_weight).to(acc.dtype)
    out = torch.cat([acc, acc.new_full((1,) + tuple(acc.shape[1:]),
                                       reduce_neutral(reduce, acc.dtype))])
    if reduce == "sum":
        vals = torch.cat([vals, vals.new_zeros((1,) + tuple(vals.shape[1:]))])
        dst = torch.cat([oa.d_dst_local.long(),
                         oa.d_dst_local.new_full((1,), v).long()])
        for k in range(oa.rounds.shape[0]):
            s = oa.rounds[k]
            out.index_add_(0, dst.index_select(0, s), vals.index_select(0, s))
    else:
        idx = oa.d_dst_local.long().clamp(0, v)
        idx = idx.reshape(idx.shape + (1,) * (vals.dim() - 1)).expand_as(vals)
        out.scatter_reduce_(0, idx, vals, reduce="amin" if reduce == "min" else "amax",
                            include_self=True)
    return out[:v]


def fold_rounds(d_dst_local: np.ndarray, nv_pad: int) -> np.ndarray:
    """The sum fold's plan for (P, D) destinations: (P, W, R) int64 slot
    indices, round k holding the k-th live slot (in slot order) of every
    destination that has more than k; ``D`` pads.  W and R are the
    maxima over parts (at least 1)."""
    P, D = d_dst_local.shape
    per = []
    for p in range(P):
        dst = np.asarray(d_dst_local[p], np.int64)
        live = np.flatnonzero(dst < nv_pad)
        order = live[np.argsort(dst[live], kind="stable")]
        ds = dst[order]
        first = np.ones(len(ds), bool)
        first[1:] = ds[1:] != ds[:-1]
        run_start = np.maximum.accumulate(np.where(first, np.arange(len(ds)), 0))
        k = np.arange(len(ds)) - run_start
        per.append((order, k))
    W = max([int(k.max()) + 1 if len(k) else 0 for _, k in per] + [1])
    R = max([int(np.bincount(k).max()) if len(k) else 0 for _, k in per] + [1])
    out = np.full((P, W, R), D, np.int64)
    for p, (order, k) in enumerate(per):
        for r in range(W):
            sel = order[k == r]
            out[p, r, :len(sel)] = sel
    return out


def device_overlay(oarr, device, nv_pad: int) -> list:
    """Stacked OverlayArrays (numpy or tensors) -> one DeviceOverlay per
    part on ``device``, the fold plan computed once here.  Call it once
    per run, outside the iteration loop."""
    host = OverlayArrays(*(np.asarray(a.cpu() if torch.is_tensor(a) else a)
                           for a in oarr))
    rounds = torch.from_numpy(fold_rounds(host.d_dst_local, nv_pad)).to(device)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    del_val, src, dst, w = (dev(a) for a in host)
    return [DeviceOverlay(del_val[p], src[p], dst[p], w[p], rounds[p])
            for p in range(del_val.shape[0])]


# ---------------------------------------------------------------------------
# host-side construction
# ---------------------------------------------------------------------------


def _csc_slot_of_base_edge(shards, edge_idx: np.ndarray, base_row_ptr):
    """Map base CSC edge indices -> (part, slot) under the shards' cuts
    (the default fill_part layout: slot = edge index rebased to the
    part's edge range)."""
    cuts = np.asarray(shards.cuts, np.int64)
    dst = (np.searchsorted(base_row_ptr, edge_idx, side="right") - 1)
    part = part_of_vertex(cuts, dst).astype(np.int64)
    elo = np.asarray(base_row_ptr, np.int64)[cuts[part]]
    return part, (edge_idx - elo)


def build_pull_overlay(shards, dlog: DeltaLog, cap: Optional[int] = None):
    """(OverlayStatic, OverlayArrays) for a PullShards bundle built from
    ``dlog.base`` with the default layout (the tombstone mask addresses
    slots by base CSC position; a layout that reorders edge slots is
    detected on the deleted set and refused).  Raises DeltaOverflow when
    any part's live inserts exceed the capacity."""
    arrays = shards.arrays
    if arrays.mirror_pos.shape[-1] > 0:
        raise ValueError("mutation overlays require the default pull "
                         "layout (compact_gather reorders the gather; "
                         "rebuild shards without it)")
    P = arrays.src_pos.shape[0]
    e_pad = arrays.src_pos.shape[1]
    nv_pad = arrays.vtx_mask.shape[1]
    cuts = np.asarray(shards.cuts, np.int64)
    D = delta_cap(cap)
    static = OverlayStatic(cap=D, weighted=shards.spec.weighted)

    del_val = np.zeros((P, e_pad), bool)
    dele = dlog.deleted_edges()
    if len(dele):
        part, slot = _csc_slot_of_base_edge(shards, dele, dlog.base.row_ptr)
        col = np.asarray(dlog.base.col_idx, np.int64)[dele]
        own = part_of_vertex(cuts, col).astype(np.int64)
        want = (own * nv_pad + (col - cuts[own])).astype(np.int64)
        got = np.asarray(arrays.src_pos, np.int64)[part, slot]
        if not np.array_equal(got, want):
            raise ValueError(
                "shards edge layout does not match the base CSC order "
                "(sort_segments layout?) — mutation overlays need the "
                "default fill order")
        del_val[part, slot] = True

    d_src_pos = np.zeros((P, D), np.int32)
    d_dst_local = np.full((P, D), nv_pad, np.int32)
    d_weight = np.zeros((P, D), np.float32)
    isrc, idst, iw = dlog.live_inserts()
    if len(isrc):
        p_of = part_of_vertex(cuts, idst).astype(np.int64)
        counts = np.bincount(p_of, minlength=P)
        if counts.max() > D:
            raise DeltaOverflow(
                f"part {int(counts.argmax())} holds {int(counts.max())} "
                f"live inserts > capacity {D} (LUX_DELTA_CAP) — compact")
        own = part_of_vertex(cuts, isrc).astype(np.int64)
        spos = (own * nv_pad + (isrc - cuts[own])).astype(np.int32)
        # append order within each part: a stable sort by part keeps it
        order = np.argsort(p_of, kind="stable")
        starts = np.zeros(P + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        rows = p_of[order]
        slot = np.arange(len(isrc), dtype=np.int64) - starts[rows]
        d_src_pos[rows, slot] = spos[order]
        d_dst_local[rows, slot] = (idst[order] - cuts[rows]).astype(np.int32)
        d_weight[rows, slot] = iw[order].astype(np.float32)
    return static, OverlayArrays(del_val, d_src_pos, d_dst_local, d_weight)


def empty_overlay_arrays(shards, cap: Optional[int] = None) -> OverlayArrays:
    """The zero-churn OverlayArrays of a shard bundle: no tombstones,
    every insert slot empty.  An engine handed these answers bitwise as
    the no-overlay engine does."""
    arrays = shards.arrays
    P = arrays.src_pos.shape[0]
    e_pad = arrays.src_pos.shape[1]
    nv_pad = arrays.vtx_mask.shape[1]
    D = delta_cap(cap)
    return OverlayArrays(
        del_val=np.zeros((P, e_pad), bool),
        d_src_pos=np.zeros((P, D), np.int32),
        d_dst_local=np.full((P, D), nv_pad, np.int32),
        d_weight=np.zeros((P, D), np.float32),
    )


def occupancy(shards, dlog: DeltaLog, cap: Optional[int] = None) -> dict:
    """Per-part live-insert counts against the capacity (the refresh
    rows' ``delta_occupancy``)."""
    P = shards.arrays.src_pos.shape[0]
    _, idst, _ = dlog.live_inserts()
    counts = np.bincount(part_of_vertex(np.asarray(shards.cuts, np.int64), idst),
                         minlength=P)
    D = delta_cap(cap)
    return {"cap": D, "max": int(counts.max()) if len(counts) else 0,
            "per_part": counts.astype(int).tolist(),
            "frac": round(float(counts.max()) / D, 4) if len(counts) else 0.0,
            "deletes": int(dlog.del_base.sum())}


def push_csr_perms(pshards, base) -> list:
    """Per-part CSC-slot -> CSR-slot maps of the push layout: the stable
    source sort graph/push_shards.build_push_shards performs.  O(E log E)
    once per snapshot (MutableGraph caches them), so a refresh patches
    the tombstones in O(deleted)."""
    cuts = np.asarray(pshards.cuts, np.int64)
    rp = np.asarray(base.row_ptr, np.int64)
    perms = []
    for p in range(pshards.spec.num_parts):
        elo, ehi = int(rp[cuts[p]]), int(rp[cuts[p + 1]])
        srcs = np.asarray(base.col_idx[elo:ehi], np.int64)
        order = np.argsort(srcs, kind="stable")
        inv = np.empty(len(srcs), np.int64)
        inv[order] = np.arange(len(srcs), dtype=np.int64)
        perms.append(inv)
    return perms


def build_push_overlay(pshards, dlog: DeltaLog, cap: Optional[int] = None,
                       csr_perms=None):
    """(OverlayStatic, OverlayArrays, patched PushArrays) for a PushShards
    bundle: the overlay drives the dense rounds (the embedded pull
    layout) and the insert fold; the patched CSR retires deleted edges
    from the sparse walk by pointing their destinations at the nv_pad
    sentinel, which the walk's scatter already drops."""
    from lux_tpu_torch.graph.push_shards import PushArrays

    static, oarr = build_pull_overlay(pshards.pull, dlog, cap)
    parr = pshards.parrays
    part, slot = push_tombstones(pshards, dlog, csr_perms)
    if not len(part):
        return static, oarr, parr
    csr_dst = np.array(parr.csr_dst_local, copy=True)
    csr_dst[part, slot] = pshards.pull.arrays.vtx_mask.shape[1]
    return static, oarr, PushArrays(parr.uniq_src, parr.csr_row_ptr, csr_dst,
                                    parr.csr_weight)


def push_tombstones(pshards, dlog: DeltaLog, csr_perms=None):
    """(part, CSR slot) int64 arrays of the deleted base edges in the push
    layout: the slots build_push_overlay points at the nv_pad sentinel
    (a device copy of the CSR is patched at the same slots)."""
    dele = dlog.deleted_edges()
    if not len(dele):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if csr_perms is None:
        csr_perms = push_csr_perms(pshards, dlog.base)
    part, slot = _csc_slot_of_base_edge(pshards.pull, dele, dlog.base.row_ptr)
    csr_slot = np.empty_like(slot)
    for p in np.unique(part):
        sel = part == p
        csr_slot[sel] = csr_perms[int(p)][slot[sel]]
    return part, csr_slot


def merged_degree_stacked(shards, dlog: DeltaLog) -> np.ndarray:
    """The merged graph's out-degrees in the shards' (P, V) stacked
    layout (padding slots 0): PageRank's apply divides by these."""
    from lux_tpu_torch.graph.shards import global_to_stacked

    deg = dlog.merged_out_degrees()
    return global_to_stacked(np.asarray(shards.cuts), shards.arrays.degree.shape[1], deg)
