"""Routed expand: the pull engine's per-edge state read as lane shuffles.

Counterpart of ``lux_tpu.ops.expand`` for the single-device pull (the
planners are numpy copies of the reference's, so for the same shards,
knobs and colorer the plan arrays are byte for byte the reference's; the
replays are torch around the gather kernels of ops/shuffle.py).

The pull hot loop's LOAD phase is ``state[src_pos]`` — an E-sized random
gather from the (P*V,) concatenated state.  This module re-expresses the
gather as pure data MOVEMENT so every step is a routable shuffle:

    state[src_pos]  =  perm2 o fill_forward o perm1 (state)

1. ``perm1`` — a Benes-routed PERMUTATION (ops/route.py) that places each
   distinct source's state value at the HEAD slot of its run in CSR edge
   order (edges sorted by source, so each source's edges are contiguous).
2. ``fill_forward`` — broadcast each head value across its run.  With
   STATIC run boundaries this is hierarchical and lane-local: one lane
   gather fills within each 128-lane row (cells whose head is in an
   earlier row all share ONE value — the run crossing the row start), and
   the per-row carry is the same fill-forward problem 128x smaller.
3. ``perm2`` — a second routed permutation from CSR slot order to the
   engine's CSC slot order, where the segmented reducers (ops/segment.py)
   consume the values unchanged.

Every step moves bits without arithmetic, so the result is BITWISE equal
to the direct gather.  perm1 and perm2 are 2k-1 passes each (k digits; 7
at N = 2^24), fill_forward about one.  The PASS-FUSED form (``to_pf`` /
``pf=True``) chains 2-3 passes per kernel with the tile held in shared
memory; the FUSED plan (``plan_fused``) also replaces the segmented reduce
with a group layout, and its MXREDUCE form (``mx=True``) reduces inside
the route's last kernel.  The CF plan (``plan_cf_route_shards``) routes a
wide (V, K) state's source AND destination reads, one column at a time.

On the H100 the direct gather is a native ``index_select``; whether
routing pays there is a measurement (PERF.md), not an assumption.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import stat
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from lux_tpu_torch import native
from lux_tpu_torch.engine import methods
from lux_tpu_torch.ops import route as route_mod
from lux_tpu_torch.ops import shuffle as shuf
from lux_tpu_torch.ops.spmv import reduce_neutral
from lux_tpu_torch.utils.config import env_int

LANE = 128


# ---------------------------------------------------------------------------
# the host-side planning pool
# ---------------------------------------------------------------------------


def _plan_threads() -> int:
    """Python-side plan fan-out width: LUX_PLAN_THREADS if set (>= 1;
    garbage or non-positive values raise, naming the knob), else one per
    core.  The per-part planners are numpy + the native colorer (which
    releases the GIL), so threads scale until the cores do."""
    n = env_int("LUX_PLAN_THREADS", minimum=1)
    return n if n is not None else (os.cpu_count() or 1)


def _parallel_map(count: int, fn, workers: int):
    """Daemon-thread parallel map with an atomic work counter, results
    in index order.  Daemon threads, so an abandoned plan build never
    holds the interpreter at exit; synchronous callers still join."""
    import itertools

    results = [None] * count
    errors = []
    counter = itertools.count()  # next() is atomic under the GIL
    # compound the parent's share: a worker of THIS pool spawned from a
    # worker of an outer pool is one of parent*workers machine-wide, so
    # the native colorer under it divides cores accordingly instead of
    # multiplying thread counts (O(cores^2) on many-core hosts)
    parent_share = native.get_thread_share()

    def work():
        native.set_thread_share(parent_share * workers)
        while not errors:
            i = next(counter)
            if i >= count:
                return
            try:
                results[i] = fn(i)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                return

    threads = [threading.Thread(target=work, daemon=True,
                                name=f"lux-plan-w{t}")
               for t in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _map_parts(num_parts: int, fn):
    """Run fn(i) for i in range(num_parts), fanned over the planning
    pool, results in index order.  Each plan_one is a pure function of
    its part's arrays, so the schedule can never change the bytes —
    only the wall clock."""
    if num_parts <= 1 or _plan_threads() <= 1:
        return [fn(i) for i in range(num_parts)]
    return _parallel_map(num_parts, fn, min(_plan_threads(), num_parts))



def _idx8_enabled() -> bool:
    """uint8 pass indices (default ON): every routed pass's index values
    are digit-local (< 128), so int32 storage wastes 4x the index bytes
    read per pass.  LUX_ROUTE_IDX8=0 keeps int32 (the kernels take
    both)."""
    return os.environ.get("LUX_ROUTE_IDX8", "1") != "0"


def _narrow_idx(a: np.ndarray) -> np.ndarray:
    """Narrow ONE gather-index array to uint8.  Digit-local values are
    < 128 by construction (lane digit 128, sublane digits <= 8, ff
    in-row columns < 128) — assert rather than silently fall back, so a
    structural change that breaks the invariant fails loudly instead of
    quietly losing the 4x traffic win."""
    if not np.issubdtype(a.dtype, np.integer):
        return a  # ff levels interleave bool ext masks with index arrays
    if a.size:
        # strictly < LANE: that is the invariant the lane/sublane
        # gathers require (lane fixup, ff in-row columns, sublane digits
        # are all digit-local).  [128, 256) would fit a uint8 but the
        # kernels do not check index values — fail here instead.
        assert a.min() >= 0 and a.max() < LANE, (a.dtype, a.min(), a.max())
    return a.astype(np.uint8)


def _narrow_mx(a: np.ndarray) -> np.ndarray:
    """Narrow an mxreduce RANK tile to uint8.  Unlike gather indices
    these are compared, never gathered through, so the bound is the u8
    range itself: values are in [0, v_blk] with v_blk <= 248
    (ops/shuffle._mx_defaults) and v_blk the padding sentinel."""
    if a.size:
        assert a.min() >= 0 and a.max() <= 255, (a.dtype, a.min(), a.max())
    return a.astype(np.uint8)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# fill-forward planning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FFLevelStatic:
    """Static half of one fill-forward level: the array is viewed
    (rows, 128); ``base`` levels have no carry recursion."""

    rows: int
    base: bool


@dataclasses.dataclass(frozen=True)
class FFStatic:
    levels: tuple[FFLevelStatic, ...]
    n: int


def plan_ff(h: np.ndarray):
    """Plan fill-forward for static head map ``h`` (h[e] = index of the
    first slot of e's run; h[e] <= e, h monotone, h[h[e]] == h[e],
    h[0] == 0).  len(h) must be a power of two >= 128.

    Returns (FFStatic, tuple of per-level index/mask arrays): for each
    non-base level ``(inrow_idx int32 (R,128), ext_mask bool (R,128))``,
    for the base level ``(inrow_idx (1,128),)``.
    """
    n = len(h)
    assert n >= LANE and n & (n - 1) == 0, n
    assert h[0] == 0, "slot 0 must be a head"
    statics: list[FFLevelStatic] = []
    arrays: list[np.ndarray] = []
    h = np.asarray(h, np.int64)
    while True:
        rows = len(h) // LANE
        hr, hc = (h // LANE).reshape(rows, LANE), (h % LANE).reshape(rows, LANE)
        own = np.arange(rows, dtype=np.int64)[:, None]
        same = hr == own
        inrow_idx = np.where(same, hc, 0).astype(np.int32)
        if rows == 1:
            statics.append(FFLevelStatic(rows=1, base=True))
            arrays.append(inrow_idx)
            return FFStatic(levels=tuple(statics), n=n), tuple(arrays)
        ext_mask = ~same
        statics.append(FFLevelStatic(rows=rows, base=False))
        arrays.append(inrow_idx)
        arrays.append(ext_mask)
        # row-level recursion: heads -> head-containing rows; pad the
        # row array up to a 128-multiple power of two with self-heads
        heads = np.flatnonzero(h == np.arange(len(h), dtype=np.int64))
        head_rows = np.unique(heads // LANE)
        sub_n = max(_next_pow2(rows), LANE)
        h2 = np.arange(sub_n, dtype=np.int64)
        pos = np.searchsorted(head_rows, np.arange(rows), side="right") - 1
        h2[:rows] = head_rows[pos]
        h = h2


def apply_ff(x: torch.Tensor, static: FFStatic, arrays) -> torch.Tensor:
    """Device fill-forward replay: x (n,) -> x[h] (bitwise)."""
    return _ff_rec(x, static.levels, list(arrays))


def _ff_rec(x, levels, arrays):
    lv = levels[0]
    y = x.reshape(lv.rows, LANE)
    inrow_idx = arrays.pop(0)
    tmp = shuf.lane_gather(y, inrow_idx)
    if lv.base:
        return tmp.reshape(-1)
    ext_mask = arrays.pop(0)
    w = tmp[:, LANE - 1]
    sub_n = max(_next_pow2(lv.rows), LANE)
    wp = torch.cat([w, w.new_zeros(sub_n - lv.rows)])
    f = _ff_rec(wp, levels[1:], arrays)[: lv.rows]
    rc = torch.roll(f, 1)  # rc[r] = f[r-1]; row 0 is never external
    out = torch.where(ext_mask, rc[:, None], tmp)
    return out.reshape(-1)


def apply_ff_np(x, h):
    """NumPy oracle."""
    return np.asarray(x)[np.asarray(h, np.int64)]


# ---------------------------------------------------------------------------
# the full expand plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExpandStatic:
    """Hashable descriptor of a routed expand.
    ``r1``/``r2`` hold either the unfused StaticRoute or, after
    ``to_pf``, the pass-fused StaticRoutePF — replay dispatches on the
    type, everything downstream is agnostic."""

    n: int
    e_pad: int
    state_size: int
    r1: object  # shuf.StaticRoute | shuf.StaticRoutePF
    ff: FFStatic
    r2: object


def _build_routes(*perms):
    """Build several INDEPENDENT Benes routes, concurrently when the
    planning pool allows: a plan's r1/r2 (and fused's vr) share no
    state, and the Euler coloring under build_route releases the GIL in
    the native layer — so even a single-part (P=1) plan build uses the
    host's cores.  Pure functions: the schedule can't change bytes."""
    if _plan_threads() <= 1 or len(perms) <= 1:
        return tuple(route_mod.build_route(p) for p in perms)
    return tuple(_parallel_map(
        len(perms), lambda i: route_mod.build_route(perms[i]),
        min(len(perms), _plan_threads())))

def _plan_expand_half(src_pos: np.ndarray, m: int, state_size: int):
    """Shared expand-half construction (state -> filled CSR-run slots):
    perm1 + fill-forward plan.  Returns
    (n, csr, perm1, ff_static, ff_arrays) — used by both plan_expand
    and plan_fused so the two can never diverge; the callers build the
    perm1 route TOGETHER with their other route perms (_build_routes)
    so independent colorings overlap."""
    e_pad = len(src_pos)
    n = max(_next_pow2(e_pad), _next_pow2(state_size), LANE)
    sp = np.asarray(src_pos[:m], np.int64)
    csr = np.argsort(sp, kind="stable")  # csr slot j holds CSC edge csr[j]
    sp_sorted = sp[csr]
    head = np.empty(m, bool)
    if m:
        head[0] = True
        head[1:] = sp_sorted[1:] != sp_sorted[:-1]
    head_slots = np.flatnonzero(head)
    uniq = sp_sorted[head_slots] if m else np.empty(0, np.int64)

    # perm1: out[head_slot j] = x[uniq j]; all other slots filled with
    # the unused source indices in ascending order (any bijection works)
    perm1 = np.empty(n, np.int64)
    perm1[head_slots] = uniq
    used_src = np.zeros(n, bool)
    used_src[uniq] = True
    used_tgt = np.zeros(n, bool)
    used_tgt[head_slots] = True
    perm1[~used_tgt] = np.flatnonzero(~used_src)

    # fill-forward: h[e] = head slot of e's run (CSR space); padding
    # slots are their own heads
    h = np.arange(n, dtype=np.int64)
    if m:
        h[:m] = head_slots[np.cumsum(head) - 1]
    ff_static, ff_arrays = plan_ff(h)
    return n, csr, perm1, ff_static, ff_arrays

def plan_expand(src_pos: np.ndarray, m: int, state_size: int):
    """Plan the routed expand for ONE part.

    src_pos: (e_pad,) int32 CSC-edge-order gather indices (real edges in
    slots [0, m), padding after — graph/shards.fill_part layout).
    state_size: size of the gathered state the engine reads (P*V).

    Returns (ExpandStatic, tuple of np arrays) — r1 passes, ff levels,
    r2 passes, concatenated in that order (ExpandStatic knows the split
    points through its sub-plans).
    """
    e_pad = len(src_pos)
    n, csr, perm1, ff_static, ff_arrays = _plan_expand_half(
        src_pos, m, state_size)

    # perm2: CSR slot j carries CSC edge csr[j] -> out[csr[j]] = y[j]
    perm2 = np.empty(n, np.int64)
    perm2[csr] = np.arange(m, dtype=np.int64)
    perm2[m:] = np.arange(m, n, dtype=np.int64)
    r1, r2 = _build_routes(perm1, perm2)

    r1s, r1a = shuf.freeze_plan(shuf.plan_route(r1))
    r2s, r2a = shuf.freeze_plan(shuf.plan_route(r2))
    static = ExpandStatic(n=n, e_pad=e_pad, state_size=state_size,
                          r1=r1s, ff=ff_static, r2=r2s)
    arrays = tuple(r1a) + tuple(ff_arrays) + tuple(r2a)
    if _idx8_enabled():
        # every array here is a gather index (or a bool ff mask)
        arrays = tuple(_narrow_idx(a) for a in arrays)
    return static, arrays

def _ff_array_count(ff: FFStatic) -> int:
    return sum(1 if lv.base else 2 for lv in ff.levels)


def _num_expand_arrays(static) -> int:
    """Total plan-array count of an expand-shaped static (r1 + ff + r2).
    Routes may be unfused (StaticRoute, one array per pass) or
    pass-fused (StaticRoutePF, one per in-group gather step) — the
    count helper in ops/shuffle covers both."""
    return (shuf.route_num_arrays(static.r1) + _ff_array_count(static.ff)
            + shuf.route_num_arrays(static.r2))


def split_arrays(static: ExpandStatic, arrays):
    """Recover the (r1, ff, r2) array groups from the flat tuple."""
    n1 = shuf.route_num_arrays(static.r1)
    nff = _ff_array_count(static.ff)
    r1a = arrays[:n1]
    ffa = arrays[n1:n1 + nff]
    r2a = arrays[n1 + nff:]
    assert len(r2a) == shuf.route_num_arrays(static.r2)
    return r1a, ffa, r2a


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(n - x.shape[0])]) if n > x.shape[0] else x


def apply_expand(full_state: torch.Tensor, static: ExpandStatic,
                 arrays) -> torch.Tensor:
    """Device replay: full_state (state_size,) -> full_state[src_pos]
    (e_pad,), bitwise equal to the direct gather."""
    if full_state.dim() != 1:
        raise ValueError(
            "routed expand supports scalar (1-D) vertex state only; "
            f"got shape {tuple(full_state.shape)}")
    r1a, ffa, r2a = split_arrays(static, arrays)
    x = _pad_to(full_state, static.n)
    y = shuf.apply_route_frozen(x, static.r1, r1a)
    y = apply_ff(y, static.ff, ffa)
    z = shuf.apply_route_frozen(y, static.r2, r2a)
    return z[: static.e_pad]


def apply_expand_np(src_pos, full_state):
    """NumPy oracle of the whole expand (the direct gather)."""
    return np.asarray(full_state)[np.asarray(src_pos, np.int64)]


# ---------------------------------------------------------------------------
# pass fusion (routed-pf)
# ---------------------------------------------------------------------------


def _pf_route(static_route, route_arrays, knobs=(None, None, None)):
    """One frozen route + arrays -> pass-fused form, re-narrowed."""
    s, a = shuf.pf_from_frozen(static_route, tuple(route_arrays),
                               max_block=knobs[0], max_group=knobs[1],
                               smem_bytes=knobs[2])
    if _idx8_enabled():
        a = tuple(_narrow_idx(x) for x in a)
    return s, a


def _to_pf_one(static, arrays, knobs=(None, None, None)):
    """ONE part's plan -> pass-fused (the single derivation of to_pf)."""
    arrays = tuple(np.asarray(a) for a in arrays)
    if isinstance(static, ExpandStatic):
        r1a, ffa, r2a = split_arrays(static, arrays)
        r1s, r1n = _pf_route(static.r1, r1a, knobs)
        r2s, r2n = _pf_route(static.r2, r2a, knobs)
        return (dataclasses.replace(static, r1=r1s, r2=r2s),
                tuple(r1n) + tuple(ffa) + tuple(r2n))
    if isinstance(static, FusedStatic):
        if getattr(static, "mx", None) is not None:
            raise TypeError(
                "to_pf: mxreduce plans are already pass-fused (and their "
                "r2 grouping is mx-constrained); build them with "
                "plan_fused(..., mx=True)")
        r1a, ffa, r2a, gmask, gweights, gslot, vra, _mxa = \
            split_fused_arrays(static, arrays, static.weighted)
        r1s, r1n = _pf_route(static.r1, r1a, knobs)
        r2s, r2n = _pf_route(static.r2, r2a, knobs)
        vrs, vrn = _pf_route(static.vr, vra, knobs)
        warr = (gweights,) if static.weighted else ()
        return (dataclasses.replace(static, r1=r1s, r2=r2s, vr=vrs),
                tuple(r1n) + tuple(ffa) + tuple(r2n) + (gmask,) + warr
                + (gslot,) + tuple(vrn))
    if isinstance(static, CFRouteStatic):
        n_src = _num_expand_arrays(static.src)
        s_src, a_src = _to_pf_one(static.src, arrays[:n_src], knobs)
        s_dst, a_dst = _to_pf_one(static.dst, arrays[n_src:], knobs)
        return CFRouteStatic(src=s_src, dst=s_dst), tuple(a_src) + tuple(a_dst)
    raise TypeError(f"to_pf: unsupported plan static {type(static)}")


def to_pf(plan, max_block=None, max_group=None, smem_bytes=None):
    """Upgrade a routed plan to the PASS-FUSED replay (``routed-pf``):
    every Benes route inside the plan (expand r1/r2, fused r1/r2/vr, CF
    src/dst) is regrouped so 2-3 consecutive permutation passes run in ONE kernel
    with intermediates in shared memory (ops/shuffle.pf_from_frozen) —
    fewer device-memory sweeps per iteration, bitwise-identical replay
    (the same per-pass permutations move the same bits; the
    fill-forward levels and the fused group reduce are untouched, so
    even the fused sum association is unchanged).

    numpy rearrangement of the frozen plan — no Euler recoloring.
    Accepts both a single-part plan (2-D arrays) and a stacked shards
    plan ((P, ...) arrays); parts share one static, asserted like every
    shards planner.
    """
    static, arrays = plan
    arrays = tuple(np.asarray(a) for a in arrays)
    knobs = (max_block, max_group, smem_bytes)
    if arrays and arrays[0].ndim == 3:
        num_parts = arrays[0].shape[0]
        return _stack_from(_map_parts(
            num_parts,
            lambda i: _to_pf_one(static, tuple(a[i] for a in arrays),
                                 knobs)))
    return _to_pf_one(static, arrays, knobs)


# ---------------------------------------------------------------------------
# fused expand + reduce
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedStatic:
    """Hashable descriptor of a fused routed pull iteration: expand
    (r1 + ff as in ExpandStatic) -> permute into a per-destination
    pow2-padded GROUP layout (r2) -> masked elementwise edge_value ->
    per-group reshape-reduce -> small V-space route into accumulator
    order.  Replaces gather + segmented reduce with routed movement;
    float sums use the group-layout association (a deterministic
    method-specific order, like mxsum's matmul association)."""

    n: int              # expand space (state/CSR slots)
    n2: int             # group space (>= padded group layout size)
    state_size: int
    v_pad: int          # accumulator slots (local part state size)
    nv_route: int       # pow2 routing space for the accumulator
    reduce: str         # "sum" | "min" | "max"
    weighted: bool      # plan carries pre-routed f32 weights
    #: (offset, count, 2**k) per width class.  ``offset`` is a GROUP-
    #: SPACE element offset for the plain layout, a RANK offset for the
    #: mxreduce layout (whose element offsets carry per-rank-block
    #: alignment padding and live in the plan's seg-boundary tiles).
    groups: tuple[tuple[int, int, int], ...]
    r1: object  # shuf.StaticRoute | shuf.StaticRoutePF (see ExpandStatic)
    ff: FFStatic
    r2: object
    vr: object
    #: mxreduce: the final r2 group fused WITH the segmented reduction
    #: (ops/shuffle.StaticMXGroup).  When set, ``r2`` holds only
    #: the prefix groups (identity final — the reduction consumes the
    #: final physical layout via plan-time rank tiles) and the plan's
    #: arrays carry (mx step idx tiles, dst_rel, tile_block, tile_first)
    #: in place of the group mask.  None = the plain masked group-reduce.
    mx: object = None
    #: base CSC edge slots (length of the plan's ``gslot`` tombstone
    #: route, the reference's FUSED_FORMAT 1 layout; mutation overlays
    #: scatter their tombstones through it, apply_fused ``del_val=``).
    e_pad: int = 0


def plan_fused(src_pos: np.ndarray, dst_local: np.ndarray, m: int,
               state_size: int, v_pad: int, reduce: str = "sum",
               weights: np.ndarray | None = None,
               template: dict[int, int] | None = None,
               mx: bool = False):
    """Plan the fused routed pull for ONE part.

    src_pos / dst_local: (e_pad,) CSC-order arrays (fill_part layout:
    real edges in [0, m), dst_local sorted ascending).  v_pad: the
    part's padded vertex count (accumulator size).  weights: optional
    per-edge float32 (routed into group layout HERE, at plan time).

    Returns (FusedStatic, arrays): arrays = r1 passes + ff levels + r2
    passes + (group_mask float/bool, group_weights or (), vr passes).

    ``mx=True`` plans the MXREDUCE form instead: the group layout goes
    rank-major with tile-span-aligned rank blocks, r2's target
    permutation is pre-composed with the pass-fused final physical
    layout (shuf.mx_physical_order), and the final pass group carries
    the segmented reduction in-kernel (shuf.StaticMXGroup) driven by
    plan-time SEGMENT-BOUNDARY TILES — dst_rel (u8 rank map, sentinel
    = v_blk), tile_block/tile_first (each tile's output block).
    Arrays become r1 + ff + r2-prefix + mx-steps + (dst_rel,
    tile_block, tile_first) + (weights?) + vr; no group mask (the
    sentinel subsumes it).  r1/vr freeze pass-fused directly."""
    n, csr, perm1, ff_static, ff_arrays = _plan_expand_half(
        src_pos, m, state_size)

    # --- group layout: per-destination pow2-padded blocks ---
    dl = np.asarray(dst_local[:m], np.int64)
    dsts, counts = np.unique(dl, return_counts=True)  # ascending = CSC order
    ks = _width_classes(counts)
    order = np.argsort(ks, kind="stable")  # group by k, stable by dst
    if template is None:
        template = {int(k): int((ks == k).sum()) for k in np.unique(ks)}
    assert set(int(k) for k in np.unique(ks)) <= set(template), (
        "template is missing width classes present in the data")
    groups: list[tuple[int, int, int]] = []
    seg_base = np.empty(len(dsts), np.int64)  # group-layout start per dst
    seg_stride = np.empty(len(dsts), np.int64)  # per-rank step within seg
    total_rank = np.empty(len(dsts), np.int64)  # dst -> totals-array slot
    off = 0
    rank_off = 0
    rank_widths: list[np.ndarray] = []  # mx: per-RANK pad width (+dummies)
    for k in sorted(template):
        sel = order[ks[order] == k]
        width = 1 << int(k)
        cnt = template[k]  # >= len(sel); extra rows are dummies that
        # stay masked to the reduce neutral (multi-part plans share one
        # template so every part's FusedStatic stays uniform)
        assert len(sel) <= cnt, (k, len(sel), cnt)
        total_rank[sel] = rank_off + np.arange(len(sel), dtype=np.int64)
        if mx:
            # mx layout is derived from per-rank widths below; ``groups``
            # records RANK offsets (element offsets carry alignment pads)
            groups.append((rank_off, cnt, width))
            rank_widths.append(np.full(cnt, width, np.int64))
        else:
            groups.append((off, cnt, width))
            if width < LANE:
                # COLUMN-major (width, count) block (the reference's TPU
                # layout choice, kept so the plans are identical)
                seg_base[sel] = off + np.arange(len(sel), dtype=np.int64)
                seg_stride[sel] = cnt
            else:
                seg_base[sel] = (off
                                 + np.arange(len(sel), dtype=np.int64)
                                 * width)
                seg_stride[sel] = 1
            off += cnt * width
        rank_off += cnt
    total_slots = rank_off  # template slots incl. dummies

    mx_geom = None
    if mx:
        # --- mxreduce layout: rank-major segments, every v_blk-rank
        # block's span starting on a reduce-tile boundary, so each
        # kernel tile accumulates into exactly ONE output block ---
        mx_max_block, tile_rows, v_blk = shuf._mx_defaults()
        widths = (np.concatenate(rank_widths) if rank_widths
                  else np.zeros(0, np.int64))
        num_blocks = max(-(-total_slots // v_blk), 1)
        ts = tile_rows * LANE
        cumw = np.zeros(total_slots + 1, np.int64)
        np.cumsum(widths, out=cumw[1:])
        bounds = np.minimum(np.arange(num_blocks + 1, dtype=np.int64)
                            * v_blk, total_slots)
        block_sizes = cumw[bounds[1:]] - cumw[bounds[:-1]]
        aligned = -(-block_sizes // ts) * ts
        aligned_start = np.zeros(num_blocks, np.int64)
        np.cumsum(aligned[:-1], out=aligned_start[1:])
        span = int(aligned_start[-1] + block_sizes[-1]) if total_slots else 0
        n2 = max(_next_pow2(max(span, 1)), n, LANE)
        if total_slots:
            blk = np.arange(total_slots, dtype=np.int64) // v_blk
            seg_base_rank = (aligned_start[blk]
                             + (cumw[:-1] - cumw[blk * v_blk]))
        else:
            seg_base_rank = np.zeros(0, np.int64)
        mx_geom = (mx_max_block, tile_rows, v_blk, num_blocks,
                   aligned_start, seg_base_rank)
    else:
        n2 = max(_next_pow2(off), n, LANE)

    # perm2: CSR slot j (edge csr[j], dst dl[csr[j]]) -> its slot in the
    # group layout (seg base + rank within segment)
    seg_of_edge = np.searchsorted(dsts, dl)         # (m,) CSC order
    seg_starts = np.zeros(len(dsts) + 1, np.int64)
    np.cumsum(counts, out=seg_starts[1:])
    rank_csc = np.arange(m, dtype=np.int64) - seg_starts[seg_of_edge]
    if mx:
        edge_rank = total_rank[seg_of_edge]
        gslot_csc = mx_geom[5][edge_rank] + rank_csc  # rank-major, stride 1
    else:
        gslot_csc = (seg_base[seg_of_edge]
                     + rank_csc * seg_stride[seg_of_edge])  # (m,) group slot
    # out[group slot of edge e] = y_csr[csr slot of e]
    csr_slot_of_edge = np.empty(m, np.int64)
    csr_slot_of_edge[csr] = np.arange(m, dtype=np.int64)
    perm2 = np.empty(n2, np.int64)
    used_tgt2 = np.zeros(n2, bool)
    used_src2 = np.zeros(n2, bool)
    perm2[gslot_csc] = csr_slot_of_edge
    used_tgt2[gslot_csc] = True
    used_src2[csr_slot_of_edge] = True
    perm2[~used_tgt2] = np.flatnonzero(~used_src2)

    if mx:
        # pre-compose with the final physical layout: routing perm2r and
        # SKIPPING the restore transpose lands the desired layout
        # directly under the in-kernel reduction's rank tiles
        mx_max_block, tile_rows, v_blk, num_blocks, aligned_start, _ = \
            mx_geom
        pf_blk, pf_grp, _ = shuf._pf_defaults()
        dims2 = route_mod.factor_digits(n2)
        group_sizes, _sfx = route_mod.plan_mx_fusion_groups(
            dims2, pf_blk, pf_grp, mx_max_block)
        sigma = shuf.mx_physical_order(n2, dims2, group_sizes)
        perm2r = np.empty(n2, np.int64)
        perm2r[sigma] = perm2
        # segment-boundary tiles: rank map (sentinel v_blk on padding,
        # dummy-rank, and junk slots) + per-tile output-block routing
        rank_rel = np.full(n2, v_blk, np.int64)
        if m:
            rank_rel[gslot_csc] = edge_rank % v_blk
        R = n2 // LANE
        tb = max(1, min(tile_rows, R))
        num_tiles = R // tb
        tstarts = np.arange(num_tiles, dtype=np.int64) * (tb * LANE)
        tile_block = np.clip(
            np.searchsorted(aligned_start, tstarts, side="right") - 1,
            0, num_blocks - 1).astype(np.int32)
        tile_first = np.zeros(num_tiles, np.int32)
        tile_first[0] = 1
        tile_first[1:][tile_block[1:] != tile_block[:-1]] = 1
        if weights is not None:
            gweights = np.zeros(n2, np.float32)
            gweights[gslot_csc] = np.asarray(weights[:m], np.float32)
    elif weights is not None:
        # static group-space pre-routed weights (plain layout)
        gweights = np.zeros(n2, np.float32)
        gweights[gslot_csc] = np.asarray(weights[:m], np.float32)
    if not mx:
        gmask = np.zeros(n2, bool)
        gmask[gslot_csc] = True
    # tombstone route: CSC edge rank -> group slot, sentinel n2 on the
    # padding rows (apply_fused ``del_val=`` masks deleted edges in group
    # space through it)
    gslot_full = np.full(len(src_pos), n2, np.int32)
    gslot_full[:m] = gslot_csc

    # accumulator route: totals (group order: one per dst, concat by k)
    # -> dst_local slots of a (nv_route,) vector; uncovered slots pull
    # from the zero tail
    nv_route = max(_next_pow2(max(v_pad, total_slots)), LANE)
    permv = np.empty(nv_route, np.int64)
    used_tgtv = np.zeros(nv_route, bool)
    used_srcv = np.zeros(nv_route, bool)
    permv[dsts] = total_rank
    used_tgtv[dsts] = True
    used_srcv[total_rank] = True
    # every other accumulator slot reads an unused source slot; source
    # slots >= num_seg are filled with the reduce neutral on device
    permv[~used_tgtv] = np.flatnonzero(~used_srcv)

    if mx:
        r1, r2, vr = _build_routes(perm1, perm2r, permv)
        r1s, r1a = shuf.plan_route_pf(r1)
        vrs, vra = shuf.plan_route_pf(vr)
        r2s, r2a, mxs, mxa = shuf.plan_route_pf_mx(
            r2, v_blk=v_blk, num_blocks=num_blocks, op=reduce,
            group_sizes=group_sizes, tile_rows=tb)
        static = FusedStatic(
            n=n, n2=n2, state_size=state_size, v_pad=v_pad,
            nv_route=nv_route, reduce=reduce,
            weighted=weights is not None, groups=tuple(groups),
            r1=r1s, ff=ff_static, r2=r2s, vr=vrs, mx=mxs,
            e_pad=len(src_pos),
        )
        idx_groups = (tuple(r1a) + tuple(ff_arrays) + tuple(r2a)
                      + tuple(mxa))
        dst_rel = np.ascontiguousarray(rank_rel.reshape(R, LANE))
        if _idx8_enabled():
            idx_groups = tuple(_narrow_idx(a) for a in idx_groups)
            dst_rel = _narrow_mx(dst_rel)
            vra = tuple(_narrow_idx(a) for a in vra)
        else:
            dst_rel = dst_rel.astype(np.int32)
        warr = ((np.ascontiguousarray(gweights.reshape(R, LANE)),)
                if weights is not None else ())
        arrays = (idx_groups + (dst_rel, tile_block, tile_first) + warr
                  + (gslot_full,) + tuple(vra))
        return static, arrays

    r1, r2, vr = _build_routes(perm1, perm2, permv)
    r1s, r1a = shuf.freeze_plan(shuf.plan_route(r1))
    r2s, r2a = shuf.freeze_plan(shuf.plan_route(r2))
    vrs, vra = shuf.freeze_plan(shuf.plan_route(vr))
    static = FusedStatic(
        n=n, n2=n2, state_size=state_size, v_pad=v_pad,
        nv_route=nv_route, reduce=reduce, weighted=weights is not None,
        groups=tuple(groups), r1=r1s, ff=ff_static, r2=r2s, vr=vrs,
        e_pad=len(src_pos),
    )
    idx_groups = tuple(r1a) + tuple(ff_arrays) + tuple(r2a)
    if _idx8_enabled():
        idx_groups = tuple(_narrow_idx(a) for a in idx_groups)
        vra = tuple(_narrow_idx(a) for a in vra)
    warr = (gweights,) if weights is not None else ()
    arrays = idx_groups + (gmask,) + warr + (gslot_full,) + tuple(vra)
    return static, arrays


def split_fused_arrays(static: FusedStatic, arrays, weighted: bool):
    """Recover the array groups of a fused plan's flat tuple.  Returns
    (r1a, ffa, r2a, gmask, gweights, gslot, vra, mxa): ``mxa`` is () for
    plain plans; for mxreduce plans it is (step tiles..., dst_rel,
    tile_block, tile_first) and ``gmask`` is None (the rank tiles'
    sentinel subsumes the mask).  ``gslot`` is the (e_pad,) CSC-edge ->
    group-slot tombstone route."""
    n1 = shuf.route_num_arrays(static.r1)
    nff = _ff_array_count(static.ff)
    n2p = shuf.route_num_arrays(static.r2)
    r1a = arrays[:n1]
    ffa = arrays[n1:n1 + nff]
    r2a = arrays[n1 + nff:n1 + nff + n2p]
    rest = arrays[n1 + nff + n2p:]
    mxg = getattr(static, "mx", None)
    if mxg is not None:
        nmx = len(mxg.steps) + 3  # steps + dst_rel + tile_block/first
        mxa = rest[:nmx]
        rest = rest[nmx:]
        gmask = None
        gweights = rest[0] if weighted else None
        gslot = rest[int(weighted)]
        vra = rest[1 + int(weighted):]
    else:
        mxa = ()
        gmask = rest[0]
        gweights = rest[1] if weighted else None
        gslot = rest[1 + int(weighted)]
        vra = rest[2 + int(weighted):]
    assert len(vra) == shuf.route_num_arrays(static.vr)
    return r1a, ffa, r2a, gmask, gweights, gslot, vra, mxa


_REDUCE = {"sum": torch.sum, "min": torch.amin, "max": torch.amax}


def _group_reduce(y: torch.Tensor, reduce: str, dim: int) -> torch.Tensor:
    if reduce == "sum":
        return torch.sum(y, dim=dim, dtype=y.dtype)  # int32 stays int32
    return _REDUCE[reduce](y, dim=dim)


def apply_fused(full_state: torch.Tensor, static: FusedStatic, arrays,
                edge_value=None, weighted: bool | None = None,
                del_val=None) -> torch.Tensor:
    """Device replay of the fused routed pull for one part: full_state
    (state_size,) -> accumulator (v_pad,).

    ``edge_value(src_vals, weights)`` is applied elementwise in GROUP
    layout (destination-state-dependent programs are unsupported here —
    use the expand path); ``weighted`` (default ``static.weighted``)
    says whether it is given the plan's group-space weights or None.
    Sum association follows the group layout — a deterministic,
    method-specific order, like mxsum's.  An MXREDUCE plan
    (``static.mx``) runs the final pass group and the segmented
    reduction in ONE kernel (shuf.mxreduce_pass_gather): the edge
    function is applied to the group's entry-layout array before the
    kernel (the gathers only permute, so those are the same values; an
    edge function that is the identity on the dtype, as PageRank's
    ``f32(src)`` on f32 state, returns its input and launches nothing),
    float sums accumulate in f32, min/max and integer ops keep their
    dtype bitwise, and the group-space array is read once, never written
    back.  A weighted edge function on an mx plan raises
    NotImplementedError.

    ``del_val``: optional (e_pad,) bool CSC-order tombstones (a mutation
    overlay's deletions), scattered through the plan's ``gslot`` route
    into a GROUP-SPACE mask (the sentinel ``n2`` drops): the plain layout
    folds it into the group mask, the mx layout sends the tombstoned
    slots' ranks to the kernel's sentinel ``v_blk`` in a fresh rank
    tensor (the plan's own ``dst_rel`` is never written).  Deleted edges
    reduce as the neutral, with the plan and the kernels unchanged."""
    if full_state.dim() != 1:
        raise ValueError("fused routed pull supports 1-D state only")
    if weighted is None:
        weighted = static.weighted
    r1a, ffa, r2a, gmask, gweights, gslot, vra, mxa = split_fused_arrays(
        static, arrays, static.weighted)
    g_del = None
    if del_val is not None:
        g_del = torch.zeros(static.n2 + 1, dtype=torch.bool, device=full_state.device)
        g_del[gslot.long()] = del_val
        g_del = g_del[: static.n2]
    x = _pad_to(full_state, static.n)
    y = shuf.apply_route_frozen(x, static.r1, r1a)
    y = apply_ff(y, static.ff, ffa)
    y = _pad_to(y, static.n2)
    y = shuf.apply_route_frozen(y, static.r2, r2a)
    total_slots = sum(cnt for _, cnt, _ in static.groups)
    mxg = static.mx
    if mxg is not None:
        # r2 above ran only the PREFIX groups (identity final); the mx
        # kernel chains the suffix gathers with the reduction
        y = shuf._relayout(y, mxg.view, mxg.perm_axes).reshape(mxg.kshape)
        if edge_value is not None:
            if weighted:
                raise NotImplementedError(
                    "a weighted edge function in the mx kernel comes with "
                    "the push-apps slice of the port; run --route-gather "
                    "fused-pf or expand-pf")
            y = edge_value(y, None).contiguous()
        n_steps = len(mxg.steps)
        dst_rel, tile_block, _tile_first = mxa[n_steps:]
        if g_del is not None:
            dst_rel = dst_rel.masked_fill(g_del.view(dst_rel.shape), mxg.v_blk)
        totals = shuf.mxreduce_pass_gather(
            y, tuple(mxa[:n_steps]), dst_rel, tile_block, group=mxg)
        t = totals[:total_slots]
    else:
        if edge_value is not None:
            y = edge_value(y, gweights if weighted else None)
        keep = gmask if g_del is None else gmask & ~g_del
        y = torch.where(keep, y, torch.full_like(
            y, reduce_neutral(static.reduce, y.dtype)))
        totals = []
        for off, count, width in static.groups:
            blk = y[off:off + count * width]
            if width < LANE:  # column-major (width, count) block
                totals.append(_group_reduce(blk.reshape(width, count),
                                            static.reduce, 0))
            else:
                totals.append(_group_reduce(blk.reshape(count, width),
                                            static.reduce, 1))
        t = torch.cat(totals) if totals else y.new_zeros(0)
    t = torch.cat([t, torch.full((static.nv_route - t.shape[0],),
                                 reduce_neutral(static.reduce, t.dtype),
                                 dtype=t.dtype, device=t.device)])
    acc = shuf.apply_route_frozen(t, static.vr, vra)
    return acc[: static.v_pad]


def _width_classes(counts: np.ndarray) -> np.ndarray:
    """Per-segment width class k (pad width = 2**k) from segment sizes.
    The ONE derivation shared by template construction and plan_fused —
    divergence would route through uninitialized layout slots."""
    return np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64)


def _group_template(arrays) -> dict[int, int]:
    """Shared per-width-class group counts: the MAX over parts of each
    class's segment count.  Every part planned against this template
    yields an identical FusedStatic (dummy rows mask to the reduce
    neutral), so the parts share one static."""
    template: dict[int, int] = {}
    for i in range(arrays.src_pos.shape[0]):
        dl = arrays.dst_local[i][arrays.edge_mask[i]]
        _, counts = np.unique(dl, return_counts=True)
        ks = _width_classes(counts)
        for k in np.unique(ks):
            template[int(k)] = max(template.get(int(k), 0),
                                   int((ks == k).sum()))
    return template


# ---------------------------------------------------------------------------
# the shards planners
# ---------------------------------------------------------------------------


def resolve_fused_mx(mx: bool | None) -> bool:
    """``mx=None`` on the fused planners follows the reduce-mode choice
    (engine/methods.reduce_mode: LUX_REDUCE_MODE, else "group").
    Explicit True/False always wins (the fused-mx app flag is
    explicit)."""
    if mx is not None:
        return mx
    return methods.reduce_mode() == "mxreduce"


def _fused_plan_one(shards, template, reduce: str, i: int,
                    mx: bool = False):
    """ONE part's fused plan against a SHARED template."""
    arrays = shards.arrays
    v_pad = arrays.row_ptr.shape[1] - 1
    m = int(np.count_nonzero(arrays.edge_mask[i]))
    return plan_fused(
        np.asarray(arrays.src_pos[i]), np.asarray(arrays.dst_local[i]),
        m, shards.spec.gathered_size, v_pad, reduce,
        weights=np.asarray(arrays.weights[i]), template=template, mx=mx)


def plan_fused_shards(shards, reduce: str = "sum", pf: bool = False,
                      mx: bool | None = False):
    """plan_fused for a PullShards bundle.  Parts share one group
    TEMPLATE (max segment count per width class across parts), so all
    parts produce the same FusedStatic; the price is a few dummy group
    rows per part, masked to the reduce neutral.  ``pf=True`` returns
    the pass-fused form; ``mx=True`` (or mx=None with LUX_REDUCE_MODE=
    mxreduce — resolve_fused_mx) the MXREDUCE form, which is inherently
    pass-fused."""
    if resolve_fused_mx(mx):
        template = _group_template(shards.arrays)
        return _stack_parts(
            shards.arrays.src_pos.shape[0],
            lambda i: _fused_plan_one(shards, template, reduce, i,
                                      mx=True))
    template = _group_template(shards.arrays)
    plan = _stack_parts(shards.arrays.src_pos.shape[0],
                        lambda i: _fused_plan_one(shards, template, reduce, i))
    return to_pf(plan) if pf else plan


def _stack_from(per_part):
    """Assert the statics agree (the engine replays every part with one
    shared static) and stack the arrays with a leading part axis."""
    statics = [st for st, _ in per_part]
    assert all(st == statics[0] for st in statics[1:]), (
        "parts must share one plan static")
    num_parts = len(per_part)
    stacked = tuple(
        np.stack([per_part[i][1][j] for i in range(num_parts)])
        for j in range(len(per_part[0][1]))
    )
    return statics[0], stacked


def _stack_parts(num_parts: int, plan_one):
    """Per-part plan fan-out shared by every *_shards planner: plan each
    part on the planning thread pool (_map_parts — each plan_one is a
    pure function of its part's arrays, so parallelism is bitwise-free),
    then assert/stack via _stack_from."""
    def one(i):
        st, a = plan_one(i)
        return st, tuple(a)

    return _stack_from(_map_parts(num_parts, one))


def _expand_plan_one(shards, i: int):
    arrays = shards.arrays
    m = int(np.count_nonzero(arrays.edge_mask[i]))
    return plan_expand(np.asarray(arrays.src_pos[i]), m,
                       shards.spec.gathered_size)


def plan_expand_shards(shards, pf: bool = False):
    """Plan the routed expand for every part of a PullShards bundle.

    Returns ``(ExpandStatic, tuple of (P, ...) stacked arrays)`` — the
    form the engine consumes (engine/pull.py ``route=``; numpy here,
    :func:`plan_to_device` moves the arrays).  All parts share one static
    (same e_pad / gathered size → same dims), asserted here.
    ``pf=True`` returns the pass-fused form (see to_pf).
    """
    plan = _stack_parts(shards.arrays.src_pos.shape[0],
                        lambda i: _expand_plan_one(shards, i))
    return to_pf(plan) if pf else plan


# ---------------------------------------------------------------------------
# the routed load of wide (V, K) destination-dependent programs (CF)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CFRouteStatic:
    """Routed load for WIDE (V, K) programs that read the destination's
    state per edge (collaborative filtering): the source gather routes
    per feature column through ``src``, and the destination-state read
    ``local_state[dst_local]``, also a gather of sorted runs, through
    ``dst`` (an expand plan over the part's local state)."""

    src: ExpandStatic
    dst: ExpandStatic


def _cf_plan_one(shards, i: int):
    """ONE part's CF route plan."""
    arrays = shards.arrays
    v_pad = arrays.row_ptr.shape[1] - 1
    m = int(np.count_nonzero(arrays.edge_mask[i]))
    s_src, a_src = plan_expand(np.asarray(arrays.src_pos[i]), m,
                               shards.spec.gathered_size)
    s_dst, a_dst = plan_expand(np.asarray(arrays.dst_local[i]), m, v_pad)
    return CFRouteStatic(src=s_src, dst=s_dst), tuple(a_src) + tuple(a_dst)


def plan_cf_route_shards(shards, pf: bool = False):
    """(CFRouteStatic, stacked arrays) for the wide destination-dependent
    pull: the src plan's arrays, then the dst plan's (split by the
    statics' array counts).  ``pf=True``: both sub-plans pass-fused."""
    plan = _stack_parts(shards.arrays.src_pos.shape[0],
                        lambda i: _cf_plan_one(shards, i))
    return to_pf(plan) if pf else plan


def apply_cf_route(full_state: torch.Tensor, local_state: torch.Tensor,
                   static: CFRouteStatic, arrays):
    """(src_state (e_pad, K), dst_state (e_pad, K)) through routed expands,
    one feature column at a time (each column made contiguous, then
    replayed as 1-D state); on real edge slots bitwise equal to the
    direct gathers ``full_state[src_pos]`` and ``local_state[dst_local]``."""
    n_src = _num_expand_arrays(static.src)
    a_src, a_dst = arrays[:n_src], arrays[n_src:]

    def columns(state, st, arr):
        return torch.stack([apply_expand(state[:, c].contiguous(), st, arr)
                            for c in range(state.shape[1])], dim=1)

    return (columns(full_state, static.src, a_src),
            columns(local_state, static.dst, a_dst))


def plan_to_device(plan, device):
    """A (static, arrays) plan with its arrays — numpy or tensors — as
    tensors on ``device`` (dtypes kept: uint8 indices stay uint8; arrays
    already there are not copied).  Planning is set-up: call this once,
    outside any timed window."""
    static, arrays = plan
    return static, tuple(
        (torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray)
         else a).to(device) for a in arrays)



# ---------------------------------------------------------------------------
# the per-part plan disk cache
# ---------------------------------------------------------------------------
#
# Counterpart of the reference's cached planners (``lux_tpu.ops.expand``
# ``plan_*_shards_cached``): one npz entry PER PART, keyed on that part's
# own index arrays, so a recut or a compaction that reuses the cuts
# reloads every untouched part and rebuilds only the changed ones.  The
# entry holds the arrays under index keys and the static as a JSON blob
# over this module's own dataclasses — no pickle, so loading an entry
# cannot run code.  The port's entries never meet the reference's: the
# default directory and the key salt are the port's own.

#: plan layout version of the port's entries (bump on any change to the
#: planners' output); PF_FORMAT / MX_FORMAT salt the pass-fused and
#: mxreduce families on top of it
PLAN_FORMAT = 1
PF_FORMAT = 1
MX_FORMAT = 1
FUSED_FORMAT = 1
#: the key salt's prefix: keeps the port's entry names disjoint from the
#: reference's even in one directory
CACHE_SALT = "lux_tpu_torch"

_PLAN_STATS_LOCK = threading.Lock()
_PLAN_STATS = {"cold_s": 0.0, "warm_s": 0.0, "built": 0, "loaded": 0}


def _stats_add(kind: str, seconds: float) -> None:
    with _PLAN_STATS_LOCK:
        _PLAN_STATS[f"{kind}_s"] += seconds
        _PLAN_STATS["built" if kind == "cold" else "loaded"] += 1


def plan_stats_snapshot() -> dict:
    """This process's plan accounting: ``cold_s`` seconds BUILDING plan
    entries (cache misses), ``warm_s`` seconds LOADING them, and the
    entry counts.  Threaded builds sum per-entry wall time."""
    with _PLAN_STATS_LOCK:
        return dict(_PLAN_STATS)


def reset_plan_stats() -> None:
    with _PLAN_STATS_LOCK:
        for k in _PLAN_STATS:
            _PLAN_STATS[k] = 0.0 if k.endswith("_s") else 0


def _hash_array(h, a) -> None:
    """Fold ONE array into a cache key: shape + dtype + bytes (byte-equal
    arrays of another shape or dtype must never collide)."""
    a = np.ascontiguousarray(a)
    h.update(f"{a.shape}:{a.dtype.str}:".encode())
    h.update(a.tobytes())


def _entry_path(cache_dir: str, tag: str, key_one, i: int) -> str:
    """Disk path of ONE part's plan entry: sha1 over the (CACHE_SALT,
    tag, PLAN_FORMAT, idx8) salt plus whatever key_one(h, i) folds in."""
    h = hashlib.sha1()
    h.update(f"{CACHE_SALT}:{tag}{PLAN_FORMAT}:idx8={_idx8_enabled()}:".encode())
    key_one(h, i)
    return os.path.join(cache_dir, f"{tag}_{h.hexdigest()[:16]}.npz")


def _default_cache_dir() -> str:
    """The port's per-user plan cache directory (vetted by
    _cache_dir_trusted before any read or write).  LUX_TORCH_PLAN_CACHE
    overrides it."""
    env = os.environ.get("LUX_TORCH_PLAN_CACHE")
    if env:
        return env
    uid = os.getuid() if hasattr(os, "getuid") else "na"
    return os.path.join(tempfile.gettempdir(), f"lux_torch_expand_plans_{uid}")


def _cache_dir_trusted(cache_dir: str) -> bool:
    """Create (0o700) and vet the cache directory: refuse one that is a
    symlink, not a directory, not owned by this uid, or group/world-
    writable — for loading AND for storing (the parent is the shared
    temp directory, so another local user could pre-create the path)."""
    try:
        os.makedirs(cache_dir, mode=0o700, exist_ok=True)
        st = os.lstat(cache_dir)
    except OSError:
        return False
    if stat.S_ISLNK(st.st_mode) or not stat.S_ISDIR(st.st_mode):
        return False
    if hasattr(os, "getuid") and st.st_uid != os.getuid():
        return False
    return not st.st_mode & 0o022


#: the dataclasses a cached static may contain: the decoder builds only
#: these (nothing in an entry can name other code)
_STATIC_TYPES = {
    cls.__name__: cls
    for cls in (ExpandStatic, FusedStatic, CFRouteStatic, FFStatic,
                FFLevelStatic, shuf.StaticRoute, shuf.StaticPass,
                shuf.StaticRoutePF, shuf.StaticGroup, shuf.StaticStep,
                shuf.StaticMXGroup)
}


def _static_to_obj(x):
    """Plan static -> JSON-able tree (dataclasses tagged by name)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        if type(x).__name__ not in _STATIC_TYPES:
            raise TypeError(f"unserializable plan-static type: {type(x)}")
        return {"__type__": type(x).__name__,
                "fields": {f.name: _static_to_obj(getattr(x, f.name))
                           for f in dataclasses.fields(x)}}
    if isinstance(x, tuple):
        return {"__tuple__": [_static_to_obj(v) for v in x]}
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    raise TypeError(f"unserializable plan-static field: {type(x)}")


def _static_from_obj(o):
    if isinstance(o, dict) and "__type__" in o:
        cls = _STATIC_TYPES[o["__type__"]]
        return cls(**{k: _static_from_obj(v) for k, v in o["fields"].items()})
    if isinstance(o, dict) and "__tuple__" in o:
        return tuple(_static_from_obj(v) for v in o["__tuple__"])
    return o


def _save_plan(path: str, plan) -> None:
    """(static, arrays) -> one npz (arrays under index keys, the static
    as a JSON byte blob), written to a temporary name and renamed."""
    static, arrays = plan
    blob = np.frombuffer(json.dumps(_static_to_obj(static)).encode(), np.uint8)
    payload = {f"a{i}": np.asarray(a) for i, a in enumerate(arrays)}
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __static__=blob, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_plan(path: str):
    with np.load(path, allow_pickle=False) as z:
        static = _static_from_obj(json.loads(bytes(z["__static__"]).decode()))
        arrays = tuple(z[f"a{i}"] for i in range(len(z.files) - 1))
    return static, arrays


def _cached_part_fn(tag: str, num_parts: int, key_one, build_one,
                    cache_dir: str | None = None, paths=None, validate=None):
    """Per-part disk-cached plan getter: returns ``one(i) -> (static,
    arrays)``.  ``validate`` (static -> bool) guards a family against
    entries of the wrong plan FORM; such an entry, like a corrupt one,
    is rebuilt and overwritten.  A failed store costs cache warmth,
    never the run; an untrusted directory is neither read nor written."""
    cache_dir = cache_dir or _default_cache_dir()
    trusted = _cache_dir_trusted(cache_dir)
    if paths is None and trusted:
        paths = [_entry_path(cache_dir, tag, key_one, i) for i in range(num_parts)]

    def one(i):
        path = paths[i] if trusted else None
        if path is not None and os.path.exists(path):
            t0 = time.perf_counter()
            try:
                static, arrays = _load_plan(path)
                if validate is not None and not validate(static):
                    raise ValueError("entry is not of this plan family's form")
                _stats_add("warm", time.perf_counter() - t0)
                return static, arrays
            except (OSError, ValueError, KeyError, TypeError) as e:
                print(f"# plan cache ignored ({path}): {e}", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        static, arrays = build_one(i)
        _stats_add("cold", time.perf_counter() - t0)
        if path is not None:
            try:
                _save_plan(path, (static, arrays))
            except (OSError, TypeError, ValueError) as e:
                print(f"# plan cache not written ({path}): {e}", file=sys.stderr,
                      flush=True)
        return static, tuple(arrays)

    return one


def _cached_stack(tag: str, num_parts: int, key_one, build_one,
                  cache_dir: str | None = None, paths=None, validate=None):
    """A plan family cached one entry per part: misses build on the
    planning pool, hits load; the parts' statics must agree."""
    one = _cached_part_fn(tag, num_parts, key_one, build_one, cache_dir, paths,
                          validate=validate)
    return _stack_from(_map_parts(num_parts, one))


def _warm_paths(tag: str, num_parts: int, key_one, cache_dir: str | None):
    """Per-part cache paths when the whole family is a pure disk load
    (EVERY entry present), else None."""
    cache_dir = cache_dir or _default_cache_dir()
    if not _cache_dir_trusted(cache_dir):
        return None
    paths = tuple(_entry_path(cache_dir, tag, key_one, i) for i in range(num_parts))
    return paths if all(os.path.exists(p) for p in paths) else None


def _pf_salt() -> str:
    """Key salt of pass-fused entries: the pf layout version and the
    fusion knobs, which are baked into the frozen static."""
    blk, grp, smem = shuf._pf_defaults()
    return f":pfv{PF_FORMAT}:{blk}:{grp}:{smem}"


def _mx_salt() -> str:
    """Key salt of mxreduce entries: the pf salt plus the mx geometry
    knobs (suffix block bound, tile rows, v_blk)."""
    blk, rows, vb = shuf._mx_defaults()
    return _pf_salt() + f":mx{MX_FORMAT}:{blk}:{rows}:{vb}"


def _salted(base_key_one, salt: str):
    salt_b = salt.encode()

    def key_one(h, i):
        base_key_one(h, i)
        h.update(salt_b)

    return key_one


def _pf_key_one(base_key_one):
    return _salted(base_key_one, _pf_salt())


def _mx_key_one(base_key_one):
    return _salted(base_key_one, _mx_salt())


def _pf_form(static) -> bool:
    """Family guard of the "*-pf" tags: the plain PASS-FUSED form."""
    if isinstance(static, CFRouteStatic):
        return _pf_form(static.src) and _pf_form(static.dst)
    if getattr(static, "mx", None) is not None:
        return False
    return isinstance(static.r1, shuf.StaticRoutePF)


def _mx_form(static) -> bool:
    """Family guard of the "fused-mx-*" tags: an MXREDUCE plan."""
    return (isinstance(static, FusedStatic) and static.mx is not None
            and isinstance(static.r1, shuf.StaticRoutePF))


def _plain_form(kind):
    """Family guard of the unfused tags: a ``kind`` static with unfused
    routes (a CF static: both sub-plans unfused expands)."""
    def ok(static) -> bool:
        if kind is CFRouteStatic:
            return (isinstance(static, CFRouteStatic)
                    and all(_plain_form(ExpandStatic)(s) for s in (static.src, static.dst)))
        return (isinstance(static, kind) and getattr(static, "mx", None) is None
                and isinstance(static.r1, shuf.StaticRoute))
    return ok


def _expand_key_one(shards):
    arrays = shards.arrays

    def key_one(h, i):
        _hash_array(h, arrays.src_pos[i])
        _hash_array(h, arrays.edge_mask[i])
        h.update(str(shards.spec.gathered_size).encode())

    return key_one


def _fused_key_one(shards, template):
    arrays = shards.arrays
    tmpl_salt = json.dumps(sorted(template.items())).encode()

    def key_one(h, i):
        for f in (arrays.src_pos[i], arrays.dst_local[i], arrays.weights[i],
                  arrays.edge_mask[i]):
            _hash_array(h, f)
        v_pad = arrays.row_ptr.shape[1] - 1
        h.update(f"{shards.spec.gathered_size}:{v_pad}".encode())
        h.update(f":fusedv{FUSED_FORMAT}".encode())
        h.update(tmpl_salt)

    return key_one


def _cf_key_one(shards):
    arrays = shards.arrays
    v_pad = arrays.row_ptr.shape[1] - 1

    def key_one(h, i):
        for f in (arrays.src_pos[i], arrays.dst_local[i], arrays.edge_mask[i]):
            _hash_array(h, f)
        h.update(f"{shards.spec.gathered_size}:{v_pad}".encode())

    return key_one


def plan_expand_shards_cached(shards, cache_dir: str | None = None,
                              cache_path=None, pf: bool = False):
    """plan_expand_shards with the per-part disk cache keyed on each
    part's gather layout (src_pos + edge_mask bytes + gathered size).
    ``pf=True``: the pass-fused family ("expand-pf"); a pf miss loads (or
    builds AND caches) the unfused entry and upgrades it with the numpy
    transform, so the coloring is never paid twice.  ``cache_path``: a
    has_cached_expand_plan result of the same ``pf``, to skip hashing."""
    num = shards.arrays.src_pos.shape[0]
    key_one = _expand_key_one(shards)
    paths = list(cache_path) if cache_path else None
    if not pf:
        return _cached_stack("expand", num, key_one,
                             lambda i: _expand_plan_one(shards, i), cache_dir,
                             paths=paths, validate=_plain_form(ExpandStatic))
    base_one = _cached_part_fn("expand", num, key_one,
                               lambda i: _expand_plan_one(shards, i), cache_dir,
                               validate=_plain_form(ExpandStatic))
    return _cached_stack("expand-pf", num, _pf_key_one(key_one),
                         lambda i: _to_pf_one(*base_one(i)), cache_dir,
                         paths=paths, validate=_pf_form)


def has_cached_expand_plan(shards, cache_dir: str | None = None, pf: bool = False):
    """The per-part cache paths when plan_expand_shards_cached would be a
    pure disk load (every entry present), else None."""
    key_one = _expand_key_one(shards)
    num = shards.arrays.src_pos.shape[0]
    if pf:
        return _warm_paths("expand-pf", num, _pf_key_one(key_one), cache_dir)
    return _warm_paths("expand", num, key_one, cache_dir)


def plan_fused_shards_cached(shards, reduce: str = "sum",
                             cache_dir: str | None = None, pf: bool = False,
                             mx: bool | None = False):
    """plan_fused_shards with the per-part disk cache (the reduce joins
    the tag).  Each part's key folds the SHARED group template, so a
    recut that changes any part's width-class census invalidates exactly
    the parts it must.  ``pf=True``: the pass-fused family; ``mx`` (True,
    or None following engine/methods.reduce_mode): the mxreduce family,
    its own "fused-mx-<reduce>" tag and key salt."""
    template = _group_template(shards.arrays)
    num = shards.arrays.src_pos.shape[0]
    key_one = _fused_key_one(shards, template)
    if resolve_fused_mx(mx):
        return _cached_stack(
            f"fused-mx-{reduce}", num, _mx_key_one(key_one),
            lambda i: _fused_plan_one(shards, template, reduce, i, mx=True),
            cache_dir, validate=_mx_form)
    base_one = _cached_part_fn(
        f"fused-{reduce}", num, key_one,
        lambda i: _fused_plan_one(shards, template, reduce, i), cache_dir,
        validate=_plain_form(FusedStatic))
    if not pf:
        return _stack_from(_map_parts(num, base_one))
    return _cached_stack(f"fused-pf-{reduce}", num, _pf_key_one(key_one),
                         lambda i: _to_pf_one(*base_one(i)), cache_dir,
                         validate=_pf_form)


def has_cached_fused_plan(shards, reduce: str = "sum", cache_dir: str | None = None,
                          pf: bool = False, mx: bool | None = False):
    """Per-part paths when the fused plan family is fully cached, else
    None."""
    template = _group_template(shards.arrays)
    key_one = _fused_key_one(shards, template)
    num = shards.arrays.src_pos.shape[0]
    if resolve_fused_mx(mx):
        return _warm_paths(f"fused-mx-{reduce}", num, _mx_key_one(key_one), cache_dir)
    if pf:
        return _warm_paths(f"fused-pf-{reduce}", num, _pf_key_one(key_one), cache_dir)
    return _warm_paths(f"fused-{reduce}", num, key_one, cache_dir)


def plan_cf_route_shards_cached(shards, cache_dir: str | None = None, pf: bool = False):
    """plan_cf_route_shards with the per-part disk cache."""
    num = shards.arrays.src_pos.shape[0]
    key_one = _cf_key_one(shards)
    base_one = _cached_part_fn("cf", num, key_one, lambda i: _cf_plan_one(shards, i),
                               cache_dir, validate=_plain_form(CFRouteStatic))
    if not pf:
        return _stack_from(_map_parts(num, base_one))
    return _cached_stack("cf-pf", num, _pf_key_one(key_one),
                         lambda i: _to_pf_one(*base_one(i)), cache_dir,
                         validate=_pf_form)


def has_cached_cf_plan(shards, cache_dir: str | None = None, pf: bool = False):
    """Per-part paths when the CF plan family is fully cached, else None."""
    key_one = _cf_key_one(shards)
    num = shards.arrays.src_pos.shape[0]
    if pf:
        return _warm_paths("cf-pf", num, _pf_key_one(key_one), cache_dir)
    return _warm_paths("cf", num, key_one, cache_dir)
