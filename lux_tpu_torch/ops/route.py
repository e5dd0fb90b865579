"""Host-side Benes/Clos routing: any fixed permutation as per-digit gathers.

Counterpart of ``lux_tpu.ops.route`` (numpy; a copy, so the port never
imports the reference).  The routed pull re-expresses the per-edge state
read ``state[src_pos]`` as data movement, and a gather can only move
data along a narrow axis: the 128-wide lane row of the lane kernel, or a
digit of at most 8 in the sublane kernel (ops/shuffle.py).  So an
arbitrary N-element permutation is routed through those widths.

Factor N into "digits" from {128, 8, 4, 2}, view the flat array as a
mixed-radix hypercube, and decompose the permutation Clos-style:

    route(pi over (D, M)) = [gather along D] o [per-d route over M] o
                            [gather along D]

which yields 2k-1 passes for k digits (a Benes network of radix-128/8
stages).  Each pass gathers along exactly ONE digit, batched over all
others, and the middle recursion is batched, so all leaves of one level
share a single physical pass.  Pass index arrays are precomputed HERE,
once per graph; the device replays them every iteration.

The stage-1/3 index construction is an edge coloring of the D-regular
bipartite multigraph between source and destination middle-coordinates:
repeated Euler splits halve the regularity until single matchings remain
(possible because digits are powers of two).  numpy here; the native
colorer (lux_tpu_torch/native/lux_route.cc) computes the same contract
much faster at benchmark scale.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from lux_tpu_torch import native

#: digits a pass may gather along: 128 rides the lane kernel, <= 8 the
#: sublane kernel (the reference's widths, kept so plans are identical).
LANE = 128
MAX_SUBLANE = 8


def factor_digits(n: int) -> list[int]:
    """Factor ``n`` (a power of two, >= 2) into gatherable digits,
    most-significant first: as many 128s as possible, then one 8/4/2
    remainder digit (kept in the MIDDLE recursion where it costs one
    pass, not two)."""
    if n & (n - 1) or n < 2:
        raise ValueError(f"n must be a power of two >= 2, got {n}")
    digits = []
    while n >= LANE:
        digits.append(LANE)
        n //= LANE
    while n > 1:
        d = min(n, MAX_SUBLANE)
        digits.append(d)
        n //= d
    # middle digit is cheapest (appears once in the Benes pass list):
    # put the small remainder digit innermost
    return digits


def benes_axes(k: int) -> tuple[int, ...]:
    """The gathered-axis sequence of the 2k-1 Benes passes (the "V"
    order build_route emits: dims[min(j, 2k-2-j)] for pass j)."""
    return tuple(min(j, 2 * k - 2 - j) for j in range(2 * k - 1))


def plan_fusion_groups(dims, max_block_elems: int = 1 << 17,
                       max_group: int = 3) -> tuple[int, ...]:
    """Pack the Benes pass sequence into consecutive FUSION GROUPS for
    the pass-fused device replay (ops/shuffle.plan_route_pf).

    A group of passes can chain inside one kernel with intermediates
    held in shared memory exactly when every inter-pass relayout stays
    local to the block spanned by the group's gathered digits: the
    block size is the product of the group's DISTINCT digit dims (axes
    repeat across the Benes "V" turn — e.g. passes gathering axes
    (2, 3, 2) span only dims[2]*dims[3]).  ``max_block_elems`` is the
    on-chip budget expressed in elements (the kernel holds the data
    tile in two ping-pong buffers); ``max_group`` bounds the number of
    index operands per kernel.  Returns the group LENGTHS, summing to
    2k-1.

    Greedy left-to-right packing: each pass joins the current group
    while the distinct-digit block stays within budget.  Purely a
    function of (dims, knobs) — every part of a multi-part plan gets
    the identical grouping, which the stacked-plan replay relies on.
    """
    if max_block_elems < LANE:
        raise ValueError(f"max_block_elems must be >= {LANE}, "
                         f"got {max_block_elems}")
    if max_group < 1:
        raise ValueError(f"max_group must be >= 1, got {max_group}")
    axes = benes_axes(len(dims))
    return _pack_axes(dims, axes, max_block_elems, max_group)


def _pack_axes(dims, axes, max_block_elems: int,
               max_group: int) -> tuple[int, ...]:
    """Greedy left-to-right packing of ``axes`` (a slice of the Benes
    pass sequence) into fusion groups under the distinct-digit block
    budget — the shared engine behind plan_fusion_groups and the
    mxreduce grouping (plan_mx_fusion_groups)."""
    groups: list[int] = []
    cur: list[int] = []  # distinct axes of the current group, in order
    cur_len = 0
    for a in axes:
        nxt = cur if a in cur else cur + [a]
        blk = 1
        for x in nxt:
            blk *= dims[x]
        if cur and (blk > max_block_elems or cur_len >= max_group):
            groups.append(cur_len)
            cur, cur_len = [a], 1
        else:
            cur, cur_len = list(nxt), cur_len + 1
    if cur_len:
        groups.append(cur_len)
    assert sum(groups) == len(axes), (groups, axes)
    return tuple(groups)


def plan_mx_fusion_groups(dims, max_block_elems: int = 1 << 17,
                          max_group: int = 3,
                          mx_max_block: int = 1024
                          ) -> tuple[tuple[int, ...], int]:
    """Fusion grouping for an MXREDUCE route (ops/shuffle
    ``plan_route_pf_mx``): the FINAL group is the longest pass suffix
    whose distinct-digit block fits ``mx_max_block`` — that group's
    kernel chains the suffix gathers AND the segmented reduction on the
    same on-chip tile, so its block size also bounds the
    reduce tile (the rank-block alignment padding in ops/expand's mx
    layout is a multiple of the tile span; a big suffix block would
    inflate the group space).  The prefix packs greedily exactly like
    plan_fusion_groups.

    Returns ``(group_sizes, suffix_len)`` with
    ``group_sizes[-1] == suffix_len``; the final Benes pass gathers
    digit 0 (dim <= 128), so a valid suffix always exists."""
    if mx_max_block < LANE:
        raise ValueError(f"mx_max_block must be >= {LANE}, "
                         f"got {mx_max_block}")
    if max_group < 1:
        raise ValueError(f"max_group must be >= 1, got {max_group}")
    axes = benes_axes(len(dims))
    suffix = 0
    for ln in range(1, min(max_group, len(axes)) + 1):
        distinct = set(axes[-ln:])
        blk = 1
        for a in distinct:
            blk *= dims[a]
        if blk > mx_max_block:
            break
        suffix = ln
    assert suffix >= 1, (dims, mx_max_block)
    prefix = (_pack_axes(dims, axes[:-suffix], max_block_elems,
                         max_group) if len(axes) > suffix else ())
    return prefix + (suffix,), suffix


@dataclasses.dataclass
class Pass:
    """One device pass: gather along ``digit`` (size ``dim``) with the
    digit at position ``axis`` of the mixed-radix ``shape``; ``idx`` is
    the full-size int32 gather index array, laid out in ``shape`` order,
    values in [0, dim)."""

    shape: tuple[int, ...]
    axis: int
    idx: np.ndarray  # shape == self.shape, int32


@dataclasses.dataclass
class Route:
    """A routed permutation: applying ``passes`` in order to ``x``
    (flattened mixed-radix layout) yields ``x[perm]``."""

    n: int
    dims: tuple[int, ...]
    passes: list[Pass]


def _split_regular(u: np.ndarray, v: np.ndarray, deg: int, nl: int, nr: int):
    """Split a deg-regular bipartite multigraph (edges u[i]->v[i], u in
    [0,nl), v in [0,nr)) into two (deg/2)-regular halves via an Euler
    partition.  Returns a bool mask (True = first half).  Pure Python
    pointer walk — the reference implementation and small-N path."""
    m = len(u)
    # incidence CSR per side (stable argsort = vectorized bucket fill)
    l_off = np.zeros(nl + 1, np.int64)
    np.add.at(l_off[1:], u, 1)
    np.cumsum(l_off, out=l_off)
    l_edges = np.argsort(u, kind="stable")
    r_off = np.zeros(nr + 1, np.int64)
    np.add.at(r_off[1:], v, 1)
    np.cumsum(r_off, out=r_off)
    r_edges = np.argsort(v, kind="stable")

    used = np.zeros(m, bool)
    half = np.zeros(m, bool)
    l_ptr = l_off[:-1].copy()
    r_ptr = r_off[:-1].copy()

    def _next_l(node):
        p = l_ptr[node]
        stop = l_off[node + 1]
        while p < stop and used[l_edges[p]]:
            p += 1
        l_ptr[node] = p
        return l_edges[p] if p < stop else -1

    def _next_r(node):
        p = r_ptr[node]
        stop = r_off[node + 1]
        while p < stop and used[r_edges[p]]:
            p += 1
        r_ptr[node] = p
        return r_edges[p] if p < stop else -1

    for e0 in range(m):
        if used[e0]:
            continue
        # walk the Euler circuit containing e0, alternating halves:
        # L->R edges get the parity flag, the return R->L edge the other
        e = e0
        take = True
        while True:
            used[e] = True
            half[e] = take
            take = not take
            # continue from the right endpoint: leave via an unused edge
            nxt = _next_r(v[e])
            if nxt < 0:
                # circuit closed on the right side; all circuits in an
                # even-regular multigraph close where they started
                break
            e = nxt
            used[e] = True
            half[e] = take
            take = not take
            nxt = _next_l(u[e])
            if nxt < 0:
                break
            e = nxt
    return half


def _color_regular(u: np.ndarray, v: np.ndarray, deg: int, nl: int,
                   nr: int) -> np.ndarray:
    """Color a deg-regular bipartite multigraph with ``deg`` colors
    (deg a power of two) by recursive Euler splits; returns int32
    colors per edge, each color class a perfect matching."""
    colors = np.zeros(len(u), np.int32)
    stack = [(np.arange(len(u), dtype=np.int64), deg, 0)]
    while stack:
        sel, d, base = stack.pop()
        if d == 1:
            colors[sel] = base
            continue
        mask = _split_regular(u[sel], v[sel], d, nl, nr)
        stack.append((sel[mask], d // 2, base))
        stack.append((sel[~mask], d // 2, base + d // 2))
    return colors


def _color_regular_batched(u: np.ndarray, v: np.ndarray, deg: int,
                           nside: int,
                           n_threads: int | None = None) -> np.ndarray:
    """Color B independent deg-regular bipartite multigraphs
    (u, v: (B, n)) with deg colors each.  Native single-call path
    (native/lux_route.cc) when available — threaded over the recursion's
    independent frames (bitwise-identical for any thread count); numpy
    Euler walk per batch otherwise.  Colorings may differ between the
    two — both are valid (every color class a perfect matching), and
    route correctness is pinned on replay equality, not on specific
    colors.  Which one ran is counted in :data:`COLOR_STATS`."""
    out = native.route_color(u, v, deg, nside, n_threads=n_threads)
    if out is not None:
        _count_colorer("native")
        return out
    _count_colorer("numpy")
    return np.stack([
        _color_regular(u[b], v[b], deg, nside, nside)
        for b in range(u.shape[0])
    ])


#: colorer calls since the last reset_color_stats(): "native" (the C++
#: walk) and "numpy" (the Python walk) — what a plan report prints
COLOR_STATS = {"native": 0, "numpy": 0}
_STATS_LOCK = threading.Lock()


def _count_colorer(kind: str) -> None:
    with _STATS_LOCK:
        COLOR_STATS[kind] += 1


def reset_color_stats() -> None:
    with _STATS_LOCK:
        for k in COLOR_STATS:
            COLOR_STATS[k] = 0


def _route_rec(perms: np.ndarray, dims: list[int]) -> list[np.ndarray]:
    """Recursive Clos decomposition, batched.  ``perms`` is (B, n): B
    independent permutations, each mapping TARGET flat index -> SOURCE
    flat index over mixed-radix ``dims`` (row-major).  Returns the pass
    index arrays (B, n) outermost-first; pass j gathers along digit
    dims[min(j, 2k-2-j)] (the Benes "V" order — see build_route, which
    reshapes per pass).  Batching keeps the coloring at ONE native call
    per recursion level instead of exploding into per-subproblem Python
    calls."""
    b, n = perms.shape
    d = dims[0]
    if len(dims) == 1:
        # single digit: the permutation IS a gather along it
        return [perms.astype(np.int32)]
    m = n // d  # size of the middle (remaining digits) space
    tgt = np.arange(n, dtype=np.int64)
    src = perms.astype(np.int64)
    # coordinates: flat = digit * m + mid  (digit is OUTERMOST, row-major)
    m2 = tgt % m  # (n,) shared across batches
    d1, m1 = src // m, src % m  # (B, n)
    # color the D-regular multigraph m1 -> m2 with D colors
    colors = _color_regular_batched(
        m1, np.broadcast_to(m2, (b, n)), d, m).astype(np.int64)
    # stage 1: within each middle-coordinate m1 (a "column"), move along
    # the digit axis: element (d1, m1) -> (c, m1).  idx1[c, m1] = d1.
    idx1 = np.empty((b, n), np.int32)
    np.put_along_axis(idx1, colors * m + m1, d1.astype(np.int32), axis=1)
    # stage 2 (recurse): within each digit value c, an arbitrary
    # permutation of the middle space: target (c, m2) pulls from (c, m1)
    mid_perm = np.empty((b, n), np.int64)
    np.put_along_axis(mid_perm, colors * m + m2, m1, axis=1)
    sub = _route_rec(mid_perm.reshape(b * d, m), dims[1:])
    mids = [s.reshape(b, n) for s in sub]
    # stage 3: within each m2 column, digit c -> d2: idx3[d2, m2] = c,
    # and since target coordinates enumerate (d2, m2) in flat order this
    # is the colors array itself
    idx3 = colors.astype(np.int32)
    return [idx1] + mids + [idx3]


def build_route(perm: np.ndarray, dims: list[int] | None = None) -> Route:
    """Decompose ``perm`` (out[i] = x[perm[i]], a bijection on a
    power-of-two N) into 2k-1 digit-gather passes.

    Every pass array is returned reshaped to the full mixed-radix
    ``shape`` with ``axis`` marking the gathered digit, so the device
    side can transpose that axis into lane/sublane position and feed
    the gather kernels directly.
    """
    n = len(perm)
    if dims is None:
        dims = factor_digits(n)
    assert int(np.prod(dims)) == n, (dims, n)
    flat_passes = [
        p.reshape(-1)
        for p in _route_rec(np.asarray(perm, np.int64)[None], list(dims))
    ]
    k = len(dims)
    assert len(flat_passes) == 2 * k - 1
    shape = tuple(dims)
    passes = []
    for j, idx in enumerate(flat_passes):
        axis = min(j, 2 * k - 2 - j)
        passes.append(Pass(shape=shape, axis=axis,
                           idx=idx.reshape(shape)))
    return Route(n=n, dims=shape, passes=passes)


def apply_route_np(route: Route, x: np.ndarray) -> np.ndarray:
    """NumPy oracle: replay the passes with take_along_axis."""
    y = np.asarray(x).reshape(route.dims)
    for p in route.passes:
        y = np.take_along_axis(y, p.idx, axis=p.axis)
    return y.reshape(-1)
