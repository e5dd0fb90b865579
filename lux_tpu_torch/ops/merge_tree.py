"""Static reduction trees for the push engine's cross-part frontier merge.

Counterpart of ``lux_tpu.ops.merge_tree``.  Instead of scattering the
whole concatenated frontier into each part at once, every source part's
candidates land in their own neutral-initialized partial accumulator, and
the partials combine pairwise up a tree whose order is fixed in advance:

* :func:`plan_tree` — the pairwise combine levels for any arity
  (non-powers of two get byes), a pure host-side plan;
* :func:`tree_combine` — that plan evaluated over a stacked ``(B, ...)``
  block of partial accumulators;
* :func:`neutral` — the combiner identity each partial starts from;
* :func:`staged_concat_gather` — the distributed push engine's queue
  exchange as ceil(log2 W) staged point-to-point rounds (a Bruck
  concatenation, offsets from :func:`bruck_schedule`) instead of one
  all-gather.

min / max / integer sum are associative and commutative in machine
arithmetic, so ``tree_combine`` is bitwise equal to any other combine
order at every arity; a float sum is not, so the push engine runs tree
merges for its min/max programs only.  The staged gather leaves each
rank the whole queue in a ROTATED part order; every consumer is a sum
(walk totals) or a min/max (the scatter), so results stay bitwise.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch


@lru_cache(maxsize=None)
def plan_tree(arity: int) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """The static pairwise combine schedule for ``arity`` partials.

    Returns a tuple of levels; each level is a tuple of ``(dst, src)``
    index pairs meaning "combine partial ``src`` into partial ``dst``".
    Indices not named at a level carry through unchanged (byes).  Level
    count is ceil(log2(arity)); an arity of 0 or 1 has no levels.
    """
    if arity < 0:
        raise ValueError(f"arity must be >= 0, got {arity}")
    levels = []
    live = list(range(arity))
    while len(live) > 1:
        pairs = []
        nxt = []
        i = 0
        while i + 1 < len(live):
            pairs.append((live[i], live[i + 1]))
            nxt.append(live[i])
            i += 2
        if i < len(live):
            nxt.append(live[i])  # bye: the odd survivor rides up untouched
        levels.append(tuple(pairs))
        live = nxt
    return tuple(levels)


def tree_depth(arity: int) -> int:
    return len(plan_tree(arity))


def tree_combine(partials: torch.Tensor, op) -> torch.Tensor:
    """Combine a stacked ``(B, ...)`` block of partial accumulators up the
    :func:`plan_tree` schedule; returns the ``(...)`` root.  ``op`` is the
    elementwise combiner (``torch.minimum`` / ``torch.maximum`` /
    ``torch.add``); each level is one ``op`` call on two strided slices."""
    b = partials.shape[0]
    if b == 0:
        raise ValueError("tree_combine needs at least one partial")
    while b > 1:
        even = (b // 2) * 2
        nxt = op(partials[0:even:2], partials[1:even:2])
        if b % 2:
            nxt = torch.cat([nxt, partials[even:]], dim=0)
        partials = nxt
        b = partials.shape[0]
    return partials[0]


def neutral(reduce: str, dtype: torch.dtype):
    """The combiner identity a partial accumulator starts from, as a
    Python scalar: 0 for sum; the dtype's extremes for integer min/max;
    +-inf for float min/max."""
    if reduce == "sum":
        return 0
    if reduce not in ("min", "max"):
        raise ValueError(f"unknown reduce {reduce!r}")
    if dtype.is_floating_point:
        return float("inf") if reduce == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if reduce == "min" else info.min


def bruck_schedule(num_ranks: int) -> Tuple[int, ...]:
    """The static offsets of :func:`staged_concat_gather`: doubling strides
    ``(1, 2, 4, ...)`` below ``num_ranks``, ceil(log2 W) rounds (none at
    W = 1)."""
    if num_ranks < 1:
        raise ValueError(f"num_ranks must be >= 1, got {num_ranks}")
    offs = []
    s = 1
    while s < num_ranks:
        offs.append(s)
        s *= 2
    return tuple(offs)


def staged_concat_gather(block: torch.Tensor, pg) -> torch.Tensor:
    """Concatenate every rank's ``(k, ...)`` block along the ranks in
    staged point-to-point rounds (``pg`` a parallel.mesh.PartsGroup).

    Bruck construction: in the round of offset ``s`` each rank sends its
    buffer to rank ``(r - s) % W`` and appends the buffer it receives from
    rank ``(r + s) % W``, then keeps the first W rank blocks.  After the
    rounds rank ``r`` holds the blocks of ranks ``r, r+1, ..., r+W-1``
    (mod W): the whole concatenation, rotated by r.  Every rank runs the
    same rounds with the same sizes, whatever the data.  Under gloo on a
    card each round's buffers cross through pinned host memory; with
    ``pg.timed`` the copies and the transfers add to ``pg.times``."""
    import torch.distributed as dist

    from lux_tpu_torch.parallel.placement import _wire

    W, k = pg.world, block.shape[0]
    buf = block.contiguous()
    blocks = 1
    for s in bruck_schedule(W):
        t0 = pg.fence() if pg.timed else 0.0
        if pg.staged:
            send = pg.pinned(f"bruck_send_{blocks}", buf)
            send.copy_(buf)
            recv = pg.pinned(f"bruck_recv_{blocks}", buf)
        else:
            send, recv = buf, torch.empty_like(buf)
        t1 = pg.fence() if pg.timed else 0.0
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, _wire(send), pg.peer((pg.rank - s) % W),
                       group=pg.group),
            dist.P2POp(dist.irecv, _wire(recv), pg.peer((pg.rank + s) % W),
                       group=pg.group)])
        for w in works:
            w.wait()
        t2 = pg.fence() if pg.timed else 0.0
        got = recv.to(buf.device, copy=True) if pg.staged else recv
        blocks = min(2 * blocks, W)
        # the first W rank blocks of [r .. r+2s) are [r .. r+W): duplicates
        # fall off the end
        buf = torch.cat([buf, got])[: blocks * k]
        if pg.timed:
            t3 = pg.fence()
            pg.times.stage_s += (t1 - t0) + (t3 - t2)
            pg.times.collective_s += t2 - t1
            pg.times.calls += 1
    return buf
