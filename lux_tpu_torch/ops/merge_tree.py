"""Static reduction trees for the push engine's cross-part frontier merge.

Counterpart of ``lux_tpu.ops.merge_tree`` (single device: the staged
ppermute exchange, ``bruck_schedule``/``staged_concat_gather``, waits for
the multi-GPU port).  Instead of scattering the whole concatenated
frontier into each part at once, every source part's candidates land in
their own neutral-initialized partial accumulator, and the partials
combine pairwise up a tree whose order is fixed in advance:

* :func:`plan_tree` — the pairwise combine levels for any arity
  (non-powers of two get byes), a pure host-side plan;
* :func:`tree_combine` — that plan evaluated over a stacked ``(B, ...)``
  block of partial accumulators;
* :func:`neutral` — the combiner identity each partial starts from.

min / max / integer sum are associative and commutative in machine
arithmetic, so ``tree_combine`` is bitwise equal to any other combine
order at every arity; a float sum is not, so the push engine runs tree
merges for its min/max programs only.
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
