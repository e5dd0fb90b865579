"""Synthetic graph generator for tests and benchmarks.

Stays numpy with the same RNG sequences as ``lux_tpu.graph.generate``'s
``rmat`` and ``bipartite_ratings``, so the same arguments give
byte-identical graphs in both packages.
"""
from __future__ import annotations

import numpy as np

from lux_tpu_torch.graph.csc import HostGraph, from_edge_list


def rmat(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    weighted: bool = False,
    max_weight: int = 100,
) -> HostGraph:
    """Recursive-matrix (Graph500-style) power-law graph: nv = 2**scale,
    ne = nv * edge_factor.  The draw is a ``graph.generate`` recorder
    span."""
    from lux_tpu_torch import obs

    with obs.span("graph.generate", kind="rmat", scale=scale, ef=edge_factor,
                  seed=seed):
        return _rmat_impl(scale, edge_factor, a, b, c, seed, weighted, max_weight)


def _rmat_impl(scale, edge_factor, a, b, c, seed, weighted, max_weight) -> HostGraph:
    rng = np.random.default_rng(seed)
    nv = 1 << scale
    ne = nv * edge_factor
    src = np.zeros(ne, dtype=np.int64)
    dst = np.zeros(ne, dtype=np.int64)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for bit in range(scale):
        r1 = rng.random(ne)
        r2 = rng.random(ne)
        src_bit = r1 > ab
        dst_bit = np.where(src_bit, r2 > c_norm, r2 > a_norm)
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    # permute vertex labels to avoid degree locality artifacts
    perm = rng.permutation(nv)
    src = perm[src]
    dst = perm[dst]
    w = (rng.integers(1, max_weight + 1, size=ne).astype(np.int32)
         if weighted else None)
    return from_edge_list(src, dst, nv, weights=w)


def bipartite_ratings(
    n_users: int, n_items: int, n_ratings: int, seed: int = 0, max_rating: int = 5
) -> HostGraph:
    """Weighted bipartite rating graph with every rating as an edge in BOTH
    directions (user -> item and item -> user), so that collaborative
    filtering, which updates destinations only, trains both sides.  Users
    are vertices [0, n_users), items [n_users, n_users + n_items); ratings
    are uniform in [1, max_rating]."""
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, size=n_ratings)
    items = rng.integers(0, n_items, size=n_ratings) + n_users
    ratings = rng.integers(1, max_rating + 1, size=n_ratings).astype(np.int32)
    src = np.concatenate([users, items])
    dst = np.concatenate([items, users])
    w = np.concatenate([ratings, ratings])
    return from_edge_list(src, dst, n_users + n_items, weights=w)
