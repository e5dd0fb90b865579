"""On-device invariant validation (the ``-check`` edge walk).

Counterpart of ``lux_tpu.engine.validate``: after convergence, every edge
is walked once on the device and a per-edge violation indicator is
summed, so a state that lives on the card validates there, with no host
gather.  A plain tensor pass over the pull layout, one part at a time.
"""
from __future__ import annotations

from typing import Callable

import torch

from lux_tpu_torch.graph.shards import PullShards, to_device


def count_violations(shards: PullShards, state_stacked: torch.Tensor,
                     edge_violation: Callable) -> int:
    """Walk every edge on the state's device; count violations exactly.

    ``edge_violation(src_state, dst_state, weight)`` -> bool per edge;
    ``state_stacked``: the (P, V, ...) final vertex state tensor."""
    spec = shards.spec
    arrays = to_device(shards.arrays, state_stacked.device)
    full = state_stacked.reshape((spec.gathered_size,) + tuple(state_stacked.shape[2:]))
    total = torch.zeros((), dtype=torch.int64, device=state_stacked.device)
    for p in range(spec.num_parts):
        arr, local = arrays.part(p), state_stacked[p]
        src_state = full.index_select(0, arr.src_pos)
        dst_state = local.index_select(0, arr.dst_local.clamp(0, local.shape[0] - 1))
        bad = edge_violation(src_state, dst_state, arr.weights)
        total += (bad & arr.edge_mask).sum(dtype=torch.int64)
    return int(total)


def sssp_violation(inf: int, weighted: bool = False):
    """dist[dst] <= dist[src] + w for every edge with a reached source
    (w == 1 for the BFS flavor, the edge weight for the weighted one)."""

    def fn(src_state, dst_state, weight):
        w = weight.to(src_state.dtype) if weighted else 1
        return (dst_state > src_state + w) & (src_state < inf)

    return fn


def cc_violation():
    """label[dst] >= label[src] on every edge."""

    def fn(src_state, dst_state, weight):
        del weight
        return dst_state < src_state

    return fn
