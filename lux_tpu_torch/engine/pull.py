"""The pull (gather) execution engine.

Counterpart of ``lux_tpu.engine.pull`` on the direct path.  Every
iteration, each part reads the WHOLE previous vertex state and writes
only its own contiguous slice:

    full_state  = all parts' padded states, concatenated -> (P*V, ...)
    local_state = this part's padded slice                -> (V, ...)

and one iteration per part is

    gather src states -> per-edge values -> segmented reduce by dst -> apply.

Apps plug in as ``PullProgram``s.  Parts run one after another in a
Python loop (the reference vmaps them); the iteration loop is a Python
loop too, so each iteration launches its kernels eagerly.
"""
from __future__ import annotations

from typing import Any, Callable, Protocol

import torch

from lux_tpu_torch.engine import methods
from lux_tpu_torch.graph.shards import ShardArrays, ShardSpec
from lux_tpu_torch.ops import segment


class PullProgram(Protocol):
    """A gather-apply vertex program."""

    #: "sum" | "min" | "max" — the per-destination combiner.
    reduce: str
    #: whether edge_value reads the destination's current state
    needs_dst_state: bool

    def init_state(self, global_vid: torch.Tensor, degree: torch.Tensor,
                   vtx_mask: torch.Tensor) -> Any:
        """Per-vertex initial state for one part (padded slots included)."""
        ...

    def edge_value(self, src_state: torch.Tensor, weight: torch.Tensor,
                   dst_state: torch.Tensor | None = None) -> torch.Tensor:
        """Per-edge value from the gathered source state (and weight)."""
        ...

    def apply(self, old_local: torch.Tensor, acc: torch.Tensor,
              arrays: ShardArrays) -> torch.Tensor:
        """New local state from the old state and the reduced acc."""
        ...


_REDUCERS: dict[str, Callable] = segment.reducers()


def pull_gather_part(arrays: ShardArrays, full_state: torch.Tensor,
                     local_state: torch.Tensor, with_dst: bool):
    """LOAD phase for ONE part: the per-edge source-state gather, and the
    per-edge destination-state read (sentinel-clipped) when the program
    needs it."""
    src_state = full_state.index_select(0, arrays.src_pos)  # int32 as is
    if not with_dst:
        return src_state, None
    dst = arrays.dst_local.clamp(0, local_state.shape[0] - 1)
    return src_state, local_state.index_select(0, dst)


def pull_reduce_part(prog: PullProgram, arrays: ShardArrays, gath,
                     method: str) -> torch.Tensor:
    """COMP phase for ONE part: per-edge values + segmented reduce by
    destination."""
    src_state, dst_state = gath
    vals = prog.edge_value(src_state, arrays.weights, dst_state)
    return _REDUCERS[prog.reduce](
        vals, arrays.row_ptr, arrays.head_flag, arrays.dst_local, method=method)


def local_pull_step(prog: PullProgram, arrays: ShardArrays,
                    full_state: torch.Tensor, local_state: torch.Tensor,
                    method: str = "scan") -> torch.Tensor:
    """One pull iteration for ONE part.  ``full_state`` is the (P*V, ...)
    concatenated padded state of all parts; ``local_state`` is (V, ...)."""
    gath = pull_gather_part(arrays, full_state, local_state,
                            prog.needs_dst_state)
    acc = pull_reduce_part(prog, arrays, gath, method)
    return prog.apply(local_state, acc, arrays)


def init_state(prog: PullProgram, arrays: ShardArrays) -> torch.Tensor:
    """Stacked (P, V, ...) initial state, one part at a time."""
    P = arrays.global_vid.shape[0]
    return torch.stack([
        prog.init_state(arrays.global_vid[p], arrays.degree[p], arrays.vtx_mask[p])
        for p in range(P)
    ])


def _pull_iteration(prog, spec: ShardSpec, method, arrays, state):
    """One pull iteration over the whole (P, V, ...) shard stack."""
    full = state.reshape((spec.gathered_size,) + tuple(state.shape[2:]))
    return torch.stack([
        local_pull_step(prog, arrays.part(p), full, state[p], method)
        for p in range(spec.num_parts)
    ])


def _resolve(prog, method, arrays):
    return methods.resolve_sum(
        method, prog.reduce, methods.default_platform(arrays.src_pos.device))


def run_pull_fixed(prog: PullProgram, spec: ShardSpec, arrays: ShardArrays,
                   state0: torch.Tensor, num_iters: int, method: str = "auto",
                   donate: bool = False) -> torch.Tensor:
    """Fixed iteration count (PageRank style).  ``arrays`` are torch
    tensors (graph.shards.to_device) on the state's device.
    ``method="auto"`` resolves per engine.methods.  ``donate=True`` writes
    each iteration's new state back into ``state0``'s buffer and returns
    it; otherwise ``state0`` is left untouched.  Returns the final
    stacked (P, V, ...) state."""
    method = _resolve(prog, method, arrays)
    state = state0
    for _ in range(num_iters):
        new = _pull_iteration(prog, spec, method, arrays, state)
        if donate:
            state0.copy_(new)
        else:
            state = new
    return state


def run_pull_until(prog: PullProgram, spec: ShardSpec, arrays: ShardArrays,
                   state0: torch.Tensor, max_iters: int,
                   active_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                   method: str = "auto", donate: bool = False):
    """Iterate until no vertex is active or ``max_iters`` ran.
    ``active_fn(old, new)`` gives per-part active counts (P,); the total is
    read on the host once per iteration.  ``donate`` as in
    run_pull_fixed.  Returns (final_state, num_iters_run)."""
    method = _resolve(prog, method, arrays)
    state = state0
    it = 0
    while it < max_iters:
        new = _pull_iteration(prog, spec, method, arrays, state)
        active = int(active_fn(state, new).sum())
        if donate:
            state0.copy_(new)
        else:
            state = new
        it += 1
        if active == 0:
            break
    return state, it
