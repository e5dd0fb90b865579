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

``route=`` switches to the routed pull (ops/expand.py): an
(ExpandStatic, arrays) plan replaces the LOAD phase's gather with the
routed expand (bitwise equal), a (FusedStatic, arrays) plan replaces
load AND reduce.  Route arrays are stacked per part, (P, ...).
"""
from __future__ import annotations

import ast
from typing import Any, Callable, Optional, Protocol

import torch

from lux_tpu_torch.engine import methods
from lux_tpu_torch.graph.shards import ShardArrays, ShardSpec
from lux_tpu_torch.ops import expand, segment


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


def _dst_gather(arrays: ShardArrays, local_state: torch.Tensor, with_dst: bool):
    """Per-edge destination-state read (sentinel-clipped) when the
    program needs it, shared by the direct and routed LOAD paths."""
    if not with_dst:
        return None
    dst = arrays.dst_local.clamp(0, local_state.shape[0] - 1)
    return local_state.index_select(0, dst)


def pull_gather_part(arrays: ShardArrays, full_state: torch.Tensor,
                     local_state: torch.Tensor, with_dst: bool):
    """LOAD phase for ONE part: the per-edge source-state gather, and the
    per-edge destination-state read when the program needs it."""
    src_state = full_state.index_select(0, arrays.src_pos)  # int32 as is
    return src_state, _dst_gather(arrays, local_state, with_dst)


def pull_gather_part_routed(arrays: ShardArrays, full_state: torch.Tensor,
                            local_state: torch.Tensor, route_static,
                            route_arrays, with_dst: bool):
    """LOAD phase via the routed expand (ops/expand.apply_expand): the
    per-edge state read as Benes lane shuffles, bitwise equal to the
    direct gather on every edge slot."""
    src_state = expand.apply_expand(full_state, route_static, route_arrays)
    return src_state, _dst_gather(arrays, local_state, with_dst)


def _edge_reads_weight(prog) -> bool:
    """Whether the program's edge function reads the edge weight: from
    its spec's edge expression when it has one, else assumed."""
    spec = getattr(prog, "spec", None)
    if spec is None:
        return True
    return any(isinstance(n, ast.Name) and n.id == "weight"
               for n in ast.walk(ast.parse(spec.edge)))


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
                    method: str = "scan", route=None) -> torch.Tensor:
    """One pull iteration for ONE part.  ``full_state`` is the (P*V, ...)
    concatenated padded state of all parts; ``local_state`` is (V, ...).
    ``route`` = (ExpandStatic, this part's arrays) switches the LOAD
    phase to the routed expand; (FusedStatic, arrays) replaces BOTH the
    load and the segmented reduce with the fused routed pipeline
    (ops/expand.apply_fused — destination-state-independent programs
    only)."""
    if route is not None and isinstance(route[0], expand.FusedStatic):
        assert route[0].reduce == prog.reduce, (
            f"fused plan was built for reduce={route[0].reduce!r} but the "
            f"program reduces with {prog.reduce!r}")
        if prog.needs_dst_state:
            raise ValueError(
                "the fused routed pull reads no destination state; this "
                "program needs it — route it with --route-gather expand")
        acc = expand.apply_fused(
            full_state, route[0], route[1],
            edge_value=lambda s, w: prog.edge_value(s, w, None),
            weighted=route[0].weighted and _edge_reads_weight(prog))
        return prog.apply(local_state, acc, arrays)
    if route is not None:
        gath = pull_gather_part_routed(arrays, full_state, local_state,
                                       route[0], route[1],
                                       prog.needs_dst_state)
    else:
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


def _pull_iteration(prog, spec: ShardSpec, method, arrays, state,
                    routes=None):
    """One pull iteration over the whole (P, V, ...) shard stack;
    ``routes`` is one (static, arrays) plan per part, or None."""
    full = state.reshape((spec.gathered_size,) + tuple(state.shape[2:]))
    return torch.stack([
        local_pull_step(prog, arrays.part(p), full, state[p], method,
                        None if routes is None else routes[p])
        for p in range(spec.num_parts)
    ])


def _route_parts(route, device, num_parts: int) -> Optional[list]:
    """A stacked (static, (P, ...) arrays) plan as one (static, arrays)
    plan per part, its arrays as tensors on ``device``."""
    if route is None:
        return None
    static, arrays = expand.plan_to_device(route, device)
    if arrays and arrays[0].shape[0] != num_parts:
        raise ValueError(f"route plan has {arrays[0].shape[0]} parts, the "
                         f"shards {num_parts}")
    return [(static, tuple(a[p] for a in arrays)) for p in range(num_parts)]


def _resolve(prog, method, arrays):
    return methods.resolve_sum(
        method, prog.reduce, methods.default_platform(arrays.src_pos.device))


def run_pull_fixed(prog: PullProgram, spec: ShardSpec, arrays: ShardArrays,
                   state0: torch.Tensor, num_iters: int, method: str = "auto",
                   route=None, donate: bool = False) -> torch.Tensor:
    """Fixed iteration count (PageRank style).  ``arrays`` are torch
    tensors (graph.shards.to_device) on the state's device.
    ``method="auto"`` resolves per engine.methods.  ``route`` (from
    ops/expand.plan_expand_shards / plan_fused_shards, arrays numpy or
    tensors) switches to the routed pull.  ``donate=True`` writes each
    iteration's new state back into ``state0``'s buffer and returns it;
    otherwise ``state0`` is left untouched.  Returns the final stacked
    (P, V, ...) state."""
    method = _resolve(prog, method, arrays)
    routes = _route_parts(route, state0.device, spec.num_parts)
    state = state0
    for _ in range(num_iters):
        new = _pull_iteration(prog, spec, method, arrays, state, routes)
        if donate:
            state0.copy_(new)
        else:
            state = new
    return state


def run_pull_until(prog: PullProgram, spec: ShardSpec, arrays: ShardArrays,
                   state0: torch.Tensor, max_iters: int,
                   active_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                   method: str = "auto", route=None, donate: bool = False):
    """Iterate until no vertex is active or ``max_iters`` ran.
    ``active_fn(old, new)`` gives per-part active counts (P,); the total is
    read on the host once per iteration.  ``route`` and ``donate`` as in
    run_pull_fixed.  Returns (final_state, num_iters_run)."""
    method = _resolve(prog, method, arrays)
    routes = _route_parts(route, state0.device, spec.num_parts)
    state = state0
    it = 0
    while it < max_iters:
        new = _pull_iteration(prog, spec, method, arrays, state, routes)
        active = int(active_fn(state, new).sum())
        if donate:
            state0.copy_(new)
        else:
            state = new
        it += 1
        if active == 0:
            break
    return state, it
