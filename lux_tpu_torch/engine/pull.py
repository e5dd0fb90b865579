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
load AND reduce, and a (CFRouteStatic, arrays) plan routes both reads of
a wide destination-dependent program.  Route arrays are stacked per
part, (P, ...).

``overlay=`` runs the step against a mutating graph
(lux_tpu_torch.mutate): tombstoned base edges' values are neutralized
before the reduce (through the fused plans' gslot route on the fused
families), then the fixed-capacity insert buffer is folded into the
accumulator before apply.  The overlay's tensors are moved to the device
once per run.

``telemetry=`` (obs/ring.py) records one row an iteration in a device
tensor with no host read, leaving every result bitwise unchanged;
``run_pull_fixed_overlapped`` iterates direct while a routed plan builds
on another thread and hands over once it resolves.
"""
from __future__ import annotations

import ast
from typing import Any, Callable, Optional, Protocol

import torch

from lux_tpu_torch import obs
from lux_tpu_torch.engine import methods
from lux_tpu_torch.graph.shards import ShardArrays, ShardSpec
from lux_tpu_torch.mutate import overlay as ovl
from lux_tpu_torch.obs import ring as obs_ring
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
                     method: str, del_val=None) -> torch.Tensor:
    """COMP phase for ONE part: per-edge values + segmented reduce by
    destination.  ``del_val`` (the mutation overlay's (E,) tombstone
    mask) neutralizes deleted base edges' VALUES; the base arrays and the
    reduce itself run unchanged."""
    src_state, dst_state = gath
    vals = prog.edge_value(src_state, arrays.weights, dst_state)
    if del_val is not None:
        if vals.dim() > 1:
            del_val = del_val.reshape(del_val.shape + (1,) * (vals.dim() - 1))
        vals = ovl.mask_deleted(vals, del_val, prog.reduce)
    return _REDUCERS[prog.reduce](
        vals, arrays.row_ptr, arrays.head_flag, arrays.dst_local, method=method)


def local_pull_step(prog: PullProgram, arrays: ShardArrays,
                    full_state: torch.Tensor, local_state: torch.Tensor,
                    method: str = "scan", route=None, overlay=None) -> torch.Tensor:
    """One pull iteration for ONE part.  ``full_state`` is the (P*V, ...)
    concatenated padded state of all parts; ``local_state`` is (V, ...).
    ``route`` = (ExpandStatic, this part's arrays) switches the LOAD
    phase to the routed expand; (FusedStatic, arrays) replaces BOTH the
    load and the segmented reduce with the fused routed pipeline
    (ops/expand.apply_fused — destination-state-independent programs
    only); (CFRouteStatic, arrays) routes the source and destination reads
    of a wide (V, K) state column by column (ops/expand.apply_cf_route).
    ``overlay`` = this part's mutate.overlay.DeviceOverlay: tombstones
    neutralize, then the insert buffer folds into the accumulator before
    apply.  The CF route refuses it (mutate.overlay.FUSED_OVERLAY_NOTE)."""
    if overlay is not None and route is not None and isinstance(
            route[0], expand.CFRouteStatic):
        raise ValueError(ovl.FUSED_OVERLAY_NOTE)
    del_val = None if overlay is None else overlay.del_val
    if route is not None and isinstance(route[0], expand.CFRouteStatic):
        gath = expand.apply_cf_route(full_state, local_state, route[0], route[1])
        acc = pull_reduce_part(prog, arrays, gath, method)
        return prog.apply(local_state, acc, arrays)
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
            weighted=route[0].weighted and _edge_reads_weight(prog),
            del_val=del_val)
    else:
        if route is not None:
            gath = pull_gather_part_routed(arrays, full_state, local_state,
                                           route[0], route[1],
                                           prog.needs_dst_state)
        else:
            gath = pull_gather_part(arrays, full_state, local_state,
                                    prog.needs_dst_state)
        acc = pull_reduce_part(prog, arrays, gath, method, del_val)
    if overlay is not None:
        acc = ovl.delta_scatter(acc, full_state, overlay,
                                lambda s, w: prog.edge_value(s, w, None), prog.reduce)
    return prog.apply(local_state, acc, arrays)


def init_state(prog: PullProgram, arrays: ShardArrays) -> torch.Tensor:
    """Stacked (P, V, ...) initial state, one part at a time."""
    P = arrays.global_vid.shape[0]
    return torch.stack([
        prog.init_state(arrays.global_vid[p], arrays.degree[p], arrays.vtx_mask[p])
        for p in range(P)
    ])


def _pull_iteration(prog, spec: ShardSpec, method, arrays, state,
                    routes=None, overlays=None):
    """One pull iteration over the whole (P, V, ...) shard stack;
    ``routes`` is one (static, arrays) plan per part, or None;
    ``overlays`` one DeviceOverlay per part, or None."""
    full = state.reshape((spec.gathered_size,) + tuple(state.shape[2:]))
    return torch.stack([
        local_pull_step(prog, arrays.part(p), full, state[p], method,
                        None if routes is None else routes[p],
                        None if overlays is None else overlays[p])
        for p in range(spec.num_parts)
    ])


def compile_pull_phases(prog: PullProgram, spec: ShardSpec, method: str = "auto"):
    """One pull iteration as THREE separately callable phases (the
    reference's load/comp/update split, ``lux_tpu.engine.pull
    .compile_pull_phases``):

      load(arrays, state)         -> per-part gathered (src, dst) states,
                                     the destination read only when
                                     ``prog.needs_dst_state``
      comp(arrays, gathered)      -> (P, V, ...) reduced accumulators
                                     (edge_value + segmented reduction)
      update(arrays, state, acc)  -> the new (P, V, ...) state (apply)

    ``arrays`` are the stacked device tensors; ``method`` resolves per
    engine.methods on the arrays' device.  A reduce-only phase (a spec
    with no apply rule) runs load and comp alone.  Returns (load, comp,
    update)."""

    def load(arrays: ShardArrays, state: torch.Tensor) -> list:
        full = state.reshape((spec.gathered_size,) + tuple(state.shape[2:]))
        return [pull_gather_part(arrays.part(p), full, state[p],
                                 prog.needs_dst_state)
                for p in range(spec.num_parts)]

    def comp(arrays: ShardArrays, gathered: list) -> torch.Tensor:
        m = _resolve(prog, method, arrays)
        return torch.stack([pull_reduce_part(prog, arrays.part(p), gathered[p], m)
                            for p in range(spec.num_parts)])

    def update(arrays: ShardArrays, state: torch.Tensor,
               acc: torch.Tensor) -> torch.Tensor:
        return torch.stack([prog.apply(state[p], acc[p], arrays.part(p))
                            for p in range(spec.num_parts)])

    return load, comp, update


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


def overlay_parts(overlay, device, spec: ShardSpec) -> Optional[list]:
    """An (OverlayStatic, OverlayArrays) pair as one DeviceOverlay per
    part on ``device`` (mutate.overlay.device_overlay), or None.  A list
    of DeviceOverlays (this function's result), alone or in the pair,
    passes through."""
    if overlay is None:
        return None
    oarr = overlay if isinstance(overlay, list) else overlay[1]
    if isinstance(oarr, list):
        return oarr
    if oarr.del_val.shape[0] != spec.num_parts:
        raise ValueError(f"overlay has {oarr.del_val.shape[0]} parts, the "
                         f"shards {spec.num_parts}")
    return ovl.device_overlay(oarr, device, spec.nv_pad)


def _resolve(prog, method, arrays):
    return methods.resolve_sum(
        method, prog.reduce, methods.default_platform(arrays.src_pos.device))


def run_pull_fixed(prog: PullProgram, spec: ShardSpec, arrays: ShardArrays,
                   state0: torch.Tensor, num_iters: int, method: str = "auto",
                   route=None, donate: bool = False, overlay=None,
                   telemetry=None):
    """Fixed iteration count (PageRank style).  ``arrays`` are torch
    tensors (graph.shards.to_device) on the state's device.
    ``method="auto"`` resolves per engine.methods.  ``route`` (from
    ops/expand.plan_expand_shards / plan_fused_shards, arrays numpy or
    tensors) switches to the routed pull.  ``donate=True`` writes each
    iteration's new state back into ``state0``'s buffer and returns it;
    otherwise ``state0`` is left untouched.  ``overlay``
    ((OverlayStatic, OverlayArrays) from lux_tpu_torch.mutate.overlay)
    runs the step against the mutating graph.  ``telemetry`` (an
    ``obs.ring.new_ring("pull_fixed")`` on the state's device) records
    each iteration's L1 residual, a device reduction of new − old, with
    no host read; the results stay bitwise the same and the return
    becomes (state, ring).  Returns the final stacked (P, V, ...)
    state."""
    method = _resolve(prog, method, arrays)
    routes = _route_parts(route, state0.device, spec.num_parts)
    overlays = overlay_parts(overlay, state0.device, spec)
    ring = telemetry
    state = state0
    for i in range(num_iters):
        new = _pull_iteration(prog, spec, method, arrays, state, routes, overlays)
        if ring is not None:
            ring = obs_ring.ring_push_residual(ring, i, new, state)
        if donate:
            state0.copy_(new)
        else:
            state = new
    return state if ring is None else (state, ring)


def run_pull_fixed_overlapped(prog: PullProgram, spec: ShardSpec, arrays: ShardArrays,
                              state0: torch.Tensor, num_iters: int,
                              method: str = "auto", route_future=None,
                              chunk: int = 1):
    """run_pull_fixed that overlaps routed-plan construction with the
    first iterations: while ``route_future`` (an ops/expand.PlanFuture)
    is still building on the host, iterations run direct in
    ``chunk``-sized windows, each synchronized before the future is
    polled again; once the plan resolves, the remaining iterations run
    routed.  The routed expand (and the CF route) is bitwise the direct
    gather, so the handover point cannot change the result.  A fused
    plan changes the reduce's association: one that is ready at entry
    runs fused from iteration 0, one that resolves mid-run finishes the
    remaining iterations DIRECT, so the result is exactly the direct
    engine's.  The caller's ``state0`` is never written: the first chunk
    runs undonated and later chunks write into the state the first one
    made.  Each window is a ``pull.chunk`` recorder span.  Returns
    (final_state, routed_iters), the iterations that ran routed."""
    if route_future is None:
        return run_pull_fixed(prog, spec, arrays, state0, num_iters, method), 0
    if route_future.ready():
        route = route_future.result()
        return run_pull_fixed(prog, spec, arrays, state0, num_iters, method,
                              route=route), num_iters
    state = state0
    done = 0
    while done < num_iters and not route_future.ready():
        k = min(chunk, num_iters - done)
        with obs.span("pull.chunk", k=k, done=done, routed=False):
            state = run_pull_fixed(prog, spec, arrays, state, k, method,
                                   donate=done > 0)
            # materialize before polling again: launches are
            # asynchronous, so without a sync the loop would queue every
            # chunk before the future could win the race
            if state.device.type == "cuda":
                torch.cuda.synchronize(state.device)
        done += k
    if done >= num_iters:
        return state, 0
    route = route_future.result()
    if isinstance(route[0], expand.FusedStatic):
        # mixing associations mid-run is invalid; the direct result is a
        # valid deterministic answer, so finish direct
        with obs.span("pull.chunk", k=num_iters - done, done=done,
                      routed=False, fused_skip=True):
            state = run_pull_fixed(prog, spec, arrays, state, num_iters - done,
                                   method, donate=done > 0)
        return state, 0
    with obs.span("pull.chunk", k=num_iters - done, done=done, routed=True):
        state = run_pull_fixed(prog, spec, arrays, state, num_iters - done, method,
                               route=route, donate=done > 0)
    return state, num_iters - done


def run_pull_until(prog: PullProgram, spec: ShardSpec, arrays: ShardArrays,
                   state0: torch.Tensor, max_iters: int,
                   active_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                   method: str = "auto", route=None, donate: bool = False,
                   overlay=None, telemetry=None):
    """Iterate until no vertex is active or ``max_iters`` ran.
    ``active_fn(old, new)`` gives per-part active counts (P,); the total is
    read on the host once per iteration.  ``route``, ``donate`` and
    ``overlay`` as in run_pull_fixed: with an overlay this is the
    incremental refresh's entry point (warm state in, iterate the overlay
    step until quiescent).  ``telemetry`` (an
    ``obs.ring.new_ring("pull_until")``) records each iteration's active
    count, the value the loop already reads; the return gains the ring.
    Returns (final_state, num_iters_run[, ring])."""
    method = _resolve(prog, method, arrays)
    routes = _route_parts(route, state0.device, spec.num_parts)
    overlays = overlay_parts(overlay, state0.device, spec)
    ring = telemetry
    state = state0
    it = 0
    while it < max_iters:
        new = _pull_iteration(prog, spec, method, arrays, state, routes, overlays)
        active = int(active_fn(state, new).sum())
        if ring is not None:
            ring = obs_ring.ring_push(ring, it, active)
        if donate:
            state0.copy_(new)
        else:
            state = new
        it += 1
        if active == 0:
            break
    return (state, it) if ring is None else (state, it, ring)
