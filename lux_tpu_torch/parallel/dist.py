"""The distributed pull engine over the allgather exchange.

Counterpart of ``lux_tpu.parallel.dist``.  The reference runs one
shard_map program over a 1-D mesh: each iteration all-gathers every
part's state (``lax.all_gather``) and runs the single-device per-part
step on its resident parts, with convergence decided by a ``psum`` of the
per-part active counts.  Here each rank is a process holding k = P/W
parts: every iteration gathers the whole state with
``placement.halo_all_gather`` and runs ``engine/pull.local_pull_step`` on
each resident part, one after another, exactly as the single-process
engine runs them.  Only the exchange differs, so the result is bitwise
the single-process ``run_pull_fixed`` at the same P and method.

The method resolves through ``engine/methods`` on the rank's device, as
on one card: an f32 sum is ``mxscan`` on the card (the segmented-scan
kernel).  ``route=`` runs each resident part's step through its routed
plan (ops/expand: an ExpandStatic or CFRouteStatic routes the load,
bitwise; a FusedStatic the load and the reduce), the rank's rows of a
stacked plan; the exchange is unchanged, so a routed run is bitwise the
single-process routed run at the same P.  A rank plans only its own
rows; the fused planners' group template is every part's, agreed over
the ranks (:func:`agree_template`), and the ranks agree that every plan
was made before the first exchange (:func:`agree_ok`).  The small
collectives of the distributed push's round decision
(:func:`reduce_read`, :func:`gather_small`) live here too.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from lux_tpu_torch.engine import methods
from lux_tpu_torch.engine.pull import (PullProgram, local_pull_step, pull_gather_part,
                                       pull_reduce_part)
from lux_tpu_torch.graph.shards import ShardArrays, ShardSpec
from lux_tpu_torch.parallel.mesh import PartsGroup, resident_plans, shard_stacked
from lux_tpu_torch.parallel.placement import halo_all_gather


def _method(prog, method: str, pg: PartsGroup) -> str:
    return methods.resolve_sum(method, prog.reduce, methods.default_platform(pg.device))


def _place(pg: PartsGroup, spec: ShardSpec, arrays, state0):
    if spec.num_parts != pg.num_parts:
        raise ValueError(f"the shards have {spec.num_parts} parts, the group "
                         f"{pg.num_parts}")
    return shard_stacked(pg, arrays), shard_stacked(pg, state0)


def dist_iteration(prog: PullProgram, arrays: ShardArrays, block: torch.Tensor,
                   pg: PartsGroup, method: str, routes=None) -> torch.Tensor:
    """One iteration on this rank: gather the whole state, then each
    resident part's local_pull_step (through ``routes[j]``, its routed
    plan on the device, when given).  Returns the new (k, V, ...) block."""
    full = halo_all_gather(block, pg)
    return torch.stack([local_pull_step(prog, arrays.part(j), full, block[j], method,
                                        route=None if routes is None else routes[j])
                        for j in range(pg.k)])


def run_pull_fixed_dist(prog: PullProgram, spec: ShardSpec, arrays, state0,
                        num_iters: int, pg: PartsGroup, method: str = "auto",
                        route=None) -> torch.Tensor:
    """Fixed-iteration distributed pull (PageRank, CF).  ``arrays`` and
    ``state0`` are stacked by part: all P parts (this rank takes its
    rows) or this rank's k (a subset build); ``route`` a stacked routed
    plan of the same rows (ops/expand ``plan_*_shards``; ``rows=`` plans a
    rank's alone).  Returns this rank's final (k, V, ...) block."""
    method = _method(prog, method, pg)
    arrays, block = _place(pg, spec, arrays, state0)
    routes = resident_plans(pg, route)
    for _ in range(num_iters):
        block = dist_iteration(prog, arrays, block, pg, method, routes)
    return block


def compile_pull_phases_dist(prog: PullProgram, pg: PartsGroup, method: str = "auto"):
    """One distributed pull iteration as three separately callable phases
    (the reference's -verbose load/comp/update split on a mesh):

      load(arrays, block)       -> per-part gathered (src, dst) states;
                                   carries the exchange
      comp(arrays, gathered)    -> (k, V, ...) reduced accumulators
      update(arrays, block, acc)-> the new (k, V, ...) block (apply)

    ``arrays`` are this rank's (k, ...) device tensors.  The per-part
    bodies are those of the fused engine, so the three phases compose to
    its result bit for bit."""
    m = _method(prog, method, pg)

    def load(arrays: ShardArrays, block: torch.Tensor) -> list:
        full = halo_all_gather(block, pg)
        return [pull_gather_part(arrays.part(j), full, block[j], prog.needs_dst_state)
                for j in range(pg.k)]

    def comp(arrays: ShardArrays, gathered: list) -> torch.Tensor:
        return torch.stack([pull_reduce_part(prog, arrays.part(j), gathered[j], m)
                            for j in range(pg.k)])

    def update(arrays: ShardArrays, block: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        return torch.stack([prog.apply(block[j], acc[j], arrays.part(j))
                            for j in range(pg.k)])

    return load, comp, update


def global_active(pg: PartsGroup, count: torch.Tensor) -> int:
    """The sum of every rank's active count: this rank's count is read on
    the host once (the iteration's one host read), then summed over the
    ranks (on the card under NCCL)."""
    import torch.distributed as dist

    if pg.backend == "nccl":
        t = count.reshape(1).to(torch.int64)
    else:
        t = torch.tensor([int(count)], dtype=torch.int64)
    dist.all_reduce(t, group=pg.group)
    return int(t.item())


def run_pull_until_dist(prog: PullProgram, spec: ShardSpec, arrays, state0,
                        max_iters: int,
                        active_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                        pg: PartsGroup, method: str = "auto"):
    """Convergence-driven distributed pull (CC, SSSP): iterate until the
    global active count, the sum over the ranks of ``active_fn(old,
    new)`` of their resident parts, is 0, or ``max_iters`` ran.
    Returns (this rank's final (k, V, ...) block, iterations run)."""
    method = _method(prog, method, pg)
    arrays, block = _place(pg, spec, arrays, state0)
    it = 0
    while it < max_iters:
        new = dist_iteration(prog, arrays, block, pg, method)
        active = global_active(pg, active_fn(block, new).sum())
        block = new
        it += 1
        if active == 0:
            break
    return block, it


def _timed_collective(pg, run) -> None:
    """``run()`` (a collective on small tensors), its seconds added to
    ``pg.times`` when ``pg.timed``."""
    t0 = pg.fence() if pg.timed else 0.0
    run()
    if pg.timed:
        pg.times.collective_s += pg.fence() - t0
        pg.times.calls += 1


def reduce_read(pg: PartsGroup, shared: torch.Tensor, local: torch.Tensor):
    """Sum the small int64 vector ``shared`` over the ranks and read it on
    the host together with this rank's own int64 ``local`` values, in ONE
    device-to-host copy: under NCCL the sum runs on the card before the
    copy, under gloo on the host after it.  Returns (summed list, local
    list).  The distributed push's round decision (engine/push)."""
    import torch.distributed as dist

    n = shared.numel()
    if pg.backend == "nccl":
        _timed_collective(pg, lambda: dist.all_reduce(shared, group=pg.group))
        vals = torch.cat([shared, local]).tolist()
        return vals[:n], vals[n:]
    vals = torch.cat([shared, local]).tolist()
    red = torch.tensor(vals[:n], dtype=torch.int64)
    _timed_collective(pg, lambda: dist.all_reduce(red, group=pg.group))
    return red.tolist(), vals[n:]


def gather_small(pg: PartsGroup, vec: torch.Tensor) -> torch.Tensor:
    """Every rank's small int64 vector, as a (W, n) tensor in rank order:
    on the card under NCCL (no host read), on the host under gloo (one
    read).  One collective where a sum and a min are both wanted (the
    distributed delta's bucket vote and threshold)."""
    import torch.distributed as dist

    if pg.backend != "nccl":
        vec = vec.cpu()
    vec = vec.contiguous().reshape(-1)
    out = torch.empty(pg.world * vec.numel(), dtype=vec.dtype, device=vec.device)
    _timed_collective(pg, lambda: dist.all_gather_into_tensor(out, vec, group=pg.group))
    return out.view(pg.world, -1)


#: the width classes a fused plan's group template can hold (2**63 edges)
_CLASSES = 64


def agree_template(pg: PartsGroup, local: Optional[dict]) -> dict:
    """The fused planners' group template of every part
    (ops/expand._group_template over all P), from each rank's template of
    its own parts, in ONE max all-reduce over ``pg``'s ranks: a rank that
    planned against its own parts' template alone would tile its groups
    otherwise.  Every rank must call it; ``local`` None says this rank
    failed to compute its template, and then every rank raises."""
    import torch.distributed as dist

    v = torch.zeros(_CLASSES + 1, dtype=torch.int64)
    if local is None:
        v[-1] = 1
    else:
        for k, n in local.items():
            v[int(k)] = int(n)
    if pg.backend == "nccl":
        v = v.to(pg.device)
    dist.all_reduce(v, op=dist.ReduceOp.MAX, group=pg.group)
    v = v.cpu().tolist()
    if v[-1]:
        raise RuntimeError("a rank could not compute its parts' fused group template")
    return {k: n for k, n in enumerate(v[:-1]) if n}


def agree_ok(ok: bool) -> bool:
    """Whether every rank of the default group says ``ok``, in one
    all-reduce every rank takes (each rank's plan made before the first
    exchange: a rank that failed must not leave the others waiting in
    that exchange)."""
    from lux_tpu_torch.parallel.multihost import agree_max

    return agree_max(0 if ok else 1) == 0
