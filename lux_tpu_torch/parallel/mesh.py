"""The parts group: which graph parts this process holds, over which
process group.

Counterpart of ``lux_tpu.parallel.mesh``.  The reference declares a 1-D
``jax.sharding.Mesh`` over the chips and lets shard_map place k = P/D
parts on each; here there is one process a rank (``torch.distributed``),
and rank r holds the contiguous parts ``[r*k, (r+1)*k)`` of a P-part
graph.  That ordering is the invariant the halo collectives rely on
(parallel/placement.py): an all-gather concatenates the ranks' blocks in
rank order, which is global part order.

The 2-D meshes (parallel/edge2d.py, parallel/feat.py) put the ranks on a
(parts x A) grid, :class:`Grid2D`: rank r = p*A + a, its part row p and
its A index a.  The ranks of one A index form a parts group of their own
(a ``PartsGroup`` over a sub-group, group rank p), and the ranks of one
part row the A-axis group, whose all-reduce (:func:`axis_all_reduce`)
combines the partial results of the edge or feature shards.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ExchangeTimes:
    """Seconds spent in the exchange, by kind, while ``PartsGroup.timed``
    is on: ``stage_s`` copying device blocks through the pinned host
    buffers (gloo with ranks on a card), ``collective_s`` in the
    collectives themselves, ``calls`` their count."""

    stage_s: float = 0.0
    collective_s: float = 0.0
    calls: int = 0

    def as_dict(self) -> dict:
        return {"stage_s": self.stage_s, "collective_s": self.collective_s,
                "calls": self.calls}


@dataclasses.dataclass
class PartsGroup:
    """One rank's view of a P-part graph over ``world`` ranks.

    ``group`` is the torch.distributed process group (None = the default
    group), ``backend`` its backend ("gloo" or "nccl"), ``device`` where
    this rank computes.  ``timed`` fences each exchange on the device and
    adds its seconds to ``times`` (off by default: the fences cost a
    synchronization a collective)."""

    num_parts: int
    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any = None
    timed: bool = False
    #: the global ranks of the group's members in group-rank order (None:
    #: the default group, where a group rank is the global rank); a
    #: point-to-point peer is named by its global rank (:meth:`peer`)
    ranks: Optional[tuple] = None
    times: ExchangeTimes = dataclasses.field(default_factory=ExchangeTimes)
    _pinned: Dict[tuple, torch.Tensor] = dataclasses.field(default_factory=dict, repr=False)
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, repr=False)

    def __post_init__(self):
        if self.num_parts % self.world:
            raise ValueError(
                f"{self.num_parts} parts do not divide over {self.world} ranks: "
                "-ng must be a multiple of the rank count (k parts resident a rank)")

    @property
    def k(self) -> int:
        """Parts resident on this rank."""
        return self.num_parts // self.world

    @property
    def lo(self) -> int:
        return self.rank * self.k

    @property
    def hi(self) -> int:
        return (self.rank + 1) * self.k

    @property
    def parts(self) -> range:
        """This rank's global part indices, in order."""
        return range(self.lo, self.hi)

    @property
    def staged(self) -> bool:
        """Whether collectives on this rank's device blocks go through
        host buffers: gloo moves host memory only."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def peer(self, group_rank: int) -> int:
        """The global rank of the member ``group_rank`` (torch.distributed
        names point-to-point peers by global rank, also in a sub-group)."""
        return group_rank if self.ranks is None else self.ranks[group_rank]

    def pinned(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """A page-locked host buffer shaped as ``like``, kept for reuse
        under ``name`` (one a shape and dtype)."""
        key = (name, tuple(like.shape), like.dtype)
        with self._lock:
            buf = self._pinned.get(key)
            if buf is None:
                buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
                self._pinned[key] = buf
            return buf

    def fence(self) -> float:
        """Wait for this rank's device work; returns the host clock."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def barrier(self) -> None:
        import torch.distributed as dist

        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index or 0])
        else:
            dist.barrier(group=self.group)


def make_parts_group(num_parts: int, device, group=None) -> PartsGroup:
    """The PartsGroup of this process in the initialized default (or the
    given) process group; P % W == 0 is required, as in the reference
    (``dist.py:110``)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.multihost.initialize first")
    return PartsGroup(num_parts=num_parts, rank=dist.get_rank(group),
                      world=dist.get_world_size(group), device=torch.device(device),
                      backend=dist.get_backend(group), group=group)


def _local(pg: PartsGroup, a):
    """This rank's rows of a stacked array: rows [lo, hi) of a (P, ...)
    array, or the array itself when it already holds k rows (a subset
    build of this rank's parts)."""
    n = a.shape[0]
    if n == pg.num_parts and n != pg.k:
        return a[pg.lo:pg.hi]
    if n == pg.k:
        return a
    raise ValueError(f"stacked array has {n} rows: neither the {pg.num_parts} parts "
                     f"nor this rank's {pg.k}")


def _to_device(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def shard_stacked(pg: PartsGroup, tree):
    """This rank's parts of stacked (P, ...) host arrays, as tensors on
    its device: one array, or a NamedTuple of them (every field stacked
    by part).  A (k, ...) array of this rank's parts passes through."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(_local(pg, a), pg.device) for a in tree))
    return _to_device(_local(pg, tree), pg.device)


def place_plan(pg: PartsGroup, route):
    """This rank's rows of a stacked routed plan (static, arrays stacked by
    part, (P, ...) or this rank's (k, ...); a bucket plan's (R, S, ...)),
    as (static, (k, ...) tensors on its device) (ops/expand.plan_to_device;
    rows already there are not copied).  Placing is set-up: do it once."""
    from lux_tpu_torch.ops import expand

    static, arrays = route
    return expand.plan_to_device((static, tuple(_local(pg, a) for a in arrays)), pg.device)


def resident_plans(pg: PartsGroup, route) -> Optional[list]:
    """This rank's resident parts' plans of a stacked routed plan
    (:func:`place_plan`), each (static, its arrays) on the device, in
    resident order; None for no plan."""
    if route is None:
        return None
    static, local = place_plan(pg, route)
    return [(static, tuple(a[j] for a in local)) for j in range(pg.k)]


AXES = ("edge", "feat")


@dataclasses.dataclass
class Grid2D:
    """One rank's place on a (parts x A) grid of ``parts.world * size``
    ranks: rank r = p*A + a.  ``parts`` is the PartsGroup of the ranks
    that share this rank's A index a, over the parts axis (group rank p;
    the halo all-gather there concatenates part rows in global part
    order); ``axis_group`` the ranks of this rank's part row p, over the
    A axis (the ``edge`` or ``feat`` axis, ``axis``), ``index`` is a."""

    parts: PartsGroup
    axis: str
    size: int
    index: int
    axis_group: Any = None

    @property
    def lead(self) -> bool:
        """Global rank 0: the rank that assembles and prints."""
        return self.parts.rank == 0 and self.index == 0

    @property
    def world(self) -> int:
        return self.parts.world * self.size


def make_grid(num_parts: int, size: int, axis: str, device) -> Grid2D:
    """This rank's Grid2D over the initialized default group: W ranks as
    a (W/size) x size grid, ``num_parts`` parts over its W/size part rows
    (k = num_parts / (W/size) resident a rank).  Every rank creates every
    sub-group, in one order (columns, then rows): a rank that skipped one
    would hang the others."""
    import torch.distributed as dist

    if axis not in AXES:
        raise ValueError(f"axis must be one of {AXES}, got {axis!r}")
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.multihost.initialize first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if size < 1 or world % size:
        raise ValueError(f"{world} ranks do not form a grid with {size} {axis} shards: "
                         f"the rank count must be a multiple of {size}")
    rows = world // size
    p, a = divmod(rank, size)
    cols = [tuple(q * size + b for q in range(rows)) for b in range(size)]
    row_ranks = [tuple(q * size + b for b in range(size)) for q in range(rows)]
    col_groups = [dist.new_group(list(c)) for c in cols]
    row_groups = [dist.new_group(list(r)) for r in row_ranks]
    parts = PartsGroup(num_parts=num_parts, rank=p, world=rows, device=torch.device(device),
                       backend=dist.get_backend(), group=col_groups[a], ranks=cols[a])
    return Grid2D(parts=parts, axis=axis, size=size, index=a, axis_group=row_groups[p])


_REDUCE_OPS = ("sum", "min", "max")


def axis_all_reduce(grid: Grid2D, t: torch.Tensor, reduce: str) -> torch.Tensor:
    """The sum, min or max of ``t`` over the A axis of this rank's part
    row, as a new tensor (the reference's psum/pmin/pmax over the edge or
    feat axis).  Through pinned host buffers under gloo on a card
    (placement.host_staged), its seconds in ``grid.parts.times``."""
    import torch.distributed as dist

    from lux_tpu_torch.parallel.placement import host_staged

    if reduce not in _REDUCE_OPS:
        raise ValueError(f"reduce must be one of {_REDUCE_OPS}, got {reduce!r}")
    if t.dtype == torch.bfloat16:
        raise TypeError("axis_all_reduce takes the f32 partials: a bf16 sum would "
                        "round once a shard")
    op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
          "max": dist.ReduceOp.MAX}[reduce]
    t = t.contiguous()
    out = torch.empty_like(t)
    if grid.size == 1:
        return out.copy_(t)

    def collective(o, i):
        o.copy_(i)
        dist.all_reduce(o, op=op, group=grid.axis_group)

    host_staged(grid.parts, collective, out, t)
    return out


def axis_all_gather(grid: Grid2D, t: torch.Tensor) -> torch.Tensor:
    """Every A-axis rank's ``t`` of this rank's part row, stacked in A
    order as a (size, ...) tensor (a bf16 tensor crosses as its bytes)."""
    import torch.distributed as dist

    from lux_tpu_torch.parallel.placement import _wire, host_staged

    t = t.contiguous()
    out = torch.empty((grid.size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    if grid.size == 1:
        out[0].copy_(t)
        return out
    host_staged(grid.parts, lambda o, i: dist.all_gather_into_tensor(
        o, i, group=grid.axis_group), _wire(out.reshape(-1)), _wire(t.reshape(-1)))
    return out
