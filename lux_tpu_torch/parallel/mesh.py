"""The parts group: which graph parts this process holds, over which
process group.

Counterpart of ``lux_tpu.parallel.mesh``.  The reference declares a 1-D
``jax.sharding.Mesh`` over the chips and lets shard_map place k = P/D
parts on each; here there is one process a rank (``torch.distributed``),
and rank r holds the contiguous parts ``[r*k, (r+1)*k)`` of a P-part
graph.  That ordering is the invariant the halo collectives rely on
(parallel/placement.py): an all-gather concatenates the ranks' blocks in
rank order, which is global part order.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict

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
