"""PlacementTree — the one partition→(host, device, slice) map.

Counterpart of ``lux_tpu.parallel.placement``'s tree (a copy: the port
imports nothing of the reference; ``PlacementTree.build`` splits parts
exactly as the reference does, and the wire form is the same).  The
reference's machine model lives in core/lux_mapper.cc: parts are sliced
node-major, part p on GPU ``p % gpus`` of node ``p / gpus_per_node``.

The fleet exchanges this tree over the wire in the hello handshake
(``serve/fleet/worker.py``), and a pod (``serve/fleet/pod.py``) gives each
worker process the contiguous part range the tree assigns to its host
coordinate, so a "replica" and a "slice" are one object: a worker that
owns parts [lo, hi) of an N-part graph is routed exactly like a worker
that owns all of it.  The tree is small and wire-friendly: a contiguous
part range per host (the balanced split), serialized as plain JSON lists.

Not here yet: the device meshes (``mesh``/``local_mesh``) and the halo
collectives (``halo_all_gather``, ``halo_reduce_scatter``) come with
multi-GPU, on ``torch.distributed``; :func:`local_tree` is the
single-host tree until then.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

#: wire-schema version for PlacementTree.to_wire (bump on layout change)
WIRE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class HostSlice:
    """One host's contiguous part range [lo, hi) of an N-part graph.

    ``devices`` is the host's local device count (0 = unknown/any): the
    fleet uses it for capacity accounting only.
    """

    host: int
    lo: int
    hi: int
    devices: int = 0

    def __post_init__(self):
        if self.lo > self.hi or self.lo < 0:
            raise ValueError(f"bad part range [{self.lo}, {self.hi})")

    @property
    def num_parts(self) -> int:
        return self.hi - self.lo

    @property
    def parts(self) -> range:
        return range(self.lo, self.hi)

    def to_wire(self) -> Dict:
        return {"host": self.host, "lo": self.lo, "hi": self.hi,
                "devices": self.devices}

    @classmethod
    def from_wire(cls, d: Dict) -> "HostSlice":
        return cls(host=int(d["host"]), lo=int(d["lo"]), hi=int(d["hi"]),
                   devices=int(d.get("devices", 0)))


@dataclasses.dataclass(frozen=True)
class PlacementTree:
    """How ``num_parts`` graph partitions map onto hosts.  Slices are contiguous,
    ordered, and tile [0, num_parts) exactly — checked at construction
    so a tree received over the wire cannot describe overlapping or
    gapped ownership."""

    num_parts: int
    slices: Tuple[HostSlice, ...]

    def __post_init__(self):
        if self.num_parts < 1:
            raise ValueError(f"num_parts must be >= 1, got {self.num_parts}")
        if not self.slices:
            raise ValueError("placement tree needs at least one host slice")
        cursor = 0
        for i, s in enumerate(self.slices):
            if s.host != i:
                raise ValueError(
                    f"slice {i} carries host id {s.host}; hosts must be "
                    "dense 0..H-1 in slice order")
            if s.lo != cursor:
                raise ValueError(
                    f"host {i} starts at part {s.lo}, expected {cursor}: "
                    "slices must tile [0, num_parts) contiguously")
            cursor = s.hi
        if cursor != self.num_parts:
            raise ValueError(
                f"slices cover [0, {cursor}) but num_parts={self.num_parts}")

    # ---------------------------------------------------------- build
    @classmethod
    def build(cls, num_parts: int, num_hosts: int = 1,
              devices_per_host: int = 0) -> "PlacementTree":
        """Balanced node-major split: the first ``num_parts % num_hosts``
        hosts take one extra part (the historical
        ``multihost.local_part_range`` arithmetic, now defined once).
        Hosts beyond ``num_parts`` get empty slices rather than erroring
        so a fixed fleet can serve a small graph."""
        if num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
        base, extra = divmod(num_parts, num_hosts)
        slices = []
        for h in range(num_hosts):
            lo = h * base + min(h, extra)
            hi = lo + base + (1 if h < extra else 0)
            slices.append(HostSlice(host=h, lo=lo, hi=hi,
                                    devices=devices_per_host))
        return cls(num_parts=num_parts, slices=tuple(slices))

    @classmethod
    def single_host(cls, num_parts: int,
                    devices: int = 0) -> "PlacementTree":
        """The degenerate tree every existing single-host path implies."""
        return cls.build(num_parts, 1, devices)

    # ---------------------------------------------------------- lookup
    @property
    def num_hosts(self) -> int:
        return len(self.slices)

    def parts_of(self, host: int) -> range:
        """Part indices host ``host`` owns."""
        return self.slices[host].parts

    def host_of(self, part: int) -> int:
        """Which host owns ``part`` (binary search over slice bounds)."""
        if not 0 <= part < self.num_parts:
            raise IndexError(f"part {part} outside [0, {self.num_parts})")
        lo, hi = 0, len(self.slices) - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if part >= self.slices[mid].hi:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def slice_of(self, host: int) -> HostSlice:
        return self.slices[host]

    # ------------------------------------------------------------ wire
    def to_wire(self) -> Dict:
        """JSON-safe dict for the fleet hello handshake / pod ops."""
        return {
            "version": WIRE_VERSION,
            "num_parts": self.num_parts,
            "slices": [s.to_wire() for s in self.slices],
        }

    @classmethod
    def from_wire(cls, d: Dict) -> "PlacementTree":
        v = int(d.get("version", 1))
        if v > WIRE_VERSION:
            raise ValueError(
                f"placement tree wire version {v} > supported "
                f"{WIRE_VERSION}")
        return cls(
            num_parts=int(d["num_parts"]),
            slices=tuple(HostSlice.from_wire(s) for s in d["slices"]),
        )


def local_tree(num_parts: int) -> PlacementTree:
    """The tree for the CURRENT runtime: one host (the port has no
    multi-process runtime yet, so this is always the single-host tree),
    with the visible CUDA device count as its capacity hint."""
    import torch

    return PlacementTree.single_host(num_parts,
                                     devices=torch.cuda.device_count())
