"""Multi-process initialization: one process a rank over torch.distributed.

Counterpart of ``lux_tpu.parallel.multihost``.  The reference bootstraps
``jax.distributed`` and runs the same shard_map programs over a global
mesh; here each rank is a process (``python -m torch.distributed.run
--nproc-per-node W -m lux_tpu_torch.apps.pagerank --distributed ...``, or
:mod:`lux_tpu_torch.parallel.spawn`), :func:`initialize` joins the
process group, and each rank builds and keeps only its own parts.

The backend is the caller's choice, never a silent substitution:

  * ``nccl``: each local rank has a card of its own (``cuda:LOCAL_RANK``);
  * ``gloo`` on the CPU;
  * ``gloo`` on cards, for ranks that share one: the collectives move
    host memory, so each exchange stages the device blocks through
    pinned host buffers (``parallel/placement.host_staged``).

The choice comes from the ``backend`` argument, else the environment
variable ``LUX_DIST_BACKEND`` (``nccl`` | ``gloo``), else ``nccl`` on
cards and ``gloo`` on the CPU.  NCCL with more local ranks than cards is
refused with a message that names the setting.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch

from lux_tpu_torch.parallel.mesh import PartsGroup, make_parts_group

BACKEND_ENV = "LUX_DIST_BACKEND"
BACKENDS = ("nccl", "gloo")
#: a collective that waits longer than this fails the rank (a hung peer
#: would otherwise hang every rank)
TIMEOUT_S = 300.0


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw.strip() else default


def resolve_backend(device: torch.device, backend: Optional[str] = None,
                    local_world: int = 1) -> str:
    """The backend for ranks on ``device``: ``backend``, else
    LUX_DIST_BACKEND, else nccl on cards and gloo on the CPU.  Refuses
    NCCL off a card and NCCL for more local ranks than cards."""
    chosen = backend or os.environ.get(BACKEND_ENV, "").strip() or (
        "nccl" if device.type == "cuda" else "gloo")
    if chosen not in BACKENDS:
        raise ValueError(f"{BACKEND_ENV} must be one of {BACKENDS}, got {chosen!r}")
    if chosen == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the nccl backend runs on cards; on the CPU set "
                             f"{BACKEND_ENV}=gloo")
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(
                f"nccl needs a card a rank: {local_world} local ranks share {cards} "
                f"card(s). For ranks that share a card set {BACKEND_ENV}=gloo "
                "(host-staged collectives)")
    return chosen


def rank_device(device: torch.device, backend: str, local_rank: int) -> torch.device:
    """This rank's device: the CPU, ``cuda:LOCAL_RANK`` under nccl, and
    the shared card ``cuda:(LOCAL_RANK % cards)`` under gloo."""
    if device.type != "cuda":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", local_rank)
    return torch.device("cuda", local_rank % max(torch.cuda.device_count(), 1))


def _join(device: torch.device, backend: Optional[str], init_method: Optional[str],
          rank: Optional[int], world_size: Optional[int], local_rank: Optional[int],
          local_world: Optional[int]) -> torch.device:
    """Join the default process group once a process; returns this
    rank's device."""
    import torch.distributed as dist

    if dist.is_initialized():
        # joined before (by a launcher, or an earlier run in this process):
        # its backend and device stand, unless the caller asks otherwise
        current = dist.get_backend()
        wanted = backend or os.environ.get(BACKEND_ENV, "").strip()
        if wanted and wanted != current:
            raise ValueError(f"torch.distributed already runs {current}, not {wanted}")
        return (torch.device("cuda", torch.cuda.current_device())
                if device.type == "cuda" else torch.device("cpu"))
    rank = _env_int("RANK", 0) if rank is None else rank
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    local_rank = _env_int("LOCAL_RANK", rank) if local_rank is None else local_rank
    if local_world is None:
        local_world = _env_int("LOCAL_WORLD_SIZE", world_size)
    chosen = resolve_backend(device, backend, local_world)
    dev = rank_device(device, chosen, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if chosen == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(
        chosen, init_method=init_method or "env://",
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    return dev


def _announce(pg: PartsGroup, dev, num_parts: int, where: str = "") -> None:
    import torch.distributed as dist

    staged = " (collectives staged through pinned host buffers)" if pg.staged else ""
    print(f"distributed: rank {dist.get_rank()}/{dist.get_world_size()}, backend "
          f"{pg.backend}{staged}, device {dev}, parts [{pg.lo}, {pg.hi}) of "
          f"{num_parts}{where}", flush=True)


def dist_world() -> int:
    """The rank count: of the joined group, else the launcher's
    WORLD_SIZE (1 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return _env_int("WORLD_SIZE", 1)


def initialize(num_parts: int, device="cuda", backend: Optional[str] = None,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None, local_rank: Optional[int] = None,
               local_world: Optional[int] = None, quiet: bool = False) -> PartsGroup:
    """Join the default process group (once a process) and return this
    rank's PartsGroup for a ``num_parts``-part graph.

    Without arguments it reads torch.distributed.run's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT); ``init_method`` takes a ``file://`` rendezvous
    instead.  Prints the rank, the backend and the
    device unless ``quiet``."""
    dev = _join(torch.device(device), backend, init_method, rank, world_size, local_rank,
                local_world)
    pg = make_parts_group(num_parts, dev)
    if not quiet:
        _announce(pg, dev, num_parts)
    return pg


def initialize_grid(num_parts: int, size: int, axis: str, device="cuda",
                    backend: Optional[str] = None, quiet: bool = False):
    """:func:`initialize` for the 2-D meshes: join the default group and
    return this rank's mesh.Grid2D, the ranks as a (W/size) x size grid
    of part rows and ``axis`` ("edge" | "feat") shards."""
    from lux_tpu_torch.parallel.mesh import make_grid

    dev = _join(torch.device(device), backend, None, None, None, None, None)
    grid = make_grid(num_parts, size, axis, dev)
    if not quiet:
        _announce(grid.parts, dev, num_parts, f", {axis} shard {grid.index} of {size}")
    return grid


def shutdown() -> None:
    """Leave the default process group, when one is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def local_part_range(num_parts: int) -> range:
    """The parts this process owns: the placement tree's slice of this
    rank (``placement.local_tree``), which for P % W == 0 is
    ``[rank*k, (rank+1)*k)``."""
    import torch.distributed as dist

    from lux_tpu_torch.parallel.placement import local_tree

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return local_tree(num_parts).parts_of(rank)


def assemble_global(pg: PartsGroup, block: torch.Tensor) -> Optional[np.ndarray]:
    """The stacked (P, V, ...) state on rank 0 as a host array (float32
    for a bf16 state), from every rank's (k, V, ...) block; None on the
    other ranks."""
    from lux_tpu_torch.parallel.placement import halo_all_gather

    full = halo_all_gather(block, pg)
    if pg.rank != 0:
        return None
    host = full.float() if full.dtype == torch.bfloat16 else full
    return host.cpu().numpy().reshape((pg.num_parts,) + tuple(block.shape[1:]))


def agree_max(value: int) -> int:
    """The largest of every rank's ``value`` over the default group (an
    exit code: any rank's failure fails all)."""
    import torch.distributed as dist

    nccl = dist.get_backend() == "nccl"
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=torch.device("cuda", torch.cuda.current_device()) if nccl
                     else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())
