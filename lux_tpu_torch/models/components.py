"""Connected components by max-label propagation.

Counterpart of ``lux_tpu.models.components`` on one device:
  * labels start at the vertex's own id;
  * each iteration a vertex takes the max of its label and its
    in-neighbors' labels;
  * convergence when no label changes anywhere;
  * the ``-check`` validator asserts label[dst] >= label[src] on every
    edge.

:func:`connected_components` is the pull form (engine/pull
.run_pull_until); :func:`connected_components_push` the direction-
optimized push form the reference's app runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.push_shards import PushShards, build_push_shards
from lux_tpu_torch.graph.shards import PullShards, build_pull_shards, to_device
from lux_tpu_torch.models.sssp import push_run, refuse_unported
from lux_tpu_torch.program import library
from lux_tpu_torch.program.spec import SpecBacked
from lux_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MaxLabelProgram(SpecBacked):
    """Max-label propagation (program/library.COMPONENTS): labels start at
    the vertex id (-1 on padding, so it never wins a max) and everyone
    starts active.  Its edge/apply serve the pull engine, its
    edge/frontier the push engine."""

    @property
    def spec(self):
        return library.COMPONENTS


def active_count(old_local, new_local):
    """The count of vertices whose label changed in one part."""
    return (old_local != new_local).sum()


def active_count_stacked(old_stacked, new_stacked):
    """(P, V) stacked variant -> (P,) counts (run_pull_until's active_fn)."""
    return (old_stacked != new_stacked).sum(dim=-1)


def connected_components(g: HostGraph | PullShards, max_iters: int = 10_000,
                         num_parts: int = 1, method: str = "auto",
                         device="cuda") -> np.ndarray:
    """CC on the pull engine to convergence; returns (nv,) int32 labels."""
    shards = g if isinstance(g, PullShards) else build_pull_shards(g, num_parts)
    arrays = to_device(shards.arrays, resolve_device(device))
    prog = MaxLabelProgram()
    final, _ = pull.run_pull_until(prog, shards.spec, arrays,
                                   pull.init_state(prog, arrays), max_iters,
                                   active_count_stacked, method=method)
    return shards.scatter_to_global(final.cpu().numpy())


def connected_components_push(g: HostGraph | PushShards, max_iters: int = 10_000,
                              num_parts: int = 1, method: str = "auto",
                              route=None, merge=None, device="cuda", mesh=None,
                              exchange: str = "allgather",
                              repartition_every: int = 0,
                              repartition_threshold: float = 1.25) -> np.ndarray:
    """CC on the push engine (direction-optimized; what the reference's app
    runs); returns (nv,) int32 labels.  ``route``: an expand plan of the
    push shards' pull layout for the dense rounds; ``repartition_every >
    0`` enables the adaptive repartitioning (``g`` a HostGraph)."""
    refuse_unported(mesh, exchange)
    shards = g if isinstance(g, PushShards) else build_push_shards(g, num_parts)
    return push_run(MaxLabelProgram(), g, shards, max_iters, method, route, merge,
                    device, repartition_every, repartition_threshold)


def check_labels(g: HostGraph, labels: np.ndarray) -> int:
    """Host ``-check`` oracle: the number of edges with label[dst] <
    label[src] (0 after convergence)."""
    dst = g.dst_of_edges()
    return int(np.sum(labels[dst] < labels[g.col_idx]))


def fixpoint_labels(g: HostGraph) -> np.ndarray:
    """Host oracle of the labels themselves: label[v] = max(v, labels of
    v's in-neighbors), iterated to its fixpoint with ``np.maximum.at``."""
    want = np.arange(g.nv)
    dst = g.dst_of_edges()
    while True:
        new = want.copy()
        np.maximum.at(new, dst, want[g.col_idx])
        if np.array_equal(new, want):
            return want.astype(np.int32)
        want = new
