"""Single-source shortest paths (BFS flavor) on the push engine.

Counterpart of ``lux_tpu.models.sssp`` on one device:
  * unweighted relaxation ``dist[dst] = min(dist[dst], dist[src] + 1)``;
  * dist is int32 with INF encoded as nv;
  * a single-source sparse frontier at ``start``;
  * direction-optimized iterations until no vertex changes;
  * the ``-check`` invariant dist[dst] <= dist[src] + 1 on every edge.

``WeightedSSSPProgram`` relaxes with integer edge costs (an extension
beyond Lux, as in the reference); ``delta=`` runs it by delta-stepping
(engine/delta.py) and ``repartition_every=`` rebalances the parts' cuts
from their measured load (engine/repartition.py).  The distributed and
ring drivers are not ported: their arguments raise.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from lux_tpu_torch.engine import push
from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.graph.push_shards import PushShards, build_push_shards
from lux_tpu_torch.program import library
from lux_tpu_torch.program.spec import SpecBacked


@dataclasses.dataclass(frozen=True)
class SSSPProgram(SpecBacked):
    """BFS-SSSP vertex program: hop-count relaxation, evaluated from the
    declarative spec (program/library.SSSP)."""

    nv: int
    start: int = 0

    @property
    def spec(self):
        return library.SSSP

    @property
    def inf(self) -> int:
        """Unreached sentinel: nv (hop counts are < nv)."""
        return self.nv

    def _env(self):
        return {"start": self.start, "inf": self.inf}


@dataclasses.dataclass(frozen=True)
class WeightedSSSPProgram(SSSPProgram):
    """Weighted SSSP by chaotic relaxation over integer edge costs."""

    @property
    def spec(self):
        return library.SSSP_WEIGHTED

    @property
    def inf(self) -> int:
        # weighted distances can exceed nv; large, yet inf + a weight
        # still fits int32
        return 1 << 30


def refuse_unported(mesh=None, exchange="allgather") -> None:
    """Raise for a driver option of the reference that is not ported (a
    silently ignored option would misreport what ran)."""
    for name, val, default in (("mesh", mesh, None), ("exchange", exchange, "allgather")):
        if val != default:
            raise NotImplementedError(
                f"{name}={val!r}: the distributed and ring push drivers are not "
                "ported to lux_tpu_torch yet (ROADMAP Queue 1 item 7; -ng parts "
                "stack on one device)")


def push_run(prog, g, shards: PushShards, max_iters, method, route, merge, device,
             repartition_every: int = 0, repartition_threshold: float = 1.25
             ) -> np.ndarray:
    """Run ``prog`` on the push engine, or with ``repartition_every > 0``
    on the adaptive repartitioning driver (which needs the HostGraph
    ``g`` for its rebuilds); (nv,) int32 global state."""
    if repartition_every > 0:
        if route is not None:
            raise ValueError("route= is a non-adaptive driver option; the "
                             "repartitioning push runs the direct gather")
        if not isinstance(g, HostGraph):
            raise ValueError("repartition_every needs the HostGraph (shard rebuilds)")
        from lux_tpu_torch.engine import repartition

        return repartition.run_push_adaptive(
            prog, g, shards.spec.num_parts, chunk=repartition_every,
            threshold=repartition_threshold, max_iters=max_iters, method=method,
            shards=shards, device=device).state
    final, _, _ = push.run_push(prog, shards, max_iters, method=method,
                                route=route, merge=merge, device=device)
    return shards.scatter_to_global(final.cpu().numpy())


def sssp(g: HostGraph | PushShards, start: int = 0, num_parts: int = 1,
         max_iters: int = 10_000, weighted: bool = False, method: str = "auto",
         route=None, merge=None, device="cuda", mesh=None,
         exchange: str = "allgather", repartition_every: int = 0,
         repartition_threshold: float = 1.25, delta: int = 0) -> np.ndarray:
    """Run SSSP from ``start`` on ``device``; returns (nv,) int32
    distances, INF == nv (1 << 30 weighted).  ``route``: an expand plan of
    the push shards' pull layout for the dense rounds.
    ``repartition_every > 0`` rebalances the vertex cuts from the
    measured per-part load every N iterations; ``delta > 0`` selects the
    delta-stepping driver (weighted runs): the same distances, far fewer
    relaxed edges than chaotic relaxation."""
    refuse_unported(mesh, exchange)
    shards = g if isinstance(g, PushShards) else build_push_shards(g, num_parts)
    if not 0 <= start < shards.spec.nv:
        raise ValueError(f"start vertex {start} out of range [0, {shards.spec.nv})")
    if weighted:
        if not shards.spec.weighted:
            raise ValueError("weighted=True requires an edge-weighted graph")
        if isinstance(g, HostGraph) and not np.issubdtype(g.weights.dtype, np.integer):
            raise ValueError("weighted SSSP uses integer edge costs; got dtype "
                             + str(g.weights.dtype))
    cls = WeightedSSSPProgram if weighted else SSSPProgram
    prog = cls(nv=shards.spec.nv, start=start)
    if delta > 0:
        if not weighted:
            raise ValueError("delta-stepping orders WEIGHTED distances; "
                             "unweighted BFS buckets are the iterations")
        if repartition_every:
            raise ValueError("delta-stepping does not combine with repartition_every")
        # the SHARDS' weights (covers pre-built PushShards too): bucket
        # order finalizes too early under negative costs
        if float(np.asarray(shards.arrays.weights).min()) < 0:
            raise ValueError("delta-stepping needs non-negative weights")
        from lux_tpu_torch.engine import delta as delta_mod

        final, _, _ = delta_mod.run_push_delta(prog, shards, delta, max_iters,
                                               method=method, route=route, device=device)
        return shards.scatter_to_global(final.cpu().numpy())
    return push_run(prog, g, shards, max_iters, method, route, merge, device,
                    repartition_every, repartition_threshold)


def sssp_batched(g: HostGraph | PushShards, sources, num_parts: int = 1,
                 method: str = "auto", max_iters: int = 10_000,
                 device="cuda") -> np.ndarray:
    """Answer ``len(sources)`` BFS-SSSP queries in ONE batched engine run
    (serve/batched: the serving hot path as a library call); returns
    (Q, nv) int32 distances, nv == INF.  Each row is bitwise
    ``sssp(g, start=sources[q])``."""
    from lux_tpu_torch.graph.shards import PullShards, build_pull_shards
    from lux_tpu_torch.serve.batched import BatchedEngine

    if isinstance(g, PushShards):
        shards = g.pull
    elif isinstance(g, PullShards):
        shards = g
    else:
        shards = build_pull_shards(g, num_parts)
    sources = np.asarray(sources, np.int32)
    eng = BatchedEngine(shards, "sssp", len(sources), method=method,
                        max_iters=max_iters, device=device)
    return eng.run(sources).state


def inf_value(nv: int, weighted: bool = False) -> int:
    """The unreached-distance sentinel sssp() returns."""
    return WeightedSSSPProgram(nv=nv).inf if weighted else SSSPProgram(nv=nv).inf


def check_distances(g: HostGraph, dist: np.ndarray, weighted: bool = False) -> int:
    """Host ``-check`` oracle: the count of edges violating the triangle
    inequality dist[dst] <= dist[src] + w (0 at a fixpoint)."""
    d_src = dist[g.col_idx]
    d_dst = dist[g.dst_of_edges()]
    if weighted and g.weights is not None:
        viol = d_dst.astype(np.int64) > d_src.astype(np.int64) + g.weights
    else:
        # hop counts are at most the INF sentinel nv, so + 1 cannot wrap
        viol = d_dst > d_src + 1
    # relaxations from unreached (INF) sources don't count
    return int(np.count_nonzero(viol & (d_src < inf_value(g.nv, weighted))))


def bfs_reference(g: HostGraph, start: int) -> np.ndarray:
    """Host BFS oracle over the out-adjacency (CSR) view."""
    perm = np.argsort(g.col_idx, kind="stable")
    csr_dst = g.dst_of_edges()[perm]
    csr_row_ptr = np.zeros(g.nv + 1, dtype=np.int64)
    np.cumsum(np.bincount(g.col_idx, minlength=g.nv), out=csr_row_ptr[1:])
    dist = np.full(g.nv, g.nv, np.int32)
    dist[start] = 0
    dq = deque([start])
    while dq:
        u = dq.popleft()
        for v in csr_dst[csr_row_ptr[u]: csr_row_ptr[u + 1]]:
            if dist[v] == g.nv:
                dist[v] = dist[u] + 1
                dq.append(v)
    return dist
