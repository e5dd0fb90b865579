"""Single-source shortest paths (BFS flavor) on the push engine.

Counterpart of ``lux_tpu.models.sssp``:
  * unweighted relaxation ``dist[dst] = min(dist[dst], dist[src] + 1)``;
  * dist is int32 with INF encoded as nv;
  * a single-source sparse frontier at ``start``;
  * direction-optimized iterations until no vertex changes;
  * the ``-check`` invariant dist[dst] <= dist[src] + 1 on every edge.

``WeightedSSSPProgram`` relaxes with integer edge costs (an extension
beyond Lux, as in the reference); ``delta=`` runs it by delta-stepping
(engine/delta.py) and ``repartition_every=`` rebalances the parts' cuts
from their measured load (engine/repartition.py).  ``mesh=`` (a
parallel.mesh.PartsGroup, the reference's device mesh) spreads the parts
over the ranks of torch.distributed: the allgather push, or with
``exchange="ring"`` the ring push; every rank gets the global answer.
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


def push_run(prog, g, shards, max_iters, method, route, merge, device,
             repartition_every: int = 0, repartition_threshold: float = 1.25,
             mesh=None, exchange: str = "allgather") -> np.ndarray:
    """Run ``prog`` on the push engine: on ``device``, or over the ranks of
    ``mesh`` with the allgather or the ring dense exchange; with
    ``repartition_every > 0`` on the adaptive repartitioning driver
    (which needs the HostGraph ``g`` for its rebuilds).  ``shards`` is a
    PushShards or a parallel.ring.PushRingShards.  Returns the (nv,)
    global state (on every rank)."""
    from lux_tpu_torch.parallel.ring import PushRingShards, build_push_ring_shards

    if exchange not in ("allgather", "ring"):
        raise ValueError(f"unsupported exchange {exchange!r}")
    if exchange == "ring" and mesh is None:
        raise ValueError("exchange='ring' needs a mesh (a parallel.mesh.PartsGroup)")
    if route is not None and (mesh is not None or repartition_every > 0):
        raise ValueError("route= is a single-device non-adaptive driver option; the "
                         "distributed and repartitioning push run the direct gather")
    push_sh = shards.push if isinstance(shards, PushRingShards) else shards
    if repartition_every > 0 and not isinstance(g, HostGraph):
        raise ValueError("repartition_every needs the HostGraph (shard rebuilds)")
    if exchange == "ring" and not isinstance(shards, PushRingShards):
        if not isinstance(g, HostGraph):
            raise ValueError("exchange='ring' needs a HostGraph or pre-built PushRingShards")
        # ring buckets on the SAME partition: no second push build
        shards = build_push_ring_shards(g, push_sh.spec.num_parts,
                                        parts_subset=list(mesh.parts), push=push_sh)
    layout = shards if exchange == "ring" else push_sh
    if repartition_every > 0:
        from lux_tpu_torch.engine import repartition

        return repartition.run_push_adaptive(
            prog, g, push_sh.spec.num_parts, chunk=repartition_every,
            threshold=repartition_threshold, max_iters=max_iters, method=method,
            mesh=mesh, shards=layout, exchange=exchange, device=device).state
    lay = push.place_layout(prog, layout, mesh, method, device, route=route, merge=merge)
    return lay.global_state(lay.loop(lay.init(), max_iters).state)


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
    relaxed edges than chaotic relaxation.  ``mesh`` (a
    parallel.mesh.PartsGroup) runs over its ranks, ``exchange="ring"``
    streaming the dense rounds; every rank returns the distances."""
    from lux_tpu_torch.parallel.ring import PushRingShards

    shards = (g if isinstance(g, (PushShards, PushRingShards))
              else build_push_shards(g, num_parts))
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
        if exchange != "allgather" or repartition_every:
            raise ValueError("delta-stepping is an allgather-exchange driver; it does not "
                             "combine with exchange='ring' or repartition_every")
        if route is not None and mesh is not None:
            raise ValueError("route= delta-stepping is single-device")
        # the SHARDS' weights (covers pre-built PushShards too): bucket
        # order finalizes too early under negative costs
        if float(np.asarray(shards.arrays.weights).min()) < 0:
            raise ValueError("delta-stepping needs non-negative weights")
        from lux_tpu_torch.engine import delta as delta_mod

        delta_mod._validate(prog, delta)
        push_sh = shards.push if isinstance(shards, PushRingShards) else shards
        lay = push.place_layout(prog, push_sh, mesh, method, device, route=route)
        out = delta_mod.run_window(lay, delta, delta_mod.init_on(lay, delta), max_iters)
        return lay.global_state(out.state)
    return push_run(prog, g, shards, max_iters, method, route, merge, device,
                    repartition_every, repartition_threshold, mesh, exchange)


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
