"""Runners and NumPy oracles of the spec workloads.

Counterpart of ``lux_tpu.program.workloads``.  The four workloads —
multi-source BFS, k-core decomposition, seeded label propagation and
weighted triangle counting — exist only as declarative specs
(:mod:`lux_tpu_torch.program.library`) plus the thin host drivers below,
which lower through the engines' public entry points (``run_push``,
``run_pull_until``, ``run_pull_fixed``, ``compile_pull_phases``).

Each workload has the reference's NumPy oracle (``*_reference``) and
``check_*`` invariant for the CLI's ``-check`` verdict, copied as they
are, and a fast host oracle for graphs of the card's size
(``*_reference_fast``), which the tests hold to the reference's.

Stress corners, by design:
  * bfs        — frontier/push, the sparse->dense direction switch, routed
                 dense rounds; distance to the nearest of several sources.
  * kcore      — iterative peel: a host loop over k, each level one spec
                 program run to quiescence, warm-started from the previous
                 level's survivors (k-cores nest).
  * labelprop  — dense pull with a wide (V, L) probability state.
  * triangles  — two phases: per-vertex neighborhood bitsets (a sum whose
                 integer sum is the set union), then a reduce-only pass
                 intersecting the source and destination bitsets per edge.
                 The bitsets run as int32 bit patterns (:class:`BitPatterns`):
                 PyTorch's CUDA build has no uint32 arithmetic.

``mesh=`` and ``exchange="ring"`` raise NotImplementedError: the
distributed drivers come with multi-GPU.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Sequence, Tuple

import numpy as np
import torch

from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph.csc import HostGraph, from_edge_list
from lux_tpu_torch.graph.shards import PullShards, build_pull_shards, to_device
from lux_tpu_torch.models.sssp import refuse_unported
from lux_tpu_torch.ops import expand
from lux_tpu_torch.program import library
from lux_tpu_torch.program.spec import SpecProgram, active_changed, bind
from lux_tpu_torch.utils.device import resolve_device

#: triangle counting builds (V, ceil(nv/32)) bitsets — quadratic memory
#: in nv.  Bound it loudly instead of running out of memory quietly.
TRIANGLES_MAX_NV = 1 << 15


def symmetrize(g: HostGraph, unit_weights: bool = False) -> HostGraph:
    """Undirected simple view of ``g``: dedupe unordered pairs, drop
    self-loops, emit BOTH orientations.  Weights: max over the parallel
    directed duplicates of a pair (1 everywhere when the input is
    unweighted or ``unit_weights``) — k-core and triangle counting are
    classically undirected, so their apps run on this view by default."""
    src = np.asarray(g.col_idx, np.int64)
    dst = np.asarray(g.dst_of_edges(), np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    key = lo * g.nv + hi
    if g.weights is None or unit_weights:
        pairs = np.unique(key)
        w_und = np.ones(pairs.shape[0], np.int32)
    else:
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        w_s = np.asarray(g.weights)[keep][order]
        pairs, first = np.unique(key_s, return_index=True)
        w_und = np.maximum.reduceat(w_s, first).astype(np.int32)
    lo = (pairs // g.nv).astype(np.int64)
    hi = (pairs % g.nv).astype(np.int64)
    es = np.concatenate([lo, hi])
    ed = np.concatenate([hi, lo])
    return from_edge_list(es, ed, g.nv,
                          weights=np.concatenate([w_und, w_und]))


def on_device(shards: PullShards, device) -> PullShards:
    """``shards`` with its arrays moved to ``device`` once, so that runs
    over them (the apps' untimed and timed runs, every peel level) copy
    nothing."""
    return dataclasses.replace(shards, arrays=to_device(shards.arrays,
                                                        resolve_device(device)))


def _pull_setup(g, num_parts: int, device):
    """(PullShards, their arrays on ``device``): arrays that are tensors
    already (:func:`on_device`) are used as they are."""
    shards = g if isinstance(g, PullShards) else build_pull_shards(g, num_parts)
    if isinstance(shards.arrays.src_pos, torch.Tensor):
        return shards, shards.arrays
    return shards, to_device(shards.arrays, resolve_device(device))


def _global(shards, state: torch.Tensor) -> np.ndarray:
    return shards.scatter_to_global(state.cpu().numpy())


# ---------------------------------------------------------------------------
# BFS
# ---------------------------------------------------------------------------


def bfs_program(nv: int, sources: Sequence[int]) -> SpecProgram:
    srcs = tuple(sorted(set(int(s) for s in sources)))
    if not srcs:
        raise ValueError("bfs needs at least one source vertex")
    for s in srcs:
        if not 0 <= s < nv:
            raise ValueError(f"bfs source {s} out of range [0, {nv})")
    return bind(library.BFS, nv=nv, sources=srcs)


def bfs(g, sources: Sequence[int], num_parts: int = 1,
        max_iters: int = 10_000, method: str = "auto",
        engine: str = "push", mesh=None, route=None,
        exchange: str = "allgather", device="cuda") -> Tuple[np.ndarray, int]:
    """Multi-source BFS on ``device``: hop distance to the NEAREST source,
    INF == nv.  ``engine="push"`` runs the direction-optimizing frontier
    engine (the workload's home surface; ``route`` routes the dense
    rounds); ``engine="pull"`` runs the pull-until surface — bitwise the
    same distances (unique min fixpoint).  ``g``: a HostGraph, or the
    engine's shards (PushShards for push, PullShards for pull).  Returns
    (dist (nv,), iters)."""
    from lux_tpu_torch.graph.push_shards import PushShards, build_push_shards

    refuse_unported(mesh=mesh, exchange=exchange)
    if engine == "push":
        from lux_tpu_torch.engine import push

        shards = g if isinstance(g, PushShards) else build_push_shards(g, num_parts)
        prog = bfs_program(shards.spec.nv, sources)
        final, it, _ = push.run_push(prog, shards, max_iters, method,
                                     route=route, device=device)
        return _global(shards, final), int(it)
    if engine != "pull":
        raise ValueError(f"bfs engine must be 'push' or 'pull', got {engine!r}")
    shards, arrays = _pull_setup(g, num_parts, device)
    prog = bfs_program(shards.spec.nv, sources)
    state0 = pull.init_state(prog, arrays)
    final, it = pull.run_pull_until(prog, shards.spec, arrays, state0,
                                    max_iters, active_changed, method,
                                    route=route)
    return _global(shards, final), int(it)


def bfs_reference(g: HostGraph, sources: Sequence[int]) -> np.ndarray:
    """Host multi-source BFS oracle over the out-adjacency (CSR) view."""
    csr_row_ptr, csr_dst, _ = g.to_csr()
    dist = np.full(g.nv, g.nv, np.int32)
    dq = deque()
    for s in sorted(set(int(s) for s in sources)):
        dist[s] = 0
        dq.append(s)
    while dq:
        u = dq.popleft()
        for v in csr_dst[csr_row_ptr[u]: csr_row_ptr[u + 1]]:
            if dist[v] == g.nv:
                dist[v] = dist[u] + 1
                dq.append(v)
    return dist


def bfs_reference_fast(g: HostGraph, sources: Sequence[int]) -> np.ndarray:
    """:func:`bfs_reference` for large graphs: unweighted shortest paths
    of ``scipy.sparse.csgraph`` from each source, the minimum over the
    sources, INF == nv."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    srcs = sorted(set(int(s) for s in sources))
    adj = csr_matrix((np.ones(g.ne), (g.col_idx, g.dst_of_edges())),
                     shape=(g.nv, g.nv))
    d = shortest_path(adj, directed=True, unweighted=True, indices=srcs)
    d = np.atleast_2d(d).min(axis=0)
    return np.where(np.isinf(d), g.nv, d).astype(np.int32)


def check_bfs(g: HostGraph, dist: np.ndarray,
              sources: Sequence[int]) -> int:
    """-check invariant — the full min fixpoint, so the gate bounds the
    distances from BOTH sides: every source at 0; every edge satisfies
    dist[dst] <= dist[src] + 1 (reached sources only — the upper
    bound); and every non-source vertex's distance EQUALS
    min over in-edges of dist[src] + 1, INF included (the lower bound:
    an all-zeros answer fails here, not just an over-estimate)."""
    dist = np.asarray(dist, np.int64)
    srcs = set(int(s) for s in sources)
    bad = sum(int(dist[s] != 0) for s in srcs)
    dst = g.dst_of_edges()
    reached = dist[g.col_idx] < g.nv
    bad += int(np.sum((dist[dst] > dist[g.col_idx] + 1) & reached))
    # lower bound via the fixpoint: relax every edge once into a fresh
    # accumulator; a non-source vertex must sit exactly at its best
    # in-edge relaxation (clipped at the INF sentinel nv)
    best = np.full(g.nv, g.nv, np.int64)
    np.minimum.at(best, dst, np.minimum(dist[g.col_idx] + 1, g.nv))
    non_src = np.ones(g.nv, bool)
    non_src[list(srcs)] = False
    bad += int(np.sum(non_src & (dist != best)))
    return bad


# ---------------------------------------------------------------------------
# k-core decomposition
# ---------------------------------------------------------------------------


def kcore(g, kmax: int = 0, num_parts: int = 1, max_iters: int = 10_000,
          method: str = "auto", mesh=None, route=None, device="cuda",
          ) -> Tuple[np.ndarray, int, int]:
    """Coreness per vertex by ITERATIVE PEEL over the in-neighborhood:
    for k = 1, 2, ... run the one-level spec (library.KCORE) to
    quiescence — a vertex survives level k iff it keeps >= k alive
    in-neighbors — warm-starting each level from the previous level's
    survivors (k-cores nest, so the monotone fixpoint carries over).
    Classic undirected coreness: pass a ``symmetrize(g)`` view (the
    app's default).  ``kmax=0`` peels until the core empties.  Each
    level binds its own program (k is a parameter); the levels reuse one
    layout and one ``route`` plan on the device, and the coreness stays
    there too: a level costs its rounds' reads and one read of whether
    any vertex survived.  Returns (coreness (nv,) int32, k_max,
    total_rounds)."""
    refuse_unported(mesh=mesh)
    shards, arrays = _pull_setup(g, num_parts, device)
    dev = arrays.src_pos.device
    if route is not None:
        route = expand.plan_to_device(route, dev)
    coreness = torch.zeros(arrays.vtx_mask.shape, dtype=torch.int32, device=dev)
    state = None
    rounds = 0
    k = 1
    while kmax == 0 or k <= kmax:
        prog = bind(library.KCORE, kk=k)
        if state is None:
            state = pull.init_state(prog, arrays)
        state, it = pull.run_pull_until(prog, shards.spec, arrays, state,
                                        max_iters, active_changed, method,
                                        route=route)
        rounds += int(it)
        alive = state > 0
        if not bool(alive.any()):
            break
        coreness = torch.where(alive, k, coreness)
        k += 1
    core = _global(shards, coreness)
    return core, int(core.max(initial=0)), rounds


def kcore_reference(g: HostGraph, kmax: int = 0) -> np.ndarray:
    """NumPy peel oracle (same in-neighborhood semantics)."""
    nv = g.nv
    dst = g.dst_of_edges()
    coreness = np.zeros(nv, np.int32)
    alive = np.ones(nv, bool)
    k = 1
    while kmax == 0 or k <= kmax:
        while True:
            cnt = np.zeros(nv, np.int64)
            live = alive[g.col_idx] & alive[dst]
            np.add.at(cnt, dst[live], 1)
            new = alive & (cnt >= k)
            if (new == alive).all():
                break
            alive = new
        if not alive.any():
            break
        coreness[alive] = k
        k += 1
    return coreness


def kcore_reference_fast(g: HostGraph, kmax: int = 0) -> np.ndarray:
    """:func:`kcore_reference` for large graphs.  The count of alive
    in-neighbors is kept across waves, and a wave of removals lowers it
    only along the removed vertices' out-edges (one ``np.bincount`` over
    them), instead of recounting every edge each round.  The k-cores
    are unique, so the order of removals does not change the result."""
    nv = g.nv
    rp, csr_dst, _ = g.to_csr()
    cnt = g.in_degrees().astype(np.int64)
    coreness = np.zeros(nv, np.int32)
    alive = np.ones(nv, bool)
    k = 1
    while kmax == 0 or k <= kmax:
        while True:
            gone = np.flatnonzero(alive & (cnt < k))
            if gone.size == 0:
                break
            alive[gone] = False
            starts, lens = rp[gone], rp[gone + 1] - rp[gone]
            tot = int(lens.sum())
            if tot:
                first = np.repeat(starts - np.cumsum(lens) + lens, lens)
                edges = first + np.arange(tot)
                cnt -= np.bincount(csr_dst[edges], minlength=nv)
        if not alive.any():
            break
        coreness[alive] = k
        k += 1
    return coreness


def check_kcore(g: HostGraph, coreness: np.ndarray) -> int:
    """-check invariant: inside the level-c subgraph induced by
    {v: coreness[v] >= c}, every member keeps >= c in-neighbors — for
    c = each vertex's own coreness.  One vectorized pass: count
    in-neighbors u with coreness[u] >= coreness[v]."""
    coreness = np.asarray(coreness, np.int64)
    dst = g.dst_of_edges()
    cnt = np.zeros(g.nv, np.int64)
    np.add.at(cnt, dst, (coreness[g.col_idx] >= coreness[dst]).astype(
        np.int64))
    return int(np.sum((coreness > 0) & (cnt < coreness)))


# ---------------------------------------------------------------------------
# label propagation
# ---------------------------------------------------------------------------


def labelprop_program(labels: int, stride: int) -> SpecProgram:
    if labels < 2:
        raise ValueError(f"labelprop needs >= 2 labels, got {labels}")
    if stride < 1:
        raise ValueError(f"labelprop seed stride must be >= 1, got {stride}")
    return bind(library.LABELPROP, labels=int(labels), stride=int(stride),
                width=int(labels))


def labelprop(g, labels: int = 8, stride: int = 16, num_iters: int = 10,
              num_parts: int = 1, method: str = "auto", mesh=None,
              device="cuda") -> np.ndarray:
    """Seeded multi-class label propagation (dense pull, WIDE state):
    every ``stride``-th vertex is pinned to one-hot class
    ``vid % labels``; everyone else averages incoming class rows for
    ``num_iters`` fixed iterations.  Returns (nv, labels) float32
    class probabilities."""
    refuse_unported(mesh=mesh)
    shards, arrays = _pull_setup(g, num_parts, device)
    prog = labelprop_program(labels, stride)
    state0 = pull.init_state(prog, arrays)
    final = pull.run_pull_fixed(prog, shards.spec, arrays, state0, num_iters,
                                method)
    return _global(shards, final)


def labelprop_reference(g: HostGraph, labels: int = 8, stride: int = 16,
                        num_iters: int = 10) -> np.ndarray:
    """Float64 oracle of the identical recurrence."""
    nv = g.nv
    vid = np.arange(nv)
    seeded = (vid % stride) == 0
    eye = np.eye(labels)
    p = np.full((nv, labels), 1.0 / labels)
    p[seeded] = eye[vid[seeded] % labels]
    dst = g.dst_of_edges()
    for _ in range(num_iters):
        acc = np.zeros_like(p)
        np.add.at(acc, dst, p[g.col_idx])
        tot = acc.sum(-1, keepdims=True)
        norm = np.where(tot > 0, acc / np.maximum(tot, 1e-30), p)
        p = np.where(seeded[:, None], eye[vid % labels], norm)
    return p


def labelprop_reference_fast(g: HostGraph, labels: int = 8, stride: int = 16,
                             num_iters: int = 10) -> np.ndarray:
    """:func:`labelprop_reference` for large graphs: the same float64
    recurrence, each iteration's per-destination sum as one product with
    the (nv, nv) in-adjacency in scipy's CSR form (parallel edges count
    with their multiplicity)."""
    from scipy.sparse import csr_matrix

    nv = g.nv
    vid = np.arange(nv)
    seeded = (vid % stride) == 0
    eye = np.eye(labels)
    pinned = eye[vid % labels]
    adj = csr_matrix((np.ones(g.ne), g.col_idx, g.row_ptr), shape=(nv, nv))
    p = np.full((nv, labels), 1.0 / labels)
    p[seeded] = pinned[seeded]
    for _ in range(num_iters):
        acc = adj @ p
        tot = acc.sum(-1, keepdims=True)
        norm = np.where(tot > 0, acc / np.maximum(tot, 1e-30), p)
        p = np.where(seeded[:, None], pinned, norm)
    return p


def check_labelprop(probs: np.ndarray, labels: int, stride: int) -> int:
    """-check invariant: finite rows; seed rows exactly one-hot; every
    row with in-edges sums to ~1 (rows that kept the uniform prior do
    too, so the check is unconditional)."""
    probs = np.asarray(probs, np.float64)
    nv = probs.shape[0]
    vid = np.arange(nv)
    seeded = (vid % stride) == 0
    bad = int((~np.isfinite(probs)).any(axis=-1).sum())
    eye = np.eye(labels)
    bad += int((probs[seeded] != eye[vid[seeded] % labels]).any(-1).sum())
    bad += int(np.sum(np.abs(probs.sum(-1) - 1.0) > 1e-3))
    return bad


# ---------------------------------------------------------------------------
# weighted triangle counting (two-phase)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BitPatterns:
    """A uint32-state program run with its state held as int32 bit
    patterns, the same bits.  PyTorch's CUDA build has no uint32
    gather-reduce (no ``add``, ``index_add_`` or ``where`` kernel), and a
    sum modulo 2^32 gives the same bits in int32 as in uint32.  So the
    state enters the gather and the segmented sum as int32, and the
    program's own apply — its ``cast(acc, 'uint32')`` included — runs on
    the uint32 view.  The edge function must be bitwise (the triangle
    phases' ``src``), so it reads the patterns as they are."""

    prog: SpecProgram

    @property
    def spec(self):
        return self.prog.spec

    @property
    def reduce(self) -> str:
        return self.prog.reduce

    @property
    def needs_dst_state(self) -> bool:
        return self.prog.needs_dst_state

    def init_state(self, global_vid, degree, vtx_mask):
        return self.prog.init_state(global_vid, degree, vtx_mask).view(torch.int32)

    def edge_value(self, src_state, weight, dst_state=None):
        return self.prog.edge_value(src_state, weight, dst_state)

    def apply(self, old_local, acc, arrays):
        new = self.prog.apply(old_local.view(torch.uint32), acc, arrays)
        return new.view(torch.int32)


def require_simple(g: HostGraph) -> None:
    """Raise unless ``g`` has no parallel duplicate edges.  Phase 1's
    sum-as-union is exact only on a SIMPLE graph: a duplicate (src, dst)
    edge adds the source's bit twice and the binary carry corrupts the
    neighboring bitset lane.  symmetrize dedupes; a raw --directed input
    must be checked."""
    key = g.col_idx.astype(np.int64) * g.nv + g.dst_of_edges()
    if np.unique(key).size != g.ne:
        raise ValueError(
            "triangles needs a SIMPLE graph (no parallel duplicate "
            "edges — a duplicate source bit would carry into the "
            "next bitset lane); dedupe first, e.g. via "
            "program.workloads.symmetrize")


def triangles(g, num_parts: int = 1, method: str = "auto", device="cuda",
              ) -> Tuple[np.ndarray, dict]:
    """Weighted triangle counting as the TWO-PHASE spec program:

      phase 1 (library.TRI_NEIGHBORS, one pull iteration): each vertex
        accumulates the bitset union of its in-neighbors' ids, (V,
        ceil(nv/32)) words held as int32 bit patterns (:class:`BitPatterns`);
      phase 2 (library.TRI_COUNT, reduce-only through the pull engine's
        load/comp phase split): per edge (u, v), weight(u, v) *
        |bits(u) & bits(v)|, sum-reduced per destination.

    Returns (incidence (nv,) float32, stats).  ``incidence[v]`` is the
    weighted triangle incidence Σ_{u→v} w(u,v)·|N(u) ∩ N(v)|.  On a
    ``symmetrize(..., unit_weights=True)`` view the totals are exact
    counts: stats["triangles"] = Σ incidence / 6 (each triangle is seen
    once per directed edge).  Requires an edge-weighted graph (the
    symmetrize helper provides unit weights); a HostGraph must be simple
    (:func:`require_simple`), shards are taken as they are."""
    shards = g if isinstance(g, PullShards) else build_pull_shards(g, num_parts)
    nv = shards.spec.nv
    if nv > TRIANGLES_MAX_NV:
        raise ValueError(
            f"triangles builds (V, ceil(nv/32)) uint32 bitsets — "
            f"quadratic memory; nv={nv} exceeds the supported "
            f"{TRIANGLES_MAX_NV} (run a smaller graph)")
    if not shards.spec.weighted:
        raise ValueError(
            "triangles weights each closing edge; pass a weighted graph "
            "(program.workloads.symmetrize assigns unit weights)")
    if isinstance(g, HostGraph):
        require_simple(g)
    shards, arrays = _pull_setup(shards, num_parts, device)
    words = (nv + 31) // 32
    phase1 = BitPatterns(bind(library.TRI_NEIGHBORS, w=words, width=words))
    bits = pull.run_pull_fixed(phase1, shards.spec, arrays,
                               pull.init_state(phase1, arrays), 1, method)
    incidence = reduce_phase(bind(library.TRI_COUNT), shards, arrays,
                             bits, method)
    total = float(incidence.sum())
    return incidence, {
        "total_weighted_incidence": total,
        # exact only under unit weights (documented above)
        "triangles_if_unit": total / 6.0,
        "bitset_words": words,
    }


def reduce_phase(prog, shards, arrays, state, method: str = "auto",
                 ) -> np.ndarray:
    """Run a reduce-only spec phase: ONE gather + edge_value + segmented
    reduce over the supplied state, through the pull engine's public
    load/comp phase split (compile_pull_phases) — no update loop, so the
    phase needs no apply rule.  Returns the reduced (nv,) accumulator."""
    load, comp, _ = pull.compile_pull_phases(prog, shards.spec, method)
    acc = comp(arrays, load(arrays, state))
    return _global(shards, acc)


def triangles_reference(g: HostGraph) -> np.ndarray:
    """NumPy oracle: per-vertex weighted triangle incidence via
    adjacency sets (O(E·deg) — CLI/test scale)."""
    nv = g.nv
    dst = g.dst_of_edges()
    nbrs = [set() for _ in range(nv)]
    for u, v in zip(g.col_idx, dst):
        nbrs[int(v)].add(int(u))
    out = np.zeros(nv, np.float64)
    w = g.weights if g.weights is not None else np.ones(g.ne, np.int64)
    for u, v, ww in zip(g.col_idx, dst, w):
        out[int(v)] += float(ww) * len(nbrs[int(u)] & nbrs[int(v)])
    return out.astype(np.float32)


#: set bits of every byte value, the fallback of np.bitwise_count
_BYTE_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.int64)


def _popcount_rows(words: np.ndarray) -> np.ndarray:
    """Set bits per row of a (rows, w) uint32 array."""
    if hasattr(np, "bitwise_count"):  # NumPy >= 2
        return np.bitwise_count(words).sum(axis=1, dtype=np.int64)
    return _BYTE_POPCOUNT[words.view(np.uint8)].sum(axis=1)


def triangles_reference_fast(g: HostGraph, chunk: int = 1 << 14) -> np.ndarray:
    """:func:`triangles_reference` for graphs at TRIANGLES_MAX_NV: the
    in-neighbor sets as (nv, ceil(nv/32)) uint32 bitsets, and per edge
    (u, v) the set bits of bits(u) & bits(v), over chunks of ``chunk``
    edges, weighted and summed per destination in float64."""
    nv = g.nv
    words = (nv + 31) // 32
    dst = g.dst_of_edges().astype(np.int64)
    src = g.col_idx.astype(np.int64)
    bits = np.zeros((nv, words), np.uint32)
    np.bitwise_or.at(bits, (dst, src // 32),
                     (np.uint32(1) << (src % 32).astype(np.uint32)))
    w = (np.asarray(g.weights, np.float64) if g.weights is not None
         else np.ones(g.ne, np.float64))
    out = np.zeros(nv, np.float64)
    for lo in range(0, g.ne, chunk):
        hi = min(lo + chunk, g.ne)
        common = _popcount_rows(bits[src[lo:hi]] & bits[dst[lo:hi]])
        np.add.at(out, dst[lo:hi], w[lo:hi] * common)
    return out.astype(np.float32)


def check_triangles(g: HostGraph, incidence: np.ndarray) -> int:
    """-check: recompute the oracle and count mismatches (the workload
    is small-scale by construction, so the O(E·deg) oracle is the
    honest validator)."""
    ref = triangles_reference(g)
    got = np.asarray(incidence, np.float64)
    tol = 1e-5 * np.maximum(np.abs(ref), 1.0)
    return int(np.sum(~np.isfinite(got) | (np.abs(got - ref) > tol)))
