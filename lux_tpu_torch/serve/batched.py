"""Batched multi-source engines: a TRAILING query axis over shared shards.

Counterpart of ``lux_tpu.serve.batched``.  One iteration answers Q
queries at once: the per-vertex state is (P, V, Q) instead of (P, V), the
per-edge gather reads (E, Q) rows, and the segmented reducers
(ops/segment.py) reduce each query lane independently.  With Q on the
minor axis each edge's indices are decoded once and move Q contiguous
lanes, so the per-edge overhead amortizes by Q.

Numerics: every reducer strategy combines along the edge axis with the
query lanes independent ("mxscan" falls back to the plain scan: the
kernel is 1-D and the (E, Q) values are not), so column q of a batched
run performs exactly the operations of a single-query run of the same
method.  For SSSP the converged distances are also the unique fixpoint
of min-relaxation, so they equal the push engine's (engine/push.py)
bitwise under every method.

The loop runs on the host, one batched iteration after another, with ONE
host read a round: the (Q,) vector of per-query changed counts, from
which both "any query still active" and the per-query round counters
follow.  A query whose state stopped changing is masked out of the round
counters, so it stops contributing traversed edges while stragglers in
the batch keep relaxing (relaxing a converged query is a no-op).  At most
two (P, V, Q) state buffers are live in the loop: the state and the
iteration's new state.

An engine built with ``overlay_static`` (lux_tpu_torch.mutate.overlay)
serves a MUTATING graph: every ``run`` then requires the current overlay
arrays (and, for degree-consuming programs like PPR, the merged degree
stack).  Tombstoned base edges neutralize their (E, Q) values (the (E,)
mask broadcasts over the query lanes), and the fixed-capacity insert
buffer is folded into the accumulator as (D, Q) rows before apply.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from lux_tpu_torch.engine import methods
from lux_tpu_torch.graph.shards import PullShards, ShardArrays, ShardSpec, to_device
from lux_tpu_torch.mutate import overlay as ovl
from lux_tpu_torch.ops import segment
from lux_tpu_torch.program import BatchedSpecBacked, library
from lux_tpu_torch.utils.device import resolve_device

_REDUCERS = segment.reducers()


class QueryProgram:
    """Contract of a batched query app (the PullProgram analog with a
    trailing query axis).  ``queries`` is a (Q,) int32 tensor of
    per-query parameters (SSSP sources, PPR seeds)."""

    #: "sum" | "min" | "max" per-destination combiner.
    reduce: str
    #: True = iterate until every query's state stops changing (frontier
    #: apps); False = a fixed iteration count (PageRank style).
    fixpoint: bool

    def init_part(self, global_vid, degree, vtx_mask, queries):
        """(V,) part arrays + (Q,) queries -> (V, Q) initial state."""
        raise NotImplementedError

    def edge_value(self, src_state, weights):
        """(E, Q) gathered source states + (E,) weights -> (E, Q)."""
        raise NotImplementedError

    def apply(self, old_local, acc, arr, queries):
        """(V, Q) old state + (V, Q) reduced acc -> (V, Q) new state."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class MultiSourceSSSP(BatchedSpecBacked, QueryProgram):
    """Q-source BFS-SSSP (unweighted hop counts, INF == nv): the Q-axis
    lift of program.library.SSSP with its ``start`` parameter bound to
    the query vector, so each lane evaluates models/sssp.SSSPProgram's
    spec."""

    nv: int

    @property
    def spec(self):
        return library.SSSP

    @property
    def inf(self) -> int:
        return self.nv

    def _env(self):
        return {"inf": self.inf}


@dataclasses.dataclass(frozen=True)
class MultiSourcePPR(BatchedSpecBacked, QueryProgram):
    """Q-seed personalized PageRank: the Q-axis lift of
    program.library.PPR with ``seed`` bound to the query vector; column q
    is a single-seed models/pagerank.PPRProgram pull run of the same
    method."""

    nv: int
    alpha: float = library.ALPHA

    @property
    def spec(self):
        return library.PPR

    def _env(self):
        # the serve engines are float32 (the driver refuses other dtypes)
        return {"nv": self.nv, "alpha": self.alpha, "dtype": "float32"}


def _batched_part(prog, method: str, arr: ShardArrays, full: torch.Tensor,
                  loc: torch.Tensor, queries: torch.Tensor, oa=None) -> torch.Tensor:
    """One part's batched step: (E, Q) gather, edge values, the segmented
    reduce of every lane, apply -> (V, Q).  ``oa`` (this part's
    mutate.overlay.DeviceOverlay) neutralizes the tombstoned edges' values
    and folds the (D, Q) insert rows into the accumulator."""
    src = full.index_select(0, arr.src_pos)  # (E, Q)
    vals = prog.edge_value(src, arr.weights)
    del src  # free the gather now where the edge function copied it
    if oa is not None:
        vals = ovl.mask_deleted(vals, oa.del_val[:, None], prog.reduce)
    acc = _REDUCERS[prog.reduce](vals, arr.row_ptr, arr.head_flag,
                                 arr.dst_local, method=method)
    del vals
    if oa is not None:
        acc = ovl.delta_scatter(acc, full, oa, prog.edge_value, prog.reduce)
    return prog.apply(loc, acc, arr, queries)


def batched_iteration(prog, spec: ShardSpec, method: str, arrays: ShardArrays,
                      state: torch.Tensor, queries: torch.Tensor,
                      overlays=None) -> torch.Tensor:
    """One batched pull iteration over the whole (P, V, Q) shard stack;
    returns the new stack (a fresh buffer: ``state`` is only read).
    ``overlays``: one DeviceOverlay per part, or None."""
    full = state.reshape((spec.gathered_size,) + tuple(state.shape[2:]))
    if spec.num_parts == 1:
        return _batched_part(prog, method, arrays.part(0), full, state[0], queries,
                             None if overlays is None else overlays[0]).unsqueeze(0)
    new = torch.empty_like(state)
    for p in range(spec.num_parts):
        new[p] = _batched_part(prog, method, arrays.part(p), full, state[p], queries,
                               None if overlays is None else overlays[p])
    return new


def batched_init(prog, arrays: ShardArrays, queries: torch.Tensor) -> torch.Tensor:
    """The (P, V, Q) initial state of a batch."""
    return torch.stack([
        prog.init_part(arrays.global_vid[p], arrays.degree[p], arrays.vtx_mask[p],
                       queries)
        for p in range(arrays.global_vid.shape[0])])


def run_batched_fixpoint(prog, spec: ShardSpec, method: str, arrays: ShardArrays,
                         queries: torch.Tensor, state: torch.Tensor, max_iters: int,
                         overlays=None):
    """Iterate while ANY query is still changing (at most ``max_iters``);
    per-query round counters freeze as queries converge.  ``state`` is
    consumed (the caller keeps no reference, so the first iteration
    frees it).  Returns (state, iterations, per-query rounds)."""
    q = queries.shape[0]
    active = [1] * q
    rounds = [0] * q
    it = 0
    while it < max_iters and any(a > 0 for a in active):
        new = batched_iteration(prog, spec, method, arrays, state, queries, overlays)
        changed = (new != state).sum(dim=(0, 1), dtype=torch.int32)  # (Q,)
        # a query active at iteration entry walked every edge this round
        rounds = [r + (a > 0) for r, a in zip(rounds, active)]
        state = new
        del new
        active = changed.tolist()  # the round's one host read
        it += 1
    return state, it, rounds


def run_batched_fixed(prog, spec: ShardSpec, method: str, arrays: ShardArrays,
                      queries: torch.Tensor, state: torch.Tensor, num_iters: int,
                      overlays=None):
    """``num_iters`` batched iterations (PPR style), no host read.
    Returns (state, iterations, per-query rounds)."""
    for _ in range(num_iters):
        state = batched_iteration(prog, spec, method, arrays, state, queries, overlays)
    return state, num_iters, [num_iters] * queries.shape[0]


@dataclasses.dataclass
class BatchedResult:
    """One batch answer: per-query global state + work accounting."""

    state: np.ndarray  # (Q, nv)
    iters: int  # loop iterations the batch ran (max over queries)
    rounds: np.ndarray  # (Q,) int32 dense rounds each query was active
    traversed: list  # (Q,) python ints: edges walked per query

    def query_state(self, i: int) -> np.ndarray:
        return self.state[i]


def make_program(app: str, nv: int) -> QueryProgram:
    """The served app registry ('sssp' | 'ppr')."""
    if app == "sssp":
        return MultiSourceSSSP(nv=nv)
    if app == "ppr":
        return MultiSourcePPR(nv=nv)
    raise ValueError(f"unknown served app {app!r}; expected 'sssp' or 'ppr'")


def resolve_method(method: str, app: str, nv: int, device) -> str:
    """``method`` for ``app``'s reduce on ``device`` (engine/methods.resolve:
    ``auto`` -> the measured winner of the device's platform)."""
    return methods.resolve(method, make_program(app, nv).reduce,
                           methods.default_platform(device))


class BatchedEngine:
    """One batched engine bound to a (shards, app, Q, method) tuple.
    ``run`` answers exactly ``q`` queries per call (the scheduler pads
    short batches); ``warm()`` runs one dummy batch so the first launches
    (module loads, the allocator's growth to the (E, Q) temporaries)
    happen at service start, not on the first request.

    ``device_arrays``: the shards' arrays already on the device, shared by
    every engine of a warm cache (one device copy of the O(E) arrays);
    without it the engine places its own copy on ``device``.

    ``overlay_static`` (mutate.overlay.OverlayStatic) builds the LIVE
    twin: every ``run`` then REQUIRES the current overlay arrays — an
    engine built for a mutating graph must never silently answer from
    the base graph."""

    def __init__(self, shards: PullShards, app: str, q: int,
                 method: str = "auto", num_iters: int = 10,
                 max_iters: int = 10_000, device_arrays=None,
                 overlay_static=None, device="cuda"):
        if q < 1:
            raise ValueError(f"q must be >= 1, got {q}")
        self.overlay_static = overlay_static
        self.shards = shards
        self.app = app
        self.q = q
        self.prog = make_program(app, shards.spec.nv)
        if device_arrays is None:
            self.device = resolve_device(device)
            device_arrays = to_device(shards.arrays, self.device)
        else:
            self.device = device_arrays.src_pos.device
        self._arrays = device_arrays
        self.method = resolve_method(method, app, shards.spec.nv, self.device)
        self.num_iters = num_iters
        self.max_iters = max_iters
        if self.prog.fixpoint:
            self._loop, self._stop = run_batched_fixpoint, max_iters
        else:
            self._loop, self._stop = run_batched_fixed, num_iters
        self._warmed = False
        self._warm_lock = threading.Lock()

    def _run(self, queries: torch.Tensor, stop: int, arrays=None, overlays=None):
        # the initial state goes straight into the loop: no reference
        # here keeps it alive past the first iteration
        arrays = self._arrays if arrays is None else arrays
        return self._loop(self.prog, self.shards.spec, self.method, arrays,
                          queries, batched_init(self.prog, arrays, queries), stop,
                          overlays)

    def _empty_oarrays(self):
        return ovl.empty_overlay_arrays(self.shards, self.overlay_static.cap)

    def device_overlays(self, oarrays) -> list:
        """Overlay arrays (numpy OverlayArrays, or the per-part device
        list this returns) as one DeviceOverlay per part on the engine's
        device."""
        if isinstance(oarrays, list):
            return oarrays
        return ovl.device_overlay(oarrays, self.device, self.shards.spec.nv_pad)

    def _query_rows(self, state: torch.Tensor) -> torch.Tensor:
        """(P, V, Q) stacked state -> (Q, nv) rows in global vertex order,
        de-padded and transposed on the state's device (a host transpose
        of the answers costs more than the batch at RMAT 20)."""
        cuts = self.shards.cuts
        parts = [state[p, : int(cuts[p + 1] - cuts[p])] for p in range(state.shape[0])]
        glob = parts[0] if len(parts) == 1 else torch.cat(parts)  # (nv, Q)
        return glob.T.contiguous()

    def warm(self, oarrays=None) -> "BatchedEngine":
        """Run one dummy batch (queries = vertex 0, one iteration) and wait
        for it.  Serialized: concurrent pumps (the scheduler thread and a
        draining caller) must not both pay the first launches.  An
        overlay engine warms against the given (or the empty) overlay."""
        with self._warm_lock:
            if not self._warmed:
                q0 = torch.zeros(self.q, dtype=torch.int32, device=self.device)
                overlays = None
                if self.overlay_static is not None:
                    overlays = self.device_overlays(
                        oarrays if oarrays is not None else self._empty_oarrays())
                self._run(q0, 1, overlays=overlays)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._warmed = True
        return self

    def run(self, queries, oarrays=None, degree=None) -> BatchedResult:
        """Answer ``queries`` ((q,) int vertex ids) -> BatchedResult, on
        the host.  ``oarrays``: the current mutation overlay (required iff
        the engine was built with ``overlay_static``; numpy OverlayArrays
        or the list ``device_overlays`` returns).  ``degree``: the merged
        (P, V) out-degree stack, substituting the base degrees for
        degree-consuming programs."""
        queries = np.asarray(queries, np.int32)
        if queries.shape != (self.q,):
            raise ValueError(
                f"engine is built for Q={self.q}; got {queries.shape}")
        nv = self.shards.spec.nv
        if queries.size and (queries.min() < 0 or queries.max() >= nv):
            raise ValueError(f"query vertex out of range [0, {nv})")
        if (self.overlay_static is None) != (oarrays is None):
            # a silently ignored overlay would serve base-graph answers
            # under a live graph
            raise ValueError(
                "overlay_static and oarrays must be passed together: "
                "BatchedEngine(..., overlay_static=ostatic) and "
                "run(..., oarrays=oarr)")
        arrays = self._arrays
        if degree is not None:
            arrays = arrays._replace(degree=torch.as_tensor(degree).to(self.device))
        overlays = None if oarrays is None else self.device_overlays(oarrays)
        q_dev = torch.from_numpy(queries.copy()).to(self.device)
        state, it, rounds = self._run(q_dev, self._stop, arrays, overlays)
        self._warmed = True
        rows = self._query_rows(state)
        del state
        ne = self.shards.spec.ne
        return BatchedResult(
            state=rows.cpu().numpy(),  # .cpu() waits for the finished batch
            iters=int(it),
            rounds=np.asarray(rounds, np.int32),
            traversed=[int(r) * ne for r in rounds],
        )
