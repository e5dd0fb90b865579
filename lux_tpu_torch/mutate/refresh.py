"""Incremental refresh: warm-restart the apps after edge churn.

Counterpart of ``lux_tpu.mutate.refresh``.  A cold recompute pays load,
shard build, plan and the full iteration; a refresh pays an O(delta) host
analysis plus a warm run of the overlay engines from the prior converged
state.

Per-app exactness contracts (the parity tests pin them):

  * SSSP (min, int32) / CC (max, int32): the merged graph's fixpoint is
    UNIQUE, so a sound refresh lands on the cold rebuild's exact bits.
    Deletions need an invalidation pass — a monotone engine cannot
    un-relax:
      - SSSP: dirty = destinations of deleted TIGHT edges (dist[v] ==
        dist[u] + w), closed over tight out-edges (the decremental
        cascade; over-approximation is safe); dirty resets to INF, and
        the frontier seeds with every LIVE in-neighbor of the dirty set
        plus the insert endpoints.  Needs strictly positive weights.
      - CC: dirty = every vertex whose label belongs to a component a
        deletion touched; dirty resets to its own id and seeds active,
        with the region's live in-neighbors.
  * PageRank (f32 sum): the warm state is the prior ranks rescaled for
    the changed out-degrees, iterated to an EXACT f32 fixpoint (residual
    == 0) of the overlay map.  The overlay's sum association differs
    from a cold-rebuilt layout's, so the converged fixpoints are
    compared, never single iterations.

The probe's count is read on the host once an iteration
(engine/pull.run_pull_until).  The reference's ``mutate.overlay`` and
``mutate.refresh`` spans are not ported: lux_tpu.obs has no counterpart
here yet.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from lux_tpu_torch.graph.shards import global_to_stacked


def _stack(shards, vec, fill=0):
    """Global (nv,) -> the shards' (P, nv_pad) stacked layout with
    ``fill`` on padding slots (global_to_stacked zero-fills; the push
    apps keep INF there, as their init_state does)."""
    out = global_to_stacked(np.asarray(shards.cuts), shards.arrays.vtx_mask.shape[1], vec)
    if fill:
        out = np.where(np.asarray(shards.arrays.vtx_mask), out, fill)
    return out.astype(vec.dtype)


# ---------------------------------------------------------------------------
# deletion-invalidation analysis (host, O(affected))
# ---------------------------------------------------------------------------


def _dead_edges(mg, weighted: bool):
    """(src, dst, w) of EVERY edge the log removed: base tombstones plus
    dead inserts (a prior state may have depended on an insert a later
    batch deleted; over-including is safe)."""
    g = mg.base
    dele = mg.log.deleted_edges()
    dst_of = np.searchsorted(np.asarray(g.row_ptr, np.int64), dele, side="right") - 1
    src_of = np.asarray(g.col_idx, np.int64)[dele]
    w_of = (np.asarray(g.weights, np.int64)[dele] if weighted
            else np.ones(len(dele), np.int64))
    dead = ~mg.log.ins_live
    dsrc = mg.log.ins_src[dead]
    ddst = mg.log.ins_dst[dead]
    dw = mg.log.ins_w[dead] if weighted else np.ones(int(dead.sum()), np.int64)
    return (np.concatenate([src_of, dsrc]), np.concatenate([dst_of, ddst]),
            np.concatenate([w_of, dw]))


def sssp_dirty(mg, dist: np.ndarray, start: int, weighted: bool = False) -> np.ndarray:
    """(nv,) bool: vertices whose distance a deletion may invalidate —
    the closure over TIGHT out-edges (live base edges and live inserts)
    of the old distance field.  A vertex left clean keeps a shortest path
    that avoids every removed edge."""
    g = mg.base
    dirty = np.zeros(g.nv, bool)
    rs, rd, rw = _dead_edges(mg, weighted)
    if not len(rs):
        return dirty
    if weighted:
        wall = np.asarray(g.weights, np.int64)
        _, _, liw = mg.log.live_inserts()
        if ((len(wall) and wall.min() <= 0) or (len(rw) and rw.min() <= 0)
                or (len(liw) and liw.min() <= 0)):
            raise ValueError(
                "sssp refresh under deletion needs strictly positive "
                "weights (zero-weight tight cycles break the "
                "invalidation cascade) — compact instead")
    dist = np.asarray(dist, np.int64)
    tight = dist[rd] == dist[rs] + rw
    seeds = np.unique(rd[tight])
    seeds = seeds[seeds != start]  # the source's 0 never depends on edges
    if not len(seeds):
        return dirty
    csr_row_ptr, csr_dst, csr_perm = mg.base_csr()
    w_of = np.asarray(g.weights, np.int64) if weighted else np.ones(g.ne, np.int64)
    csr_w = w_of[csr_perm]
    csr_live = (~mg.log.del_base)[csr_perm]
    # live inserts as a second out-adjacency, sorted by source
    isrc, idst, iw = mg.log.live_inserts()
    order = np.argsort(isrc, kind="stable")
    ins_ptr = np.searchsorted(isrc[order], np.arange(g.nv + 1))
    ins_dst = idst[order]
    ins_w = iw[order] if weighted else np.ones(len(order), np.int64)
    # the closure level by level (the reference walks it vertex by vertex
    # with a queue; the closure is the same set whatever the order)
    dirty[seeds] = True
    front = seeds
    while len(front):
        cands = []
        for ptr, dst_of, w_of_e, live in ((csr_row_ptr, csr_dst, csr_w, csr_live),
                                          (ins_ptr, ins_dst, ins_w, None)):
            src, e = _out_edges(np.asarray(ptr, np.int64), front)
            t = np.asarray(dst_of, np.int64)[e]
            ok = dist[t] == dist[src] + w_of_e[e]
            if live is not None:
                ok &= live[e]
            cands.append(t[ok])
        t = np.unique(np.concatenate(cands))
        t = t[~dirty[t] & (t != start)]
        dirty[t] = True
        front = t
    return dirty


def _out_edges(ptr: np.ndarray, verts: np.ndarray):
    """(source, edge index) of every out-edge of ``verts`` under the
    offsets ``ptr``, in vertex order."""
    lo, hi = ptr[verts], ptr[verts + 1]
    cnt = hi - lo
    total = int(cnt.sum())
    src = np.repeat(verts, cnt)
    first = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
    return src, first + np.arange(total, dtype=np.int64)


def cc_dirty(mg, labels: np.ndarray) -> np.ndarray:
    """(nv,) bool: every vertex whose converged label belongs to a
    label-component holding a removed edge's endpoint (a deletion may
    split it, and max-label cannot decrease incrementally)."""
    g = mg.base
    rs, rd, _ = _dead_edges(mg, weighted=False)
    if not len(rs):
        return np.zeros(g.nv, bool)
    labels = np.asarray(labels, np.int64)
    bad = np.unique(np.concatenate([labels[rs], labels[rd]]))
    return np.isin(labels, bad)


def _live_in_neighbors(mg, region: np.ndarray) -> np.ndarray:
    """(nv,) bool: sources of LIVE base in-edges into ``region`` plus
    live insert sources targeting it — the boundary that must seed the
    warm frontier."""
    g = mg.base
    seeds = np.zeros(g.nv, bool)
    if region.any():
        dst_of = g.dst_of_edges()
        m = region[dst_of] & ~mg.log.del_base
        seeds[np.asarray(g.col_idx, np.int64)[m]] = True
    isrc, idst, _ = mg.log.live_inserts()
    if len(isrc):
        seeds[isrc[region[idst]]] = True
    return seeds


# ---------------------------------------------------------------------------
# warm-restart entry points
# ---------------------------------------------------------------------------


def warm_push_carry(pspec, arrays, state0: torch.Tensor, frontier: torch.Tensor,
                    force_active: bool):
    """A push.PushCarry seeded from a prior stacked state and frontier
    mask (the warm twin of push._init_carry).  ``force_active`` keeps the
    loop alive for one round when the frontier is empty but the log is
    not (the insert fold runs inside the round)."""
    from lux_tpu_torch.engine import push

    mask0 = frontier & arrays.vtx_mask
    q_vid, q_val, cnt = push.queues_of(pspec, arrays, mask0, state0)
    active = cnt.sum(dtype=torch.int32)
    if force_active:
        active = active.clamp_min(1)
    return push.PushCarry(state0, q_vid, q_val, cnt, 0, active, 0,
                          (0,) * state0.shape[0], 0)


def _run_push_overlay(prog, mg, state_g, frontier_g, method, max_iters, pad_fill,
                      device):
    """The shared warm push loop: the overlay and the patched CSR through
    push.run_push_chunk, from the prior state and frontier."""
    from lux_tpu_torch.engine import push

    pshards = mg.push_shards
    dev, arrays, parrays = mg.device_push(device)
    ostatic, oarr, tomb = mg.push_overlay_parts()
    if len(tomb[0]):
        csr = parrays.csr_dst_local.clone()
        csr[torch.from_numpy(tomb[0]).to(dev), torch.from_numpy(tomb[1]).to(dev)] = \
            pshards.spec.nv_pad
        parrays = parrays._replace(csr_dst_local=csr)
    state = torch.from_numpy(_stack(pshards.pull, state_g, fill=pad_fill)).to(dev)
    frontier = torch.from_numpy(_stack(pshards.pull, frontier_g.astype(np.int32)) > 0).to(dev)
    carry0 = warm_push_carry(pshards.pspec, arrays, state, frontier,
                             force_active=not mg.log.empty)
    out = push.run_push_chunk(prog, pshards.pspec, pshards.spec, arrays, parrays, carry0,
                              max_iters, method, overlay_static=ostatic, oarrays=oarr)
    return out.state, out.it


def refresh_sssp(mg, prior_state_g: np.ndarray, start: int, method: str = "auto",
                 weighted: bool = False, max_iters: int = 10_000, device="cuda"):
    """Warm SSSP refresh.  ``prior_state_g``: the (nv,) converged
    distances on the PRE-churn graph.  Returns (dist (nv,) numpy, rounds)
    on the merged graph — bitwise a cold rebuild's (unique int
    fixpoint)."""
    from lux_tpu_torch.models.sssp import SSSPProgram, WeightedSSSPProgram

    cls = WeightedSSSPProgram if weighted else SSSPProgram
    prog = cls(nv=mg.base.nv, start=start)
    dist = np.asarray(prior_state_g).copy()
    dirty = sssp_dirty(mg, dist, start, weighted)
    seeds = _live_in_neighbors(mg, dirty)
    # boundary members must hold a REACHED value to be worth pushing
    seeds &= np.asarray(dist) < prog.inf
    seeds &= ~dirty
    isrc, _, _ = mg.log.live_inserts()
    if len(isrc):
        s = np.unique(isrc)
        seeds[s[dist[s] < prog.inf]] = True
    dist[dirty] = prog.inf
    dist[start] = 0
    if dirty[start]:
        seeds[start] = True
    state, it = _run_push_overlay(prog, mg, dist, seeds, method, max_iters,
                                  pad_fill=prog.inf, device=device)
    return mg.push_shards.scatter_to_global(state.cpu().numpy()), it


def refresh_components(mg, prior_labels_g: np.ndarray, method: str = "auto",
                       max_iters: int = 10_000, device="cuda"):
    """Warm CC refresh from prior converged labels; returns (labels (nv,)
    numpy, rounds) — bitwise a cold rebuild's."""
    from lux_tpu_torch.models.components import MaxLabelProgram

    prog = MaxLabelProgram()
    labels = np.asarray(prior_labels_g).copy()
    dirty = cc_dirty(mg, labels)
    seeds = _live_in_neighbors(mg, dirty) | dirty
    isrc, idst, _ = mg.log.live_inserts()
    if len(isrc):
        seeds[np.unique(isrc)] = True
        seeds[np.unique(idst)] = True
    labels[dirty] = np.flatnonzero(dirty)  # reset to own id (cold init)
    state, it = _run_push_overlay(prog, mg, labels, seeds, method, max_iters,
                                  pad_fill=-1, device=device)
    return mg.push_shards.scatter_to_global(state.cpu().numpy()), it


def _changed_count(old, new):
    """Residual probe: per-part count of entries that moved — residual 0
    is the exact-fixpoint convergence the refresh contract uses."""
    return (old != new).reshape(old.shape[0], -1).sum(dim=1, dtype=torch.int32)


def pagerank_tolerance_threshold(tolerance: float, alpha: float | None = None) -> float:
    """The per-entry residual threshold a declared served-error bound
    ``tolerance`` buys the tolerance refresh: tolerance * (1 - alpha), a
    conservative reading of the Banach bound of the alpha-contraction
    (the reference's sizing; its tests hold the served error to the
    declared tolerance against a float64 oracle)."""
    if alpha is None:
        from lux_tpu_torch.models.pagerank import ALPHA

        alpha = ALPHA
    if tolerance < 0:
        raise ValueError(f"tolerance must be >= 0, got {tolerance}")
    return float(tolerance) * (1.0 - float(alpha))


@lru_cache(maxsize=None)
def _tolerance_probe(threshold: float):
    """Residual probe of the tolerance refresh: counts entries that moved
    by MORE than ``threshold``.  One function object per threshold."""

    def probe(old, new):
        d = (new.float() - old.float()).abs()
        return (d > threshold).reshape(old.shape[0], -1).sum(dim=1, dtype=torch.int32)

    return probe


def pagerank_probe(tolerance: float = 0.0):
    """The convergence probe for a declared served-error bound:
    ``tolerance <= 0`` returns ``_changed_count`` itself (the exact
    residual == 0 path)."""
    if tolerance <= 0:
        return _changed_count
    return _tolerance_probe(pagerank_tolerance_threshold(tolerance))


def converge_pagerank(shards, method: str = "auto", route=None, overlay=None,
                      state0=None, max_iters: int = 512, dtype: str = "float32",
                      degree_override=None, tolerance: float = 0.0, device="cuda",
                      arrays=None):
    """Iterate PageRank to an EXACT f32 fixpoint (residual == 0), shared by
    the warm refresh and the cold comparison.  Returns (stacked state
    tensor on ``device``, iterations).  ``degree_override`` substitutes the
    merged out-degrees ((P, V) int32); ``tolerance > 0`` stops once every
    entry's step movement is inside pagerank_tolerance_threshold;
    ``arrays``: the shards' arrays already on the device."""
    from lux_tpu_torch.engine import pull
    from lux_tpu_torch.graph.shards import to_device
    from lux_tpu_torch.models.pagerank import PageRankProgram
    from lux_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    prog = PageRankProgram(nv=shards.spec.nv, dtype=dtype)
    if arrays is None:
        arrays = to_device(shards.arrays, dev)
    if degree_override is not None:
        arrays = arrays._replace(degree=torch.from_numpy(
            np.ascontiguousarray(degree_override)).to(dev))
    if state0 is None:
        state0 = pull.init_state(prog, arrays)
    elif not torch.is_tensor(state0):
        state0 = torch.from_numpy(np.ascontiguousarray(state0)).to(dev)
    return pull.run_pull_until(prog, shards.spec, arrays, state0, max_iters,
                               pagerank_probe(tolerance), method=method,
                               route=route, overlay=overlay)


def refresh_pagerank(mg, prior_state_stacked, method: str = "auto", route=None,
                     max_iters: int = 512, dtype: str = "float32",
                     tolerance: float = 0.0, device="cuda"):
    """Warm PageRank refresh: the prior converged ranks rescaled for the
    merged out-degrees (the state stores rank/deg), then the overlay step
    iterates to an exact f32 fixpoint.  ``route``: a BASE-graph plan —
    expand (unfused or pass-fused) or a fused family (tombstones in group
    space); the CF route refuses overlays.  ``tolerance`` as in
    converge_pagerank.  Returns (stacked state tensor, iterations)."""
    from lux_tpu_torch.mutate import overlay as ovl

    shards = mg.pull_shards
    ostatic, oarr = mg.pull_overlay()
    deg_new = ovl.merged_degree_stacked(shards, mg.log)
    deg_old = np.asarray(shards.arrays.degree, np.float32)
    dn = deg_new.astype(np.float32)
    scale = np.where(deg_old > 0, deg_old, 1.0) / np.where(dn > 0, dn, 1.0)
    prior = (prior_state_stacked.cpu().numpy() if torch.is_tensor(prior_state_stacked)
             else np.asarray(prior_state_stacked))
    warm = (prior.astype(np.float32) * scale).astype(dtype)
    _, arrays = mg.device_pull(device)
    return converge_pagerank(shards, method=method, route=route,
                             overlay=(ostatic, oarr), state0=warm, max_iters=max_iters,
                             dtype=dtype, degree_override=deg_new, tolerance=tolerance,
                             device=device, arrays=arrays)
