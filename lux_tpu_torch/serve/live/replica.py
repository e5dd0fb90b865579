"""LiveReplica: a worker's half of the mutation-aware serving contract.

Counterpart of ``lux_tpu.serve.live.replica`` on the port's mutate
package: the overlays move to the worker's device (default ``cuda``;
``device="cpu"`` must be asked for), the standing SSSP/CC rounds run the
push overlay loop and standing PageRank the pull engine on the route
``route_family`` names, through the ported kernels.

Owns, per replica:

* the local DELTA LOG — every replicated batch is journaled through
  ``mutate/deltalog.py``'s npz+``.ok`` protocol BEFORE it is
  acknowledged, so a worker killed between delta receipt and the
  marker loses exactly that batch and recovers to the exact committed
  prefix (the controller re-sends the rest at rejoin: snapshot +
  journal replay + catch-up stream);
* the SERVING OVERLAYS — after each applied batch the statically-shaped
  (OverlayArrays, merged-degree) pair is rebuilt (O(delta) host work)
  and handed to the worker's WarmEngineCache, so every batched query
  answers against the merged graph with NO retrace and NO snapshot
  swap;
* the STANDING STATES — per configured (app, arg) pair a converged
  app state kept warm with the warm-refresh machinery
  (``mutate/refresh.py``): SSSP/CC bitwise-equal to a cold rebuild of
  the merged graph, PageRank an exact f32 fixpoint.  ``refresh()`` runs
  BETWEEN queries (the worker's refresh thread) — queries keep flowing
  through the overlays meanwhile, so refresh latency never blocks
  reads.

Generations: ``generation()`` counts the journaled prefix
(``base_generation`` + batches applied); ``servable_generation()`` is
what the installed overlay actually serves — they differ only in the
overflow window (a batch journaled but too big for the overlay buffers,
the state that escalates to fleet compaction).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.mutate import overlay as ovl
from lux_tpu_torch.mutate.deltalog import DeltaLog
from lux_tpu_torch.mutate.graph import MutableGraph
from lux_tpu_torch.serve.live.journal import (
    read_live_meta,
    unpack_batch,
    write_live_meta,
)

from lux_tpu_torch.serve.live.errors import GenerationGap  # noqa: F401 — the
# protocol exception lives in the stdlib-only errors module; re-exported
# here for callers

#: standing apps the refresh dispatcher knows (arg = sssp start vertex;
#: pagerank / components take none)
STANDING_APPS = ("sssp", "pagerank", "components")


def parse_standing(spec: str) -> Tuple[Tuple[str, Optional[int]], ...]:
    """``"sssp:0,pagerank"`` -> (("sssp", 0), ("pagerank", None)) — the
    --standing CLI format."""
    out = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        app, _, arg = tok.partition(":")
        if app not in STANDING_APPS:
            raise ValueError(
                f"unknown standing app {app!r}; expected one of "
                f"{STANDING_APPS} (sssp takes ':<start>')")
        out.append((app, int(arg) if arg else None))
    return tuple(out)


class LiveReplica:
    """``g``/``shards``: the CURRENT epoch base and ITS default-layout
    pull shards (the exact bundle the serving cache holds — overlays
    address base edge slots by position, so they must be built from the
    serving layout, pinned identical to the push-embedded one by
    test_live).  ``base_generation``: the epoch base this snapshot
    represents; a journaled replica recovers it from ``live_meta.json``
    (written on first open) and replays its committed prefix."""

    def __init__(self, g: HostGraph, shards, cap: Optional[int] = None,
                 journal_dir: Optional[str] = None,
                 base_generation: int = 0,
                 standing: Tuple[Tuple[str, Optional[int]], ...] = (),
                 method: str = "auto", max_iters: int = 10_000,
                 route_family: Optional[str] = None,
                 tolerance: float = 0.0, device="cuda"):
        from lux_tpu_torch.utils.device import resolve_device

        self.shards = shards
        #: where the standing refreshes run (no fallback: ``cuda``
        #: without a card raises here, before any work)
        self.device = resolve_device(device)
        self.cap = ovl.delta_cap(cap)
        self.method = method
        self.max_iters = int(max_iters)
        # Standing-refresh gather route: the fused families tombstone
        # deleted edges in group space, so the PageRank refresh rides a
        # routed plan family.  None -> LUX_LIVE_ROUTE env, default
        # 'fused-pf' (the reference's default); '' / 'none' disables
        # routing (the direct gather).
        if route_family is None:
            route_family = os.environ.get("LUX_LIVE_ROUTE", "fused-pf")
        self.route_family = str(route_family)
        #: frontier-tolerance band for the standing PageRank refresh —
        #: 0.0 is bitwise the exact fixpoint loop; > 0 trades a declared
        #: per-entry served-error bound (surfaced on every fleet read as
        #: the tolerance tag) for fewer warm iterations.
        self.tolerance = float(tolerance)
        self._pr_route = None  # lazily-planned pagerank gather route
        self.journal_dir = journal_dir
        self.standing_spec = tuple(
            (app, None if arg is None else int(arg))
            for app, arg in standing)
        for app, _arg in self.standing_spec:
            if app not in STANDING_APPS:
                raise ValueError(f"unknown standing app {app!r}")
        self.mg = MutableGraph(g, num_parts=shards.spec.num_parts,
                               cap=self.cap)
        self.mg._pull = shards  # one layout: serving == refresh
        self.base_generation = int(base_generation)
        if journal_dir is not None:
            os.makedirs(journal_dir, mode=0o700, exist_ok=True)
            meta = read_live_meta(journal_dir)
            if meta is not None:
                self.base_generation = int(meta["base_generation"])
            # replays the committed prefix (stops at the first missing
            # .ok marker — the kill-between-receipt-and-marker window)
            self.mg.log = DeltaLog(g, journal_dir=journal_dir)
            if meta is None:
                write_live_meta(journal_dir, self.base_generation)
        self._servable = self.generation()
        #: app -> {state (nv,), stacked (pagerank), generation, iters}
        self._standing: Dict[str, dict] = {}

    # ------------------------------------------------------------------
    # generations
    # ------------------------------------------------------------------

    def generation(self) -> int:
        """Journaled generation: base + committed batches."""
        return self.base_generation + self.mg.log.batches_applied

    def servable_generation(self) -> int:
        """What the installed overlay serves (== generation() except in
        the overflow window awaiting fleet compaction)."""
        return self._servable

    # ------------------------------------------------------------------
    # the write path
    # ------------------------------------------------------------------

    def apply_batch(self, arr: np.ndarray, generation: int):
        """Apply ONE replicated batch (wire (rows, 4) array) claiming
        commit ``generation``.  Journals durably (when journaled), then
        rebuilds the serving overlay.  Returns (oarrays, degree) for the
        cache install.  Raises GenerationGap on a sequence gap (nothing
        applied) and DeltaOverflow when the batch no longer fits the
        overlay capacity (the batch IS journaled — the write is durable,
        just not servable until the fleet compacts)."""
        want = int(generation)
        have = self.generation()
        if want != have + 1:
            raise GenerationGap(have, want)
        src, dst, op, w = unpack_batch(arr)
        self.mg.log.apply(src, dst, op, w)
        oarr, deg = self.serving_overlay()  # raises DeltaOverflow
        self._servable = want
        return oarr, deg

    def serving_overlay(self):
        """(OverlayArrays, merged (P, V) degree stack) for the CURRENT
        log — what the worker installs into its WarmEngineCache."""
        _, oarr = ovl.build_pull_overlay(self.shards, self.mg.log,
                                         self.cap)
        deg = ovl.merged_degree_stacked(self.shards, self.mg.log)
        return oarr, deg

    @property
    def overlay_static(self) -> ovl.OverlayStatic:
        return ovl.OverlayStatic(cap=self.cap,
                                 weighted=self.shards.spec.weighted)

    # ------------------------------------------------------------------
    # standing states (warm refresh, between queries)
    # ------------------------------------------------------------------

    def refresh(self) -> dict:
        """Bring every standing state to the current servable
        generation: warm refresh from the prior converged state (cold
        overlay convergence the first time).  SSSP/CC land bitwise on
        the merged graph's unique fixpoint; PageRank on an exact f32
        fixpoint (<= 1 ulp across layouts, per the refresh contract)."""
        import time

        from lux_tpu_torch import obs

        gen = self.servable_generation()
        apps = {}
        t0 = time.perf_counter()
        with obs.span("live.refresh", generation=gen,
                      apps=[a for a, _ in self.standing_spec]):
            for app, arg in self.standing_spec:
                ent = self._standing.get(app)
                ts = time.perf_counter()
                if app == "sssp":
                    ent = self._refresh_sssp(ent, arg)
                elif app == "components":
                    ent = self._refresh_components(ent)
                else:
                    ent = self._refresh_pagerank(ent)
                ent["generation"] = gen
                ent["arg"] = arg
                ent["seconds"] = round(time.perf_counter() - ts, 4)
                self._standing[app] = ent
                apps[app] = {"iters": ent["iters"],
                             "seconds": ent["seconds"]}
        return {"generation": gen, "apps": apps,
                "seconds": round(time.perf_counter() - t0, 4)}

    def standing(self, app: str) -> dict:
        """The refreshed entry for ``app`` (KeyError when it was never
        refreshed or is not configured)."""
        return self._standing[app]

    def inherit_standing(self, prior: "LiveReplica") -> None:
        """Carry converged standing states across a republish — but
        ONLY entries refreshed at exactly the new epoch base: the new
        base is the merged graph at ``base_generation``, so a state
        converged there is a valid warm prior, while one converged
        EARLIER is missing batches the new base already contains — the
        fresh-epoch refresh (empty log → no dirty set) would re-tag it
        as current without recomputing, serving stale answers.  Dropped
        entries (stale, or shape-mismatched after a recut) cold-rebuild
        on the next refresh."""
        for app, ent in prior._standing.items():
            if ent.get("generation") != self.base_generation:
                continue
            stacked = ent.get("stacked")
            if stacked is not None and stacked.shape != (
                    self.shards.arrays.vtx_mask.shape):
                continue
            if ent["state"].shape != (self.mg.base.nv,):
                continue
            self._standing[app] = dict(ent)

    def _refresh_sssp(self, ent, start):
        from lux_tpu_torch.mutate import refresh as R

        if ent is None:
            from lux_tpu_torch.models.sssp import SSSPProgram

            prog = SSSPProgram(nv=self.mg.base.nv, start=int(start))
            dist0 = np.full(self.mg.base.nv, prog.inf, np.int32)
            dist0[int(start)] = 0
            frontier = np.zeros(self.mg.base.nv, bool)
            frontier[int(start)] = True
            # a cold run THROUGH the overlay loop: same compiled family
            # as every later warm refresh, exact on the merged graph
            state, it = R._run_push_overlay(
                prog, self.mg, dist0, frontier, self.method,
                self.max_iters, pad_fill=prog.inf, device=self.device)
            dist = self.mg.push_shards.scatter_to_global(
                state.cpu().numpy())
            return {"state": dist, "iters": int(it)}
        dist, it = R.refresh_sssp(self.mg, ent["state"], int(start),
                                  method=self.method,
                                  max_iters=self.max_iters,
                                  device=self.device)
        return {"state": dist, "iters": int(it)}

    def _refresh_components(self, ent):
        from lux_tpu_torch.mutate import refresh as R

        if ent is None:
            from lux_tpu_torch.models.components import MaxLabelProgram

            nv = self.mg.base.nv
            labels0 = np.arange(nv, dtype=np.int32)
            frontier = np.ones(nv, bool)
            state, it = R._run_push_overlay(
                MaxLabelProgram(), self.mg, labels0, frontier,
                self.method, self.max_iters, pad_fill=-1,
                device=self.device)
            labels = self.mg.push_shards.scatter_to_global(
                state.cpu().numpy())
            return {"state": labels, "iters": int(it)}
        labels, it = R.refresh_components(self.mg, ent["state"],
                                          method=self.method,
                                          max_iters=self.max_iters,
                                          device=self.device)
        return {"state": labels, "iters": int(it)}

    def _pagerank_route(self):
        """The (cached) base-graph gather plan the standing PageRank
        refresh rides — the base gather is unchanged by churn, so one
        plan serves every refresh of the epoch.  Family comes from the
        ``route_family`` knob (env LUX_LIVE_ROUTE, default 'fused-pf');
        every family is bitwise-equal through the overlay, so this is a
        perf decision only.  The plan goes through the plan disk cache
        (``LUX_TORCH_PLAN_CACHE``) and moves to the device once."""
        rg = self.route_family
        if rg in ("", "none"):
            return None
        if self._pr_route is None:
            from lux_tpu_torch.apps.common import route_base, route_is_pf, \
                route_mx
            from lux_tpu_torch.ops import expand

            shards = self.mg.pull_shards
            pf = route_is_pf(rg)
            if route_base(rg) == "fused":
                plan = expand.plan_fused_shards_cached(
                    shards, "sum", pf=pf, mx=route_mx(rg))
            else:
                plan = expand.plan_expand_shards_cached(shards, pf=pf)
            self._pr_route = expand.plan_to_device(plan, self.device)
        return self._pr_route

    def _refresh_pagerank(self, ent):
        from lux_tpu_torch.mutate import refresh as R

        shards = self.mg.pull_shards
        route = self._pagerank_route()
        if ent is None:
            oarr, deg = self.serving_overlay()
            _, arrays = self.mg.device_pull(self.device)
            stacked, it = R.converge_pagerank(
                shards, method=self.method, route=route,
                overlay=(self.overlay_static, oarr),
                degree_override=deg, tolerance=self.tolerance,
                device=self.device, arrays=arrays)
        else:
            stacked, it = R.refresh_pagerank(self.mg, ent["stacked"],
                                             method=self.method,
                                             route=route,
                                             tolerance=self.tolerance,
                                             device=self.device)
        stacked = stacked.cpu().numpy()
        return {"state": shards.scatter_to_global(stacked),
                "stacked": stacked, "iters": int(it),
                "tolerance": self.tolerance}

    # ------------------------------------------------------------------
    # republish plumbing
    # ------------------------------------------------------------------

    def rebind_journal(self, journal_dir: Optional[str],
                       prior: Optional["LiveReplica"] = None) -> None:
        """Post-commit: take over ``journal_dir`` for the new epoch —
        rotate the PRIOR replica's journal (its batches now live in this
        replica's base snapshot) and open a fresh one.  A staged replica
        is built journal-less during prepare (the dir still holds
        old-epoch batches against the old base) and adopts the dir only
        here.  Crash order matches compact.py: the snapshot was durable
        before commit, so a kill mid-rotation leaves either the old
        committed prefix (stale but consistent) or the fresh epoch."""
        self.journal_dir = journal_dir
        if journal_dir is None:
            return
        if prior is not None and prior.journal_dir == journal_dir \
                and prior.mg.log.journal_dir is not None:
            prior.mg.log.journal_reset()
        self.mg.log = DeltaLog(self.mg.base, journal_dir=journal_dir)
        write_live_meta(journal_dir, self.base_generation)

    def stats(self) -> dict:
        occ = ovl.occupancy(self.shards, self.mg.log, self.cap)
        return {
            "generation": self.generation(),
            "servable_generation": self.servable_generation(),
            "base_generation": self.base_generation,
            "delta_occupancy": occ,
            "standing": {app: {"generation": e.get("generation"),
                               "iters": e.get("iters"),
                               "tolerance": e.get("tolerance", 0.0)}
                         for app, e in self._standing.items()},
        }
