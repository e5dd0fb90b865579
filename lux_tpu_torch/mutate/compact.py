"""Compaction: merge the delta-log into a new `.lux` base snapshot.

Counterpart of ``lux_tpu.mutate.compact``.  Protocol (crash-safe, each
step durable before the next):

  1. materialize the merged graph (deltalog.merged_graph — the one
     deterministic definition the parity tests pin);
  2. write it as a `.lux` snapshot through a tmp + fsync + rename (a
     crash mid-write leaves the old snapshot intact);
  3. rotate the journal (deltalog.journal_reset — the batches now live in
     the snapshot; a crash between 2 and 3 replays them against the OLD
     base: stale but consistent, never half-applied);
  4. rebuild the shard layouts REUSING the old vertex cuts, so the
     per-part plan cache (ops/expand, one npz entry per part keyed on
     that part's own index arrays) invalidates ONLY the parts whose
     arrays changed — ``invalidation_report`` computes which, from the
     cache's own key functions;
  5. swap the base last, so a failed build leaves the graph consistent.

``publish_to_fleet`` ships a compacted snapshot to a serving fleet
(``serve/fleet``) through the controller's two-phase republish, inside a
``mutate.publish`` recorder span.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from lux_tpu_torch.graph.format import write_lux


def snapshot_write(path: str, g) -> None:
    """Durable `.lux` write: tmp + fsync + atomic rename (write_lux
    itself streams straight to its target, which a crash would tear)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    write_lux(tmp, g)
    with open(tmp, "rb+") as f:
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def plan_bucket_paths(shards, cache_dir: Optional[str] = None):
    """The expand plan family's per-part cache PATHS for a shard bundle,
    derived by the cache's own key functions (ops/expand._expand_key_one
    and _entry_path), so this report cannot drift from what the cache
    keys on.  None when the cache directory is untrusted (the cache
    itself degrades the same way)."""
    from lux_tpu_torch.ops import expand

    cache_dir = cache_dir or expand._default_cache_dir()
    if not expand._cache_dir_trusted(cache_dir):
        return None
    key_one = expand._expand_key_one(shards)
    return [expand._entry_path(cache_dir, "expand", key_one, i)
            for i in range(shards.arrays.src_pos.shape[0])]


def invalidation_report(old_shards, new_shards, cache_dir: Optional[str] = None) -> dict:
    """Which plan-cache parts a compaction invalidates: a part survives
    iff its content-derived cache path is UNCHANGED.  Returns {parts,
    changed, fraction, changed_parts}."""
    P = old_shards.arrays.src_pos.shape[0]
    old_p = plan_bucket_paths(old_shards, cache_dir)
    new_p = plan_bucket_paths(new_shards, cache_dir)
    total = new_shards.arrays.src_pos.shape[0]
    if old_p is None or new_p is None or total != P:
        # untrusted cache directory or another part count: all rebuild
        changed = list(range(total))
    else:
        changed = [i for i in range(P) if old_p[i] != new_p[i]]
    return {
        "parts": total,
        "changed": len(changed),
        "fraction": round(len(changed) / total, 4) if total else 0.0,
        "changed_parts": changed,
    }


def compact_mutable(mg, path: Optional[str] = None, reuse_cuts: bool = True) -> dict:
    """Compact a MutableGraph in place (the steps of the module
    docstring).  Returns a report: the snapshot path (or None), the
    merged sizes, and the plan-cache invalidation of the pull layout."""
    from lux_tpu_torch import obs
    from lux_tpu_torch.graph.push_shards import build_push_shards
    from lux_tpu_torch.graph.shards import build_pull_shards

    with obs.span("mutate.compact", inserts=int(mg.log.ins_live.sum()),
                  deletes=int(mg.log.del_base.sum())) as sp:
        if mg.log.journal_dir is not None and path is None:
            raise ValueError(
                "a journaled MutableGraph needs a snapshot path to "
                "compact: rotating the journal without persisting the "
                "merged base would drop durable mutations (set "
                "MutableGraph(snapshot=...) or pass compact(path=...))")
        merged = mg.log.merged_graph()
        if path is not None:
            snapshot_write(path, merged)
        mg.log.journal_reset()

        old_pull = mg._pull
        cuts = np.asarray(old_pull.cuts) if (reuse_cuts and old_pull is not None) else None
        report = {"path": path, "nv": int(merged.nv), "ne": int(merged.ne)}
        new_pull = new_push = None
        if mg._push is not None:
            new_push = build_push_shards(merged, mg.num_parts, cuts=cuts)
            new_pull = new_push.pull
        elif old_pull is not None:
            new_pull = build_pull_shards(merged, mg.num_parts, cuts=cuts)
        if old_pull is not None and new_pull is not None:
            report["invalidation"] = invalidation_report(old_pull, new_pull)
        # swap the base LAST so a build failure leaves mg consistent
        mg.base = merged
        mg.log = type(mg.log)(merged, journal_dir=mg.log.journal_dir)
        mg._pull = new_pull
        mg._push = new_push
        mg._csr = None
        mg._csr_perms = None
        mg._dev = {}
        sp.set(nv=report["nv"], ne=report["ne"])
    return report


def publish_to_fleet(controller, path: str, graph_id: Optional[str] = None) -> dict:
    """Publish a compacted snapshot to a live fleet through the
    controller's token-guarded two-phase republish (serve/fleet: every
    worker prepares a second engine cache while the old graph serves,
    then an atomic commit — zero shed, answers equal to a fresh engine on
    the snapshot; a failed prepare anywhere aborts with the old graph
    still serving).  One ``mutate.publish`` recorder span."""
    from lux_tpu_torch import obs

    gid = graph_id if graph_id is not None else os.path.basename(path)
    with obs.span("mutate.publish", graph=gid):
        return controller.republish(path, graph_id=gid)
