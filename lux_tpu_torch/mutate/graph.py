"""MutableGraph: one live graph = base snapshot + delta-log + layouts.

Counterpart of ``lux_tpu.mutate.graph``.  The bundle owns the base
HostGraph, the DeltaLog (optionally journaled), the lazily built pull and
push shard layouts of the BASE (which the overlay-aware engines keep
consuming unchanged across churn), the cached push CSR permutations (so
tombstone patching is O(deleted) per refresh, not a re-sort), and the
compaction trigger: a batch that would overflow any part's delta capacity
compacts FIRST (merging the log into a new base, reusing the old cuts so
untouched plan-cache entries survive), then applies.

Host only: the layouts are numpy; the engines move what they read to the
device once per run.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.mutate import overlay as ovl
from lux_tpu_torch.mutate.deltalog import DeltaLog, DeltaOverflow, OP_INSERT


class MutableGraph:
    """A mutating graph the engines serve from fixed-shape overlays.

    ``num_parts`` fixes the shard layout (the parts stack on one device);
    ``cap`` (default ``LUX_DELTA_CAP``) the per-part delta capacity;
    ``journal_dir`` makes mutations durable (crash replay on reopen);
    ``snapshot`` names where compaction writes merged ``.lux`` snapshots
    (in-memory compaction when None)."""

    def __init__(self, g: HostGraph, num_parts: int = 1,
                 cap: Optional[int] = None,
                 journal_dir: Optional[str] = None,
                 snapshot: Optional[str] = None):
        self.base = g
        self.num_parts = num_parts
        self.cap = ovl.delta_cap(cap)
        self.snapshot = snapshot
        self.log = DeltaLog(g, journal_dir=journal_dir)
        self.compactions = 0
        self._pull = None
        self._push = None
        self._csr = None          # base out-edge view (refresh cascades)
        self._csr_perms = None    # push CSC->CSR slot maps
        self._dev = {}            # base layouts on a device (device_pull/_push)
        self._version = 0         # bumps on every applied batch/compact

    # ------------------------------------------------------------------
    # layouts (base graph, default fill order — the overlay contract)
    # ------------------------------------------------------------------

    @property
    def pull_shards(self):
        if self._pull is None:
            from lux_tpu_torch.graph.shards import build_pull_shards

            self._pull = build_pull_shards(self.base, self.num_parts)
        return self._pull

    @property
    def push_shards(self):
        if self._push is None:
            from lux_tpu_torch.graph.push_shards import build_push_shards

            self._push = build_push_shards(self.base, self.num_parts)
            # share the pull layout (one O(E) build, one overlay target)
            self._pull = self._push.pull
        return self._push

    def base_csr(self):
        """(csr_row_ptr, csr_dst, csr_perm) of the BASE graph, cached —
        the refresh deletion cascades walk out-edges through this."""
        if self._csr is None:
            self._csr = self.base.to_csr()
        return self._csr

    def csr_perms(self):
        if self._csr_perms is None:
            self._csr_perms = ovl.push_csr_perms(self.push_shards, self.base)
        return self._csr_perms

    def _on_device(self, key, layout, build):
        hit = self._dev.get(key)
        if hit is None or hit[0] is not layout:
            hit = (layout, build())
            self._dev[key] = hit
        return hit[1]

    def device_pull(self, device="cuda"):
        """(device, the base pull layout's arrays on it), placed once and
        kept until the layout changes (a compaction): a refresh moves only
        its overlay."""
        from lux_tpu_torch.graph.shards import to_device
        from lux_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        sh = self.pull_shards
        return dev, self._on_device(("pull", str(dev)), sh,
                                    lambda: to_device(sh.arrays, dev))

    def device_push(self, device="cuda"):
        """(device, pull arrays, base push arrays) of the push layout on
        the device, placed once like device_pull."""
        from lux_tpu_torch.engine import push

        pshards = self.push_shards
        dev, arrays = self.device_pull(device)
        parrays = self._on_device(("push", str(dev)), pshards,
                                  lambda: push.place(pshards, dev)[1])
        return dev, arrays, parrays

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------

    def apply(self, src, dst, op, weight=None) -> dict:
        """Apply one mutation batch; when it would overflow any part's
        delta capacity, compact FIRST (fold the standing log into the
        base — the prior converged app states equal that merged graph, so
        a warm refresh stays sound) and THEN apply, keeping the new batch
        in the log.  A batch that ALONE exceeds the capacity raises
        DeltaOverflow (folding it too would silently invalidate every
        caller-held prior state).  Returns the log stats, with
        ``compacted`` set when a compaction ran.  (The reference's
        ``mutate.apply`` span is not ported: lux_tpu.obs has no
        counterpart here yet.)"""
        compacted = False
        if not self.log.empty and self._would_overflow(dst, op):
            self.compact()
            compacted = True
        self.log.apply(src, dst, op, weight)
        self._version += 1
        if self._overflowed():
            raise DeltaOverflow(
                "one batch exceeds the per-part delta capacity "
                f"{self.cap} (LUX_DELTA_CAP) on its own — split the "
                "batch, raise the capacity, or compact() and "
                "cold-recompute the app states")
        return {**self.log.stats(), "compacted": compacted}

    def _would_overflow(self, dst, op) -> bool:
        """Conservative pre-check: standing per-part occupancy plus the
        batch's inserts (in-batch insert/delete pairs are not netted —
        compacting a little early is harmless, late is a hard error)."""
        from lux_tpu_torch.graph.partition import part_of_vertex

        occ = np.asarray(ovl.occupancy(self.pull_shards, self.log,
                                       self.cap)["per_part"], np.int64)
        dstb = np.atleast_1d(np.asarray(dst, np.int64))
        opb = np.atleast_1d(np.asarray(op, np.int64))
        ins = dstb[opb == OP_INSERT]
        if len(ins):
            occ = occ + np.bincount(
                part_of_vertex(np.asarray(self.pull_shards.cuts), ins),
                minlength=len(occ))
        return bool(occ.max() > self.cap)

    def _overflowed(self) -> bool:
        return ovl.occupancy(self.pull_shards, self.log, self.cap)["max"] > self.cap

    # ------------------------------------------------------------------
    # overlays
    # ------------------------------------------------------------------

    def pull_overlay(self):
        """(OverlayStatic, OverlayArrays) for the pull engine."""
        return ovl.build_pull_overlay(self.pull_shards, self.log, self.cap)

    def push_overlay(self):
        """(OverlayStatic, OverlayArrays, patched PushArrays)."""
        return ovl.build_push_overlay(self.push_shards, self.log, self.cap,
                                      csr_perms=self.csr_perms())

    def push_overlay_parts(self):
        """(OverlayStatic, OverlayArrays, (part, CSR slot) tombstones): the
        push overlay with the CSR patch as slots, for a device copy."""
        pshards = self.push_shards
        static, oarr = ovl.build_pull_overlay(pshards.pull, self.log, self.cap)
        return static, oarr, ovl.push_tombstones(pshards, self.log, self.csr_perms())

    def occupancy(self) -> dict:
        return ovl.occupancy(self.pull_shards, self.log, self.cap)

    # ------------------------------------------------------------------
    # compaction
    # ------------------------------------------------------------------

    def compact(self, path: Optional[str] = None, reuse_cuts: bool = True) -> dict:
        """Merge the delta-log into a new base (mutate.compact has the
        snapshot / journal / invalidation protocol); rebuilt layouts keep
        the old cuts by default, so only the plan-cache entries whose
        index arrays changed are invalidated."""
        from lux_tpu_torch.mutate import compact as compact_mod

        report = compact_mod.compact_mutable(
            self, path=path if path is not None else self.snapshot,
            reuse_cuts=reuse_cuts)
        self.compactions += 1
        self._version += 1
        return report

    @property
    def version(self) -> int:
        return self._version
