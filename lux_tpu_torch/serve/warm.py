"""Warm engine cache: batched engines keyed on (app, method, part layout,
Q bucket).

Counterpart of ``lux_tpu.serve.warm``.  On the card nothing is traced or
compiled, but the first batch of each (app, Q) shape pays the first
launches: kernel module loads and the caching allocator's growth to that
shape's (E, Q) temporaries.  A service pays that once per shape, at
start: the cache runs one dummy batch per common Q bucket (default
1/8/64) for each served app, resolves ``--method auto`` per
engine/methods, and counts warm hits against cold builds so the serving
metrics can report the ratio.

The layout half of the key exists because an engine binds the shard
GEOMETRY (part count, padded sizes): engines of a superseded layout are
dropped when a new shards bundle is installed.  Every engine of one
layout shares ONE device copy of the shard arrays.

A cache built with ``overlay_static`` serves a mutating graph: every
engine is the overlay twin, and ``set_overlay`` installs the current
overlay (moved to the device once) as one atomic store that dispatchers
read with ``current_overlay``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional, Tuple

import torch

from lux_tpu_torch.graph.shards import PullShards, to_device
from lux_tpu_torch.mutate import overlay as ovl
from lux_tpu_torch.serve.batched import BatchedEngine, resolve_method
from lux_tpu_torch.utils.config import env_int
from lux_tpu_torch.utils.device import resolve_device

#: Q buckets warmed at service start: 1 is the latency floor and the cold
#: degradation path, 64 the throughput bucket, 8 the middle.
DEFAULT_Q_BUCKETS = (1, 8, 64)

#: LRU bound on live engines (env LUX_SERVE_ENGINE_CAP): ad-hoc Q shapes
#: and multi-app serving must not accumulate engines without bound.
DEFAULT_MAX_ENGINES = 32


def layout_key(shards: PullShards) -> tuple:
    """Hashable shard-geometry key: everything an engine binds."""
    s = shards.spec
    return (s.num_parts, s.nv, s.ne, s.nv_pad, s.e_pad, s.weighted)


@dataclasses.dataclass(frozen=True)
class EngineKey:
    app: str
    method: str
    layout: tuple
    q: int


class WarmEngineCache:
    """Engine cache + pre-warmer.  ``get`` returns (engine, was_warm); a
    miss builds AND warms the engine inline (the cold path the
    scheduler's degradation policy keeps at Q=1)."""

    def __init__(self, shards: PullShards, apps=("sssp",),
                 q_buckets=DEFAULT_Q_BUCKETS, method: str = "auto",
                 num_iters: int = 10, max_iters: int = 10_000,
                 metrics=None, max_engines: Optional[int] = None,
                 overlay_static=None, device="cuda"):
        self.shards = shards
        self.device = resolve_device(device)
        #: mutate.overlay.OverlayStatic -> every engine of this cache is the
        #: overlay twin; the current overlay lives in ``_overlay`` as one
        #: immutable (generation, device overlays, device degree) tuple
        self.overlay_static = overlay_static
        self._overlay = None
        self.apps = tuple(apps)
        self.q_buckets = tuple(sorted(set(int(q) for q in q_buckets)))
        if self.q_buckets and self.q_buckets[0] < 1:
            raise ValueError(f"q buckets must be >= 1: {self.q_buckets}")
        self.num_iters = num_iters
        self.max_iters = max_iters
        #: optional ServeMetrics sink (evictions feed its counters)
        self.metrics = metrics
        if max_engines is None:
            max_engines = env_int("LUX_SERVE_ENGINE_CAP", DEFAULT_MAX_ENGINES,
                                  minimum=1)
        if max_engines < 1:
            raise ValueError(f"max_engines must be >= 1: {max_engines}")
        self.max_engines = int(max_engines)
        self._layout = layout_key(shards)
        # one resolution per app (the reduce differs), shared by every bucket
        self._method = {app: resolve_method(method, app, shards.spec.nv, self.device)
                        for app in self.apps}
        # recency-ordered: the LRU eviction order
        self._engines: "collections.OrderedDict[EngineKey, BatchedEngine]" = \
            collections.OrderedDict()
        self.evictions = 0
        # ONE device placement of the graph arrays, shared by every engine
        # of this layout
        self._device_arrays = None
        self._lock = threading.Lock()
        self.warm_hits = 0
        self.cold_traces = 0
        self.warm_seconds = 0.0

    def key(self, app: str, q: int) -> EngineKey:
        return EngineKey(app=app, method=self._method[app], layout=self._layout,
                         q=int(q))

    # -- live overlay -----------------------------------------------------

    def set_overlay(self, generation: int, oarrays, degree=None) -> None:
        """Install the CURRENT mutation overlay: one atomic store of an
        immutable (generation, per-part device overlays, device degree)
        tuple.  A dispatcher that read the tuple before a newer install
        tags its answers with the older generation — a lower bound on
        what the batch served."""
        if self.overlay_static is None:
            raise ValueError(
                "cache was built without overlay_static; a live server "
                "must construct its WarmEngineCache with the overlay "
                "descriptor so every engine is the overlay twin")
        dev_o = ovl.device_overlay(oarrays, self.device, self.shards.spec.nv_pad)
        dev_d = None if degree is None else torch.as_tensor(degree).to(self.device)
        self._overlay = (int(generation), dev_o, dev_d)

    def current_overlay(self):
        """(generation, device overlays, degree) or None (a cache without
        overlays).  A live cache before any set_overlay serves the empty
        overlay at generation 0."""
        if self.overlay_static is None:
            return None
        ov = self._overlay
        if ov is None:
            self.set_overlay(0, ovl.empty_overlay_arrays(self.shards,
                                                         self.overlay_static.cap))
            ov = self._overlay
        return ov

    def _warm_oarrays(self):
        ov = self.current_overlay()
        return None if ov is None else ov[1]

    def prewarm(self, apps=None, q_buckets=None) -> float:
        """Build and warm one engine per (app, bucket); returns the wall
        seconds spent (the service-start cost, reported apart from
        request latency)."""
        t0 = time.perf_counter()
        for app in apps if apps is not None else self.apps:
            for q in q_buckets if q_buckets is not None else self.q_buckets:
                self._build(app, int(q)).warm(self._warm_oarrays())
        spent = time.perf_counter() - t0
        with self._lock:
            self.warm_seconds += spent
        return spent

    def warm_buckets(self, app: str) -> tuple:
        """Ascending Q buckets with a WARMED engine for ``app``."""
        with self._lock:
            return tuple(sorted(
                k.q for k, e in self._engines.items()
                if k.app == app and k.layout == self._layout and e._warmed))

    def is_warm(self, app: str, q: int) -> bool:
        with self._lock:
            e = self._engines.get(self.key(app, q))
        return e is not None and e._warmed

    def _build(self, app: str, q: int) -> BatchedEngine:
        k = self.key(app, q)
        with self._lock:
            eng = self._engines.get(k)
            if eng is None:
                if self._device_arrays is None:
                    self._device_arrays = to_device(self.shards.arrays, self.device)
                eng = BatchedEngine(
                    self.shards, app, q, method=k.method,
                    num_iters=self.num_iters, max_iters=self.max_iters,
                    device_arrays=self._device_arrays,
                    overlay_static=self.overlay_static)
                self._engines[k] = eng
                self._evict_locked()
            else:
                self._engines.move_to_end(k)  # refresh LRU recency
        return eng

    def _evict_locked(self) -> None:
        """Drop least-recently-used engines past ``max_engines`` (the
        caller holds the lock).  An in-flight batch keeps its engine
        through its own reference; the next request for that shape is a
        cold build (counted, like every cold build)."""
        while len(self._engines) > self.max_engines:
            self._engines.popitem(last=False)
            self.evictions += 1
            if self.metrics is not None:
                self.metrics.record_eviction()

    def get(self, app: str, q: int) -> Tuple[BatchedEngine, bool]:
        """(engine, was_warm).  A cold get warms the engine inline.  The
        counters are updated under the cache lock (concurrent pumps must
        not lose hits); the warm runs outside it, serialized by the
        engine's own lock."""
        eng = self._build(app, q)
        with self._lock:
            was_warm = eng._warmed
            if was_warm:
                self.warm_hits += 1
            else:
                self.cold_traces += 1
        if was_warm:
            return eng, True
        t0 = time.perf_counter()
        eng.warm(self._warm_oarrays())
        with self._lock:
            self.warm_seconds += time.perf_counter() - t0
        return eng, False

    def install_shards(self, shards: PullShards) -> None:
        """Swap in a rebuilt graph layout; engines of the old geometry are
        dropped and the arrays are placed again at the next build."""
        with self._lock:
            self.shards = shards
            self._layout = layout_key(shards)
            self._device_arrays = None
            self._overlay = None  # stale occupancy, stale shapes
            self._engines = collections.OrderedDict(
                (k, e) for k, e in self._engines.items() if k.layout == self._layout)

    def stats(self) -> dict:
        with self._lock:
            warmed = sum(1 for e in self._engines.values() if e._warmed)
            total = len(self._engines)
            hits, cold = self.warm_hits, self.cold_traces
            evicted = self.evictions
        return {
            "engines": total,
            "engines_warm": warmed,
            "max_engines": self.max_engines,
            # resident engines / LRU cap (an always-1.0 cache is thrashing
            # its LRU; see evictions)
            "occupancy": round(total / max(self.max_engines, 1), 4),
            "evictions": evicted,
            "warm_hits": hits,
            "cold_traces": cold,
            "warm_hit_ratio": round(hits / max(hits + cold, 1), 4),
            "warm_seconds": round(self.warm_seconds, 3),
        }
