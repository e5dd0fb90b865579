"""Consistent-hash routing for the serving fleet (stdlib only).

Counterpart of ``lux_tpu.serve.fleet.hashring`` (a copy: the port
imports nothing of the reference).  ``h64``/``route_key`` and the ring
route every key exactly as the reference does.

The controller routes ``(app, graph_id, Q-slot)`` keys over the live
replica workers.  Requirements, in priority order:

* **Deterministic across processes** — the controller may restart, and a
  post-mortem must be able to replay routing from the event log.  Python's
  builtin ``hash`` is salted per process (PYTHONHASHSEED), so every hash
  here is a blake2b digest; ``tests/test_torch_fleet.py`` pins agreement
  with the reference's table and across processes.
* **Bounded key movement** — adding a worker to a ring of R moves ~1/(R+1)
  of the keys (all of them TO the new worker); removing one moves exactly
  the keys it owned (all of them to ring successors).  That is the classic
  consistent-hashing contract (Karger et al.), and it is what makes a
  worker join/leave a local event instead of a fleet-wide cache flush:
  every moved key lands on a replica whose warm engines are already
  traced for the same graph, so the only cost is Q-batch refill.
* **Balance** — each worker is hashed onto the ring at ``vnodes`` points
  (virtual nodes), so R real workers present R*vnodes points and the
  per-worker load concentrates around 1/R.

Keys are **Q-slots**, not raw queries: ``route_key`` folds the query id
into one of ``slots`` buckets per (app, graph).  A bounded, enumerable
key set lets the controller precompute the slot->worker table once per
membership change (routing a request is then a single dict lookup) and
lets the movement property be asserted exactly over the whole key space.
Queries that hash to the same slot always land on the same replica, so
repeated/popular queries hit the same warm engines and coalesce into the
same Q-bucket batches.

This module must stay importable WITHOUT the lux_tpu_torch package
(stdlib only): the determinism test loads it standalone in a subprocess.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Sequence, Tuple

#: ring points per worker; 64 keeps the max/mean per-worker key load
#: within ~1.5x for small fleets (pinned loosely by tests/test_torch_fleet.py)
DEFAULT_VNODES = 64

#: Q-slots per (app, graph): the routable key space.  512 slots over a
#: handful of replicas keeps per-slot granularity fine enough that the
#: ~1/R movement bound is visible, while the precomputed table stays tiny.
DEFAULT_SLOTS = 512


def h64(s: str) -> int:
    """64-bit deterministic hash (blake2b; never the salted builtin)."""
    return int.from_bytes(
        hashlib.blake2b(s.encode("utf-8"), digest_size=8).digest(), "big")


def route_key(app: str, graph_id: str, query: int,
              slots: int = DEFAULT_SLOTS) -> str:
    """The routable key of one query: its (app, graph, Q-slot) tuple.
    The query id is hashed into a slot (not used raw) so the key space
    is bounded and popular query ids spread over slots uniformly."""
    return f"{app}|{graph_id}|q{h64(str(int(query))) % slots}"


class EmptyRingError(RuntimeError):
    """route() on a ring with no workers."""


class HashRing:
    """Sorted-ring consistent hashing with virtual nodes.

    Not thread-safe by itself: the controller mutates it only under its
    own registry lock (membership changes are rare; routing reads go
    through the precomputed slot table, not this object).
    """

    def __init__(self, vnodes: int = DEFAULT_VNODES):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._hashes: List[int] = []  # sorted ring point hashes
        self._owners: List[str] = []  # worker id at each ring point
        self._members: Dict[str, Tuple[int, ...]] = {}

    def __len__(self) -> int:
        return len(self._members)

    def workers(self) -> Tuple[str, ...]:
        return tuple(sorted(self._members))

    def add(self, worker_id: str) -> None:
        if worker_id in self._members:
            raise ValueError(f"worker {worker_id!r} already on the ring")
        points = tuple(h64(f"{worker_id}#{i}") for i in range(self.vnodes))
        for p in points:
            at = bisect.bisect_left(self._hashes, p)
            # digest collisions across distinct ids are ~impossible at
            # 64 bits and fleet scale; deterministic tiebreak anyway
            while at < len(self._hashes) and self._hashes[at] == p \
                    and self._owners[at] < worker_id:
                at += 1
            self._hashes.insert(at, p)
            self._owners.insert(at, worker_id)
        self._members[worker_id] = points

    def remove(self, worker_id: str) -> None:
        if worker_id not in self._members:
            raise ValueError(f"worker {worker_id!r} not on the ring")
        del self._members[worker_id]
        keep = [(h, w) for h, w in zip(self._hashes, self._owners)
                if w != worker_id]
        self._hashes = [h for h, _ in keep]
        self._owners = [w for _, w in keep]

    def route(self, key: str) -> str:
        """The worker owning ``key``: first ring point clockwise."""
        if not self._hashes:
            raise EmptyRingError("no workers on the ring")
        at = bisect.bisect_right(self._hashes, h64(key))
        if at == len(self._hashes):
            at = 0  # wrap past the top of the ring
        return self._owners[at]

    def successors(self, key: str, n: int) -> List[str]:
        """Up to ``n`` DISTINCT workers in ring order from ``key`` — the
        failover walk order: index 0 is the owner, the rest are where the
        key's load sheds to when earlier candidates are saturated/dead."""
        if not self._hashes:
            raise EmptyRingError("no workers on the ring")
        out: List[str] = []
        start = bisect.bisect_right(self._hashes, h64(key))
        for i in range(len(self._hashes)):
            w = self._owners[(start + i) % len(self._hashes)]
            if w not in out:
                out.append(w)
                if len(out) >= n:
                    break
        return out

    def table(self, keys: Sequence[str]) -> Dict[str, str]:
        """key -> owner for a whole key set (the controller's per-slot
        routing table, rebuilt on membership change)."""
        return {k: self.route(k) for k in keys}

    def rebalance_preview(self, keys: Sequence[str],
                          add: Sequence[str] = (),
                          remove: Sequence[str] = ()) -> dict:
        """DRY-RUN a membership change: the exact key
        movement ``add``/``remove`` would cause over ``keys``, with
        nothing mutated.  This is the autoscaler's cost gate — a scale
        decision can see, before acting, that a join moves ~1/(R+1) of
        the keys (all TO the joiner) while a retire moves exactly the
        leaver's share, and refuse actions whose warm-cache flush would
        cost more than the load problem they solve.

        Returns ``{total, moved, moved_frac, gained, lost, add,
        remove}`` where ``gained``/``lost`` count moved keys per
        receiving/yielding worker.  The preview is computed on throwaway
        ring clones built from the same deterministic vnode hashes, so
        it matches a real ``add()``/``remove()`` table diff EXACTLY
        (property-pinned against the join/leave movement tests)."""
        add = [str(w) for w in add]
        remove = [str(w) for w in remove]
        overlap = sorted(set(add) & set(remove))
        if overlap:
            raise ValueError(f"workers both added and removed: {overlap}")
        for w in add:
            if w in self._members:
                raise ValueError(f"worker {w!r} already on the ring")
        for w in remove:
            if w not in self._members:
                raise ValueError(f"worker {w!r} not on the ring")

        def _owners(members) -> Dict[str, str]:
            if not members:
                return {k: "" for k in keys}
            ring = HashRing(self.vnodes)
            for w in sorted(members):
                ring.add(w)
            return ring.table(keys)

        before = _owners(list(self._members))
        after = _owners([w for w in self._members if w not in remove]
                        + add)
        gained: Dict[str, int] = {}
        lost: Dict[str, int] = {}
        moved = 0
        for k in keys:
            b, a = before[k], after[k]
            if b == a:
                continue
            moved += 1
            if a:
                gained[a] = gained.get(a, 0) + 1
            if b:
                lost[b] = lost.get(b, 0) + 1
        total = len(keys)
        return {"total": total, "moved": moved,
                "moved_frac": (moved / total) if total else 0.0,
                "gained": dict(sorted(gained.items())),
                "lost": dict(sorted(lost.items())),
                "add": sorted(add), "remove": sorted(remove)}
