"""Edge delta-log: batched insert/delete against a frozen `.lux` base.

Counterpart of ``lux_tpu.mutate.deltalog`` (a copy: the port imports
nothing of the reference).  Mutations arrive as batches of ``(src, dst,
op[, weight])`` rows and are resolved eagerly against the base CSC: a
delete tombstones one matching live edge (the newest insert first, else
the newest base edge), an insert appends to the in-memory insert arrays.
The resolved state is a boolean tombstone mask over the base edge slots
and an append-ordered live insert list; ``overlay.py`` turns those into
the fixed-shape per-part device buffers the engines consume.

The optional on-disk JOURNAL is the reference's format byte for byte
(``meta.json`` + ``batch_%08d.npz`` + ``batch_%08d.ok`` markers), so a
journal written by either package replays in the other.  Each batch is
one npz (tmp + fsync + rename) followed by a separate fsync'd marker;
replay consumes committed batches in sequence and stops at the first
missing marker, so a kill between the append and the marker loses
exactly that uncommitted batch.

The MERGED graph is defined deterministically: base edges in base CSC
order minus tombstones, then live inserts in append order, through
``graph.csc.from_edge_list`` (its stable dst-sort keeps that relative
order per destination).  Compaction (``compact.py``) materializes
exactly this definition.

The journal fires the reference's two fault-injection sites
(lux_tpu_torch.fault): ``journal.write``, where a ``torn`` rule lands
half a file's bytes at its final path and raises ``InjectedKill``, and
``journal.before_marker``, between a durable batch and its marker.  The
drills ``torn_journal_write`` and ``kill_before_marker`` replay to the
same committed batches as the reference's under the same plan.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from lux_tpu_torch.graph.csc import HostGraph, from_edge_list

#: journal layout version — bump on any change to the meta/batch format
JOURNAL_FORMAT = 1

OP_DELETE = 0
OP_INSERT = 1


def _fsync_write(path: str, data: bytes) -> None:
    """Write bytes durably: tmp file + flush + fsync + atomic rename +
    DIRECTORY fsync — without the last, the rename's directory entry
    can flush after a later file's, and the batch-before-marker
    ordering the crash-replay protocol depends on would not be
    durable.

    Fault site ``journal.write`` (lux_tpu_torch.fault): a ``torn`` rule
    lands HALF the bytes at the final path with no rename and no fsync —
    the on-disk shape of a non-atomic writer caught by a crash — then
    raises InjectedKill; the replay protocol must discard exactly that
    file (no marker ever follows it)."""
    from lux_tpu_torch import fault

    rule = fault.ppoint("journal.write", file=os.path.basename(path))
    if rule is not None and rule.action == "torn":
        with open(path, "wb") as f:
            f.write(data[:max(len(data) // 2, 1)])
        raise fault.InjectedKill(f"injected torn write at {path}")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _base_sha(g: HostGraph) -> str:
    """Content fingerprint of a base graph (row_ptr + col_idx + weights
    bytes).  The journal meta carries it so a journal can never be
    replayed against the WRONG base — nv/ne alone cannot tell two
    epochs apart when churn conserves the edge count (exactly the
    bench's balanced-churn pattern)."""
    import hashlib

    h = hashlib.sha1()
    h.update(np.ascontiguousarray(g.row_ptr).tobytes())
    h.update(np.ascontiguousarray(g.col_idx).tobytes())
    if g.weights is not None:
        h.update(np.ascontiguousarray(g.weights).tobytes())
    return h.hexdigest()[:16]


class DeltaOverflow(RuntimeError):
    """A part's live-insert count exceeded the overlay capacity — the
    caller must compact (MutableGraph does so automatically)."""


class DeltaLog:
    """Resolved edge mutations against one base HostGraph.

    The log owns NO device state: it is the host-side source of truth
    the overlay construction (``overlay.py``) and the compactor
    (``compact.py``) read.  ``journal_dir=None`` keeps the log purely
    in-memory (tests, ephemeral churn); a directory makes every applied
    batch durable before ``apply`` returns.
    """

    def __init__(self, base: HostGraph,
                 journal_dir: Optional[str] = None,
                 replay: bool = True):
        self.base = base
        self._dst_of_edge = base.dst_of_edges() if base.ne else \
            np.zeros(0, np.int32)
        self.del_base = np.zeros(base.ne, bool)
        self.ins_src = np.zeros(0, np.int64)
        self.ins_dst = np.zeros(0, np.int64)
        self.ins_w = np.zeros(0, np.int64)
        self.ins_live = np.zeros(0, bool)
        self.batches_applied = 0
        self.journal_dir = journal_dir
        if journal_dir is not None:
            self._journal_open(replay=replay)

    # ------------------------------------------------------------------
    # mutation API
    # ------------------------------------------------------------------

    def apply(self, src, dst, op, weight=None,
              journal_extra: Optional[dict] = None) -> None:
        """Apply ONE batch of edge mutations (arrays of equal length;
        ``op`` rows are OP_INSERT/OP_DELETE).  Rows resolve in order —
        a batch may insert an edge and delete it again.  Deleting an
        edge that does not exist (in base or live inserts) raises
        KeyError: silent no-op deletes would let the log and the true
        graph drift apart.

        ``journal_extra``: extra named uint8/int arrays journaled WITH
        the batch npz and ignored by replay (the live sequencer rides
        its idempotent write-ids here) — same format version, older
        readers skip unknown keys.

        Atomicity: the WHOLE batch resolves against the in-memory
        state first (an invalid row restores the pre-batch state and
        raises — memory never holds half a batch), and only a batch
        that resolved is journaled (durably, marker last) — the
        journal can never commit a batch that cannot replay.  A crash
        after the resolve but before the marker loses exactly this
        batch; ``apply`` had not returned, so nothing was promised."""
        src = np.atleast_1d(np.asarray(src, np.int64))
        dst = np.atleast_1d(np.asarray(dst, np.int64))
        op = np.atleast_1d(np.asarray(op, np.int8))
        w = (np.zeros(len(src), np.int64) if weight is None
             else np.atleast_1d(np.asarray(weight, np.int64)))
        if not (len(src) == len(dst) == len(op) == len(w)):
            raise ValueError("batch arrays must share one length")
        if len(src) and (src.min() < 0 or src.max() >= self.base.nv
                         or dst.min() < 0 or dst.max() >= self.base.nv):
            raise ValueError("edge endpoints out of [0, nv) — the delta"
                             " log mutates edges, never the vertex set")
        bad = set(journal_extra or ()) & {"src", "dst", "op", "w"}
        if bad:
            # validated BEFORE the batch touches memory: a savez kwarg
            # collision would raise after _apply_resolved committed —
            # memory one batch ahead of the journal, the drift the
            # atomicity contract forbids
            raise ValueError(
                f"journal_extra keys {sorted(bad)} collide with the "
                "reserved batch fields ('src', 'dst', 'op', 'w')")
        # snapshot the resolution state: growth rebinds the ins_*
        # arrays (never mutates them), so references suffice there;
        # del_base / ins_live ARE mutated in place and copy
        snap = (self.del_base.copy(), self.ins_src, self.ins_dst,
                self.ins_w, self.ins_live.copy(), self.batches_applied)
        try:
            self._apply_resolved(src, dst, op, w)
        except BaseException:
            (self.del_base, self.ins_src, self.ins_dst, self.ins_w,
             self.ins_live, self.batches_applied) = snap
            raise
        if self.journal_dir is not None:
            from lux_tpu_torch import fault

            seq = self._journal_write_batch(src, dst, op, w,
                                            self.batches_applied - 1,
                                            extra=journal_extra)
            # THE crash window the replay protocol is built around:
            # batch npz durable, marker not yet — the kill_before_marker
            # drill injects the kill exactly here
            fault.ppoint("journal.before_marker", seq=seq)
            self._journal_mark(seq)

    def _apply_resolved(self, src, dst, op, w) -> None:
        """Resolve one batch in row order, growing the insert arrays
        ONCE at the end (np.append per row is O(rows^2) in copies —
        a 1% churn batch at scale 20 is ~8e4 rows)."""
        add_s: list = []
        add_d: list = []
        add_w: list = []
        add_live: list = []
        for i in range(len(src)):
            o, u, v = int(op[i]), int(src[i]), int(dst[i])
            if o == OP_INSERT:
                add_s.append(u)
                add_d.append(v)
                add_w.append(int(w[i]))
                add_live.append(True)
            elif o == OP_DELETE:
                # newest matching live insert from THIS batch first ...
                for j in range(len(add_s) - 1, -1, -1):
                    if add_live[j] and add_s[j] == u and add_d[j] == v:
                        add_live[j] = False
                        break
                else:
                    # ... then the committed inserts / base edges
                    self._delete_one(u, v)
            else:
                raise ValueError(f"unknown op {o} at row {i}")
        if add_s:
            self.ins_src = np.concatenate(
                [self.ins_src, np.asarray(add_s, np.int64)])
            self.ins_dst = np.concatenate(
                [self.ins_dst, np.asarray(add_d, np.int64)])
            self.ins_w = np.concatenate(
                [self.ins_w, np.asarray(add_w, np.int64)])
            self.ins_live = np.concatenate(
                [self.ins_live, np.asarray(add_live, bool)])
        self.batches_applied += 1

    def _delete_one(self, u: int, v: int) -> None:
        # newest matching live insert first …
        hits = np.flatnonzero(self.ins_live & (self.ins_src == u)
                              & (self.ins_dst == v))
        if len(hits):
            self.ins_live[hits[-1]] = False
            return
        # … else the newest matching live base edge in v's CSC segment
        lo, hi = int(self.base.row_ptr[v]), int(self.base.row_ptr[v + 1])
        seg = np.flatnonzero(
            (np.asarray(self.base.col_idx[lo:hi]) == u)
            & ~self.del_base[lo:hi])
        if not len(seg):
            raise KeyError(f"delete({u}, {v}): no live edge matches")
        self.del_base[lo + seg[-1]] = True

    # ------------------------------------------------------------------
    # resolved views
    # ------------------------------------------------------------------

    def live_inserts(self):
        """(src, dst, w) int64 arrays of live inserts, append order."""
        m = self.ins_live
        return self.ins_src[m], self.ins_dst[m], self.ins_w[m]

    def deleted_edges(self) -> np.ndarray:
        """Sorted base CSC edge indices currently tombstoned."""
        return np.flatnonzero(self.del_base)

    @property
    def empty(self) -> bool:
        return not (self.del_base.any() or self.ins_live.any())

    def stats(self) -> dict:
        return {
            "inserts_live": int(self.ins_live.sum()),
            "inserts_total": int(len(self.ins_live)),
            "deletes_base": int(self.del_base.sum()),
            "batches": self.batches_applied,
        }

    def merged_edge_list(self):
        """The merged graph's deterministic edge sequence: live base
        edges in base CSC order, then live inserts in append order.
        Weights keep the base dtype (int64 when the base is unweighted
        but inserts carry weights — the merged graph is then weighted
        iff the base was; insert weights are dropped, matching the
        engines' unweighted contract)."""
        g = self.base
        live = ~self.del_base
        bsrc = np.asarray(g.col_idx, np.int64)[live]
        bdst = np.asarray(self._dst_of_edge, np.int64)[live]
        isrc, idst, iw = self.live_inserts()
        src = np.concatenate([bsrc, isrc])
        dst = np.concatenate([bdst, idst])
        if g.weights is None:
            return src, dst, None
        bw = np.asarray(g.weights)[live]
        w = np.concatenate([bw, iw.astype(bw.dtype)])
        return src, dst, w

    def merged_graph(self) -> HostGraph:
        """The merged HostGraph — bitwise equal to from_edge_list over
        merged_edge_list (this IS that call; compaction and the test
        oracle both anchor on it)."""
        src, dst, w = self.merged_edge_list()
        return from_edge_list(src, dst, self.base.nv, weights=w)

    def merged_out_degrees(self) -> np.ndarray:
        """Out-degrees of the merged graph in O(delta) on top of the
        base histogram (pagerank's apply divides by these)."""
        deg = self.base.out_degrees().astype(np.int64)
        dele = self.deleted_edges()
        if len(dele):
            np.subtract.at(deg, np.asarray(self.base.col_idx,
                                           np.int64)[dele], 1)
        isrc, _, _ = self.live_inserts()
        if len(isrc):
            np.add.at(deg, isrc, 1)
        return deg.astype(np.int32)

    # ------------------------------------------------------------------
    # journal (npz + json, crash-safe, no pickle)
    # ------------------------------------------------------------------

    def _meta_path(self) -> str:
        return os.path.join(self.journal_dir, "meta.json")

    def _batch_path(self, seq: int) -> str:
        return os.path.join(self.journal_dir, f"batch_{seq:08d}.npz")

    def _marker_path(self, seq: int) -> str:
        return os.path.join(self.journal_dir, f"batch_{seq:08d}.ok")

    def _journal_open(self, replay: bool) -> None:
        os.makedirs(self.journal_dir, mode=0o700, exist_ok=True)
        meta_path = self._meta_path()
        if os.path.exists(meta_path):
            with open(meta_path, "rb") as f:
                meta = json.loads(f.read().decode())
            if meta.get("format") != JOURNAL_FORMAT:
                raise ValueError(
                    f"journal {self.journal_dir}: format "
                    f"{meta.get('format')} != {JOURNAL_FORMAT}")
            sha = _base_sha(self.base)
            if ((meta["nv"], meta["ne"]) != (self.base.nv, self.base.ne)
                    or meta.get("base_sha") != sha):
                raise ValueError(
                    f"journal {self.journal_dir} was written against a "
                    f"different base (nv={meta['nv']} ne={meta['ne']} "
                    f"sha={meta.get('base_sha')}; this base is "
                    f"nv={self.base.nv} ne={self.base.ne} sha={sha})")
            if replay:
                self._journal_replay()
        else:
            _fsync_write(meta_path, json.dumps({
                "format": JOURNAL_FORMAT,
                "nv": int(self.base.nv),
                "ne": int(self.base.ne),
                "weighted": self.base.weights is not None,
                "base_sha": _base_sha(self.base),
            }).encode())

    def _journal_replay(self) -> None:
        """Re-apply committed batches in sequence; stop at the first
        missing marker (an uncommitted append from a crashed writer —
        its npz, if present, is ignored AND removed so the sequence
        number is reusable)."""
        seq = 0
        while True:
            bpath, mpath = self._batch_path(seq), self._marker_path(seq)
            if not os.path.exists(mpath):
                if os.path.exists(bpath):
                    os.remove(bpath)  # torn append: marker never landed
                break
            if not os.path.exists(bpath):
                # marker without batch: a torn directory state from a
                # crash on a filesystem that reordered the entries —
                # treat as uncommitted (the batch bytes are gone)
                os.remove(mpath)
                break
            with np.load(bpath, allow_pickle=False) as z:
                self._apply_resolved(z["src"], z["dst"], z["op"], z["w"])
            seq += 1

    def _journal_write_batch(self, src, dst, op, w, seq=None,
                             extra: Optional[dict] = None) -> int:
        """Durably append ONE batch npz; the batch is NOT committed
        until _journal_mark writes its marker (the crash-window the
        replay protocol is built around)."""
        if seq is None:
            seq = self.batches_applied
        import io

        buf = io.BytesIO()
        np.savez(buf, src=src, dst=dst, op=op, w=w, **(extra or {}))
        _fsync_write(self._batch_path(seq), buf.getvalue())
        return seq

    def _journal_mark(self, seq: int) -> None:
        _fsync_write(self._marker_path(seq), b"ok\n")

    def journal_reset(self) -> None:
        """Drop all committed batches AND the meta (post-compaction
        rotation): the new base snapshot already contains them, and the
        next DeltaLog opened on this dir (against the NEW base) writes
        a fresh meta.  Crash-safe for the CALLER's protocol: compact.py
        persists the merged snapshot (fsync'd) BEFORE calling this, so
        a kill anywhere in here leaves either the full old journal
        (replayable against the old base — stale but consistent) or a
        marker-gapped prefix that replay correctly ignores; it can
        never half-apply a batch."""
        if self.journal_dir is None:
            return
        last = 0
        while os.path.exists(self._marker_path(last)):
            last += 1
        # remove DESCENDING, marker before npz: a crash anywhere in
        # here leaves an intact committed PREFIX (a consistent
        # old-epoch journal) — ascending removal would leave a stale
        # committed SUFFIX that later sequence numbers could resurrect
        # into the new epoch
        for seq in range(last - 1, -1, -1):
            os.remove(self._marker_path(seq))
            if os.path.exists(self._batch_path(seq)):
                os.remove(self._batch_path(seq))
        if os.path.exists(self._meta_path()):
            os.remove(self._meta_path())
