"""LiveJournal: the controller's authoritative write sequencer.

Counterpart of ``lux_tpu.serve.live.journal``: the same journal files,
``live_meta.json`` and wire frame, so a journal written by either package
replays in the other.  One journal defines the fleet's ONE write order.  Every admitted batch
is resolved against the controller's copy of the base graph and — when
``journal_dir`` is set — made durable through ``mutate/deltalog.py``'s
crash-safe npz+``.ok`` protocol BEFORE any replica sees it, so a
controller crash can never have acknowledged a write the journal lost.

Generations are monotonic across the whole life of the graph::

    generation = base_generation + batches applied this epoch

``base_generation`` advances at each COMPACTION (the epoch boundary):
the merged snapshot then contains every batch up to it, the DeltaLog
journal rotates (deltalog.journal_reset — crash-safe, prefix-consistent)
and a fresh epoch starts empty.  ``live_meta.json`` (fsync'd, next to
the DeltaLog's own ``meta.json``) carries the epoch base so a restarted
controller resumes the SAME generation line; the DeltaLog meta's
``base_sha`` refuses a journal replayed against the wrong snapshot.

Batches ride the fleet wire as ONE ``(rows, 4)`` int64 array
(src, dst, op, weight columns) — ``pack_batch``/``unpack_batch`` are
the two ends of that frame.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from lux_tpu_torch.graph.csc import HostGraph
from lux_tpu_torch.mutate.deltalog import DeltaLog, _fsync_write

#: live-meta layout version
LIVE_FORMAT = 1


def read_live_meta(journal_dir: str) -> Optional[dict]:
    """The epoch meta (``live_meta.json``) of a live journal dir, or
    None when absent.  Shared by the controller's LiveJournal and the
    workers' LiveReplica — one format, one generation line."""
    path = os.path.join(journal_dir, "live_meta.json")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        meta = json.loads(f.read().decode())
    if meta.get("format") != LIVE_FORMAT:
        raise ValueError(
            f"live journal {journal_dir}: format "
            f"{meta.get('format')} != {LIVE_FORMAT}")
    return meta


def write_live_meta(journal_dir: str, base_generation: int) -> None:
    _fsync_write(os.path.join(journal_dir, "live_meta.json"), json.dumps({
        "format": LIVE_FORMAT,
        "base_generation": int(base_generation),
    }).encode())


def pack_batch(src, dst, op, weight=None) -> np.ndarray:
    """One mutation batch -> the (rows, 4) int64 wire array."""
    src = np.atleast_1d(np.asarray(src, np.int64))
    dst = np.atleast_1d(np.asarray(dst, np.int64))
    op = np.atleast_1d(np.asarray(op, np.int64))
    w = (np.zeros(len(src), np.int64) if weight is None
         else np.atleast_1d(np.asarray(weight, np.int64)))
    if not (len(src) == len(dst) == len(op) == len(w)):
        raise ValueError("batch arrays must share one length")
    return np.stack([src, dst, op, w], axis=1)


def unpack_batch(arr: np.ndarray) -> Tuple[np.ndarray, ...]:
    """(rows, 4) int64 wire array -> (src, dst, op, weight)."""
    arr = np.asarray(arr)
    if arr.ndim != 2 or arr.shape[1] != 4:
        raise ValueError(f"delta frame must be (rows, 4); got {arr.shape}")
    a = arr.astype(np.int64, copy=False)
    return a[:, 0], a[:, 1], a[:, 2].astype(np.int8), a[:, 3]


class LiveJournal:
    """The sequencer.  ``base``: the controller's HostGraph copy of the
    CURRENT epoch's snapshot (numpy only — the controller never imports
    torch).  ``journal_dir=None`` keeps it in-memory (tests, ephemeral
    fleets); a directory makes every admitted batch durable before the
    commit generation is returned."""

    def __init__(self, base: HostGraph,
                 journal_dir: Optional[str] = None):
        self.journal_dir = journal_dir
        self.base_generation = 0
        #: guards the (base_generation, log) pair that compaction swaps:
        #: ``generation()`` is read by threads outside the write path (a
        #: reader stamping its submit, the heartbeat-fed stats), and
        #: between the two stores it would read the new base plus the
        #: old epoch's batches
        self._epoch_lock = threading.Lock()
        meta = None
        if journal_dir is not None:
            os.makedirs(journal_dir, mode=0o700, exist_ok=True)
            meta = read_live_meta(journal_dir)
            if meta is not None:
                self.base_generation = int(meta["base_generation"])
        # replays any committed epoch batches (and validates base_sha)
        self.log = DeltaLog(base, journal_dir=journal_dir)
        #: committed batches of THIS epoch, wire-packed, replication +
        #: catch-up order; index i commits generation base_generation+i+1
        self._batches: List[np.ndarray] = []
        #: idempotent write-id -> commit generation: a client
        #: retrying an admit whose ack was lost to a controller crash
        #: gets the ALREADY-COMMITTED generation back instead of a
        #: double apply.  Journaled write-ids ride inside the batch npz
        #: (``wid`` key, ignored by replay), so a RESTARTED controller
        #: rebuilds the current epoch's map; ids of compacted epochs
        #: survive only in this process's memory — documented window.
        self._write_ids: Dict[str, int] = {}
        if journal_dir is not None and self.log.batches_applied:
            self._reload_epoch_batches()
        if journal_dir is not None and meta is None:
            self._write_live_meta()

    # ------------------------------------------------------------------
    # generations
    # ------------------------------------------------------------------

    def generation(self) -> int:
        with self._epoch_lock:
            return self.base_generation + self.log.batches_applied

    def admit(self, src, dst, op, weight=None,
              write_id: Optional[str] = None) -> int:
        """Sequence ONE batch: resolve against the merged state, journal
        it durably (marker last), and return its COMMIT generation.
        Raises like DeltaLog.apply on an invalid batch — nothing is
        journaled, no generation is burned.

        ``write_id``: idempotence key — a replayed admit with an
        already-committed id returns that commit's generation WITHOUT
        applying anything (the retry-after-lost-ack path; callers that
        replicate must check ``generation()`` did not advance)."""
        if write_id is not None:
            got = self._write_ids.get(str(write_id))
            if got is not None:
                return got
        arr = pack_batch(src, dst, op, weight)
        s, d, o, w = unpack_batch(arr)
        extra = None
        if write_id is not None:
            extra = {"wid": np.frombuffer(
                str(write_id).encode("utf-8"), np.uint8)}
        self.log.apply(s, d, o, w, journal_extra=extra)
        self._batches.append(arr)
        gen = self.generation()
        if write_id is not None:
            self._write_ids[str(write_id)] = gen
        return gen

    def lookup_write(self, write_id: str) -> Optional[int]:
        """The commit generation of an already-admitted ``write_id``,
        or None."""
        return self._write_ids.get(str(write_id))

    # ------------------------------------------------------------------
    # replication / catch-up views
    # ------------------------------------------------------------------

    def payload(self, generation: int) -> np.ndarray:
        """The wire array of the batch that committed ``generation``."""
        idx = int(generation) - self.base_generation - 1
        if not (0 <= idx < len(self._batches)):
            raise KeyError(
                f"generation {generation} is not in this epoch "
                f"({self.base_generation}..{self.generation()}] — "
                "compacted-away batches live in the snapshot)")
        return self._batches[idx]

    def batches_since(self, generation: int):
        """(gen, wire array) for every committed batch AFTER
        ``generation`` — the catch-up stream for a joining/recovering
        worker.  ``generation`` below the epoch base raises: those
        batches were compacted into the snapshot, so the worker must
        restart from it instead."""
        g = int(generation)
        if g < self.base_generation:
            raise KeyError(
                f"generation {g} predates the current epoch base "
                f"{self.base_generation}: the missing batches were "
                "compacted into the snapshot — reload the worker from "
                "it and catch up from there")
        return [(g0 + 1, self._batches[g0 - self.base_generation])
                for g0 in range(g, self.generation())]

    # ------------------------------------------------------------------
    # compaction epoch
    # ------------------------------------------------------------------

    def compact(self, snapshot_path: Optional[str] = None) -> HostGraph:
        """Fold the epoch into a new base: write the merged snapshot
        durably (when a path is given — REQUIRED for a journaled
        sequencer, same rule as MutableGraph.compact), rotate the
        journal, advance ``base_generation`` to the current generation
        and start the next epoch empty.  Returns the merged graph (what
        the fleet republish ships)."""
        from lux_tpu_torch.mutate.compact import snapshot_write

        if self.journal_dir is not None and snapshot_path is None:
            raise ValueError(
                "a journaled LiveJournal needs a snapshot path to "
                "compact: rotating the journal without persisting the "
                "merged base would drop durable writes")
        merged = self.log.merged_graph()
        if snapshot_path is not None:
            snapshot_write(snapshot_path, merged)
        with self._epoch_lock:
            self.base_generation += self.log.batches_applied
            self.log.journal_reset()
            self.log = DeltaLog(merged, journal_dir=self.journal_dir)
            self._batches = []
        if self.journal_dir is not None:
            self._write_live_meta()
        return merged

    # ------------------------------------------------------------------
    # epoch reload
    # ------------------------------------------------------------------

    def _write_live_meta(self) -> None:
        write_live_meta(self.journal_dir, self.base_generation)

    def _reload_epoch_batches(self) -> None:
        """Rebuild the wire-packed batch list from the committed journal
        files (the DeltaLog already replayed them into its state; this
        restores the replication/catch-up view a restarted controller
        needs)."""
        for seq in range(self.log.batches_applied):
            with np.load(self.log._batch_path(seq),
                         allow_pickle=False) as z:
                self._batches.append(
                    pack_batch(z["src"], z["dst"], z["op"], z["w"]))
                if "wid" in z.files:  # idempotent write-id rides along
                    wid = bytes(np.asarray(z["wid"],
                                           np.uint8)).decode("utf-8")
                    self._write_ids[wid] = (self.base_generation
                                            + seq + 1)

    def stats(self) -> dict:
        return {
            "generation": self.generation(),
            "base_generation": self.base_generation,
            "epoch_batches": len(self._batches),
            "write_ids": len(self._write_ids),
            **self.log.stats(),
        }
