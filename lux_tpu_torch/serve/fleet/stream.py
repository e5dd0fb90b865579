"""Snapshot streaming over the fleet wire protocol (stdlib + numpy).

Counterpart of ``lux_tpu.serve.fleet.stream`` (a copy: the port imports
nothing of the reference).

Retires the fleet's LAST shared-filesystem assumption: ``prepare`` used
to carry a ``path`` both peers could read, which silently required the
controller and every worker to share a disk.  Now the controller reads
the snapshot bytes LOCALLY and streams them to each worker over the
existing bounded-frame wire protocol (``fleet/wire.py``); the worker
reassembles them into its own PRIVATE tmpdir and stages from that local
copy.  Process-mode fleets run with fully disjoint tmpdirs — the
pod_smoke ci stage pins it.

Protocol (rides the ordinary framed connection; npy payloads carry the
raw bytes as uint8, so the no-pickle policy holds end to end)::

    stream_begin {token, nbytes, chunks, chunk_bytes}   -> RPC (ok)
    stream_chunk {token, seq} + uint8 payload            x chunks, casts
    <consumer op> {token, stream: true, sha256, ...}    -> RPC

Chunks are CASTS (no per-chunk ack): ordering is the TCP stream's, flow
control is the kernel's send buffer, and any receive-side error (bad
seq, overflow, disk) is RECORDED in the sink and surfaced by the final
consumer op — degraded to one loud error, never a silent half-file.
The final op carries the sha256 of the whole byte stream; the sink
verifies it against its own rolling digest before handing the local
path over, so a corrupt or truncated reassembly can never be staged.

Chunk size is NEGOTIATED: both peers advertise ``max_frame_bytes()``
in the hello handshake (``LUX_FLEET_MAX_FRAME_MB``), and the sender
chunks to the smaller bound minus frame overhead — a fleet with
mismatched bounds fails loudly at hello, not mid-stream.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

#: frame overhead headroom under the payload bound: the npy container
#: (~128 B) + the JSON header; 64 KiB is orders of magnitude more than
#: either needs and keeps the arithmetic obviously safe
FRAME_SLACK = 64 * 1024

#: floor for a negotiated chunk — a pathological bound must not degrade
#: to byte-at-a-time framing
MIN_CHUNK = 256 * 1024


def negotiate_chunk_bytes(local_bound: int, remote_bound: Optional[int]
                          ) -> int:
    """Chunk size both peers can frame: min of the two advertised
    payload bounds minus slack (remote None = an old peer that never
    advertised; assume it matches ours, which the hello guard already
    enforced for new peers)."""
    bound = int(local_bound)
    if remote_bound is not None:
        bound = min(bound, int(remote_bound))
    return max(MIN_CHUNK, bound - FRAME_SLACK)


def file_chunks(path: str, chunk_bytes: int
                ) -> Tuple[int, int, Iterator[np.ndarray]]:
    """(nbytes, nchunks, iterator of uint8 chunk arrays) for one local
    file.  One sequential read pass; the sender folds the same bytes
    into its sha256 as it goes (see :func:`stream_file`)."""
    nbytes = os.path.getsize(path)
    nchunks = max(1, -(-nbytes // chunk_bytes))

    def gen():
        with open(path, "rb") as f:
            while True:
                buf = f.read(chunk_bytes)
                if not buf:
                    break
                yield np.frombuffer(buf, dtype=np.uint8)

    return nbytes, nchunks, gen()


class StreamSink:
    """Receiver-side reassembly of ONE token's byte stream into a
    private local file.  Single-writer (the connection reader thread
    feeds it in arrival order); errors latch — the first one wins and
    the final consumer op surfaces it."""

    def __init__(self, token: str, dirpath: str, nbytes: int,
                 nchunks: int):
        self.token = str(token)
        self.nbytes = int(nbytes)
        self.nchunks = int(nchunks)
        self.path = os.path.join(dirpath, f"stream-{os.getpid()}-"
                                 f"{abs(hash(token)) % (1 << 32):08x}.lux")
        self.next_seq = 0
        self.received = 0
        self.error: Optional[str] = None
        self._sha = hashlib.sha256()
        self._f = open(self.path, "wb")

    def add(self, seq: int, arr: Optional[np.ndarray]) -> None:
        if self.error is not None:
            return  # latched; drain the rest silently
        if arr is None or arr.dtype != np.uint8 or arr.ndim != 1:
            self.error = (f"stream chunk {seq} for token {self.token!r}"
                          " carries no uint8 payload")
            return
        if int(seq) != self.next_seq:
            self.error = (f"stream chunk out of order for token "
                          f"{self.token!r}: got seq {seq}, expected "
                          f"{self.next_seq} (frames reordered or lost)")
            return
        buf = arr.tobytes()
        if self.received + len(buf) > self.nbytes:
            self.error = (f"stream overflow for token {self.token!r}: "
                          f"{self.received + len(buf)} > announced "
                          f"{self.nbytes} bytes")
            return
        try:
            self._f.write(buf)
        except OSError as e:
            self.error = f"stream sink write failed: {e}"
            return
        self._sha.update(buf)
        self.received += len(buf)
        self.next_seq += 1

    def finalize(self, sha256: str) -> str:
        """Verify completeness + digest; returns the local path.  Raises
        ValueError on any defect (the consumer op turns it into an error
        reply; the controller aborts the republish)."""
        try:
            self._f.close()
        except OSError as e:
            self.error = self.error or f"stream sink close failed: {e}"
        if self.error is not None:
            raise ValueError(self.error)
        if self.received != self.nbytes or self.next_seq != self.nchunks:
            raise ValueError(
                f"incomplete stream for token {self.token!r}: "
                f"{self.received}/{self.nbytes} bytes in "
                f"{self.next_seq}/{self.nchunks} chunks")
        got = self._sha.hexdigest()
        if got != str(sha256):
            raise ValueError(
                f"stream digest mismatch for token {self.token!r}: "
                f"reassembled {got}, sender announced {sha256}")
        return self.path

    def abort(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass


class StreamTable:
    """The receiver's token -> sink map plus its private spool dir.
    One per worker; NOT thread-safe by itself — callers serialize on
    the connection reader (begin/chunk) and take their own lock around
    pop()."""

    def __init__(self, prefix: str = "lux-stream-"):
        self._dir: Optional[str] = None
        self._prefix = prefix
        self._sinks: Dict[str, StreamSink] = {}

    @property
    def dirpath(self) -> str:
        if self._dir is None:
            self._dir = tempfile.mkdtemp(prefix=self._prefix)
        return self._dir

    def begin(self, token: str, nbytes: int, nchunks: int) -> StreamSink:
        old = self._sinks.pop(str(token), None)
        if old is not None:
            old.abort()  # a restarted stream supersedes its own token
        sink = StreamSink(token, self.dirpath, nbytes, nchunks)
        self._sinks[str(token)] = sink
        return sink

    def chunk(self, token: str, seq: int,
              arr: Optional[np.ndarray]) -> None:
        sink = self._sinks.get(str(token))
        if sink is not None:
            sink.add(int(seq), arr)
        # unknown token: a chunk for an already-aborted stream — drop

    def pop(self, token: str) -> Optional[StreamSink]:
        return self._sinks.pop(str(token), None)

    def clear(self) -> None:
        sinks, self._sinks = list(self._sinks.values()), {}
        for s in sinks:
            s.abort()
        if self._dir is not None:
            import shutil

            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None


def stream_file(conn, path: str, token: str, chunk_bytes: int,
                begin_op: str = "stream_begin",
                chunk_op: str = "stream_chunk",
                rpc=None, timeout_s: float = 600.0) -> dict:
    """Sender side: announce + stream one local file to ``conn``.

    ``rpc(msg) -> reply`` performs the begin RPC (the controller passes
    its pending-table sender; the pod driver its blocking call).
    Chunks go out as casts on the same connection — ordered behind the
    begin by TCP.  Returns {nbytes, chunks, sha256} for the caller to
    attach to its final consumer op."""
    nbytes, nchunks, chunks = file_chunks(path, chunk_bytes)
    rpc({"op": begin_op, "token": token, "nbytes": nbytes,
         "chunks": nchunks, "chunk_bytes": int(chunk_bytes)})
    sha = hashlib.sha256()
    for seq, arr in enumerate(chunks):
        sha.update(arr.tobytes())
        conn.send({"op": chunk_op, "token": token, "seq": seq}, arr)
    return {"nbytes": nbytes, "chunks": nchunks,
            "sha256": sha.hexdigest()}
