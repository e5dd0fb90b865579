"""Fleet wire protocol: length-prefixed JSON + npy frames over loopback
TCP sockets (pure stdlib + numpy).

Counterpart of ``lux_tpu.serve.fleet.wire`` (a copy: the port imports
nothing of the reference).  Frames are byte-compatible: a frame either
package packs, the other unpacks.  Why not torch.distributed / gRPC /
pickle: replicas are independent CUDA processes, not ranks of one job,
and pickle over a socket is an arbitrary-code-execution surface.  A
frame here is::

    !III  header_len payload_len payload_crc32
    header_len bytes   UTF-8 JSON object (the message)
    payload_len bytes  optional np.save() bytes (one ndarray)

The npy container carries dtype/shape itself, so answers round-trip
bitwise with no schema drift; ``allow_pickle=False`` on the way back in
keeps the no-pickle policy airtight.  The crc32 makes
payload corruption DETECTABLE: a length prefix already fails loudly,
but flipped bits inside an npy's data region used to parse as a valid
— wrong — answer; now they are a WireError (both peers always run the
same code, so the frame layout can evolve atomically).  Every message is a JSON dict; the
conventional keys are ``op`` (requests), ``req_id`` (multiplexing), and
``ok``/``err`` (replies) — the framing layer does not interpret them.

``Conn`` wraps a connected socket with a send lock (many threads reply
on one connection: the worker's responder + op handlers) and a recv that
is only ever called from that connection's single reader thread.

**Deadlines**: once a frame is IN FLIGHT — the first header
byte arrived, or a send began — the rest must complete within
``LUX_FLEET_TIMEOUT_S`` (default 60 s; 0 disables).  Idle waits between
frames stay unbounded (a quiet peer is normal; a half-frame peer is
hung).  Timeouts are selectors-based, never ``settimeout`` — the reader
and the senders share one socket object, and a socket-level timeout set
by one would race the other.  A deadline expiring raises
:class:`WireTimeout` (a ``ConnectionClosed``: a peer that hangs
mid-frame has desynchronized the stream, so the connection is done)
naming the peer and the knob.

**Fault injection**: every send and every received frame
consults the process's installed :class:`lux_tpu_torch.fault.FaultPlan` at
sites ``wire.send`` / ``wire.recv`` with (owner, peer, op) context —
drops, delays, truncated/partial writes, corrupt payloads, resets and
kills are injected HERE, at the layer where real networks fail, so
drills exercise the exact production frames.  No plan installed = one
``None`` check per frame.
"""
from __future__ import annotations

import io
import json
import selectors
import socket
import struct
import threading
import time
import zlib
from typing import Optional, Tuple

import numpy as np

from lux_tpu_torch import fault as _fault
from lux_tpu_torch.obs import dtrace as _dtrace

_HDR = struct.Struct("!III")

#: sanity bounds — a corrupt length prefix must fail loudly, not OOM the
#: controller (64 MiB covers a (nv,) answer for any graph serve handles)
MAX_HEADER = 16 * 1024 * 1024
MAX_PAYLOAD = 64 * 1024 * 1024

#: longest uninterrupted wait of an in-flight frame before re-checking
#: that its socket is still open (see _wait_io)
CLOSE_POLL_S = 0.25


def max_frame_bytes() -> int:
    """The payload bound, env-tunable: ``LUX_FLEET_MAX_FRAME_MB``
    (default 64 MiB).  Resolved per call so a worker process launched
    with the knob and a controller sharing its environment agree — the
    first hardening step toward non-loopback workers shipping bigger
    snapshots/answers; both peers must raise it, since
    a frame one side can send and the other refuses to receive is a
    dropped connection, not an error reply."""
    from lux_tpu_torch.utils.config import env_int

    return env_int("LUX_FLEET_MAX_FRAME_MB", MAX_PAYLOAD // (1024 * 1024),
                   minimum=1) * 1024 * 1024


def frame_timeout_s() -> Optional[float]:
    """Per-frame in-flight deadline: ``LUX_FLEET_TIMEOUT_S`` seconds
    (default 60; 0 disables).  Resolved per call like max_frame_bytes
    so both peers of a spawned-process fleet agree from one
    environment."""
    from lux_tpu_torch.utils.config import env_float

    t = env_float("LUX_FLEET_TIMEOUT_S", 60.0, minimum=0.0)
    return None if not t else float(t)


class WireError(RuntimeError):
    """Malformed frame (bad length prefix, oversized, bad JSON)."""


class ConnectionClosed(ConnectionError):
    """Peer closed the connection (EOF mid-frame or between frames)."""


class WireTimeout(ConnectionClosed):
    """A frame in flight did not complete within LUX_FLEET_TIMEOUT_S.
    Subclasses ConnectionClosed: a peer hung mid-frame has
    desynchronized the byte stream, so every handler that survives a
    dropped peer (retire + re-dispatch) is the right handler here too
    — previously this peer would have blocked its reader thread
    forever."""

    def __init__(self, direction: str, peer: str, waiting_bytes: int,
                 timeout_s: float):
        super().__init__(
            f"{direction} to/from peer {peer!r} stalled mid-frame "
            f"({waiting_bytes} bytes outstanding after {timeout_s:g}s) "
            "— raise LUX_FLEET_TIMEOUT_S if this link is genuinely "
            "that slow")
        self.peer = peer
        self.timeout_s = timeout_s


def _wait_io(sock: socket.socket, direction: str, deadline: float,
             peer: str, nbytes: int, timeout_s: float) -> None:
    """Block until the socket is ready for ``direction`` or the
    deadline passes (WireTimeout).  selectors (epoll/poll under the
    hood), NOT select.select: fd-set select breaks on fds >= 1024
    (FD_SETSIZE), and a big fleet's controller — many workers, engine
    caches, journal files — crosses that line with perfectly healthy
    sockets.

    The wait runs in slices of CLOSE_POLL_S, checking between them
    whether another thread closed the socket: epoll drops a closed fd
    from its interest set without waking the waiter, so a sender racing
    a controller's retire of the same connection would otherwise sit out
    the whole deadline."""
    ev = (selectors.EVENT_READ if direction == "recv"
          else selectors.EVENT_WRITE)
    try:
        with selectors.DefaultSelector() as sel:
            sel.register(sock, ev)
            while True:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                if sel.select(min(rem, CLOSE_POLL_S)):
                    return
                if sock.fileno() == -1:
                    raise OSError("socket closed")
    except (OSError, ValueError) as e:  # fd closed under us
        raise ConnectionClosed(f"{direction} to/from {peer}: {e}") \
            from None
    raise WireTimeout(direction, peer, nbytes, timeout_s)


def _recv_exact(sock: socket.socket, n: int, peer: str = "peer",
                timeout_s: Optional[float] = None,
                idle_first: bool = False) -> bytes:
    """Read exactly ``n`` bytes.  ``idle_first`` lets the FIRST byte
    wait forever (the normal idle gap between frames); once any byte
    of a frame arrived, the rest must land within ``timeout_s``."""
    buf = bytearray()
    deadline: Optional[float] = (
        None if timeout_s is None or idle_first
        else time.monotonic() + timeout_s)
    while len(buf) < n:
        if deadline is not None:
            _wait_io(sock, "recv", deadline, peer, n - len(buf),
                     timeout_s)
        try:
            chunk = sock.recv(n - len(buf))
        except OSError as e:
            raise ConnectionClosed(f"recv from {peer} failed: {e}") \
                from None
        if not chunk:
            raise ConnectionClosed(f"peer {peer} closed")
        buf.extend(chunk)
        if deadline is None and timeout_s is not None:
            deadline = time.monotonic() + timeout_s  # frame in flight
    return bytes(buf)


def _send_all(sock: socket.socket, data: bytes, peer: str,
              timeout_s: Optional[float]) -> None:
    view = memoryview(data)
    deadline = (None if timeout_s is None
                else time.monotonic() + timeout_s)
    while view.nbytes:
        if deadline is not None:
            _wait_io(sock, "send", deadline, peer, view.nbytes,
                     timeout_s)
        try:
            sent = sock.send(view)
        except OSError as e:
            raise ConnectionClosed(f"send to {peer} failed: {e}") \
                from None
        view = view[sent:]


def pack_array(arr: np.ndarray) -> bytes:
    bio = io.BytesIO()
    np.save(bio, np.ascontiguousarray(arr), allow_pickle=False)
    return bio.getvalue()


def unpack_array(payload: bytes) -> np.ndarray:
    return np.load(io.BytesIO(payload), allow_pickle=False)


class Conn:
    """One framed, thread-safe-for-send connection.  ``peer`` names the
    REMOTE end and ``owner`` the local one — purely observability +
    fault-rule matching labels (errors name the peer; FaultRules match
    both)."""

    #: class-level label defaults: a Conn built without __init__ (test
    #: doubles) still labels errors and matches fault rules sanely
    peer = "peer"
    owner: Optional[str] = None
    _tc_sent = 0
    _tc_rcvd = 0

    #: skew-stamp throttle: the first N traced frames per connection
    #: always stamp dtrace.send/recv points, then every Mth — the skew
    #: solver needs a SAMPLE of (send, recv) pairs per process pair
    #: (it takes minima), and stamping every frame of a saturated
    #: fleet would make the stamps themselves the overhead
    TC_STAMP_FIRST = 32
    TC_STAMP_EVERY = 16

    def __init__(self, sock: socket.socket, peer: str = "peer",
                 owner: Optional[str] = None):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._closed = False
        self._tc_sent = 0
        self._tc_rcvd = 0
        self.peer = str(peer)
        self.owner = owner

    def _stamp(self, count: int) -> bool:
        return (count <= self.TC_STAMP_FIRST
                or count % self.TC_STAMP_EVERY == 0)

    @classmethod
    def connect(cls, host: str, port: int, timeout_s: float = 10.0,
                peer: Optional[str] = None,
                owner: Optional[str] = None) -> "Conn":
        sock = socket.create_connection((host, port), timeout=timeout_s)
        sock.settimeout(None)  # blocking from here on; reader owns recv
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return cls(sock, peer=peer if peer else f"{host}:{port}",
                   owner=owner)

    def label(self, peer: Optional[str] = None,
              owner: Optional[str] = None) -> "Conn":
        """Re-label after identity is learned (the controller knows a
        worker's id only after its hello)."""
        if peer is not None:
            self.peer = str(peer)
        if owner is not None:
            self.owner = str(owner)
        return self

    # ------------------------------------------------------------------

    def send(self, msg: dict, arr: Optional[np.ndarray] = None) -> None:
        header = json.dumps(msg, separators=(",", ":")).encode("utf-8")
        payload = pack_array(arr) if arr is not None else b""
        if len(header) > MAX_HEADER or len(payload) > max_frame_bytes():
            raise WireError(
                f"frame too large: header={len(header)} "
                f"payload={len(payload)} (payload bound is "
                "LUX_FLEET_MAX_FRAME_MB)")
        frame = (_HDR.pack(len(header), len(payload),
                           zlib.crc32(payload)) + header + payload)
        rule = _fault.fire("wire.send", owner=self.owner, peer=self.peer,
                           op=msg.get("op"))
        if rule is not None:
            frame = self._faulted_send(rule, frame)
            if frame is None:
                return
        with self._send_lock:
            tc = msg.get("tc")
            if tc is not None:
                # the skew-correction stamp: paired with the
                # receiver's dtrace.recv by the header's span id, these
                # are the (send, recv) pairs a trace stitcher bounds
                # per-process clock offsets from.  Untraced frames
                # (heartbeats, no header) cost exactly this None check;
                # traced ones are throttled past TC_STAMP_FIRST (see
                # _stamp).  Counter + stamp live INSIDE the send lock:
                # the receiver counts frames in arrival (= send) order,
                # and both sides must pick the SAME frames to stamp or
                # the (send, recv) pairs never match up under
                # concurrent senders.
                self._tc_sent += 1
                if self._stamp(self._tc_sent):
                    _dtrace.wire_point("send", tc, msg.get("op"),
                                       self.peer, self.owner)
            _send_all(self._sock, frame, self.peer, frame_timeout_s())

    def _faulted_send(self, rule, frame: bytes) -> Optional[bytes]:
        """Apply a fired send-site rule; returns the (possibly altered)
        frame to transmit, or None when nothing should be sent."""
        act = rule.action
        if act == "drop":
            return None
        if act == "kill":
            raise _fault.InjectedKill("injected kill at wire.send")
        if act == "delay":
            if rule.delay_ms > 0:
                time.sleep(rule.delay_ms / 1e3)
            return frame
        if act == "corrupt":
            # flip bits near the end of the frame (payload when present,
            # header otherwise) — the peer must detect, not crash
            buf = bytearray(frame)
            buf[-1] ^= 0xFF
            buf[len(buf) // 2] ^= 0xFF
            return bytes(buf)
        if act in ("truncate", "partial"):
            cut = min(_HDR.size + max(rule.trunc_bytes, 0),
                      max(len(frame) - 1, 1))
            with self._send_lock:
                _send_all(self._sock, frame[:cut], self.peer,
                          frame_timeout_s())
            if act == "truncate":
                self.close()  # peer sees EOF mid-frame
            # "partial": stop mid-frame WITHOUT closing — the peer's
            # LUX_FLEET_TIMEOUT_S deadline is what unsticks it
            return None
        if act == "reset":
            self.close()
            raise ConnectionClosed(
                f"injected reset to peer {self.peer!r}")
        return frame  # noop

    def recv(self) -> Tuple[dict, Optional[np.ndarray]]:
        """Next (message, array-or-None).  Single-reader only."""
        timeout_s = frame_timeout_s()
        while True:
            hl, pl, crc = _HDR.unpack(_recv_exact(
                self._sock, _HDR.size, peer=self.peer,
                timeout_s=timeout_s, idle_first=True))
            if hl > MAX_HEADER or pl > max_frame_bytes():
                raise WireError(f"frame length out of bounds: {hl}/{pl} "
                                "(payload bound is LUX_FLEET_MAX_FRAME_MB)")
            try:
                msg = json.loads(_recv_exact(
                    self._sock, hl, peer=self.peer,
                    timeout_s=timeout_s).decode("utf-8"))
            except ValueError as e:
                raise WireError(f"bad frame header JSON: {e}") from None
            if not isinstance(msg, dict):
                raise WireError(
                    f"frame header is not an object: {type(msg)}")
            payload = _recv_exact(self._sock, pl, peer=self.peer,
                                  timeout_s=timeout_s) if pl else b""
            rule = _fault.fire("wire.recv", owner=self.owner,
                               peer=self.peer, op=msg.get("op"))
            if rule is not None:
                if rule.action == "drop":
                    continue  # the frame never happened
                if rule.action == "kill":
                    raise _fault.InjectedKill(
                        "injected kill at wire.recv")
                if rule.action == "delay" and rule.delay_ms > 0:
                    time.sleep(rule.delay_ms / 1e3)
                if rule.action == "reset":
                    self.close()
                    raise ConnectionClosed(
                        f"injected reset from peer {self.peer!r}")
                if rule.action == "corrupt" and payload:
                    buf = bytearray(payload)
                    buf[-1] ^= 0xFF
                    buf[len(buf) // 2] ^= 0xFF
                    payload = bytes(buf)
            tc = msg.get("tc")
            if tc is not None:
                self._tc_rcvd += 1
                if self._stamp(self._tc_rcvd):
                    _dtrace.wire_point("recv", tc, msg.get("op"),
                                       self.peer, self.owner)
            if not payload:
                return msg, None
            if zlib.crc32(payload) != crc:
                # flipped bits inside the npy DATA region would parse
                # as a valid (wrong!) array — the crc is the only
                # detector for silent payload corruption
                raise WireError(
                    f"corrupt payload from peer {self.peer!r}: crc "
                    "mismatch")
            try:
                return msg, unpack_array(payload)
            except ValueError as e:
                raise WireError(
                    f"corrupt npy payload from peer {self.peer!r}: {e}"
                ) from None

    def recv_wait(self, timeout_s: float) -> Tuple[dict, Optional[np.ndarray]]:
        """``recv()`` with a BOUNDED wait for the frame to START.

        Plain ``recv`` idles forever between frames (a quiet peer is
        normal for the data plane), but a lease probe (election.py's
        WireIncumbent) must treat silence itself as the signal: an
        incumbent that stops answering within the lease interval is
        dead.  Raises :class:`WireTimeout` when no frame begins within
        ``timeout_s``; once bytes flow, the normal in-flight deadline
        applies."""
        _wait_io(self._sock, "recv", time.monotonic() + timeout_s,
                 self.peer, _HDR.size, timeout_s)
        return self.recv()

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    @property
    def closed(self) -> bool:
        return self._closed
