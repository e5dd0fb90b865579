"""Pods: fleet workers that are slices of ONE sharded graph.

Counterpart of ``lux_tpu.serve.fleet.pod``.  The fleet (serve/fleet)
replicates a graph across processes; a *pod* is a set of worker
processes that together hold ONE sharded graph, each worker owning the
contiguous part range a shared :class:`~lux_tpu_torch.parallel.placement
.PlacementTree` assigns to its host coordinate — the balanced split of a
multi-host launch.  On one H100 each member is a CUDA process of its own;
loopback TCP carries what the interconnect would.

Per iteration the pod runs the pull engine's EXACT per-part step
(``engine/pull.local_pull_step``) on each worker's resident parts, on
the worker's device, with the driver assembling the full gathered state
in part order between rounds — the all-gather leg spelled as frames.
Every worker resolves the same method (``engine/methods.resolve_sum`` on
its device: ``auto`` is mxscan on the card, so each iteration launches
the ``mxscan_segmented`` kernel in every member; each step reply carries
the member's kernel launch counts), and the state crosses
processes as npy frames (device -> host -> wire -> host -> device) that
nothing rounds, so pod answers are BITWISE equal to the single-process
engine (``run_pull_fixed``/``run_pull_until`` over the same parts) for
every (parts x hosts) shape, mutation overlays included (rows sliced to
each worker by the same tree).

No shared filesystem: the snapshot reaches each worker as a byte stream
over the bounded-frame wire protocol (serve/fleet/stream.py), and each
worker loads only its own parts' byte ranges
(graph/sharded_load.load_pull_shards).

Run a worker: ``python -m lux_tpu_torch.serve.fleet.pod --worker-id p0
[--device cuda|cpu]`` (prints one READY JSON line; see
serve/fleet/launcher.py).  Drive a pod: :func:`run_pull_pod`.
"""
from __future__ import annotations

import io
import json
import os
import socket
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from lux_tpu_torch.parallel.placement import PlacementTree
from lux_tpu_torch.serve.fleet.stream import (
    StreamTable,
    negotiate_chunk_bytes,
    stream_file,
)
from lux_tpu_torch.serve.fleet.wire import (
    Conn,
    ConnectionClosed,
    WireError,
    max_frame_bytes,
)

#: apps a pod can run: quiescent apps stop on total changed-count == 0
#: (run_pull_until semantics); pagerank runs exactly ``num_iters`` rounds
POD_APPS = ("sssp", "components", "pagerank")


class PodError(RuntimeError):
    pass


def _build_prog(app: str, start: int, nv: int):
    """(program, until) for one pod app — the same model classes the
    single-process drivers use, so parity is by construction."""
    if app == "sssp":
        from lux_tpu_torch.models.sssp import SSSPProgram

        return SSSPProgram(nv=nv, start=int(start)), True
    if app == "components":
        from lux_tpu_torch.models.components import MaxLabelProgram

        return MaxLabelProgram(), True
    if app == "pagerank":
        from lux_tpu_torch.models.pagerank import PageRankProgram

        return PageRankProgram(nv=nv), False
    raise PodError(
        f"unknown pod app {app!r}; expected one of {POD_APPS}")


def _pack_overlay(oarrays) -> np.ndarray:
    """OverlayArrays rows -> one uint8 npz blob (a single npy payload
    frame; np.savez of plain ndarrays — no pickle)."""
    buf = io.BytesIO()
    np.savez(buf, **{f: np.asarray(getattr(oarrays, f))
                     for f in type(oarrays)._fields})
    return np.frombuffer(buf.getvalue(), dtype=np.uint8)


def _unpack_overlay(blob: np.ndarray):
    from lux_tpu_torch.mutate.overlay import OverlayArrays

    with np.load(io.BytesIO(blob.tobytes()), allow_pickle=False) as z:
        return OverlayArrays(**{f: z[f] for f in OverlayArrays._fields})


class PodWorker:
    """One pod member: owns the parts a PlacementTree assigns to its
    host coordinate, steps them on ``device`` with the pull engine's
    per-part math, and speaks the fleet wire protocol (hello /
    stream_begin / stream_chunk / pod_build / pod_overlay / pod_step /
    stats / shutdown).  One driver connection at a time is the intended
    shape; extra connections are served but share the one engine."""

    def __init__(self, worker_id: str, host: str = "127.0.0.1",
                 port: int = 0, device="cuda"):
        from lux_tpu_torch.utils.device import resolve_device

        self.worker_id = str(worker_id)
        self.device = resolve_device(device)  # raises before binding
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, int(port)))
        self._srv.listen(4)
        self.host, self.port = self._srv.getsockname()[:2]
        self._streams = StreamTable(prefix=f"lux-pod-{worker_id}-")
        self._lock = threading.Lock()  # engine + stream table
        self._running = False
        self._threads: List[threading.Thread] = []
        self._conns: List[Conn] = []
        # engine state (built by pod_build)
        self._shards = None
        self._arrays = None  # the resident parts' arrays on the device
        self._prog = None
        self._method = "scan"
        self._tree: Optional[PlacementTree] = None
        self._host_index = 0
        self._lo = 0
        self._hi = 0
        self._overlays = None  # one DeviceOverlay per resident part
        self._launch_base: dict = {}  # kernel launches at the last pod_build
        self.counts = {"steps": 0, "builds": 0, "compute_s": 0.0,
                       "plan_s": 0.0}

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "PodWorker":
        self._running = True
        t = threading.Thread(target=self._accept_loop,
                             name=f"lux-pod-{self.worker_id}",
                             daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._running = False
        # shutdown() first: close() alone does not wake a thread blocked
        # in accept() on Linux
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # never connected / already down
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            c.close()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=10.0)
        with self._lock:
            self._streams.clear()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                sock, _addr = self._srv.accept()
            except OSError:
                return
            conn = Conn(sock, peer="pod-driver",
                        owner=f"pod-{self.worker_id}")
            with self._lock:
                self._conns.append(conn)
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _conn_loop(self, conn: Conn) -> None:
        while self._running:
            try:
                msg, arr = conn.recv()
            except (ConnectionClosed, WireError):
                break
            try:
                if not self._dispatch(conn, msg, arr):
                    break
            except ConnectionClosed:
                break
            except Exception as e:  # noqa: BLE001 — op errors reply, not die
                try:
                    conn.send({"req_id": msg.get("req_id"), "ok": False,
                               "err": f"{type(e).__name__}: {e}"})
                except ConnectionClosed:
                    break
        conn.close()

    def _reply(self, conn: Conn, msg: dict, arr=None, **fields) -> None:
        conn.send({"req_id": msg.get("req_id"), "ok": True, **fields},
                  arr)

    def _reply_err(self, conn: Conn, msg: dict, err: str) -> None:
        conn.send({"req_id": msg.get("req_id"), "ok": False, "err": err})

    # -- ops -------------------------------------------------------------

    def _dispatch(self, conn: Conn, msg: dict, arr) -> bool:
        op = msg.get("op")
        if op == "hello":
            self._reply(conn, msg, worker_id=self.worker_id,
                        max_frame_bytes=max_frame_bytes(),
                        pid=os.getpid(), device=str(self.device))
        elif op == "stream_begin":
            with self._lock:
                self._streams.begin(str(msg["token"]),
                                    int(msg["nbytes"]),
                                    int(msg["chunks"]))
            self._reply(conn, msg)
        elif op == "stream_chunk":  # cast: no reply (stream.py contract)
            with self._lock:
                self._streams.chunk(str(msg["token"]),
                                    int(msg["seq"]), arr)
        elif op == "pod_build":
            self._op_build(conn, msg)
        elif op == "pod_overlay":
            self._op_overlay(conn, msg, arr)
        elif op == "pod_step":
            self._op_step(conn, msg, arr)
        elif op == "stats":
            from lux_tpu_torch.serve.fleet.worker import (device_memory,
                                                          kernel_launches)

            with self._lock:
                lo, hi, counts = self._lo, self._hi, dict(self.counts)
            self._reply(conn, msg, worker_id=self.worker_id, lo=lo, hi=hi,
                        launches=kernel_launches(),
                        **device_memory(self.device), **counts)
        elif op == "shutdown":
            self._reply(conn, msg)
            self.stop()
            return False
        else:
            self._reply_err(conn, msg, f"unknown pod op {op!r}")
        return True

    def _op_build(self, conn: Conn, msg: dict) -> None:
        from lux_tpu_torch.engine import methods, pull
        from lux_tpu_torch.graph.shards import to_device
        from lux_tpu_torch.graph.sharded_load import load_pull_shards
        from lux_tpu_torch.serve.fleet.worker import kernel_launches

        t0 = time.perf_counter()
        token = str(msg["token"])
        with self._lock:
            sink = self._streams.pop(token)
        if sink is None:
            self._reply_err(conn, msg,
                            f"no snapshot stream staged for token "
                            f"{token!r}")
            return
        try:
            path = sink.finalize(str(msg.get("sha256")))
        except ValueError as e:
            sink.abort()
            self._reply_err(conn, msg, str(e))
            return
        num_parts = int(msg["num_parts"])
        tree = PlacementTree.from_wire(msg["placement"])
        host_index = int(msg["host"])
        if tree.num_parts != num_parts:
            os.unlink(path)
            self._reply_err(conn, msg,
                            f"placement tree covers {tree.num_parts} "
                            f"parts, graph is cut into {num_parts}")
            return
        parts = tree.parts_of(host_index)
        # partial load: only MY parts' byte ranges enter memory — no
        # worker holds the whole edge list
        shards = load_pull_shards(path, num_parts, parts_subset=list(parts))
        try:
            os.unlink(path)  # spool served its purpose
        except OSError:
            pass
        prog, _until = _build_prog(str(msg.get("app", "sssp")),
                                   int(msg.get("start", 0)),
                                   shards.spec.nv)
        arrays = to_device(shards.arrays, self.device)
        method = methods.resolve_sum(str(msg.get("method", "auto")),
                                     prog.reduce,
                                     methods.default_platform(self.device))
        state0 = pull.init_state(prog, arrays)
        with self._lock:
            self._shards = shards
            self._arrays = arrays
            self._prog = prog
            self._method = method
            self._tree = tree
            self._host_index = host_index
            self._lo, self._hi = parts.start, parts.stop
            self._overlays = None
            self._launch_base = kernel_launches()
            self.counts["builds"] += 1
            lo, hi = self._lo, self._hi
        plan_s = time.perf_counter() - t0
        with self._lock:
            self.counts["plan_s"] += plan_s
        self._reply(conn, msg, state0.cpu().numpy(), lo=lo, hi=hi,
                    nv=shards.spec.nv, nv_pad=shards.spec.nv_pad,
                    plan_s=plan_s, method=method)

    def _op_overlay(self, conn: Conn, msg: dict, blob) -> None:
        from lux_tpu_torch.mutate import overlay as ovl

        with self._lock:
            shards = self._shards
            lo, hi = self._lo, self._hi
        if shards is None:
            self._reply_err(conn, msg, "pod_overlay before pod_build")
            return
        if blob is None:
            with self._lock:
                self._overlays = None
            self._reply(conn, msg)
            return
        oarrays = _unpack_overlay(blob)
        k = hi - lo
        if oarrays.del_val.shape[0] != k:
            self._reply_err(conn, msg,
                            f"overlay rows {oarrays.del_val.shape[0]} "
                            f"!= my {k} resident parts")
            return
        # the insert fold's rounds are planned here, once, on the host
        overlays = ovl.device_overlay(oarrays, self.device,
                                      shards.spec.nv_pad)
        with self._lock:
            self._overlays = overlays
        self._reply(conn, msg)

    def _op_step(self, conn: Conn, msg: dict, full) -> None:
        import torch

        from lux_tpu_torch.engine.pull import local_pull_step
        from lux_tpu_torch.program.spec import active_changed
        from lux_tpu_torch.serve.fleet.worker import kernel_launches

        with self._lock:
            shards, arrays = self._shards, self._arrays
            prog, method = self._prog, self._method
            overlays = self._overlays
            lo, hi = self._lo, self._hi
            base = self._launch_base
        if shards is None:
            self._reply_err(conn, msg, "pod_step before pod_build")
            return
        if full is None:
            self._reply_err(conn, msg,
                            "pod_step carries no gathered-state payload")
            return
        t0 = time.perf_counter()
        V = shards.spec.nv_pad
        full_t = torch.from_numpy(np.ascontiguousarray(full)).to(self.device)
        local = full_t.reshape((shards.spec.num_parts, V)
                               + tuple(full_t.shape[1:]))[lo:hi]
        # literally engine/pull._pull_iteration restricted to the parts
        # this host owns: pod math IS single-process math
        new = torch.stack([
            local_pull_step(prog, arrays.part(i), full_t, local[i], method,
                            overlay=None if overlays is None else overlays[i])
            for i in range(hi - lo)])
        active = int(active_changed(local, new).sum())
        new_np = new.cpu().numpy()
        compute_s = time.perf_counter() - t0
        with self._lock:
            self.counts["steps"] += 1
            self.counts["compute_s"] += compute_s
        # this run's launches: the counters' growth since its pod_build
        launches = {k: n - base.get(k, 0) for k, n in kernel_launches().items()}
        self._reply(conn, msg, new_np, active=active, compute_s=compute_s,
                    launches=launches)


# ----------------------------------------------------------------------
# the driver: a pod as one logical engine
# ----------------------------------------------------------------------


def _rpc(conn: Conn, msg: dict,
         arr: Optional[np.ndarray] = None) -> Tuple[dict, object]:
    """One blocking request/reply on a driver connection (the driver is
    the connection's only reader, one op in flight per worker)."""
    conn.send(msg, arr)
    reply, payload = conn.recv()
    if not reply.get("ok"):
        raise PodError(reply.get("err", f"pod op {msg.get('op')!r} "
                                        "failed"))
    return reply, payload


class PodHandle:
    """Driver-side view of one pod member."""

    def __init__(self, conn: Conn, worker_id: str, bound: Optional[int]):
        self.conn = conn
        self.worker_id = worker_id
        self.max_frame_bytes = bound
        self.lo = 0
        self.hi = 0
        self.compute_s = 0.0
        self.launches: dict = {}
        self.method = None


def pod_connect(endpoints: Sequence[Tuple[str, int]],
                timeout_s: float = 30.0) -> List[PodHandle]:
    """Dial every pod member and hello — returns one handle per worker,
    in endpoint order (endpoint order IS host-coordinate order)."""
    handles = []
    for i, (host, port) in enumerate(endpoints):
        conn = Conn.connect(host, int(port), timeout_s=timeout_s,
                            peer=f"pod{i}@{host}:{port}",
                            owner="pod-driver")
        reply, _ = _rpc(conn, {"op": "hello"})
        handles.append(PodHandle(conn, str(reply["worker_id"]),
                                 reply.get("max_frame_bytes")))
    return handles


def run_pull_pod(
    endpoints: Sequence[Tuple[str, int]],
    path: str,
    num_parts: int,
    app: str = "sssp",
    start: int = 0,
    method: str = "auto",
    num_iters: int = 10,
    max_iters: int = 10_000,
    tree: Optional[PlacementTree] = None,
    overlay=None,
    shutdown: bool = True,
) -> dict:
    """Drive one pull computation across a pod of worker processes.

    ``endpoints``: (host, port) per pod member; position in the list is
    the member's host coordinate in ``tree`` (default
    ``PlacementTree.build(num_parts, len(endpoints))``).  ``path`` is a
    ``.lux`` snapshot readable by the DRIVER only; it streams to each
    worker over the wire.  ``overlay`` is an optional ``(OverlayStatic,
    OverlayArrays)`` over the full part stack — rows are sliced to each
    worker by the tree.

    Returns {state, iters, phases, workers}: ``state`` is the stacked
    (P, V, ...) final state (numpy) — bitwise equal to the single-process
    pull engine's — and ``phases`` attributes wall time to plan (stream +
    partial load + init), exchange (frames + assembly) and converge
    (worker compute, max over workers per round).  ``workers`` holds each
    member's parts, compute seconds, resolved method and the kernel
    launches its process made in this run, counted from its pod_build
    (every iteration of an ``auto`` run on the card launches
    ``mxscan_segmented`` in each).
    """
    tree = tree or PlacementTree.build(num_parts, len(endpoints))
    if tree.num_hosts != len(endpoints):
        raise PodError(f"placement tree names {tree.num_hosts} hosts "
                       f"but {len(endpoints)} endpoints were given")
    handles = pod_connect(endpoints)
    t_plan = time.perf_counter()
    bounds = [h.max_frame_bytes for h in handles
              if h.max_frame_bytes is not None]
    chunk = negotiate_chunk_bytes(max_frame_bytes(),
                                  min(bounds) if bounds else None)
    state = None
    V = None
    try:
        for i, h in enumerate(handles):
            token = f"pod-{i}"
            meta = stream_file(h.conn, str(path), token, chunk,
                               rpc=lambda m, _h=h: _rpc(_h.conn, m)[0])
            reply, init_local = _rpc(h.conn, {
                "op": "pod_build", "token": token,
                "sha256": meta["sha256"], "num_parts": int(num_parts),
                "placement": tree.to_wire(), "host": i, "app": app,
                "start": int(start), "method": method})
            h.lo, h.hi = int(reply["lo"]), int(reply["hi"])
            h.method = reply.get("method")
            if (h.lo, h.hi) != (tree.parts_of(i).start,
                                tree.parts_of(i).stop):
                raise PodError(f"pod member {h.worker_id} claims parts "
                               f"[{h.lo},{h.hi}) but the tree assigns "
                               f"{tree.parts_of(i)}")
            V = int(reply["nv_pad"])
            if state is None:
                state = np.zeros((num_parts,) + init_local.shape[1:],
                                 init_local.dtype)
            state[h.lo:h.hi] = init_local
        if len({h.method for h in handles}) > 1:
            raise PodError("pod members resolved different methods: "
                           f"{[h.method for h in handles]}")
        until = app != "pagerank"
        if overlay is not None:
            ostatic, oarrays = overlay
            for h in handles:
                rows = type(oarrays)(
                    *(np.asarray(f)[h.lo:h.hi] for f in oarrays))
                _rpc(h.conn, {"op": "pod_overlay",
                              "cap": int(ostatic.cap),
                              "weighted": bool(ostatic.weighted)},
                     _pack_overlay(rows))
        plan_s = time.perf_counter() - t_plan

        t_loop = time.perf_counter()
        compute_s = 0.0
        iters = 0
        limit = max_iters if until else num_iters
        while iters < limit:
            full = state.reshape((num_parts * V,) + state.shape[2:])
            # fan the round out first (all sends), then drain replies —
            # workers compute concurrently, the driver's recv order is
            # just reply collection
            for h in handles:
                h.conn.send({"op": "pod_step"}, full)
            active = 0
            round_compute = 0.0
            for h in handles:
                reply, new_local = h.conn.recv()
                if not reply.get("ok"):
                    raise PodError(
                        f"pod member {h.worker_id} step failed: "
                        f"{reply.get('err')}")
                state[h.lo:h.hi] = new_local
                active += int(reply["active"])
                h.compute_s += float(reply["compute_s"])
                h.launches = dict(reply.get("launches") or {})
                round_compute = max(round_compute,
                                    float(reply["compute_s"]))
            compute_s += round_compute
            iters += 1
            if until and active == 0:
                break
        converge_s = time.perf_counter() - t_loop
        return {
            "state": state,
            "iters": iters,
            "loop_s": converge_s,
            "phases": {"plan": plan_s,
                       "exchange": max(converge_s - compute_s, 0.0),
                       "converge": compute_s},
            "workers": {h.worker_id: {"lo": h.lo, "hi": h.hi,
                                      "compute_s": h.compute_s,
                                      "method": h.method,
                                      "launches": h.launches}
                        for h in handles},
        }
    finally:
        for h in handles:
            try:
                if shutdown:
                    _rpc(h.conn, {"op": "shutdown"})
            except (PodError, ConnectionClosed, WireError):
                pass
            h.conn.close()


def main(argv=None) -> int:
    """Pod worker process entry: bind, print ONE ready line (JSON:
    worker_id/port/pid) and block until shutdown or SIGTERM.  The graph
    arrives over the wire (stream + pod_build) — there is no --graph
    flag, which is the point.  ``--device cuda`` (the default) without a
    card raises before the READY line: there is no CPU fallback."""
    import argparse
    import signal

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    w = PodWorker(args.worker_id, host=args.host, port=args.port,
                  device=args.device)
    w.start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    print(json.dumps({"ready": True, "worker_id": w.worker_id,
                      "port": w.port, "pid": os.getpid(),
                      "device": str(w.device)}), flush=True)
    try:
        while not stop.is_set() and w._running:
            stop.wait(0.2)
    except KeyboardInterrupt:
        pass
    if w._running:
        w.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
