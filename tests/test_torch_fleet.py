"""serve/fleet in lux_tpu_torch vs lux_tpu, on the CPU: the hashring
routes every key as the reference does, wire frames are byte-compatible
both ways, snapshots stream and reassemble, and a 2-worker port fleet
(threads, ``device="cpu"``, real loopback sockets) answers SSSP bitwise
and PPR within rtol 1e-5 of the reference's fleet.  Then the fleet's
machinery on the port alone: republish under load with zero shed,
``publish_to_fleet`` after a compaction, shedding at ``max_queue``,
``submit_retrying``, the ``worker_kill_mid_burst``, ``wire_chaos`` and
``controller_kill_at_heartbeat`` drills at their sites, the live hooks'
refusals, no CPU fallback, and one worker process through the launcher."""
import collections
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from lux_tpu.graph import csc as ref_csc
from lux_tpu.graph.shards import build_pull_shards as ref_build_pull
from lux_tpu.serve.fleet import hashring as ref_hashring
from lux_tpu.serve.fleet import pubproto as ref_pubproto
from lux_tpu.serve.fleet import stream as ref_stream
from lux_tpu.serve.fleet import wire as ref_wire
from lux_tpu.serve.fleet.controller import FleetController as RefController
from lux_tpu.serve.fleet.worker import ReplicaWorker as RefWorker
from lux_tpu_torch import fault
from lux_tpu_torch.fault import drills
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.format import write_lux
from lux_tpu_torch.graph.shards import build_pull_shards
from lux_tpu_torch.models.sssp import bfs_reference
from lux_tpu_torch.serve.batched import BatchedEngine
from lux_tpu_torch.serve.fleet import hashring, pubproto, stream, wire
from lux_tpu_torch.serve.fleet.controller import (FleetController, FleetError,
                                                  FleetRejectedError)
from lux_tpu_torch.serve.fleet.worker import ReplicaWorker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HASHRING_PATH = os.path.join(REPO, "lux_tpu_torch", "serve", "fleet", "hashring.py")
SOURCES = [0, 3, 7, 11, 20, 33, 40, 41]
PPR_RTOL = 1e-5


# ----------------------------------------------------------------------
# hashring: the reference's routes
# ----------------------------------------------------------------------


def test_route_key_and_h64_match_reference():
    for app in ("sssp", "ppr"):
        for gid in ("g", "rmat20", "snap.lux"):
            for q in range(0, 1000, 7):
                assert hashring.route_key(app, gid, q) == ref_hashring.route_key(app, gid, q)
    keys = [f"k{i}" for i in range(1000)]
    assert [hashring.h64(k) for k in keys] == [ref_hashring.h64(k) for k in keys]
    slots = {hashring.route_key("sssp", "g", s, slots=16) for s in range(5000)}
    assert len(slots) == 16


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_ring_routes_1000_keys_as_the_reference(n):
    mine, ref = hashring.HashRing(), ref_hashring.HashRing()
    for i in range(n):
        mine.add(f"w{i}")
        ref.add(f"w{i}")
    keys = [hashring.route_key("sssp", "g", q) for q in range(1000)]
    assert mine.table(keys) == ref.table(keys)
    for k in keys[:50]:
        assert mine.successors(k, n) == ref.successors(k, n)
    if n > 1:
        mine.remove("w0")
        ref.remove("w0")
        assert mine.table(keys) == ref.table(keys)
    slot_keys = [f"sssp|g|q{i}" for i in range(hashring.DEFAULT_SLOTS)]
    assert mine.rebalance_preview(slot_keys, add=["wN"]) == \
        ref.rebalance_preview(slot_keys, add=["wN"])


@pytest.mark.parametrize("n_before", [2, 4, 7])
def test_join_and_leave_move_bounded_keys(n_before):
    r = hashring.HashRing()
    for i in range(n_before):
        r.add(f"w{i}")
    keys = [f"sssp|g|q{i}" for i in range(hashring.DEFAULT_SLOTS)]
    before = r.table(keys)
    r.add("wNEW")
    after = r.table(keys)
    moved = [k for k in keys if before[k] != after[k]]
    # every moved key lands ON the joiner, ~1/(R+1) of them (2x slack)
    assert moved and all(after[k] == "wNEW" for k in moved)
    assert len(moved) <= 2 * len(keys) // (n_before + 1)
    r.remove("wNEW")
    assert r.table(keys) == before  # a leave moves exactly the leaver's keys
    prev = r.rebalance_preview(keys, add=["wNEW"])
    assert prev["moved"] == len(moved) and prev["gained"] == {"wNEW": len(moved)}


def test_routing_deterministic_across_processes():
    """A fresh interpreter loading the port's hashring.py STANDALONE (no
    package import, another hash seed) derives the reference's table."""
    r = ref_hashring.HashRing()
    for i in range(4):
        r.add(f"w{i}")
    want = [r.route(ref_hashring.route_key("sssp", "g", s)) for s in range(200)]
    code = ("import importlib.util, json, sys\n"
            "spec = importlib.util.spec_from_file_location('hr', sys.argv[1])\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "r = m.HashRing()\n"
            "for i in range(4): r.add(f'w{i}')\n"
            "print(json.dumps([r.route(m.route_key('sssp', 'g', s)) for s in range(200)]))\n")
    env = dict(os.environ, PYTHONHASHSEED="12345")
    out = subprocess.run([sys.executable, "-c", code, HASHRING_PATH],
                         capture_output=True, text=True, env=env, timeout=60)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == want


# ----------------------------------------------------------------------
# wire frames: byte-compatible both ways
# ----------------------------------------------------------------------


def _frame_bytes(conn_cls, msg, arr):
    a, b = socket.socketpair()
    conn_cls(a).send(msg, arr)
    a.close()
    buf = b""
    while True:
        chunk = b.recv(1 << 16)
        if not chunk:
            break
        buf += chunk
    b.close()
    return buf


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.float64, np.uint8, None])
def test_wire_frames_cross_packages(dtype):
    msg = {"op": "query", "req_id": "r7", "app": "sssp", "source": 41}
    arr = None if dtype is None else (np.arange(257) * 3).astype(dtype).reshape(1, 257)
    assert _frame_bytes(wire.Conn, msg, arr) == _frame_bytes(ref_wire.Conn, msg, arr)
    for send_cls, recv_cls in ((wire.Conn, ref_wire.Conn), (ref_wire.Conn, wire.Conn)):
        a, b = socket.socketpair()
        tx, rx = send_cls(a), recv_cls(b)
        tx.send(msg, arr)
        got_msg, got = rx.recv()
        assert got_msg == msg
        if arr is None:
            assert got is None
        else:
            assert got.dtype == arr.dtype and np.array_equal(got, arr)
        tx.close(), rx.close()


def test_wire_rejects_oversized_and_corrupt_frames():
    a, b = socket.socketpair()
    ca, cb = wire.Conn(a), wire.Conn(b)
    with pytest.raises(wire.WireError):
        ca.send({"x": "y" * (20 * 1024 * 1024)})
    a.sendall(b"\xff" * 12)  # a corrupt length prefix fails loudly
    with pytest.raises(wire.WireError):
        cb.recv()
    ca.close(), cb.close()
    frame = bytearray(_frame_bytes(wire.Conn, {"op": "ans"}, np.arange(64)))
    frame[-40] ^= 0xFF  # flipped bits in the npy DATA: only the crc sees it
    a, b = socket.socketpair()
    a.sendall(bytes(frame))
    with pytest.raises(wire.WireError, match="crc"):
        wire.Conn(b).recv()
    a.close(), b.close()


def test_pubproto_and_chunk_negotiation_match_reference():
    assert pubproto.publish_token("c1x2-ab", "r9") == ref_pubproto.publish_token("c1x2-ab", "r9")
    assert pubproto.ERR_NOTHING_STAGED == ref_pubproto.ERR_NOTHING_STAGED
    assert pubproto.ERR_PREPARE_SUPERSEDED == ref_pubproto.ERR_PREPARE_SUPERSEDED
    assert pubproto.token_mismatch("a", "b") == ref_pubproto.token_mismatch("a", "b")
    for local in (1 << 20, 64 << 20, 200 << 20):
        for remote in (None, 1 << 18, 32 << 20, 128 << 20):
            assert stream.negotiate_chunk_bytes(local, remote) == \
                ref_stream.negotiate_chunk_bytes(local, remote)


def test_streamed_snapshot_reassembles_with_its_digest(tmp_path):
    """A file streamed in chunks over a Conn into a StreamTable comes back
    byte for byte; a wrong digest, a reordered chunk and a short stream
    never finalize."""
    path = tmp_path / "blob.bin"
    path.write_bytes(np.random.default_rng(3).integers(0, 256, 700_001, np.uint8).tobytes())
    a, b = socket.socketpair()
    tx, rx = wire.Conn(a), wire.Conn(b)
    table = stream.StreamTable(prefix="lux-test-")
    sink_box = {}

    def rpc(m):
        sink_box["sink"] = table.begin(m["token"], m["nbytes"], m["chunks"])
        return {"ok": True}

    reader_done = threading.Event()

    def reader():
        for _ in range(3):
            m, arr = rx.recv()
            table.chunk(m["token"], m["seq"], arr)
        reader_done.set()

    t = threading.Thread(target=reader)
    t.start()
    meta = stream.stream_file(tx, str(path), "tok", 256 * 1024, rpc=rpc)
    t.join(30)
    assert reader_done.is_set() and meta["chunks"] == 3
    sink = table.pop("tok")
    with pytest.raises(ValueError, match="digest mismatch"):
        sink.finalize("0" * 64)
    sink = table.begin("t2", meta["nbytes"], meta["chunks"])
    for seq, arr in enumerate(stream.file_chunks(str(path), 256 * 1024)[2]):
        sink.add(seq, arr)
    local = sink.finalize(meta["sha256"])
    assert open(local, "rb").read() == path.read_bytes()
    bad = table.begin("t3", meta["nbytes"], meta["chunks"])
    bad.add(1, np.zeros(4, np.uint8))
    with pytest.raises(ValueError, match="out of order"):
        bad.finalize(meta["sha256"])
    short = table.begin("t4", meta["nbytes"], meta["chunks"])
    short.add(0, np.zeros(4, np.uint8))
    with pytest.raises(ValueError, match="incomplete"):
        short.finalize(meta["sha256"])
    table.clear()
    tx.close(), rx.close()


# ----------------------------------------------------------------------
# the fleet, port against reference
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    g = generate.rmat(8, 4, seed=4)
    return g, build_pull_shards(g, 2)


def _mk_fleet(shards, n=2, graph_id="g", apps=("sssp",), **kw):
    buckets = kw.pop("q_buckets", (1, 4))
    workers = [ReplicaWorker(shards, f"w{i}", graph_id=graph_id, apps=apps,
                             q_buckets=buckets, device="cpu", **kw).start()
               for i in range(n)]
    ctl = FleetController(hb_interval_s=0.1)
    for w in workers:
        ctl.add_worker("127.0.0.1", w.port)
    return ctl, workers


def _teardown(ctl, workers):
    ctl.close()
    for w in workers:
        if w._running:
            w.stop()


def test_fleet_answers_match_reference_fleet(small):
    """SSSP answers through a 2-worker port fleet are bitwise the
    reference fleet's (and the BFS oracle's), PPR within rtol 1e-5; the
    two controllers route every query to the same worker."""
    g, shards = small
    rg = ref_csc.HostGraph(g.nv, g.ne, g.row_ptr.copy(), g.col_idx.copy())
    rshards = ref_build_pull(rg, 2)
    ctl, workers = _mk_fleet(shards, apps=("sssp", "ppr"))
    rworkers = [RefWorker(rshards, f"w{i}", graph_id="g", apps=("sssp", "ppr"),
                          q_buckets=(1, 4)).start() for i in range(2)]
    rctl = RefController(hb_interval_s=0.1)
    try:
        for w in rworkers:
            rctl.add_worker("127.0.0.1", w.port)
        for app in ("sssp", "ppr"):
            futs = [ctl.submit(s, app=app) for s in SOURCES]
            rfuts = [rctl.submit(s, app=app) for s in SOURCES]
            for s, f, rf in zip(SOURCES, futs, rfuts):
                got, want = f.result(timeout=60), np.asarray(rf.result(timeout=120))
                assert got.shape == want.shape == (g.nv,)
                assert f.worker_id == rf.worker_id == ctl.route(s, app) == rctl.route(s, app)
                if app == "sssp":
                    assert got.dtype == want.dtype
                    assert np.array_equal(got, want), s
                    assert np.array_equal(got, bfs_reference(g, s)), s
                else:
                    np.testing.assert_allclose(got, want, rtol=PPR_RTOL, atol=0)
        assert ctl.stats()["completed"] == 2 * len(SOURCES)
        assert ctl.stats()["errors"] == 0
    finally:
        _teardown(ctl, workers)
        rctl.close()
        for w in rworkers:
            w.stop()


def test_heartbeat_prom_and_device_fields(small):
    g, shards = small
    ctl, workers = _mk_fleet(shards, 1)
    try:
        for f in [ctl.submit(s) for s in (0, 3)]:
            f.result(timeout=60)
        hb = workers[0].heartbeat()
        assert hb["max_queue"] == 256 and hb["generation"] == 0
        assert hb["warm_buckets"] == {"sssp": [1, 4]}
        assert hb["completed"] >= 2 and hb["shed_total"] == 0
        assert hb["device"] == "cpu" and "peak_bytes" not in hb
        # a CPU tensor runs every kernel's plain version: nothing counted
        assert set(hb["launches"]) >= {"mxscan_segmented", "spmv_blockcsr"}
        assert workers[0].info()["placement"] == {
            "version": 1, "num_parts": 2,
            "slices": [{"host": 0, "lo": 0, "hi": 2, "devices": 0}]}
        text = ctl.prom_dump()
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("lux_serve_requests_completed_total"))
        assert '{replica="w0"}' in line and int(line.rsplit(" ", 1)[1]) >= 2
        assert text.count("# TYPE lux_serve_requests_completed_total") == 1
    finally:
        _teardown(ctl, workers)


def test_backpressure_sheds_at_max_queue_and_recovers(small):
    g, shards = small
    ctl, workers = _mk_fleet(shards, 2, max_queue=2, max_wait_ms=50.0)
    try:
        shed, futs = 0, []
        for i in range(120):
            try:
                futs.append(ctl.submit(int(i % g.nv)))
            except FleetRejectedError as e:
                shed += 1
                assert e.retry_after_ms > 0
            time.sleep(0.001)  # let the workers' shed replies land
        ok = 0
        for f in futs:  # degraded, never wrong
            try:
                a = f.result(timeout=60)
            except FleetRejectedError:
                shed += 1  # every ring successor was saturated too
                continue
            assert np.array_equal(a, bfs_reference(g, f.source))
            ok += 1
        assert shed > 0, "a flood past 2x2-deep queues must shed"
        assert ok > 0
        st = ctl.stats()
        assert st["shed"] > 0 and st["rerouted"] > 0
        # submit_retrying rides out the saturation: retry_after hints, jitter
        f = ctl.submit_retrying(3, deadline_s=30.0, attempt_timeout_s=10.0)
        assert np.array_equal(f.result(timeout=0), bfs_reference(g, 3))
    finally:
        _teardown(ctl, workers)


def test_submit_retrying_waits_out_an_empty_fleet(small):
    g, shards = small
    ctl = FleetController(hb_interval_s=0.1)
    w = ReplicaWorker(shards, "w0", q_buckets=(1, 4), device="cpu").start()
    try:
        joiner = threading.Timer(0.3, lambda: ctl.add_worker("127.0.0.1", w.port))
        joiner.start()
        f = ctl.submit_retrying(7, deadline_s=30.0)  # NoWorkersError retried
        joiner.join()
        assert np.array_equal(f.result(timeout=0), bfs_reference(g, 7))
        assert f.attempts >= 2 and ctl.stats()["retries"] >= 1
    finally:
        _teardown(ctl, [w])


def test_worker_kill_mid_burst_drill(small):
    """fault/drills.worker_kill_mid_burst at the port's wire.recv site:
    the victim dies at its 5th query frame and every query of the burst
    is answered, correctly, by the survivor."""
    g, shards = small
    ctl, workers = _mk_fleet(shards, 2)
    try:
        srcs = [int(s) % g.nv for s in range(40)]
        victim = collections.Counter(ctl.route(s) for s in srcs).most_common(1)[0][0]
        plan = drills.worker_kill_mid_burst(victim, nth_query=5)
        plan.bind(f"kill:{victim}", next(w for w in workers if w.worker_id == victim).kill)
        with fault.installed(plan):
            futs = [ctl.submit(s) for s in srcs]
            for s, f in zip(srcs, futs):
                assert np.array_equal(f.result(timeout=60), bfs_reference(g, s)), s
        assert plan.total_fired() == 1
        assert plan.counters() == [{"site": "wire.recv", "target": victim,
                                    "action": "kill", "count": 1}]
        st = ctl.stats()
        assert st["worker_deaths"] == 1 and st["rerouted"] >= 1
        survivor = next(w.worker_id for w in workers if w.worker_id != victim)
        assert ctl.live_workers() == [survivor]
        assert sum(f.worker_id == survivor for f in futs) > len(srcs) // 2
    finally:
        _teardown(ctl, workers)


def test_wire_chaos_drill_fires_and_answers_hold(small):
    """fault/drills.wire_chaos at the wire.send/wire.recv sites: dropped
    and delayed query frames, and the retry envelope still answers every
    query correctly."""
    g, shards = small
    ctl, workers = _mk_fleet(shards, 2)
    plan = drills.wire_chaos(seed=5, delay_ms=2.0, delay_prob=0.5, drop_prob=0.3)
    try:
        with fault.installed(plan):
            for s in SOURCES:
                f = ctl.submit_retrying(s, deadline_s=30.0, attempt_timeout_s=0.5)
                assert np.array_equal(f.result(timeout=0), bfs_reference(g, s)), s
            # the controller's scrape counts the installed plan's injections
            assert 'lux_fault_injected_total{site="wire.send"' in ctl.prom_dump()
        fired = {(c["site"], c["action"]) for c in plan.counters()}
        assert ("wire.send", "drop") in fired and ("wire.send", "delay") in fired
    finally:
        _teardown(ctl, workers)


def test_controller_kill_at_heartbeat_drill(small):
    _, shards = small
    ctl, workers = _mk_fleet(shards, 1)
    plan = drills.controller_kill_at_heartbeat(nth=2)
    plan.bind("kill:controller", ctl.kill)
    try:
        with fault.installed(plan):
            deadline = time.monotonic() + 10
            while plan.total_fired() == 0 and time.monotonic() < deadline:
                time.sleep(0.05)
        assert plan.total_fired() == 1
        with pytest.raises(FleetError, match="closed"):
            ctl.ping()
        assert workers[0]._running  # the workers outlive their controller
    finally:
        _teardown(ctl, workers)


# ----------------------------------------------------------------------
# republish and publish_to_fleet
# ----------------------------------------------------------------------


def _churned(g, seed=1):
    """The graph with its first 10 edges removed and 10 new ones added."""
    from lux_tpu_torch.mutate.graph import MutableGraph

    mg = MutableGraph(g, num_parts=2)
    rng = np.random.default_rng(seed)
    dst = g.dst_of_edges()
    mg.apply(g.col_idx[:10], dst[:10], np.zeros(10, np.int8))
    mg.apply(rng.integers(0, g.nv, 10), rng.integers(0, g.nv, 10), np.ones(10, np.int8))
    return mg


class _StallOnce(threading.Event):
    """The heartbeat sweep's sleep, stalled once for ``stall_s`` at its
    ``nth`` wait: the controller itself not running for a while."""

    def __init__(self, nth: int, stall_s: float):
        super().__init__()
        self.calls, self.nth, self.stall_s = 0, nth, stall_s
        self.stalled = threading.Event()

    def wait(self, timeout=None):
        self.calls += 1
        if self.calls == self.nth:
            time.sleep(self.stall_s)
            self.stalled.set()
        return super().wait(timeout)


def _cpu_workers(shards, n=2):
    return [ReplicaWorker(shards, f"w{i}", graph_id="g", apps=("sssp",),
                          q_buckets=(1, 4), device="cpu").start() for i in range(n)]


def test_controller_stall_convicts_no_worker(small):
    """A heartbeat sweep that itself stalls three leases long (the
    controller not running) is no evidence against the workers, which
    speak only when probed: none is retired, and both answer after it."""
    g, shards = small
    workers = _cpu_workers(shards)
    ctl = FleetController(hb_interval_s=0.05, hb_timeout_s=0.5)
    ctl._hb_stop = stall = _StallOnce(nth=3, stall_s=1.5)
    try:
        for w in workers:
            ctl.add_worker("127.0.0.1", w.port)
        assert stall.stalled.wait(timeout=30)
        time.sleep(0.3)  # several sweeps after the stall
        assert ctl.live_workers() == ["w0", "w1"]
        assert ctl.stats()["worker_deaths"] == 0
        for s in SOURCES:
            assert np.array_equal(ctl.submit(s).result(timeout=60), bfs_reference(g, s)), s
    finally:
        _teardown(ctl, workers)


def test_hung_worker_is_convicted_alone(small):
    """A worker that stops answering its probes is retired once one has
    gone unanswered for the lease; the other worker, probed in the same
    sweeps, stays and answers every query."""
    g, shards = small
    workers = _cpu_workers(shards)
    hung, release = workers[0], threading.Event()
    beat = hung.heartbeat
    ctl = FleetController(hb_interval_s=0.05, hb_timeout_s=1.0)
    try:
        for w in workers:
            ctl.add_worker("127.0.0.1", w.port)
        hung.heartbeat = lambda: (release.wait(), beat())[1]
        deadline = time.monotonic() + 30
        while ctl.live_workers() != ["w1"] and time.monotonic() < deadline:
            time.sleep(0.05)
        assert ctl.live_workers() == ["w1"]
        assert ctl.stats()["worker_deaths"] == 1
        for s in SOURCES:
            f = ctl.submit(s)
            assert np.array_equal(f.result(timeout=60), bfs_reference(g, s)), s
            assert f.worker_id == "w1"
    finally:
        release.set()
        _teardown(ctl, workers)


def test_overlapping_stops_run_one_at_a_time(small):
    """A shutdown op's stop thread and a SIGTERM's stop in the worker
    process can overlap. Each teardown step then runs once at a time and
    neither raises (two at once met a listener the other had cleared)."""
    _g, shards = small
    (w,) = _cpu_workers(shards, n=1)
    close, inside, most = w._close_sockets, [0], [0]

    def slow_close():
        inside[0] += 1
        most[0] = max(most[0], inside[0])
        time.sleep(0.2)
        try:
            close()
        finally:
            inside[0] -= 1

    w._close_sockets = slow_close
    errors = []

    def stop():
        try:
            w.stop()
        except Exception as e:  # noqa: BLE001 — the test reports it
            errors.append(e)

    threads = [threading.Thread(target=stop) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and most[0] == 1
    assert w._listener is None and not w._running


def test_republish_under_load_bitwise_and_zero_shed(small, tmp_path):
    """Every answer during a republish is the old graph's or the new
    one's, bitwise; every answer after the commit is the new one's (a
    fresh single-process engine on the snapshot); nothing is shed."""
    g, shards = small
    mg = _churned(g)
    new_g = mg.log.merged_graph()
    snap = str(tmp_path / "new.lux")
    write_lux(snap, new_g)
    old_eng = BatchedEngine(shards, "sssp", 1, device="cpu")
    new_eng = BatchedEngine(build_pull_shards(new_g, 2), "sssp", 1, device="cpu")
    srcs = (0, 3, 7, 11)
    old = {s: old_eng.run([s]).query_state(0) for s in srcs}
    new = {s: new_eng.run([s]).query_state(0) for s in srcs}
    assert any(not np.array_equal(old[s], new[s]) for s in srcs)
    ctl, workers = _mk_fleet(shards, 2)
    try:
        stop, results = threading.Event(), []

        def pump():
            i = 0
            while not stop.is_set():
                s = srcs[i % 4]
                try:
                    results.append((s, ctl.submit(s)))
                except Exception as e:  # noqa: BLE001 — the zero-shed gate reads it
                    results.append((s, e))
                i += 1
                time.sleep(0.005)

        t = threading.Thread(target=pump)
        t.start()
        time.sleep(0.2)
        rep = ctl.republish(snap, graph_id="new.lux")
        time.sleep(0.2)
        stop.set()
        t.join()
        assert rep["generations"] == {"w0": 1, "w1": 1} and rep["retired"] == []
        assert len(results) > 20
        for s, f in results:
            assert not isinstance(f, Exception), f
            a = f.result(timeout=60)
            assert np.array_equal(a, old[s]) or np.array_equal(a, new[s]), s
        st = ctl.stats()
        assert st["shed"] == 0 and st["errors"] == 0 and st["republishes"] == 1
        assert ctl.graph_id == "new.lux"
        for w in workers:
            hb = w.heartbeat()
            assert hb["generation"] == 1 and not hb["staged"]
        for s in srcs:
            assert np.array_equal(ctl.submit(s).result(timeout=60), new[s])
        # a failed prepare aborts with the committed graph still serving
        with pytest.raises(FleetError, match="aborted"):
            ctl.republish(str(tmp_path / "missing.lux"))
        assert all(w.heartbeat()["generation"] == 1 for w in workers)
        assert np.array_equal(ctl.submit(7).result(timeout=60), new[7])
    finally:
        _teardown(ctl, workers)


def test_publish_to_fleet_after_compaction(small, tmp_path):
    """mutate.compact.publish_to_fleet no longer raises: a compacted
    snapshot reaches every worker through the two-phase republish, and
    the fleet then answers the merged graph's BFS."""
    from lux_tpu_torch.mutate.compact import compact_mutable, publish_to_fleet
    from lux_tpu_torch.obs import recorder

    g, shards = small
    mg = _churned(g, seed=2)
    path = str(tmp_path / "compacted.lux")
    compact_mutable(mg, path=path)
    ctl, workers = _mk_fleet(shards, 2)
    try:
        rep = publish_to_fleet(ctl, path)
        assert rep["graph_id"] == "compacted.lux"
        assert rep["generations"] == {"w0": 1, "w1": 1}
        assert recorder().total_count("mutate.publish") >= 1
        for s in SOURCES:
            assert np.array_equal(ctl.submit(s).result(timeout=60),
                                  bfs_reference(mg.base, s)), s
        assert ctl.stats()["shed"] == 0
    finally:
        _teardown(ctl, workers)


# ----------------------------------------------------------------------
# refusals: the live hooks, and no CPU fallback
# ----------------------------------------------------------------------


def test_live_hooks_refuse_naming_the_live_slice(small):
    """The live hooks are ported (serve/live): a STATIC worker answers
    the delta/refresh/read ops with a refusal naming how to start a live
    one (--live / a LiveReplica), and a LIVE worker refuses a prepare
    without the epoch's base_generation, naming the live republish."""
    from lux_tpu_torch.serve.live.replica import LiveReplica

    g, shards = small
    w = ReplicaWorker(shards, "w0", q_buckets=(1,), device="cpu").start()
    live = LiveReplica(g, shards, standing=(), device="cpu")
    lw = ReplicaWorker(shards, "w1", q_buckets=(1,), live=live, device="cpu").start()
    try:
        c = wire.Conn.connect("127.0.0.1", w.port)
        for op in ("delta", "refresh", "read"):
            c.send({"op": op, "req_id": op, "generation": 1},
                   arr=np.zeros((1, 4), np.int64))
            reply, _ = c.recv()
            assert not reply["ok"] and "--live" in reply["err"]
        c.close()
        c = wire.Conn.connect("127.0.0.1", lw.port)
        c.send({"op": "prepare", "req_id": "p", "path": "x.lux"})
        reply, _ = c.recv()
        assert not reply["ok"] and "base_generation" in reply["err"]
        assert "compact_fleet" in reply["err"]
        c.close()
    finally:
        w.stop()
        lw.stop()


def test_no_cpu_fallback_without_a_card(small):
    from lux_tpu_torch.serve.fleet import pod
    from lux_tpu_torch.serve.fleet import worker as worker_mod

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    _, shards = small
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker_mod.main(["--worker-id", "w0", "--rmat", "6,2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pod.main(["--worker-id", "p0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaWorker(shards, "w0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pod.PodWorker("p0")


def test_worker_process_through_the_launcher(tmp_path):
    """The one subprocess test: ``python -m lux_tpu_torch.serve.fleet
    .worker --device cpu`` through the launcher, joined by a controller,
    answering the BFS oracle; SIGTERM reaps it and its private tmpdir."""
    from lux_tpu_torch.serve.fleet import launcher

    g = generate.rmat(8, 4, seed=0)
    snap = str(tmp_path / "g.lux")
    write_lux(snap, g)
    h = launcher.launch_fleet_worker(
        "pw0", ["--graph", snap, "--graph-id", "g", "--buckets", "1,4"], device="cpu")
    ctl = FleetController(hb_interval_s=0.1)
    try:
        assert h.alive() and h.ready["device"] == "cpu" and os.path.isdir(h.tmpdir)
        assert ctl.add_worker("127.0.0.1", h.port) == "pw0"
        for s in (0, 5, 9):
            assert np.array_equal(ctl.submit(s).result(timeout=60), bfs_reference(g, s))
        assert ctl.workers()["pw0"]["alive"]
    finally:
        ctl.close()
        tmp = h.tmpdir
        assert h.terminate() == 0
        assert not os.path.exists(tmp)
