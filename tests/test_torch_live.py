"""lux_tpu_torch.serve.live against lux_tpu.serve.live, on the CPU.

Seeded RMAT graphs (scale 8, two parts) and one batch sequence feed the
reference (jax) and the port side by side.  Held bitwise: the wire
packing, ``parse_standing``, journal sequencing / reload / the compaction
epoch, journals and ``live_meta.json`` replayed across the two packages in
both directions, a replica killed between delta receipt and its ``.ok``
marker, ``GenerationGap`` and overflow, and ``LiveReplica``'s standing
SSSP / components against the reference's after the same batches; its
standing PageRank within rtol 1e-5 of the reference's, and at a tolerance
band within that band of a float64 oracle.  Then the port's live fleet
(thread workers, ``device="cpu"``, real loopback sockets): read-your-writes,
the fleet refresh bitwise a single-host replica, a mid-replication kill
and rejoin, overflow escalating to a fleet compaction, no stale standing
state across a compaction, the static-worker and split-brain refusals,
the mixed read/write window, one ``--live`` worker process through the
launcher, and no CPU fallback."""
import json
import os
import time

import numpy as np
import pytest
import torch

from lux_tpu.graph import csc as ref_csc
from lux_tpu.graph.shards import build_pull_shards as ref_build_pull
from lux_tpu.mutate.deltalog import DeltaOverflow as RefDeltaOverflow
from lux_tpu.serve.live import journal as ref_journal
from lux_tpu.serve.live.replica import GenerationGap as RefGenerationGap
from lux_tpu.serve.live.replica import LiveReplica as RefLiveReplica
from lux_tpu.serve.live.replica import parse_standing as ref_parse_standing
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.format import read_lux, write_lux
from lux_tpu_torch.graph.shards import build_pull_shards
from lux_tpu_torch.models.pagerank import _host_iteration
from lux_tpu_torch.models.sssp import bfs_reference
from lux_tpu_torch.mutate.deltalog import DeltaLog, DeltaOverflow
from lux_tpu_torch.serve.fleet import wire
from lux_tpu_torch.serve.fleet.controller import (FleetError, StaleReadError,
                                                  WorkerRefusedError)
from lux_tpu_torch.serve.fleet.worker import ReplicaWorker
from lux_tpu_torch.serve.live import journal
from lux_tpu_torch.serve.live.controller import LiveFleetController, start_live_fleet
from lux_tpu_torch.serve.live.errors import REFUSAL_REASONS, GenerationGap
from lux_tpu_torch.serve.live.replica import LiveReplica, parse_standing

CPU = "cpu"
PR_RTOL = 1e-5
STANDING = (("sssp", 0), ("components", None), ("pagerank", None))


def ref_graph(g):
    return ref_csc.HostGraph(g.nv, g.ne, g.row_ptr.copy(), g.col_idx.copy(),
                             None if g.weights is None else g.weights.copy())


@pytest.fixture(scope="module")
def small():
    g = generate.rmat(8, 8, seed=4)
    return g, build_pull_shards(g, 2)


def _batches(g, n, rows=12, seed=1):
    """n random insert/delete batches against ``g`` (deletes target
    distinct base edges so every batch resolves) — the reference test's
    generator."""
    rng = np.random.default_rng(seed)
    dele_pool = rng.permutation(g.ne)
    out, lo = [], 0
    for _ in range(n):
        ndel = rows // 2
        dele = dele_pool[lo:lo + ndel]
        lo += ndel
        src = np.concatenate([np.asarray(g.col_idx, np.int64)[dele],
                              rng.integers(0, g.nv, rows - ndel)])
        dst = np.concatenate([np.asarray(g.dst_of_edges(), np.int64)[dele],
                              rng.integers(0, g.nv, rows - ndel)])
        op = np.concatenate([np.zeros(ndel, np.int8), np.ones(rows - ndel, np.int8)])
        out.append((src, dst, op))
    return out


def _same_graph(a, b):
    return (a.nv == b.nv and np.array_equal(a.row_ptr, b.row_ptr)
            and np.array_equal(a.col_idx, b.col_idx))


# ----------------------------------------------------------------------
# the protocol surface: packing, parse_standing, errors
# ----------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["sssp:7,pagerank", "components", "sssp:0,components,pagerank",
                                  " sssp:3 , ", ""])
def test_parse_standing_matches_reference(spec):
    assert parse_standing(spec) == ref_parse_standing(spec)


@pytest.mark.parametrize("spec", ["bfsish", "sssp:x"])
def test_parse_standing_refusals_match_reference(spec):
    with pytest.raises(ValueError) as mine:
        parse_standing(spec)
    with pytest.raises(ValueError) as ref:
        ref_parse_standing(spec)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("weighted", [False, True])
def test_pack_unpack_bitwise_reference(small, weighted):
    g, _ = small
    s, d, o = _batches(g, 1)[0]
    w = np.arange(len(s)) + 1 if weighted else None
    arr = journal.pack_batch(s, d, o, w)
    ref = ref_journal.pack_batch(s, d, o, w)
    assert arr.dtype == ref.dtype and np.array_equal(arr, ref)
    for a, b in zip(journal.unpack_batch(arr), ref_journal.unpack_batch(ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="rows, 4"):
        journal.unpack_batch(arr[:, :3])
    with pytest.raises(ValueError, match="one length"):
        journal.pack_batch(s, d[:-1], o)


def test_generation_gap_and_refusals_speak_the_reference():
    from lux_tpu.serve.live import errors as ref_errors

    assert REFUSAL_REASONS == ref_errors.REFUSAL_REASONS
    e, r = GenerationGap(3, 5), ref_errors.GenerationGap(3, 5)
    assert (e.have, e.want, str(e)) == (r.have, r.want, str(r))


# ----------------------------------------------------------------------
# the journal
# ----------------------------------------------------------------------


def test_live_journal_sequencing_reload_and_epoch(small, tmp_path):
    g, _sh = small
    jd = str(tmp_path / "ctl")
    J = journal.LiveJournal(g, journal_dir=jd)
    gens = [J.admit(s, d, o) for s, d, o in _batches(g, 3)]
    assert gens == [1, 2, 3]
    assert [gen for gen, _ in J.batches_since(1)] == [2, 3]
    with pytest.raises(KeyError):
        J.payload(4)
    # reload: same generation line, same catch-up stream
    J2 = journal.LiveJournal(g, journal_dir=jd)
    assert J2.generation() == 3
    assert np.array_equal(J2.payload(2), J.payload(2))
    # compaction epoch: base advances, old batches gone, line continues
    snap = str(tmp_path / "snap.lux")
    merged = J.compact(snap)
    assert J.base_generation == 3 and J.generation() == 3
    assert not J.batches_since(3)
    with pytest.raises(KeyError, match="compacted"):
        J.batches_since(0)
    assert J.admit([1], [2], [1]) == 4
    J3 = journal.LiveJournal(read_lux(snap), journal_dir=jd)
    assert J3.base_generation == 3 and J3.generation() == 4
    assert merged.ne == read_lux(snap).ne
    with pytest.raises(ValueError, match="snapshot path"):
        J3.compact()


def test_write_ids_dedup_and_survive_reload(small, tmp_path):
    g, _ = small
    jd = str(tmp_path / "ctl")
    J = journal.LiveJournal(g, journal_dir=jd)
    b = _batches(g, 2)
    assert J.admit(*b[0], write_id="a") == 1
    assert J.admit(*b[1], write_id="a") == 1  # a replay: nothing applied
    assert J.generation() == 1
    assert journal.LiveJournal(g, journal_dir=jd).lookup_write("a") == 1


def test_generation_never_tears_across_compaction(small, monkeypatch):
    """A thread reading the journal's generation while the write path
    swaps in the compacted epoch reads the line before or after the swap,
    never the new base plus the old epoch's batches: a reader started in
    the middle of the swap (where the new epoch's delta-log is built)
    must see 3, not 6."""
    import threading

    g, _ = small
    J = journal.LiveJournal(g)
    for s, d, o in _batches(g, 3):
        J.admit(s, d, o)
    seen, readers = [], []
    real = journal.DeltaLog

    def mid_swap(*a, **k):
        t = threading.Thread(target=lambda: seen.append(J.generation()), daemon=True)
        t.start()
        t.join(timeout=0.2)  # a reader that runs while the swap is open
        readers.append(t)
        return real(*a, **k)

    monkeypatch.setattr(journal, "DeltaLog", mid_swap)
    J.compact()
    for t in readers:
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen == [3] and J.generation() == 3 and J.base_generation == 3


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_replays_across_packages(small, tmp_path, writer):
    """A journal (with a compaction epoch behind it and write ids inside)
    written by either package's LiveJournal replays in the other's:
    same generation line, same payloads, same merged graph, same
    ``live_meta.json``."""
    g, _ = small
    jd, snap = str(tmp_path / "ctl"), str(tmp_path / "snap.lux")
    W = ref_journal.LiveJournal if writer == "reference" else journal.LiveJournal
    R = journal.LiveJournal if writer == "reference" else ref_journal.LiveJournal
    base = ref_graph(g) if writer == "reference" else g
    J = W(base, journal_dir=jd)
    b = _batches(g, 4)
    for i, (s, d, o) in enumerate(b[:2]):
        J.admit(s, d, o, write_id=f"w{i}")
    J.compact(snap)
    merged_base = J.log.base
    for i, (s, d, o) in enumerate(b[2:]):
        live = np.flatnonzero(~J.log.del_base)[:3]
        J.admit(np.concatenate([np.asarray(merged_base.col_idx, np.int64)[live], s[6:]]),
                np.concatenate([np.asarray(merged_base.dst_of_edges(), np.int64)[live],
                                d[6:]]),
                np.concatenate([np.zeros(3, np.int8), o[6:]]), write_id=f"x{i}")
    snap_g = read_lux(snap)
    other = R(snap_g if writer == "reference" else ref_graph(snap_g), journal_dir=jd)
    assert (other.base_generation, other.generation()) == (J.base_generation, J.generation())
    assert (other.base_generation, other.generation()) == (2, 4)
    for gen in (3, 4):
        assert np.array_equal(other.payload(gen), J.payload(gen))
    assert other.lookup_write("x1") == J.lookup_write("x1") == 4
    assert _same_graph(other.log.merged_graph(), J.log.merged_graph())
    with open(os.path.join(jd, "live_meta.json")) as fh:
        assert json.load(fh) == {"format": 1, "base_generation": 2}


# ----------------------------------------------------------------------
# the replica against the reference's
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def replicas(small):
    """The port's and the reference's LiveReplica after the same three
    batches and two refreshes (cold after the first batch, warm after
    the rest)."""
    g, sh = small
    rg = ref_graph(g)
    J = journal.LiveJournal(g)
    for s, d, o in _batches(g, 3):
        J.admit(s, d, o)
    mine = LiveReplica(g, sh, cap=256, standing=STANDING, device=CPU)
    ref = RefLiveReplica(rg, ref_build_pull(rg, 2), cap=256, standing=STANDING)
    for rep in (mine, ref):
        rep.apply_batch(J.payload(1), 1)
        rep.refresh()
        for gen in (2, 3):
            rep.apply_batch(J.payload(gen), gen)
        rep.refresh()
    return J, mine, ref


@pytest.mark.parametrize("app", ["sssp", "components"])
def test_replica_standing_bitwise_reference(replicas, app):
    J, mine, ref = replicas
    a, b = mine.standing(app), ref.standing(app)
    assert a["generation"] == b["generation"] == 3
    assert a["state"].dtype == np.asarray(b["state"]).dtype
    assert np.array_equal(a["state"], np.asarray(b["state"]))
    if app == "sssp":
        assert np.array_equal(a["state"], bfs_reference(J.log.merged_graph(), 0))


def test_replica_standing_pagerank_vs_reference(replicas):
    _J, mine, ref = replicas
    a, b = mine.standing("pagerank"), ref.standing("pagerank")
    assert a["generation"] == b["generation"] == 3
    assert a["tolerance"] == b["tolerance"] == 0.0
    np.testing.assert_allclose(a["state"], np.asarray(b["state"]), rtol=PR_RTOL, atol=0)
    assert mine.stats()["standing"].keys() == ref.stats()["standing"].keys()


def _oracle_fixpoint(merged, iters=200):
    deg = merged.out_degrees().astype(np.float64)
    st = np.where(deg > 0, (1.0 / merged.nv) / np.maximum(deg, 1.0), 1.0 / merged.nv)
    for _ in range(iters):
        st = _host_iteration(merged, st, deg)
    return st


@pytest.mark.parametrize("route", ["none", "expand-pf"])
def test_replica_pagerank_tolerance_band(small, replicas, route):
    """At tolerance > 0 the standing PageRank (cold, then warm after a
    batch) stays within the declared band of the float64 fixpoint, in no
    more iterations than the exact refresh, and rides the read tag."""
    g, sh = small
    J, exact, _ = replicas
    tol = 1e-4
    rep = LiveReplica(g, sh, cap=256, standing=(("pagerank", None),), device=CPU,
                      route_family=route, tolerance=tol)
    for gen in (1, 2, 3):
        rep.apply_batch(J.payload(gen), gen)
    rep.refresh()
    ent = rep.standing("pagerank")
    oracle = _oracle_fixpoint(J.log.merged_graph())
    assert ent["tolerance"] == tol
    assert np.max(np.abs(ent["state"].astype(np.float64) - oracle)) <= tol
    assert ent["iters"] <= exact.standing("pagerank")["iters"] + 1


def test_replica_kill_between_receipt_and_marker_recovers_prefix(
        small, tmp_path, monkeypatch):
    """A worker killed between delta receipt and the .ok marker recovers
    to the EXACT committed prefix and, after catch-up, answers bitwise a
    never-killed replica (and the reference's)."""
    g, sh = small
    J = journal.LiveJournal(g)
    for s, d, o in _batches(g, 3):
        J.admit(s, d, o)
    wd = str(tmp_path / "w")
    rep = LiveReplica(g, sh, cap=256, journal_dir=wd, standing=(("sssp", 0),), device=CPU)
    rep.apply_batch(J.payload(1), 1)
    monkeypatch.setattr(DeltaLog, "_journal_mark",
                        lambda self, seq: (_ for _ in ()).throw(
                            KeyboardInterrupt("killed before marker")))
    with pytest.raises(KeyboardInterrupt):
        rep.apply_batch(J.payload(2), 2)
    monkeypatch.undo()
    rec = LiveReplica(g, sh, cap=256, journal_dir=wd, standing=(("sssp", 0),), device=CPU)
    assert rec.generation() == 1 == rec.servable_generation()
    # the reference replays the same directory to the same prefix
    rg = ref_graph(g)
    assert RefLiveReplica(rg, ref_build_pull(rg, 2), cap=256, journal_dir=wd,
                          standing=()).generation() == 1
    for gen, arr in J.batches_since(rec.generation()):
        rec.apply_batch(arr, gen)
    assert rec.generation() == 3
    clean = LiveReplica(g, sh, cap=256, standing=(("sssp", 0),), device=CPU)
    for gen, arr in J.batches_since(0):
        clean.apply_batch(arr, gen)
    rec.refresh()
    clean.refresh()
    assert np.array_equal(rec.standing("sssp")["state"], clean.standing("sssp")["state"])
    assert np.array_equal(rec.standing("sssp")["state"], bfs_reference(J.log.merged_graph(), 0))


def test_replica_generation_gap_and_overflow_as_reference(small):
    g, sh = small
    rg = ref_graph(g)
    J = journal.LiveJournal(g)
    for s, d, o in _batches(g, 2):
        J.admit(s, d, o)
    rng = np.random.default_rng(7)
    big = journal.pack_batch(rng.integers(0, g.nv, 400), rng.integers(0, g.nv, 400),
                             np.ones(400, np.int8))
    for rep, gap, ovf in ((LiveReplica(g, sh, cap=128, standing=(), device=CPU),
                           GenerationGap, DeltaOverflow),
                          (RefLiveReplica(rg, ref_build_pull(rg, 2), cap=128, standing=()),
                           RefGenerationGap, RefDeltaOverflow)):
        with pytest.raises(gap) as ei:
            rep.apply_batch(J.payload(2), 2)
        assert ei.value.have == 0 and ei.value.want == 2
        rep.apply_batch(J.payload(1), 1)
        with pytest.raises(ovf):
            rep.apply_batch(big, 2)
        assert rep.generation() == 2 and rep.servable_generation() == 1
        assert rep.stats()["delta_occupancy"]["max"] > 128


def test_replica_serving_overlay_bitwise_reference(small):
    g, sh = small
    rg = ref_graph(g)
    J = journal.LiveJournal(g)
    for s, d, o in _batches(g, 2):
        J.admit(s, d, o)
    mine = LiveReplica(g, sh, cap=256, standing=(), device=CPU)
    ref = RefLiveReplica(rg, ref_build_pull(rg, 2), cap=256, standing=())
    for gen in (1, 2):
        oa, da = mine.apply_batch(J.payload(gen), gen)
        ob, db = ref.apply_batch(J.payload(gen), gen)
    for a, b in zip(oa, ob):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(np.asarray(da), np.asarray(db))
    assert mine.overlay_static.cap == ref.overlay_static.cap


def test_live_replica_refuses_cuda_without_a_card(small):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    g, sh = small
    from lux_tpu_torch.serve.fleet import worker as worker_mod

    with pytest.raises(RuntimeError, match="no CUDA device"):
        LiveReplica(g, sh, standing=(("sssp", 0),))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker_mod.main(["--worker-id", "w0", "--rmat", "6,2", "--live"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        start_live_fleet(1, g, parts=2)


# ----------------------------------------------------------------------
# the live fleet (thread workers on the CPU)
# ----------------------------------------------------------------------


def test_live_fleet_read_your_writes(small):
    g, _sh = small
    fleet = start_live_fleet(2, g, parts=2, cap=256, standing=(("sssp", 0),), device=CPU)
    ctl = fleet.controller
    try:
        f = ctl.submit(3)
        assert np.array_equal(f.result(timeout=60), bfs_reference(g, 3))
        assert f.generation == 0
        for s, d, o in _batches(g, 2):
            rep = ctl.admit_writes(s, d, o)
        assert rep["generation"] == 2 and set(rep["acked"]) == {"w0", "w1"}
        merged = ctl.journal.log.merged_graph()
        seen = set()
        for s in (0, 3, 7, 11, 20, 33, 40, 41):
            f = ctl.submit(s, min_generation=2)
            assert np.array_equal(f.result(timeout=60), bfs_reference(merged, s)), s
            assert f.generation >= 2
            seen.add(f.worker_id)
        assert seen == {"w0", "w1"}
        assert ctl.worker_generations() == {"w0": 2, "w1": 2}
        with pytest.raises(StaleReadError):
            ctl.submit(0, min_generation=99)
        text = ctl.prom_dump()
        assert "lux_live_journal_generation 2" in text
        assert 'lux_live_servable_generation{replica="w0"} 2' in text
    finally:
        fleet.close()


def test_live_fleet_refresh_bitwise_vs_single_host(small):
    g, sh = small
    fleet = start_live_fleet(2, g, parts=2, cap=256, standing=STANDING, device=CPU)
    ctl = fleet.controller
    try:
        for s, d, o in _batches(g, 2):
            ctl.admit_writes(s, d, o)
        ctl.refresh_fleet()
        for s, d, o in _batches(g, 2, seed=9):
            gen = ctl.admit_writes(s, d, o)["generation"]
        res = ctl.refresh_fleet()
        assert all(w["generation"] == gen for w in res["workers"].values())
        solo = LiveReplica(g, build_pull_shards(g, 2), cap=256, standing=STANDING,
                           device=CPU)
        for gg, arr in ctl.journal.batches_since(0):
            solo.apply_batch(arr, gg)
        solo.refresh()
        for app in ("sssp", "components", "pagerank"):
            allr = ctl.read_standing_all(app)
            assert set(allr) == {"w0", "w1"}
            ref = solo.standing(app)["state"]
            for wid, ent in allr.items():
                assert ent["generation"] >= gen, (app, wid)
                if app == "pagerank":
                    a = ent["state"].view(np.int32).astype(np.int64)
                    b = ref.view(np.int32).astype(np.int64)
                    assert np.abs(a - b).max() <= 1, (app, wid)
                else:
                    assert np.array_equal(ent["state"], ref), (app, wid)
        assert np.array_equal(ctl.read_standing("sssp")["state"],
                              bfs_reference(ctl.journal.log.merged_graph(), 0))
    finally:
        fleet.close()


def test_live_fleet_mid_replication_kill_and_rejoin(small, tmp_path, monkeypatch):
    g, sh = small
    jroot = str(tmp_path / "j")
    fleet = start_live_fleet(2, g, parts=2, cap=256, journal_root=jroot,
                             standing=(("sssp", 0),), device=CPU)
    ctl = fleet.controller
    try:
        batches = _batches(g, 4)
        ctl.admit_writes(*batches[0])
        w1 = fleet.thread_workers[1]
        orig_mark = DeltaLog._journal_mark

        def boom(self_log, seq):
            if self_log is w1._live.mg.log:
                w1.kill()
                raise OSError("killed between receipt and marker")
            return orig_mark(self_log, seq)

        monkeypatch.setattr(DeltaLog, "_journal_mark", boom)
        rep = ctl.admit_writes(*batches[1])
        monkeypatch.undo()
        assert rep["acked"] == ["w0"]
        deadline = time.monotonic() + 10
        while ctl.live_workers() != ["w0"]:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        rep = ctl.admit_writes(*batches[2])
        assert rep["generation"] == 3 and rep["acked"] == ["w0"]
        merged = ctl.journal.log.merged_graph()
        f = ctl.submit(3, min_generation=3)
        assert np.array_equal(f.result(timeout=60), bfs_reference(merged, 3))
        live2 = LiveReplica(g, sh, cap=256, journal_dir=os.path.join(jroot, "w1"),
                            standing=(("sssp", 0),), device=CPU)
        assert live2.generation() == 1
        w1b = ReplicaWorker(sh, "w1", graph_id="live", q_buckets=(1, 4), live=live2,
                            device=CPU).start()
        fleet.thread_workers.append(w1b)
        ctl.add_worker("127.0.0.1", w1b.port)
        assert ctl.worker_generations() == {"w0": 3, "w1": 3}
        assert ctl.stats()["resyncs"] == 1
        ctl.refresh_fleet()
        allr = ctl.read_standing_all("sssp")
        assert np.array_equal(allr["w0"]["state"], allr["w1"]["state"])
        assert np.array_equal(allr["w1"]["state"], bfs_reference(merged, 0))
        assert allr["w1"]["generation"] == 3
        seen = set()
        for srcv in (0, 3, 7, 11, 20, 33):
            fq = ctl.submit(srcv, min_generation=3)
            assert np.array_equal(fq.result(timeout=60), bfs_reference(merged, srcv))
            seen.add(fq.worker_id)
        assert "w1" in seen
    finally:
        fleet.close()


def test_overflow_escalates_to_fleet_compaction(small, tmp_path):
    g, _sh = small
    snap = str(tmp_path / "snap.lux")
    fleet = start_live_fleet(2, g, parts=2, cap=128, snapshot_path=snap,
                             journal_root=str(tmp_path / "j"), standing=(("sssp", 0),),
                             device=CPU)
    ctl = fleet.controller
    rng = np.random.default_rng(1)
    try:
        rep = None
        for _ in range(3):
            rep = ctl.admit_writes(rng.integers(0, g.nv, 120), rng.integers(0, g.nv, 120),
                                   np.ones(120, np.int8))
            if rep["compacted"]:
                break
        assert rep["compacted"], "cap=128 never overflowed"
        gen = rep["generation"]
        assert ctl.journal.base_generation == gen and os.path.exists(snap)
        assert ctl.stats()["overflow_compactions"] == 1
        assert ctl.stats()["shed"] == 0
        merged = ctl.journal.log.merged_graph()
        f = ctl.submit(3, min_generation=gen)
        assert np.array_equal(f.result(timeout=60), bfs_reference(merged, 3))
        assert f.generation >= gen
        assert ctl.worker_generations() == {"w0": gen, "w1": gen}
        # the answers after it: a fresh engine on the merged snapshot
        from lux_tpu_torch.serve.batched import BatchedEngine

        eng = BatchedEngine(build_pull_shards(read_lux(snap), 2), "sssp", 4, device=CPU)
        srcs = [0, 3, 9, 17]
        want = eng.run(srcs).state
        for i, s in enumerate(srcs):
            assert np.array_equal(ctl.submit(s).result(timeout=60), want[i])
        log = ctl.journal.log
        live_edges = np.flatnonzero(~log.del_base)[:4]
        rep2 = ctl.admit_writes(np.asarray(log.base.col_idx, np.int64)[live_edges],
                                np.asarray(log.base.dst_of_edges(), np.int64)[live_edges],
                                np.zeros(4, np.int8))
        assert rep2["generation"] == gen + 1
    finally:
        fleet.close()


def test_standing_state_not_stale_across_compaction(small, tmp_path):
    g, _sh = small
    snap = str(tmp_path / "snap.lux")
    fleet = start_live_fleet(2, g, parts=2, cap=256, snapshot_path=snap,
                             standing=(("sssp", 0),), device=CPU)
    ctl = fleet.controller
    try:
        batches = _batches(g, 2)
        ctl.admit_writes(*batches[0])
        ctl.refresh_fleet()  # standing converges at generation 1
        ctl.admit_writes(*batches[1])  # generation 2, NOT refreshed
        ctl.compact_fleet()  # epoch base := 2
        ctl.refresh_fleet()
        merged = ctl.journal.log.merged_graph()
        for wid, ent in ctl.read_standing_all("sssp").items():
            assert ent["generation"] == 2, wid
            assert np.array_equal(ent["state"], bfs_reference(merged, 0)), wid
        # a live worker refuses a prepare with no base_generation, and
        # the abort leaves it serving
        with pytest.raises(FleetError, match="base_generation"):
            ctl.republish(snap, graph_id="live")
        assert np.array_equal(ctl.submit(3).result(timeout=60), bfs_reference(merged, 3))
    finally:
        fleet.close()


def test_live_controller_refuses_static_worker(small):
    g, sh = small
    w = ReplicaWorker(sh, "ws", graph_id="live", q_buckets=(1,), device=CPU).start(prewarm=False)
    ctl = LiveFleetController(g)
    try:
        with pytest.raises(WorkerRefusedError, match="not live") as ei:
            ctl.add_worker("127.0.0.1", w.port)
        assert ei.value.kind == "static"
        assert ctl.live_workers() == []
    finally:
        ctl.close()
        if w._running:
            w.stop()


def test_split_brain_guard_both_directions(small, tmp_path):
    """A worker ahead of the controller's journal is refused by the
    controller; a controller behind a worker's own journal is refused by
    the worker (its hello reply names the guard)."""
    g, sh = small
    wd = str(tmp_path / "w")
    live = LiveReplica(g, sh, cap=256, journal_dir=wd, standing=(), device=CPU)
    J = journal.LiveJournal(g)
    for s, d, o in _batches(g, 2):
        J.admit(s, d, o)
    for gen in (1, 2):
        live.apply_batch(J.payload(gen), gen)
    w = ReplicaWorker(sh, "w0", graph_id="live", q_buckets=(1,), live=live,
                      device=CPU).start(prewarm=False)
    ctl = LiveFleetController(g, journal_dir=str(tmp_path / "wiped"))
    try:
        with pytest.raises(WorkerRefusedError, match="behind my own journal"):
            ctl.add_worker("127.0.0.1", w.port)
        c = wire.Conn.connect("127.0.0.1", w.port)
        c.send({"op": "hello", "req_id": "h", "journal_generation": 5})
        reply, _ = c.recv()
        assert reply["ok"] and reply["live"] and reply["journal_generation"] == 2
        c.close()
    finally:
        ctl.close()
        w.stop()


def test_live_ops_on_a_static_worker_and_unknown_app(small):
    """A static worker answers the live ops with a refusal naming --live
    (instead of hanging the caller); a live worker's read of an app it
    never refreshed names the configured apps."""
    g, sh = small
    w = ReplicaWorker(sh, "w0", q_buckets=(1,), device=CPU).start(prewarm=False)
    live = LiveReplica(g, sh, cap=256, standing=(("sssp", 0),), device=CPU)
    lw = ReplicaWorker(sh, "w1", q_buckets=(1,), live=live, device=CPU).start(prewarm=False)
    try:
        c = wire.Conn.connect("127.0.0.1", w.port)
        for op in ("delta", "refresh", "read"):
            c.send({"op": op, "req_id": op}, arr=np.zeros((1, 4), np.int64))
            reply, _ = c.recv()
            assert not reply["ok"] and "not live" in reply["err"], op
        c.close()
        c = wire.Conn.connect("127.0.0.1", lw.port)
        c.send({"op": "read", "req_id": "r", "app": "pagerank"})
        reply, _ = c.recv()
        assert not reply["ok"] and "send a refresh first" in reply["err"]
        c.send({"op": "delta", "req_id": "d", "generation": 1})
        reply, _ = c.recv()
        assert not reply["ok"] and "payload" in reply["err"]
        c.close()
    finally:
        w.stop()
        lw.stop()


def test_mixed_window_counts_bounded_reads(small):
    from lux_tpu_torch.serve.live.bench import churn_batch, measure_live_mixed, mixed_window

    g, _ = small
    rng = np.random.default_rng(0)
    dl = DeltaLog(g)
    s, d, o = churn_batch(dl, rng, 16)
    assert len(s) == 16 and int((o == 0).sum()) == 8
    dl.apply(s, d, o)  # every delete names a live base edge
    fleet = start_live_fleet(2, g, parts=2, cap=512, standing=(("sssp", 0),), device=CPU)
    try:
        win = mixed_window(fleet.controller, [0, 3, 7, 11], np.random.default_rng(1),
                           batch_rows=16, write_batches=3, reader_threads=2,
                           rmw_frac=0.25, min_window_s=0.5)
        assert win["final_acked_generation"] == 3 and win["reads"] > 0
        assert win["bounded_reads"] > 0 and win["bounded_below_bound"] == 0
        assert win["read_errors"] == 0 and win["compactions"] == 0
    finally:
        fleet.close()
    row = measure_live_mixed(scale=7, ef=4, workers=2, batch_rows=16, write_batches=2,
                             reader_threads=1, min_window_s=0.3, device=CPU)
    assert row["metric"] == "sssp_live_w2_rmat7_cpu" and row["value"] > 0
    assert set(row["worker_generations"].values()) == {2}
    assert row["read_errors"] == 0 and row["fleet_refresh_s"] > 0


def test_live_worker_process_through_the_launcher(small, tmp_path):
    """``python -m lux_tpu_torch.serve.fleet.worker --live --device cpu``
    with a journal dir: it joins a live controller, takes writes, and a
    standing read after a refresh is the merged graph's BFS."""
    from lux_tpu_torch.serve.fleet import launcher

    g, _ = small
    snap = str(tmp_path / "g.lux")
    write_lux(snap, g)
    h = launcher.launch_fleet_worker(
        "lw0", ["--graph", snap, "--graph-id", "live", "--parts", "2", "--buckets", "1,4",
                "--live", "--journal-dir", str(tmp_path / "j"), "--standing", "sssp:5,components",
                "--route-gather", "none"], device="cpu")
    ctl = LiveFleetController(g, hb_interval_s=0.1)
    try:
        assert h.ready["delta_generation"] == 0
        assert ctl.add_worker("127.0.0.1", h.port) == "lw0"
        for s, d, o in _batches(g, 2):
            rep = ctl.admit_writes(s, d, o)
        assert rep["acked"] == ["lw0"]
        ctl.refresh_fleet()
        merged = ctl.journal.log.merged_graph()
        ent = ctl.read_standing("sssp")
        assert ent["generation"] == 2 and ent["arg"] == 5
        assert np.array_equal(ent["state"], bfs_reference(merged, 5))
        assert np.array_equal(ctl.submit(9, min_generation=2).result(timeout=60),
                              bfs_reference(merged, 9))
    finally:
        ctl.close(shutdown_workers=True)
        assert h.terminate() == 0
