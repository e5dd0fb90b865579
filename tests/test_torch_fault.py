"""Fault injection in lux_tpu_torch (fault/) against lux_tpu.fault, on the CPU.

FaultPlan JSON written by either package installs in the other and fires
on the same schedule (after / count / seeded prob gates); the named
drills are the reference's plans; the journal's two sites
(``journal.write``, ``journal.before_marker``) fire in the port's
DeltaLog, and the torn-write and kill-before-marker drills replay to the
same committed batches and the same merged graph as the reference's
DeltaLog under the same plan — and each package's journal replays in the
other.
"""
import importlib
import json
import os

import numpy as np
import pytest

from lux_tpu import fault as ref_fault
from lux_tpu.fault import drills as ref_drills
from lux_tpu.fault.plan import FaultPlan as RefPlan
from lux_tpu.graph import generate as ref_generate
from lux_tpu.mutate.deltalog import DeltaLog as RefLog
from lux_tpu_torch import fault
from lux_tpu_torch.fault import drills
from lux_tpu_torch.fault.plan import FaultPlan, FaultPlanError, FaultRule
from lux_tpu_torch.graph import generate
from lux_tpu_torch.mutate.deltalog import DeltaLog

recorder = importlib.import_module("lux_tpu_torch.obs.recorder")


@pytest.fixture(autouse=True)
def _clean():
    fault.uninstall()
    ref_fault.uninstall()
    yield
    fault.uninstall()
    ref_fault.uninstall()


@pytest.fixture(scope="module")
def graphs():
    return generate.rmat(8, 6, seed=9), ref_generate.rmat(8, 6, seed=9)


def _batches(g, n, rows=12, seed=1):
    """n mutation batches of a seeded draw: half deletes of existing
    edges, half random inserts."""
    rng = np.random.default_rng(seed)
    pool = rng.permutation(g.ne)
    dst_of = np.repeat(np.arange(g.nv, dtype=np.int64), np.diff(np.asarray(g.row_ptr)))
    out, lo = [], 0
    for _ in range(n):
        ndel = rows // 2
        dele = pool[lo:lo + ndel]
        lo += ndel
        src = np.concatenate([np.asarray(g.col_idx, np.int64)[dele],
                              rng.integers(0, g.nv, rows - ndel)])
        dst = np.concatenate([dst_of[dele], rng.integers(0, g.nv, rows - ndel)])
        op = np.concatenate([np.zeros(ndel, np.int8), np.ones(rows - ndel, np.int8)])
        out.append((src, dst, op))
    return out


def _schedule(plan, site, n, **ctx):
    return [plan.fire(site, **ctx) is not None for _ in range(n)]


def test_plan_json_round_trips_through_both_and_fires_alike():
    plan = FaultPlan([
        FaultRule("wire.send", "drop", op="query", prob=0.4, note="a"),
        FaultRule("proc", "kill", point="after_delta_before_marker", after=2, count=1),
        FaultRule("proc", "torn", point="journal.write", file="batch_*.npz", count=2),
        FaultRule("wire.recv", "delay", delay_ms=3.0, after=1, count=3),
    ], seed=13, name="mix")
    ref = RefPlan.from_json(plan.to_json())
    back = FaultPlan.from_json(ref.to_json())
    assert json.loads(back.to_json()) == json.loads(plan.to_json()) == json.loads(ref.to_json())
    a, b = FaultPlan.from_json(plan.to_json()), RefPlan.from_json(plan.to_json())
    for site, ctx in (("wire.send", {"op": "query", "peer": "w1"}),
                      ("proc", {"point": "journal.before_marker"}),
                      ("proc", {"point": "journal.write", "file": "batch_00000003.npz"}),
                      ("proc", {"point": "journal.write", "file": "meta.json"}),
                      ("wire.recv", {"op": "hello"})):
        assert _schedule(a, site, 40, **ctx) == _schedule(b, site, 40, **ctx), site
    assert a.counters() == b.counters() and a.total_fired() == b.total_fired()
    with pytest.raises(FaultPlanError, match="not expressible"):
        FaultRule("wire.send", "torn")
    with pytest.raises(FaultPlanError, match="bad plan JSON"):
        FaultPlan.from_json("not json")


@pytest.mark.parametrize("name,args", [
    ("worker_kill_mid_burst", ("w1", 5, 2)), ("kill_before_marker", (None, 2, 4)),
    ("torn_journal_write", (None, "batch_*.npz", 1, 3)),
    ("controller_kill_at_heartbeat", (3, 1)), ("wire_chaos", (11,))])
def test_drills_are_the_reference_plans(name, args):
    mine, ref = getattr(drills, name)(*args), getattr(ref_drills, name)(*args)
    strip = [{k: v for k, v in r.items() if k != "note"} for r in mine.to_dict()["rules"]]
    assert strip == [{k: v for k, v in r.items() if k != "note"}
                     for r in ref.to_dict()["rules"]]
    assert (mine.name, mine.seed) == (ref.name, ref.seed)


def test_env_install_owner_and_the_inject_point(monkeypatch, tmp_path):
    plan_json = FaultPlan([FaultRule("proc", "kill", point="journal.before_marker",
                                     owner="w*")], seed=5, name="envplan").to_json()
    monkeypatch.setenv("LUX_FAULT_PLAN", plan_json)
    monkeypatch.setattr(fault, "_ENV_CHECKED", False)
    monkeypatch.setattr(fault, "_PLAN", None)
    assert fault.active_plan().name == "envplan"
    rec = recorder.Recorder(run_id="f", root=str(tmp_path), enabled=True)
    old = recorder.install(rec)
    try:
        assert fault.ppoint("journal.before_marker") is None  # no owner: no match
        with fault.owner("w2"):
            with pytest.raises(fault.InjectedKill):
                fault.ppoint("journal.before_marker", seq=4)
    finally:
        recorder.install(old)
        rec.close()
    pts = [json.loads(x) for x in open(rec.log_path) if '"fault.inject"' in x]
    assert pts[0]["a"] == {"plan": "envplan", "seed": 5, "site": "proc", "action": "kill",
                           "note": "", "point": "journal.before_marker", "seq": 4,
                           "owner": "w2"}
    assert issubclass(fault.InjectedKill, BaseException)
    assert not issubclass(fault.InjectedKill, Exception)


def _run_drill(cls, pkg, plan_of, g, jd, batches, nth_fail):
    """Apply ``batches`` to a fresh journaled log under the drill plan;
    the ``nth_fail``-th apply (0-based) must die.  Returns nothing: the
    journal on disk is the result."""
    log = cls(g, journal_dir=jd)
    pkg.install(plan_of())
    try:
        for i, b in enumerate(batches):
            if i == nth_fail:
                with pytest.raises(pkg.InjectedKill):
                    log.apply(*b)
                return
            log.apply(*b)
    finally:
        pkg.uninstall()


def _merged(log):
    m = log.merged_graph()
    return np.asarray(m.row_ptr), np.asarray(m.col_idx)


@pytest.mark.parametrize("drill", ["torn_journal_write", "kill_before_marker"])
def test_journal_drills_replay_to_the_references_state(graphs, tmp_path, drill):
    g, rg = graphs
    batches = _batches(g, 4)
    # the third journaled batch dies (the torn one is the third batch
    # npz written; kill_before_marker fires at the third marker window)
    mine = str(tmp_path / "port")
    ref = str(tmp_path / "ref")
    _run_drill(DeltaLog, fault, lambda: getattr(drills, drill)(nth=3) if drill ==
               "torn_journal_write" else drills.kill_before_marker(nth_batch=3),
               g, mine, batches, 2)
    _run_drill(RefLog, ref_fault, lambda: getattr(ref_drills, drill)(nth=3) if drill ==
               "torn_journal_write" else ref_drills.kill_before_marker(nth_batch=3),
               rg, ref, batches, 2)
    if drill == "torn_journal_write":  # half the bytes at the final path, no marker
        assert os.path.getsize(os.path.join(mine, "batch_00000002.npz")) == \
            os.path.getsize(os.path.join(ref, "batch_00000002.npz"))
    assert not os.path.exists(os.path.join(mine, "batch_00000002.ok"))
    # replay: the committed prefix, in each package, from each journal
    for jd in (mine, ref):
        a, b = DeltaLog(g, journal_dir=jd), RefLog(rg, journal_dir=jd)
        assert a.batches_applied == b.batches_applied == 2
        for x, y in zip(_merged(a), _merged(b)):
            np.testing.assert_array_equal(x, y)
    # the unfinished batch's npz is gone, so the sequence number is reused
    assert not os.path.exists(os.path.join(mine, "batch_00000002.npz"))
    again = DeltaLog(g, journal_dir=mine)
    again.apply(*batches[2])
    assert again.batches_applied == 3


def test_injected_kill_mid_resolve_rolls_the_batch_back(graphs, monkeypatch):
    """InjectedKill is a BaseException: a kill while a batch resolves
    restores the pre-batch state, like any other failure."""
    g, _ = graphs
    log = DeltaLog(g)
    b = _batches(g, 2)
    log.apply(*b[0])
    before = (log.del_base.copy(), log.ins_src.copy(), log.ins_live.copy(),
              log.batches_applied)
    calls = {"n": 0}
    orig = DeltaLog._delete_one

    def dying(self, u, v):
        calls["n"] += 1
        if calls["n"] == 3:
            raise fault.InjectedKill("killed mid-resolve")
        return orig(self, u, v)

    monkeypatch.setattr(DeltaLog, "_delete_one", dying)
    with pytest.raises(fault.InjectedKill):
        log.apply(*b[1])
    np.testing.assert_array_equal(log.del_base, before[0])
    np.testing.assert_array_equal(log.ins_src, before[1])
    np.testing.assert_array_equal(log.ins_live, before[2])
    assert log.batches_applied == before[3]
