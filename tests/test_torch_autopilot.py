"""lux_tpu_torch.serve.autopilot against lux_tpu.serve.autopilot, on the CPU.

Held equal across the two packages: the admission policy (validation
messages, JSON both ways, first-match decisions over scripted SLO
verdicts, the mode coding), the hash ring's rebalance preview, and the
autoscaler's actions on one scripted telemetry trace (occupancy, SLO
verdicts, offered load and the previewed move fraction, on a fake clock).
Then the port alone, on live fleets of thread workers with
``device="cpu"``: the autoscaler's hysteresis, cooldown, LIFO retirement,
floor and move budget; the policy's modes gating dispatch; subscriptions
(push, cursor, coalescing); the standby election drill with its split-brain
refusals; the election fence; ``autopilot_soak`` and ``chaos_soak`` at seed
0; ``measure_autoscale`` scaling up and back down; and a worker process
through ``process_spawner``."""
import os

import numpy as np
import pytest

from lux_tpu.serve.autopilot import autoscaler as ref_autoscaler
from lux_tpu.serve.autopilot import policy as ref_policy
from lux_tpu.serve.fleet import hashring as ref_hashring
from lux_tpu_torch import fault, obs
from lux_tpu_torch.fault import drills
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.shards import build_pull_shards
from lux_tpu_torch.models.sssp import bfs_reference
from lux_tpu_torch.obs import dtrace
from lux_tpu_torch.obs.dtrace import _hex_hash
from lux_tpu_torch.obs.recorder import Recorder
from lux_tpu_torch.obs.slo import worst_verdict
from lux_tpu_torch.serve.autopilot import (MODES, AdmissionPolicy, Autoscaler,
                                           AutoscalerConfig, PolicyError, PolicyRule,
                                           Standby, StandbyGroup, SubscriptionClosed,
                                           default_fleet_policy)
from lux_tpu_torch.serve.fleet import hashring
from lux_tpu_torch.serve.fleet.controller import (_POLICY_MODE_CODE, FleetController,
                                                  FleetRejectedError, WorkerRefusedError)
from lux_tpu_torch.serve.fleet.worker import ReplicaWorker
from lux_tpu_torch.serve.live.controller import (LiveFleetController,
                                                 promote_live_controller, start_live_fleet)
from tests.test_dtrace import prom_parse, read_events, spans_by_name

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    dtrace.set_enabled(None)
    fault.uninstall()


@pytest.fixture(scope="module")
def small():
    g = generate.rmat(8, 6, seed=9)
    return g, build_pull_shards(g, 2)


@pytest.fixture()
def rec(tmp_path):
    r = Recorder(run_id="pilot", root=str(tmp_path), enabled=True)
    old = obs.install(r)
    yield r
    r.close()
    obs.install(old)


def _batches(g, n, rows=12, seed=1):
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


# ----------------------------------------------------------------------
# admission policy as data, against the reference
# ----------------------------------------------------------------------


@pytest.mark.parametrize("build", [
    lambda P: P.PolicyRule(mode="panic"),
    lambda P: P.PolicyRule(verdict="meltdown"),
    lambda P: P.AdmissionPolicy(default_mode="panic"),
    lambda P: P.AdmissionPolicy(max_shed_frac=1.5),
    lambda P: P.AdmissionPolicy.from_dict({"rules": [], "surprise": 1}),
    lambda P: P.AdmissionPolicy.from_dict(
        {"rules": [{"slo": "*", "verdict": "warn", "mode": "queue", "extra": True}]}),
    lambda P: P.AdmissionPolicy.from_json("{nope"),
    lambda P: P.AdmissionPolicy.from_dict({"default_mode": "serve"}),
])
def test_policy_refusals_match_reference(build):
    from lux_tpu_torch.serve.autopilot import policy as port_policy

    with pytest.raises(PolicyError) as mine:
        build(port_policy)
    with pytest.raises(ref_policy.PolicyError) as ref:
        build(ref_policy)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_policy_json_crosses_packages(direction):
    mine = default_fleet_policy(max_shed_frac=0.25)
    ref = ref_policy.default_fleet_policy(max_shed_frac=0.25)
    assert mine.to_json() == ref.to_json()
    if direction == "reference_to_port":
        back = AdmissionPolicy.from_json(ref.to_json())
        assert back.to_json() == ref.to_json()
    else:
        back = ref_policy.AdmissionPolicy.from_json(mine.to_json())
        assert back.to_json() == mine.to_json()
    assert back.max_shed_frac == 0.25 and back.name == "default_fleet_policy"


VERDICT_TRACES = [
    [],
    [{"name": "read_latency", "verdict": "ok"}, {"name": "read_freshness", "verdict": "ok"}],
    [{"name": "read_latency", "verdict": "warn"}],
    [{"name": "read_latency", "verdict": "burning"}, {"name": "read_freshness",
                                                      "verdict": "burning"}],
    [{"name": "read_availability", "verdict": "burning"}],
    [{"name": "journal_lag", "verdict": "warn"}, {"name": "write_ack", "verdict": "no_data"}],
]


@pytest.mark.parametrize("rows", VERDICT_TRACES)
def test_policy_decisions_match_reference(rows):
    def custom(P):
        return P.AdmissionPolicy([
            P.PolicyRule(slo="read_freshness", verdict="burning", mode="stale_degrade",
                         note="stale beats absent"),
            P.PolicyRule(slo="read_*", verdict="burning", mode="shed"),
            P.PolicyRule(slo="*", verdict="warn", mode="queue"),
        ])

    from lux_tpu_torch.serve.autopilot import policy as port_policy

    assert default_fleet_policy().decide(rows) == ref_policy.default_fleet_policy().decide(rows)
    assert custom(port_policy).decide(rows) == custom(ref_policy).decide(rows)


def test_mode_code_pin_and_verdicts():
    assert MODES == ref_policy.MODES
    assert _POLICY_MODE_CODE == {m: i for i, m in enumerate(MODES)}
    assert worst_verdict([]) == "no_data"
    pol = AdmissionPolicy([PolicyRule(slo="read_freshness", verdict="burning",
                                      mode="stale_degrade", note="stale beats absent")])
    mode, reason = pol.decide([{"name": "read_freshness", "verdict": "burning"}])
    assert mode == "stale_degrade" and "stale beats absent" in reason


@pytest.mark.parametrize("n", [1, 3])
def test_rebalance_preview_matches_reference(n):
    keys = [f"sssp|g|q{i}" for i in range(256)]
    mine, ref = hashring.HashRing(), ref_hashring.HashRing()
    for i in range(n):
        mine.add(f"w{i}")
        ref.add(f"w{i}")
    assert mine.rebalance_preview(keys, add=["w9"]) == ref.rebalance_preview(keys, add=["w9"])
    assert (mine.rebalance_preview(keys, remove=["w0"])
            == ref.rebalance_preview(keys, remove=["w0"]))


# ----------------------------------------------------------------------
# the autoscaler: one scripted telemetry trace through both packages
# ----------------------------------------------------------------------


class _FakeWorker:
    def __init__(self, wid):
        self.worker_id = wid
        self.port = 0


class _FakeCtl:
    incarnation = "fake-inc"

    def __init__(self, occ=0.0, alive=1, moved_frac=0.1):
        self.occ = occ
        self.n_alive = alive
        self.moved_frac = moved_frac
        self.slo_rows = []
        self.added, self.removed = [], []
        self.counts = {}

    def workers(self):
        return {f"w{i}": {"alive": True, "saturated": False,
                          "last_hb": {"occupancy": self.occ}}
                for i in range(self.n_alive)}

    def slo_status(self):
        return list(self.slo_rows)

    def rebalance_preview(self, add=(), remove=(), app="sssp"):
        return {"total": 256, "moved": int(256 * self.moved_frac),
                "moved_frac": self.moved_frac, "gained": {}, "lost": {},
                "add": list(add), "remove": list(remove)}

    def add_worker(self, host, port, tc=None):
        self.added.append(port)
        self.n_alive += 1

    def remove_worker(self, wid, shutdown=True):
        self.removed.append(wid)
        self.n_alive -= 1

    def _pilot_count(self, key, n=1):
        self.counts[key] = self.counts.get(key, 0) + n


def _scaler(mod, ctl, **cfg_kw):
    for k, v in (("min_workers", 1), ("max_workers", 3), ("up_occupancy", 0.6),
                 ("down_occupancy", 0.15), ("up_consecutive", 2),
                 ("down_consecutive", 2), ("cooldown_s", 10.0)):
        cfg_kw.setdefault(k, v)
    reaped, spawned = [], []

    def spawn(i):
        w = _FakeWorker(f"s{i}")
        spawned.append(w)
        return w

    sc = mod.Autoscaler(ctl, spawn, reap=reaped.append, config=mod.AutoscalerConfig(**cfg_kw))
    return sc, spawned, reaped


#: (time, occupancy, verdict rows, offered qps, moved_frac) a tick
TRACES = {
    "occupancy": [(t, occ, [], None, 0.1) for t, occ in
                  enumerate([0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                             0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])],
    "verdicts_and_knee": (
        [(t, 0.1, [{"name": "read_latency", "verdict": "burning"}], None, 0.1)
         for t in range(3)]
        + [(t, 0.1, [{"name": "read_latency", "verdict": "warn"}], 130.0, 0.1)
           for t in range(3, 16)]
        + [(t, 0.05, [], 20.0, 0.1) for t in range(16, 40)]),
    "move_budget": [(t, 0.9, [], None, 0.8 if t < 6 else 0.3) for t in range(12)],
}


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("cooldown", [0.0, 10.0])
def test_autoscaler_actions_match_reference(trace, cooldown):
    from lux_tpu_torch.serve.autopilot import autoscaler as port_autoscaler

    out = []
    for mod in (port_autoscaler, ref_autoscaler):
        ctl = _FakeCtl(alive=1)
        sc, spawned, reaped = _scaler(mod, ctl, cooldown_s=cooldown, max_move_frac=0.5)
        sc.set_capacity(50.0)
        acts = []
        for t, occ, rows, offered, moved in TRACES[trace]:
            ctl.occ, ctl.slo_rows, ctl.moved_frac = occ, rows, moved
            sc.note_offered_qps(offered)
            acts.append(sc.tick(now=float(t)))
        out.append((acts, ctl.added, ctl.removed, [w.worker_id for w in reaped],
                    ctl.counts, sc.stats()))
    assert out[0] == out[1]
    assert any(a is not None for a in out[0][0])


def test_autoscaler_hysteresis_cooldown_and_bounds():
    from lux_tpu_torch.serve.autopilot import autoscaler as port_autoscaler

    ctl = _FakeCtl(occ=0.9, alive=1)
    sc, _, _ = _scaler(port_autoscaler, ctl)
    assert sc.tick(now=0.0) is None
    act = sc.tick(now=1.0)
    assert act["action"] == "scale_up" and act["worker"] == "s0"
    assert sc.tick(now=2.0) is None and sc.tick(now=5.0) is None  # cooling
    assert sc.tick(now=12.0)["action"] == "scale_up" and ctl.n_alive == 3
    assert sc.tick(now=23.0) is None and sc.tick(now=24.0) is None  # max_workers
    assert [a["seq"] for a in sc.actions()] == [1, 2]


def test_autoscaler_scale_down_lifo_and_floor():
    from lux_tpu_torch.serve.autopilot import autoscaler as port_autoscaler

    ctl = _FakeCtl(occ=0.9, alive=1)
    sc, spawned, reaped = _scaler(port_autoscaler, ctl, cooldown_s=0.0)
    for t in range(4):
        sc.tick(now=float(t))
    assert ctl.n_alive == 3
    ctl.occ = 0.0
    assert sc.tick(now=4.0) is None
    act = sc.tick(now=5.0)
    assert act["action"] == "scale_down" and act["worker"] == "s1"
    assert ctl.removed == ["s1"] and reaped == [spawned[1]]
    sc.tick(now=6.0)
    assert sc.tick(now=7.0)["worker"] == "s0"
    assert sc.tick(now=8.0) is None and sc.tick(now=9.0) is None
    assert ctl.n_alive == 1


def test_autoscaler_config_env_knobs(monkeypatch):
    monkeypatch.setenv("LUX_PILOT_UP_OCC", "0.8")
    monkeypatch.setenv("LUX_PILOT_COOLDOWN_S", "7")
    cfg = AutoscalerConfig()
    assert cfg.up_occupancy == pytest.approx(0.8) and cfg.cooldown_s == pytest.approx(7.0)
    assert AutoscalerConfig(up_occupancy=0.9).up_occupancy == 0.9
    monkeypatch.setenv("LUX_PILOT_UP_OCC", "hot")
    with pytest.raises(ValueError, match="LUX_PILOT_UP_OCC"):
        AutoscalerConfig()
    monkeypatch.delenv("LUX_PILOT_UP_OCC")
    with pytest.raises(ValueError, match="min_workers"):
        AutoscalerConfig(min_workers=3, max_workers=1)
    with pytest.raises(ValueError, match="flap"):
        AutoscalerConfig(up_occupancy=0.3, down_occupancy=0.3)


def test_autoscaler_scale_span_is_keyed_incident(rec):
    from lux_tpu_torch.serve.autopilot import autoscaler as port_autoscaler

    dtrace.set_enabled(True)
    ctl = _FakeCtl(occ=0.9, alive=1)
    sc, _, _ = _scaler(port_autoscaler, ctl)
    sc.tick(now=0.0)
    sc.tick(now=1.0)
    (span,) = spans_by_name(read_events(rec.run_dir()))["pilot.scale"]
    a = span["a"]
    assert a["trace"] == _hex_hash("lux:scale:fake-inc:1", 8)
    assert a["direction"] == "up" and a["worker"] == "s0" and a["seq"] == 1


# ----------------------------------------------------------------------
# the policy and subscriptions on a live fleet
# ----------------------------------------------------------------------


def test_policy_modes_gate_live_dispatch(small, rec):
    g, _sh = small
    dtrace.set_enabled(True)
    fleet = start_live_fleet(1, g, parts=2, cap=1024, standing=(("sssp", 0),),
                             hb_interval_s=0.1, device=CPU)
    ctl = fleet.controller
    try:
        gen = ctl.admit_writes(*_batches(g, 1)[0])["generation"]
        merged = ctl.journal.log.merged_graph()
        f = ctl.submit_retrying(0, deadline_s=60.0)
        assert np.array_equal(f.result(timeout=0), bfs_reference(merged, 0))
        ctl.set_policy(AdmissionPolicy(default_mode="shed"))
        assert ctl.policy_mode() == "shed"
        with pytest.raises(FleetRejectedError):
            ctl.submit(0)
        fams = prom_parse(ctl.prom_dump())
        assert float(fams["lux_pilot_policy_mode"]["samples"][0][2]) == 3
        ctl.set_policy(AdmissionPolicy(default_mode="stale_degrade"))
        f = ctl.submit(0, min_generation=gen + 50)
        assert np.array_equal(f.result(timeout=60.0), bfs_reference(merged, 0))
        assert f.stale is True
        ctl.set_policy(AdmissionPolicy(default_mode="queue"))
        assert np.array_equal(ctl.submit(0).result(timeout=60.0), bfs_reference(merged, 0))
        ctl.set_policy(None)
        assert ctl.policy_mode() == "serve"
        switches = spans_by_name(read_events(rec.run_dir()))["pilot.policy.switch"]
        assert [s["a"]["mode"] for s in switches] == ["shed", "stale_degrade", "queue"]
        assert switches[0]["a"]["trace"] == _hex_hash(f"lux:policy:{ctl.incarnation}:1", 8)
    finally:
        fleet.close()


def test_subscription_push_cursor_and_coalescing(small, rec):
    g, _sh = small
    dtrace.set_enabled(True)
    fleet = start_live_fleet(1, g, parts=2, cap=1024, standing=(("sssp", 0),),
                             hb_interval_s=0.1, device=CPU)
    ctl = fleet.controller
    try:
        sub = ctl.subscribe("sssp")
        b = _batches(g, 3, seed=5)
        ctl.admit_writes(*b[0])
        ctl.refresh_fleet()
        up = sub.get(timeout_s=30.0)
        assert up["app"] == "sssp" and up["generation"] >= 1
        assert sub.cursor == up["generation"] and up["tolerance"] == 0.0
        assert np.array_equal(up["state"], bfs_reference(ctl.journal.log.merged_graph(), 0))
        ctl.admit_writes(*b[1])
        gen3 = ctl.admit_writes(*b[2])["generation"]
        ctl.refresh_fleet()
        while sub.get(timeout_s=30.0)["generation"] < gen3:
            pass
        assert sub.cursor == gen3 and ctl._sub_hub.max_lag() == 0
        fams = prom_parse(ctl.prom_dump())
        assert int(fams["lux_pilot_subscriptions"]["samples"][0][2]) == 1
        assert int(fams["lux_pilot_subscription_pushes_total"]["samples"][0][2]) >= 2
        pushes = [s for s in spans_by_name(read_events(rec.run_dir()))
                  .get("pilot.subscribe.push", ()) if "err" not in s["a"]]
        assert pushes and pushes[-1]["a"]["app"] == "sssp"
        ctl.unsubscribe(sub)
        with pytest.raises(SubscriptionClosed):
            sub.get(timeout_s=1.0)
        sub2 = ctl.subscribe("sssp")
        up2 = sub2.get(timeout_s=30.0)
        assert up2["generation"] == gen3
        assert np.array_equal(up2["state"], bfs_reference(ctl.journal.log.merged_graph(), 0))
    finally:
        fleet.close()


# ----------------------------------------------------------------------
# the election
# ----------------------------------------------------------------------


def test_standby_election_drill(small, tmp_path, rec):
    """A seeded plan kills the controller at its 2nd heartbeat sweep; a
    STANDBY detects the death, wins the incarnation-fenced election and
    promotes: zero acked-write loss, one stitched incident trace, and
    split-brain refused in both directions."""
    g, sh = small
    dtrace.set_enabled(True)
    root = str(tmp_path / "fleet")
    snap = os.path.join(root, "snap.lux")
    fleet = start_live_fleet(2, g, parts=2, cap=1024, standing=(("sssp", 0),),
                             journal_root=root, snapshot_path=snap, hb_interval_s=0.05,
                             device=CPU)
    ctl = fleet.controller
    inc0 = ctl.incarnation
    standbys = []
    try:
        acked = {f"el-{i}": ctl.admit_writes(*b, write_id=f"el-{i}")["generation"]
                 for i, b in enumerate(_batches(g, 3))}
        last = max(acked.values())
        plan = drills.controller_kill_at_heartbeat(nth=2, seed=0)
        plan.bind("kill:controller", ctl.kill)
        group = StandbyGroup()

        def _promote(tc=None):
            endpoints = [("127.0.0.1", w.port) for w in fleet.thread_workers]
            return promote_live_controller(g, os.path.join(root, "controller"), snap,
                                           endpoints, seed=1)

        standbys = [Standby(group, sid, ctl, _promote, hb_interval_s=0.02,
                            death_after_s=0.15, seed=0).start() for sid in (0, 1)]
        with fault.installed(plan):
            got = group.wait_promoted(timeout_s=60.0)
        assert plan.total_fired() == 1 and got is not None
        ctl2, rep = got
        fleet.controller = ctl2
        for s in standbys:
            s.stop()
        assert group.claimed_by(inc0) == 0 and standbys[0].outcome == "won"
        assert group.elections == 1 and ctl2.incarnation != inc0
        assert group.claim(1, inc0) is False
        assert sorted(rep["joined"]) == ["w0", "w1"] and not rep["refused"]
        assert ctl2.generation() >= last
        for wid, gen in acked.items():
            assert ctl2.journal.lookup_write(wid) == gen
        merged = ctl2.journal.log.merged_graph()
        f = ctl2.submit_retrying(0, deadline_s=60.0, min_generation=last)
        assert np.array_equal(f.result(timeout=0), bfs_reference(merged, 0))
        assert "lux_pilot_elections_total 1" in ctl2.prom_dump()
        tid = _hex_hash(f"lux:election:{inc0}", 8)
        by = spans_by_name(read_events(rec.run_dir()))
        assert {s["a"]["standby"] for s in by["pilot.detect"]} == {0, 1}
        for s in by["pilot.detect"] + by["pilot.elect"] + by["pilot.promote"]:
            assert s["a"]["trace"] == tid
        wiped = LiveFleetController(g, journal_dir=str(tmp_path / "wiped"))
        with pytest.raises(WorkerRefusedError, match="behind my own journal"):
            wiped.add_worker("127.0.0.1", fleet.thread_workers[0].port)
        wiped.close()
        ws = ReplicaWorker(sh, worker_id="ws", graph_id="live", q_buckets=(1, 4),
                           device=CPU).start()
        try:
            with pytest.raises(WorkerRefusedError) as ei:
                ctl2.add_worker("127.0.0.1", ws.port)
            assert ei.value.kind == "static"
        finally:
            ws.kill()
    finally:
        for s in standbys:
            s.stop()
        fleet.close()


def test_election_fence_and_retry_after_failed_promotion():
    group = StandbyGroup()
    group.register(2)
    group.register(5)
    assert group.claim(5, "inc-a") is False
    assert group.claim(2, "inc-a") is True
    assert group.claim(2, "inc-a") is False
    group.release(2, "inc-a")
    group.deregister(2)
    assert group.claim(5, "inc-a") is True

    class _DeadCtl:
        incarnation = "dead-1"
        hb_interval_s = 0.01
        hb_timeout_s = 0.05

        def ping(self):
            raise RuntimeError("gone")

    calls = []

    def flaky_promote(tc=None):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("promotion interrupted")
        return _FakeCtl(), {"joined": ["w0"]}

    g2 = StandbyGroup()
    sb = Standby(g2, 0, _DeadCtl(), flaky_promote, seed=3).start()
    got = g2.wait_promoted(timeout_s=30.0)
    sb.stop()
    assert got is not None and len(calls) == 2 and sb.outcome == "won"


def test_wire_incumbent_watches_a_lease(small):
    """A standby watches a controller across the wire through its
    ``serve_lease`` port: the first grant carries the lease terms, and a
    killed controller's lease goes silent."""
    from lux_tpu_torch.serve.autopilot.election import WireIncumbent

    ctl = FleetController(hb_interval_s=0.05, hb_timeout_s=0.5)
    try:
        port = ctl.serve_lease()
        inc = WireIncumbent("127.0.0.1", port, connect_timeout_s=2.0)
        assert inc.incarnation == ctl.incarnation
        assert inc.hb_interval_s == 0.05 and inc.hb_timeout_s == 0.5
        assert inc.ping()["incarnation"] == ctl.incarnation
        ctl.kill()
        with pytest.raises(Exception):
            inc.ping()
        inc.close()
    finally:
        ctl.close()


# ----------------------------------------------------------------------
# the soaks and the autoscale bench
# ----------------------------------------------------------------------


def test_autopilot_soak_fixed_seed(rec):
    from lux_tpu_torch.fault.chaos import autopilot_soak

    dtrace.set_enabled(True)
    report = autopilot_soak(0, steps=3, scale=6, cap=32, rows=8, device=CPU)
    assert report["scale_ups"] >= 1
    assert report["elections"] == 1 and report["winner"] == 0
    assert report["compactions"] >= 1
    assert report["writes"] >= 4 and report["reads"] >= 3
    assert report["sub_delivered"]
    by = spans_by_name(read_events(rec.run_dir()))
    keys = report["incident_keys"]
    etid = _hex_hash(f"lux:{keys['election']}", 8)
    assert {s["a"]["trace"] for s in by["pilot.elect"]} == {etid}
    assert {s["a"]["trace"] for s in by["pilot.scale"]} == {
        _hex_hash(f"lux:{k}", 8) for k in keys["scale"]}


def test_chaos_soak_fixed_seed():
    from lux_tpu_torch.fault.chaos import chaos_soak

    report = chaos_soak(0, device=CPU)
    assert report["steps"] == 16 and report["writes"] >= 1 and report["reads"] >= 1
    assert report["faults_injected"] > 0


def test_autopilot_demo_cli(capsys):
    from lux_tpu_torch.tools import autopilot_demo

    assert autopilot_demo.main(["--seed", "0", "--steps", "3", "--scale", "6", "--cap", "32",
                                "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "the fleet flew itself" in out and "trace=" in out


def test_measure_autoscale_scales_up_then_down_lifo():
    from lux_tpu_torch.serve.fleet.bench import measure_autoscale

    out = measure_autoscale(40.0, scale=7, ef=4, window_s=0.3, overload_levels=3,
                            low_levels=12, cooldown_s=0.2, device=CPU)
    (row,) = out["rows"]
    acts = [a["action"] for a in row["scale_actions"]]
    assert acts == ["scale_up", "scale_down"], row["scale_actions"]
    assert row["scale_actions"][0]["worker"] == row["scale_actions"][1]["worker"] == "w1"
    assert row["workers_after"] == row["workers_before"] == 1
    phases = [lv["phase"] for lv in out["levels"] if "scale_action" in lv]
    assert phases == ["overload", "low"] and out["levels"][0]["phase"] == "warm"
    lost = sum(lv["errors"] + lv["timeouts"] for lv in out["levels"])
    assert lost == 0 and row["shed_bounded"]
    assert row["metric"] == "sssp_autoscale_w1to1_rmat7_cpu" and row["knee_qps"] == 40.0


def _overload_trace(slo, policy, objective_ms, window_s=2.0, service_qps=98.0, base_s=0.25,
                    hb_s=0.1):
    """A warm level at 61.4 QPS and two overloaded ones at 184.1 (half and
    one and a half times a 122.75 QPS knee) into one FIFO server of
    ``service_qps`` whose answers take ``base_s`` more, with the SLO
    windows measure_autoscale sets; the controller's policy is evaluated
    every ``hb_s`` and, in shed mode, a submission is shed (an
    availability-bad observation, as the controller records it).
    Returns each level's (name, submitted, shed) and the mode switches."""
    import heapq

    now = [0.0]
    eng = slo.SLOEngine(slo.default_fleet_slos(
        read_p99_ms=objective_ms, windows=((2.5 * window_s, 10.0), (7.5 * window_s, 2.0))),
        clock=lambda: now[0])
    pol = policy.default_fleet_policy()
    mode, free_at, start = "serve", 0.0, 0.0
    levels, switches = [], [(0.0, "serve")]
    for name, rate in (("warm", 61.4), ("overload", 184.1), ("overload", 184.1)):
        n = int(rate * window_s)
        events = sorted([(start + i / rate, 1) for i in range(n)]
                        + [(start + k * hb_s, 0) for k in range(int(window_s / hb_s))])
        pending, shed, done = [], 0, start
        for t, is_submit in events:
            while pending and pending[0][0] <= t:
                now[0], lat = heapq.heappop(pending)
                eng.observe_query(lat)
            now[0] = t
            if not is_submit:
                mode = pol.decide(eng.status())[0]
                if mode != switches[-1][1]:
                    switches.append((round(t, 3), mode))
            elif mode == "shed":
                shed += 1
                eng.observe_query(None, ok=False)
            else:
                free_at = max(free_at, t) + 1.0 / service_qps
                heapq.heappush(pending, (free_at + base_s, free_at + base_s - t))
        while pending:
            now[0], lat = heapq.heappop(pending)
            done = now[0]
            eng.observe_query(lat)
        levels.append((name, n, shed))
        start = max(done, start + window_s)
    return levels, switches


@pytest.mark.parametrize("objective_ms", [500.0, 2000.0])
def test_overload_trace_sheds_a_level_as_the_reference(objective_ms):
    """The reference's policy and the port's, on one overload trace (the
    autoscale levels at a 122.75 QPS knee, a server of 98 QPS): the same
    mode at every heartbeat.  At the reference's 500 ms read objective the
    first overloaded level's latency burns and the policy sheds the whole
    second level; at measure_autoscale's 2 s objective nothing is shed."""
    from lux_tpu.obs import slo as ref_slo
    from lux_tpu_torch.obs import slo as port_slo
    from lux_tpu_torch.serve.autopilot import policy as port_policy

    mine = _overload_trace(port_slo, port_policy, objective_ms)
    assert mine == _overload_trace(ref_slo, ref_policy, objective_ms)
    levels, switches = mine
    if objective_ms == 500.0:
        assert levels == [("warm", 122, 0), ("overload", 368, 0), ("overload", 368, 368)]
        assert [m for _, m in switches] == ["serve", "queue", "shed"]
    else:
        assert [shed for _, _, shed in levels] == [0, 0, 0] and switches == [(0.0, "serve")]


def test_process_spawner_and_launch_script(small, tmp_path):
    from lux_tpu_torch.graph.format import write_lux
    from lux_tpu_torch.serve.fleet import launcher

    g, _ = small
    snap = str(tmp_path / "g.lux")
    write_lux(snap, g)
    spawn, reap = launcher.process_spawner(
        prefix="as", extra_args=["--graph", snap, "--buckets", "1"], device=CPU)
    h = spawn(3)
    ctl = FleetController(hb_interval_s=0.1)
    try:
        assert h.worker_id == "as3" and h.ready["device"] == "cpu"
        assert ctl.add_worker("127.0.0.1", h.port) == "as3"
        assert np.array_equal(ctl.submit(5).result(timeout=60), bfs_reference(g, 5))
    finally:
        ctl.close()
        reap(h)
    assert not h.alive()
    script = tmp_path / "ready.py"
    script.write_text("import json, os\nprint(json.dumps({'ready': True, 'worker_id': 'x', "
                      "'port': 1, 'pid': os.getpid()}), flush=True)\n")
    h2 = launcher.launch_script(str(script))
    assert h2.worker_id == "x" and h2.ready["port"] == 1
    h2.terminate()
