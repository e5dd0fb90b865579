"""Cold start in lux_tpu_torch, on the CPU: overlapped planning and the plan
disk cache in the apps.

* ``engine/pull.run_pull_fixed_overlapped`` against the reference's with
  a future that is absent, ready, never ready, or resolves after k
  polls (a test double both packages poll the same way): the same state
  and the same ``routed_iters`` (max-label propagation, held bitwise
  across the packages).  Within the port, PageRank's handover to the
  routed expand is bitwise the direct run, a fused plan that resolves
  mid-run finishes direct bitwise, one ready at entry runs fused, and the
  caller's state is never written.
* ``ops/expand.plan_async``: a real background build, its exception
  delivered by ``result()``.
* The apps' plans go through the disk cache: a second run of the same
  app on the same ``LUX_TORCH_PLAN_CACHE`` loads its plan and builds
  nothing, and ``python -m lux_tpu_torch.tools.plan_prewarm`` warms the
  entries the apps then load.
"""
import importlib
import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lux_tpu.engine import pull as ref_pull
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph.shards import build_pull_shards as ref_build
from lux_tpu.models import components as ref_cc
from lux_tpu.ops import expand as ref_expand
from lux_tpu_torch.apps import colfilter, pagerank
from lux_tpu_torch.apps import sssp as sssp_app
from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.models import components as cc
from lux_tpu_torch.models import pagerank as pr
from lux_tpu_torch.ops import expand

recorder = importlib.import_module("lux_tpu_torch.obs.recorder")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 6


class _After:
    """A plan future that resolves after ``k`` direct chunks: both
    drivers poll it once at entry and once before each chunk, so it
    reports ready from its (k + 2)-th poll on (k = -1: ready at entry;
    None: never).  ``result()`` hands the plan over."""

    def __init__(self, plan, k):
        self.plan, self.k, self.polls = plan, k, 0

    def ready(self):
        self.polls += 1
        return self.k is not None and self.polls > self.k + 1

    def result(self, timeout=None):
        assert self.k is not None, "a never-ready future was waited on"
        return self.plan


@pytest.fixture(scope="module")
def pair():
    g, rg = generate.rmat(8, 8, seed=24), ref_generate.rmat(8, 8, seed=24)
    sh, rsh = build_pull_shards(g, 2), ref_build(rg, 2)
    return sh, rsh, to_device(sh.arrays, "cpu"), jax.tree.map(jnp.asarray, rsh.arrays)


FUTURES = {"none": None, "ready": -1, "never": None, "after1": 1, "after3": 3}


@pytest.mark.parametrize("kind", sorted(FUTURES))
@pytest.mark.parametrize("family", ["expand", "fused"])
def test_overlapped_matches_the_reference(pair, kind, family):
    sh, rsh, arrays, rarr = pair
    prog, rprog = cc.MaxLabelProgram(), ref_cc.MaxLabelProgram()
    if family == "expand":
        plan, rplan = expand.plan_expand_shards(sh), ref_expand.plan_expand_shards(rsh)
    else:
        plan, rplan = (expand.plan_fused_shards(sh, "max"),
                       ref_expand.plan_fused_shards(rsh, "max"))
    k = FUTURES[kind]
    fut = None if kind == "none" else _After(plan, k)
    rfut = None if kind == "none" else _After(rplan, k)
    s0 = pull.init_state(prog, arrays)
    keep = s0.clone()
    out, routed = pull.run_pull_fixed_overlapped(prog, sh.spec, arrays, s0, ITERS,
                                                 method="scan", route_future=fut)
    rout, rrouted = ref_pull.run_pull_fixed_overlapped(
        rprog, rsh.spec, rarr, ref_pull.init_state(rprog, rarr), ITERS, method="scan",
        route_future=rfut)
    assert routed == rrouted
    want = {"none": 0, "never": 0, "ready": ITERS,
            "after1": 0 if family == "fused" else ITERS - 1,
            "after3": 0 if family == "fused" else ITERS - 3}[kind]
    assert routed == want
    np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
    assert torch.equal(s0, keep)  # the caller's state is never written


def test_pagerank_handover_is_bitwise_the_direct_run(pair):
    sh, _, arrays, _ = pair
    prog = pr.PageRankProgram(nv=sh.spec.nv)
    s0 = pull.init_state(prog, arrays)
    keep = s0.clone()
    direct = pull.run_pull_fixed(prog, sh.spec, arrays, s0, ITERS, method="scan")
    plans = {"expand-pf": expand.plan_expand_shards(sh, pf=True),
             "fused-pf": expand.plan_fused_shards(sh, "sum", pf=True)}
    for k in (1, 2, 4):
        out, routed = pull.run_pull_fixed_overlapped(
            prog, sh.spec, arrays, s0, ITERS, method="scan",
            route_future=_After(plans["expand-pf"], k))
        assert routed == ITERS - k and torch.equal(out, direct)
        out, routed = pull.run_pull_fixed_overlapped(
            prog, sh.spec, arrays, s0, ITERS, method="scan",
            route_future=_After(plans["fused-pf"], k))
        assert routed == 0 and torch.equal(out, direct)  # finished direct
    out, routed = pull.run_pull_fixed_overlapped(
        prog, sh.spec, arrays, s0, ITERS, method="scan",
        route_future=_After(plans["fused-pf"], -1))
    fused = pull.run_pull_fixed(prog, sh.spec, arrays, s0, ITERS, method="scan",
                                route=plans["fused-pf"])
    assert routed == ITERS and torch.equal(out, fused)
    torch.testing.assert_close(out, direct, rtol=1e-5, atol=1e-7)
    assert torch.equal(s0, keep)


def test_pull_chunk_spans(pair, tmp_path):
    sh, _, arrays, _ = pair
    prog = cc.MaxLabelProgram()
    rec = recorder.Recorder(run_id="chunks", root=str(tmp_path), enabled=True)
    old = recorder.install(rec)
    try:
        pull.run_pull_fixed_overlapped(prog, sh.spec, arrays, pull.init_state(prog, arrays),
                                       ITERS, method="scan", chunk=2,
                                       route_future=_After(expand.plan_expand_shards(sh), 2))
        pull.run_pull_fixed_overlapped(prog, sh.spec, arrays, pull.init_state(prog, arrays),
                                       ITERS, method="scan", chunk=4, route_future=_After(
                                           expand.plan_fused_shards(sh, "max"), 1))
    finally:
        recorder.install(old)
        rec.close()
    begins = [json.loads(x) for x in open(rec.log_path)]
    chunks = [e["a"] for e in begins if e["e"] == "b" and e["n"] == "pull.chunk"]
    assert chunks == [{"k": 2, "done": 0, "routed": False},
                      {"k": 2, "done": 2, "routed": False},
                      {"k": 2, "done": 4, "routed": True},
                      {"k": 4, "done": 0, "routed": False},
                      {"k": 2, "done": 4, "routed": False, "fused_skip": True}]


def test_plan_async_builds_off_the_thread_and_delivers_errors(pair):
    sh = pair[0]
    gate = threading.Event()

    def slow():
        gate.wait(30)
        return expand.plan_expand_shards(sh)

    fut = expand.plan_async(slow)
    assert isinstance(fut, expand.PlanFuture) and not fut.ready()
    gate.set()
    static, arrays = fut.result(timeout=60)
    want = expand.plan_expand_shards(sh)
    assert static == want[0]
    for a, b in zip(arrays, want[1]):
        np.testing.assert_array_equal(a, b)
    assert fut.ready()

    def boom():
        raise KeyError("no plan")

    bad = expand.plan_async(boom)
    with pytest.raises(KeyError):
        bad.result(timeout=60)


def test_overlapped_with_a_real_future(pair):
    """A real background build: whenever it lands, the result is the
    direct run's."""
    sh, _, arrays, _ = pair
    prog = cc.MaxLabelProgram()
    s0 = pull.init_state(prog, arrays)
    direct = pull.run_pull_fixed(prog, sh.spec, arrays, s0, 40, method="scan")

    def slow():
        time.sleep(0.05)
        return expand.plan_expand_shards(sh, pf=True)

    out, routed = pull.run_pull_fixed_overlapped(prog, sh.spec, arrays, s0, 40,
                                                 method="scan",
                                                 route_future=expand.plan_async(slow))
    assert 0 <= routed <= 40 and torch.equal(out, direct)


# ---------------------------------------------------------------------------
# the plan disk cache in the apps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("app,argv", [
    (pagerank, ["--rmat-scale", "8", "-ni", "3", "--route-gather", "expand-pf"]),
    (pagerank, ["--rmat-scale", "8", "-ni", "3", "--route-gather", "fused-mx"]),
    (sssp_app, ["--rmat-scale", "8", "--route-gather", "expand"]),
    (colfilter, ["--rmat-scale", "8", "--rmat-ef", "4", "-ni", "2",
                 "--route-gather", "expand-pf"]),
])
def test_second_app_run_loads_its_plan(app, argv, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("LUX_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    argv = argv + ["--device", "cpu", "-check"]
    expand.reset_plan_stats()
    first = app.run(argv)
    built = expand.plan_stats_snapshot()
    assert first.rc == 0 and built["built"] >= 1 and built["loaded"] == 0
    assert "routed plan built:" in capsys.readouterr().out
    expand.reset_plan_stats()
    second = app.run(argv)
    stats = expand.plan_stats_snapshot()
    assert second.rc == 0 and stats["built"] == 0 and stats["loaded"] >= 1
    out = capsys.readouterr().out
    assert "routed plan loaded:" in out and " s" in out.split("routed plan loaded:")[1]
    first_state = getattr(first, "ranks", getattr(first, "state", None))
    second_state = getattr(second, "ranks", getattr(second, "state", None))
    np.testing.assert_array_equal(first_state, second_state)


def test_plan_prewarm_check_only_then_warm(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, LUX_TORCH_PLAN_CACHE=str(tmp_path / "plans"))

    def prewarm(*extra):
        out = subprocess.run(
            [sys.executable, "-m", "lux_tpu_torch.tools.plan_prewarm", "--scale", "8",
             "--ef", "8", "--kinds", "expand,expand-pf,cf"] + list(extra),
            env=env, cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
        return json.loads(out.stdout.strip().splitlines()[-1])

    cold = prewarm("--check-only")
    assert {k: v["warm"] for k, v in cold["kinds"].items()} == \
        {"expand": False, "expand-pf": False, "cf": False}
    built = prewarm()
    assert built["kinds"]["expand"]["entries_built"] == 1
    assert built["kinds"]["expand-pf"]["entries_loaded"] == 1  # the base entry
    warm = prewarm("--check-only")
    assert all(v["warm"] for v in warm["kinds"].values())
    # the prewarmed entries are the ones the apps load
    os.environ["LUX_TORCH_PLAN_CACHE"] = str(tmp_path / "plans")
    try:
        expand.reset_plan_stats()
        res = pagerank.run(["--rmat-scale", "8", "--rmat-ef", "8", "-ni", "2",
                            "--route-gather", "expand-pf", "--device", "cpu"])
        assert res.rc == 0 and expand.plan_stats_snapshot()["built"] == 0
    finally:
        del os.environ["LUX_TORCH_PLAN_CACHE"]
