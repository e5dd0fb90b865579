"""lux_tpu_torch stands alone: importing every module of it loads neither
jax nor any lux_tpu module, builds no kernel and no native library, and
starts no process."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import lux_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(lux_tpu_torch.__path__, "lux_tpu_torch."))
for n in names:
    importlib.import_module(n)
from lux_tpu_torch import native
recorder = importlib.import_module("lux_tpu_torch.obs.recorder")
from lux_tpu_torch.ops import cuda_build
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "lux_tpu" or m.startswith("lux_tpu."))
print(json.dumps({"modules": names, "bad": bad, "libs": sorted(cuda_build._libs),
                  "native": native._lib is not None or native._tried,
                  "recorder": recorder._RECORDER is not None}))
"""


def test_port_imports_no_jax_and_no_lux_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["libs"] == []
    assert res["native"] is False
    assert res["recorder"] is False  # no event log is opened at import
    for name in ("ops.scan", "apps.pagerank", "native", "ops.route", "ops.shuffle",
                 "ops.expand", "ops.spmv", "models.colfilter", "apps.colfilter",
                 "graph.push_shards", "ops.merge_tree", "engine.push", "engine.validate",
                 "models.sssp", "models.components", "apps.sssp", "apps.components",
                 "program.workloads", "utils.preflight", "apps.run",
                 "utils.checkpoint", "engine.delta", "engine.repartition",
                 "engine.stream", "utils.timing", "serve", "serve.batched", "serve.warm",
                 "serve.scheduler", "serve.metrics", "serve.benchmarks", "serve.driver",
                 "utils.roofline", "mutate", "mutate.deltalog", "mutate.overlay",
                 "mutate.graph", "mutate.compact", "mutate.refresh",
                 "obs", "obs.recorder", "obs.dtrace", "obs.slo", "obs.ring", "obs.xprof",
                 "utils.profiling", "fault", "fault.plan", "fault.drills", "tools",
                 "tools.plan_prewarm", "utils.backoff", "parallel", "parallel.placement",
                 "graph.sharded_load", "serve.fleet", "serve.fleet.hashring",
                 "serve.fleet.pubproto", "serve.fleet.wire", "serve.fleet.stream",
                 "serve.fleet.launcher", "serve.fleet.worker", "serve.fleet.controller",
                 "serve.fleet.pod", "serve.fleet.bench", "tools.fleet_bench",
                 "tools.serve_bench", "serve.live", "serve.live.errors",
                 "serve.live.journal", "serve.live.replica", "serve.live.controller",
                 "serve.live.bench", "serve.autopilot", "serve.autopilot.policy",
                 "serve.autopilot.autoscaler", "serve.autopilot.election",
                 "serve.autopilot.subscribe", "analysis", "analysis.proto",
                 "analysis.proto.mc", "analysis.proto.election_model",
                 "analysis.proto.export", "fault.chaos", "tools.autopilot_demo"):
        assert f"lux_tpu_torch.{name}" in res["modules"]
    assert len(res["modules"]) >= 70
