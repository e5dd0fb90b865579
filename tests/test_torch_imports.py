"""lux_tpu_torch stands alone: importing every module of it loads neither
jax nor any lux_tpu module, builds no kernel and starts no process."""
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
from lux_tpu_torch.ops import cuda_build
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "lux_tpu" or m.startswith("lux_tpu."))
print(json.dumps({"modules": names, "bad": bad, "libs": sorted(cuda_build._libs)}))
"""


def test_port_imports_no_jax_and_no_lux_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["libs"] == []
    assert "lux_tpu_torch.ops.scan" in res["modules"]
    assert "lux_tpu_torch.apps.pagerank" in res["modules"]
    assert len(res["modules"]) >= 20
