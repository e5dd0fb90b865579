"""luxcheck (the reference's static analysis, ``lux_tpu.analysis``) over
the port's kernel modules and the pull engine, which a planner thread
(ops/expand.plan_async) and the schedulers' threads reach beside the
caller, and over the distributed engines (parallel/): no finding.  The
lazily bound kernel libraries and descriptor caches are written under a
lock."""
import os

import pytest

from lux_tpu.analysis import check_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("path", ["lux_tpu_torch/ops/scan.py", "lux_tpu_torch/ops/spmv.py",
                                  "lux_tpu_torch/ops/shuffle.py",
                                  "lux_tpu_torch/ops/expand.py",
                                  "lux_tpu_torch/engine/pull.py",
                                  "lux_tpu_torch/parallel/"])
def test_port_module_is_luxcheck_clean(path):
    findings = check_paths([path], REPO)
    assert not findings, "\n".join(str(f) for f in findings)
