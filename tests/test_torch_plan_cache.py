"""The port's routed-plan disk cache (ops/expand ``plan_*_shards_cached``)
on the CPU: entries round-trip, a cached plan replays bitwise the uncached
one and is loaded (not built) the second time, a corrupt or wrong-form
entry is rebuilt and overwritten, an untrusted directory is neither read
nor written, and the port's entries can never be the reference's."""
import os
import stat

import numpy as np
import pytest
import torch

from lux_tpu.ops import expand as ref_expand
from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.models.pagerank import PageRankProgram
from lux_tpu_torch.ops import expand


@pytest.fixture(scope="module")
def shards():
    return build_pull_shards(generate.rmat(8, 6, seed=5), 2)


@pytest.fixture()
def cache(tmp_path):
    d = tmp_path / "plans"
    expand.reset_plan_stats()
    return str(d)


def _same_plan(a, b):
    assert a[0] == b[0]
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_save_load_round_trip(shards, tmp_path):
    for plan in (expand.plan_expand_shards(shards, pf=True),
                 expand.plan_fused_shards(shards, "sum", mx=True)):
        one = (plan[0], tuple(a[0] for a in plan[1]))
        path = str(tmp_path / "entry.npz")
        expand._save_plan(path, one)
        _same_plan(expand._load_plan(path), one)


@pytest.mark.parametrize("family", ["expand", "expand-pf", "fused-pf", "fused-mx", "cf-pf"])
def test_cached_plan_equals_uncached_and_loads(shards, cache, family):
    build = {
        "expand": (lambda: expand.plan_expand_shards(shards),
                   lambda: expand.plan_expand_shards_cached(shards, cache)),
        "expand-pf": (lambda: expand.plan_expand_shards(shards, pf=True),
                      lambda: expand.plan_expand_shards_cached(shards, cache, pf=True)),
        "fused-pf": (lambda: expand.plan_fused_shards(shards, "sum", pf=True),
                     lambda: expand.plan_fused_shards_cached(shards, "sum", cache, pf=True)),
        "fused-mx": (lambda: expand.plan_fused_shards(shards, "max", mx=True),
                     lambda: expand.plan_fused_shards_cached(shards, "max", cache, mx=True)),
        "cf-pf": (lambda: expand.plan_cf_route_shards(shards, pf=True),
                  lambda: expand.plan_cf_route_shards_cached(shards, cache, pf=True)),
    }[family]
    want = build[0]()
    cold = build[1]()
    _same_plan(cold, want)
    built = expand.plan_stats_snapshot()["built"]
    assert built >= 2
    warm = build[1]()
    _same_plan(warm, want)
    stats = expand.plan_stats_snapshot()
    assert stats["built"] == built and stats["loaded"] == 2
    if family == "expand-pf":
        assert expand.has_cached_expand_plan(shards, cache, pf=True) is not None
        # the cached plan drives the engine bitwise as the uncached one
        prog = PageRankProgram(nv=shards.spec.nv)
        arr = to_device(shards.arrays, "cpu")
        s0 = pull.init_state(prog, arr)
        a = pull.run_pull_fixed(prog, shards.spec, arr, s0, 3, route=want)
        b = pull.run_pull_fixed(prog, shards.spec, arr, s0, 3, route=warm)
        assert torch.equal(a, b)


@pytest.mark.parametrize("damage", ["corrupt", "wrong_form"])
def test_bad_entry_is_rebuilt(shards, cache, damage):
    want = expand.plan_expand_shards_cached(shards, cache, pf=True)
    paths = expand.has_cached_expand_plan(shards, cache, pf=True)
    if damage == "corrupt":
        with open(paths[0], "wb") as f:
            f.write(b"not an npz")
    else:  # an unfused entry under the pf family's name
        unfused = expand.plan_expand_shards(shards)
        expand._save_plan(paths[0], (unfused[0], tuple(a[0] for a in unfused[1])))
    expand.reset_plan_stats()
    again = expand.plan_expand_shards_cached(shards, cache, pf=True)
    _same_plan(again, want)
    assert expand.plan_stats_snapshot()["built"] == 1  # the damaged part only
    _same_plan(expand._load_plan(paths[0]), (want[0], tuple(a[0] for a in want[1])))


@pytest.mark.parametrize("how", ["symlink", "group_writable", "other_owner"])
def test_untrusted_dir_neither_read_nor_written(shards, tmp_path, how, monkeypatch):
    real = tmp_path / "real"
    real.mkdir(mode=0o700)
    d = str(real)
    if how == "symlink":
        d = str(tmp_path / "link")
        os.symlink(str(real), d)
    elif how == "group_writable":
        os.chmod(d, 0o770)
    else:
        uid = os.getuid()
        monkeypatch.setattr(os, "getuid", lambda: uid + 1)
    assert not expand._cache_dir_trusted(d)
    want = expand.plan_expand_shards(shards)
    expand.reset_plan_stats()
    got = expand.plan_expand_shards_cached(shards, d)
    _same_plan(got, want)
    assert os.listdir(str(real)) == []
    assert expand.has_cached_expand_plan(shards, d) is None
    # a trusted cache never reads a planted entry from an untrusted dir
    assert expand.plan_stats_snapshot()["loaded"] == 0
    if how == "group_writable":
        assert stat.S_IMODE(os.stat(d).st_mode) == 0o770


def test_port_and_reference_caches_never_meet(shards, tmp_path):
    assert expand._default_cache_dir() != ref_expand._default_cache_dir()
    assert "lux_torch_expand_plans_" in expand._default_cache_dir()
    d = str(tmp_path)
    key_p = expand._expand_key_one(shards)
    key_r = ref_expand._expand_key_one(shards)
    for i in range(2):
        assert expand._entry_path(d, "expand", key_p, i) != \
            ref_expand._entry_path(d, "expand", key_r, i)
