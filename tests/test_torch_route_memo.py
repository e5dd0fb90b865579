"""The route memo of the port's plan cache (ops/route.build_route_memo,
under ops/expand's cached planners) on the CPU: a memoized route is byte
for byte the route build_route colours, the second ask loads it without
colouring, the plan families of one graph colour their shared expand half
once and stay byte for byte the uncached plans, two processes that ask
for one permutation at once colour it once, and a corrupt entry is
coloured again."""
import multiprocessing
import os

import numpy as np
import pytest

from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.shards import build_pull_shards
from lux_tpu_torch.ops import expand, route


def _perm(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).permutation(n)


def _calls() -> int:
    return sum(route.COLOR_STATS.values())


def _same_route(a, b):
    assert (a.n, a.dims, len(a.passes)) == (b.n, b.dims, len(b.passes))
    for p, q in zip(a.passes, b.passes):
        assert (p.shape, p.axis, p.idx.dtype) == (q.shape, q.axis, q.idx.dtype)
        np.testing.assert_array_equal(p.idx, q.idx)


@pytest.mark.parametrize("n", [1 << 10, 1 << 13])
def test_memo_is_the_route_and_loads_the_second_time(tmp_path, n):
    perm = _perm(n, 3)
    want = route.build_route(perm)
    route.reset_color_stats()
    first = route.build_route_memo(perm, str(tmp_path))
    coloured = _calls()
    assert coloured > 0
    again = route.build_route_memo(perm, str(tmp_path))
    assert _calls() == coloured  # loaded, not coloured
    _same_route(first, want)
    _same_route(again, want)
    x = np.arange(n) * 3
    np.testing.assert_array_equal(route.apply_route_np(again, x), x[perm])
    assert route.build_route_memo(_perm(n, 4), None).n == n  # no memo: built
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".npz")]) == 1


def test_corrupt_entry_is_coloured_again(tmp_path, capsys):
    perm = _perm(1 << 10, 5)
    route.build_route_memo(perm, str(tmp_path))
    (entry,) = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    with open(tmp_path / entry, "wb") as f:
        f.write(b"not an npz")
    route.reset_color_stats()
    got = route.build_route_memo(perm, str(tmp_path))
    assert _calls() > 0 and "route memo ignored" in capsys.readouterr().err
    _same_route(got, route.build_route(perm))
    _same_route(route.build_route_memo(perm, str(tmp_path)), got)  # rewritten


def test_plan_families_share_the_expand_half(tmp_path):
    """expand then fused-mx then fused over one cache: the later families
    load the expand half (perm1) the first coloured, and every plan is
    byte for byte its uncached build."""
    sh = build_pull_shards(generate.rmat(9, 6, seed=11), 1)
    route.reset_color_stats()
    want = [expand.plan_expand_shards(sh), expand.plan_fused_shards(sh, "sum", mx=True),
            expand.plan_fused_shards(sh, "sum")]
    fresh = _calls()
    route.reset_color_stats()
    cache = str(tmp_path / "plans")
    got = [expand.plan_expand_shards_cached(sh, cache_dir=cache),
           expand.plan_fused_shards_cached(sh, "sum", cache_dir=cache, mx=True),
           expand.plan_fused_shards_cached(sh, "sum", cache_dir=cache)]
    assert 0 < _calls() < fresh
    assert os.listdir(os.path.join(cache, "routes"))
    for a, b in zip(got, want):
        assert a[0] == b[0] and len(a[1]) == len(b[1])
        for x, y in zip(a[1], b[1]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _memo_calls(perm, path_dir, start):
    route.reset_color_stats()
    start.wait()
    route.build_route_memo(perm, path_dir)
    return _calls()


def test_two_processes_colour_one_permutation_once(tmp_path):
    perm = _perm(1 << 13, 7)
    route.reset_color_stats()
    route.build_route(perm)
    once = _calls()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Manager() as mgr:
        start = mgr.Barrier(2)
        with ctx.Pool(2) as pool:
            calls = pool.starmap(_memo_calls, [(perm, str(tmp_path), start)] * 2)
    assert sorted(calls) == [0, once]
