"""The Benes route planner and its native colorer: lux_tpu_torch vs lux_tpu.

Both packages' planners are numpy (plus the C++ colorer, each package
building its own copy), so for the same input and the same colorer the
port's pass arrays must be byte-identical to the reference's.  The native
and numpy colorers may color differently; both must replay the
permutation exactly.
"""
import numpy as np
import pytest

from lux_tpu import native as ref_native
from lux_tpu.ops import route as ref_route
from lux_tpu_torch import native
from lux_tpu_torch.ops import route


def _assert_routes_identical(a, b):
    assert a.n == b.n and tuple(a.dims) == tuple(b.dims)
    assert len(a.passes) == len(b.passes)
    for pa, pb in zip(a.passes, b.passes):
        assert pa.shape == pb.shape and pa.axis == pb.axis
        assert pa.idx.dtype == pb.idx.dtype and pa.idx.tobytes() == pb.idx.tobytes()


@pytest.mark.parametrize("n", [2, 8, 64, 128, 1024, 1 << 14, 1 << 21])
def test_factor_digits_and_axes_match_reference(n):
    assert route.factor_digits(n) == ref_route.factor_digits(n)
    k = len(route.factor_digits(n))
    assert route.benes_axes(k) == ref_route.benes_axes(k)


@pytest.mark.parametrize("dims", [(128,), (128, 8), (128, 128, 2), (128, 128, 128, 8)])
@pytest.mark.parametrize("max_block,max_group", [(1 << 14, 3), (1 << 17, 3), (1024, 2),
                                                 (128, 1)])
def test_fusion_groupings_match_reference(dims, max_block, max_group):
    assert (route.plan_fusion_groups(dims, max_block, max_group)
            == ref_route.plan_fusion_groups(dims, max_block, max_group))
    assert (route.plan_mx_fusion_groups(dims, max_block, max_group, 1024)
            == ref_route.plan_mx_fusion_groups(dims, max_block, max_group, 1024))


@pytest.mark.parametrize("n", [16, 256, 4096, 1 << 15])
def test_build_route_native_matches_reference(n):
    perm = np.random.default_rng(n).permutation(n)
    got = route.build_route(perm)
    _assert_routes_identical(got, ref_route.build_route(perm))
    x = np.random.default_rng(1).random(n)
    np.testing.assert_array_equal(route.apply_route_np(got, x), x[perm])


@pytest.mark.parametrize("n", [64, 2048])
def test_build_route_numpy_colorer_matches_reference(n, monkeypatch):
    """With the native library out of the way both packages run the same
    numpy Euler walk: the same bytes, and the stats say which ran."""
    monkeypatch.setattr(native, "route_color", lambda *a, **k: None)
    monkeypatch.setattr(ref_native, "route_color", lambda *a, **k: None)
    perm = np.random.default_rng(n + 3).permutation(n)
    route.reset_color_stats()
    got = route.build_route(perm)
    assert route.COLOR_STATS["native"] == 0 and route.COLOR_STATS["numpy"] > 0
    _assert_routes_identical(got, ref_route.build_route(perm))


def test_native_and_numpy_colorings_both_replay(monkeypatch):
    n = 1 << 12
    perm = np.random.default_rng(7).permutation(n)
    x = np.arange(n, dtype=np.float64)
    route.reset_color_stats()
    fast = route.build_route(perm)
    assert route.COLOR_STATS == {"native": route.COLOR_STATS["native"], "numpy": 0}
    monkeypatch.setattr(native, "route_color", lambda *a, **k: None)
    slow = route.build_route(perm)
    for r in (fast, slow):
        np.testing.assert_array_equal(route.apply_route_np(r, x), x[perm])


@pytest.mark.parametrize("batches,deg,nside", [(1, 128, 64), (16, 8, 32), (3, 2, 500)])
def test_native_colorer_threads_bitwise(batches, deg, nside):
    """Serial equals threaded, bitwise, and every color class is a
    perfect matching of the regular multigraph."""
    rng = np.random.default_rng(batches * deg)
    n = deg * nside
    u = np.stack([rng.permutation(np.repeat(np.arange(nside), deg)) for _ in range(batches)])
    v = np.stack([rng.permutation(np.repeat(np.arange(nside), deg)) for _ in range(batches)])
    one = native.route_color(u, v, deg, nside, n_threads=1)
    assert one is not None and one.shape == (batches, n) and one.dtype == np.int32
    for t in (2, 4, 7):
        np.testing.assert_array_equal(native.route_color(u, v, deg, nside, n_threads=t), one)
    for b in range(batches):
        for c in range(deg):
            sel = one[b] == c
            assert np.array_equal(np.sort(u[b][sel]), np.arange(nside))
            assert np.array_equal(np.sort(v[b][sel]), np.arange(nside))
    np.testing.assert_array_equal(
        one, ref_native.route_color(u, v, deg, nside, n_threads=1))


def test_native_colorer_rejects_bad_input():
    u = np.zeros((1, 8), np.int64)
    with pytest.raises(ValueError, match="route color failed"):
        native.route_color(u, u + 9, 2, 4)


def test_native_library_builds_into_the_package(monkeypatch):
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("liblux_route-")
    monkeypatch.setenv("LUX_ROUTE_THREADS", "3")
    assert native.route_threads() == 3
    monkeypatch.setenv("LUX_ROUTE_THREADS", "zero")
    with pytest.raises(ValueError, match="LUX_ROUTE_THREADS"):
        native.route_threads()
