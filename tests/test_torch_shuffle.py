"""The routed replay's planners and kernels: lux_tpu_torch.ops.shuffle vs
lux_tpu.ops.pallas_shuffle, on the CPU.

The reference's Pallas kernels run in interpret mode, as its own suite
runs them.  Plans (statics field by field, arrays byte for byte) must be
identical for equal knobs; every gather is bitwise; the mx reduce is
bitwise for min/max/int32 and within rtol 1e-5 for f32 sums (each side
associates its own way: the reference's per-row one-hot contraction, the
port's plain version an index_add_ over flat ranks).  The port's
pass-fusion budget is shared memory (LUX_PF_SMEM_BYTES) where the
reference's is TPU VMEM, so tests that compare plans pass the same
explicit max_block to both and use arrays small enough that both clamp
the tile to the whole array.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lux_tpu.ops import expand as ref_expand
from lux_tpu.ops import pallas_shuffle as ref_shuf
from lux_tpu.ops import route as ref_route
from lux_tpu_torch.ops import expand, route, shuffle


def _assert_static_equal(a, b):
    """Field by field, across the two packages' dataclasses."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _assert_static_equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_static_equal(x, y)
    else:
        assert a == b, (a, b)


def _assert_arrays_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        y = np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


def _route(n, seed=0):
    perm = np.random.default_rng(seed).permutation(n)
    return perm, route.build_route(perm), ref_route.build_route(perm)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n", [16, 64, 256, 4096])
def test_plan_route_matches_reference(n):
    perm, r, rr = _route(n)
    st, arrs = shuffle.freeze_plan(shuffle.plan_route(r))
    rst, rarrs = ref_shuf.freeze_plan(ref_shuf.plan_route(rr))
    _assert_static_equal(st, rst)
    _assert_arrays_equal(arrs, rarrs)
    assert shuffle.route_num_arrays(st) == ref_shuf.route_num_arrays(rst)
    assert shuffle.route_num_hbm_passes(st) == ref_shuf.route_num_hbm_passes(rst)
    x = np.random.default_rng(2).random(n).astype(np.float32)
    got = shuffle.apply_route_frozen(_t(x), st, [_t(a) for a in arrs])
    want = ref_shuf.apply_route_frozen(jnp.asarray(x), rst,
                                       tuple(jnp.asarray(a) for a in rarrs), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), x[perm])
    kinds = {p.kind for p in st.passes}
    assert kinds == ({"sublane"} if n < 128 else {"lane"})


@pytest.mark.parametrize("rows", [1, 2, 8, 24])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, "bfloat16"])
@pytest.mark.parametrize("idx_dtype", [np.uint8, np.int32])
def test_lane_gather_plain_matches_reference(rows, dtype, idx_dtype):
    rng = np.random.default_rng(rows)
    xv = rng.integers(-1000, 1000, (rows, 128))
    idx = rng.integers(0, 128, (rows, 128)).astype(idx_dtype)
    if dtype == "bfloat16":
        xj = jnp.asarray(xv, jnp.bfloat16)
        x = torch.from_numpy(xv.astype(np.float32)).to(torch.bfloat16)
    else:
        xj = jnp.asarray(xv.astype(dtype))
        x = _t(xv.astype(dtype))
    before = shuffle.lane_gather.launches
    got = shuffle.lane_gather(x, _t(idx))
    assert shuffle.lane_gather.launches == before  # CPU: the plain version
    want = np.asarray(ref_shuf.lane_gather(xj, jnp.asarray(idx), interpret=True))
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("d", [2, 4, 8])
def test_sublane_gather_plain_matches_reference(d):
    rng = np.random.default_rng(d)
    x = rng.random((d, 256)).astype(np.float32)
    idx = rng.integers(0, d, (d, 256)).astype(np.uint8)
    got = shuffle.sublane_gather(_t(x), _t(idx))
    want = ref_shuf.sublane_gather(jnp.asarray(x), jnp.asarray(idx), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_wrappers_reject_bad_inputs():
    x = torch.zeros(2, 128)
    with pytest.raises(ValueError, match="idx shape"):
        shuffle.lane_gather(x, torch.zeros(2, 64, dtype=torch.uint8))
    with pytest.raises(TypeError, match="indices"):
        shuffle.lane_gather(x, torch.zeros(2, 128, dtype=torch.int64))
    with pytest.raises(TypeError, match="moves"):
        shuffle.lane_gather(x.double(), torch.zeros(2, 128, dtype=torch.uint8))
    with pytest.raises(ValueError, match="d <= 8"):
        shuffle.sublane_gather(torch.zeros(9, 4), torch.zeros(9, 4, dtype=torch.uint8))


@pytest.mark.parametrize("n,max_block,max_group", [(1 << 14, 1 << 14, 3), (1 << 14, 1024, 3),
                                                   (1 << 12, 128, 2)])
def test_pf_plans_and_kernel_match_reference(n, max_block, max_group):
    """pf_from_frozen and plan_route_pf: identical plans; every group's
    plain kernel bitwise equal to the reference's kernel; the replay is
    x[perm]."""
    perm, r, rr = _route(n, seed=n)
    st, arrs = shuffle.freeze_plan(shuffle.plan_route(r))
    rst, rarrs = ref_shuf.freeze_plan(ref_shuf.plan_route(rr))
    pst, parr = shuffle.pf_from_frozen(st, arrs, max_block=max_block, max_group=max_group)
    rpst, rparr = ref_shuf.pf_from_frozen(rst, rarrs, max_block=max_block,
                                          max_group=max_group)
    _assert_static_equal(pst, rpst)
    _assert_arrays_equal(parr, rparr)
    direct = shuffle.plan_route_pf(r, max_block=max_block, max_group=max_group)
    _assert_static_equal(direct[0], pst)
    _assert_arrays_equal(direct[1], parr)
    x = np.random.default_rng(3).random(n).astype(np.float32)
    idx = [_t(a.astype(np.uint8)) for a in parr]
    y, yr, i = _t(x), jnp.asarray(x), 0
    for g, rg in zip(pst.groups, rpst.groups):
        y = shuffle._relayout(y, g.view, g.perm_axes).reshape(g.kshape)
        yr = yr.reshape(rg.view)
        yr = (yr.transpose(rg.perm_axes) if rg.perm_axes else yr).reshape(rg.kshape)
        k = len(g.steps)
        y = shuffle.fused_pass_gather(y, idx[i:i + k], g)
        yr = ref_shuf.fused_pass_gather(yr, tuple(jnp.asarray(a) for a in parr[i:i + k]),
                                        group=rg, interpret=True)
        np.testing.assert_array_equal(y.numpy(), np.asarray(yr))
        y, yr, i = y.reshape(-1), yr.reshape(-1), i + k
    got = shuffle.apply_route_frozen(_t(x), pst, idx)
    np.testing.assert_array_equal(got.numpy(), x[perm])


def test_pf_tile_follows_the_smem_budget():
    """Past 128 rows the port's tile stops at the shared-memory budget
    where the reference's grows to its VMEM budget: the index arrays
    stay byte-identical, only block_rows (and the relayout's tile count)
    differ, and both replays are x[perm]."""
    n = 1 << 15
    perm, r, rr = _route(n, seed=9)
    pst, parr = shuffle.plan_route_pf(r, max_block=1 << 14)
    rpst, rparr = ref_shuf.plan_route_pf(rr, max_block=1 << 14)
    _assert_arrays_equal(parr, rparr)
    assert [g.block_rows for g in pst.groups] == [128] * len(pst.groups)
    assert [g.block_rows for g in rpst.groups] == [256] * len(rpst.groups)
    x = np.random.default_rng(5).random(n).astype(np.float32)
    got = shuffle.apply_route_frozen(_t(x), pst, [_t(a) for a in parr])
    want = ref_shuf.apply_route_frozen(jnp.asarray(x), rpst,
                                       tuple(jnp.asarray(a) for a in rparr), interpret=True)
    np.testing.assert_array_equal(got.numpy(), x[perm])
    np.testing.assert_array_equal(np.asarray(want), x[perm])


def test_pf_smem_budget_sets_tile_and_fails_at_plan_time():
    # 2^14-element blocks need 128 rows of 2 x 4-byte buffers: 128 KB
    assert shuffle._pf_block_rows(1 << 17, 128, shuffle.SMEM_BYTES) == 128
    assert shuffle._pf_block_rows(1 << 17, 1, shuffle.SMEM_BYTES) == 128
    assert shuffle._pf_block_rows(32, 1, shuffle.SMEM_BYTES) == 32
    with pytest.raises(ValueError, match="LUX_PF_SMEM_BYTES"):
        shuffle._pf_block_rows(1 << 17, 256, shuffle.SMEM_BYTES)
    assert shuffle._pf_defaults() == (1 << 14, 3, shuffle.SMEM_BYTES)


def test_relayout_desc_reproduces_the_transpose():
    """The step table the kernels read (shift/mask/src_shift per output
    axis) maps every tile position to the element the reference's
    reshape/transpose/reshape puts there."""
    n = 1 << 15
    _, r, _ = _route(n, seed=4)
    st, arrs = shuffle.freeze_plan(shuffle.plan_route(r))
    pst, _ = shuffle.pf_from_frozen(st, arrs, max_block=1 << 14)
    steps = [s for g in pst.groups for s in g.steps if s.relayout is not None]
    assert steps
    for s in steps:
        desc = shuffle._relayout_desc((s,))
        assert desc[0] == 1 and desc[1] == 1
        ndim = desc[2]
        trip = desc[3:3 + 3 * ndim].reshape(ndim, 3)
        rview, rperm = s.relayout
        tile = int(np.prod(rview))
        q = np.arange(tile)
        src = sum(((q >> sh) & mk) << ss for sh, mk, ss in trip)
        want = np.arange(tile).reshape(rview).transpose(rperm).reshape(-1)
        np.testing.assert_array_equal(src, want)


def _mx_case(seed, m=700, nseg=37, ss=500, hub=True):
    rng = np.random.default_rng(seed)
    p = np.ones(nseg)
    if hub:
        p[0] = nseg
    dst = np.repeat(np.arange(nseg), rng.multinomial(m, p / p.sum()))
    src = rng.integers(0, ss, m)
    return src.astype(np.int64), dst.astype(np.int64)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_mxreduce_plain_matches_reference(op, dtype):
    """The mx group of a fused-mx plan, fed the same group-space values:
    the port's plain version against the reference's kernel."""
    src, dst = _mx_case(11)
    st, arr = expand.plan_fused(src, dst, len(src), 500, 64, op, mx=True)
    rst, rarr = ref_expand.plan_fused(src, dst, len(src), 500, 64, op, mx=True)
    _assert_static_equal(st, rst)
    _assert_arrays_equal(arr, rarr)
    mxg, rmxg = st.mx, rst.mx
    *_, mxa = expand.split_fused_arrays(st, arr, st.weighted)
    k = len(mxg.steps)
    rng = np.random.default_rng(12)
    n2 = st.n2
    if dtype == np.int32:
        xv = rng.integers(-2**31, 2**31 - 1, n2, dtype=np.int64).astype(np.int32)
        if op == "sum":
            xv = rng.integers(-1000, 1000, n2).astype(np.int32)
    else:
        xv = (rng.random(n2) + 0.01).astype(np.float32)
    y = shuffle._relayout(_t(xv), mxg.view, mxg.perm_axes).reshape(mxg.kshape)
    yr = jnp.asarray(xv).reshape(rmxg.view)
    yr = (yr.transpose(rmxg.perm_axes) if rmxg.perm_axes else yr).reshape(rmxg.kshape)
    got = shuffle.mxreduce_pass_gather(y, [_t(a) for a in mxa[:k]], _t(mxa[k]),
                                       _t(mxa[k + 1]), mxg).numpy()
    want = np.asarray(ref_shuf.mxreduce_pass_gather(
        yr, tuple(jnp.asarray(a) for a in mxa[:k]), jnp.asarray(mxa[k]),
        jnp.asarray(mxa[k + 1]), jnp.asarray(mxa[k + 2]), group=rmxg, interpret=True))
    total = sum(c for _, c, _ in st.groups)
    assert got.dtype == want.dtype
    if op == "sum" and dtype == np.float32:
        np.testing.assert_allclose(got[:total], want[:total], rtol=1e-5)
    else:
        np.testing.assert_array_equal(got[:total], want[:total])


def test_mxreduce_wrapper_rejects():
    src, dst = _mx_case(13)
    st, arr = expand.plan_fused(src, dst, len(src), 500, 64, "sum", mx=True)
    *_, mxa = expand.split_fused_arrays(st, arr, st.weighted)
    mxg, k = st.mx, len(st.mx.steps)
    y = torch.zeros(mxg.kshape, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        shuffle.mxreduce_pass_gather(y, [_t(a) for a in mxa[:k]], _t(mxa[k]),
                                     _t(mxa[k + 1]), mxg)
    with pytest.raises(ValueError, match="tile_block"):
        shuffle.mxreduce_pass_gather(y.float(), [_t(a) for a in mxa[:k]], _t(mxa[k]),
                                     _t(mxa[k + 1][:-1]), mxg)


def test_mx_knobs_match_reference(monkeypatch):
    assert shuffle._mx_defaults() == ref_shuf._mx_defaults()
    monkeypatch.setenv("LUX_MX_TILE_ROWS", "128")
    with pytest.raises(ValueError, match="LUX_MX_TILE_ROWS"):
        shuffle._mx_defaults()
