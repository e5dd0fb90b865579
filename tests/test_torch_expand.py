"""The routed pull: lux_tpu_torch.ops.expand and the engine's route= vs
lux_tpu, on the CPU.

Contract (the reference's own): plans are byte-identical for equal knobs
and colorer (both packages build their native colorer here); the routed
expand is BITWISE equal to the direct gather, pass fusion changes no bit,
fused-pf is bitwise the port's fused, and the fused reduces are bitwise
for min/max/int32.  Float sums associate per package (the port's group
reduce is torch.sum, its mx reduce its own order): rtol 1e-5 against the
reference and the float64 oracle.  The reference's kernels run in
interpret mode.  Both packages read LUX_PF_MAX_BLOCK, so it is pinned to
the port's default for every test here (the reference defaults to a
larger TPU block).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lux_tpu.engine import pull as ref_pull
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph import shards as ref_shards
from lux_tpu.models import pagerank as ref_pr
from lux_tpu.ops import expand as ref_expand
from lux_tpu_torch import convert
from lux_tpu_torch.engine import methods, pull
from lux_tpu_torch.graph import generate, shards
from lux_tpu_torch.models import pagerank as pr
from lux_tpu_torch.ops import expand
from lux_tpu_torch.program import library, spec

ITERS = 4


@pytest.fixture(autouse=True)
def _pf_block(monkeypatch):
    monkeypatch.setenv("LUX_PF_MAX_BLOCK", str(1 << 14))
    for k in ("LUX_ROUTE_MODE", "LUX_REDUCE_MODE", "LUX_ROUTE_IDX8"):
        monkeypatch.delenv(k, raising=False)


def _assert_static_equal(a, b):
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


def _assert_plans_equal(mine, ref):
    _assert_static_equal(mine[0], ref[0])
    assert len(mine[1]) == len(ref[1])
    for x, y in zip(mine[1], ref[1]):
        y = np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tt(arrays):
    return tuple(_t(a) for a in arrays)


def _jj(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _csc(seed, m, nseg, ss, e_pad=None, hub=False):
    """CSC-order (src_pos, dst_local) padded to e_pad like fill_part."""
    rng = np.random.default_rng(seed)
    p = np.ones(nseg)
    if hub:
        p[0] = nseg
    dst = np.repeat(np.arange(nseg), rng.multinomial(m, p / p.sum()))
    src = rng.integers(0, ss, m)
    e_pad = e_pad or m
    sp = np.zeros(e_pad, np.int32)
    dl = np.full(e_pad, nseg, np.int32)
    sp[:m], dl[:m] = src, dst
    return sp, dl


@pytest.mark.parametrize("n,runs", [(128, 5), (1024, 40), (1 << 14, 300)])
def test_fill_forward_matches_reference(n, runs):
    rng = np.random.default_rng(n)
    starts = np.unique(np.concatenate([[0], rng.integers(1, n, runs)]))
    h = starts[np.searchsorted(starts, np.arange(n), side="right") - 1]
    st, arrs = expand.plan_ff(h)
    rst, rarrs = ref_expand.plan_ff(h)
    _assert_plans_equal((st, tuple(arrs)), (rst, rarrs))
    x = rng.random(n).astype(np.float32)
    got = expand.apply_ff(_t(x), st, _tt(expand._narrow_idx(a) for a in arrs)).numpy()
    np.testing.assert_array_equal(got, expand.apply_ff_np(x, h))
    want = ref_expand.apply_ff(jnp.asarray(x), rst, _jj(rarrs), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("e_pad,m,ss", [(256, 200, 90), (2048, 2000, 3000), (5000, 4321, 777)])
def test_expand_plan_and_replay_match_reference(e_pad, m, ss):
    sp, _ = _csc(e_pad, m, 50, ss, e_pad)
    plan = expand.plan_expand(sp, m, ss)
    rplan = ref_expand.plan_expand(sp, m, ss)
    _assert_plans_equal(plan, rplan)
    x = np.random.default_rng(1).random(ss).astype(np.float32)
    got = expand.apply_expand(_t(x), plan[0], _tt(plan[1])).numpy()
    np.testing.assert_array_equal(got[:m], x[sp[:m]])
    want = ref_expand.apply_expand(jnp.asarray(x), rplan[0], _jj(rplan[1]), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    pf = expand.to_pf(plan)
    _assert_plans_equal(pf, ref_expand.to_pf(rplan))
    np.testing.assert_array_equal(expand.apply_expand(_t(x), pf[0], _tt(pf[1])).numpy(), got)


def _fused_inputs(op, dtype, ss, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        lo, hi = (-1000, 1000) if op == "sum" else (-2**31, 2**31 - 1)
        return rng.integers(lo, hi, ss, dtype=np.int64).astype(np.int32)
    return (rng.random(ss) + 0.01).astype(np.float32)


def _oracle(sp, dl, m, x, nseg, op):
    vals = np.asarray(x, np.float64)[sp[:m]]
    out = np.full(nseg, 0.0 if op == "sum" else (np.inf if op == "min" else -np.inf))
    {"sum": np.add, "min": np.minimum, "max": np.maximum}[op].at(out, dl[:m], vals)
    return out


@pytest.mark.parametrize("mx", [False, True])
@pytest.mark.parametrize("op,dtype", [("sum", np.float32), ("min", np.float32),
                                      ("max", np.float32), ("sum", np.int32),
                                      ("min", np.int32), ("max", np.int32)])
def test_fused_plan_and_apply_match_reference(mx, op, dtype):
    m, nseg, ss = 1500, 61, 900
    sp, dl = _csc(7, m, nseg, ss, 1536, hub=True)
    plan = expand.plan_fused(sp, dl, m, ss, 128, op, mx=mx)
    rplan = ref_expand.plan_fused(sp, dl, m, ss, 128, op, mx=mx)
    _assert_plans_equal(plan, rplan)
    x = _fused_inputs(op, dtype, ss, 8)
    got = expand.apply_fused(_t(x), plan[0], _tt(plan[1])).numpy()
    want = np.asarray(ref_expand.apply_fused(jnp.asarray(x), rplan[0], _jj(rplan[1]),
                                             interpret=True))
    assert got.dtype == want.dtype and got.shape == (128,)
    oracle = _oracle(sp, dl, m, x, nseg, op)
    if op == "sum" and dtype == np.float32:
        np.testing.assert_allclose(got[:nseg], want[:nseg], rtol=1e-5)
        np.testing.assert_allclose(got[:nseg], oracle, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:nseg], oracle.astype(dtype))
    if not mx:
        pf = expand.to_pf(plan)
        _assert_plans_equal(pf, ref_expand.to_pf(rplan))
        np.testing.assert_array_equal(
            expand.apply_fused(_t(x), pf[0], _tt(pf[1])).numpy(), got)


@pytest.fixture(scope="module")
def graphs():
    return generate.rmat(8, 6, seed=31), ref_generate.rmat(8, 6, seed=31)


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("kind", ["expand", "expand-pf", "fused", "fused-pf", "fused-mx"])
def test_shards_planners_match_reference(graphs, parts, kind):
    sh = shards.build_pull_shards(graphs[0], parts)
    rsh = ref_shards.build_pull_shards(graphs[1], parts)
    pf = kind.endswith(("-pf", "-mx"))
    if kind.startswith("expand"):
        mine, ref = expand.plan_expand_shards(sh, pf=pf), ref_expand.plan_expand_shards(rsh, pf=pf)
    else:
        mx = kind == "fused-mx"
        mine = expand.plan_fused_shards(sh, "sum", pf=pf, mx=mx)
        ref = ref_expand.plan_fused_shards(rsh, "sum", pf=pf, mx=mx)
    _assert_plans_equal(mine, ref)
    assert mine[1][0].shape[0] == parts


def _ref_route(rsh, kind):
    pf = kind.endswith(("-pf", "-mx"))
    if kind.startswith("expand"):
        return ref_expand.plan_expand_shards(rsh, pf=pf)
    return ref_expand.plan_fused_shards(rsh, "sum", pf=pf, mx=kind == "fused-mx")


def _port_route(sh, kind):
    pf = kind.endswith(("-pf", "-mx"))
    if kind.startswith("expand"):
        return expand.plan_expand_shards(sh, pf=pf)
    return expand.plan_fused_shards(sh, "sum", pf=pf, mx=kind == "fused-mx")


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("kind", ["expand", "expand-pf", "fused", "fused-pf", "fused-mx"])
def test_run_pull_fixed_routed_matches_reference(graphs, parts, kind):
    """PageRank through run_pull_fixed(route=...): expand modes bitwise
    equal to the port's direct run with the same reduce method; every
    mode within rtol 1e-5 of the reference's routed run and of the
    float64 oracle."""
    g, rg = graphs
    sh = shards.build_pull_shards(g, parts)
    arrays = shards.to_device(sh.arrays, "cpu")
    prog = pr.PageRankProgram(nv=g.nv)
    s0 = pull.init_state(prog, arrays)
    got = pull.run_pull_fixed(prog, sh.spec, arrays, s0, ITERS, method="scan",
                              route=_port_route(sh, kind))
    direct = pull.run_pull_fixed(prog, sh.spec, arrays, s0, ITERS, method="scan")
    if kind.startswith("expand"):
        assert torch.equal(got, direct)
    rsh = ref_shards.build_pull_shards(rg, parts)
    rprog = ref_pr.PageRankProgram(nv=rsh.spec.nv)
    ref = ref_pull.run_pull_fixed(rprog, rsh.spec, rsh.arrays,
                                  ref_pull.init_state(rprog, rsh.arrays), ITERS,
                                  method="scan", route=_ref_route(rsh, kind))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    ranks = sh.scatter_to_global(got.numpy())
    np.testing.assert_allclose(ranks, pr.pagerank_reference(g, ITERS), rtol=1e-5)


def test_fused_pf_is_bitwise_fused(graphs):
    g = graphs[0]
    sh = shards.build_pull_shards(g, 2)
    arrays = shards.to_device(sh.arrays, "cpu")
    prog = pr.PageRankProgram(nv=g.nv)
    s0 = pull.init_state(prog, arrays)
    a = pull.run_pull_fixed(prog, sh.spec, arrays, s0, ITERS, route=_port_route(sh, "fused"))
    b = pull.run_pull_fixed(prog, sh.spec, arrays, s0, ITERS, route=_port_route(sh, "fused-pf"))
    assert torch.equal(a, b)


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_routed_int_programs_bitwise(graphs, reduce):
    """Integer min/max programs through every routed mode: bitwise equal
    to the direct run (SSSP-style min over hop counts, and its max twin)."""
    g = graphs[0]
    sh = shards.build_pull_shards(g, 1)
    arrays = shards.to_device(sh.arrays, "cpu")
    lib = library.SSSP if reduce == "min" else library.COMPONENTS
    prog = spec.bind(lib, inf=g.nv, start=3) if reduce == "min" else spec.bind(lib)
    assert prog.reduce == reduce
    s0 = pull.init_state(prog, arrays)
    want = pull.run_pull_fixed(prog, sh.spec, arrays, s0, 3, method="scan")
    for kind in ("expand", "expand-pf", "fused", "fused-mx"):
        pf = kind.endswith(("-pf", "-mx"))
        route = (expand.plan_expand_shards(sh, pf=pf) if kind.startswith("expand")
                 else expand.plan_fused_shards(sh, reduce, pf=pf, mx=kind == "fused-mx"))
        got = pull.run_pull_fixed(prog, sh.spec, arrays, s0, 3, method="scan", route=route)
        assert torch.equal(got, want), kind


def test_route_plan_from_numpy_replays_the_reference_plan(graphs):
    """The reference's plan (its static read field by field, its arrays
    as numpy) drives the port's engine to the same bits as the port's
    own plan."""
    g, rg = graphs
    rsh = ref_shards.build_pull_shards(rg, 1)
    sh = shards.build_pull_shards(g, 1)
    arrays = shards.to_device(sh.arrays, "cpu")
    prog = pr.PageRankProgram(nv=g.nv)
    s0 = pull.init_state(prog, arrays)
    for kind in ("expand-pf", "fused-mx"):
        rstatic, rarrays = _ref_route(rsh, kind)
        st, ts = convert.route_plan_from_numpy(rstatic, rarrays, device="cpu")
        assert type(st).__module__ == "lux_tpu_torch.ops.expand"
        mine = _port_route(sh, kind)
        _assert_static_equal(st, mine[0])
        assert all(t.dtype == torch.from_numpy(np.asarray(a)).dtype
                   for t, a in zip(ts, rarrays))
        got = pull.run_pull_fixed(prog, sh.spec, arrays, s0, 2, route=(st, ts))
        want = pull.run_pull_fixed(prog, sh.spec, arrays, s0, 2, route=mine)
        assert torch.equal(got, want)
    @dataclasses.dataclass(frozen=True)
    class BucketRouteStatic:  # a static node the port has no class for
        r: int

    with pytest.raises(TypeError, match="no counterpart"):
        convert.route_plan_from_numpy(BucketRouteStatic(r=1), (), device="cpu")


def test_fused_rejects_what_it_cannot_run(graphs):
    g = graphs[0]
    sh = shards.build_pull_shards(g, 1)
    arrays = shards.to_device(sh.arrays, "cpu")
    full = torch.zeros(sh.spec.gathered_size)
    mx_plan = expand.plan_fused_shards(sh, "sum", mx=True)
    part = (mx_plan[0], tuple(_t(a[0]) for a in mx_plan[1]))
    with pytest.raises(NotImplementedError, match="weighted edge function"):
        expand.apply_fused(full, *part, edge_value=lambda s, w: s + w, weighted=True)
    prog = pr.PageRankProgram(nv=g.nv)
    with pytest.raises(AssertionError, match="reduce"):
        pull.local_pull_step(spec.bind(library.SSSP, inf=g.nv, start=0), arrays.part(0),
                             full, full[: sh.spec.nv_pad], route=part)
    assert not pull._edge_reads_weight(prog)
    assert pull._edge_reads_weight(spec.bind(library.SSSP_WEIGHTED, inf=1 << 30, start=0))
    with pytest.raises(ValueError, match="1-D"):
        expand.apply_expand(torch.zeros(4, 2), *_port_route(sh, "expand"))


def test_route_and_reduce_modes(monkeypatch):
    assert methods.route_mode() == "routed-pf" and methods.reduce_mode() == "group"
    monkeypatch.setenv("LUX_ROUTE_MODE", "routed")
    monkeypatch.setenv("LUX_REDUCE_MODE", "mxreduce")
    assert methods.route_mode() == "routed" and methods.reduce_mode() == "mxreduce"
    assert expand.resolve_fused_mx(None) and not expand.resolve_fused_mx(False)
    monkeypatch.setenv("LUX_ROUTE_MODE", "fast")
    with pytest.raises(ValueError, match="LUX_ROUTE_MODE"):
        methods.route_mode()


def test_idx8_off_keeps_int32_indices(monkeypatch):
    monkeypatch.setenv("LUX_ROUTE_IDX8", "0")
    sp, _ = _csc(3, 300, 20, 200, 384)
    static, arrays = expand.plan_expand(sp, 300, 200)
    assert {a.dtype for a in arrays} <= {np.dtype(np.int32), np.dtype(bool)}
    x = np.random.default_rng(4).random(200).astype(np.float32)
    got = expand.apply_expand(_t(x), static, _tt(arrays)).numpy()
    np.testing.assert_array_equal(got[:300], x[sp[:300]])
