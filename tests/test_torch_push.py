"""The push engine of lux_tpu_torch vs lux_tpu's, on the CPU.

The same graphs (numpy, from a seed) go through the reference's push
shards and engine (XLA on the CPU, its Pallas scan in interpret mode) and
through the port with device="cpu".  The push programs are integer
min/max monoids, so everything is held bitwise: the layout, the final
states, the iteration counts and the traversed-edge counts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from lux_tpu.engine import push as ref_push
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph.push_shards import build_push_shards as ref_build
from lux_tpu.models import components as ref_cc
from lux_tpu.models import sssp as ref_sssp
from lux_tpu.ops import merge_tree as ref_tree
from lux_tpu_torch import convert
from lux_tpu_torch.engine import methods, push
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph import push_shards as ps
from lux_tpu_torch.graph.push_shards import build_push_shards
from lux_tpu_torch.graph.shards import build_pull_shards
from lux_tpu_torch.models import components as cc
from lux_tpu_torch.models import sssp
from lux_tpu_torch.ops import expand, merge_tree

APPS = ("sssp", "cc")


def _progs(app, nv, start=0):
    if app == "sssp":
        return ref_sssp.SSSPProgram(nv=nv, start=start), sssp.SSSPProgram(nv=nv, start=start)
    return ref_cc.MaxLabelProgram(), cc.MaxLabelProgram()


def _ref(app, shards, method="scan", start=0, **kw):
    """The reference's (state, iters, edges) as numpy / Python ints."""
    prog = _progs(app, shards.spec.nv, start)[0]
    state, it, edges = ref_push.run_push(prog, shards, method=method, **kw)
    return np.asarray(state), int(it), ref_push.edges_total(edges)


def _port(app, shards, method="scan", start=0, **kw):
    prog = _progs(app, shards.spec.nv, start)[1]
    state, it, edges = push.run_push(prog, shards, method=method, device="cpu", **kw)
    assert isinstance(it, int) and isinstance(edges, int)
    return state.numpy(), it, push.edges_total(edges)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype == np.int32
    assert got[1:] == want[1:], f"(iters, edges): port {got[1:]}, reference {want[1:]}"


@pytest.fixture(scope="module")
def graphs():
    return generate.rmat(9, 8, seed=31), ref_generate.rmat(9, 8, seed=31)


@pytest.fixture(scope="module")
def layouts(graphs):
    """(port, reference) push shards per part count."""
    return {p: (build_push_shards(graphs[0], p), ref_build(graphs[1], p))
            for p in (1, 2, 3)}


@pytest.fixture(scope="module")
def ref_runs(layouts):
    """Reference results, computed once per (app, parts, method).  The
    reference's results do not depend on its method (its own tests hold
    that), so with more than one part it runs "scatter" only, the
    quickest to compile; on one part it runs the method asked for, its
    mxscan in interpret mode."""
    memo = {}

    def get(app, parts, method):
        key = (app, parts, method if parts == 1 else "scatter")
        if key not in memo:
            memo[key] = _ref(app, layouts[parts][1], key[2])
        return memo[key]

    return get


def _assert_layout_equal(mine, ref):
    assert dataclasses.asdict(mine.pspec) == dataclasses.asdict(ref.pspec)
    assert dataclasses.asdict(mine.spec) == dataclasses.asdict(ref.spec)
    np.testing.assert_array_equal(mine.cuts, ref.cuts)
    for name in ps.PushArrays._fields:
        a, b = getattr(mine.parrays, name), np.asarray(getattr(ref.parrays, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    for a, b in zip(mine.arrays, ref.arrays):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_push_arrays_byte_identical(parts, weighted):
    g = generate.rmat(8, 6, seed=30, weighted=weighted)
    rg = ref_generate.rmat(8, 6, seed=30, weighted=weighted)
    mine = build_push_shards(g, parts)
    _assert_layout_equal(mine, ref_build(rg, parts))
    assert 0 < mine.pspec.e_sp_small < mine.pspec.e_sp
    assert (mine.parrays.csr_weight.any()) == weighted


@pytest.mark.parametrize("parts", [1, 3])
def test_embedded_pull_layout_is_build_pull_shards(graphs, parts):
    """The push shards' pull layout is the pull engine's, so a routed plan
    built on build_pull_shards serves the push apps' dense rounds."""
    mine = build_push_shards(graphs[0], parts).pull
    want = build_pull_shards(graphs[0], parts)
    assert mine.spec == want.spec
    np.testing.assert_array_equal(mine.cuts, want.cuts)
    for a, b in zip(mine.arrays, want.arrays):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("parts", [1, 2, 3])
@pytest.mark.parametrize("method", ["scan", "scatter", "mxscan"])
@pytest.mark.parametrize("app", APPS)
def test_run_push_matches_reference(layouts, ref_runs, parts, method, app):
    got = _port(app, layouts[parts][0], method)
    _assert_same(got, ref_runs(app, parts, method))


@pytest.mark.parametrize("merge", ["bulk", "tree"])
@pytest.mark.parametrize("app", APPS)
def test_merge_modes_bitwise(layouts, ref_runs, merge, app):
    got = _port(app, layouts[3][0], "scatter", merge=merge)
    _assert_same(got, _ref(app, layouts[3][1], "scatter", merge=merge))
    _assert_same(got, ref_runs(app, 3, "scatter"))


def test_merge_mode_knob(monkeypatch):
    monkeypatch.delenv("LUX_MERGE_MODE", raising=False)
    assert methods.merge_mode() == "bulk"
    monkeypatch.setenv("LUX_MERGE_MODE", "tree")
    assert methods.merge_mode() == "tree" == push._resolve_merge(None)
    monkeypatch.setenv("LUX_MERGE_MODE", "ring")
    with pytest.raises(ValueError, match="LUX_MERGE_MODE"):
        methods.merge_mode()
    with pytest.raises(ValueError, match="merge must be"):
        push._resolve_merge("fold")


def _forced(g, rg, den, **kw):
    a, b = build_push_shards(g, 1, **kw), ref_build(rg, 1, **kw)
    a.pspec = dataclasses.replace(a.pspec, pull_threshold_den=den)
    b.pspec = dataclasses.replace(b.pspec, pull_threshold_den=den)
    return a, b


def test_forced_dense_and_forced_sparse():
    g, rg = generate.rmat(9, 8, seed=33), ref_generate.rmat(9, 8, seed=33)
    want = ref_sssp.bfs_reference(rg, 5)
    dense = _forced(g, rg, g.nv + 1)  # any frontier > nv // den == 0
    got = _port("sssp", dense[0], start=5)
    _assert_same(got, _ref("sssp", dense[1], start=5))
    np.testing.assert_array_equal(dense[0].scatter_to_global(got[0]), want)
    assert got[2] == got[1] * g.ne  # every round dense
    nv_pad, e_pad = dense[0].spec.nv_pad, dense[0].spec.e_pad
    sparse = _forced(g, rg, 1, f_cap=nv_pad, e_sp=e_pad)  # never overflows
    got = _port("sssp", sparse[0], start=5)
    _assert_same(got, _ref("sssp", sparse[1], start=5))
    np.testing.assert_array_equal(sparse[0].scatter_to_global(got[0]), want)
    assert got[2] < got[1] * g.ne


@pytest.mark.parametrize("app", APPS)
def test_overflow_falls_back_dense(app):
    """A tiny queue and edge buffer: the frontier overflows, the next
    round is dense, and the answer is still exact."""
    g, rg = generate.rmat(9, 8, seed=34), ref_generate.rmat(9, 8, seed=34)
    mine, ref = build_push_shards(g, 1, f_cap=128, e_sp=256), ref_build(rg, 1, f_cap=128, e_sp=256)
    got = _port(app, mine)
    _assert_same(got, _ref(app, ref))
    if app == "sssp":
        np.testing.assert_array_equal(mine.scatter_to_global(got[0]),
                                      sssp.bfs_reference(g, 0))


def test_build_queue_matches_reference():
    """Exact compaction in ascending local index, truncated at f_cap with
    the count kept past it (overflow)."""
    from lux_tpu.graph.shards import ShardArrays as RefArrays

    pspec = ps.PushSpec(u_pad=128, f_cap=256, e_sp=1024)
    rng = np.random.default_rng(5)
    gv = np.arange(1000, 2024, dtype=np.int32)
    vals = rng.integers(-50, 50, 1024).astype(np.int32)
    for density in (0.0, 0.05, 0.2, 0.6, 1.0):
        changed = rng.random(1024) < density
        ref_arr = RefArrays(*[None] * 7, gv, *[None] * 3)
        want = ref_push.build_queue(pspec, ref_arr, changed, vals)
        got = push.build_queue(pspec, torch.from_numpy(gv), torch.from_numpy(changed),
                               torch.from_numpy(vals))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert int(got[2]) == int(changed.sum())


def test_sparse_prep_matches_reference(layouts):
    mine, ref = layouts[3]
    rng = np.random.default_rng(6)
    q = np.full(3 * mine.pspec.f_cap, ps.SRC_SENTINEL, np.int32)
    q[:50] = np.sort(rng.choice(mine.spec.nv, 50, replace=False))
    for p in range(3):
        want = ref_push.sparse_prep(ref_push.PushArrays(*(np.asarray(a[p]) for a in ref.parrays)), q)
        parr = ps.to_device(mine.parrays, "cpu").part(p)
        got = push.sparse_prep(parr, torch.from_numpy(q))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _rounds(app, shards, start=0):
    """(dense, small-tier) of every round the port ran."""
    prog = _progs(app, shards.spec.nv, start)[1]
    arrays, parrays, c = push.push_init(prog, shards, "cpu")
    load, comp, update = push.push_phases(prog, shards.pspec, shards.spec, "scan",
                                          device="cpu")
    seen = []
    while True:
        plan = load(parrays, c)
        if plan.active == 0:
            return seen, c
        seen.append((plan.dense, plan.small))
        c = update(arrays, c, comp(arrays, parrays, c, plan), plan)


def test_both_sparse_tiers_bitwise():
    """A long sparse tail: rounds run in the small tier and in the full one,
    and the results equal the untiered run's and the reference's."""
    g, rg = generate.rmat(10, 4, seed=2), ref_generate.rmat(10, 4, seed=2)
    mine, ref = build_push_shards(g, 2), ref_build(rg, 2)
    hub = int(np.argmax(np.bincount(g.col_idx, minlength=g.nv)))
    seen, last = _rounds("sssp", mine, hub)
    assert (False, True) in seen and (False, False) in seen, seen
    got = _port("sssp", mine, start=hub)
    np.testing.assert_array_equal(got[0], last.state.numpy())
    untiered = dataclasses.replace(mine, pspec=dataclasses.replace(mine.pspec, e_sp_small=0))
    _assert_same(_port("sssp", untiered, start=hub), got)
    _assert_same(got, _ref("sssp", ref, "scatter", start=hub))


def test_phase_split_equals_the_loop(layouts, ref_runs):
    """The -verbose phase split runs the same rounds as run_push_chunk."""
    seen, last = _rounds("cc", layouts[2][0])
    want = ref_runs("cc", 2, "scan")
    np.testing.assert_array_equal(last.state.numpy(), want[0])
    assert (last.it, last.edges) == want[1:]
    assert last.dense_rounds == sum(d for d, _ in seen)


@pytest.mark.parametrize("pf", [False, True])
@pytest.mark.parametrize("app", APPS)
def test_routed_dense_rounds_bitwise(layouts, ref_runs, pf, app):
    """--route-gather expand / expand-pf: the dense rounds' gather through
    the routed expand, on the int32 state."""
    mine = layouts[2][0]
    plan = expand.plan_expand_shards(mine.pull, pf=pf)
    got = _port(app, mine, "mxscan", route=plan)
    _assert_same(got, ref_runs(app, 2, "mxscan"))


def test_route_must_be_an_expand_plan(layouts):
    mine = layouts[1][0]
    plan = expand.plan_fused_shards(mine.pull, "min")
    with pytest.raises(ValueError, match="expand plan"):
        _port("sssp", mine, route=plan)


def test_max_iters_and_resume(layouts, ref_runs):
    """A chunked run resumes from its carry to the same fixpoint."""
    mine = layouts[1][0]
    prog = sssp.SSSPProgram(nv=mine.spec.nv)
    arrays, parrays, c0 = push.push_init(prog, mine, "cpu")
    c2 = push.run_push_chunk(prog, mine.pspec, mine.spec, arrays, parrays, c0, 2)
    assert c2.it == 2 and c0.it == 0
    c = push.run_push_chunk(prog, mine.pspec, mine.spec, arrays, parrays, c2, 10_000)
    want = ref_runs("sssp", 1, "scan")
    np.testing.assert_array_equal(c.state.numpy(), want[0])
    assert (c.it, c.edges) == want[1:]


def test_reference_layout_through_convert(layouts, ref_runs):
    """The reference's own push layout, carried over with convert, runs
    bitwise through the port's engine."""
    ref = layouts[3][1]
    mine = convert.push_shards_from_numpy(
        dataclasses.asdict(ref.spec), ref.arrays._asdict(), ref.cuts,
        dataclasses.asdict(ref.pspec), ref.parrays._asdict())
    _assert_layout_equal(mine, ref)
    _assert_same(_port("cc", mine), ref_runs("cc", 3, "scan"))


def test_edges_total_exact():
    assert push.edges_total(2**40 + 5) == 2**40 + 5
    assert ref_push.edges_total(np.array([256, 5], np.uint32)) == push.edges_total(2**40 + 5)


@pytest.mark.parametrize("arity", range(10))
def test_plan_tree_matches_reference(arity):
    assert merge_tree.plan_tree(arity) == ref_tree.plan_tree(arity)
    assert merge_tree.tree_depth(arity) == ref_tree.tree_depth(arity)


@pytest.mark.parametrize("reduce,dtype", [("min", np.int32), ("max", np.int32),
                                          ("sum", np.int32), ("min", np.float32),
                                          ("max", np.float32)])
@pytest.mark.parametrize("b", [1, 2, 3, 5, 8])
def test_tree_combine_matches_reference(reduce, dtype, b):
    import jax.numpy as jnp

    rng = np.random.default_rng(b)
    x = (rng.integers(-1000, 1000, (b, 257)) if dtype == np.int32
         else rng.standard_normal((b, 257))).astype(dtype)
    ops = {"min": (torch.minimum, jnp.minimum), "max": (torch.maximum, jnp.maximum),
           "sum": (torch.add, jnp.add)}[reduce]
    got = merge_tree.tree_combine(torch.from_numpy(x), ops[0]).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_tree.tree_combine(jnp.asarray(x), ops[1])))
    neu = merge_tree.neutral(reduce, torch.from_numpy(x).dtype)
    assert neu == ref_tree.neutral(reduce, dtype).item()


def test_neutral_rejects_unknown_reduce():
    with pytest.raises(ValueError, match="unknown reduce"):
        merge_tree.neutral("prod", torch.int32)
    with pytest.raises(ValueError, match="at least one"):
        merge_tree.tree_combine(torch.zeros((0, 3)), torch.minimum)
