"""The gather relayouts (--sort-segments, --compact-gather) in
lux_tpu_torch vs lux_tpu, on the CPU.

Contract (the reference's own): both relayouts are host permutations and
are held bitwise to the reference's arrays; the compact layout's results
are bitwise the direct layout's; a sorted layout changes how f32 sums
round, so PageRank is held at rtol 1e-5 to the reference's run on the
same relayout (and to the float64 oracle); min/max relaxation is
order-free, so SSSP and components are bitwise under every layout.  The
reference's Pallas kernels run in interpret mode, its builders on their
NumPy paths (its native library is switched off here).
"""
import numpy as np
import pytest
import torch

import lux_tpu.native as ref_native
from lux_tpu.apps import colfilter as ref_cf_app
from lux_tpu.apps import components as ref_cc_app
from lux_tpu.apps import pagerank as ref_pr_app
from lux_tpu.apps import run as ref_run_app
from lux_tpu.apps import sssp as ref_sssp_app
from lux_tpu.engine import pull as ref_pull
from lux_tpu.engine import push as ref_push
from lux_tpu.graph import csc as ref_csc
from lux_tpu.graph import push_shards as ref_push_shards
from lux_tpu.graph import shards as ref_shards
from lux_tpu.graph import sharded_load as ref_sharded
from lux_tpu.models import components as ref_cc
from lux_tpu.models import pagerank as ref_pr
from lux_tpu.models import sssp as ref_sssp
from lux_tpu.mutate import deltalog as ref_deltalog
from lux_tpu.mutate import overlay as ref_overlay
from lux_tpu.ops import expand as ref_expand
from lux_tpu_torch.apps import colfilter as cf_app
from lux_tpu_torch.apps import components as cc_app
from lux_tpu_torch.apps import pagerank as pr_app
from lux_tpu_torch.apps import run as run_app
from lux_tpu_torch.apps import sssp as sssp_app
from lux_tpu_torch.engine import pull, push, repartition
from lux_tpu_torch.graph import format as fmt
from lux_tpu_torch.graph import generate, push_shards, shards, sharded_load
from lux_tpu_torch.graph.csc import HostGraph, from_edge_list
from lux_tpu_torch.models import components as cc
from lux_tpu_torch.models import pagerank as pr
from lux_tpu_torch.models import sssp
from lux_tpu_torch.mutate import deltalog, overlay
from lux_tpu_torch.ops import expand

ITERS = 6
LAYOUTS = {"default": (False, False), "sorted": (True, False),
           "compact": (False, True), "both": (True, True)}


@pytest.fixture(autouse=True)
def _reference_numpy(monkeypatch):
    monkeypatch.setattr(ref_native, "_lib", None)
    monkeypatch.setattr(ref_native, "_tried", True)
    monkeypatch.setenv("LUX_PF_MAX_BLOCK", str(1 << 14))
    for k in ("LUX_ROUTE_MODE", "LUX_REDUCE_MODE", "LUX_ROUTE_IDX8"):
        monkeypatch.delenv(k, raising=False)


def _hub_graph(weighted: bool = False) -> HostGraph:
    """RMAT 9 folded onto 300 destinations, a source hub (5 -> all of
    them) and a destination hub (every vertex -> 7, four times): empty
    parts at 8."""
    g = generate.rmat(9, 8, seed=3)
    src = np.concatenate([g.col_idx.astype(np.int64), np.tile(np.arange(g.nv), 4),
                          np.full(300, 5)])
    dst = np.concatenate([g.dst_of_edges().astype(np.int64) % 300,
                          np.full(4 * g.nv, 7), np.arange(300)])
    w = (np.random.default_rng(1).integers(1, 60, len(src)).astype(np.int32)
         if weighted else None)
    return from_edge_list(src, dst, g.nv, weights=w)


GRAPHS = {
    "rmat9": lambda: generate.rmat(9, 8, seed=21),
    "rmat8w": lambda: generate.rmat(8, 8, seed=22, weighted=True),
    "hub": lambda: _hub_graph(),
    "hubw": lambda: _hub_graph(True),
}


def _ref(g: HostGraph):
    return ref_csc.HostGraph(nv=g.nv, ne=g.ne, row_ptr=g.row_ptr, col_idx=g.col_idx,
                             weights=g.weights)


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("parts", [1, 3, 8])
def test_sort_segments_matches_reference(name, parts):
    g = GRAPHS[name]()
    mine = shards.build_pull_shards(g, parts).arrays
    ref = ref_shards.build_pull_shards(_ref(g), parts).arrays
    shards.sort_segments_inplace(mine)
    ref_shards.sort_segments_inplace(ref)
    for field, a, r in zip(mine._fields, mine, ref):
        _same(a, r, field)
    # each segment ascending; the dst sequence untouched
    sp, dl = mine.src_pos, mine.dst_local
    same_seg = dl[:, 1:] == dl[:, :-1]
    assert np.all(sp[:, 1:][same_seg] >= sp[:, :-1][same_seg])


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("parts", [1, 3, 8])
@pytest.mark.parametrize("sort", [False, True])
def test_compact_mirror_matches_reference(name, parts, sort):
    g = GRAPHS[name]()
    mine = shards.build_pull_shards(g, parts, sort_segments=sort, compact_gather=True)
    ref = ref_shards.build_pull_shards(_ref(g), parts, sort_segments=sort,
                                       compact_gather=True)
    for field, a, r in zip(mine.arrays._fields, mine.arrays, ref.arrays):
        _same(a, r, field)
    a = mine.arrays
    for p in range(parts):
        m = a.edge_mask[p]
        _same(a.mirror_pos[p][a.mirror_rel[p]][m], a.src_pos[p][m])
    u = a.mirror_pos.shape[1]
    wide = shards.build_compact_mirror(shards.build_pull_shards(g, parts).arrays, u_pad=u + 128)
    rwide = ref_shards.build_compact_mirror(ref_shards.build_pull_shards(_ref(g), parts).arrays,
                                            u_pad=u + 128)
    for field, x, r in zip(wide._fields, wide, rwide):
        _same(x, r, field)
    need = int(max(len(np.unique(a.src_pos[p][a.edge_mask[p]])) for p in range(parts)))
    with pytest.raises(ValueError, match="u_pad"):
        shards.build_compact_mirror(shards.build_pull_shards(g, parts).arrays, u_pad=need - 1)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sharded_load_relayouts_match_reference(layout, tmp_path):
    """load_pull_shards with the relayouts, all parts and a subset (whose
    mirror width is the whole file's), == the reference's loader."""
    g = _hub_graph(True)
    path = str(tmp_path / "g.lux")
    fmt.write_lux(path, g)
    ss, cg = LAYOUTS[layout]
    for parts in (3, 8):
        assert sharded_load.compact_width_from_file(path, parts) == \
            ref_sharded.compact_width_from_file(path, parts)
        for subset in (None, [parts - 1, 0]):
            got = sharded_load.load_pull_shards(path, parts, parts_subset=subset,
                                                sort_segments=ss, compact_gather=cg)
            ref = ref_sharded.load_pull_shards(path, parts, parts_subset=subset,
                                               sort_segments=ss, compact_gather=cg)
            for field, a, r in zip(got.arrays._fields, got.arrays, ref.arrays):
                _same(a, r, field)
            full = shards.build_pull_shards(g, parts, sort_segments=ss, compact_gather=cg)
            if subset is None:
                for field, a, b in zip(got.arrays._fields, got.arrays, full.arrays):
                    _same(a, b, field)


def _pagerank(sh, iters=ITERS, route=None):
    prog = pr.PageRankProgram(nv=sh.spec.nv)
    arrays = shards.to_device(sh.arrays, "cpu")
    s0 = pull.init_state(prog, arrays)
    return pull.run_pull_fixed(prog, sh.spec, arrays, s0, iters, method="scan",
                               route=route).numpy()


def _ref_pagerank(rsh, iters=ITERS, route=None):
    rprog = ref_pr.PageRankProgram(nv=rsh.spec.nv)
    return np.asarray(ref_pull.run_pull_fixed(rprog, rsh.spec, rsh.arrays,
                                              ref_pull.init_state(rprog, rsh.arrays), iters,
                                              method="scan", route=route))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("parts", [1, 3])
def test_pagerank_layouts_match_reference(layout, parts):
    g = GRAPHS["rmat9"]()
    ss, cg = LAYOUTS[layout]
    sh = shards.build_pull_shards(g, parts, sort_segments=ss, compact_gather=cg)
    rsh = ref_shards.build_pull_shards(_ref(g), parts, sort_segments=ss, compact_gather=cg)
    got = _pagerank(sh)
    np.testing.assert_allclose(got, _ref_pagerank(rsh), rtol=1e-5)
    np.testing.assert_allclose(sh.scatter_to_global(got), pr.pagerank_reference(g, ITERS),
                               rtol=1e-5)
    if cg:  # the mirror is exact: bitwise the layout without it
        plain = shards.build_pull_shards(g, parts, sort_segments=ss)
        _same(got, _pagerank(plain))


def _push_prog(app, g):
    if app == "sssp":
        return sssp.SSSPProgram(nv=g.nv, start=int(np.argmax(g.out_degrees()))), \
            ref_sssp.SSSPProgram(nv=g.nv, start=int(np.argmax(g.out_degrees())))
    return cc.MaxLabelProgram(), ref_cc.MaxLabelProgram()


@pytest.mark.parametrize("app", ["sssp", "components"])
@pytest.mark.parametrize("layout", ["sorted", "compact", "both"])
@pytest.mark.parametrize("parts", [1, 3, 8])
def test_push_layouts_bitwise_reference(app, layout, parts):
    """SSSP and components on the push engine: state, iterations and
    traversed edges bitwise the reference's run on the same relayout and
    the port's default layout."""
    g = _hub_graph()
    ss, cg = LAYOUTS[layout]
    prog, rprog = _push_prog(app, g)
    outs = []
    for kw in ({"sort_segments": ss, "compact_gather": cg}, {}):
        sh = push_shards.build_push_shards(g, parts, **kw)
        arrays, parrays, carry = push.push_init(prog, sh, "cpu")
        out = push.run_push_chunk(prog, sh.pspec, sh.spec, arrays, parrays, carry, 10_000,
                                  "scan")
        outs.append((sh.scatter_to_global(out.state.numpy()), out.it, out.edges))
    rsh = ref_push_shards.build_push_shards(_ref(g), parts, sort_segments=ss,
                                            compact_gather=cg)
    state, it, edges = ref_push.run_push(rprog, rsh, method="scan")
    want = (rsh.scatter_to_global(np.asarray(state)), int(it), ref_push.edges_total(edges))
    for got in outs:
        _same(got[0], want[0])
        assert got[1:] == want[1:]


@pytest.mark.parametrize("layout", ["sorted", "both"])
def test_sorted_routed_pagerank_matches_reference(layout):
    """--sort-segments --route-gather fused-pf (and expand-pf): plans
    over the sorted src_pos, byte-identical to the reference's; the
    expand replay bitwise the port's direct sorted run; fused-pf within
    rtol 1e-5 of the reference's (its kernels in interpret mode)."""
    g = GRAPHS["rmat9"]()
    sh = shards.build_pull_shards(g, 2, sort_segments=True)
    rsh = ref_shards.build_pull_shards(_ref(g), 2, sort_segments=True)
    for kind in ("expand-pf", "fused-pf"):
        if kind == "expand-pf":
            mine, ref = expand.plan_expand_shards(sh, pf=True), \
                ref_expand.plan_expand_shards(rsh, pf=True)
        else:
            mine = expand.plan_fused_shards(sh, "sum", pf=True)
            ref = ref_expand.plan_fused_shards(rsh, "sum", pf=True)
        assert len(mine[1]) == len(ref[1])
        for x, y in zip(mine[1], ref[1]):
            _same(x, y)
        got = _pagerank(sh, route=mine)
        if kind == "expand-pf":
            _same(got, _pagerank(sh))
        np.testing.assert_allclose(got, _ref_pagerank(rsh, route=ref), rtol=1e-5)
        np.testing.assert_allclose(sh.scatter_to_global(got), pr.pagerank_reference(g, ITERS),
                                   rtol=1e-5)


def test_sorted_routed_app_run():
    """The app with --sort-segments --route-gather fused-pf: the plan is
    built over the sorted layout; -check passes."""
    res = pr_app.run(["--rmat-scale", "8", "-ni", "4", "--sort-segments",
                      "--route-gather", "fused-pf", "-check", "--device", "cpu"])
    assert res.rc == 0 and res.route_gather == "fused-pf"
    np.testing.assert_allclose(res.ranks, pr.pagerank_reference(res.graph, 4), rtol=1e-5)


@pytest.mark.parametrize("layout", ["sorted", "compact", "both"])
def test_repartition_rebuilds_with_the_relayouts(layout):
    """A recut rebuilds the push layout with the same relayouts; the
    distances are bitwise the static run's."""
    g = _hub_graph()
    ss, cg = LAYOUTS[layout]
    prog = sssp.SSSPProgram(nv=g.nv, start=5)
    layouts = []
    res = repartition.run_push_adaptive(
        prog, g, 4, chunk=1, threshold=1.0001, device="cpu", sort_segments=ss,
        compact_gather=cg, on_repartition=lambda *a: layouts.append(a))
    assert res.reparts >= 1 and layouts
    assert (res.shards.arrays.mirror_pos.shape[1] > 0) == cg
    if ss:
        a = res.shards.arrays
        seg = a.dst_local[:, 1:] == a.dst_local[:, :-1]
        assert np.all(a.src_pos[:, 1:][seg] >= a.src_pos[:, :-1][seg])
    _same(res.state, sssp.bfs_reference(g, 5))


def test_streamed_sorted_layout(capsys):
    """--stream-hbm-gib takes --sort-segments: the streamed run within
    rtol 1e-5 of the resident sorted run and the float64 oracle."""
    argv = ["--rmat-scale", "10", "-ni", "5", "-ng", "2", "--sort-segments",
            "--device", "cpu", "--method", "scan"]
    st = pr_app.run(argv + ["--stream-hbm-gib", "0.00007"])
    assert st.streamed.n_chunks >= 2
    res = pr_app.run(argv)
    np.testing.assert_allclose(st.ranks, res.ranks, rtol=1e-5)
    np.testing.assert_allclose(st.ranks, pr.pagerank_reference(res.graph, 5), rtol=1e-5)
    assert "host path native" in capsys.readouterr().out


@pytest.mark.parametrize("layout", ["sorted", "compact"])
def test_overlays_refuse_a_relayout(layout):
    g = GRAPHS["rmat9"]()
    ss, cg = LAYOUTS[layout]
    dl = deltalog.DeltaLog(g)
    rdl = ref_deltalog.DeltaLog(_ref(g))
    victim = np.array([0, 1, 2, 3])
    src, dst = g.col_idx[victim], g.dst_of_edges()[victim]
    dl.apply(src, dst, np.zeros(4, np.int8))
    rdl.apply(src, dst, np.zeros(4, np.int8))
    sh = shards.build_pull_shards(g, 2, sort_segments=ss, compact_gather=cg)
    rsh = ref_shards.build_pull_shards(_ref(g), 2, sort_segments=ss, compact_gather=cg)
    with pytest.raises(ValueError, match="layout"):
        overlay.build_pull_overlay(sh, dl)
    with pytest.raises(ValueError, match="layout"):
        ref_overlay.build_pull_overlay(rsh, rdl)


APP = ["--rmat-scale", "6", "--rmat-ef", "4"]
REFUSED = [
    ("pagerank", ["--method", "pallas", "--sort-segments"]),
    ("pagerank", ["--method", "pallas", "--compact-gather"]),
    ("pagerank", ["--compact-gather", "--route-gather", "expand"]),
    ("pagerank", ["--compact-gather", "--route-gather", "fused-pf"]),
    ("pagerank", ["--compact-gather", "--route-gather"]),
    ("pagerank", ["--compact-gather", "--stream-hbm-gib", "0.001"]),
    ("pagerank", ["--serve", "--sort-segments"]),
    ("pagerank", ["--serve", "--compact-gather"]),
    ("colfilter", ["--method", "pallas", "--compact-gather"]),
    ("colfilter", ["--compact-gather", "--route-gather", "expand"]),
    ("sssp", ["--compact-gather", "--route-gather", "expand-pf"]),
    ("sssp", ["--method", "pallas", "--sort-segments"]),
    ("sssp", ["--serve", "--sort-segments"]),
    ("sssp", ["--serve", "--compact-gather"]),
    ("components", ["--compact-gather", "--stream-hbm-gib", "0.001"]),
    ("components", ["--compact-gather", "--route-gather", "expand"]),
    ("bfs", ["--compact-gather", "--route-gather", "expand-pf"]),
]
PORT_APPS = {"pagerank": pr_app.main, "colfilter": cf_app.main, "sssp": sssp_app.main,
             "components": cc_app.main, "bfs": lambda a: run_app.main(["bfs"] + a)}
REF_APPS = {"pagerank": ref_pr_app.main, "colfilter": ref_cf_app.main,
            "sssp": ref_sssp_app.main, "components": ref_cc_app.main,
            "bfs": lambda a: ref_run_app.main(["bfs"] + a)}


@pytest.mark.parametrize("app,argv", REFUSED)
def test_refusal_matrix_matches_reference(app, argv, capsys):
    """Each combination the reference refuses, the port refuses too, with
    a message before any set-up."""
    with pytest.raises(SystemExit) as ref:
        REF_APPS[app](APP + argv)
    assert ref.value.code not in (0, None)
    with pytest.raises(SystemExit) as mine:
        PORT_APPS[app](APP + argv + ["--device", "cpu"])
    msg = str(mine.value.code)
    assert mine.value.code not in (0, None)
    assert "gather" in msg or "sort-segments" in msg or "compact" in msg, msg
    assert "layout built" not in capsys.readouterr().out


@pytest.mark.parametrize("app,argv", [
    ("pagerank", ["--sort-segments", "--route-gather", "expand"]),
    ("sssp", ["--sort-segments", "--route-gather", "expand-pf"]),
    ("components", ["--sort-segments", "--compact-gather"]),
    ("bfs", ["--sort-segments", "--compact-gather", "--sources", "0,3"]),
])
def test_accepted_combinations_run(app, argv, capsys):
    """What the reference takes, the port runs: -check passes and the
    build line names the native host path."""
    assert PORT_APPS[app](APP + argv + ["-check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[PASS]" in out and "host path native" in out
