"""The routed gather under the distributed engines of lux_tpu_torch
(``--route-gather`` with ``--distributed``: the allgather pull in every
mode, the ring, reduce-scatter, edge2d and feat pulls, the distributed
push's dense rounds) against lux_tpu on the CPU.

The port's ranks are gloo processes (W = 2 and 4) spawned by
``parallel/spawn.run_ranks``, one spawn group for each W shared by the
module's tests; each rank plans only its own rows (its parts, its
buckets, its cell), and the fused modes plan against the group template
agreed over the ranks.  The reference runs in this process on the
conftest's 8-device CPU mesh, its Pallas kernels in interpret mode.  The
contract: expand and expand-pf gather bitwise, so a routed run is bitwise
the direct run at the same exchange, P and method, and on the allgather
bitwise the port's single-process routed run at the same P; the fused
modes bitwise that single-process run too (one template, one plan), min,
max and int32 programs bitwise the reference, f32 sums within rtol 1e-5
of it; push runs match state, iterations and traversed edges.
"""
import jax
import numpy as np
import pytest

from lux_tpu.engine import pull as ref_pull
from lux_tpu.engine import push as ref_push
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph.push_shards import build_push_shards as ref_build_push_shards
from lux_tpu.graph.shards import build_pull_shards as ref_build_pull_shards
from lux_tpu.models import colfilter as ref_cf
from lux_tpu.models import components as ref_cc
from lux_tpu.models import pagerank as ref_pr
from lux_tpu.models import sssp as ref_sssp
from lux_tpu.ops import expand as RE
from lux_tpu.parallel import dist as ref_dist
from lux_tpu.parallel import edge2d as ref_e2d
from lux_tpu.parallel import feat as ref_feat
from lux_tpu.parallel import ring as ref_ring
from lux_tpu.parallel import scatter as ref_scatter
from lux_tpu.parallel.mesh import make_mesh_for_parts
from lux_tpu.utils import preflight as ref_preflight
from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.models import colfilter as cf_model
from lux_tpu_torch.models import components
from lux_tpu_torch.models.pagerank import PageRankProgram
from lux_tpu_torch.ops import expand as E
from lux_tpu_torch.parallel import ring, scatter, spawn
from lux_tpu_torch.utils import preflight

PR9 = ("rmat", 9, 8, 15)
CC8 = ("rmat", 8, 8, 18)
CF8 = ("cf", 128, 128, 2048, 3)
ALLGATHER_MODES = ("expand", "expand-pf", "fused", "fused-pf", "fused-mx")
SSSP_START = 1
BFS_SOURCES = [1, 7]
APP = ["--rmat-scale", "8", "--rmat-ef", "8", "--device", "cpu", "--distributed", "-check"]


def _pull(graph, prog, parts, exchange, mode="expand", **kw):
    return dict(kind="pull", graph=graph, prog=prog, parts=parts, exchange=exchange,
                mode=mode, **kw)


CASES_W2 = {
    **{f"ag-{m}": _pull(PR9, "pagerank", 4, "allgather", m) for m in ALLGATHER_MODES},
    "ag-fused-mx-max": _pull(CC8, "maxlabel", 4, "allgather", "fused-mx"),
    "ag-fused-max": _pull(CC8, "maxlabel", 4, "allgather", "fused"),
    "cf-expand": _pull(CF8, "cf", 4, "allgather", "expand"),
    "cf-expand-pf": _pull(CF8, "cf", 4, "allgather", "expand-pf"),
    "ring": _pull(PR9, "pagerank", 4, "ring"),
    "ring-max": _pull(CC8, "maxlabel", 4, "ring"),
    "scatter": _pull(PR9, "pagerank", 4, "scatter"),
    "push-ag": dict(kind="push", graph=PR9, prog="sssp", start=SSSP_START, parts=4,
                    exchange="allgather"),
    "push-ag-pf": dict(kind="push", graph=CC8, prog="maxlabel", parts=4,
                       exchange="allgather", pf=True),
    "push-ring": dict(kind="push", graph=CC8, prog="maxlabel", parts=4, exchange="ring"),
    "bfs": dict(kind="bfs", graph=PR9, parts=4, sources=BFS_SOURCES),
    "agree": dict(kind="agree", fails_on=1),
    "app-pr-fused-mx": dict(kind="app", app="pagerank", argv=APP + [
        "-ng", "4", "-ni", "4", "--route-gather", "fused-mx"]),
    "app-pr-ring": dict(kind="app", app="pagerank", argv=APP + [
        "-ng", "4", "-ni", "4", "--exchange", "ring", "--route-gather", "expand"]),
    "app-sssp": dict(kind="app", app="sssp", argv=APP + [
        "-ng", "4", "-start", str(SSSP_START), "--route-gather", "expand"]),
    "app-cc-ring": dict(kind="app", app="components", argv=APP + [
        "-ng", "4", "--exchange", "ring", "--route-gather", "expand"]),
    "app-bfs": dict(kind="app", app="run", argv=["bfs"] + APP + [
        "-ng", "4", "--sources", "1,7", "--route-gather", "expand-pf"]),
}
CASES_W4 = {
    "ag-expand-k2": _pull(PR9, "pagerank", 8, "allgather", "expand"),
    "ag-fused-k1": _pull(PR9, "pagerank", 4, "allgather", "fused"),
    "scatter-k2": _pull(PR9, "pagerank", 8, "scatter"),
    "push-ring-k1": dict(kind="push", graph=CC8, prog="maxlabel", parts=4, exchange="ring"),
    "push-ring-k2": dict(kind="push", graph=CC8, prog="maxlabel", parts=8, exchange="ring"),
    "edge2d": dict(kind="edge2d", graph=PR9, prog="pagerank", parts=2, shards=2),
    "feat": dict(kind="feat", graph=CF8, prog="cf", k=8, parts=2, shards=2),
    "app-edge2d": dict(kind="app", app="pagerank", argv=APP + [
        "-ng", "2", "-ni", "4", "--edge-shards", "2", "--route-gather", "expand"]),
}


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("routed_dist_plans"))


@pytest.fixture(scope="module")
def w2(cache_dir):
    # the ring case and the apps plan through one shared disk cache
    cases = dict(CASES_W2)
    cases["ring"] = dict(cases["ring"], cache_dir=cache_dir)
    cases["ring-again"] = dict(cases["ring"])
    for name in cases:
        if name.startswith("app-"):
            cases[name] = dict(cases[name], argv=cases[name]["argv"])
    return spawn.run_ranks(2, "torch_routed_dist_jobs:run_cases", (cases,), device="cpu",
                           deadline_s=400, env={"LUX_TORCH_PLAN_CACHE": cache_dir})


@pytest.fixture(scope="module")
def w4(cache_dir):
    return spawn.run_ranks(4, "torch_routed_dist_jobs:run_cases", (CASES_W4,), device="cpu",
                           deadline_s=400, env={"LUX_TORCH_PLAN_CACHE": cache_dir})


def _group(name, w2, w4):
    return w2 if name in CASES_W2 or name == "ring-again" else w4


def _case(name):
    return CASES_W2.get(name) or CASES_W4[name]


def _graph(mod, spec):
    if spec[0] == "cf":
        return mod.bipartite_ratings(*spec[1:4], seed=spec[4])
    return mod.rmat(spec[1], spec[2], seed=spec[3])


def _ref_prog(case, g):
    return {"pagerank": lambda: ref_pr.PageRankProgram(nv=g.nv),
            "maxlabel": ref_cc.MaxLabelProgram,
            "sssp": lambda: ref_sssp.SSSPProgram(nv=g.nv, start=case.get("start", 0)),
            "cf": lambda: ref_cf.CFProgram(k=case.get("k", 8), gamma=1e-3)}[case["prog"]]()


def _ref_plan(mode, sh, prog):
    pf = mode.endswith(("-pf", "-mx"))
    if mode.startswith("fused"):
        return RE.plan_fused_shards(sh, prog.reduce, pf=pf, mx=mode == "fused-mx")
    if getattr(prog, "k", 1) > 1:
        return RE.plan_cf_route_shards(sh, pf=pf)
    return RE.plan_expand_shards(sh, pf=pf)


def _ref_pull(case, world):
    """The reference's routed run of a pull case on ``world`` mesh devices."""
    g = _graph(ref_generate, case["graph"])
    prog = _ref_prog(case, g)
    P, ex = case["parts"], case["exchange"]
    mesh = make_mesh_for_parts(P, jax.devices()[:world])
    if ex in ("ring", "scatter"):
        mod = ref_ring if ex == "ring" else ref_scatter
        sh = (mod.build_ring_shards if ex == "ring" else mod.build_scatter_shards)(g, P)
        plan = (RE.plan_ring_route_shards if ex == "ring" else RE.plan_scatter_route_shards)(sh)
        s0 = ref_pull.init_state(prog, sh.arrays)
        drive = ref_ring.run_pull_fixed_ring if ex == "ring" else \
            ref_scatter.run_pull_fixed_scatter
        out = drive(prog, sh, s0, 4, mesh, method="scan", route=plan)
    else:
        sh = ref_build_pull_shards(g, P)
        s0 = ref_pull.init_state(prog, jax.tree.map(np.asarray, sh.arrays))
        out = ref_dist.run_pull_fixed_dist(prog, sh.spec, sh.arrays, s0, 4, mesh,
                                           method="scan", route=_ref_plan(case["mode"], sh, prog))
    return sh.scatter_to_global(np.asarray(out))


def _port_prog(case, g):
    return {"pagerank": lambda: PageRankProgram(nv=g.nv),
            "maxlabel": components.MaxLabelProgram,
            "cf": lambda: cf_model.CFProgram(k=case.get("k", 8), gamma=1e-3)}[case["prog"]]()


def _single_routed(case):
    """The port's single-process routed run of an allgather case."""
    g = _graph(generate, case["graph"])
    sh = build_pull_shards(g, case["parts"])
    prog = _port_prog(case, g)
    mode, pf = case["mode"], case["mode"].endswith(("-pf", "-mx"))
    if mode.startswith("fused"):
        plan = E.plan_fused_shards(sh, prog.reduce, pf=pf, mx=mode == "fused-mx")
    elif getattr(prog, "k", 1) > 1:
        plan = E.plan_cf_route_shards(sh, pf=pf)
    else:
        plan = E.plan_expand_shards(sh, pf=pf)
    arrays = to_device(sh.arrays, "cpu")
    out = pull.run_pull_fixed(prog, sh.spec, arrays, pull.init_state(prog, arrays), 4,
                              "scan", route=plan)
    return sh.scatter_to_global(out.numpy())


def _exact(case) -> bool:
    """Whether the case's result must be bitwise: every gather-only mode,
    and every min / max program."""
    return not case.get("mode", "expand").startswith("fused") or case["prog"] != "pagerank"


PULL = [n for n, c in {**CASES_W2, **CASES_W4}.items() if c["kind"] == "pull"]


@pytest.mark.parametrize("name", PULL)
def test_routed_pull_matches_direct_single_process_and_reference(name, w2, w4):
    case = _case(name)
    res = _group(name, w2, w4)
    got = res[0]["result"][name]
    world = len(res)
    assert all(r["result"][name]["routed"] is None for r in res[1:])
    # each rank planned only its own rows
    k = case["parts"] // world
    assert all(r["result"][name]["plan_rows"] == k for r in res)
    routed, direct = got["routed"], got["direct"]
    assert np.isfinite(routed).all()
    if _exact(case):
        np.testing.assert_array_equal(routed, direct)
    else:
        np.testing.assert_allclose(routed, direct, rtol=1e-5)
    if case["exchange"] == "allgather":
        np.testing.assert_array_equal(routed, _single_routed(case))
    ref = _ref_pull(case, world)
    if case["prog"] == "maxlabel":
        np.testing.assert_array_equal(routed, ref)
    else:
        np.testing.assert_allclose(routed, ref, rtol=1e-5, atol=1e-7)


def _ref_push(case, world):
    g = _graph(ref_generate, case["graph"])
    prog = _ref_prog(case, g)
    P = case["parts"]
    mesh = make_mesh_for_parts(P, jax.devices()[:world])
    if case["exchange"] == "ring":
        sh = ref_ring.build_push_ring_shards(g, P)
        st, it, ed = ref_push.run_push_ring(prog, sh, mesh, method="scan",
                                            route=RE.plan_ring_route_shards(sh))
    else:
        sh = ref_build_push_shards(g, P)
        st, it, ed = ref_push.run_push_dist(prog, sh, mesh, method="scan",
                                            route=RE.plan_expand_shards(
                                                sh, pf=case.get("pf", False)))
    return sh.scatter_to_global(np.asarray(st)), int(it), int(ref_push.edges_total(ed))


PUSH = [n for n, c in {**CASES_W2, **CASES_W4}.items() if c["kind"] == "push"]


@pytest.mark.parametrize("name", PUSH)
def test_routed_push_dense_rounds_match_direct_and_reference(name, w2, w4):
    res = _group(name, w2, w4)
    got = res[0]["result"][name]
    assert got["routed"][1:] == got["direct"][1:]
    np.testing.assert_array_equal(got["routed"][0], got["direct"][0])
    want, it, edges = _ref_push(_case(name), len(res))
    np.testing.assert_array_equal(got["routed"][0], want)
    assert got["routed"][1:] == (it, edges)


def test_routed_bfs_push_over_the_mesh_is_bitwise(w2):
    got = w2[0]["result"]["bfs"]
    assert got["routed"][1] == got["direct"][1]
    np.testing.assert_array_equal(got["routed"][0], got["direct"][0])
    from lux_tpu.program import workloads as ref_wl

    g = _graph(ref_generate, PR9)
    want, it = ref_wl.bfs(g, BFS_SOURCES, num_parts=4, method="scan",
                          mesh=make_mesh_for_parts(4, jax.devices()[:2]),
                          route=RE.plan_expand_shards(ref_build_push_shards(g, 4)))
    np.testing.assert_array_equal(got["routed"][0], want)
    assert got["routed"][1] == it


def test_routed_edge2d_matches_direct_and_reference(w4):
    got = w4[0]["result"]["edge2d"]
    np.testing.assert_array_equal(got["routed"], got["direct"])
    g = _graph(ref_generate, PR9)
    sh = ref_e2d.build_edge2d_shards(g, 2, 2)
    prog = ref_pr.PageRankProgram(nv=g.nv)
    out = ref_e2d.run_pull_fixed_2d(prog, sh, ref_pull.init_state(prog, sh.arrays), 4,
                                    ref_e2d.make_mesh2d(2, 2), "scan",
                                    route=RE.plan_edge2d_route_shards(sh))
    np.testing.assert_allclose(got["routed"], sh.scatter_to_global(np.asarray(out)),
                               rtol=1e-5, atol=1e-7)


def test_routed_feat_matches_direct_and_reference(w4):
    got = w4[0]["result"]["feat"]
    np.testing.assert_array_equal(got["routed"], got["direct"])
    g = _graph(ref_generate, CF8)
    sh = ref_build_pull_shards(g, 2)
    prog = ref_cf.CFProgram(k=8, gamma=1e-3)
    s0 = ref_pull.init_state(prog, jax.tree.map(np.asarray, sh.arrays))
    out = ref_feat.run_cf_feat_dist(prog, sh.spec, sh.arrays, s0, 3,
                                    ref_feat.make_mesh_feat(2, 2), method="scan",
                                    route=RE.plan_cf_route_shards(sh))
    np.testing.assert_allclose(got["routed"], sh.scatter_to_global(np.asarray(out)),
                               rtol=3e-5, atol=1e-7)


def test_ranks_share_the_bucket_cache(w2):
    """The ring case planned into one cache shared by the ranks: the first
    run builds each rank's own buckets (k x P), the second loads them all;
    the routed results agree bitwise."""
    first = [r["result"]["ring"]["plans"] for r in w2]
    again = [r["result"]["ring-again"]["plans"] for r in w2]
    assert all(p["built"] == 2 * 4 and p["loaded"] == 0 for p in first), first
    assert all(p["built"] == 0 and p["loaded"] == 2 * 4 for p in again), again
    np.testing.assert_array_equal(w2[0]["result"]["ring"]["routed"],
                                  w2[0]["result"]["ring-again"]["routed"])


APP_WANT = {"app-pr-fused-mx": "pagerank", "app-pr-ring": "pagerank",
            "app-edge2d": "pagerank"}


@pytest.mark.parametrize("name", [n for n in {**CASES_W2, **CASES_W4} if n.startswith("app-")])
def test_routed_app_runs(name, w2, w4):
    """The apps under --distributed --route-gather: every rank's -check
    passes; the state is bitwise the app's direct single-process run
    (the gather modes and min programs), or within rtol 1e-5 of it."""
    from lux_tpu_torch.apps import components as cc_app
    from lux_tpu_torch.apps import pagerank as pr_app
    from lux_tpu_torch.apps import run as run_app
    from lux_tpu_torch.apps import sssp as sssp_app

    res = _group(name, w2, w4)
    assert all(r["result"][name]["rc"] == 0 for r in res)
    got = res[0]["result"][name]
    argv = [a for a in _case(name)["argv"] if a != "--distributed"]
    rg = argv.index("--route-gather")
    argv = argv[:rg] + argv[rg + 2:]
    for flag in ("--exchange", "--edge-shards"):
        if flag in argv:
            i = argv.index(flag)
            argv = argv[:i] + argv[i + 2:]
    app = _case(name)["app"]
    if app == "run":
        want = run_app.run(argv)
        np.testing.assert_array_equal(got["state"], want.state)
        assert got["iters"] == want.iters
    elif app in ("sssp", "components"):
        want = (sssp_app if app == "sssp" else cc_app).run(argv)
        np.testing.assert_array_equal(got["state"], want.state)
        assert (got["iters"], got["edges"]) == (want.iters, want.traversed)
    else:
        want = pr_app.run(argv)
        if "fused-mx" in name:
            np.testing.assert_allclose(got["state"], want.ranks, rtol=1e-5)
        else:
            np.testing.assert_allclose(got["state"], want.ranks, rtol=1e-5, atol=1e-9)


def test_bucket_cache_incremental_ring_and_subset(tmp_path):
    """Per-bucket ring entries (tests/test_expand.py's bucket cache test):
    a warm rerun loads every bucket, the cached plan equals the uncached
    one and the reference's bitwise, and a rank's subset build loads
    exactly its rows' buckets from the same cache."""
    g = generate.rmat(8, 8, seed=22)
    rs = ring.build_ring_shards(g, 4)
    cdir = str(tmp_path / "c")
    E.reset_plan_stats()
    s1, a1 = E.plan_ring_route_shards_cached(rs, cache_dir=cdir)
    st = E.plan_stats_snapshot()
    assert st["built"] == 16 and st["loaded"] == 0
    E.reset_plan_stats()
    s2, a2 = E.plan_ring_route_shards_cached(rs, cache_dir=cdir)
    assert E.plan_stats_snapshot()["loaded"] == 16
    sd, ad = E.plan_ring_route_shards(rs)
    rsd, rad = RE.plan_ring_route_shards(ref_ring.build_ring_shards(
        ref_generate.rmat(8, 8, seed=22), 4))
    assert s1 == s2 == sd
    for x, y, z, r in zip(a1, a2, ad, rad):
        assert x.shape[:2] == (4, 4)
        assert np.array_equal(x, y) and np.array_equal(x, z)
        np.testing.assert_array_equal(x, np.asarray(r))
    sub = ring.build_ring_shards(g, 4, parts_subset=[2, 3])
    E.reset_plan_stats()
    s3, a3 = E.plan_ring_route_shards_cached(sub, cache_dir=cdir)
    st = E.plan_stats_snapshot()
    assert st["built"] == 0 and st["loaded"] == 8 and s3 == s1
    for x, y in zip(a1, a3):
        np.testing.assert_array_equal(x[2:], y)


@pytest.mark.parametrize("kind", ["ring", "scatter", "edge2d"])
def test_bucket_plans_are_the_reference_and_preflight_charges_them(kind):
    """The bucket planners are byte for byte the reference's; preflight's
    analytic bucket-plan bytes (the reference's formula) are within a
    small factor of the built plan's."""
    from lux_tpu.parallel import scatter as rsc

    g, rg = generate.rmat(9, 8, seed=16), ref_generate.rmat(9, 8, seed=16)
    if kind == "edge2d":
        from lux_tpu_torch.parallel import edge2d

        sh, rsh = edge2d.build_edge2d_shards(g, 4, 2), ref_e2d.build_edge2d_shards(rg, 4, 2)
        st, arrs = E.plan_edge2d_route_shards(sh)
        rst, rarrs = RE.plan_edge2d_route_shards(rsh)
        buckets, pad, size = 1, sh.e2_pad, 4 * sh.spec.nv_pad
    else:
        mod, rmod = (ring, ref_ring) if kind == "ring" else (scatter, rsc)
        build = "build_ring_shards" if kind == "ring" else "build_scatter_shards"
        sh, rsh = getattr(mod, build)(g, 4), getattr(rmod, build)(rg, 4)
        planner = "plan_ring_route_shards" if kind == "ring" else "plan_scatter_route_shards"
        st, arrs = getattr(E, planner)(sh)
        rst, rarrs = getattr(RE, planner)(rsh)
        buckets, pad, size = 4, sh.e_bucket_pad, sh.spec.nv_pad
    assert len(arrs) == len(rarrs) and st.n == rst.n and st.e_pad == rst.e_pad
    for x, y in zip(arrs, rarrs):
        np.testing.assert_array_equal(x, np.asarray(y))
    # a resident part holds P buckets of the ring or reduce-scatter, one cell of edge2d
    cells = arrs[0].shape[0] * (arrs[0].shape[1] if kind == "edge2d" else 1)
    per_part = sum(a.nbytes for a in arrs) // cells
    analytic = preflight.routed_bucket_plan_bytes_analytic(buckets, pad, size)
    assert analytic == ref_preflight.routed_bucket_plan_bytes_analytic(buckets, pad, size)
    assert 0.5 * per_part < analytic < 2.0 * per_part


def test_rank_template_agrees_with_the_whole_graph():
    """The fused group template of a rank's parts differs from the whole
    graph's; the max over the ranks' templates is the whole graph's."""
    g = generate.rmat(9, 8, seed=15)
    sh = build_pull_shards(g, 4)
    whole = E._group_template(sh.arrays)
    halves = [E._group_template(sh.arrays, rows) for rows in ([0, 1], [2, 3])]
    agreed = {k: max(t.get(k, 0) for t in halves) for k in set().union(*halves)}
    assert agreed == whole
    assert any(t != whole for t in halves)
    # planning a rank's rows against the agreed template is the rows of the whole plan
    s_all, a_all = E.plan_fused_shards(sh, "sum")
    s_half, a_half = E.plan_fused_shards(sh, "sum", rows=[2, 3], template=agreed)
    assert s_half == s_all
    for x, y in zip(a_all, a_half):
        np.testing.assert_array_equal(x[2:], y)


def test_a_failed_plan_fails_every_rank_alike(w2):
    """A rank whose template or plan failed: every rank raises at the same
    collective (none waits in an exchange the other never joins), and the
    group goes on agreeing after (the template is the max over ranks)."""
    got = [r["result"]["agree"] for r in w2]
    assert all("could not compute" in g["template"] for g in got)
    assert "failed on this rank: no plan here" in got[1]["planned"]
    assert "failed on another rank" in got[0]["planned"]
    assert all(g["after"] == {1: 2, 5: 2} for g in got)


@pytest.mark.parametrize("app,argv,match", [
    ("pagerank", ["--exchange", "scatter", "--route-gather", "fused-mx"], "allgather-only"),
    ("pagerank", ["--edge-shards", "2", "--route-gather", "fused"], "allgather-only"),
    ("pagerank", ["--route-gather", "expand", "-verbose"], "-verbose 3-phase"),
    ("pagerank", ["--route-gather", "expand", "--ckpt-dir", "ck", "--ckpt-every", "2"],
     "checkpointing"),
    ("pagerank", ["--route-gather", "expand", "--compact-gather"], "compact-gather"),
    ("pagerank", ["--route-gather", "--method", "pallas"], "pallas"),
    ("colfilter", ["--route-gather", "fused"], "scalar vertex state"),
    ("colfilter", ["--feat-shards", "2", "--exchange", "ring", "--route-gather", "expand"],
     "allgather-only"),
    ("sssp", ["--weighted", "--delta", "4", "--route-gather", "expand"],
     "--distributed --delta"),
    ("run", ["kcore", "--route-gather", "expand"], "single-device"),
    ("run", ["bfs", "--engine", "pull", "--route-gather", "expand"], "single-device"),
])
def test_routed_distributed_refusals(app, argv, match, capsys):
    """The pairings the reference refuses under --distributed, refused
    before any rank joins a group."""
    import importlib

    mod = importlib.import_module(f"lux_tpu_torch.apps.{app}")
    lead, rest = (argv[:1], argv[1:]) if app == "run" else ([], argv)
    with pytest.raises(SystemExit) as e:
        mod.run(lead + APP + ["-ng", "4"] + rest)
    assert match in f"{e.value.code}{capsys.readouterr().err}"


def test_expand_pf_downgrades_on_a_bucketed_exchange(capsys):
    """expand-pf on the ring (pull and push) runs the unfused family, with
    the reference's note."""
    from lux_tpu_torch.apps import common
    from lux_tpu_torch.utils.config import parse_args

    cfg = parse_args(APP + ["-ng", "4", "--exchange", "ring", "--route-gather", "expand-pf"],
                     pull=True)
    common.check_route(cfg, PageRankProgram(nv=256))
    assert cfg.route_gather == "expand"
    assert "plans per-bucket" in capsys.readouterr().err
