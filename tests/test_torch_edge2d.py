"""The 2-D (parts x edge) grid of lux_tpu_torch (parallel/edge2d.py,
parallel/mesh.Grid2D, the apps' --edge-shards arm, the preflight hint and
the traffic model) against lux_tpu.parallel.edge2d on the CPU.

The port's ranks are gloo processes spawned by
``parallel/spawn.run_ranks``: one spawn group of 4 (a 2 x 2 grid) and one
of 8 (4 x 2), shared by the module's tests; each rank builds only its
own (part, chunk).  The reference runs in this process on the conftest's
8-device CPU mesh.  Tolerances: min and max programs bitwise (states and
iterations); PageRank rtol 1e-5 (the edge shards' partial sums meet in
another order than one part's); CF rtol 3e-5 / atol 1e-7.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from lux_tpu.engine import pull as ref_pull
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph.shards import build_pull_shards as ref_build_pull_shards
from lux_tpu.models import colfilter as ref_cf
from lux_tpu.models import components as ref_cc
from lux_tpu.models import pagerank as ref_pr
from lux_tpu.parallel import edge2d as ref_e2d
from lux_tpu.program import workloads as ref_wl
from lux_tpu.utils import preflight as ref_preflight
from lux_tpu.utils import roofline as ref_roofline
from lux_tpu_torch.apps import pagerank as pr_app
from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.format import read_lux, write_lux
from lux_tpu_torch.graph.shards import build_pull_shards, edge2d_chunk_pad, to_device
from lux_tpu_torch.models import components
from lux_tpu_torch.models import pagerank as pr
from lux_tpu_torch.parallel import edge2d, mesh, spawn
from lux_tpu_torch.program import workloads as wl
from lux_tpu_torch.program.spec import active_changed
from lux_tpu_torch.utils import preflight, roofline

PR9 = ("rmat", 9, 8, 130)
ML8 = ("rmat", 8, 8, 132)
CF = ("cf", 100, 60, 1200, 133)
SOURCES = (3, 40)
APP = ["--rmat-scale", "8", "--rmat-ef", "6", "-ni", "5", "--device", "cpu"]

CASES_W4 = {
    "pr": {"kind": "edge2d", "graph": PR9, "prog": "pagerank", "parts": 2, "shards": 2},
    "pr_rerun": {"kind": "edge2d", "graph": PR9, "prog": "pagerank", "parts": 2,
                 "shards": 2},
    "maxlabel": {"kind": "edge2d", "graph": ML8, "prog": "maxlabel", "parts": 2,
                 "shards": 2, "iters": 30},
    "until_max": {"kind": "edge2d", "graph": ML8, "prog": "maxlabel", "parts": 2,
                  "shards": 2, "until": True},
    "until_min": {"kind": "edge2d", "graph": ML8, "prog": "bfs", "sources": SOURCES,
                  "parts": 2, "shards": 2, "until": True, "method": "scatter"},
    "cf": {"kind": "edge2d", "graph": CF, "prog": "cf", "parts": 2, "shards": 2,
           "iters": 3},
    "app": {"kind": "app", "app": "pagerank",
            "argv": APP + ["-ng", "2", "--edge-shards", "2", "--distributed", "--method",
                           "scan", "-check"]},
}
CASES_W8 = {
    "pr": {"kind": "edge2d", "graph": PR9, "prog": "pagerank", "parts": 4, "shards": 2},
    "until_max": {"kind": "edge2d", "graph": ML8, "prog": "maxlabel", "parts": 4,
                  "shards": 2, "until": True},
}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("edge2d_ckpt"))


@pytest.fixture(scope="module")
def w4(ckpt_dir):
    # a checkpointed run cut at 4 iterations, then resumed to 6 (rank 0
    # writes the global state; each rank restacks its own part)
    ck = APP[:4] + ["--device", "cpu", "-ng", "2", "--edge-shards", "2", "--distributed",
                    "--method", "scan", "--ckpt-dir", ckpt_dir, "--ckpt-every", "2"]
    cases = dict(CASES_W4,
                 ckpt_first={"kind": "app", "app": "pagerank", "argv": ck + ["-ni", "4"]},
                 ckpt_resumed={"kind": "app", "app": "pagerank", "argv": ck + ["-ni", "6"]})
    return spawn.run_ranks(4, "torch_mesh_jobs:run_cases", (cases,), device="cpu",
                           deadline_s=300)


@pytest.fixture(scope="module")
def w8():
    return spawn.run_ranks(8, "torch_mesh_jobs:run_cases", (CASES_W8,), device="cpu",
                           deadline_s=300)


def _graph(mod, spec):
    if spec[0] == "cf":
        return mod.bipartite_ratings(*spec[1:4], seed=spec[4])
    return mod.rmat(spec[1], spec[2], seed=spec[3])


def _ref_run(case):
    """The reference's 2-D driver on the CPU mesh for ``case``: (global
    state, iterations or None)."""
    g = _graph(ref_generate, case["graph"])
    P, EP = case["parts"], case["shards"]
    sh = ref_e2d.build_edge2d_shards(g, P, EP)
    mesh = ref_e2d.make_mesh2d(P, EP)
    prog = {"pagerank": lambda: ref_pr.PageRankProgram(nv=g.nv),
            "maxlabel": ref_cc.MaxLabelProgram,
            "bfs": lambda: ref_wl.bfs_program(g.nv, case.get("sources", ())),
            "cf": lambda: ref_cf.CFProgram(gamma=1e-3)}[case["prog"]]()
    s0 = ref_pull.init_state(prog, sh.arrays)
    method = case.get("method", "scan")
    if case.get("until"):
        active = ref_cc.active_count if case["prog"] == "maxlabel" \
            else ref_wl.active_changed_scalar
        out, it = ref_e2d.run_pull_until_2d(prog, sh, s0, 200, active, mesh, method)
        return sh.scatter_to_global(np.asarray(out)), int(it)
    out = ref_e2d.run_pull_fixed_2d(prog, sh, s0, case.get("iters", 5), mesh, method)
    return sh.scatter_to_global(np.asarray(out)), None


def _single(case):
    """The port's single-process pull run of ``case`` at the same parts."""
    g = _graph(generate, case["graph"])
    sh = build_pull_shards(g, case["parts"])
    arrays = to_device(sh.arrays, "cpu")
    prog = {"maxlabel": components.MaxLabelProgram,
            "bfs": lambda: wl.bfs_program(g.nv, case.get("sources", ()))}[case["prog"]]()
    s0 = pull.init_state(prog, arrays)
    method = case.get("method", "scan")
    if case.get("until"):
        out, it = pull.run_pull_until(prog, sh.spec, arrays, s0, 200,
                                      active_changed if case["prog"] == "bfs"
                                      else components.active_count_stacked, method)
        return sh.scatter_to_global(out.numpy()), int(it)
    out = pull.run_pull_fixed(prog, sh.spec, arrays, s0, case.get("iters", 5), method)
    return sh.scatter_to_global(out.numpy()), None


@pytest.mark.parametrize("world,parts", [(4, 2), (8, 4)])
def test_pagerank_matches_reference(world, parts, w4, w8):
    res = w4 if world == 4 else w8
    got, _ = res[0]["result"]["pr"]
    case = (CASES_W4 if world == 4 else CASES_W8)["pr"]
    want, _ = _ref_run(case)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    g = _graph(generate, PR9)
    np.testing.assert_allclose(got, pr.pagerank(g, 5, num_parts=parts, method="scan",
                                                device="cpu"), rtol=1e-5)
    np.testing.assert_allclose(got, ref_pr.pagerank_reference(_graph(ref_generate, PR9), 5),
                               rtol=3e-5)
    assert all(r["result"]["pr"][0] is None for r in res[1:])


def test_rerun_is_bitwise(w4):
    out = w4[0]["result"]
    assert out["pr"][0].tobytes() == out["pr_rerun"][0].tobytes()


@pytest.mark.parametrize("name", ["maxlabel", "until_max", "until_min"])
def test_min_max_programs_are_bitwise(name, w4):
    got, it = w4[0]["result"][name]
    want, want_it = _ref_run(CASES_W4[name])
    np.testing.assert_array_equal(got, want)
    single, single_it = _single(CASES_W4[name])
    np.testing.assert_array_equal(got, single)
    assert it == want_it == single_it
    if name != "until_min":
        assert ref_cc.check_labels(_graph(ref_generate, ML8), got) == 0


def test_until_on_a_four_by_two_grid(w8):
    got, it = w8[0]["result"]["until_max"]
    want, want_it = _ref_run(CASES_W8["until_max"])
    np.testing.assert_array_equal(got, want)
    assert it == want_it and 1 <= it < 200


def test_weighted_cf_matches_reference(w4):
    got, _ = w4[0]["result"]["cf"]
    want, _ = _ref_run(CASES_W4["cf"])
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=1e-7)
    g = _graph(ref_generate, CF)
    np.testing.assert_allclose(got, ref_cf.colfilter_reference(g, 3, gamma=1e-3), rtol=3e-5,
                               atol=1e-7)


def test_pagerank_app_edge_shards(w4):
    """`apps.pagerank -ng 2 --edge-shards 2 --distributed` on 4 ranks:
    -check passes on every rank, rank 0 alone holds the ranks, within
    rtol 1e-5 of the single-process -ng 2 run."""
    outs = [r["result"]["app"] for r in w4]
    assert all(o["rc"] == 0 for o in outs) and all(o["state"] is None for o in outs[1:])
    single = pr_app.run(APP + ["-ng", "2", "--method", "scan"])
    np.testing.assert_allclose(outs[0]["state"], single.ranks, rtol=1e-5)


def test_checkpointed_edge2d_run_resumes(w4, ckpt_dir):
    import os

    first, resumed = w4[0]["result"]["ckpt_first"], w4[0]["result"]["ckpt_resumed"]
    assert (first["iters"], resumed["iters"]) == (4, 2) and first["rc"] == resumed["rc"] == 0
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt_2.npz", "ckpt_4.npz", "ckpt_6.npz"]
    want = pr.pagerank(generate.rmat(8, 6, seed=0), 6, num_parts=2, method="scan",
                       device="cpu")
    np.testing.assert_allclose(resumed["state"], want, rtol=1e-5)


@pytest.mark.parametrize("parts,shards,weighted", [(4, 2, True), (2, 4, False), (3, 3, True)])
def test_layout_is_the_reference(parts, shards, weighted):
    """The chunks are byte for byte the reference's; a rank's build of its
    own (part, chunk) holds that row of the full build."""
    g = generate.rmat(8, 6, seed=131, weighted=weighted)
    rg = ref_generate.rmat(8, 6, seed=131, weighted=weighted)
    mine = edge2d.build_edge2d_shards(g, parts, shards)
    ref = ref_e2d.build_edge2d_shards(rg, parts, shards)
    assert mine.e2_pad == ref.e2_pad and vars(mine.spec) == vars(ref.spec)
    np.testing.assert_array_equal(mine.cuts, ref.cuts)
    for name in ref.arrays2d._fields:
        np.testing.assert_array_equal(getattr(mine.arrays2d, name),
                                      np.asarray(getattr(ref.arrays2d, name)), err_msg=name)
    p, e = parts - 1, shards - 1
    one = edge2d.build_edge2d_shards(g, parts, shards, parts_subset=[p], chunks_subset=[e])
    for name in ("src_pos", "dst_local", "head_flag", "weights"):
        np.testing.assert_array_equal(getattr(one.arrays2d, name)[0, 0],
                                      getattr(mine.arrays2d, name)[p, e], err_msg=name)
    for name in ("vtx_mask", "degree", "global_vid"):
        np.testing.assert_array_equal(getattr(one.arrays2d, name)[0],
                                      getattr(mine.arrays2d, name)[p], err_msg=name)


def test_file_build_reads_its_chunk(tmp_path):
    """From a .lux file (memory-mapped, each chunk read by range) the
    arrays are those of the in-memory build."""
    g = generate.rmat(8, 6, seed=12, weighted=True)
    path = str(tmp_path / "g.lux")
    write_lux(path, g)
    gm = read_lux(path)
    want = edge2d.build_edge2d_shards(g, 2, 3)
    for p, e in ((0, 0), (1, 2)):
        one = edge2d.build_edge2d_shards(gm, 2, 3, parts_subset=[p], chunks_subset=[e],
                                         path=path)
        for name in ("src_pos", "dst_local", "head_flag", "weights"):
            np.testing.assert_array_equal(getattr(one.arrays2d, name)[0, 0],
                                          getattr(want.arrays2d, name)[p, e], err_msg=name)
        np.testing.assert_array_equal(one.arrays2d.degree[0], want.arrays2d.degree[p])


def test_every_edge_lands_in_exactly_one_chunk():
    g = generate.rmat(8, 6, seed=131)
    sh = edge2d.build_edge2d_shards(g, 2, 4)
    a, V = sh.arrays2d, sh.spec.nv_pad
    assert int((a.dst_local < V).sum()) == g.ne
    one_d = build_pull_shards(g, 2)
    for p in range(2):
        real = a.dst_local[p] < V
        got = sorted(zip(a.src_pos[p][real].tolist(), a.dst_local[p][real].tolist()))
        m = one_d.arrays.edge_mask[p]
        want = sorted(zip(one_d.arrays.src_pos[p][m].tolist(),
                          one_d.arrays.dst_local[p][m].tolist()))
        assert got == want


def test_chunk_pad_estimate_and_suggestion_are_the_reference():
    from lux_tpu.graph.shards import edge2d_chunk_pad as ref_pad

    for m, ep in ((1, 1), (1000, 3), (4097, 4), (0, 2)):
        assert edge2d_chunk_pad(m, ep) == ref_pad(m, ep)
    g = generate.rmat(10, 16, seed=133)
    sh = build_pull_shards(g, 2)
    rsh = ref_build_pull_shards(ref_generate.rmat(10, 16, seed=133), 2)
    for width, sbytes in ((1, 4), (20, 2)):
        for e2 in (128, 4096):
            assert vars(preflight.estimate_edge2d(sh.spec, e2, width, sbytes)) == \
                vars(ref_preflight.estimate_edge2d(rsh.spec, e2, width, sbytes))
        full = ref_preflight.estimate_pull(rsh.spec, width, sbytes).total_bytes
        for budget in (full // 4, full // 2, full - 1, full * 2):
            assert preflight.suggest_edge_shards(sh.spec, budget, width, sbytes) == \
                ref_preflight.suggest_edge_shards(rsh.spec, budget, width, sbytes)


def test_the_hint_names_edge_shards_when_one_fits():
    g = generate.rmat(9, 8, seed=134)
    sh = build_pull_shards(g, 2)
    est = preflight.estimate_pull(sh.spec)
    floor = preflight.estimate_edge2d(sh.spec, 128).total_bytes
    assert preflight.suggest_edge_shards(sh.spec, floor - 1) is None

    def said(**kw):
        buf = io.StringIO()
        with redirect_stdout(buf):
            ok = preflight.check_fits(est, spec=sh.spec, **kw)
        return ok, buf.getvalue()

    ok, out = said(hbm_bytes=est.total_bytes - 1, max_edge_shards=8)
    assert not ok and "--edge-shards" in out
    assert "--edge-shards" not in said(hbm_bytes=floor - 1, max_edge_shards=8)[1]
    ok, out = said(hbm_bytes=est.total_bytes - 1, max_edge_shards=1)
    assert not ok and "--edge-shards" not in out  # no grid of these ranks would run
    assert said(hbm_bytes=est.total_bytes)[0]


@pytest.mark.parametrize("method", ["scan", "scatter", "mxscan"])
def test_traffic_model_is_the_reference(method):
    for ne, nv, P in ((1 << 16, 1 << 12, 4), (12345, 678, 3)):
        for ep in (1, 2, 4, 8):
            for sb, weighted in ((4, False), (2, True)):
                m = roofline.edge2d_iter_model(ne, nv, P, ep, method, sb, weighted)
                r = ref_roofline.edge2d_iter_model(ne, nv, P, ep, method, sb, weighted)
                assert m["ici_bytes"] == r["ici_bytes"]
                assert m["replication_factor"] == r["replication_factor"]
                assert (m["hbm"].bytes_moved, m["hbm"].flops, m["hbm"].device_flops) == \
                    (r["hbm"].bytes_moved, r["hbm"].flops, r["hbm"].device_flops)


@pytest.mark.parametrize("argv,match", [
    (["--edge-shards", "2"], "requires --distributed"),
    (["-ng", "4", "--distributed", "--edge-shards", "2", "--exchange", "ring"],
     "own exchange"),
    (["-ng", "2", "--distributed", "--edge-shards", "2", "--method", "mxsum"],
     "scan or scatter"),
    (["-ng", "2", "--distributed", "--edge-shards", "2", "--method", "pallas"],
     "1-D mesh"),
    (["-ng", "2", "--distributed", "--edge-shards", "2", "--sort-segments"],
     "relay out"),
    (["-ng", "2", "--distributed", "--edge-shards", "2", "--method", "scan"],
     "4 devices needed"),
    (["--edge-shards", "2", "--stream-hbm-gib", "0.001"], "host-offload"),
])
def test_cli_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        pr_app.run(APP + argv)


def test_engine_refusals():
    g = generate.rmat(6, 4, seed=1)
    sh = edge2d.build_edge2d_shards(g, 1, 2)
    prog = pr.PageRankProgram(nv=g.nv)
    grid = mesh.Grid2D(parts=mesh.PartsGroup(num_parts=1, rank=0, world=1,
                                             device=torch.device("cpu"), backend="gloo"),
                       axis="edge", size=2, index=0)
    # the chunks route their gather with expand plans only
    with pytest.raises(ValueError, match="expand plans"):
        edge2d.run_pull_fixed_2d(prog, sh, None, 1, grid, route=(object(), ()))
    with pytest.raises(ValueError, match="scan' or 'scatter"):
        edge2d.run_pull_fixed_2d(prog, sh, None, 1, grid, method="mxscan")
    with pytest.raises(ValueError, match="one part a part row"):
        edge2d.run_pull_fixed_2d(prog, edge2d.build_edge2d_shards(g, 2, 2), None, 1,
                                 mesh.Grid2D(parts=mesh.PartsGroup(
                                     num_parts=2, rank=0, world=1, device=torch.device("cpu"),
                                     backend="gloo"), axis="edge", size=2, index=0))
    assert edge2d.resolve_method("auto", "sum", torch.device("cpu")) in ("scan", "scatter")
