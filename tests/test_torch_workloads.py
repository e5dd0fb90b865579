"""The spec workloads in lux_tpu_torch vs lux_tpu, on the CPU: bfs, kcore,
labelprop and triangles through program/workloads, their oracles and
-check invariants, the fast host oracles meant for the card, the pull
engine's load/comp/update split, the SWAR popcount and the generic CLI.

Tolerances: bfs, kcore and triangles bitwise (integer min and sums;
triangle incidences are integer counts times integer weights, far below
2^24, so exact in f32); labelprop rtol 1e-5 against the reference's
float32 run (the sums associate in another order), and the reference's
own rtol 2e-4 / atol 1e-6 against its float64 oracle."""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lux_tpu.engine import pull as ref_pull
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph.push_shards import build_push_shards as ref_push_shards
from lux_tpu.graph.shards import build_pull_shards as ref_pull_shards
from lux_tpu.ops import expand as ref_expand
from lux_tpu.program import expr as ref_expr
from lux_tpu.program import library as ref_library
from lux_tpu.program import spec as ref_spec
from lux_tpu.program import workloads as ref_wl
from lux_tpu_torch.apps import run as run_app
from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.csc import from_edge_list
from lux_tpu_torch.graph.push_shards import build_push_shards
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.ops import expand
from lux_tpu_torch.parallel import spawn
from lux_tpu_torch.parallel.mesh import PartsGroup
from lux_tpu_torch.program import expr, library
from lux_tpu_torch.program import spec as spec_mod
from lux_tpu_torch.program import workloads as wl

METHODS = ("scan", "scatter", "mxscan", "auto")
SOURCES = (3, 77, 200)


@lru_cache(maxsize=None)
def _graphs(directed: bool = True):
    """The reference tests' fixture graph, rmat(8, 6, seed 3), in both
    packages (byte-identical), or its symmetrized view."""
    g, rg = generate.rmat(8, 6, seed=3), ref_generate.rmat(8, 6, seed=3)
    if not directed:
        g, rg = wl.symmetrize(g), ref_wl.symmetrize(rg)
    return g, rg


def _jax_plan(plan):
    return plan[0], jax.tree.map(jnp.asarray, plan[1])


@lru_cache(maxsize=None)
def _ref_bfs(engine: str, routed: bool = False):
    _, rg = _graphs()
    if engine == "push":
        sh = ref_push_shards(rg, 2)
        route = _jax_plan(ref_expand.plan_expand_shards(sh)) if routed else None
    else:
        sh = ref_pull_shards(rg, 2)
        route = _jax_plan(ref_expand.plan_expand_shards(sh)) if routed else None
    dist, it = ref_wl.bfs(sh, SOURCES, engine=engine, method="scan", route=route)
    return np.asarray(dist), it


@lru_cache(maxsize=None)
def _ref_kcore(directed: bool, kmax: int):
    return ref_wl.kcore(_graphs(directed)[1], kmax=kmax, method="scan")


# ---------------------------------------------------------------------------
# bfs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("engine", ["push", "pull"])
def test_bfs_matches_reference(engine, method):
    g, _ = _graphs()
    sh = build_push_shards(g, 2) if engine == "push" else build_pull_shards(g, 2)
    dist, it = wl.bfs(sh, SOURCES, engine=engine, method=method, device="cpu")
    want, want_it = _ref_bfs(engine)
    assert dist.dtype == np.int32 and dist.shape == (g.nv,)
    np.testing.assert_array_equal(dist, want)
    assert it == want_it
    np.testing.assert_array_equal(dist, wl.bfs_reference(g, SOURCES))


@pytest.mark.parametrize("mode", ["expand", "expand-pf"])
@pytest.mark.parametrize("engine", ["push", "pull"])
def test_bfs_routed_matches_reference(engine, mode):
    g, _ = _graphs()
    sh = build_push_shards(g, 2) if engine == "push" else build_pull_shards(g, 2)
    plan = expand.plan_expand_shards(sh.pull if engine == "push" else sh,
                                     pf=mode == "expand-pf")
    dist, it = wl.bfs(sh, SOURCES, engine=engine, method="mxscan", route=plan,
                      device="cpu")
    want, want_it = _ref_bfs(engine, routed=True)
    np.testing.assert_array_equal(dist, want)
    assert it == want_it
    np.testing.assert_array_equal(dist, _ref_bfs(engine)[0])


def test_bfs_refuses_unported_drivers():
    """The reference's refusals (``lux_tpu/program/workloads.py``): the
    ring needs a mesh, and the distributed pull-until has no routed form
    (the mesh runs themselves are the mesh cases below)."""
    g, _ = _graphs()
    with pytest.raises(ValueError, match="needs a mesh"):
        wl.bfs(g, SOURCES, exchange="ring", device="cpu")
    pg = PartsGroup(num_parts=2, rank=0, world=2, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="single-device runs only"):
        wl.bfs(build_pull_shards(g, 2), SOURCES, engine="pull", mesh=pg, route=object(),
               device="cpu")
    with pytest.raises(ValueError, match="engine"):
        wl.bfs(g, SOURCES, engine="sideways", device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        wl.bfs_program(g.nv, (g.nv,))


def test_bfs_oracles_and_check_match_reference():
    g, rg = _graphs()
    ref = wl.bfs_reference(g, SOURCES)
    np.testing.assert_array_equal(ref, ref_wl.bfs_reference(rg, SOURCES))
    np.testing.assert_array_equal(wl.bfs_reference_fast(g, SOURCES), ref)
    np.testing.assert_array_equal(wl.bfs_reference_fast(g, (5,)), wl.bfs_reference(g, (5,)))
    over = ref.copy()
    over[ref == 1] = 3
    for d in (ref, np.zeros(g.nv, np.int32), over):
        assert wl.check_bfs(g, d, SOURCES) == ref_wl.check_bfs(rg, d, SOURCES)
    assert wl.check_bfs(g, ref, SOURCES) == 0 < wl.check_bfs(g, over, SOURCES)


def test_to_csr_matches_reference():
    g, rg = _graphs()
    for got, want in zip(g.to_csr(), rg.to_csr()):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# kcore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kmax", [5, 0])
@pytest.mark.parametrize("directed", [True, False])
def test_kcore_matches_reference(directed, kmax, method):
    g, _ = _graphs(directed)
    core, k, rounds = wl.kcore(g, kmax=kmax, method=method, device="cpu")
    want = _ref_kcore(directed, kmax)
    np.testing.assert_array_equal(core, np.asarray(want[0]))
    assert (k, rounds) == (want[1], want[2])
    assert wl.check_kcore(g, core) == 0


@pytest.mark.parametrize("mode", ["fused-mx", "expand-pf"])
def test_kcore_routed_matches_reference(mode):
    g, rg = _graphs(directed=False)
    sh = build_pull_shards(g, 1)
    if mode == "fused-mx":
        plan = expand.plan_fused_shards(sh, "sum", pf=True, mx=True)
    else:
        plan = expand.plan_expand_shards(sh, pf=True)
    core, k, rounds = wl.kcore(sh, kmax=4, method="mxscan", route=plan, device="cpu")
    want = ref_wl.kcore(ref_pull_shards(rg, 1), kmax=4, method="scan")
    np.testing.assert_array_equal(core, np.asarray(want[0]))
    assert (k, rounds) == (want[1], want[2])


def test_kcore_reference_mx_route_matches():
    """The reference's own fused-mx peel equals the port's, rounds too."""
    g, rg = _graphs(directed=False)
    rsh = ref_pull_shards(rg, 1)
    rplan = _jax_plan(ref_expand.plan_fused_shards(rsh, "sum", pf=True, mx=True))
    want = ref_wl.kcore(rsh, kmax=3, method="scan", route=rplan)
    sh = build_pull_shards(g, 1)
    plan = expand.plan_fused_shards(sh, "sum", pf=True, mx=True)
    got = wl.kcore(sh, kmax=3, route=plan, device="cpu")
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1:] == tuple(want[1:])


@pytest.mark.parametrize("kmax", [0, 4])
@pytest.mark.parametrize("directed", [True, False])
def test_kcore_oracles_match_reference(directed, kmax):
    g, rg = _graphs(directed)
    ref = wl.kcore_reference(g, kmax)
    np.testing.assert_array_equal(ref, ref_wl.kcore_reference(rg, kmax))
    np.testing.assert_array_equal(wl.kcore_reference_fast(g, kmax), ref)
    bad = ref.copy()
    bad[np.argmax(ref)] += 5
    for c in (ref, bad):
        assert wl.check_kcore(g, c) == ref_wl.check_kcore(rg, c)
    assert wl.check_kcore(g, bad) > 0


def test_kcore_fast_oracle_on_a_larger_graph():
    gs = wl.symmetrize(generate.rmat(10, 8, seed=4))
    np.testing.assert_array_equal(wl.kcore_reference_fast(gs), wl.kcore_reference(gs))


def test_symmetrize_matches_reference():
    for weighted in (False, True):
        g = generate.rmat(7, 5, seed=9, weighted=weighted, max_weight=7)
        rg = ref_generate.rmat(7, 5, seed=9, weighted=weighted, max_weight=7)
        for unit in (False, True):
            got, want = wl.symmetrize(g, unit), ref_wl.symmetrize(rg, unit)
            np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
            np.testing.assert_array_equal(got.col_idx, want.col_idx)
            np.testing.assert_array_equal(got.weights, want.weights)


# ---------------------------------------------------------------------------
# labelprop
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _ref_labelprop(method: str):
    return np.asarray(ref_wl.labelprop(ref_pull_shards(_graphs()[1], 2), labels=6,
                                       stride=8, num_iters=5, method=method))


@pytest.mark.parametrize("method", METHODS)
def test_labelprop_matches_reference(method):
    g, rg = _graphs()
    probs = wl.labelprop(build_pull_shards(g, 2), labels=6, stride=8, num_iters=5,
                         method=method, device="cpu")
    assert probs.shape == (g.nv, 6) and probs.dtype == np.float32
    ref_method = "scatter" if method == "auto" else method
    np.testing.assert_allclose(probs, _ref_labelprop(ref_method), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(probs, wl.labelprop_reference(g, 6, 8, 5), rtol=2e-4,
                               atol=1e-6)
    assert wl.check_labelprop(probs, 6, 8) == 0


def test_labelprop_oracles_and_check_match_reference():
    g, rg = _graphs()
    ref = wl.labelprop_reference(g, 5, 4, 6)
    np.testing.assert_array_equal(ref, ref_wl.labelprop_reference(rg, 5, 4, 6))
    np.testing.assert_allclose(wl.labelprop_reference_fast(g, 5, 4, 6), ref, rtol=1e-12,
                               atol=1e-15)
    bad = ref.copy()
    bad[0] = 0.5
    bad[3, 0] = np.nan
    for p in (ref, bad):
        assert wl.check_labelprop(p, 5, 4) == ref_wl.check_labelprop(p, 5, 4)
    assert wl.check_labelprop(bad, 5, 4) == 3  # row 0: not one-hot, sum 2.5; row 3: NaN
    with pytest.raises(ValueError, match="labels"):
        wl.labelprop_program(1, 4)


# ---------------------------------------------------------------------------
# triangles
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _tri_graphs():
    g = wl.symmetrize(generate.rmat(7, 4, seed=9, weighted=True, max_weight=7))
    rg = ref_wl.symmetrize(ref_generate.rmat(7, 4, seed=9, weighted=True, max_weight=7))
    return g, rg


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("parts", [1, 2])
def test_triangles_match_reference(parts, method):
    g, rg = _tri_graphs()
    inc, stats = wl.triangles(g, num_parts=parts, method=method, device="cpu")
    want, want_stats = ref_wl.triangles(rg, num_parts=parts, method="scatter")
    assert inc.dtype == np.float32 and inc.shape == (g.nv,)
    np.testing.assert_array_equal(inc, np.asarray(want))
    assert stats == want_stats
    assert wl.check_triangles(g, inc) == 0


def test_triangles_complete_graph_counts_exactly():
    n = 6
    pairs = [(a, b) for a in range(n) for b in range(n) if a != b]
    es, ed = np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs])
    g6 = from_edge_list(es, ed, n, weights=np.ones(len(es), np.int32))
    inc, stats = wl.triangles(g6, device="cpu")
    assert stats["triangles_if_unit"] == 20.0
    np.testing.assert_array_equal(inc, wl.triangles_reference(g6))


def test_triangles_guards():
    g, _ = _graphs()
    with pytest.raises(ValueError, match="weighted"):
        wl.triangles(g, device="cpu")
    n = wl.TRIANGLES_MAX_NV + 1
    big = from_edge_list(np.arange(n - 1), np.arange(1, n), n,
                         weights=np.ones(n - 1, np.int32))
    with pytest.raises(ValueError, match="quadratic"):
        wl.triangles(big, device="cpu")
    dup = from_edge_list(np.array([1, 1, 2]), np.array([0, 0, 0]), 3,
                         weights=np.ones(3, np.int32))
    with pytest.raises(ValueError, match="SIMPLE"):
        wl.triangles(dup, device="cpu")
    assert wl.TRIANGLES_MAX_NV == ref_wl.TRIANGLES_MAX_NV


def test_triangle_oracles_and_check_match_reference():
    g, rg = _tri_graphs()
    ref = wl.triangles_reference(g)
    np.testing.assert_array_equal(ref, ref_wl.triangles_reference(rg))
    np.testing.assert_array_equal(wl.triangles_reference_fast(g), ref)
    np.testing.assert_array_equal(wl.triangles_reference_fast(g, chunk=7), ref)
    gu = wl.symmetrize(generate.rmat(9, 8, seed=2))
    np.testing.assert_array_equal(wl.triangles_reference_fast(gu), wl.triangles_reference(gu))
    bad = ref.copy()
    bad[np.argmax(ref)] += 1.0
    for inc in (ref, bad):
        assert wl.check_triangles(g, inc) == ref_wl.check_triangles(rg, inc)
    assert wl.check_triangles(g, bad) == 1


def test_triangle_phase1_bit_patterns_match_reference_bitsets():
    """Phase 1's int32 bit patterns are the reference's uint32 bitsets."""
    g, rg = _tri_graphs()
    sh, rsh = build_pull_shards(g, 2), ref_pull_shards(rg, 2)
    words = (g.nv + 31) // 32
    prog = wl.BitPatterns(spec_mod.bind(library.TRI_NEIGHBORS, w=words, width=words))
    arrays = to_device(sh.arrays, "cpu")
    bits = pull.run_pull_fixed(prog, sh.spec, arrays, pull.init_state(prog, arrays), 1,
                               "scan")
    assert bits.dtype == torch.int32
    rprog = ref_spec.bind(ref_library.TRI_NEIGHBORS, w=words, width=words)
    rarr = jax.tree.map(jnp.asarray, rsh.arrays)
    want = ref_pull.run_pull_fixed(rprog, rsh.spec, rarr, ref_pull.init_state(rprog, rarr),
                                   1, "scan")
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), np.asarray(want))


# ---------------------------------------------------------------------------
# the engine's phase split, the expression language
# ---------------------------------------------------------------------------

DST_SPEC = dict(name="dst_dependent", reduce="sum", init="f32(vid % 7) + 1.0",
                edge="src * f32(weight) + dst", apply="old + acc", needs_dst_state=True)


@pytest.mark.parametrize("method", ["scan", "scatter", "mxscan"])
def test_compile_pull_phases_matches_reference(method):
    g = generate.rmat(8, 6, seed=5, weighted=True, max_weight=5)
    rg = ref_generate.rmat(8, 6, seed=5, weighted=True, max_weight=5)
    sh, rsh = build_pull_shards(g, 2), ref_pull_shards(rg, 2)
    prog = spec_mod.bind(spec_mod.VertexProgramSpec(**DST_SPEC))
    rprog = ref_spec.bind(ref_spec.VertexProgramSpec(**DST_SPEC))
    arrays, rarr = to_device(sh.arrays, "cpu"), jax.tree.map(jnp.asarray, rsh.arrays)
    state, rstate = pull.init_state(prog, arrays), ref_pull.init_state(rprog, rarr)
    load, comp, update = pull.compile_pull_phases(prog, sh.spec, method)
    rload, rcomp, rupdate = ref_pull.compile_pull_phases(rprog, rsh.spec, "scan")
    gath, rgath = load(arrays, state), rload(rarr, rstate)
    for p in range(2):
        for got, want in zip(gath[p], rgath):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[p]))
    acc, racc = comp(arrays, gath), rcomp(rarr, rgath)
    np.testing.assert_allclose(acc.numpy(), np.asarray(racc), rtol=1e-5)
    new = update(arrays, state, acc)
    np.testing.assert_allclose(new.numpy(), np.asarray(rupdate(rarr, rstate, racc)),
                               rtol=1e-5)
    # one pull iteration is the three phases
    one = pull.run_pull_fixed(prog, sh.spec, arrays, state, 1, method)
    np.testing.assert_array_equal(one.numpy(), new.numpy())


def _words():
    rng = np.random.default_rng(0)
    return np.concatenate([np.array([0, 1 << 31, 0xFFFFFFFF, 1, 0x80000001, 0x7FFFFFFF,
                                     0x55555555, 0xAAAAAAAA], np.uint32),
                           rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)])


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32])
def test_swar_popcount_matches_reference(dtype):
    w = _words()
    want = np.asarray(ref_expr.run("popcount(x)", {"x": jnp.asarray(w)}))
    t = torch.from_numpy(w.view(np.int32)).view(dtype)
    got = expr.run("popcount(x)", {"x": t})
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.to(torch.int64).numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(want, [bin(int(v)).count("1") for v in w])
    with pytest.raises(TypeError, match="32-bit"):
        expr.run("popcount(x)", {"x": torch.zeros(3, dtype=torch.int64)})


@pytest.mark.parametrize("src", [
    "u32(1) << u32(vid % 32)",
    "where(vid > 9, u32(vid) - u32(20), u32(7))",
    "(u32(vid) * u32(2654435761)) >> u32(5)",
    "maximum(u32(vid) ^ u32(4294967295), u32(12))",
    "~u32(vid) & u32(65535)",
    "u32(vid) == u32(17)",
])
def test_uint32_ops_match_reference(src):
    """uint32 arithmetic runs on the int64 widening (PyTorch's CUDA build
    has none for uint32): the same values and dtype as the reference."""
    vid = np.arange(64, dtype=np.int32)
    want = np.asarray(ref_expr.run(src, {"vid": jnp.asarray(vid)}))
    got = expr.run(src, {"vid": torch.from_numpy(vid)})
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the generic CLI
# ---------------------------------------------------------------------------

SMALL = ["--rmat-scale", "7", "--rmat-ef", "5", "--device", "cpu"]


@pytest.mark.parametrize("argv, verdict", [
    (["bfs", "--sources", "0,3", "-check"], "[PASS] bfs"),
    (["bfs", "--sources", "0,3", "--engine", "pull", "-check"], "[PASS] bfs"),
    (["bfs", "--sources", "5", "--route-gather", "expand-pf", "-check"], "[PASS] bfs"),
    (["kcore", "--kmax", "3", "-check"], "[PASS] kcore"),
    (["kcore", "--route-gather", "fused-mx", "-check"], "[PASS] kcore"),
    (["kcore", "--directed", "--method", "scatter", "-check"], "[PASS] kcore"),
    (["labelprop", "--labels", "4", "-ni", "2", "-check"], "[PASS] labelprop"),
    (["triangles", "-check"], "[PASS] triangles"),
])
def test_run_cli_programs_pass_check(argv, verdict, capsys):
    assert run_app.main(argv[:1] + SMALL + argv[1:]) == 0
    out = capsys.readouterr().out
    assert verdict in out
    assert out.index("per-device memory estimate") < out.index("ELAPSED TIME")


def test_run_cli_matches_library_results(capsys):
    res = run_app.run(["kcore"] + SMALL + ["--kmax", "3"])
    g = wl.symmetrize(generate.rmat(7, 5, seed=0))
    np.testing.assert_array_equal(res.state, wl.kcore_reference(g, 3))
    res = run_app.run(["triangles"] + SMALL)
    assert "triangles (unit weights, exact)" in capsys.readouterr().out
    np.testing.assert_array_equal(res.state, wl.triangles_reference(res.graph))
    res = run_app.run(["bfs"] + SMALL + ["--sources", "0,3"])
    np.testing.assert_array_equal(res.state, wl.bfs_reference(res.graph, (0, 3)))
    assert res.stats["traversed_edges"] > 0


def test_run_cli_rejections(capsys):
    assert run_app.main(["nope"]) == 2
    assert "unknown program" in capsys.readouterr().err
    assert run_app.main([]) == 2
    assert run_app.main(["-h"]) == 0
    for argv in (["bfs", "--sources", "frog"], ["bfs", "--sources", "100000"],
                 ["labelprop", "--route-gather", "expand"],
                 ["triangles", "--route-gather", "expand"],
                 ["bfs", "--method", "pallas"], ["kcore", "--method", "pallas"],
                 ["bfs", "--engine", "pull", "--method", "cumsum"],
                 ["kcore", "--exchange", "ring"]):
        with pytest.raises(SystemExit):
            run_app.main(argv[:1] + SMALL + argv[1:])


def test_run_cli_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_app.main(["kcore", "--rmat-scale", "7"])


# ---------------------------------------------------------------------------
# the mesh drivers: 2 gloo ranks, 4 parts (2 resident a rank)
# ---------------------------------------------------------------------------

RMAT8 = ("rmat", 8, 6, 3)
MESH_CASES = {
    "bfs_push": {"kind": "workload", "graph": RMAT8, "prog": "bfs", "sources": SOURCES,
                 "parts": 4},
    "bfs_ring": {"kind": "workload", "graph": RMAT8, "prog": "bfs", "sources": SOURCES,
                 "parts": 4, "exchange": "ring"},
    "bfs_pull": {"kind": "workload", "graph": RMAT8, "prog": "bfs", "sources": SOURCES,
                 "parts": 4, "engine": "pull"},
    "bfs_rerun": {"kind": "workload", "graph": RMAT8, "prog": "bfs", "sources": SOURCES,
                  "parts": 4},
    "kcore": {"kind": "workload", "graph": RMAT8, "prog": "kcore", "parts": 4,
              "symmetrize": True},
    "labelprop": {"kind": "workload", "graph": RMAT8, "prog": "labelprop", "parts": 4,
                  "labels": 8, "stride": 16, "iters": 10},
}
MESH_APPS = {
    "bfs": ["bfs", "--sources", "0,3"],
    "bfs-ring": ["bfs", "--sources", "0,3", "--exchange", "ring"],
    "bfs-pull": ["bfs", "--sources", "0,3", "--engine", "pull"],
    "kcore": ["kcore"],
    "labelprop": ["labelprop", "--labels", "4", "-ni", "3"],
}


@pytest.fixture(scope="module")
def mesh_w2():
    cases = dict(MESH_CASES)
    for name, argv in MESH_APPS.items():
        cases[f"app-{name}"] = {"kind": "app", "app": "run",
                                "argv": argv[:1] + SMALL + ["-ng", "4", "--distributed",
                                                            "-check"] + argv[1:]}
    return spawn.run_ranks(2, "torch_mesh_jobs:run_cases", (cases,), num_parts=4,
                           device="cpu", deadline_s=300)


@lru_cache(maxsize=None)
def _ref_bfs_mesh(engine: str, exchange: str):
    from lux_tpu.parallel.mesh import make_mesh_for_parts

    _, rg = _graphs()
    mesh = make_mesh_for_parts(4, jax.devices()[:2])
    sh = ref_pull_shards(rg, 4) if engine == "pull" else (
        rg if exchange == "ring" else ref_push_shards(rg, 4))
    dist, it = ref_wl.bfs(sh, SOURCES, num_parts=4, method="scan", engine=engine,
                          mesh=mesh, exchange=exchange)
    return np.asarray(dist), int(it)


@pytest.mark.parametrize("name,engine,exchange", [("bfs_push", "push", "allgather"),
                                                  ("bfs_ring", "push", "ring"),
                                                  ("bfs_pull", "pull", "allgather")])
def test_bfs_mesh_matches_reference(name, engine, exchange, mesh_w2):
    """bfs over the ranks, bitwise the reference's mesh run and the port's
    single process (distances and iterations); every rank holds them."""
    dist, it = mesh_w2[0]["result"][name]
    want, want_it = _ref_bfs_mesh(engine, exchange)
    np.testing.assert_array_equal(dist, want)
    assert it == want_it
    g, _ = _graphs()
    sh = build_push_shards(g, 4) if engine == "push" else build_pull_shards(g, 4)
    single, single_it = wl.bfs(sh, SOURCES, engine=engine, method="scan", device="cpu")
    np.testing.assert_array_equal(dist, single)
    assert it == single_it
    assert mesh_w2[1]["result"][name] is None  # rank 1 returns nothing


def test_bfs_mesh_rerun_is_bitwise(mesh_w2):
    out = mesh_w2[0]["result"]
    assert out["bfs_push"][0].tobytes() == out["bfs_rerun"][0].tobytes()
    assert out["bfs_push"][1] == out["bfs_rerun"][1]


def test_kcore_mesh_matches_reference(mesh_w2):
    core, kmax, rounds = mesh_w2[0]["result"]["kcore"]
    ref_core, ref_kmax, ref_rounds = _ref_kcore(False, 0)
    np.testing.assert_array_equal(core, np.asarray(ref_core))
    assert (kmax, rounds) == (int(ref_kmax), int(ref_rounds))
    g, rg = _graphs(False)
    np.testing.assert_array_equal(core, ref_wl.kcore_reference(rg))
    single = wl.kcore(g, num_parts=4, method="scan", device="cpu")
    np.testing.assert_array_equal(core, single[0])
    assert (kmax, rounds) == single[1:]


def test_labelprop_mesh_matches_reference(mesh_w2):
    from lux_tpu.parallel.mesh import make_mesh_for_parts

    probs = mesh_w2[0]["result"]["labelprop"]
    _, rg = _graphs()
    want = np.asarray(ref_wl.labelprop(rg, 8, 16, 10, num_parts=4, method="scan",
                                       mesh=make_mesh_for_parts(4, jax.devices()[:2])))
    np.testing.assert_allclose(probs, want, rtol=1e-5, atol=1e-7)
    g, _ = _graphs()
    np.testing.assert_allclose(probs, wl.labelprop(g, 8, 16, 10, num_parts=4, method="scan",
                                                   device="cpu"), rtol=1e-5)
    assert wl.check_labelprop(probs, 8, 16) == 0


@pytest.mark.parametrize("name", list(MESH_APPS))
def test_run_cli_distributed(name, mesh_w2):
    """`apps.run <program> --distributed -ng 4` on 2 ranks: every rank's
    -check passes, rank 0's result is the single-process run's (bitwise
    for bfs and kcore, rtol 1e-5 for labelprop)."""
    outs = [r["result"][f"app-{name}"] for r in mesh_w2]
    assert all(o["rc"] == 0 for o in outs)
    argv = MESH_APPS[name]
    single = run_app.run(argv[:1] + SMALL + ["-ng", "4"] + [
        a for a in argv[1:] if a not in ("--exchange", "ring")])
    if name == "labelprop":
        np.testing.assert_allclose(outs[0]["state"], single.state, rtol=1e-5)
    else:
        np.testing.assert_array_equal(outs[0]["state"], single.state)
        assert all((o["iters"], o["stats"]) == (single.iters, single.stats) for o in outs)


@pytest.mark.parametrize("argv,match", [
    (["kcore", "--distributed", "--exchange", "ring"], "allgather pull layout"),
    (["labelprop", "--distributed", "--edge-shards", "2"], "allgather pull layout"),
    (["kcore", "--distributed", "--feat-shards", "2"], "allgather pull layout"),
    (["bfs", "--engine", "pull", "--distributed", "--exchange", "ring"],
     "allgather pull layout"),
    (["triangles", "--distributed"], "single-device two-phase"),
    # the pull-until surface routes single-device runs only, as in the reference
    (["bfs", "--engine", "pull", "--distributed", "--route-gather", "expand"],
     "single-device"),
], ids=["argv0-allgather pull layout", "argv1-allgather pull layout",
        "argv2-allgather pull layout", "argv3-allgather pull layout",
        "argv4-single-device two-phase",
        # the id this case had while the distributed routed gather was not ported
        "argv5-7.5"])
def test_run_cli_mesh_refusals(argv, match, capsys):
    try:
        run_app.run(argv[:1] + SMALL + argv[1:])
    except SystemExit as e:
        assert match in f"{e.code}{capsys.readouterr().err}"
    else:
        raise AssertionError(f"{argv} ran")
