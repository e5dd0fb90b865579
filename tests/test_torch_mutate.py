"""lux_tpu_torch.mutate against lux_tpu.mutate, on the CPU.

Seeded numpy RMAT graphs (scale <= 9, two parts) and one churn sequence
feed the reference (jax) and the port side by side.  Held: the delta-log,
its journal (either package replays the other's) and compaction
bitwise; the overlay arrays bitwise; the min/max overlay steps
and the SSSP / CC refreshes bitwise, against the reference and against a
cold rebuild of the merged graph; PageRank's refresh within rtol 1e-5 of
the reference's (another sum association) and its tolerance band against
a float64 oracle."""
import os

import numpy as np
import pytest
import torch

from lux_tpu.engine import pull as ref_pull
from lux_tpu.graph import csc as ref_csc
from lux_tpu.models import components as ref_comp
from lux_tpu.mutate import DeltaLog as RefDeltaLog
from lux_tpu.mutate import MutableGraph as RefMutableGraph
from lux_tpu.mutate import overlay as ref_ovl
from lux_tpu.mutate import refresh as ref_refresh
from lux_tpu_torch.engine import pull, push
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.csc import from_edge_list
from lux_tpu_torch.graph.format import read_lux
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.models import components as comp
from lux_tpu_torch.models.pagerank import ALPHA, _host_iteration
from lux_tpu_torch.models.sssp import SSSPProgram, WeightedSSSPProgram, bfs_reference
from lux_tpu_torch.mutate import (
    DeltaLog,
    DeltaOverflow,
    MutableGraph,
    OP_DELETE,
    OP_INSERT,
    build_pull_overlay,
)
from lux_tpu_torch.mutate import overlay as ovl
from lux_tpu_torch.mutate import refresh
from lux_tpu_torch.ops import expand, scan, shuffle

CPU = "cpu"
PR_RTOL = 1e-5


def ref_graph(g):
    return ref_csc.HostGraph(g.nv, g.ne, g.row_ptr.copy(), g.col_idx.copy(),
                             None if g.weights is None else g.weights.copy())


def churn_batches(g, rng, n_batches, k, oracle):
    """Random mixed batches (the reference test's generator), mutating
    the python ``oracle`` edge list by the delete-newest-match rule."""
    for _ in range(n_batches):
        srcs, dsts, ops, ws = [], [], [], []
        for _ in range(k):
            if rng.random() < 0.45 and oracle:
                u, v, w = oracle[rng.integers(len(oracle))]
                for i in range(len(oracle) - 1, -1, -1):
                    if oracle[i][0] == u and oracle[i][1] == v:
                        del oracle[i]
                        break
                srcs.append(u)
                dsts.append(v)
                ops.append(OP_DELETE)
                ws.append(0)
            else:
                u, v, w = int(rng.integers(g.nv)), int(rng.integers(g.nv)), int(rng.integers(1, 9))
                oracle.append((u, v, w))
                srcs.append(u)
                dsts.append(v)
                ops.append(OP_INSERT)
                ws.append(w)
        yield srcs, dsts, ops, ws


def churn(g, rng, ndel, nins):
    """Two batches: ``ndel`` distinct base-edge deletes, then ``nins``
    uniform inserts."""
    dele = rng.choice(g.ne, ndel, replace=False)
    return [(g.col_idx[dele], g.dst_of_edges()[dele], np.full(ndel, OP_DELETE, np.int8)),
            (rng.integers(0, g.nv, nins), rng.integers(0, g.nv, nins),
             np.full(nins, OP_INSERT, np.int8))]


@pytest.fixture(scope="module")
def churned():
    """One graph churned the same way in both packages (two parts)."""
    g = generate.rmat(9, 8, seed=13)
    rng = np.random.default_rng(2)
    batches = churn(g, rng, 25, 40)
    mg, rmg = MutableGraph(g, num_parts=2), RefMutableGraph(ref_graph(g), num_parts=2)
    for b in batches:
        mg.apply(*b)
        rmg.apply(*b)
    return g, mg, rmg


def assert_graph_equal(a, b):
    assert (a.nv, a.ne) == (b.nv, b.ne)
    np.testing.assert_array_equal(np.asarray(a.row_ptr), np.asarray(b.row_ptr))
    np.testing.assert_array_equal(np.asarray(a.col_idx), np.asarray(b.col_idx))
    if a.weights is None:
        assert b.weights is None
    else:
        np.testing.assert_array_equal(np.asarray(a.weights), np.asarray(b.weights))


@pytest.mark.parametrize("seed", [3, 11])
def test_compact_bitwise_vs_scratch_and_reference(seed, tmp_path):
    """Any insert/delete batch sequence applied through the delta-log
    and compacted equals the merged graph built from scratch and the
    reference's merged graph, bitwise, through the .lux round trip."""
    g = generate.rmat(9, 8, seed=seed, weighted=True, max_weight=9)
    rng = np.random.default_rng(seed)
    oracle = list(zip(g.col_idx.tolist(), g.dst_of_edges().tolist(),
                      np.asarray(g.weights).tolist()))
    mg = MutableGraph(g, num_parts=2)
    rlog = RefDeltaLog(ref_graph(g))
    for batch in churn_batches(g, rng, 4, 50, oracle):
        mg.apply(*batch)
        rlog.apply(*batch)
    ref_merged = rlog.merged_graph()
    assert_graph_equal(mg.log.merged_graph(), ref_merged)
    snap = str(tmp_path / "merged.lux")
    rep = mg.compact(path=snap)
    want = from_edge_list(np.array([e[0] for e in oracle]), np.array([e[1] for e in oracle]),
                          g.nv, weights=np.array([e[2] for e in oracle], np.int32))
    assert_graph_equal(read_lux(snap), want)
    assert_graph_equal(mg.base, want)
    assert rep["ne"] == want.ne and mg.log.empty


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_replays_across_packages(writer, tmp_path):
    """A journal written by either package replays in the other to a
    bitwise-equal merged graph; a batch whose npz landed without its
    .ok marker (a crash in the append window) is dropped and removed."""
    g = generate.rmat(8, 4, seed=3)
    jd = str(tmp_path / "journal")
    w_cls, r_cls = (RefDeltaLog, DeltaLog) if writer == "reference" else (DeltaLog, RefDeltaLog)
    base_w = ref_graph(g) if writer == "reference" else g
    base_r = g if writer == "reference" else ref_graph(g)
    log = w_cls(base_w, journal_dir=jd)
    log.apply([1, 5], [2, 9], [OP_INSERT, OP_INSERT], [5, 7])
    u, v = int(g.col_idx[0]), int(g.dst_of_edges()[0])
    log.apply([2, 1, u], [3, 2, v], [OP_INSERT, OP_DELETE, OP_DELETE], [6, 0, 0])
    seq = log._journal_write_batch(np.array([7]), np.array([8]),
                                   np.array([OP_INSERT], np.int8), np.array([9]))
    back = r_cls(base_r, journal_dir=jd)
    assert back.stats() == {"inserts_live": 2, "inserts_total": 3, "deletes_base": 1,
                            "batches": 2}
    assert not os.path.exists(back._batch_path(seq))
    assert_graph_equal(back.merged_graph(), log.merged_graph())
    # the reader keeps appending where the writer stopped
    back.apply([4], [4], [OP_INSERT], [1])
    again = w_cls(base_w, journal_dir=jd)
    assert again.stats()["batches"] == 3
    assert_graph_equal(again.merged_graph(), back.merged_graph())


def test_overlay_arrays_bitwise_reference(churned):
    """build_pull_overlay and build_push_overlay (with the patched CSR)
    give the reference's arrays bitwise; the push layout's CSR is the
    stable source sort push_csr_perms assumes."""
    g, mg, rmg = churned
    st, oa = mg.pull_overlay()
    rst, roa = rmg.pull_overlay()
    assert (st.cap, st.weighted) == (rst.cap, rst.weighted)
    for a, b in zip(oa, roa):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    pst, poa, parr = mg.push_overlay()
    rpst, rpoa, rparr = rmg.push_overlay()
    for a, b in zip(tuple(poa) + tuple(parr), tuple(rpoa) + tuple(rparr)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the CSR slot of each CSC slot holds that slot's destination
    ps = mg.push_shards
    for p, perm in enumerate(mg.csr_perms()):
        n = len(perm)
        np.testing.assert_array_equal(ps.parrays.csr_dst_local[p, perm],
                                      ps.arrays.dst_local[p, :n])
    np.testing.assert_array_equal(ovl.merged_degree_stacked(mg.pull_shards, mg.log),
                                  ref_ovl.merged_degree_stacked(rmg.pull_shards, rmg.log))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_overlay_step_max_bitwise(churned, n):
    """The max-label overlay pull step over n iterations equals the step
    on cold-rebuilt merged shards and the reference's overlay step,
    bitwise."""
    g, mg, rmg = churned
    prog = comp.MaxLabelProgram()
    sh = mg.pull_shards
    sh_m = build_pull_shards(mg.log.merged_graph(), 2, cuts=np.asarray(sh.cuts))
    arr, arr_m = to_device(sh.arrays, CPU), to_device(sh_m.arrays, CPU)
    a = pull.run_pull_fixed(prog, sh.spec, arr, pull.init_state(prog, arr), n,
                            method="scan", overlay=mg.pull_overlay())
    b = pull.run_pull_fixed(prog, sh_m.spec, arr_m, pull.init_state(prog, arr_m), n,
                            method="scan")
    got = sh.scatter_to_global(a.numpy())
    np.testing.assert_array_equal(got, sh_m.scatter_to_global(b.numpy()))
    rprog = ref_comp.MaxLabelProgram()
    rsh = rmg.pull_shards
    r = ref_pull.run_pull_fixed(rprog, rsh.spec, rsh.arrays,
                                ref_pull.init_state(rprog, rsh.arrays), n,
                                method="scan", overlay=rmg.pull_overlay())
    np.testing.assert_array_equal(got, rsh.scatter_to_global(np.asarray(r)))


def _plan(sh, family):
    if family == "expand-pf":
        return expand.plan_expand_shards(sh, pf=True)
    if family == "fused-mx":
        return expand.plan_fused_shards(sh, "max", mx=True)
    return expand.plan_fused_shards(sh, "max", pf=family == "fused-pf")


@pytest.mark.parametrize("family", ["expand-pf", "fused", "fused-pf", "fused-mx"])
def test_overlay_routed_families_bitwise(churned, family):
    """The overlay on a BASE-graph plan of every routed family (the fused
    ones tombstone in group space through gslot) equals the cold
    merged-graph step bitwise for the max reduce."""
    g, mg, _ = churned
    prog = comp.MaxLabelProgram()
    sh = mg.pull_shards
    sh_m = build_pull_shards(mg.log.merged_graph(), 2, cuts=np.asarray(sh.cuts))
    arr, arr_m = to_device(sh.arrays, CPU), to_device(sh_m.arrays, CPU)
    plan = _plan(sh, family)
    for n in (1, 3):
        want = pull.run_pull_fixed(prog, sh_m.spec, arr_m, pull.init_state(prog, arr_m), n,
                                   method="scan")
        got = pull.run_pull_fixed(prog, sh.spec, arr, pull.init_state(prog, arr), n,
                                  method="scan", overlay=mg.pull_overlay(), route=plan)
        np.testing.assert_array_equal(sh.scatter_to_global(got.numpy()),
                                      sh_m.scatter_to_global(want.numpy()))
    cf = expand.plan_cf_route_shards(sh)
    with pytest.raises(ValueError, match="CF route"):
        pull.run_pull_fixed(prog, sh.spec, arr, pull.init_state(prog, arr), 1,
                            overlay=mg.pull_overlay(), route=cf)


@pytest.mark.parametrize("app", ["sssp", "components"])
def test_refresh_push_bitwise_reference_and_cold(app):
    """Two churn rounds with a refresh after each: the port's SSSP / CC
    refresh equals the reference's refresh, a cold run on the merged
    graph and the host oracle, bitwise."""
    g = generate.rmat(9, 8, seed=4)
    rng = np.random.default_rng(4)
    mg, rmg = MutableGraph(g, num_parts=2), RefMutableGraph(ref_graph(g), num_parts=2)
    start = int(np.argmax(np.bincount(g.col_idx, minlength=g.nv)))
    if app == "sssp":
        st, _, _ = push.run_push(SSSPProgram(nv=g.nv, start=start), mg.push_shards, device=CPU)
        state = mg.push_shards.scatter_to_global(st.numpy())
    else:
        state = comp.connected_components_push(g, num_parts=2, device=CPU)
    rstate = state.copy()
    for _ in range(2):
        for b in churn(g, rng, 15, 20):
            mg.apply(*b)
            rmg.apply(*b)
        if app == "sssp":
            # the level-by-level cascade marks the reference's queue closure
            np.testing.assert_array_equal(refresh.sssp_dirty(mg, state, start),
                                          ref_refresh.sssp_dirty(rmg, rstate, start))
            state, it = refresh.refresh_sssp(mg, state, start, device=CPU)
            rstate, rit = ref_refresh.refresh_sssp(rmg, rstate, start)
            want = bfs_reference(mg.log.merged_graph(), start)
        else:
            state, it = refresh.refresh_components(mg, state, device=CPU)
            rstate, rit = ref_refresh.refresh_components(rmg, rstate)
            want = comp.fixpoint_labels(mg.log.merged_graph())
        np.testing.assert_array_equal(state, np.asarray(rstate))
        assert it == int(rit)
        np.testing.assert_array_equal(state, want)
    cold = (push.run_push(SSSPProgram(nv=g.nv, start=start),
                          build_push_shards_merged(mg), device=CPU)[0]
            if app == "sssp" else None)
    if cold is not None:
        np.testing.assert_array_equal(state, mg.push_shards.scatter_to_global(cold.numpy()))


def build_push_shards_merged(mg):
    from lux_tpu_torch.graph.push_shards import build_push_shards

    return build_push_shards(mg.log.merged_graph(), 2, cuts=np.asarray(mg.push_shards.cuts))


def test_weighted_refresh_and_zero_weight_guard():
    g = generate.rmat(9, 8, seed=5, weighted=True, max_weight=9)
    rng = np.random.default_rng(3)
    mg = MutableGraph(g, num_parts=2)
    start = int(np.argmax(np.bincount(g.col_idx, minlength=g.nv)))
    st, _, _ = push.run_push(WeightedSSSPProgram(nv=g.nv, start=start), mg.push_shards,
                             device=CPU)
    dist = mg.push_shards.scatter_to_global(st.numpy())
    dele = rng.choice(g.ne, 20, replace=False)
    mg.apply(g.col_idx[dele], g.dst_of_edges()[dele], np.full(20, OP_DELETE, np.int8))
    mg.apply(rng.integers(0, g.nv, 20), rng.integers(0, g.nv, 20),
             np.full(20, OP_INSERT, np.int8), rng.integers(1, 9, 20))
    rmg = RefMutableGraph(ref_graph(g), num_parts=2)
    for b in ((g.col_idx[dele], g.dst_of_edges()[dele], np.full(20, OP_DELETE, np.int8)),):
        rmg.apply(*b)
    rmg.apply(*[np.asarray(x) for x in (mg.log.ins_src, mg.log.ins_dst)],
              np.full(20, OP_INSERT, np.int8), mg.log.ins_w)
    np.testing.assert_array_equal(refresh.sssp_dirty(mg, dist, start, weighted=True),
                                  ref_refresh.sssp_dirty(rmg, dist, start, weighted=True))
    got, _ = refresh.refresh_sssp(mg, dist, start, weighted=True, device=CPU)
    cold, _, _ = push.run_push(WeightedSSSPProgram(nv=g.nv, start=start),
                               build_push_shards_merged(mg), device=CPU)
    np.testing.assert_array_equal(got, mg.push_shards.scatter_to_global(cold.numpy()))
    mg0 = MutableGraph(g, num_parts=2)
    mg0.apply([1], [2], [OP_INSERT], [0])
    mg0.log.apply(g.col_idx[:1], g.dst_of_edges()[:1], [OP_DELETE], [0])
    with pytest.raises(ValueError, match="positive"):
        refresh.sssp_dirty(mg0, dist, start, weighted=True)


def _oracle_fixpoint(merged):
    """float64 fixpoint of the merged graph's recurrence (200 host
    iterations of an ALPHA-contraction)."""
    deg = merged.out_degrees().astype(np.float64)
    st = np.where(deg > 0, (1.0 / merged.nv) / np.maximum(deg, 1.0), 1.0 / merged.nv)
    for _ in range(200):
        st = _host_iteration(merged, st, deg)
    return st


def test_refresh_pagerank_vs_reference_and_oracle(churned):
    """The exact refresh lands within rtol 1e-5 of the reference's (the
    base reduce associates differently; the insert fold is the
    reference's sequential order) and within f32 noise of the float64
    fixpoint; two refreshes from one prior are bitwise equal; the
    tolerance band (1e-4) holds against the oracle in fewer iterations."""
    g, mg, rmg = churned
    base = build_pull_shards(g, 2)
    pr0, _ = refresh.converge_pagerank(base, device=CPU)
    rpr0, _ = ref_refresh.converge_pagerank(rmg_base_shards(g))
    got, it = refresh.refresh_pagerank(mg, pr0, device=CPU)
    again, it2 = refresh.refresh_pagerank(mg, pr0, device=CPU)
    assert torch.equal(got, again) and it == it2
    want, _ = ref_refresh.refresh_pagerank(rmg, rpr0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PR_RTOL, atol=0)
    oracle = _oracle_fixpoint(mg.log.merged_graph())
    glob = mg.pull_shards.scatter_to_global(got.numpy()).astype(np.float64)
    assert np.max(np.abs(glob - oracle)) <= 1e-8
    tol = 1e-4
    band, it_band = refresh.refresh_pagerank(mg, pr0, tolerance=tol, device=CPU)
    err = np.max(np.abs(mg.pull_shards.scatter_to_global(band.numpy()) - oracle))
    assert err <= tol and it_band <= it
    assert refresh.pagerank_probe(0.0) is refresh._changed_count
    assert refresh.pagerank_probe(tol) is refresh.pagerank_probe(tol)
    assert refresh.pagerank_tolerance_threshold(tol) == pytest.approx(tol * (1 - ALPHA))


def rmg_base_shards(g):
    from lux_tpu.graph.shards import build_pull_shards as ref_build

    return ref_build(ref_graph(g), 2)


def test_overflow_compacts_first_and_lone_batch_raises():
    g = generate.rmat(9, 8, seed=5)
    rng = np.random.default_rng(1)
    mg = MutableGraph(g, num_parts=2, cap=128)
    st = mg.apply(rng.integers(0, g.nv, 100), np.full(100, 3), np.full(100, OP_INSERT, np.int8))
    assert not st["compacted"]
    st = mg.apply(rng.integers(0, g.nv, 100), np.full(100, 3), np.full(100, OP_INSERT, np.int8))
    assert st["compacted"] and mg.compactions == 1
    assert mg.base.ne == g.ne + 100 and mg.log.stats()["inserts_live"] == 100
    with pytest.raises(DeltaOverflow, match="on its own"):
        mg.apply(rng.integers(0, g.nv, 200), np.full(200, 3), np.full(200, OP_INSERT, np.int8))
    log = DeltaLog(g)
    log.apply(rng.integers(0, g.nv, 200), np.full(200, 3), np.full(200, OP_INSERT, np.int8))
    with pytest.raises(DeltaOverflow):
        build_pull_overlay(MutableGraph(g, num_parts=2, cap=128).pull_shards, log, cap=128)


def test_missing_delete_raises_and_failed_batch_leaves_log(tmp_path):
    g = generate.rmat(8, 4, seed=3)
    log = DeltaLog(g, journal_dir=str(tmp_path / "j"))
    log.apply([1], [2], [OP_INSERT], [5])
    before = log.stats()
    merged = log.merged_graph()
    with pytest.raises(KeyError):
        log.apply([3, 1], [4, 3], [OP_INSERT, OP_DELETE], [6, 0])
    assert log.stats() == before
    assert_graph_equal(log.merged_graph(), merged)
    u, v = int(g.col_idx[0]), int(g.dst_of_edges()[0])
    n_par = int(np.sum(g.col_idx[g.row_ptr[v]:g.row_ptr[v + 1]] == u))
    for _ in range(n_par):
        log.apply([u], [v], [OP_DELETE])
    with pytest.raises(KeyError):
        log.apply([u], [v], [OP_DELETE])
    log.apply([u, u], [v, v], [OP_INSERT, OP_DELETE])  # resolves in order
    assert log.stats()["inserts_live"] == 1
    assert DeltaLog(g, journal_dir=str(tmp_path / "j")).stats() == log.stats()


def test_bucket_invalidation_is_minimal(tmp_path, monkeypatch):
    """Churn confined to one part's destination range (balanced, so the
    shared e_pad stays) invalidates exactly that part's plan-cache
    entry: fraction 0.5 at two parts."""
    monkeypatch.setenv("LUX_TORCH_PLAN_CACHE", str(tmp_path / "plans"))
    g = generate.rmat(9, 8, seed=2)
    mg = MutableGraph(g, num_parts=2)
    cuts = np.asarray(mg.pull_shards.cuts)
    lo, hi = int(cuts[1]), int(cuts[2])
    dsts = g.dst_of_edges()
    rng = np.random.default_rng(0)
    dele = rng.choice(np.flatnonzero((dsts >= lo) & (dsts < hi)), 8, replace=False)
    mg.apply(g.col_idx[dele], dsts[dele], np.full(8, OP_DELETE, np.int8))
    mg.apply(rng.integers(0, g.nv, 8), rng.integers(lo, hi, 8), np.full(8, OP_INSERT, np.int8))
    rep = mg.compact()
    assert rep["invalidation"]["changed_parts"] == [1], rep
    assert rep["invalidation"]["fraction"] == 0.5


def test_occupancy_changes_no_shape_and_no_launch(monkeypatch):
    """Overlay shapes and the per-iteration calls of the kernel wrappers'
    plain versions (what the card's kernels replace) stay fixed at 4, 60
    and 180 live inserts, and equal those of the overlay-free run."""
    calls = {}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    for mod, name in ((scan, "mxscan_segmented_plain"), (shuffle, "lane_gather_plain"),
                      (shuffle, "fused_pass_gather_plain")):
        spy(mod, name)
    g = generate.rmat(9, 8, seed=7)
    rng = np.random.default_rng(0)
    mg = MutableGraph(g, num_parts=2, cap=256)
    plan = expand.plan_expand_shards(mg.pull_shards, pf=True)
    prog_sh = mg.pull_shards
    arr = to_device(prog_sh.arrays, CPU)
    prog = comp.MaxLabelProgram()

    def per_iter(overlay):
        calls.clear()
        pull.run_pull_fixed(prog, prog_sh.spec, arr, pull.init_state(prog, arr), 2,
                            method="mxscan", route=plan, overlay=overlay)
        return dict(calls)

    base = per_iter(None)
    assert base["mxscan_segmented_plain"] == 4 and base["fused_pass_gather_plain"] > 0
    shapes = []
    for lvl in (4, 60, 180):
        mg.apply(rng.integers(0, g.nv, lvl), rng.integers(0, g.nv, lvl),
                 np.full(lvl, OP_INSERT, np.int8))
        st, oa = mg.pull_overlay()
        shapes.append(tuple(a.shape for a in oa))
        assert per_iter((st, oa)) == base
    assert shapes[0] == shapes[1] == shapes[2]


def test_entry_points_default_to_cuda():
    """The refresh and the device placement default to the card and raise
    without one (no quiet CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = generate.rmat(8, 4, seed=3)
    mg = MutableGraph(g, num_parts=2)
    for call in (lambda: refresh.converge_pagerank(mg.pull_shards),
                 lambda: refresh.refresh_components(mg, np.arange(g.nv)),
                 lambda: mg.device_pull()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
