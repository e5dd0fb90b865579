"""serve/batched in lux_tpu_torch vs lux_tpu, on the CPU.  One seeded
numpy RMAT graph feeds the reference's BatchedEngine (jax) and the
port's.  SSSP is held bitwise (distances, iterations, per-query rounds,
traversed edges), PPR within rtol 1e-5 (the f32 sums associate
differently: the reference's CPU methods are jax scatters and scans),
over P in {1, 2}, Q in {1, 3, 8} and the methods scan, scatter and auto.
Each column also equals the port's own single-query run."""
import numpy as np
import pytest
import torch

from lux_tpu.graph import csc as ref_csc
from lux_tpu.graph.shards import build_pull_shards as ref_build_pull
from lux_tpu.models import pagerank as ref_pagerank
from lux_tpu.program import spec as ref_spec
from lux_tpu.serve import batched as ref_batched
from lux_tpu_torch.engine import pull
from lux_tpu_torch.graph import generate
from lux_tpu_torch.graph.push_shards import build_push_shards
from lux_tpu_torch.graph.shards import build_pull_shards, to_device
from lux_tpu_torch.models import pagerank, sssp
from lux_tpu_torch.program import spec
from lux_tpu_torch.serve import batched

NI = 6  # PPR iterations
PPR_RTOL = 1e-5


@pytest.fixture(scope="module")
def graphs():
    g = generate.rmat(9, 8, seed=41)
    rg = ref_csc.HostGraph(g.nv, g.ne, g.row_ptr.copy(), g.col_idx.copy())
    return g, rg


def mixed_sources(g, n: int) -> np.ndarray:
    """n distinct sources with a mixed convergence profile: the hub, a
    vertex without out-edges when there is one (converges in one round),
    then low- and high-degree vertices."""
    deg = g.out_degrees()
    order = np.argsort(deg, kind="stable")
    picks = [int(np.argmax(deg))]
    if deg[order[0]] == 0:
        picks.append(int(order[0]))
    picks.extend(int(v) for v in order[deg[order] > 0][:n])
    picks.extend(int(v) for v in order[::-1][1:n])
    return np.asarray(list(dict.fromkeys(picks))[:n], np.int32)


@pytest.mark.parametrize("method", ["scan", "scatter", "auto"])
@pytest.mark.parametrize("q", [1, 3, 8])
@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("app", ["sssp", "ppr"])
def test_batched_engine_matches_reference(graphs, app, parts, q, method):
    g, rg = graphs
    srcs = mixed_sources(g, q)
    want = ref_batched.BatchedEngine(ref_build_pull(rg, parts), app, q, method=method,
                                     num_iters=NI).run(srcs)
    eng = batched.BatchedEngine(build_pull_shards(g, parts), app, q, method=method,
                                num_iters=NI, device="cpu")
    got = eng.run(srcs)
    assert got.state.shape == (q, g.nv) and got.state.flags["C_CONTIGUOUS"]
    if app == "sssp":
        assert got.state.dtype == np.int32
        np.testing.assert_array_equal(got.state, np.asarray(want.state))
    else:
        assert got.state.dtype == np.float32
        np.testing.assert_allclose(got.state, np.asarray(want.state), rtol=PPR_RTOL,
                                   atol=0)
    assert got.iters == int(want.iters)
    np.testing.assert_array_equal(got.rounds, np.asarray(want.rounds))
    assert got.traversed == list(want.traversed)
    if method == "auto":  # no measured CPU row in the port: the portable scan
        assert eng.method == "scan"


@pytest.mark.parametrize("parts", [1, 2])
def test_sssp_columns_equal_single_source_runs(graphs, parts):
    """Every column of a mixed batch is the push engine's single-source
    run bitwise, and the batch's per-query masking shows: rounds and
    traversed edges differ across the batch."""
    g, _ = graphs
    srcs = mixed_sources(g, 8)
    out = batched.BatchedEngine(build_pull_shards(g, parts), "sssp", 8,
                                device="cpu").run(srcs)
    for i, s in enumerate(srcs):
        np.testing.assert_array_equal(out.state[i],
                                      sssp.sssp(g, start=int(s), num_parts=parts,
                                                device="cpu"))
        np.testing.assert_array_equal(out.state[i], sssp.bfs_reference(g, int(s)))
    assert out.rounds.min() < out.rounds.max()
    assert min(out.traversed) < max(out.traversed)
    assert out.iters == int(out.rounds.max())


@pytest.mark.parametrize("method", ["scan", "scatter"])
@pytest.mark.parametrize("parts", [1, 2])
def test_ppr_columns_equal_single_seed_pull_runs(graphs, parts, method):
    """Each PPR column is the single-seed PPRProgram pull run of the same
    method bitwise, and near the float64 oracle."""
    g, _ = graphs
    shards = build_pull_shards(g, parts)
    seeds = mixed_sources(g, 3)
    out = batched.BatchedEngine(shards, "ppr", 3, method=method, num_iters=NI,
                                device="cpu").run(seeds)
    arrays = to_device(shards.arrays, "cpu")
    for i, s in enumerate(seeds):
        prog = pagerank.PPRProgram(nv=g.nv, seed=int(s))
        single = pull.run_pull_fixed(prog, shards.spec, arrays,
                                     pull.init_state(prog, arrays), NI, method=method)
        np.testing.assert_array_equal(out.state[i],
                                      shards.scatter_to_global(single.numpy()))
        np.testing.assert_allclose(out.state[i], pagerank.ppr_reference(g, int(s), NI),
                                   rtol=2e-4, atol=1e-7)


def test_ppr_reference_matches_reference_oracle(graphs):
    g, rg = graphs
    for seed in mixed_sources(g, 3):
        np.testing.assert_allclose(pagerank.ppr_reference(g, int(seed), NI),
                                   ref_pagerank.ppr_reference(rg, int(seed), NI),
                                   rtol=1e-6, atol=1e-12)


def test_ppr_mass_concentrates_at_seed(graphs):
    g, _ = graphs
    deg = g.out_degrees()
    seed = int(np.argmax(deg))
    out = batched.BatchedEngine(build_pull_shards(g, 1), "ppr", 1, num_iters=10,
                                device="cpu").run([seed])
    assert int(np.argmax(out.state[0] * np.maximum(deg, 1))) == seed


def test_sssp_batched_library_helper(graphs):
    g, _ = graphs
    srcs = mixed_sources(g, 3)
    got = sssp.sssp_batched(g, srcs, num_parts=2, device="cpu")
    also = sssp.sssp_batched(build_push_shards(g, 2), srcs, device="cpu")
    np.testing.assert_array_equal(got, also)
    for i, s in enumerate(srcs):
        np.testing.assert_array_equal(got[i], sssp.sssp(g, start=int(s), num_parts=2,
                                                        device="cpu"))


def test_engine_validates_inputs(graphs):
    g, _ = graphs
    shards = build_pull_shards(g, 1)
    eng = batched.BatchedEngine(shards, "sssp", 2, device="cpu")
    with pytest.raises(ValueError, match="built for Q=2"):
        eng.run([1, 2, 3])
    with pytest.raises(ValueError, match="out of range"):
        eng.run([0, g.nv])
    with pytest.raises(ValueError, match="unknown served app"):
        batched.BatchedEngine(shards, "nope", 1, device="cpu")
    with pytest.raises(ValueError, match="q must be"):
        batched.BatchedEngine(shards, "sssp", 0, device="cpu")


def _churned_pair(g, rg, parts):
    """The same churn (base deletes, then inserts) in the port's and the
    reference's MutableGraph."""
    from lux_tpu.mutate import MutableGraph as RefMutableGraph
    from lux_tpu_torch.mutate import OP_DELETE, OP_INSERT, MutableGraph

    rng = np.random.default_rng(5)
    dele = rng.choice(g.ne, 30, replace=False)
    batches = [(g.col_idx[dele], g.dst_of_edges()[dele], np.full(30, OP_DELETE, np.int8)),
               (rng.integers(0, g.nv, 40), rng.integers(0, g.nv, 40),
                np.full(40, OP_INSERT, np.int8))]
    mg, rmg = MutableGraph(g, num_parts=parts), RefMutableGraph(rg, num_parts=parts)
    for b in batches:
        mg.apply(*b)
        rmg.apply(*b)
    return mg, rmg


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("app", ["sssp", "ppr"])
def test_overlay_engine_matches_reference(graphs, app, parts):
    """The overlay twin (tombstones broadcast over the Q lanes, (D, Q)
    insert fold, merged degrees) answers as the reference's overlay
    BatchedEngine: SSSP bitwise and equal to a BFS of the merged graph,
    PPR within rtol 1e-5."""
    from lux_tpu.mutate import overlay as ref_ovl
    from lux_tpu_torch.mutate import overlay as ovl

    g, rg = graphs
    mg, rmg = _churned_pair(g, rg, parts)
    srcs = mixed_sources(g, 3)
    st, oa = mg.pull_overlay()
    rst, roa = rmg.pull_overlay()
    deg = ovl.merged_degree_stacked(mg.pull_shards, mg.log) if app == "ppr" else None
    rdeg = ref_ovl.merged_degree_stacked(rmg.pull_shards, rmg.log) if app == "ppr" else None
    got = batched.BatchedEngine(mg.pull_shards, app, 3, num_iters=NI, overlay_static=st,
                                device="cpu").run(srcs, oarrays=oa, degree=deg)
    want = ref_batched.BatchedEngine(rmg.pull_shards, app, 3, num_iters=NI,
                                     overlay_static=rst).run(srcs, oarrays=roa, degree=rdeg)
    if app == "sssp":
        np.testing.assert_array_equal(got.state, np.asarray(want.state))
        merged = mg.log.merged_graph()
        for i, s in enumerate(srcs):
            np.testing.assert_array_equal(got.state[i], sssp.bfs_reference(merged, int(s)))
        assert got.iters == int(want.iters)
        np.testing.assert_array_equal(got.rounds, np.asarray(want.rounds))
    else:
        np.testing.assert_allclose(got.state, np.asarray(want.state), rtol=PPR_RTOL, atol=0)


@pytest.mark.parametrize("app", ["sssp", "ppr"])
def test_empty_overlay_bitwise_no_overlay_engine(graphs, app):
    from lux_tpu_torch.mutate import overlay as ovl

    g, _ = graphs
    shards = build_pull_shards(g, 2)
    srcs = mixed_sources(g, 3)
    plain = batched.BatchedEngine(shards, app, 3, num_iters=NI, device="cpu").run(srcs)
    live = batched.BatchedEngine(shards, app, 3, num_iters=NI, device="cpu",
                                 overlay_static=ovl.OverlayStatic(cap=128, weighted=False))
    live.warm()
    got = live.run(srcs, oarrays=ovl.empty_overlay_arrays(shards, 128))
    np.testing.assert_array_equal(got.state, plain.state)
    assert got.iters == plain.iters and got.traversed == plain.traversed


def test_overlay_pairing_guard(graphs):
    """An overlay engine never answers from the base graph, and a plain
    engine never silently ignores an overlay."""
    from lux_tpu_torch.mutate import overlay as ovl

    g, _ = graphs
    shards = build_pull_shards(g, 1)
    live = batched.BatchedEngine(shards, "sssp", 1, device="cpu",
                                 overlay_static=ovl.OverlayStatic(cap=128, weighted=False))
    with pytest.raises(ValueError, match="passed together"):
        live.run([0])
    plain = batched.BatchedEngine(shards, "sssp", 1, device="cpu")
    with pytest.raises(ValueError, match="passed together"):
        plain.run([0], oarrays=ovl.empty_overlay_arrays(shards, 128))


def test_cuda_without_a_card_raises(graphs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batched.BatchedEngine(build_pull_shards(graphs[0], 1), "sssp", 1)


def test_warm_runs_one_dummy_batch_once(graphs):
    eng = batched.BatchedEngine(build_pull_shards(graphs[0], 1), "sssp", 4, device="cpu")
    assert not eng._warmed
    assert eng.warm() is eng and eng._warmed
    assert eng.warm()._warmed


def test_programs_are_hashable_statics():
    assert hash(batched.MultiSourceSSSP(nv=10)) == hash(batched.MultiSourceSSSP(nv=10))
    assert batched.MultiSourcePPR(nv=10) == batched.MultiSourcePPR(nv=10)
    assert batched.MultiSourceSSSP(nv=10).fixpoint
    assert not batched.MultiSourcePPR(nv=10).fixpoint


def _u32_spec(mod):
    return mod.VertexProgramSpec(
        name="u32_lift", reduce="max",
        init="h = u32(vid) * u32(2654435761)\nwhere(vtx_mask, h ^ u32(q), u32(0))",
        edge="src", apply="maximum(old, acc)", query_param="q")


@pytest.mark.parametrize("which", ["sssp", "ppr", "u32"])
def test_q_lift_binds_rows_and_lanes_like_the_reference(graphs, which):
    """The query parameter binds as a (1, Q) row and the per-vertex names
    as (V, 1) lanes, in the port as in the reference, including the
    uint32 arithmetic (which the port runs on its int64 widening)."""
    import jax.numpy as jnp

    g, rg = graphs
    shards = build_pull_shards(g, 1)
    a = shards.arrays
    queries = mixed_sources(g, 5)
    if which == "u32":
        mine = spec.BatchedSpecProgram(_u32_spec(spec))
        ref = ref_spec.BatchedSpecProgram(_u32_spec(ref_spec))
    else:
        mine = batched.make_program(which, g.nv)
        ref = ref_batched.make_program(which, g.nv)
    got = mine.init_part(*(torch.from_numpy(x[0]) for x in (a.global_vid, a.degree,
                                                             a.vtx_mask)),
                         torch.from_numpy(queries))
    want = np.asarray(ref.init_part(*(jnp.asarray(x[0]) for x in (a.global_vid, a.degree,
                                                                   a.vtx_mask)),
                                    jnp.asarray(queries)))
    assert tuple(got.shape) == want.shape == (shards.spec.nv_pad, 5)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)
