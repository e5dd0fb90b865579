"""Collaborative filtering in lux_tpu_torch vs lux_tpu, on the CPU.

The same numpy inputs go through both packages; the reference runs its
own CPU paths (XLA; its Pallas kernels in interpret mode).  Tolerances:
the graph, the plans and the routed reads are byte- or bit-identical;
the 2-D SpMV's f32 sums rtol 1e-5 (both sides accumulate in f32, in
different orders); CF states rtol 3e-5 / atol 1e-7, the reference's own
CF parity tolerance against its oracle (tests/test_colfilter.py: five
iterations of f32 error-dots and sums in different orders); a bf16 state
rtol 2e-2 / atol 2e-3 (one bf16 rounding of each latent per iteration).
GAMMA is 1e-3 so that the state moves (at the app's 3.5e-7 it barely
does).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lux_tpu.engine import pull as ref_pull
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph import shards as ref_shards
from lux_tpu.models import colfilter as ref_cf
from lux_tpu.ops import expand as ref_expand
from lux_tpu.ops import pallas_spmv as ref_spmv
from lux_tpu_torch import convert
from lux_tpu_torch.apps import colfilter as app
from lux_tpu_torch.engine import methods, pull
from lux_tpu_torch.graph import csc, generate, shards
from lux_tpu_torch.models import colfilter as cf
from lux_tpu_torch.ops import expand, spmv

ITERS = 5
GAMMA = 1e-3
RTOL, ATOL = 3e-5, 1e-7
BLK = 128  # v_blk = t_chunk of the block-CSR cases, as the reference's tests


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    # both packages read LUX_PF_MAX_BLOCK; pin it to the port's default
    monkeypatch.setenv("LUX_PF_MAX_BLOCK", str(1 << 14))
    for k in ("LUX_ROUTE_MODE", "LUX_ROUTE_IDX8", "LUX_CF_ERR_DOT", "LUX_SUM_MODE"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def graphs():
    return (generate.bipartite_ratings(60, 40, 800, seed=50),
            ref_generate.bipartite_ratings(60, 40, 800, seed=50))


@pytest.fixture(scope="module")
def oracle(graphs):
    return ref_cf.colfilter_reference(graphs[1], ITERS, gamma=GAMMA)


@pytest.mark.parametrize("args", [(60, 40, 800, 50, 5), (1000, 7, 5000, 3, 10),
                                  (1, 1, 1, 0, 5)])
def test_bipartite_ratings_byte_identical(args):
    *sizes, seed, top = args
    mine = generate.bipartite_ratings(*sizes, seed=seed, max_rating=top)
    ref = ref_generate.bipartite_ratings(*sizes, seed=seed, max_rating=top)
    assert (mine.nv, mine.ne) == (ref.nv, ref.ne)
    for f in ("row_ptr", "col_idx", "weights"):
        a, b = getattr(mine, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def test_oracles_agree(graphs, oracle):
    np.testing.assert_array_equal(cf.colfilter_reference(graphs[0], ITERS, gamma=GAMMA),
                                  oracle)
    f64 = cf.colfilter_reference(graphs[0], ITERS, gamma=GAMMA, dtype=np.float64)
    assert f64.dtype == np.float64
    np.testing.assert_allclose(oracle, f64, rtol=RTOL, atol=ATOL)


# --- the 2-D block-CSR SpMV --------------------------------------------------


def _layout(kind):
    """A block-CSR layout at v_blk = t_chunk = 128: the bipartite graph, a
    ragged one (a hub spanning several chunks, a ragged last block), and
    one with empty vertex blocks and an all-padding tail block."""
    if kind == "bipartite":
        return spmv.build_blockcsr(generate.bipartite_ratings(300, 200, 4000, seed=60),
                                   v_blk=BLK, t_chunk=BLK)
    rng = np.random.default_rng(61)
    nv = 1000
    if kind == "ragged":
        dst = np.concatenate([rng.integers(0, 1000, 3000), np.full(500, 130)])
    else:
        dst = np.concatenate([rng.integers(0, 200, 900), rng.integers(700, 760, 100)])
    g = csc.from_edge_list(rng.integers(0, nv, dst.shape[0]), dst, nv)
    return spmv.build_blockcsr(g, v_blk=BLK, t_chunk=BLK)


def _spmv_2d_both(bc, vals):
    ref = ref_spmv.spmv_blockcsr_2d(
        jnp.asarray(vals), jnp.asarray(bc.e_dst_rel), jnp.asarray(bc.chunk_block),
        jnp.asarray(bc.chunk_first), v_blk=bc.v_blk, num_vblocks=bc.num_vblocks,
        interpret=True)
    got = spmv.spmv_blockcsr_2d(
        convert.array_to_tensor(np.asarray(vals), "cpu"), torch.from_numpy(bc.e_dst_rel),
        torch.from_numpy(bc.chunk_block), torch.from_numpy(bc.chunk_first),
        v_blk=bc.v_blk, num_vblocks=bc.num_vblocks)
    return np.asarray(ref), got.numpy()


def _spmv_2d_oracle(bc, vals):
    k = vals.shape[-1]
    real = bc.e_dst_rel < bc.v_blk
    dst = (bc.chunk_block[:, None].astype(np.int64) * bc.v_blk + bc.e_dst_rel)[real]
    out = np.zeros((bc.num_vblocks * bc.v_blk, k), np.float64)
    np.add.at(out, dst, np.asarray(vals, np.float64)[real])
    return out


@pytest.mark.parametrize("kind", ["bipartite", "ragged", "empty"])
@pytest.mark.parametrize("k", [1, 3, 20])
def test_spmv_2d_plain_matches_reference(kind, k):
    bc = _layout(kind)
    if kind == "empty":
        assert (bc.e_dst_rel[bc.chunk_block == bc.num_vblocks - 1] == BLK).all()
    rng = np.random.default_rng(62 + k)
    # positive values (no cancellation, so rtol is meaningful); padding
    # slots carry values too: the reduce skips them by index
    vals = rng.random(bc.e_dst_rel.shape + (k,), dtype=np.float32) + 0.01
    ref, got = _spmv_2d_both(bc, vals)
    assert got.dtype == np.float32 and got.shape == (bc.num_vblocks * BLK, k)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got, _spmv_2d_oracle(bc, vals), rtol=1e-5)


def test_spmv_2d_bf16_values_accumulate_in_f32():
    bc = _layout("ragged")
    vals = jnp.asarray(np.random.default_rng(63).random(bc.e_dst_rel.shape + (20,),
                                                        dtype=np.float32)).astype(jnp.bfloat16)
    ref, got = _spmv_2d_both(bc, vals)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_spmv_2d_wrapper_checks_and_cpu_never_launches():
    bc = _layout("ragged")
    dst = torch.from_numpy(bc.e_dst_rel)
    cb, cfirst = torch.from_numpy(bc.chunk_block), torch.from_numpy(bc.chunk_first)
    vals = torch.zeros(bc.e_dst_rel.shape + (4,))
    kw = dict(v_blk=BLK, num_vblocks=bc.num_vblocks)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        spmv.spmv_blockcsr_2d(vals.to(torch.int32), dst, cb, cfirst, **kw)
    with pytest.raises(ValueError, match=r"\(C, T, K\)"):
        spmv.spmv_blockcsr_2d(vals[..., 0], dst, cb, cfirst, **kw)
    with pytest.raises(ValueError, match="num_vblocks"):
        spmv.spmv_blockcsr_2d(vals, dst, cb, cfirst, v_blk=BLK)
    before = spmv.spmv_blockcsr_2d.launches
    spmv.spmv_blockcsr_2d(vals, dst, cb, cfirst, **kw)
    assert spmv.spmv_blockcsr_2d.launches == before


# --- CF on the pull engine and on the block-CSR runner -----------------------


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("method", ["scan", "scatter", "cumsum", "mxscan"])
def test_colfilter_matches_reference(graphs, oracle, method, parts):
    """mxscan runs downgraded to scan for (E, K) values in both packages."""
    got = cf.colfilter(graphs[0], ITERS, num_parts=parts, gamma=GAMMA, method=method,
                       device="cpu")
    ref = ref_cf.colfilter(graphs[1], ITERS, num_parts=parts, gamma=GAMMA, method=method)
    assert got.dtype == np.float32 and got.shape == (graphs[0].nv, cf.K)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("parts", [1, 2])
def test_colfilter_err_dot_mxu_matches_reference(graphs, oracle, parts):
    got = cf.colfilter(graphs[0], ITERS, num_parts=parts, gamma=GAMMA, err_dot="mxu",
                       device="cpu")
    ref = ref_cf.colfilter(graphs[1], ITERS, num_parts=parts, gamma=GAMMA, err_dot="mxu")
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)


def test_colfilter_k3_matches_reference(graphs):
    got = cf.colfilter(graphs[0], ITERS, k=3, gamma=GAMMA, device="cpu")
    ref = ref_cf.colfilter(graphs[1], ITERS, k=3, gamma=GAMMA)
    want = ref_cf.colfilter_reference(graphs[1], ITERS, k=3, gamma=GAMMA)
    assert got.shape == (graphs[0].nv, 3)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_colfilter_bf16_state_matches_reference(graphs, oracle):
    got = cf.colfilter(graphs[0], ITERS, gamma=GAMMA, dtype="bfloat16", device="cpu")
    ref = ref_cf.colfilter(graphs[1], ITERS, gamma=GAMMA, dtype="bfloat16")
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(got, oracle, rtol=2e-2, atol=2e-3)


def test_cf_edge_value_is_f32_on_bf16_state():
    prog = cf.CFProgram(dtype="bfloat16")
    ones = torch.ones((6, cf.K), dtype=torch.bfloat16)
    assert prog.edge_value(ones, torch.ones(6), ones).dtype == torch.float32


@pytest.mark.parametrize("k,err_dot", [(20, "vpu"), (20, "mxu"), (3, "vpu")])
def test_pallas_runner_matches_reference(graphs, k, err_dot):
    kw = dict(k=k, gamma=GAMMA, v_blk=BLK, t_chunk=BLK, err_dot_mode=err_dot)
    got = cf.colfilter_pallas(graphs[0], ITERS, device="cpu", **kw)
    ref = ref_cf.colfilter_pallas(graphs[1], ITERS, interpret=True, **kw)
    want = ref_cf.colfilter_reference(graphs[1], ITERS, k=k, gamma=GAMMA)
    assert got.shape == (graphs[0].nv, k)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_pallas_runner_updates_in_place_and_bf16(graphs, oracle):
    run, s0 = cf.make_pallas_runner(graphs[0], gamma=GAMMA, device="cpu")
    assert s0.shape == (512, cf.K) and run(s0, 2) is s0
    got = cf.colfilter_pallas(graphs[0], ITERS, gamma=GAMMA, dtype="bfloat16", device="cpu")
    np.testing.assert_allclose(got, oracle, rtol=2e-2, atol=2e-3)


def test_rmse_and_check_training_match_reference(graphs, oracle):
    g, rg = graphs
    assert cf.rmse(g, oracle) == ref_cf.rmse(rg, oracle)
    assert cf.init_rmse(g) == ref_cf.init_rmse(rg)
    assert cf.check_training(g, oracle) == ref_cf.check_training(rg, oracle) == 0
    bad = oracle.copy()
    bad[:3] = np.nan
    assert cf.check_training(g, bad) == ref_cf.check_training(rg, bad) > 0
    assert cf.check_training(g, oracle * 10) == ref_cf.check_training(rg, oracle * 10) == 1


def test_cf_err_dot_mode(monkeypatch):
    assert methods.cf_err_dot_mode() == "vpu" and cf._resolve_err_dot(None) == "vpu"
    assert cf._resolve_err_dot("mxu") == "mxu"
    monkeypatch.setenv("LUX_CF_ERR_DOT", "mxu")
    assert cf._resolve_err_dot(None) == "mxu"
    monkeypatch.setenv("LUX_CF_ERR_DOT", "tensor")
    with pytest.raises(ValueError, match="LUX_CF_ERR_DOT"):
        methods.cf_err_dot_mode()


def test_colfilter_requires_weights():
    g = generate.rmat(6, 4, seed=0)
    with pytest.raises(ValueError, match="weighted"):
        cf.colfilter(g, 1, device="cpu")
    with pytest.raises(ValueError, match="weighted"):
        cf.make_pallas_runner(g, device="cpu")


# --- the CF route ------------------------------------------------------------


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


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("pf", [False, True])
def test_cf_route_plans_match_reference(graphs, parts, pf):
    mine = expand.plan_cf_route_shards(shards.build_pull_shards(graphs[0], parts), pf=pf)
    ref = ref_expand.plan_cf_route_shards(ref_shards.build_pull_shards(graphs[1], parts),
                                          pf=pf)
    assert isinstance(mine[0], expand.CFRouteStatic)
    _assert_static_equal(mine[0], ref[0])
    assert len(mine[1]) == len(ref[1])
    for x, y in zip(mine[1], ref[1]):
        y = np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        assert x.shape[0] == parts


@pytest.mark.parametrize("pf", [False, True])
def test_apply_cf_route_bitwise_direct_gathers(graphs, pf):
    sh = shards.build_pull_shards(graphs[0], 2)
    static, arrays = expand.plan_to_device(expand.plan_cf_route_shards(sh, pf=pf), "cpu")
    rng = np.random.default_rng(64)
    full = torch.from_numpy(rng.standard_normal((sh.spec.gathered_size, 5), dtype=np.float32))
    for p in range(2):
        local = full[p * sh.spec.nv_pad:(p + 1) * sh.spec.nv_pad]
        src, dst = expand.apply_cf_route(full, local, static, tuple(a[p] for a in arrays))
        m = int(sh.arrays.edge_mask[p].sum())
        assert src.shape == dst.shape == (sh.spec.e_pad, 5)
        assert torch.equal(src[:m], full[torch.from_numpy(sh.arrays.src_pos[p][:m]).long()])
        assert torch.equal(dst[:m], local[torch.from_numpy(sh.arrays.dst_local[p][:m]).long()])


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("pf", [False, True])
def test_routed_colfilter_bitwise_direct(graphs, parts, pf):
    sh = shards.build_pull_shards(graphs[0], parts)
    route = expand.plan_cf_route_shards(sh, pf=pf)
    direct = cf.colfilter(sh, ITERS, gamma=GAMMA, method="scan", device="cpu")
    routed = cf.colfilter(sh, ITERS, gamma=GAMMA, method="scan", route=route, device="cpu")
    np.testing.assert_array_equal(routed, direct)


# --- the app -----------------------------------------------------------------


APP = ["--rmat-scale", "9", "--rmat-ef", "8", "-ni", "3", "--device", "cpu", "-check"]


@pytest.mark.parametrize("extra", [["--method", "pallas"], [], ["--method", "scatter"],
                                   ["--route-gather", "expand-pf"],
                                   ["--route-gather", "expand"]])
def test_app_runs_on_cpu_with_check(extra, capsys):
    res = app.run(APP + extra)
    out = capsys.readouterr().out
    assert res.rc == 0 and "[PASS]" in out and "GTEPS" in out and "training RMSE" in out
    assert res.state.shape == (512, cf.K) and np.isfinite(res.state).all()
    assert res.rmse == cf.rmse(res.graph, res.state)
    if extra[:1] == ["--route-gather"]:
        assert res.route_gather == extra[1]
        np.testing.assert_array_equal(res.state, app.run(APP).state)
    else:
        want = cf.colfilter_reference(res.graph, 3)
        np.testing.assert_allclose(res.state, want, rtol=RTOL, atol=ATOL)


def test_app_graph_is_the_reference_rating_graph():
    g = app.run(APP).graph
    n = (1 << 9) // 2
    ref = ref_generate.bipartite_ratings(n, n, (1 << 9) * 8 // 2, seed=0)
    assert g.col_idx.tobytes() == np.asarray(ref.col_idx).tobytes()
    assert g.weights.tobytes() == np.asarray(ref.weights).tobytes()


def test_app_refuses_fused_routes_and_unweighted_files(tmp_path, capsys):
    with pytest.raises(SystemExit, match="--route-gather fused supports scalar vertex state"):
        app.run(APP + ["--route-gather", "fused-pf"])
    from lux_tpu_torch.graph.format import write_lux

    path = tmp_path / "plain.lux"
    write_lux(str(path), generate.rmat(6, 4, seed=0))
    with pytest.raises(SystemExit, match="has no edge weights"):
        app.run(["-file", str(path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--feat-shards requires --distributed"):
        app.main(APP + ["--feat-shards", "2"])


def test_app_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--rmat-scale", "6", "-ni", "1"])


# --- carrying the reference's layout, state and plan over --------------------


def test_convert_carries_reference_layout_state_and_plan(graphs):
    g, rg = graphs
    _, s0 = ref_cf.make_pallas_runner(rg, interpret=True)
    rbc = ref_spmv.build_blockcsr(rg)
    d = {f: getattr(rbc, f) for f in ("e_src_pos", "e_dst_rel", "e_weight", "chunk_block",
                                      "chunk_first")}
    d["state0"] = np.asarray(s0)
    out = convert.shards_from_numpy(d, device="cpu")
    run, mine0 = cf.make_pallas_runner(g, device="cpu")
    bc = spmv.build_blockcsr(g)
    for f in ("e_src_pos", "e_dst_rel", "e_weight", "chunk_block", "chunk_first"):
        assert torch.equal(out[f], torch.from_numpy(getattr(bc, f))), f
    assert out["e_weight"].dtype == torch.float32 and out["e_weight"].abs().sum() > 0
    assert out["state0"].shape == (bc.num_vblocks * bc.v_blk, cf.K)
    assert torch.equal(out["state0"], mine0)
    # the reference's CF plan, replayed by the port's engine
    rsh = ref_shards.build_pull_shards(rg, 1)
    sh = shards.build_pull_shards(g, 1)
    rstatic, rarrays = ref_expand.plan_cf_route_shards(rsh, pf=True)
    st, ts = convert.route_plan_from_numpy(rstatic, rarrays, device="cpu")
    assert isinstance(st, expand.CFRouteStatic)
    mine = expand.plan_cf_route_shards(sh, pf=True)
    _assert_static_equal(st, mine[0])
    want = cf.colfilter(sh, 2, gamma=GAMMA, method="scan", route=mine, device="cpu")
    got = cf.colfilter(sh, 2, gamma=GAMMA, method="scan", route=(st, ts), device="cpu")
    np.testing.assert_array_equal(got, want)
    # and the reference's engine state, carried over, is the port's
    prog = ref_cf.CFProgram(gamma=GAMMA)
    rs0 = ref_pull.init_state(prog, rsh.arrays)
    arrays = shards.to_device(sh.arrays, "cpu")
    assert torch.equal(convert.array_to_tensor(np.asarray(rs0), "cpu"),
                       pull.init_state(cf.CFProgram(gamma=GAMMA), arrays))
