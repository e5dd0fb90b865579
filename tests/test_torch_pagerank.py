"""The slice end to end: PageRank in lux_tpu_torch vs lux_tpu, on the CPU.

The reference runs its own CPU paths (XLA; its Pallas kernels in
interpret mode).  Tolerances: f32 ranks rtol 1e-5 against the reference
and against the float64 oracle — 10 iterations of f32 accumulation in
different orders at RMAT scale 8-9 stay well inside it; a bf16 state
carries ~2^-8 relative quantization per rank, so rtol 2e-2 there.
"""
import numpy as np
import pytest
import torch

from lux_tpu.engine import pull as ref_pull
from lux_tpu.graph import generate as ref_generate
from lux_tpu.graph import shards as ref_shards
from lux_tpu.models import pagerank as ref_pr
from lux_tpu.program import library as ref_library
from lux_tpu.program import spec as ref_spec
from lux_tpu_torch import convert
from lux_tpu_torch.apps import pagerank as app
from lux_tpu_torch.engine import methods, pull
from lux_tpu_torch.graph import generate, shards
from lux_tpu_torch.models import pagerank as pr
from lux_tpu_torch.ops import expand
from lux_tpu_torch.program import library, spec

ITERS = 10


@pytest.fixture(scope="module")
def graphs():
    return generate.rmat(9, 6, seed=51), ref_generate.rmat(9, 6, seed=51)


@pytest.fixture(scope="module")
def oracle(graphs):
    return ref_pr.pagerank_reference(graphs[1], ITERS)


def test_oracles_agree(graphs, oracle):
    np.testing.assert_allclose(pr.pagerank_reference(graphs[0], ITERS), oracle,
                               rtol=1e-6)


@pytest.mark.parametrize("method", ["scan", "scatter", "mxscan", "cumsum", "mxsum"])
def test_pull_engine_matches_reference(graphs, oracle, method):
    got = pr.pagerank(graphs[0], ITERS, method=method, device="cpu")
    ref = ref_pr.pagerank(graphs[1], ITERS, method=method)
    assert got.dtype == np.float32 and got.shape == (graphs[0].nv,)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5)


@pytest.mark.parametrize("parts", [2, 3])
def test_multi_part_on_cpu(graphs, oracle, parts):
    """-ng > 1 runs on the CPU engine (the card runs one part)."""
    got = pr.pagerank(graphs[0], ITERS, num_parts=parts, method="scan", device="cpu")
    np.testing.assert_allclose(got, oracle, rtol=1e-5)


def test_bf16_state_matches_reference(graphs, oracle):
    got = pr.pagerank(graphs[0], ITERS, method="scan", dtype="bfloat16", device="cpu")
    ref = ref_pr.pagerank(graphs[1], ITERS, method="scan", dtype="bfloat16")
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=2e-2)
    np.testing.assert_allclose(got, oracle, rtol=2e-2)


def test_blockcsr_runner_matches_reference(graphs, oracle):
    got = pr.pagerank_pallas(graphs[0], ITERS, v_blk=128, t_chunk=128, device="cpu")
    ref = ref_pr.pagerank_pallas(graphs[1], ITERS, interpret=True, v_blk=128, t_chunk=128)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5)


def test_engine_on_the_reference_layout(graphs):
    """The reference's own shards and state, carried over with convert,
    give the same ranks through the port's engine."""
    sh = ref_shards.build_pull_shards(graphs[1], 2)
    prog = ref_pr.PageRankProgram(nv=sh.spec.nv)
    s0 = ref_pull.init_state(prog, sh.arrays)
    ref = np.asarray(ref_pull.run_pull_fixed(prog, sh.spec, sh.arrays, s0, ITERS,
                                             method="scan"))
    d = {k: np.asarray(v) for k, v in sh.arrays._asdict().items()}
    d["state"] = np.asarray(s0)
    t = convert.shards_from_numpy(d, device="cpu")
    spec_port = shards.ShardSpec(**sh.spec.__dict__)
    got = pull.run_pull_fixed(pr.PageRankProgram(nv=sh.spec.nv), spec_port, t["arrays"],
                              t["state"], ITERS, method="scan")
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_run_pull_until_bitwise(graphs):
    """A quiescent min program (SSSP hop counts): integer state, bitwise."""
    g, rg = graphs
    start = int(np.argmax(np.bincount(g.col_idx, minlength=g.nv)))
    sh = shards.build_pull_shards(g, 1)
    arrays = shards.to_device(sh.arrays, "cpu")
    prog = spec.bind(library.SSSP, inf=g.nv, start=start)
    state, iters = pull.run_pull_until(prog, sh.spec, arrays,
                                       pull.init_state(prog, arrays), 100,
                                       spec.active_changed, method="scan")
    rsh = ref_shards.build_pull_shards(rg, 1)
    rprog = ref_spec.bind(ref_library.SSSP, inf=g.nv, start=start)
    rstate, riters = ref_pull.run_pull_until(rprog, rsh.spec, rsh.arrays,
                                             ref_pull.init_state(rprog, rsh.arrays), 100,
                                             ref_spec.active_changed, method="scan")
    assert iters == int(riters) and iters > 1
    np.testing.assert_array_equal(state.numpy(), np.asarray(rstate))


def test_donate_writes_into_state0(graphs):
    sh = shards.build_pull_shards(graphs[0], 1)
    arrays = shards.to_device(sh.arrays, "cpu")
    prog = pr.PageRankProgram(nv=graphs[0].nv)
    s0 = pull.init_state(prog, arrays)
    kept = pull.run_pull_fixed(prog, sh.spec, arrays, s0.clone(), 3, method="scan")
    out = pull.run_pull_fixed(prog, sh.spec, arrays, s0, 3, method="scan", donate=True)
    assert out is s0 and torch.equal(out, kept)


def test_check_ranks_agrees_with_reference(graphs):
    ranks = pr.pagerank(graphs[0], 3, method="scan", device="cpu")
    assert pr.check_ranks(graphs[0], ranks, num_iters=3) == \
        ref_pr.check_ranks(graphs[1], ranks, num_iters=3) == 0
    bad = ranks.copy()
    bad[:7] *= 2
    assert pr.check_ranks(graphs[0], bad, num_iters=3) == \
        ref_pr.check_ranks(graphs[1], bad, num_iters=3) > 0


def test_auto_resolves_to_scan_until_measured(monkeypatch):
    """auto runs scan wherever no winner was measured: every reduce on the
    CPU; the card's winners were measured on an H100 (chip_smoke.py
    phases push_race for min/max and sum_race for sum): mxscan."""
    monkeypatch.delenv("LUX_SUM_MODE", raising=False)
    monkeypatch.delenv("LUX_METHOD_PLATFORM", raising=False)
    for red in ("sum", "min", "max"):
        assert methods.resolve_sum("auto", red, "cpu") == "scan"
    for red in ("sum", "min", "max"):
        assert methods.resolve_sum("auto", red, "cuda") == "mxscan"
    assert methods.resolve_sum("scatter", "sum", "cuda") == "scatter"
    assert methods.resolve_sum("scatter", "min", "cuda") == "scatter"
    monkeypatch.setenv("LUX_SUM_MODE", "mxscan")
    assert methods.resolve_sum("auto", "sum", "cuda") == "mxscan"
    assert methods.resolve_sum("auto", "min", "cpu") == "scan"
    monkeypatch.setenv("LUX_SUM_MODE", "bogus")
    with pytest.raises(ValueError, match="LUX_SUM_MODE"):
        methods.resolve_sum("auto", "sum", "cuda")


@pytest.mark.parametrize("method", ["pallas", "mxscan", "scan", "scatter"])
def test_app_runs_on_cpu_with_check(method, capsys):
    rc = app.main(["--rmat-scale", "8", "--rmat-ef", "6", "-ni", "5",
                   "--method", method, "--device", "cpu", "-check"])
    out = capsys.readouterr().out
    assert rc == 0 and "[PASS]" in out and "GTEPS" in out


def test_app_result_matches_oracle():
    res = app.run(["--rmat-scale", "8", "--rmat-ef", "6", "-ni", "5",
                   "--method", "pallas", "--device", "cpu"])
    want = pr.pagerank_reference(generate.rmat(8, 6, seed=0), 5)
    np.testing.assert_allclose(res.ranks, want, rtol=1e-5)


def test_app_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(["--rmat-scale", "6", "-ni", "1"])


@pytest.mark.parametrize("argv,msg", [
    (["--edge-shards", "2"], "requires --distributed"),
    # fused is allgather-only under --distributed (the reference's refusal)
    (["--distributed", "--exchange", "ring", "--route-gather", "fused"], "allgather-only"),
    (["--exchange", "ring", "--distributed", "--feat-shards", "2"], "colfilter only"),
    (["-ng", "2", "--method", "pallas"], "-ng"),
    (["--frobnicate"], "unrecognized")],
    # the ids these cases had while the 2-D meshes and the distributed
    # routed gather were refused as not ported
    ids=["argv0-not ported", "argv1-not ported", "argv2-not ported", "argv3--ng",
         "argv4-unrecognized"])
def test_app_rejects_unported_flags(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        app.main(argv + ["--device", "cpu"])
    assert msg in f"{e.value.code}{capsys.readouterr().err}"


@pytest.mark.parametrize("mode", ["expand", "expand-pf", "fused", "fused-pf", "fused-mx", None])
def test_app_route_gather_on_cpu_with_check(mode, capsys):
    """--route-gather through the CLI; the bare flag resolves to
    expand-pf.  Expand modes with the same reduce are bitwise the direct
    run; every mode is within rtol 1e-5 of the float64 oracle."""
    argv = ["--rmat-scale", "8", "--rmat-ef", "6", "-ni", "4", "--device", "cpu",
            "-check", "--method", "mxscan", "--route-gather"] + ([mode] if mode else [])
    res = app.run(argv)
    assert res.rc == 0 and "[PASS]" in capsys.readouterr().out
    assert res.route_gather == (mode or "expand-pf")
    want = pr.pagerank_reference(res.graph, 4)
    np.testing.assert_allclose(res.ranks, want, rtol=1e-5)
    if res.route_gather.startswith("expand"):
        direct = app.run(argv[:-2] if mode else argv[:-1])
        np.testing.assert_array_equal(res.ranks, direct.ranks)


def test_app_route_gather_rejects_pallas_and_foreign_plans(capsys):
    with pytest.raises(SystemExit):
        app.main(["--route-gather", "--method", "pallas", "--device", "cpu"])
    assert "--method pallas" in capsys.readouterr().err
    g = generate.rmat(6, 4, seed=0)
    plan = expand.plan_expand_shards(shards.build_pull_shards(g, 1))
    with pytest.raises(ValueError, match="replays 'expand'"):
        app.run(["--rmat-scale", "6", "--rmat-ef", "4", "-ni", "1", "--device", "cpu",
                 "--route-gather", "fused"], route=plan)
